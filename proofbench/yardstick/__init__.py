"""What the benchmark measures with: traffic, the window, the work a proof
needs and its least time on the card, the reduction of a profiler window,
and the device and host records."""
