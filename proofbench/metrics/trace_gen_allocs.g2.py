"""Device allocation requests a proof inside the program's "generate_trace"
root span (the caching allocator's allocation.all.allocated across it; about
one a kernel launch), the mean over the traced run's window proofs."""

from yardstick import spans


def read(record):
    return spans.mean_allocs("generate_trace")
