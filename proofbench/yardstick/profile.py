"""One torch.profiler window, reduced to what the per-layer metrics read.

`Session(skip).run(fn)` runs `fn` once under the profiler (CPU and CUDA
activity), inside a `proofbench.window` annotation, and synchronises before
the window closes.  The program's TimingTree scopes, passed through
`Session.annotate`, become annotations too, so each idle gap of the device
is labelled by the innermost scope that was open on the host at the gap's
start; the scopes named in `skip` are left out of the window.  The
reduction keeps:

  - window_s: the annotation's length less the left-out scopes';
  - busy_s: the union of the device operations' intervals inside it;
  - launches: the device kernels (memory copies and sets not counted);
  - device_s: device seconds by operation name;
  - gaps: the idle gaps, longest first, as (scope, seconds).
"""

from __future__ import annotations

import contextlib
import time

WINDOW = "proofbench.window"
SCOPE = "scope:"
SKIP = "skip:"


@contextlib.contextmanager
def _annotation(name: str):
    import torch

    with torch.profiler.record_function(name):
        yield


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    """`events`: (name, is_device, start_us, end_us) tuples of one window.
    The annotations' device-side copies are not device operations."""
    win = [(s, e) for name, dev, s, e in events if not dev and name == WINDOW]
    dev_ops = [(name, s, e) for name, dev, s, e in events
               if dev and name != WINDOW and not name.startswith((SCOPE, SKIP))]
    scopes = [(name[len(SCOPE):], s, e) for name, dev, s, e in events
              if not dev and name.startswith(SCOPE)]
    marks = sorted(s for name, dev, s, _ in events if not dev and name.startswith(SKIP))
    skipped = list(zip(marks[0::2], marks[1::2]))  # each left-out scope: (off, on)
    w0, w1 = win[0]
    inside = [(max(s, w0), min(e, w1)) for _, s, e in dev_ops if e > w0 and s < w1]
    merged = _merge(inside)
    busy_us = sum(e - s for s, e in merged)
    skipped_us = sum(e - s for s, e in skipped)
    merged = _merge(inside + skipped)  # a left-out scope is no gap
    device_s = {}
    launches = 0
    for name, s, e in dev_ops:
        device_s[name] = device_s.get(name, 0.0) + (e - s) / 1e6
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = []
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            open_ = [(name, ss) for name, ss, ee in scopes if ss <= s < ee]
            label = max(open_, key=lambda t: t[1])[0] if open_ else "prove (no scope)"
            gaps.append((label, (e - s) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    window_s = (w1 - w0 - skipped_us) / 1e6
    return {"window_s": window_s, "busy_s": busy_us / 1e6, "launches": launches,
            "device_s": device_s, "gaps": gaps}


class Session:
    """One profiler window over a call into the program, whose TimingTree
    scopes become annotations; the scopes named in `skip` are left out:
    the device is synchronised and collection switched off while they run,
    and the window's length leaves their time out."""

    def __init__(self, skip=()):
        self.skip, self.prof = tuple(skip), None

    def annotate(self, tree):
        """Make each scope of the program's TimingTree `tree` an annotation."""
        opened = tree.scope

        @contextlib.contextmanager
        def scope(name):
            if name not in self.skip or self.prof is None:
                with _annotation(SCOPE + name), opened(name):
                    yield
                return
            self._toggle(False, name)
            try:
                with opened(name):
                    yield
            finally:
                self._toggle(True, name)

        tree.scope = scope
        return tree

    def _toggle(self, on: bool, name: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity

        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if on:
            self.prof.toggle_collection_dynamic(True, activities)
        with _annotation(SKIP + name):
            pass
        if not on:
            self.prof.toggle_collection_dynamic(False, activities)

    def run(self, fn, log=None) -> tuple:
        """(fn's result, the reduced window).  The events are read from the
        profiler's raw results, without building its per-event Python
        objects."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            self.prof = prof
            t1 = time.perf_counter()
            with torch.profiler.record_function(WINDOW):
                out = fn()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        self.prof = None
        t2 = time.perf_counter()
        raw = prof.profiler.kineto_results
        base = raw.trace_start_ns()
        events = []
        for e in raw.events():
            start = (e.start_ns() - base) / 1e3
            events.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                           start + e.duration_ns() / 1e3))
        reduced = reduce_events(events)
        if log:
            log(f"# profiler: {len(events):,} events, {reduced['launches']:,} device kernels, "
                f"window {wall:.3f} s; start and stop {t2 - t0 - wall:.1f} s, "
                f"read in {time.perf_counter() - t2:.1f} s")
        return out, reduced
