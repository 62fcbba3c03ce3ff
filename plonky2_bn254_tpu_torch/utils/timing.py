"""The port's span recorder: hierarchical timing scopes (plonky2's TimingTree)
that never synchronise a span boundary.

Port of `plonky2_bn254_tpu/utils/timing.py`, grown into one recorder for
the process.  A span of an enabled tree records:

  - an id, its parent's id and its root's id: the parent is the innermost
    span open in the process when it opened, whichever tree opened that one;
  - its name;
  - its host open and close times, in Unix-epoch ns (`time.time_ns`, the
    clock `torch.profiler` stamps its events with);
  - on CUDA, its device open and close times: a `torch.cuda.Event` recorded
    on the current stream at each end, mapped onto the same epoch clock
    through an anchor event that each root span records on an idle stream
    of its own (so it fires as it is recorded; no synchronise);
  - `allocs`: the caching allocator's `allocation.all.allocated` counter
    across the span, the device allocation requests made inside it.  The
    port's out-of-place int64 arithmetic makes about one a kernel launch.

A span's seconds run from the later of its host and device opens to the
later of its host and device closes: what a scope that synchronised at both
ends measured, taken without making the host wait.  Device times resolve
when spans are read (`records`, `total`, `print`, `spans()`), with one
synchronise there.

Tracing is on while an enabled TimingTree is alive, or always when
PLONKY2_BN254_TPU_TIMING=1 is set at import.  While it is on, `get(None)`
returns the process's tree, so code that is handed no tree records too;
a tree that is passed in always wins (a disabled one records nothing).
Every enabled tree writes its spans into the process's store too, read by
`spans()` and cleared by `reset()`.  While a `torch.profiler` collects,
every scope, of an enabled tree or not, also opens the annotation
`scope:<name>`, so a device trace shows the program's spans.  The
recorder assumes one thread opens spans.
"""

from __future__ import annotations

import itertools
import os
import time
import weakref
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

ENV = "PLONKY2_BN254_TPU_TIMING"
ANNOTATION = "scope:"
WHOLE_CALLS = ("prove", "prove_outer")  # spans around a whole call; `stages` looks through them
_UNNAMED = nullcontext()


@dataclass(eq=False)
class Span:
    id: int
    parent: Optional[int]
    root: int
    name: str
    host_open_ns: int
    host_close_ns: int = 0
    device_open_ns: Optional[int] = None
    device_close_ns: Optional[int] = None
    allocs: Optional[int] = None
    # on CUDA until resolved: [device, anchor, open event (None: the card came up
    # inside the span), close event, allocs at open]
    _pending: Optional[list] = None

    @property
    def seconds(self) -> float:
        t0 = max(self.host_open_ns, self.device_open_ns or 0)
        t1 = max(self.host_close_ns, self.device_close_ns or 0)
        return (t1 - t0) / 1e9


_ALWAYS = os.environ.get(ENV, "0") == "1"
_live = 0  # enabled trees alive
_STORE: List[Span] = []  # closed spans of every enabled tree, in close order
_OPEN: List[Span] = []  # the process's open spans, innermost last
_IDS = itertools.count(1)
_ANCHORS: Dict[int, tuple] = {}  # device index -> (its anchor stream, (event, host ns))


def tracing() -> bool:
    return _ALWAYS or _live > 0


def _dead() -> None:
    global _live
    _live -= 1


def _allocs(dev: int) -> int:
    return torch.cuda.memory_stats_as_nested_dict(dev)["allocation"]["all"]["allocated"]


def _anchor(dev: int, fresh: bool) -> tuple:
    """(event, host ns) that ties the device's clock to the host's: an event
    recorded on a stream nothing else uses, so it fires at once, and the
    host's time as soon as a query sees it fired (a query waits on nothing)."""
    stream, anchor = _ANCHORS.get(dev, (None, None))
    if stream is None:
        stream = torch.cuda.Stream(dev)
    if anchor is None or fresh:
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        while not event.query():
            pass
        anchor = (event, time.time_ns())
        _ANCHORS[dev] = (stream, anchor)
    return anchor


def _open(name: str) -> Span:
    parent = _OPEN[-1] if _OPEN else None
    sid = next(_IDS)
    span = Span(sid, parent and parent.id, parent.root if parent else sid, name,
                host_open_ns=time.time_ns())
    if torch.cuda.is_initialized():
        dev = torch.cuda.current_device()
        anchor = _anchor(dev, fresh=parent is None)
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(dev))
        span._pending = [dev, anchor, event, None, _allocs(dev)]
    _OPEN.append(span)
    return span


def _close(span: Span) -> None:
    span.host_close_ns = time.time_ns()
    if span._pending is None and torch.cuda.is_initialized():
        # the card came up inside the span, and nothing was allocated before it did
        dev = torch.cuda.current_device()
        span._pending = [dev, _anchor(dev, fresh=False), None, None, 0]
    if span._pending is not None:
        dev = span._pending[0]
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(dev))
        span._pending[3] = event
        span.allocs = _allocs(dev) - span._pending[4]
    _OPEN.remove(span)
    _STORE.append(span)


def _resolve(spans) -> None:
    """Map the device events of closed `spans` onto the epoch clock, after
    one synchronise of each device they ran on."""
    pending = [s for s in spans if s._pending is not None]
    for dev in {s._pending[0] for s in pending}:
        torch.cuda.synchronize(dev)
    for s in pending:
        _, (anchor, host_ns), ev0, ev1, _ = s._pending
        if ev0 is not None:
            s.device_open_ns = host_ns + round(anchor.elapsed_time(ev0) * 1e6)
        s.device_close_ns = host_ns + round(anchor.elapsed_time(ev1) * 1e6)
        s._pending = None


class TimingTree:
    def __init__(self, enabled: Optional[bool] = None):
        global _live
        if enabled is None:
            enabled = os.environ.get(ENV, "0") == "1"
        self.enabled = enabled
        self._spans: List[tuple] = []  # (depth, Span) in close order
        self._depth = 0
        if enabled:
            _live += 1
            weakref.finalize(self, _dead)

    @contextmanager
    def scope(self, name: str):
        profiling = torch.autograd._profiler_enabled()
        with torch.profiler.record_function(ANNOTATION + name) if profiling else _UNNAMED:
            if not self.enabled:
                yield
                return
            depth = self._depth
            self._depth += 1
            span = _open(name)
            try:
                yield
            finally:
                _close(span)
                self._depth = depth
                self._spans.append((depth, span))

    @property
    def records(self) -> List[tuple]:
        """(depth, name, seconds) per closed scope, in close order."""
        _resolve(s for _, s in self._spans)
        return [(depth, s.name, s.seconds) for depth, s in self._spans]

    def stages(self) -> Dict[str, float]:
        """Seconds by name of the top scopes, looking through the whole-call
        spans `prove` and `prove_outer` to the stages under them."""
        out: Dict[str, float] = {}
        path: List[str] = []
        for depth, name, secs in reversed(self.records):  # parents first
            path[depth:] = [name]
            if name not in WHOLE_CALLS and all(p in WHOLE_CALLS for p in path[:-1]):
                out[name] = out.get(name, 0.0) + secs
        return dict(reversed(out.items()))

    def print(self, out=None):
        lines = []
        for depth, name, secs in self.records:
            lines.append(f"{'  ' * depth}{secs:8.3f}s  {name}")
        text = "\n".join(lines)
        if out is not None:
            out.write(text + "\n")
        else:
            print(text)
        return text

    def total(self, name: str) -> float:
        return sum(s for _, n, s in self.records if n == name)


_NULL = TimingTree(enabled=False)
_PROCESS = TimingTree(enabled=False)
_PROCESS.enabled = True  # records while tracing is on; keeps no tracing on


def get(timing: Optional[TimingTree]) -> TimingTree:
    """`timing` if given, else the process's tree while tracing is on, else
    a tree that records nothing."""
    if timing is not None:
        return timing
    return _PROCESS if tracing() else _NULL


def spans() -> List[Span]:
    """Every closed span of every enabled tree since the last `reset()`,
    in close order, its device times resolved."""
    _resolve(_STORE)
    return list(_STORE)


def reset() -> None:
    _STORE.clear()
    _PROCESS._spans.clear()
