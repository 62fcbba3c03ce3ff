"""The port's span recorder (`plonky2_bn254_tpu_torch.utils.timing`) on the
CPU: no synchronise on a span boundary, the profiler's clock, tracing
switched on and off by the trees alive, a passed tree winning, the
program's annotations in the benchmark's profile reduction, and the
metric files that read the span store."""

import gc
import importlib.util
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

from plonky2_bn254_tpu_torch.utils import timing
from plonky2_bn254_tpu_torch.utils.timing import Span, TimingTree

PROOFBENCH = pathlib.Path(__file__).resolve().parents[1] / "proofbench"
if str(PROOFBENCH) not in sys.path:
    sys.path.insert(0, str(PROOFBENCH))

LAG_NS = 5_000_000  # the fake card runs 5 ms behind the host


@pytest.fixture(autouse=True)
def quiet_store(monkeypatch):
    """Tracing only where a test turns it on, and an empty store."""
    monkeypatch.setattr(timing, "_ALWAYS", False)
    gc.collect()
    timing.reset()
    yield
    timing.reset()


class _FakeEvent:
    """A CUDA event on a card whose current stream runs LAG_NS behind the
    host and whose anchor stream fires at once."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.time_ns() + (0 if stream == "anchor" else LAG_NS)

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def _fake_card(monkeypatch, allocated, up=(True,)):
    syncs = []
    monkeypatch.setattr(timing, "_ANCHORS", {})
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: up[0])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: "main")
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev=None: "anchor")
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: syncs.append(dev))
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda dev=None: {"allocation": {"all": {"allocated": allocated[0]}}})
    return syncs


def test_span_boundaries_never_synchronise(monkeypatch):
    allocated = [100]
    syncs = _fake_card(monkeypatch, allocated)
    tt = TimingTree(enabled=True)
    with tt.scope("outer"):
        allocated[0] += 2
        with tt.scope("inner"):
            allocated[0] += 3
        with timing.get(None).scope("other tree"):
            pass
    assert syncs == []
    spans = {s.name: s for s in timing.spans()}
    assert syncs == [0]  # one synchronise, when they are read
    assert spans["outer"].allocs == 5 and spans["inner"].allocs == 3
    for s in spans.values():
        assert abs(s.device_open_ns - s.host_open_ns - LAG_NS) < 1_000_000
        assert abs(s.device_close_ns - s.host_close_ns - LAG_NS) < 1_000_000
        assert s.seconds == (max(s.host_close_ns, s.device_close_ns)
                             - max(s.host_open_ns, s.device_open_ns)) / 1e9
    assert [n for _, n, _ in tt.records] == ["inner", "outer"]
    assert syncs == [0]  # already resolved


def test_a_span_across_the_cards_start_counts_from_it(monkeypatch):
    """A span that opens before the card comes up has no device open; it
    counts the allocations from the card's start and closes on its clock."""
    allocated, up = [0], [False]
    _fake_card(monkeypatch, allocated, up)
    tt = TimingTree(enabled=True)
    with tt.scope("first proof"):
        up[0] = True
        allocated[0] += 7
    (s,) = timing.spans()
    assert s.allocs == 7 and s.device_open_ns is None
    assert abs(s.device_close_ns - s.host_close_ns - LAG_NS) < 1_000_000
    assert s.seconds == (s.device_close_ns - s.host_open_ns) / 1e9


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    tt, quiet = TimingTree(enabled=True), TimingTree(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):  # the profiler's first event sets it up
            pass
        with tt.scope("outer"):
            with tt.scope("inner"):
                time.sleep(0.005)
            with quiet.scope("untraced"):
                time.sleep(0.002)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(timing.ANNOTATION)}
    assert set(events) == {"scope:outer", "scope:inner", "scope:untraced"}
    spans = timing.spans()
    assert [s.name for s in spans] == ["inner", "outer"]
    for s in spans:
        e = events[timing.ANNOTATION + s.name]
        assert abs(e.start_ns() - s.host_open_ns) < 1_000_000
        assert abs(e.start_ns() + e.duration_ns() - s.host_close_ns) < 1_000_000


def _fq_exp_trace():
    from plonky2_bn254_tpu_torch.bn254 import oracle
    from plonky2_bn254_tpu_torch.starks import fq_exp

    rng = np.random.default_rng(7)
    inputs = [(int(rng.integers(1, 1 << 62)) << 150 | t, oracle.random_fq(rng), t)
              for t in range(2)]
    return fq_exp.generate_trace(inputs, min_rows=2048, device="cpu")


def test_tracing_follows_the_enabled_trees_alive():
    assert not timing.tracing() and timing.get(None) is timing._NULL
    tt = TimingTree(enabled=True)
    assert timing.tracing() and timing.get(None) is timing._PROCESS
    trace = _fq_exp_trace()
    spans = timing.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["generate_trace"]
    root = roots[0]
    children = [s.name for s in spans if s.parent == root.id]
    assert children == ["inputs", "chains", "witness pass", "assemble", "range checks"]
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.root == root.id
        if s.parent is not None:
            parent = by_id[s.parent]
            assert parent.host_open_ns <= s.host_open_ns <= s.host_close_ns <= parent.host_close_ns
    assert tt.records == []  # the machine was handed no tree: the process's recorded it

    del tt
    gc.collect()
    assert not timing.tracing()
    timing.reset()
    assert torch.equal(_fq_exp_trace(), trace)
    assert timing.spans() == []


def test_a_passed_tree_wins():
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks.demo import demo_stark, demo_trace

    trace, ctl = demo_trace(np.random.default_rng(3))
    on = TimingTree(enabled=True)
    quiet = TimingTree(enabled=False)
    prove_mod.prove(demo_stark(), trace, ctl, TEST_CONFIG, timing=quiet)
    assert timing.spans() == [] and quiet.records == []
    prove_mod.prove(demo_stark(), trace, ctl, TEST_CONFIG, timing=on)
    names = [n for d, n, _ in on.records]
    assert names[-1] == "prove" and {"trace commit", "aux", "quotient", "fri"} <= set(names)
    assert [s.name for s in timing.spans()] == names
    assert set(on.stages()) >= {"trace commit", "aux", "quotient", "fri"}
    assert "prove" not in on.stages()


def test_program_annotations_are_no_device_work():
    """A profiled window whose only scopes are the program's annotations
    (each with its device-side copy): every gap takes the innermost
    program span open where it starts, and no annotation counts as a
    device operation."""
    from yardstick import profile

    us = [("proofbench.window", False, 0.0, 1000.0)]
    for name, s, e in (("prove", 0.0, 1000.0), ("quotient", 100.0, 600.0)):
        us += [(timing.ANNOTATION + name, False, s, e), (timing.ANNOTATION + name, True, s, e)]
    us += [("kernel_a", True, 0.0, 50.0), ("kernel_b", True, 300.0, 350.0),
           ("kernel_a", True, 900.0, 1000.0)]
    reduced = profile.reduce_events(us)
    assert reduced["launches"] == 3
    assert reduced["busy_s"] == pytest.approx(200e-6)
    assert set(reduced["device_s"]) == {"kernel_a", "kernel_b"}
    assert reduced["gaps"] == [("quotient", pytest.approx(550e-6)),
                               ("prove", pytest.approx(250e-6))]


def _span(sid, parent, root, name, secs, allocs=None):
    return Span(sid, parent, root, name, host_open_ns=0, host_close_ns=int(secs * 1e9),
                allocs=allocs)


def _store():
    """Two batch proofs and two circuit proofs, with a "chains" span inside
    the hook's trace generation that no batch metric may read."""
    return [
        _span(1, None, 1, "generate_ctl_values", 0.5),
        _span(3, 2, 2, "chains", 3.0), _span(4, 2, 2, "witness pass", 1.0),
        _span(2, None, 2, "generate_trace", 5.0, allocs=1000),
        _span(6, 5, 5, "chains", 5.0),
        _span(5, None, 5, "generate_trace", 7.0, allocs=1000),
        _span(9, 8, 7, "chains", 0.8), _span(8, 10, 7, "generate_trace", 0.9, allocs=7),
        _span(10, 7, 7, "fq_exp trace gen", 1.0), _span(11, 7, 7, "fq_exp prove", 3.0),
        _span(12, 7, 7, "fq_exp self-verify", 0.5), _span(13, 7, 7, "inject", 0.25),
        _span(7, None, 7, "generate_witness", 6.0),
        _span(15, 14, 14, "fq_exp trace gen", 2.0), _span(16, 14, 14, "fq_exp prove", 4.0),
        _span(17, 14, 14, "fq_exp self-verify", 1.5), _span(18, 14, 14, "inject", 0.75),
        _span(14, None, 14, "generate_witness", 10.0),
    ]


METRICS = {
    "chains_s.g1": 4.0, "chains_s.batch": 4.0,
    "trace_gen_allocs.g1": 1000.0, "trace_gen_allocs.batch": 1000.0,
    "hook_trace_gen_s.circuit": 1.5, "hook_prove_s.circuit": 3.5,
    "hook_verify_s.circuit": 1.0, "fixpoint_s.circuit": (6.0 - 4.75 + 10.0 - 8.25) / 2,
}


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "test_metric_" + name.replace(".", "_"), PROOFBENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_metric_reads_its_mean(monkeypatch, name):
    monkeypatch.setattr(timing, "spans", _store)
    assert _metric(name).read({}) == pytest.approx(METRICS[name])
    monkeypatch.setattr(timing, "spans", list)  # an empty store reads as nothing
    assert _metric(name).read({}) is None
    monkeypatch.delattr(timing, "spans")  # a program without the store
    assert _metric(name).read({}) is None
