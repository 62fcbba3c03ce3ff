"""The port's measurement entry points on the CPU: bench_torch.py's inputs,
statistics, measuring function and gate; the scripts' refusal without a
card; the hook-scale and recursion circuits' counts against the JAX
package's builder; the profiler script's steps at a tiny shape."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from plonky2_bn254_tpu.bn254 import oracle as joracle
from plonky2_bn254_tpu.circuit import builder_ops as jbuilder_ops
from plonky2_bn254_tpu.circuit.builder import CircuitBuilder as JCircuitBuilder
from plonky2_bn254_tpu.circuit.fq import FqTarget as JFqTarget
from plonky2_bn254_tpu.prover.config import DEFAULT_CONFIG as JDEFAULT_CONFIG
from plonky2_bn254_tpu.prover.config import StarkConfig as JStarkConfig
from plonky2_bn254_tpu_torch.prover import verify as verify_mod
from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
sys.path.insert(0, str(REPO))

import bench_torch  # noqa: E402
import torch_measure_default_recursion as default_recursion  # noqa: E402
import torch_measure_hook_scale as hook_scale  # noqa: E402
import torch_profile_chip as profile_chip  # noqa: E402

BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline", "stages_s"}
NEW_KEYS = {"walls_s", "median_s", "q1_s", "q3_s", "n", "warmup_s", "build_s", "peak_gb",
            "verified", "device"}


def test_bench_inputs_are_bench_py_and_the_smoke_g1_path():
    """The bench proves chip_smoke.Path's g1 batch, and that batch is
    bench.py's."""
    import chip_smoke

    path = chip_smoke.Path("g1", "cpu")
    rng = np.random.default_rng(2024)  # bench.py:111-122, with the JAX package's oracle
    want = [
        (int(rng.integers(1, 1 << 63)) << 192 | int(rng.integers(0, 1 << 63)),
         joracle.random_g1(rng), joracle.random_g1(rng), t)
        for t in range(128)
    ]
    assert path.inputs == want
    stark, ctl_values, _ = bench_torch.load_machine("g1", 128, "cpu")
    assert ctl_values == path.ctl_values and stark.width == path.stark.width == 781


@pytest.mark.parametrize("values,want", [
    ([5.0, 1.0, 3.0, 2.0, 4.0], (2.0, 3.0, 4.0)),
    ([1.0, 2.0, 3.0, 4.0], (1.75, 2.5, 3.25)),
    ([1.0, 2.0], (1.25, 1.5, 1.75)),
    ([7.0], (7.0, 7.0, 7.0)),
])
def test_quartiles(values, want):
    assert bench_torch.quartiles(values) == want
    stats = bench_torch.wall_stats(values)
    assert (stats["q1_s"], stats["median_s"], stats["q3_s"]) == want
    assert stats["walls_s"] == values and stats["n"] == len(values)


def test_measure_on_the_cpu():
    """The demo machine, one trace a proof: the machines verify only at 2^16
    rows, which take minutes a proof on a CPU."""
    res = bench_torch.measure("demo", 1, TEST_CONFIG, 2, "cpu")
    assert BENCH_PY_KEYS | NEW_KEYS <= set(res)
    assert res["metric"] == "demo_proofs_per_s" and res["unit"] == "proofs/s"
    assert res["n"] == 2 and len(res["walls_s"]) == 2
    assert res["median_s"] == float(np.median(res["walls_s"]))
    assert res["value"] == 1 / res["median_s"]
    assert res["vs_baseline"] == res["value"] / 100.0
    assert res["q1_s"] <= res["median_s"] <= res["q3_s"]
    assert res["verified"] is True and res["warmup_s"] > 0 and res["build_s"] >= 0
    assert {"trace gen", "trace commit", "aux", "quotient", "openings", "fri"} <= set(res["stages_s"])
    assert res["peak_gb"] is None and res["device"]["platform"] == "cpu"


def test_measure_stops_at_the_gate(monkeypatch):
    def refuse(*args, **kwargs):
        raise verify_mod.VerificationError("refused")

    monkeypatch.setattr(verify_mod, "verify", refuse)
    progress = []
    with pytest.raises(verify_mod.VerificationError):
        bench_torch.measure("demo", 1, TEST_CONFIG, 2, "cpu",
                            lambda phase, partial: progress.append(phase))
    assert progress[-1] == "gate"


def test_measure_stops_at_a_proof_unlike_the_gated_one(monkeypatch):
    """Every proof after the gate is held to the gated proof: here the
    proof under the timer reads differently and ends the run."""
    keys = iter(["gated", "other"])
    monkeypatch.setattr(bench_torch, "proof_key", lambda proof: next(keys))
    progress = []
    with pytest.raises(AssertionError, match="differs from the gated proof"):
        bench_torch.measure("demo", 1, TEST_CONFIG, 2, "cpu",
                            lambda phase, partial: progress.append(phase))
    assert progress[-1] == "timed proof"


def test_gate_rejects_a_flipped_opening(monkeypatch):
    from plonky2_bn254_tpu_torch.field.extension import GLExt
    from plonky2_bn254_tpu_torch.prover import prove as prove_mod

    stark, ctl_values, make_trace = bench_torch.load_machine("demo", 1, "cpu")
    proof = prove_mod.prove(stark, make_trace(), ctl_values, TEST_CONFIG)
    bench_torch.gate(stark, proof, ctl_values, TEST_CONFIG)
    proof.openings.trace_zeta[0] = proof.openings.trace_zeta[0] + GLExt(1)
    with pytest.raises(verify_mod.VerificationError):
        bench_torch.gate(stark, proof, ctl_values, TEST_CONFIG)
    # a verifier that accepts everything fails the gate's second half
    monkeypatch.setattr(verify_mod, "verify", lambda *args, **kwargs: None)
    with pytest.raises(AssertionError, match="flipped opening"):
        bench_torch.gate(stark, proof, ctl_values, TEST_CONFIG)


def test_demo_takes_one_trace():
    with pytest.raises(ValueError):
        bench_torch.load_machine("demo", 2, "cpu")


ENTRY_POINTS = [
    ["bench_torch.py"],
    ["scripts/torch_bench_outer.py"],
    ["scripts/torch_prove_compose_default.py"],
    ["scripts/torch_profile_chip.py"],
    ["scripts/torch_measure_hook_scale.py", "4", "--fake"],
    ["scripts/torch_measure_default_recursion.py"],
]


def test_entry_points_refuse_the_cpu():
    """Without a card each entry point exits non-zero before any work and
    prints no result."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen([sys.executable, *args], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for args in ENTRY_POINTS]
    for args, proc in zip(ENTRY_POINTS, procs):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode != 0, args
        assert "no CUDA device" in err, (args, err)
        assert '"value"' not in out and "targets" not in out, (args, out)


def _jax_hook_scale(n_ops: int, prove: bool):
    """scripts/measure_hook_scale.py's recording and build, on the JAX package."""
    rng = np.random.default_rng(hook_scale.SEED)
    b = JCircuitBuilder()
    hook = jbuilder_ops.get_bn254_hook(b)
    hook.stark_config = JStarkConfig(**hook_scale.CONFIG)
    hook.prove_starks = prove
    for _ in range(n_ops):
        s_v = int(rng.integers(1, 1 << 62)) << 180 | int(rng.integers(0, 1 << 62))
        joracle.random_fq(rng)
        x_t = JFqTarget.new_unchecked(b)
        jbuilder_ops.fq_exp(b, s_v, x_t)
    b.build()
    return b


@pytest.mark.parametrize("prove", [False, True], ids=["fake", "real"])
def test_hook_scale_counts_equal_jax(prove):
    built = hook_scale.build(4, prove)
    jb = _jax_hook_scale(4, prove)
    want = {"targets": jb.num_targets, "constraints": len(jb.constraints),
            "templated_rows": len(jb.tpl_rows)}
    assert hook_scale.counts(built["builder"]) == want
    assert len(built["recorded"]) == 4


def test_default_recursion_counts_equal_jax():
    built = default_recursion.build("fq_exp", 1)
    rng = np.random.default_rng(default_recursion.SEED)  # measure_default_recursion.py
    jb = JCircuitBuilder()
    jbuilder_ops.get_bn254_hook(jb).stark_config = JDEFAULT_CONFIG
    x_t = JFqTarget.new_unchecked(jb)
    s_v = int(rng.integers(1, 1 << 62)) << 150 | int(rng.integers(0, 1 << 62))
    jbuilder_ops.fq_exp(jb, s_v, x_t)
    jb.build()
    want = {"targets": jb.num_targets, "constraints": len(jb.constraints),
            "templated_rows": len(jb.tpl_rows), "templates": len(jb.templates),
            "generators": len(jb.generators), "poseidon_ops": len(jb.poseidon_ops)}
    assert default_recursion.counts(built["circuit"].builder) == want


def test_profile_steps_on_the_cpu():
    """Control flow only: every step of part (a) and every slice of part (b)
    on the demo machine (no device time exists on the host)."""
    steps = []
    profile_chip.hot_path("demo", 1, TEST_CONFIG, 1, "cpu",
                          lambda name, best, median: steps.append((name, best, median)))
    names = [name for name, _, _ in steps]
    assert names[0] == "trace gen" and names[-1].startswith("quotient")
    assert any(n.startswith("iNTT (K3)") for n in names) and any(n.startswith("LDE plain") for n in names)
    assert len(names) == 13 and all(best == median >= 0 for _, best, median in steps)

    slices = profile_chip.slice_profile("demo", 1, TEST_CONFIG, "cpu")
    assert set(slices) == set(profile_chip.SLICES)
    for rec in slices.values():
        assert rec["wall_s"] > 0 and rec["wall_unprofiled_s"] > 0
        assert rec["kernels"] == 0 and rec["device_busy_s"] == 0 and rec["idle_share"] == 1
