"""The PyTorch port stands alone: it imports no JAX, its copies of the JAX
package's host files equal the originals by value, and its kernel wrappers
never fall back from a device request to the plain version."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "plonky2_bn254_tpu_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_no_jax():
    mods = list(_port_modules())
    assert len(mods) > 30
    for m in ("fq_mul", "fq_exp", "fq2_alg", "g2_add", "g2_scalar_mul", "rows"):
        assert f"plonky2_bn254_tpu_torch.starks.{m}" in mods, m
    for m in ("builder", "biguint", "fq", "fq2", "curves", "to_u16", "ext_target",
              "poseidon_gadget", "stark_verifier", "builder_ops", "outer", "msm", "hash_to_g2"):
        assert f"plonky2_bn254_tpu_torch.circuit.{m}" in mods, m
    for m in ("field.native", "prover.device_challenger", "parallel", "parallel.mesh",
              "parallel.ntt", "parallel.launch"):
        assert f"plonky2_bn254_tpu_torch.{m}" in mods, m
    assert "plonky2_bn254_tpu_torch.circuit" in mods
    # the mesh and measurement scripts (scripts/ on the path, as when they
    # run), the smoke and the bench
    scripts = ["torch_mesh_common", "torch_mesh_scaling", "torch_mesh2d_production",
               "torch_dryrun_multichip", "chip_smoke", "bench_torch", "torch_bench_outer",
               "torch_prove_compose_default", "torch_profile_chip", "torch_measure_hook_scale",
               "torch_measure_default_recursion"]
    code = (
        "import importlib, sys\n"
        "sys.path.insert(0, 'scripts')\n"
        f"for m in {mods + scripts!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib', 'plonky2_bn254_tpu.')) or k == 'plonky2_bn254_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_params_copy_equals_original():
    from plonky2_bn254_tpu.bn254 import params as orig
    from plonky2_bn254_tpu_torch.bn254 import params as copy

    names = [n for n in dir(orig) if n.isupper()]
    assert names
    for n in names:
        assert getattr(copy, n) == getattr(orig, n), n


def test_oracle_copy_equals_original():
    from plonky2_bn254_tpu.bn254 import oracle as orig
    from plonky2_bn254_tpu_torch.bn254 import oracle as copy

    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        pa, pb = copy.random_g1(ra), orig.random_g1(rb)
        assert pa == pb
        k = int(ra.integers(1, 2**62))
        assert int(rb.integers(1, 2**62)) == k
        assert copy.g1_mul(pa, k) == orig.g1_mul(pb, k)
        assert copy.g1_add(pa, copy.g1_neg(pa)) is None
        assert copy.g1_is_on_curve(pa) and copy.fq_sgn(k) == orig.fq_sgn(k)
        assert copy.fq_inv(k) == orig.fq_inv(k) and copy.fq_sqrt(k) == orig.fq_sqrt(k)
    for _ in range(2):
        qa, qb = copy.random_g2(ra), orig.random_g2(rb)
        assert qa == qb and copy.g2_is_on_curve(qa)
        k = int(ra.integers(1, 2**62))
        assert int(rb.integers(1, 2**62)) == k
        assert copy.g2_mul(qa, k) == orig.g2_mul(qb, k)
        assert copy.g2_add(qa, copy.g2_mul(qa, k)) == orig.g2_add(qb, orig.g2_mul(qb, k))
        assert copy.g2_add(qa, copy.g2_neg(qa)) is None
        a, b = qa[0], qa[1]
        for name in ("fq2_add", "fq2_sub", "fq2_mul"):
            assert getattr(copy, name)(a, b) == getattr(orig, name)(a, b), name
        for name in ("fq2_neg", "fq2_inv", "fq2_sgn", "fq2_is_square", "fq2_sqrt"):
            assert getattr(copy, name)(a) == getattr(orig, name)(a), name
        assert copy.fq2_mul_scalar(a, k) == orig.fq2_mul_scalar(a, k)


def _layouts(mod):
    return {n: getattr(mod, n) for n in dir(mod) if n.endswith("_LAYOUT")}


def _layout_value(lay):
    return [(name, _layout_value(s) if hasattr(s, "spec") else s) for name, s in lay.spec]


def test_layout_copy_equals_original():
    from plonky2_bn254_tpu.starks import layout as orig
    from plonky2_bn254_tpu_torch.starks import layout as copy

    a, b = _layouts(copy), _layouts(orig)
    assert a.keys() == b.keys() and a
    for n in a:
        assert _layout_value(a[n]) == _layout_value(b[n]), n
        assert a[n].width == b[n].width
        assert a[n].offsets == b[n].offsets


def test_table_copy_equals_original():
    from plonky2_bn254_tpu.starks import table as orig
    from plonky2_bn254_tpu_torch.starks import table as copy

    for cls in ("Lookup", "KeyedLookup", "CtlSpec", "Stark"):
        fa = [(f.name, f.default) for f in dataclasses.fields(getattr(copy, cls))]
        fb = [(f.name, f.default) for f in dataclasses.fields(getattr(orig, cls))]
        assert fa == fb, cls
    for factory in ("fq_exp_stark", "g1_scalar_mul_stark", "g2_scalar_mul_stark"):
        sa, sb = getattr(copy, factory)(), getattr(orig, factory)()
        assert (sa.name, sa.width, sa.constraint_degree) == (sb.name, sb.width, sb.constraint_degree)
        assert [dataclasses.asdict(x) for x in sa.lookups] == [dataclasses.asdict(x) for x in sb.lookups]
        assert [dataclasses.asdict(x) for x in sa.ctls] == [dataclasses.asdict(x) for x in sb.ctls]
        for ca, cb in zip(sa.ctls, sb.ctls):
            assert ca.flat_weights(12345, 2**64 - 2**32 + 1) == cb.flat_weights(12345, 2**64 - 2**32 + 1)


def test_config_copy_equals_original():
    from plonky2_bn254_tpu.prover import config as orig
    from plonky2_bn254_tpu_torch.prover import config as copy

    assert [f.name for f in dataclasses.fields(copy.StarkConfig)] == [
        f.name for f in dataclasses.fields(orig.StarkConfig)]
    for name in ("DEFAULT_CONFIG", "TEST_CONFIG"):
        assert dataclasses.asdict(getattr(copy, name)) == dataclasses.asdict(getattr(orig, name))
    assert copy.DEFAULT_CONFIG.rate == orig.DEFAULT_CONFIG.rate


def test_challenger_and_constants_copies_equal_original():
    from plonky2_bn254_tpu.field import poseidon_constants as orig_c
    from plonky2_bn254_tpu.prover.challenger import Challenger as Orig
    from plonky2_bn254_tpu_torch.field import poseidon_constants as copy_c
    from plonky2_bn254_tpu_torch.prover.challenger import Challenger as Copy

    np.testing.assert_array_equal(copy_c.ROUND_CONSTANTS, orig_c.ROUND_CONSTANTS)
    np.testing.assert_array_equal(copy_c.MDS, orig_c.MDS)
    a, b = Copy(), Orig()
    for x in range(23):
        a.observe_element(x * 7919)
        b.observe_element(x * 7919)
        if x % 4 == 0:
            assert a.get_extension_challenge().c1 == b.get_extension_challenge().c1
    assert (a.state, a.input_buffer, a.output_buffer) == (b.state, b.input_buffer, b.output_buffer)


@pytest.mark.parametrize("n1_log, n2_log", [(1, 1), (3, 4), (6, 7)])
def test_parallel_ntt_tables_equal_original(n1_log, n2_log):
    """The mesh transforms' host tables, copied from the JAX package's
    parallel/ntt.py, by value in both directions."""
    from plonky2_bn254_tpu.parallel import ntt as orig
    from plonky2_bn254_tpu_torch.parallel import ntt as copy

    for inverse in (False, True):
        np.testing.assert_array_equal(copy._twiddle_matrix(n1_log, n2_log, inverse),
                                      orig._twiddle_matrix(n1_log, n2_log, inverse))
        n_log, d_log = n1_log + n2_log, min(n1_log, n2_log)
        np.testing.assert_array_equal(copy._dftD_matrix(n_log, d_log, inverse),
                                      orig._dftD_matrix(n_log, d_log, inverse))
        np.testing.assert_array_equal(copy._mid_twiddle(n_log, d_log, inverse),
                                      orig._mid_twiddle(n_log, d_log, inverse))


def test_timing_copy_records_scopes(monkeypatch):
    """Nested scopes record with their depths; `get(None)` is a tree that
    records nothing while tracing is off, and the process's tree, which
    records into the span store, while an enabled tree is alive."""
    import gc

    from plonky2_bn254_tpu_torch.utils import timing
    from plonky2_bn254_tpu_torch.utils.timing import TimingTree, get

    monkeypatch.setattr(timing, "_ALWAYS", False)
    gc.collect()
    timing.reset()
    off = get(None)
    with off.scope("x"):
        pass
    assert off.records == [] and timing.spans() == []
    tt = TimingTree(enabled=True)
    with tt.scope("outer"):
        with tt.scope("inner"):
            with get(None).scope("process"):
                pass
    assert [(d, n) for d, n, _ in tt.records] == [(1, "inner"), (0, "outer")]
    assert tt.total("inner") >= 0.0
    assert get(None) is not off
    assert [(d, n) for d, n, _ in get(None).records] == [(0, "process")]
    assert [s.name for s in timing.spans()] == ["process", "inner", "outer"]
    timing.reset()


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain path; anything else launches a
    kernel or raises."""
    from plonky2_bn254_tpu_torch.field import ntt_cuda, poseidon_cuda

    meta = torch.empty((4, 8), dtype=torch.int64, device="meta")
    for fn in (poseidon_cuda.hash_leaves, poseidon_cuda.permute_states,
               ntt_cuda.ntt, ntt_cuda.intt, lambda x: ntt_cuda.coset_lde(x, 1)):
        with pytest.raises(ValueError):
            fn(meta)


def test_cuda_request_without_gpu_raises(monkeypatch, tmp_path):
    """Without a card, a CUDA input cannot even be made, and the kernel
    library refuses to build without nvcc; neither falls back."""
    from plonky2_bn254_tpu_torch import kernels
    from plonky2_bn254_tpu_torch.field import poseidon_cuda

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the card tests cover this path")
    with pytest.raises((RuntimeError, AssertionError)):
        poseidon_cuda.hash_leaves(torch.zeros((2, 8), dtype=torch.int64, device="cuda"))

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    kernels.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            kernels.library()
    finally:
        kernels.library.cache_clear()


def test_launch_counters_reset():
    from plonky2_bn254_tpu_torch import kernels

    kernels.LAUNCHES["K1"] += 3
    kernels.reset_launches()
    assert dict(kernels.LAUNCHES) == {k: 0 for k in kernels.KERNEL_IDS}


def test_circuit_constants_equal_original():
    """The circuit layer's copied constants, by value."""
    import inspect

    from plonky2_bn254_tpu.circuit import biguint as jbiguint
    from plonky2_bn254_tpu.circuit import builder_ops as jops
    from plonky2_bn254_tpu.circuit import fq as jfq
    from plonky2_bn254_tpu.circuit import outer as jouter
    from plonky2_bn254_tpu.starks import fq_exp as jfq_exp
    from plonky2_bn254_tpu.starks import g1_scalar_mul as jg1
    from plonky2_bn254_tpu.starks import g2_scalar_mul as jg2
    from plonky2_bn254_tpu_torch.circuit import biguint, builder_ops, fq, outer

    assert builder_ops.HOOK_KEY == jops.HOOK_KEY == "bn254"
    assert builder_ops.PERIOD == jfq_exp.FQ_PERIOD == jg1.G1_PERIOD == jg2.G2_PERIOD == 512
    for mod in (jfq_exp, jg1, jg2):
        assert inspect.signature(mod.generate_trace).parameters["min_rows"].default == (
            builder_ops.MIN_ROWS)
    assert (biguint.LIMB_BITS, biguint.LIMB_MASK) == (jbiguint.LIMB_BITS, jbiguint.LIMB_MASK)
    assert fq.NUM_MODULUS_LIMBS == jfq.NUM_MODULUS_LIMBS and fq.P == jfq.P
    assert (outer.W12, outer.Q_TERMS, outer.S_SLOTS, outer.POS_BLOCK) == (
        jouter.W12, jouter.Q_TERMS, jouter.S_SLOTS, jouter.POS_BLOCK)
    props = [n for n, v in vars(jouter.OuterLayout).items() if isinstance(v, property)]
    assert len(props) > 20
    for dims in [(10, 4, 1, 0), (10, 4, 2, 1), (10, 4, 3, 0), (6, 2, 1, 1)]:
        a, b = outer.OuterLayout(*dims), jouter.OuterLayout(*dims)
        assert {n: getattr(a, n) for n in props} == {n: getattr(b, n) for n in props}, dims
