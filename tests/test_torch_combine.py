"""K7's schedules (`prover/combine_cuda.py`) on the CPU: the emulations of
the openings kernel (K7r: ladder-derived powers, the exact 128-bit sums,
the lanes' shuffles, the tiles' partial sums) and of the FRI oracle's
(K7c: slices over the rows, the fused quotients) against the prover's
plain versions; the grids the shapes give; the prover's openings and
oracle routed through the wrappers; K7's bound.  The kernels themselves
run only on the card (tests/test_torch_cuda.py -k k7)."""

import types

import numpy as np
import pytest
import torch

from plonky2_bn254_tpu_torch import bounds, kernels
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.field.extension import Ext, GLExt
from plonky2_bn254_tpu_torch.interop import tensor_from_u64, u64_from_tensor
from plonky2_bn254_tpu_torch.prover import combine_cuda as cc
from plonky2_bn254_tpu_torch.prover import prove as prove_mod

P1 = gl.P - 1  # every word p - 1: each product and each sum at its largest


def _values(rng, shape, fill=None) -> torch.Tensor:
    if fill is not None:
        return torch.full(shape, gl.i64(fill), dtype=torch.int64)
    return tensor_from_u64(rng.integers(0, gl.P, size=shape, dtype=np.uint64))


def _point(rng, device_tensors: bool, fill=None):
    """A host GLExt, or the same value as an Ext of 0-d tensors (a device
    challenge)."""
    c0, c1 = ((fill, fill) if fill is not None else
              (int(rng.integers(0, gl.P, dtype=np.uint64)),
               int(rng.integers(0, gl.P, dtype=np.uint64))))
    if device_tensors:
        return Ext(*tensor_from_u64(np.array([c0, c1], dtype=np.uint64)))
    return GLExt(c0, c1)


def _plain_openings(coeffs, points, offsets=None):
    offsets = offsets or (None,) * len(points)
    return torch.stack([prove_mod._openings_plain(coeffs, z, None, off)
                        for z, off in zip(points, offsets)])


# (k, n, device challenges, all p - 1): one row, odd k, n below a tile,
# several tiles, the accumulator's worst case
OPENINGS_CASES = {
    "one_row": (1, 1 << 12, False, False),
    "odd_rows": (7, 1 << 11, True, False),
    "below_a_tile": (5, 64, False, False),
    "several_tiles": (3, 1 << 13, True, False),
    "one_tile": (4, 1 << 10, False, False),
    "all_p_minus_1": (3, 1 << 12, False, True),
    "all_p_minus_1_device": (2, 1 << 12, True, True),
}


@pytest.mark.parametrize("case", OPENINGS_CASES)
def test_emulated_openings_equal_the_plain_version(case):
    k, n, on_device, worst = OPENINGS_CASES[case]
    rng = np.random.default_rng(k * n)
    coeffs = _values(rng, (k, n), P1 if worst else None)
    points = [_point(rng, on_device, P1 if worst else None) for _ in range(2)]
    got = cc.emulate_openings(coeffs, points)
    assert got.shape == (2, 2, k)
    assert torch.equal(got, _plain_openings(coeffs, points))


@pytest.mark.parametrize("k, n", [(3, 300), (2, 2 * cc.MAX_TILE + 17)])
def test_emulated_openings_of_ragged_rows_equal_horner(k, n):
    """n not a multiple of the tile nor a power of two (the plain version's
    add tree takes powers of two only), on any 64-bit words: Horner's rule
    over python ints."""
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2**64 - 1, size=(k, n), dtype=np.uint64, endpoint=True)
    points = [_point(rng, False), _point(rng, True)]
    got = u64_from_tensor(cc.emulate_openings(tensor_from_u64(words), points))
    for p, z in enumerate(points):
        z = GLExt(gl.u64(int(z.c0)), gl.u64(int(z.c1)))
        for i, row in enumerate(words):
            acc = GLExt.zero()
            for v in reversed(row):
                acc = acc * z + GLExt(int(v))
            assert (int(got[p, 0, i]), int(got[p, 1, i])) == (acc.c0, acc.c1)


@pytest.mark.parametrize("on_device", [False, True])
def test_emulated_mesh_blocks_sum_to_the_whole_opening(on_device):
    """Each rank's block [k, n/D] with the offsets prove._block_offsets
    gives; the D partial sums added mod p are the whole opening."""
    D, k, n = 4, 3, 1 << 12
    rng = np.random.default_rng(5)
    coeffs = _values(rng, (k, n))
    g = gl.primitive_root_of_unity(12)
    zeta = _point(rng, on_device)
    zeta_g = prove_mod._times_const(zeta, g)
    total = torch.zeros((2, 2, k), dtype=torch.int64)
    for r in range(D):
        offsets = prove_mod._block_offsets(zeta, g, n // D, types.SimpleNamespace(rank=r))
        block = coeffs[:, r * n // D : (r + 1) * n // D]
        total = gl.add(total, cc.emulate_openings(block, (zeta, zeta_g), offsets))
    assert torch.equal(total, _plain_openings(coeffs, (zeta, zeta_g)))


def _oracle_case(rng, rows, N, on_device, worst=False):
    batches = [_values(rng, (r, N), P1 if worst else None) for r in rows]
    alpha = _values(rng, (sum(rows), 2), P1 if worst else None)
    scalars = [_point(rng, on_device, P1 if worst else None) for _ in range(5)]
    return batches, alpha, scalars


def _plain_oracle(batches, alpha, scalars):
    zeta, zeta_g, s_zeta, s_zeta_g, alpha_n = scalars
    return torch.stack(prove_mod._fri_oracle_plain(batches, alpha, s_zeta, s_zeta_g, zeta,
                                                   zeta_g, alpha_n))


# (rows of each batch, coset points, device challenges, all p - 1): one
# slice; three and four batches; rows split over slices; the worst case
ORACLE_CASES = {
    "one_batch": ((6,), 1 << 9, False, False),
    "three_batches": ((5, 4, 2), 1 << 10, True, False),
    "four_batches": ((3, 1, 7, 2), 1 << 9, False, False),
    "sliced_rows": ((150, 60, 4), 1 << 9, True, False),
    "all_p_minus_1": ((7, 3), 1 << 9, False, True),
}


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_emulated_oracle_equals_the_plain_version(case):
    rows, N, on_device, worst = ORACLE_CASES[case]
    batches, alpha, scalars = _oracle_case(np.random.default_rng(N + sum(rows)), rows, N,
                                           on_device, worst)
    if case == "sliced_rows":
        assert cc.oracle_geometry(sum(rows), N, cc.H100_SMS)[0] > 1
    assert torch.equal(cc.emulate_oracle(batches, alpha, scalars),
                       _plain_oracle(batches, alpha, scalars))


def test_emulated_oracle_on_a_mesh_block_is_that_block_of_the_whole():
    """Rank r's LDE block [k, N/D] at the coset points r N/D .. : the
    oracle is pointwise, so it is that block of the whole domain's."""
    D, N = 4, 1 << 10
    batches, alpha, scalars = _oracle_case(np.random.default_rng(9), (5, 3), N, True)
    whole = _plain_oracle(batches, alpha, scalars)
    nb = N // D
    for r in range(D):
        block = [b[:, r * nb : (r + 1) * nb] for b in batches]
        got = cc.emulate_oracle(block, alpha, scalars, x_base=r * nb, n_all=N)
        assert torch.equal(got, whole[:, r * nb : (r + 1) * nb])


# (k, n): the batches' coefficient keys (G2's trace, aux and quotient, G1's
# trace, FqExp's trace, the outer proof's trace at 2^20) and a test size
@pytest.mark.parametrize("k, n", [(1295, 1 << 16), (906, 1 << 16), (4, 1 << 16), (781, 1 << 16),
                                  (427, 1 << 16), (108, 1 << 20), (5, 1 << 8)])
def test_openings_geometry_adapts_to_the_shape(k, n):
    tile, rows = cc.openings_geometry(k, n, cc.H100_SMS)
    tiles = -(-n // tile)
    assert tile % cc.THREADS == 0 and tile <= cc.MAX_TILE and tile >= min(n, cc.MAX_TILE)
    assert rows in cc.ROW_CHOICES
    blocks = tiles * -(-k // rows)
    enough = blocks >= cc.OPENINGS_BLOCKS_PER_SM * cc.H100_SMS
    assert enough or rows == cc.ROW_CHOICES[-1]
    if rows != cc.ROW_CHOICES[0]:  # the next larger block would be too few
        more = cc.ROW_CHOICES[cc.ROW_CHOICES.index(rows) - 1]
        assert tiles * -(-k // more) < cc.OPENINGS_BLOCKS_PER_SM * cc.H100_SMS


@pytest.mark.parametrize("n_polys, n", [(2205, 1 << 17), (1241, 1 << 17), (565, 1 << 17),
                                        (150, 1 << 21), (10, 1 << 9), (0, 1 << 9)])
def test_oracle_geometry_covers_every_row_once(n_polys, n):
    ny, per = cc.oracle_geometry(n_polys, n, cc.H100_SMS)
    assert ny >= 1 and per >= 1
    assert (ny - 1) * per < max(n_polys, 1) <= ny * per or n_polys == 0
    if ny > 1:
        assert per >= cc.ORACLE_MIN_ROWS
    blocks = -(-n // cc.THREADS)
    if blocks >= cc.ORACLE_BLOCKS_PER_SM * cc.H100_SMS:
        assert ny == 1


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(3)
    coeffs = _values(rng, (3, 256))
    points = [_point(rng, False), _point(rng, True)]
    batches, alpha, scalars = _oracle_case(rng, (3, 2), 256, False)
    before = kernels.LAUNCHES["K7"]
    assert torch.equal(prove_mod._openings(coeffs, points), _plain_openings(coeffs, points))
    zeta, zeta_g, s_zeta, s_zeta_g, alpha_n = scalars
    F = prove_mod._fri_oracle(batches, alpha, s_zeta, s_zeta_g, zeta, zeta_g, alpha_n)
    assert torch.equal(torch.stack(F), _plain_oracle(batches, alpha, scalars))
    assert kernels.LAUNCHES["K7"] == before


def test_wrappers_refuse_what_the_kernel_does_not_take():
    meta = torch.ones((2, 8), dtype=torch.int64, device="meta")
    z = GLExt(3, 4)
    with pytest.raises(ValueError):
        cc.openings(meta, (z, z))
    with pytest.raises(ValueError):
        cc.oracle([meta], torch.ones((2, 2), dtype=torch.int64, device="meta"), (z,) * 5)
    before = kernels.LAUNCHES["K7"]
    for bad in (torch.ones((2, 8), dtype=torch.int32), torch.ones(8, dtype=torch.int64)):
        with pytest.raises(ValueError):
            cc.openings(bad, (z, z))
    assert kernels.LAUNCHES["K7"] == before


@pytest.mark.parametrize("machine", ["demo", "keyed_demo"])
@pytest.mark.parametrize("device_fs", [False, True])
def test_the_prover_routes_its_openings_and_oracle_through_k7(machine, device_fs, monkeypatch):
    """With the card's branch taken (the wrappers swapped for their
    emulations), a proof equals the plain versions' proof field by field;
    a proof calls K7r three times (trace, aux, quotient, both points at
    once) and K7c once."""
    import json

    from plonky2_bn254_tpu_torch.interop import proof_to_fields
    from plonky2_bn254_tpu_torch.prover.config import TEST_CONFIG
    from plonky2_bn254_tpu_torch.starks import demo

    mk_stark, mk_trace = {"demo": (demo.demo_stark, demo.demo_trace),
                          "keyed_demo": (demo.keyed_demo_stark, demo.keyed_demo_trace)}[machine]
    trace, ctl = mk_trace(np.random.default_rng(4))
    as_json = lambda p: json.dumps(proof_to_fields(p), default=lambda v: v.tolist())  # noqa: E731
    plain = as_json(prove_mod.prove(mk_stark(), trace, ctl, TEST_CONFIG, device_fs=device_fs))
    calls = []

    def openings(coeffs, points, offsets=None):
        calls.append(("openings", tuple(coeffs.shape), len(points)))
        return cc.emulate_openings(coeffs, points, offsets)

    def oracle(lde_batches, alpha_pows, scalars, x_base=0, n_all=None):
        calls.append(("oracle", tuple(b.shape[0] for b in lde_batches)))
        return cc.emulate_oracle(lde_batches, alpha_pows, scalars, x_base, n_all)

    monkeypatch.setattr(prove_mod, "kernels", types.SimpleNamespace(is_plain=lambda t: False))
    monkeypatch.setattr(cc, "openings", openings)
    monkeypatch.setattr(cc, "oracle", oracle)
    routed = as_json(prove_mod.prove(mk_stark(), trace, ctl, TEST_CONFIG, device_fs=device_fs))
    assert routed == plain
    assert [c[0] for c in calls] == ["openings"] * 3 + ["oracle"]
    assert all(c[2] == 2 for c in calls[:3])


def test_bound_prices_a_product_without_its_reduction():
    wide = bounds.OP_COST["mul"] - bounds.OP_COST["reduce"]
    k, n = 1295, 1 << 16
    ops, nbytes = bounds.combine_work(k, n, 2)
    assert ops == 4 * k * n * wide + 4 * k * bounds.OP_COST["reduce"] + 6 * n * bounds.OP_COST["mul"]
    assert nbytes == 8 * k * n + 32 * k
    assert bounds.bound_ms(ops, nbytes, 132, 1980.0)[1] == "bytes"
    k, N = 2205, 1 << 17
    ops, nbytes = bounds.combine_work(k, N, 2, over_rows=True)
    assert ops == 2 * k * N * wide + 2 * N * bounds.OP_COST["reduce"] + 23 * N * bounds.OP_COST["mul"]
    assert nbytes == 8 * k * N + 16 * k + 16 * N
    assert bounds.bound_ms(ops, nbytes, 132, 1980.0)[1] == "bytes"
    assert bounds.combine_work(0, 0, 2) == (0, 0)
