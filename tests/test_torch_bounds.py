"""The operation counts of `plonky2_bn254_tpu_torch.bounds` against a
butterfly-by-butterfly count of the radix-2 DIF transform, and the launch
keys the wrappers record for the chip smoke's shape list."""

import numpy as np
import pytest

from plonky2_bn254_tpu_torch import bounds, kernels
from plonky2_bn254_tpu_torch.field import ntt_cuda


def dif_counts(n_log: int, live: list) -> tuple:
    """(products, adds, subs) of a radix-2 DIF on 2^n_log words of which
    `live[i]` may be non-zero: a butterfly (a, b) -> (a + b, (a - b) w^e)
    needs the add only if both are live, the sub only if b is, and the
    product only if a or b is and w^e != 1."""
    n = 1 << n_log
    live = list(live)
    prods = adds = subs = 0
    h = n // 2
    while h >= 1:
        for blk in range(0, n, 2 * h):
            for j in range(h):
                a, b = live[blk + j], live[blk + j + h]
                adds += a and b
                subs += b
                prods += (a or b) and j * (n // (2 * h)) % n != 0
                live[blk + j] = live[blk + j + h] = a or b
        h //= 2
    return prods, adds, subs


def ops_of(prods: int, adds: int, subs: int) -> int:
    c = bounds.OP_COST
    return prods * c["mul"] + adds * c["add"] + subs * c["sub"]


@pytest.mark.parametrize("n_log", range(0, 11))
def test_ntt_ops_skip_unit_twiddles(n_log):
    n = 1 << n_log
    ops, nbytes = bounds.ntt_work(3, n, False)
    assert ops == 3 * ops_of(*dif_counts(n_log, [True] * n))
    assert nbytes == 3 * 16 * n


@pytest.mark.parametrize("n_log", range(0, 11))
def test_intt_ops_fold_n_inverse_into_the_four_step_table(n_log):
    """The inverse costs one product more for each unit entry of the
    four-step table w_n^(k1 i2) of the split n1 = 2^ceil, n2 = 2^floor."""
    n = 1 << n_log
    m1 = n_log - n_log // 2
    table = ntt_cuda._four_step(n_log, m1, True, False, "cpu") if n_log else np.ones(1)
    units = int((np.asarray(table) == 1).sum()) if n_log else 0
    fwd, _ = bounds.ntt_work(1, n, False)
    inv, _ = bounds.ntt_work(1, n, True)
    assert inv - fwd == units * bounds.OP_COST["mul"]


@pytest.mark.parametrize("n_log,rate_bits", [(k, r) for k in range(0, 9) for r in range(0, 4)])
def test_coset_lde_ops_skip_the_zero_extension(n_log, rate_bits):
    """Premultiply by shift^i (no product for i = 0), then the DIF on the
    zero-extended row, with no work on words known to be zero."""
    n = 1 << n_log
    big = n_log + rate_bits
    live = [i < n for i in range(1 << big)]
    prods, adds, subs = dif_counts(big, live)
    ops, nbytes = bounds.coset_lde_work(2, n, rate_bits)
    assert ops == 2 * ops_of(prods + n - 1, adds, subs)
    assert nbytes == 2 * 8 * (n + (n << rate_bits))


def test_permutation_ops_sparse_partial_rounds():
    """The sparse partial rounds cost less than the dense MDS form that the
    kernels run, and the full rounds are counted as written."""
    c, t = bounds.OP_COST, bounds.POSEIDON_WIDTH
    full = t * c["add"] + 4 * t * c["mul"] + t * t * c["small_mul"] + t * c["reduce"]
    dense_partial = t * c["add"] + 4 * c["mul"] + t * t * c["small_mul"] + t * c["reduce"]
    dense = 8 * full + 22 * dense_partial
    assert bounds.permutation_ops() < dense
    assert bounds.permutation_ops() > 8 * full + 22 * 4 * c["mul"]
    ops, nbytes = bounds.hash_leaves_work(5, 17)
    assert ops == 5 * 3 * bounds.permutation_ops() and nbytes == 5 * (17 + 4) * 8


def test_bound_takes_the_larger_time():
    sms, mhz = 132, 1980.0
    t_ops, by = bounds.bound_ms(int(1e12), 0, sms, mhz)
    assert by == "operations"
    assert t_ops == pytest.approx(1e3 * 1e12 / (128 * sms * mhz * 1e6))
    t_bytes, by = bounds.bound_ms(0, int(3.35e9), sms, mhz)
    assert by == "bytes" and t_bytes == pytest.approx(1.0)


def test_count_launch_records_keys():
    kernels.reset_launches()
    kernels.count_launch("K3", (2, 8, 8, True))
    kernels.count_launch("K3", (2, 8, 8, True))
    kernels.count_launch("K4", (2, 8, 16, False))
    assert kernels.LAUNCHES["K3"] == 2 and kernels.CALLS["K3"] == {(2, 8, 8, True): 2}
    kernels.reset_launches()
    assert all(not kernels.CALLS[k] for k in kernels.KERNEL_IDS)
