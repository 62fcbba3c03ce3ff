"""The machines whose constraint tapes the tests hold against the eager GL
ring (`prover/tape.py`, K5), with random LDE values and challenges to run
them on.  Imports no JAX, so the card tests (`--noconftest`) use it too.

The mod-zero and G1-add micro machines are the ones
tests/test_torch_micro_starks.py proves; the outer starks are the outer
circuit's at its slot geometry, without and with the Poseidon region, and
at the geometry of the benchmark's two-op circuit.
"""

import numpy as np
import torch

from plonky2_bn254_tpu_torch.circuit import outer
from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.interop import tensor_from_u64
from plonky2_bn254_tpu_torch.prover import constraints as cons
from plonky2_bn254_tpu_torch.prover import device_challenger as dcm
from plonky2_bn254_tpu_torch.prover import prove as prove_mod
from plonky2_bn254_tpu_torch.starks import bigint, fq_mul, g1_add, table
from plonky2_bn254_tpu_torch.starks.demo import demo_stark, keyed_demo_stark
from plonky2_bn254_tpu_torch.starks.layout import G1_ADD_AUX_LAYOUT, MODULUS_ZERO_AUX_LAYOUT, Layout
from plonky2_bn254_tpu_torch.starks.table import CtlSpec, Stark

MZ_LAYOUT = Layout([("a", 16), ("b", 16), ("c", 16), ("aux", MODULUS_ZERO_AUX_LAYOUT),
                    ("filter", 1)])
G1A_LAYOUT = Layout([("ax", 16), ("ay", 16), ("bx", 16), ("by", 16), ("cx", 16), ("cy", 16),
                     ("aux", G1_ADD_AUX_LAYOUT), ("filter", 1)])


def eval_mod_zero(consumer, ring, local, next_):
    v = MZ_LAYOUT.view(local)
    modulus = [ring.const(m) for m in bigint.MOD_LIMBS_INT]
    fq_mul.eval_fq_mul(consumer, ring, v["filter"], modulus, v["a"], v["b"], v["c"], v["aux"])


def eval_g1_add(consumer, ring, local, next_):
    v = G1A_LAYOUT.view(local)
    modulus = [ring.const(m) for m in bigint.MOD_LIMBS_INT]
    g1_add.eval_g1_add(consumer, ring, v["filter"], modulus, {"x": v["ax"], "y": v["ay"]},
                       {"x": v["bx"], "y": v["by"]}, {"x": v["cx"], "y": v["cy"]}, v["aux"])


def mod_zero_stark() -> Stark:
    """a * b = c (mod p) rows, the a, b, c limbs bound through one CTL."""
    return Stark(name="mod_zero_micro", width=MZ_LAYOUT.width, eval_fn=eval_mod_zero,
                 lookups=[], ctls=[CtlSpec(columns=[("single", i) for i in range(48)],
                                           filter_col=MZ_LAYOUT.col("filter"))])


def g1_add_stark() -> Stark:
    """Unified add/double rows, the six coordinates bound through one CTL."""
    return Stark(name="g1_add_micro", width=G1A_LAYOUT.width, eval_fn=eval_g1_add,
                 lookups=[], ctls=[CtlSpec(columns=[("single", i) for i in range(96)],
                                           filter_col=G1A_LAYOUT.col("filter"))])


def outer_stark(R: int = 1, NP: int = 0) -> Stark:
    return outer.outer_stark(outer.OuterLayout(S=outer.S_SLOTS, Q=outer.Q_TERMS, R=R, NP=NP))


MACHINES = {
    "fq_exp": table.fq_exp_stark,
    "g1_scalar_mul": table.g1_scalar_mul_stark,
    "g2_scalar_mul": table.g2_scalar_mul_stark,
    "demo": demo_stark,
    "keyed_demo": keyed_demo_stark,
    "mod_zero": mod_zero_stark,
    "g1_add": g1_add_stark,
    "outer": outer_stark,
    "outer_poseidon": lambda: outer_stark(NP=1),
    # the benchmark's two-op fq_exp circuit: 2^20 x 108
    "outer_circuit2": lambda: outer_stark(R=2, NP=1),
}


def random_case(stark: Stark, n: int, seed: int, nc: int = 2, device="cpu",
                as_tensors: bool = False) -> dict:
    """Random LDE values at n points (local and next rows, trace and aux),
    selectors and challenges; with `as_tensors` the challenges and totals
    are 0-d tensors on `device`, as the device transcript gives them."""
    rng = np.random.default_rng(seed)
    aw = cons.aux_width(stark, nc)

    def vals(*shape):
        return tensor_from_u64(rng.integers(0, gl.P, shape, dtype=np.uint64), device)

    def scalars(k):
        return [int(x) for x in rng.integers(0, gl.P, k, dtype=np.uint64)]

    case = {"t_loc": vals(stark.width, n), "t_nxt": vals(stark.width, n),
            "a_loc": vals(aw, n), "a_nxt": vals(aw, n), "sel": vals(4, n),
            "alphas": scalars(nc),
            "challenges": [tuple(scalars(2)) for _ in range(nc)],
            "totals": [scalars(len(stark.ctls)) for _ in range(nc)]}
    if as_tensors:
        def dev(x):
            return torch.tensor(gl.i64(x), dtype=torch.int64, device=device)

        case["alphas"] = [dev(a) for a in case["alphas"]]
        case["challenges"] = [(dev(b), dev(g)) for b, g in case["challenges"]]
        case["totals"] = torch.tensor([[gl.i64(x) for x in row] for row in case["totals"]],
                                      dtype=torch.int64, device=device).reshape(nc, -1)
    return case


def eager_values(stark: Stark, case: dict) -> torch.Tensor:
    """The prover's eager GL-ring evaluation of `case`, with the CTL weights
    its stacked path reads derived from each beta."""
    betas = [b for b, _ in case["challenges"]]
    if isinstance(betas[0], torch.Tensor):
        weights = [dcm.ctl_weights_device(stark, b) for b in betas]
    else:
        weights = [[tensor_from_u64(np.array([w for _, w in ctl.flat_weights(b, gl.P)],
                                             dtype=np.uint64), case["t_loc"].device)
                    for ctl in stark.ctls] for b in betas]
    return prove_mod._eager_quotient_values(
        stark, case["t_loc"], case["t_nxt"], case["a_loc"], case["a_nxt"], case["sel"],
        case["alphas"], case["challenges"], case["totals"], weights)
