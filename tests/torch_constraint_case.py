"""A machine's whole constraint system (AIR, LogUp, CTL), alpha-combined
over random row values: the JAX GL ring's accumulators on its stacked path,
and the port's GL ring's on its stacked or generic path, for the
test_torch_* files of each machine."""

import numpy as np
import jax.numpy as jnp

from plonky2_bn254_tpu.field import goldilocks as jgl
from plonky2_bn254_tpu.prover import constraints as jcons
from plonky2_bn254_tpu.starks import air as jair
from plonky2_bn254_tpu_torch.interop import tensor_from_u64, u64_from_tensor
from plonky2_bn254_tpu_torch.prover import constraints as tcons
from plonky2_bn254_tpu_torch.starks import air as tair

GL_P = jgl.P


def jax_case(jstark, stark, seed: int, C: int = 8) -> dict:
    """Random inputs for `stark` (the port's machine) and the JAX GL ring's
    accumulators on them for `jstark` (the same machine in JAX)."""
    rng = np.random.default_rng(seed)
    aw = tcons.aux_width(stark, 2)
    case = {
        "vals": {k: rng.integers(0, GL_P, (n, C), dtype=np.uint64)
                 for k, n in [("loc", stark.width), ("nxt", stark.width), ("aloc", aw),
                              ("anxt", aw)]},
        "sel": rng.integers(0, GL_P, (3, C), dtype=np.uint64),
        "alphas": [int(x) for x in rng.integers(0, GL_P, 2, dtype=np.uint64)],
        "challenges": [tuple(int(x) for x in rng.integers(0, GL_P, 2, dtype=np.uint64))
                       for _ in range(2)],
        "totals": [[int(x) for x in rng.integers(0, GL_P, 2, dtype=np.uint64)] for _ in range(2)],
    }
    case["alpha_pows"] = np.array([[pow(a, j, GL_P) for j in range(513)] for a in case["alphas"]],
                                  dtype=np.uint64)
    case["static"] = tuple(tuple(c for c, _ in ctl.flat_weights(1, GL_P)) for ctl in jstark.ctls)

    ring = jair.GLRing((C,))
    lj = {k: [jair.GL(jnp.asarray(v[j])) for j in range(v.shape[0])]
          for k, v in case["vals"].items()}
    cj = jair.ConstraintConsumer(ring, [ring.const(jnp.uint64(a)) for a in case["alphas"]],
                                 *(jair.GL(jnp.asarray(s)) for s in case["sel"]),
                                 alpha_pows=jnp.asarray(case["alpha_pows"]))
    wj = [[jnp.asarray(np.array([w for _, w in ctl.flat_weights(b, GL_P)], dtype=np.uint64))
           for ctl in jstark.ctls] for b, _ in case["challenges"]]
    jcons.eval_all_constraints(
        cj, ring, jstark, lj["loc"], lj["nxt"], lj["aloc"], lj["anxt"],
        [(jnp.uint64(b), jnp.uint64(g)) for b, g in case["challenges"]],
        [[jnp.uint64(x) for x in r] for r in case["totals"]],
        ctl_weight_specs=(case["static"], wj),
    )
    case["count"] = cj.count
    case["want"] = np.stack([np.asarray(a.v) for a in cj.accs])
    return case


def port_accs(case: dict, stark, stacked: bool):
    """(constraint count, accumulators as u64) of the port's GL ring."""
    C = case["sel"].shape[1]
    tring = tair.GLRing((C,), "cpu")
    lt = {k: [tair.GL(tensor_from_u64(v[j])) for j in range(v.shape[0])]
          for k, v in case["vals"].items()}
    ct = tair.ConstraintConsumer(
        tring, [tring.const(a) for a in case["alphas"]],
        *(tair.GL(tensor_from_u64(s)) for s in case["sel"]),
        alpha_pows=tensor_from_u64(case["alpha_pows"]) if stacked else None,
    )
    specs = None
    if stacked:
        wt = [[tensor_from_u64(np.array([w for _, w in ctl.flat_weights(b, GL_P)], dtype=np.uint64))
               for ctl in stark.ctls] for b, _ in case["challenges"]]
        specs = (case["static"], wt)
    tcons.eval_all_constraints(ct, tring, stark, lt["loc"], lt["nxt"], lt["aloc"], lt["anxt"],
                               case["challenges"], case["totals"], ctl_weight_specs=specs)
    return ct.count, np.stack([u64_from_tensor(a.v) for a in ct.accs])
