"""Native STARK verifier (host, python ints / GLExt scalars).

Port of `plonky2_bn254_tpu/prover/verify.py` onto this package's host code:
recompute the Fiat-Shamir transcript, re-evaluate the same constraint set
at zeta through the extension-scalar ring, check the quotient identity and
the CTL extra looking sums, and verify the batch-FRI opening proof.
"""

from __future__ import annotations

from typing import Dict, List

from ..field import goldilocks as gl
from ..field import poseidon
from ..field.extension import GLExt
from ..starks.air import ConstraintConsumer, HostExtRing
from ..starks.table import Stark
from . import constraints as cons
from . import fri as fri_mod
from .challenger import Challenger
from .config import StarkConfig
from .merkle import MerkleTree
from .poly_batch import bit_rev_perm
from .prove import Proof


class VerificationError(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise VerificationError(msg)


def verify(
    stark: Stark,
    proof: Proof,
    ctl_values: Dict[int, List[List[int]]],
    config: StarkConfig,
) -> GLExt:
    """Full native verification; returns the opening point `zeta` so
    wrappers (e.g. the outer circuit verifier) can pin additional
    polynomial evaluations against the same transcript point."""
    n_log = proof.degree_bits
    n = 1 << n_log
    N = n << config.rate_bits
    w = stark.width
    aux_w = cons.aux_width(stark, config.num_challenges)
    n_quot = 2 * config.num_challenges

    _check(len(proof.openings.trace_zeta) == w, "trace opening count")
    _check(len(proof.openings.aux_zeta) == aux_w, "aux opening count")
    _check(len(proof.openings.quotient_zeta) == n_quot, "quotient opening count")

    # ---- transcript ----------------------------------------------------
    ch = Challenger()
    ch.observe_element(n_log)
    ch.observe_cap(proof.trace_cap)
    challenges = [
        (ch.get_challenge(), ch.get_challenge())
        for _ in range(config.num_challenges)
    ]
    ch.observe_cap(proof.aux_cap)
    ctl_totals = [
        [
            cons.ctl_total(ctl_values[c_idx], beta, gamma)
            for c_idx in range(len(stark.ctls))
        ]
        for (beta, gamma) in challenges
    ]
    alphas = ch.get_n_challenges(config.num_challenges)
    ch.observe_cap(proof.quotient_cap)
    zeta = ch.get_extension_challenge()
    for vals, vals_g in proof.openings.all_polys_order():
        for v in vals:
            ch.observe_extension(v)
        for v in vals_g:
            ch.observe_extension(v)
    fri_alpha = ch.get_extension_challenge()

    # FRI transcript
    layers_cfg, (final_m_log, final_shift, final_deg_bits) = (
        fri_mod.domain_shifts_and_sizes(n_log, config)
    )
    _check(len(proof.fri.layer_caps) == len(layers_cfg), "fri layer count")
    betas = []
    for cap in proof.fri.layer_caps:
        ch.observe_cap(cap)
        betas.append(ch.get_extension_challenge())
    _check(
        len(proof.fri.final_coeffs) == 1 << final_deg_bits, "final poly size"
    )
    for fc in proof.fri.final_coeffs:
        ch.observe_extension(fc)
    _check(
        fri_mod.pow_check(ch, proof.fri.pow_nonce, config.proof_of_work_bits),
        "proof of work",
    )
    ch.observe_element(proof.fri.pow_nonce % gl.P)
    val = ch.get_challenge()
    _check(val >> (64 - config.proof_of_work_bits) == 0, "pow challenge")
    query_indices = [
        ch.get_challenge() % N for _ in range(config.num_query_rounds)
    ]
    _check(query_indices == proof.query_indices, "query indices")

    # ---- constraint identity at zeta -----------------------------------
    ring = HostExtRing()
    g = gl.primitive_root_of_unity(n_log)
    g_last = pow(g, n - 1, gl.P)
    zeta_n = zeta.exp(n)
    z_h = zeta_n - GLExt(1)
    _check(not z_h.is_zero(), "zeta in trace domain")
    n_inv = gl.h_inv(n)
    l_first = z_h * (zeta - GLExt(1)).inv()
    l_first = l_first.scalar_mul(n_inv)
    z_last_v = zeta - GLExt(g_last)
    l_last = z_h * z_last_v.inv()
    l_last = l_last.scalar_mul(g_last * n_inv % gl.P)

    consumer = ConstraintConsumer(
        ring, [GLExt(a) for a in alphas], z_last_v, l_first, l_last
    )
    cons.eval_all_constraints(
        consumer,
        ring,
        stark,
        proof.openings.trace_zeta,
        proof.openings.trace_zeta_g,
        proof.openings.aux_zeta,
        proof.openings.aux_zeta_g,
        challenges,
        ctl_totals,
    )
    for i, acc in enumerate(consumer.accs):
        q = (
            proof.openings.quotient_zeta[2 * i]
            + zeta_n * proof.openings.quotient_zeta[2 * i + 1]
        )
        _check(acc == z_h * q, f"quotient identity (challenge {i})")

    # ---- FRI queries ----------------------------------------------------
    vals_zeta = (
        proof.openings.trace_zeta
        + proof.openings.aux_zeta
        + proof.openings.quotient_zeta
    )
    vals_zeta_g = (
        proof.openings.trace_zeta_g
        + proof.openings.aux_zeta_g
        + proof.openings.quotient_zeta_g
    )
    n_polys = len(vals_zeta)

    def horner(vals: List[GLExt], x: GLExt) -> GLExt:
        acc = GLExt.zero()
        for v in reversed(vals):
            acc = acc * x + v
        return acc

    S_zeta = horner(vals_zeta, fri_alpha)
    S_zeta_g = horner(vals_zeta_g, fri_alpha)
    alpha_off = fri_alpha.exp(n_polys)
    zeta_g_pt = zeta.scalar_mul(g)

    caps = [proof.trace_cap, proof.aux_cap, proof.quotient_cap]
    widths = [w, aux_w, n_quot]
    big_perm = bit_rev_perm(n_log + config.rate_bits)
    g_big = gl.primitive_root_of_unity(n_log + config.rate_bits)
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR

    for qi, idx in enumerate(query_indices):
        initials = proof.query_initials[qi]
        _check(len(initials) == 3, "initial batch count")
        leaf_vals: List[int] = []
        for (leaf_row, path), cap, width in zip(initials, caps, widths):
            _check(len(leaf_row) == width, "leaf width")
            digest = poseidon.h_hash_no_pad([int(v) for v in leaf_row])
            _check(
                MerkleTree.verify(digest, idx, path, cap),
                f"initial merkle path (query {qi})",
            )
            leaf_vals.extend(int(v) for v in leaf_row)
        x = shift * pow(g_big, int(big_perm[idx]), gl.P) % gl.P
        S_x = horner([GLExt(v) for v in leaf_vals], fri_alpha)
        B = (S_x - S_zeta) * (GLExt(x) - zeta).inv()
        B_g = (S_x - S_zeta_g) * (GLExt(x) - zeta_g_pt).inv()
        F_x = B + alpha_off * B_g
        _check(
            fri_mod.verify_fri_query(
                proof.fri,
                betas,
                idx,
                F_x,
                n_log,
                config,
                proof.fri_query_layers[qi],
            ),
            f"fri query {qi}",
        )
    return zeta
