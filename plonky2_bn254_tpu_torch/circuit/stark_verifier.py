"""Recursive STARK verifier: the native verifier expressed over circuit

Copy of `plonky2_bn254_tpu/circuit/stark_verifier.py`: host Python on ints, which
records the same targets and constraints as the original (tests/test_torch_recursion.py
holds the two packages' circuits equal).
targets.

Rebuild of the reference crate's src/starks/common/verifier.rs:101-185
(`recursive_verifier`): the proof is allocated as witness targets
(`add_virtual_stark_proof`, mirroring starky's
add_virtual_stark_proof_with_pis), the Fiat-Shamir transcript is replayed
with the in-circuit Poseidon challenger, the SAME ring-generic AIR that
drives the prover and native verifier is evaluated at zeta through
`TargetExtRing`, the quotient identity is enforced, the batch-FRI opening
proof is checked query by query (Merkle paths + folds, plonky2-recursive-
FRI style), and the CTL extra looking sums are recomputed in-circuit from
caller-supplied CTL value targets (`sum_ctl_values_circuit`,
ctl_values.rs:49-71) — THE binding that ties the STARK trace to circuit
wires.

`set_stark_proof_target` (generators/g1/stark_proof.rs:173 equivalent)
writes a native `Proof` into the allocated targets at witness time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..field import goldilocks as gl
from ..prover import constraints as cons
from ..prover import fri as fri_mod
from ..prover.config import StarkConfig
from ..starks.air import ConstraintConsumer
from ..starks.table import Stark
from .builder import CircuitBuilder, Target
from .ext_target import ExtTarget, TargetExtRing, random_access, split_le
from .poseidon_gadget import (
    RecursiveChallenger,
    hash_no_pad_targets,
    two_to_one_targets,
)

Digest = List[Target]  # 4 targets


@dataclass
class FriLayerTarget:
    group_values: List[ExtTarget]  # A values
    path: List[Digest]


@dataclass
class QueryTarget:
    initial_leaves: List[List[Target]]  # per batch: width-many targets
    initial_paths: List[List[Digest]]
    layers: List[FriLayerTarget]


@dataclass
class StarkProofTarget:
    degree_bits: int
    trace_cap: List[Digest]
    aux_cap: List[Digest]
    quotient_cap: List[Digest]
    # openings, in verify.py order
    trace_zeta: List[ExtTarget]
    trace_zeta_g: List[ExtTarget]
    aux_zeta: List[ExtTarget]
    aux_zeta_g: List[ExtTarget]
    quotient_zeta: List[ExtTarget]
    quotient_zeta_g: List[ExtTarget]
    fri_layer_caps: List[List[Digest]]
    fri_final_coeffs: List[ExtTarget]
    pow_nonce: Target

    queries: List[QueryTarget]

    def opening_groups(self):
        return (
            (self.trace_zeta, self.trace_zeta_g),
            (self.aux_zeta, self.aux_zeta_g),
            (self.quotient_zeta, self.quotient_zeta_g),
        )


def _widths(stark: Stark, config: StarkConfig):
    w = stark.width
    aux_w = cons.aux_width(stark, config.num_challenges)
    n_quot = 2 * config.num_challenges
    return [w, aux_w, n_quot]


def add_virtual_stark_proof(
    builder: CircuitBuilder, stark: Stark, degree_bits: int, config: StarkConfig
) -> StarkProofTarget:
    """Allocate every proof component as virtual targets (shape is fully
    static given (stark, degree_bits, config))."""
    n_log = degree_bits
    widths = _widths(stark, config)
    cap_len = 1 << config.cap_height

    def digest():
        return builder.add_virtual_targets(4)

    def cap():
        return [digest() for _ in range(cap_len)]

    def exts(n):
        return [
            ExtTarget(builder.add_virtual_target(), builder.add_virtual_target())
            for _ in range(n)
        ]

    layers_cfg, (final_m_log, _final_shift, final_deg_bits) = (
        fri_mod.domain_shifts_and_sizes(n_log, config)
    )
    tree_height = n_log + config.rate_bits - config.cap_height

    queries = []
    for _ in range(config.num_query_rounds):
        initial_leaves = [builder.add_virtual_targets(w) for w in widths]
        initial_paths = [
            [digest() for _ in range(tree_height)] for _ in widths
        ]
        layer_ts = []
        for m_log, _shift, a in layers_cfg:
            cap_h = min(config.cap_height, m_log - a)
            layer_ts.append(
                FriLayerTarget(
                    group_values=exts(1 << a),
                    path=[digest() for _ in range(m_log - a - cap_h)],
                )
            )
        queries.append(
            QueryTarget(
                initial_leaves=initial_leaves,
                initial_paths=initial_paths,
                layers=layer_ts,
            )
        )

    fri_layer_caps = []
    for m_log, _shift, a in layers_cfg:
        cap_h = min(config.cap_height, m_log - a)
        fri_layer_caps.append([digest() for _ in range(1 << cap_h)])

    return StarkProofTarget(
        degree_bits=n_log,
        trace_cap=cap(),
        aux_cap=cap(),
        quotient_cap=cap(),
        trace_zeta=exts(widths[0]),
        trace_zeta_g=exts(widths[0]),
        aux_zeta=exts(widths[1]),
        aux_zeta_g=exts(widths[1]),
        quotient_zeta=exts(widths[2]),
        quotient_zeta_g=exts(widths[2]),
        fri_layer_caps=fri_layer_caps,
        fri_final_coeffs=exts(1 << final_deg_bits),
        pow_nonce=builder.add_virtual_target(),
        queries=queries,
    )


def sum_ctl_values_circuit(
    builder: CircuitBuilder,
    rows: List[List[Target]],
    beta: Target,
    gamma: Target,
) -> Target:
    """total = sum over rows of 1/(gamma + sum_j beta^j v_j), computed over
    targets with hinted inverses (ctl_values.rs:49-71 equivalent)."""
    if not rows:
        return builder.zero()
    max_len = max(len(r) for r in rows)
    beta_pows = [builder.one()]
    for _ in range(max_len - 1):
        beta_pows.append(builder.mul(beta_pows[-1], beta))
    inv_terms = []
    for row in rows:
        acc = gamma
        for v, bp in zip(row, beta_pows):
            acc = builder.add(acc, builder.mul(v, bp))
        inv = builder.add_virtual_target()

        def run(w, acc=acc, inv=inv):
            return {inv.index: gl.h_inv(w[acc.index])}

        from .builder import Generator

        builder.add_generator(Generator([acc.index], [inv.index], run, "ctl_inv"))
        # acc * inv = 1 (combine() is nonzero w.h.p. for honest challenges;
        # the native verifier inverts unconditionally — h_inv(0)=0 would
        # simply fail this constraint, as it should)
        builder.connect(builder.mul(acc, inv), builder.one())
        inv_terms.append(inv)
    return builder.add_linear([(1, t) for t in inv_terms])


def _verify_merkle_path_circuit(
    builder: CircuitBuilder,
    leaf_digest: Digest,
    idx_bits: List[Target],
    path: List[Digest],
    cap: List[Digest],
):
    """Walk the path with bit-selected sibling order; connect to the
    bit-indexed cap entry."""
    h = leaf_digest
    for lvl, sib in enumerate(path):
        bit = idx_bits[lvl]
        left = [builder.select(bit, s, x) for s, x in zip(sib, h)]
        right = [builder.select(bit, x, s) for s, x in zip(sib, h)]
        h = two_to_one_targets(builder, left, right)
    cap_bits = idx_bits[len(path) :]
    if cap_bits:
        expected = random_access(builder, cap_bits, cap)
    else:
        expected = cap[0]
    for a, b in zip(h, expected):
        builder.connect(a, b)


def _pow_of_g_from_bits(
    builder: CircuitBuilder, bits_msb_first: List[Target], g: int
) -> Target:
    """g^i where i's bits are given MSB-first as targets: product of
    selected constant factors g^(2^k)."""
    acc = builder.one()
    n = len(bits_msb_first)
    for k, bit in enumerate(bits_msb_first):
        factor = pow(g, 1 << (n - 1 - k), gl.P)
        sel = builder.select(bit, builder.constant(factor), builder.one())
        acc = builder.mul(acc, sel)
    return acc


def verify_stark_proof_circuit(
    builder: CircuitBuilder,
    stark: Stark,
    proof: StarkProofTarget,
    ctl_value_targets: Dict[int, List[List[Target]]],
    config: StarkConfig,
) -> None:
    """Emit constraints asserting `proof` is a valid STARK proof whose CTL
    values equal `ctl_value_targets` (mirrors prover/verify.py verify())."""
    n_log = proof.degree_bits
    n = 1 << n_log
    big_n_log = n_log + config.rate_bits
    ring = TargetExtRing(builder)
    ops = ring.ops

    # ---- transcript ----------------------------------------------------
    ch = RecursiveChallenger(builder)
    ch.observe_element(builder.constant(n_log))
    ch.observe_cap(proof.trace_cap)
    challenges = [
        (ch.get_challenge(), ch.get_challenge())
        for _ in range(config.num_challenges)
    ]
    ch.observe_cap(proof.aux_cap)
    ctl_totals = [
        [
            sum_ctl_values_circuit(builder, ctl_value_targets[c_idx], beta, gamma)
            for c_idx in range(len(stark.ctls))
        ]
        for (beta, gamma) in challenges
    ]
    alphas = ch.get_n_challenges(config.num_challenges)
    ch.observe_cap(proof.quotient_cap)
    zeta = ch.get_extension_challenge()
    for vals, vals_g in proof.opening_groups():
        for v in vals:
            ch.observe_extension(v)
        for v in vals_g:
            ch.observe_extension(v)
    fri_alpha = ch.get_extension_challenge()

    layers_cfg, (final_m_log, final_shift, final_deg_bits) = (
        fri_mod.domain_shifts_and_sizes(n_log, config)
    )
    betas = []
    for cap in proof.fri_layer_caps:
        ch.observe_cap(cap)
        betas.append(ch.get_extension_challenge())
    for fc in proof.fri_final_coeffs:
        ch.observe_extension(fc)
    # proof of work: the post-nonce challenge has pow_bits high zero bits.
    # split_le's 64-bit decomposition is unique here: the alternative
    # representative v+p always has nonzero top bits (v+p >= p > 2^48).
    ch.observe_element(proof.pow_nonce)
    pow_chal = ch.get_challenge()
    pow_bits_t = split_le(builder, pow_chal, 64)
    for b in pow_bits_t[64 - config.proof_of_work_bits :]:
        builder.assert_zero(b)
    # query indices: low bits of fresh challenges (plonky2-FRI style; the
    # +p representative ambiguity affects only challenges < 2^32, a
    # negligible-probability event the reference's fork accepts as well)
    query_bits = []
    for _ in range(config.num_query_rounds):
        c = ch.get_challenge()
        bits = split_le(builder, c, 64)
        query_bits.append(bits[:big_n_log])

    # ---- constraint identity at zeta -----------------------------------
    g = gl.primitive_root_of_unity(n_log)
    g_last = pow(g, n - 1, gl.P)
    zeta_n = ops.exp_const(zeta, n)
    one_e = ops.constant(1)
    z_h = ops.sub(zeta_n, one_e)
    n_inv = gl.h_inv(n)
    l_first = ops.scalar_mul(
        ops.mul(z_h, ops.inverse(ops.sub(zeta, one_e))), n_inv
    )
    z_last_v = ops.sub(zeta, ops.constant(g_last))
    l_last = ops.scalar_mul(
        ops.mul(z_h, ops.inverse(z_last_v)), g_last * n_inv % gl.P
    )

    consumer = ConstraintConsumer(
        ring,
        [ring.const(a) for a in alphas],
        ring.wrap(z_last_v),
        ring.wrap(l_first),
        ring.wrap(l_last),
    )
    cons.eval_all_constraints(
        consumer,
        ring,
        stark,
        [ring.wrap(v) for v in proof.trace_zeta],
        [ring.wrap(v) for v in proof.trace_zeta_g],
        [ring.wrap(v) for v in proof.aux_zeta],
        [ring.wrap(v) for v in proof.aux_zeta_g],
        challenges,
        ctl_totals,
    )
    for i, acc in enumerate(consumer.accs):
        q = ops.mul_add(
            zeta_n,
            proof.quotient_zeta[2 * i + 1],
            proof.quotient_zeta[2 * i],
        )
        ops.connect(acc.v, ops.mul(z_h, q))

    # ---- FRI ------------------------------------------------------------
    all_zeta = proof.trace_zeta + proof.aux_zeta + proof.quotient_zeta
    all_zeta_g = proof.trace_zeta_g + proof.aux_zeta_g + proof.quotient_zeta_g
    n_polys = len(all_zeta)

    def horner_ext(vals: List[ExtTarget], x: ExtTarget) -> ExtTarget:
        acc = ops.constant(0)
        for v in reversed(vals):
            acc = ops.mul_add(acc, x, v)
        return acc

    S_zeta = horner_ext(all_zeta, fri_alpha)
    S_zeta_g = horner_ext(all_zeta_g, fri_alpha)
    alpha_off = ops.exp_const(fri_alpha, n_polys)
    zeta_g_pt = ops.scalar_mul(zeta, g)

    caps = [proof.trace_cap, proof.aux_cap, proof.quotient_cap]
    g_big = gl.primitive_root_of_unity(big_n_log)
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    widths = _widths(stark, config)

    for qi in range(config.num_query_rounds):
        idx_bits = query_bits[qi]
        qt = proof.queries[qi]
        # initial tree openings
        leaf_vals: List[Target] = []
        for leaf_row, path, cap, w_b in zip(
            qt.initial_leaves, qt.initial_paths, caps, widths
        ):
            assert len(leaf_row) == w_b
            digest = hash_no_pad_targets(builder, leaf_row)
            _verify_merkle_path_circuit(builder, digest, idx_bits, path, cap)
            leaf_vals.extend(leaf_row)
        # x = shift * g_big^(bit_rev(idx)): bit-reversal = feed bits LSB-
        # first as the MSB-first exponent bits
        x = builder.mul_const(
            shift, _pow_of_g_from_bits(builder, idx_bits, g_big)
        )
        x_e = ops.from_base(x)
        # S_x = sum_j alpha^j leaf_j by Horner (leaf values are base-field)
        S_x = ops.constant(0)
        for v in reversed(leaf_vals):
            t = ops.mul(S_x, fri_alpha)
            S_x = ExtTarget(builder.add(t.c0, v), t.c1)
        B = ops.mul(ops.sub(S_x, S_zeta), ops.inverse(ops.sub(x_e, zeta)))
        B_g = ops.mul(
            ops.sub(S_x, S_zeta_g), ops.inverse(ops.sub(x_e, zeta_g_pt))
        )
        cur = ops.add(B, ops.mul(alpha_off, B_g))

        r_bits = idx_bits
        for li, (m_log, l_shift, a) in enumerate(layers_cfg):
            A = 1 << a
            lt = qt.layers[li]
            offset_bits = r_bits[:a]
            group_bits = r_bits[a:]
            # consistency: group_values[offset] == cur
            sel = random_access(
                builder,
                offset_bits,
                [[v.c0, v.c1] for v in lt.group_values],
            )
            builder.connect(sel[0], cur.c0)
            builder.connect(sel[1], cur.c1)
            # Merkle path for the group leaf (interleaved c0,c1 like
            # fri._ext_leaves)
            leaf = []
            for v in lt.group_values:
                leaf.extend([v.c0, v.c1])
            digest = hash_no_pad_targets(builder, leaf)
            cap_h = min(config.cap_height, m_log - a)
            _verify_merkle_path_circuit(
                builder, digest, group_bits, lt.path, proof.fri_layer_caps[li]
            )
            # fold: iNTT of size A (constant matrix) then Horner in
            # beta / x_base
            from ..prover.poly_batch import bit_rev_perm

            rev = bit_rev_perm(a)
            vals_nat: List[ExtTarget] = [None] * A
            for j in range(A):
                vals_nat[int(rev[j])] = lt.group_values[j]
            w_inv = gl.h_inv(gl.primitive_root_of_unity(a))
            A_inv = gl.h_inv(A)
            coeffs = []
            for j in range(A):
                terms0 = []
                terms1 = []
                for t_i in range(A):
                    wp = pow(w_inv, j * t_i, gl.P) * A_inv % gl.P
                    terms0.append((wp, vals_nat[t_i].c0))
                    terms1.append((wp, vals_nat[t_i].c1))
                coeffs.append(
                    ExtTarget(
                        builder.add_linear(terms0), builder.add_linear(terms1)
                    )
                )
            # x_base = l_shift * g_m^(bit_rev(group))
            g_m = gl.primitive_root_of_unity(m_log)
            x_base = builder.mul_const(
                l_shift, _pow_of_g_from_bits(builder, group_bits, g_m)
            )
            # mult = beta / x_base
            x_base_inv = _base_inverse(builder, x_base)
            mult = ops.base_mul(betas[li], x_base_inv)
            acc = ops.constant(0)
            for c in reversed(coeffs):
                acc = ops.mul_add(acc, mult, c)
            cur = acc
            r_bits = group_bits
        # final polynomial check at y = final_shift * g^(bit_rev(r))
        g_f = gl.primitive_root_of_unity(final_m_log)
        y = builder.mul_const(
            final_shift, _pow_of_g_from_bits(builder, r_bits, g_f)
        )
        acc = ops.constant(0)
        for c in reversed(proof.fri_final_coeffs):
            t = ops.base_mul(acc, y)
            acc = ops.add(t, c)
        ops.connect(acc, cur)


def _base_inverse(builder: CircuitBuilder, t: Target) -> Target:
    """Hinted base-field inverse with t * inv = 1 enforced."""
    from .builder import Generator

    inv = builder.add_virtual_target()

    def run(w, t=t, inv=inv):
        return {inv.index: gl.h_inv(w[t.index])}

    builder.add_generator(Generator([t.index], [inv.index], run, "base_inv"))
    builder.connect(builder.mul(t, inv), builder.one())
    return inv


def flatten_proof_targets(proof_t: StarkProofTarget) -> List[Target]:
    """Every Target allocated for the proof, for a generator's output list."""
    out: List[Target] = []

    def ext(e: ExtTarget):
        out.extend([e.c0, e.c1])

    for cap in (proof_t.trace_cap, proof_t.aux_cap, proof_t.quotient_cap):
        for d in cap:
            out.extend(d)
    for group in (
        proof_t.trace_zeta,
        proof_t.trace_zeta_g,
        proof_t.aux_zeta,
        proof_t.aux_zeta_g,
        proof_t.quotient_zeta,
        proof_t.quotient_zeta_g,
        proof_t.fri_final_coeffs,
    ):
        for e in group:
            ext(e)
    for cap in proof_t.fri_layer_caps:
        for d in cap:
            out.extend(d)
    out.append(proof_t.pow_nonce)
    for qt in proof_t.queries:
        for leaf in qt.initial_leaves:
            out.extend(leaf)
        for path in qt.initial_paths:
            for d in path:
                out.extend(d)
        for lt in qt.layers:
            for e in lt.group_values:
                ext(e)
            for d in lt.path:
                out.extend(d)
    return out


# ---------------------------------------------------------------------------
# witness-time proof injection (set_stark_proof_target)
# ---------------------------------------------------------------------------


def set_stark_proof_target(proof_t: StarkProofTarget, proof) -> Dict[int, int]:
    """Map a native prover.Proof onto the allocated targets; returns a
    {target_index: value} dict for a generator to emit."""
    out: Dict[int, int] = {}

    def set_t(t: Target, v: int):
        out[t.index] = int(v) % gl.P

    def set_digest(d: Digest, vals):
        for t, v in zip(d, vals):
            set_t(t, int(v))

    def set_cap(cap_t, cap_vals):
        for d, v in zip(cap_t, cap_vals):
            set_digest(d, v)

    def set_ext(e: ExtTarget, v):
        set_t(e.c0, v.c0)
        set_t(e.c1, v.c1)

    set_cap(proof_t.trace_cap, proof.trace_cap)
    set_cap(proof_t.aux_cap, proof.aux_cap)
    set_cap(proof_t.quotient_cap, proof.quotient_cap)
    o = proof.openings
    for ts, vs in (
        (proof_t.trace_zeta, o.trace_zeta),
        (proof_t.trace_zeta_g, o.trace_zeta_g),
        (proof_t.aux_zeta, o.aux_zeta),
        (proof_t.aux_zeta_g, o.aux_zeta_g),
        (proof_t.quotient_zeta, o.quotient_zeta),
        (proof_t.quotient_zeta_g, o.quotient_zeta_g),
    ):
        assert len(ts) == len(vs), (len(ts), len(vs))
        for t, v in zip(ts, vs):
            set_ext(t, v)
    for cap_t, cap_vals in zip(proof_t.fri_layer_caps, proof.fri.layer_caps):
        set_cap(cap_t, cap_vals)
    for t, v in zip(proof_t.fri_final_coeffs, proof.fri.final_coeffs):
        set_ext(t, v)
    set_t(proof_t.pow_nonce, proof.fri.pow_nonce % gl.P)

    for qi, qt in enumerate(proof_t.queries):
        initials = proof.query_initials[qi]
        for (leaf_row, path), leaf_ts, path_ts in zip(
            initials, qt.initial_leaves, qt.initial_paths
        ):
            for t, v in zip(leaf_ts, leaf_row):
                set_t(t, int(v))
            for d, sib in zip(path_ts, path):
                set_digest(d, sib)
        for lt, lp in zip(qt.layers, proof.fri_query_layers[qi]):
            for et, row in zip(lt.group_values, lp.group_values):
                set_t(et.c0, int(row[0]))
                set_t(et.c1, int(row[1]))
            for d, sib in zip(lt.path, lp.path):
                set_digest(d, sib)
    return out
