"""A plain verifier of the batch STARK proofs the program makes.

It replays the Fiat-Shamir transcript (a Poseidon duplex sponge over python
ints), evaluates the machine's constraints, lookups and cross-table lookups
at the opening point against the statement it works out itself, checks the
quotient identity, and checks every FRI query: the Merkle paths of the
three committed batches and of each folding layer (hashed in NumPy, a row
per query), the consistency of each fold, and the final polynomial.

The proof comes in as plain data (`proof` below): python ints, lists and
uint64 arrays, in the fields the program's proof object has.  `verify`
returns None for a proof it accepts and the first reason it found for one
it rejects.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import field as F
from .field import Ext
from .stark import Consumer, KeyedLookup, Machine


class Reject(Exception):
    pass


def _check(cond, msg: str) -> None:
    if not cond:
        raise Reject(msg)


class Challenger:
    """The duplex sponge: absorb 8 words a permutation, squeeze from the end."""

    def __init__(self):
        self.state = [0] * F.WIDTH
        self.inputs: List[int] = []
        self.outputs: List[int] = []

    def observe(self, x: int) -> None:
        _check(0 <= x < F.P, "a transcript word is not a field element")
        self.outputs = []
        self.inputs.append(x)
        if len(self.inputs) == F.RATE:
            self._duplex()

    def observe_all(self, xs) -> None:
        for x in xs:
            self.observe(int(x))

    def observe_cap(self, cap) -> None:
        for digest in np.asarray(cap, dtype=np.uint64).reshape(-1, F.DIGEST):
            self.observe_all(digest)

    def observe_ext(self, v: Ext) -> None:
        self.observe_all((v.c0, v.c1))

    def challenge(self) -> int:
        if self.inputs or not self.outputs:
            self._duplex()
        return self.outputs.pop()

    def ext_challenge(self) -> Ext:
        c0 = self.challenge()
        return Ext(c0, self.challenge())

    def _duplex(self) -> None:
        for i, x in enumerate(self.inputs):
            self.state[i] = x
        self.inputs = []
        self.state = F.permute(self.state)
        self.outputs = list(self.state[:F.RATE])


def fri_layers(n_log: int, config: dict):
    """[(m_log, shift, arity bits)] of each folding layer, and the final
    domain's (m_log, shift, degree bits)."""
    out, m_log, shift, deg = [], n_log + config["rate_bits"], F.MULTIPLICATIVE_GROUP_GENERATOR, n_log
    while deg > config["final_poly_degree_bits"]:
        a = min(config["arity_bits"], deg - config["final_poly_degree_bits"])
        out.append((m_log, shift, a))
        shift, m_log, deg = pow(shift, 1 << a, F.P), m_log - a, deg - a
    return out, (m_log, shift, deg)


def _entries(lk) -> int:
    return len(lk.pairs) if isinstance(lk, KeyedLookup) else len(lk.columns)


def aux_width(machine: Machine) -> int:
    """Aux columns a challenge: a lookup's helpers (a pair of entries each)
    and its running sum, then a running sum a cross-table lookup."""
    return sum((_entries(lk) + 1) // 2 + 1 for lk in machine.lookups) + len(machine.ctls)


def ctl_total(rows, beta: int, gamma: int) -> int:
    total = 0
    for row in rows:
        acc, b = gamma, 1
        for v in row:
            acc, b = (acc + b * v) % F.P, b * beta % F.P
        total += F.inv(acc)
    return total % F.P


def eval_lookups_and_ctls(consumer, ring, machine, local, aux_local, aux_next, challenges,
                          totals) -> None:
    per = aux_width(machine)
    for i, (beta, gamma) in enumerate(challenges):
        off = i * per
        gamma_v, beta_v, one = ring.const(gamma), ring.const(beta), ring.one()
        for lk in machine.lookups:
            n_h = (_entries(lk) + 1) // 2
            helpers = aux_local[off:off + n_h]
            z_loc, z_next = aux_local[off + n_h], aux_next[off + n_h]
            keyed = isinstance(lk, KeyedLookup)
            if keyed:
                entries = [local[k] + local[v] * beta_v for k, v in lk.pairs]
                table = gamma_v + local[lk.table_key_col] + local[lk.table_val_col] * beta_v
            else:
                entries = [local[c] for c in lk.columns]
                table = gamma_v + local[lk.table_col]
            filters = lk.filters if keyed and lk.filters else [None] * len(entries)

            def weight(k, term):  # filter k times term, the term alone where unfiltered
                return term if filters[k] is None else local[filters[k]] * term

            for k in range(n_h):
                t1 = gamma_v + entries[2 * k]
                if 2 * k + 1 < len(entries):
                    t2 = gamma_v + entries[2 * k + 1]
                    consumer.constraint(helpers[k] * t1 * t2 - weight(2 * k, t2)
                                        - weight(2 * k + 1, t1))
                else:
                    consumer.constraint(helpers[k] * t1 - weight(2 * k, one))
            freq = local[lk.freq_col]
            h_sum = helpers[0]
            for h in helpers[1:]:
                h_sum = h_sum + h
            consumer.constraint_transition((z_loc - z_next - h_sum) * table + freq)
            consumer.constraint_last_row((z_loc - h_sum) * table + freq)
            consumer.constraint_first_row(z_loc)
            off += n_h + 1
        for c_idx, ctl in enumerate(machine.ctls):
            z_loc, z_next = aux_local[off], aux_next[off]
            acc, b_pow = gamma_v, one
            for v in ctl.eval_row(local):
                acc, b_pow = acc + v * b_pow, b_pow * beta_v
            filt = local[ctl.filter_col]
            consumer.constraint_transition((z_loc - z_next) * acc - filt)
            consumer.constraint_last_row(z_loc * acc - filt)
            consumer.constraint_first_row(z_loc - ring.const(totals[i][c_idx]))
            off += 1


def _exts(pairs) -> List[Ext]:
    return [Ext(int(c0), int(c1)) for c0, c1 in pairs]


def _fold(group_values, x_base: int, beta: Ext, a_bits: int) -> Ext:
    """Interpolate the fiber's values (bit-reversed order at x_base * w^t)
    and evaluate at beta / x_base."""
    size = 1 << a_bits
    vals = [None] * size
    for j in range(size):
        vals[F.bit_reverse(j, a_bits)] = Ext(int(group_values[j][0]), int(group_values[j][1]))
    w_inv, n_inv = F.inv(F.root_of_unity(a_bits)), F.inv(size)
    point, acc, cur = beta.scalar_mul(F.inv(x_base)), Ext(0), Ext(1)
    for j in range(size):
        step, wp, coeff = pow(w_inv, j, F.P), 1, Ext(0)
        for t in range(size):
            coeff = coeff + vals[t].scalar_mul(wp)
            wp = wp * step % F.P
        acc = acc + coeff.scalar_mul(n_inv) * cur
        cur = cur * point
    return acc


def _merkle_batch(rows, indices, paths, cap, what: str) -> None:
    rows = np.asarray(rows, dtype=np.uint64)
    paths = np.asarray(paths, dtype=np.uint64)
    _check(rows.ndim == 2 and paths.ndim == 3 and paths.shape[2] == F.DIGEST, f"{what}: shape")
    ok = F.np_merkle_verify(F.np_hash_no_pad(rows), indices, paths, cap)
    bad = np.flatnonzero(~ok)
    _check(bad.size == 0, f"{what}: Merkle path of query {bad[:1].tolist()} does not reach the cap")


def verify(machine: Machine, proof: dict, ctl_values: Dict[int, list], config: dict,
           degree_bits: int, check_openings=None):
    """None if `proof` proves `ctl_values` for `machine` at `config` over
    2^degree_bits rows, else the first reason for rejecting it.
    `check_openings(zeta, zeta_g, trace_zeta, trace_zeta_g)` may add checks
    of the trace's openings (the outer proof's constant columns); it
    returns a reason to reject or None."""
    try:
        zeta, zeta_g, op = _verify(machine, proof, ctl_values, config, degree_bits)
        if check_openings is not None:
            reason = check_openings(zeta, zeta_g, op["trace_zeta"], op["trace_zeta_g"])
            _check(reason is None, reason or "")
    except Reject as err:
        return str(err)
    except (ValueError, IndexError, KeyError, TypeError, AttributeError, ZeroDivisionError) as err:
        return f"malformed proof: {type(err).__name__}: {err}"
    return None


def _verify(machine, proof, ctl_values, config, degree_bits) -> None:
    nc = config["num_challenges"]
    n_log = proof["degree_bits"]
    _check(n_log == degree_bits, "degree bits differ from the cell's rows")
    n, rate = 1 << n_log, config["rate_bits"]
    big_log = n_log + rate
    w, aux_w, n_quot = machine.width, aux_width(machine) * nc, 2 * nc
    op = {k: _exts(v) for k, v in proof["openings"].items()}
    for name, count in (("trace", w), ("aux", aux_w), ("quotient", n_quot)):
        _check(len(op[f"{name}_zeta"]) == count and len(op[f"{name}_zeta_g"]) == count,
               f"{name} opening count")
    caps = [np.asarray(proof[k], dtype=np.uint64) for k in ("trace_cap", "aux_cap",
                                                           "quotient_cap")]
    for cap in caps:
        _check(cap.shape == (1 << config["cap_height"], F.DIGEST), "cap size")

    # transcript
    ch = Challenger()
    ch.observe(n_log)
    ch.observe_cap(caps[0])
    challenges = [(ch.challenge(), ch.challenge()) for _ in range(nc)]
    ch.observe_cap(caps[1])
    totals = [[ctl_total(ctl_values[c], beta, gamma) for c in range(len(machine.ctls))]
              for beta, gamma in challenges]
    alphas = [ch.challenge() for _ in range(nc)]
    ch.observe_cap(caps[2])
    zeta = ch.ext_challenge()
    for name in ("trace", "aux", "quotient"):
        for v in op[f"{name}_zeta"] + op[f"{name}_zeta_g"]:
            ch.observe_ext(v)
    fri_alpha = ch.ext_challenge()
    layers, (final_m_log, final_shift, final_deg) = fri_layers(n_log, config)
    fri = proof["fri"]
    _check(len(fri["layer_caps"]) == len(layers), "FRI layer count")
    betas = []
    for cap in fri["layer_caps"]:
        ch.observe_cap(cap)
        betas.append(ch.ext_challenge())
    final = _exts(fri["final_coeffs"])
    _check(len(final) == 1 << final_deg, "final polynomial size")
    for c in final:
        ch.observe_ext(c)
    pow_bits, nonce = config["proof_of_work_bits"], int(fri["pow_nonce"])
    ch.observe(nonce % F.P)
    _check(ch.challenge() >> (64 - pow_bits) == 0, "proof of work")
    queries = [ch.challenge() % (n << rate) for _ in range(config["num_query_rounds"])]
    _check(list(proof["query_indices"]) == queries, "query indices")

    # the constraints at zeta
    ring = F.ExtRing()
    g = F.root_of_unity(n_log)
    g_last = pow(g, n - 1, F.P)
    zeta_n = zeta.exp(n)
    z_h = zeta_n - Ext(1)
    _check(not z_h.is_zero(), "zeta in the trace domain")
    n_inv = F.inv(n)
    z_last = zeta - Ext(g_last)
    consumer = Consumer([Ext(a) for a in alphas], z_last,
                        (z_h * (zeta - Ext(1)).inv()).scalar_mul(n_inv),
                        (z_h * z_last.inv()).scalar_mul(g_last * n_inv % F.P))
    machine.eval_fn(consumer, ring, op["trace_zeta"], op["trace_zeta_g"])
    eval_lookups_and_ctls(consumer, ring, machine, op["trace_zeta"], op["aux_zeta"],
                          op["aux_zeta_g"], challenges, totals)
    for i, acc in enumerate(consumer.accs):
        q = op["quotient_zeta"][2 * i] + zeta_n * op["quotient_zeta"][2 * i + 1]
        _check(acc == z_h * q, f"quotient identity (challenge {i})")

    # FRI queries
    vals_zeta = op["trace_zeta"] + op["aux_zeta"] + op["quotient_zeta"]
    vals_zeta_g = op["trace_zeta_g"] + op["aux_zeta_g"] + op["quotient_zeta_g"]
    n_polys = len(vals_zeta)
    alpha_pows = [Ext(1)]
    for _ in range(n_polys - 1):
        alpha_pows.append(alpha_pows[-1] * fri_alpha)
    # value k takes fri_alpha^k (Horner from the last value)
    a0 = [a.c0 for a in alpha_pows]
    a1 = [a.c1 for a in alpha_pows]

    def combine(values) -> Ext:
        acc = Ext(0)
        for v, a in zip(values, alpha_pows):
            acc = acc + v * a
        return acc

    s_zeta, s_zeta_g = combine(vals_zeta), combine(vals_zeta_g)
    alpha_off = fri_alpha.exp(n_polys)
    zeta_g = zeta.scalar_mul(g)
    nq = len(queries)
    idx = np.asarray(queries, dtype=np.int64)
    initials = proof["query_initials"]
    _check(len(initials) == nq and all(len(q) == 3 for q in initials), "initial batches")
    leaf_rows = []
    for b, (cap, width) in enumerate(zip(caps, (w, aux_w, n_quot))):
        rows = np.stack([np.asarray(initials[q][b][0], dtype=np.uint64) for q in range(nq)])
        _check(rows.shape == (nq, width), "leaf width")
        paths = np.stack([np.asarray(initials[q][b][1], dtype=np.uint64).reshape(-1, F.DIGEST)
                          for q in range(nq)])
        _merkle_batch(rows, idx, paths, cap, f"initial batch {b}")
        leaf_rows.append(rows)
    leaves = np.concatenate(leaf_rows, axis=1)

    g_big, shift = F.root_of_unity(big_log), F.MULTIPLICATIVE_GROUP_GENERATOR
    fri_layers_q = proof["fri_query_layers"]
    _check(len(fri_layers_q) == nq and all(len(q) == len(layers) for q in fri_layers_q),
           "FRI query layers")
    # each layer's Merkle paths, a row per query
    r = idx.copy()
    for li, (m_log, _, a) in enumerate(layers):
        groups = np.stack([np.asarray(fri_layers_q[q][li]["group_values"], dtype=np.uint64)
                           for q in range(nq)])
        _check(groups.shape == (nq, 1 << a, 2), "FRI group size")
        paths = np.stack([np.asarray(fri_layers_q[q][li]["path"], dtype=np.uint64)
                          .reshape(-1, F.DIGEST) for q in range(nq)])
        _merkle_batch(groups.reshape(nq, -1), r >> a, paths, fri["layer_caps"][li],
                      f"FRI layer {li}")
        r = r >> a

    for q, index in enumerate(queries):
        row = [int(v) for v in leaves[q]]
        s_x = Ext(sum(v * c for v, c in zip(row, a0)), sum(v * c for v, c in zip(row, a1)))
        x = Ext(shift * pow(g_big, F.bit_reverse(index, big_log), F.P))
        cur = ((s_x - s_zeta) * (x - zeta).inv()
               + alpha_off * (s_x - s_zeta_g) * (x - zeta_g).inv())
        pos = index
        for li, (m_log, layer_shift, a) in enumerate(layers):
            group, offset = pos >> a, pos & ((1 << a) - 1)
            gv = fri_layers_q[q][li]["group_values"]
            _check(Ext(int(gv[offset][0]), int(gv[offset][1])) == cur,
                   f"FRI query {q} layer {li}: value differs from the fold below")
            x_base = layer_shift * pow(F.root_of_unity(m_log), F.bit_reverse(group, m_log - a),
                                       F.P) % F.P
            cur = _fold(gv, x_base, betas[li], a)
            pos = group
        y = final_shift * pow(F.root_of_unity(final_m_log), F.bit_reverse(pos, final_m_log),
                              F.P) % F.P
        acc = Ext(0)
        for c in reversed(final):
            acc = acc.scalar_mul(y) + c
        _check(acc == cur, f"FRI query {q}: final polynomial")
    return zeta, zeta_g, op
