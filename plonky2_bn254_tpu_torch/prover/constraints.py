"""Shared constraint system: AIR + LogUp lookups + CTL bindings.

Port of `plonky2_bn254_tpu/prover/constraints.py`.  One evaluation path
serves the prover (GL ring over the LDE coset) and the verifier (extension
scalars at zeta); the constraint values and their order match the
reference's, so both accumulate the same quotient.

Aux column order (per challenge set, sets concatenated):
  [lookup helpers..., lookup Z] per lookup, then [ctl Z] per CTL.
"""

from __future__ import annotations

from typing import List

import torch

from ..field import goldilocks as gl
from ..starks.table import KeyedLookup, Stark


def _n_entries(lookup) -> int:
    if isinstance(lookup, KeyedLookup):
        return len(lookup.pairs)
    return len(lookup.columns)


def aux_width(stark: Stark, num_challenges: int) -> int:
    per = 0
    for lk in stark.lookups:
        per += (_n_entries(lk) + 1) // 2 + 1
    per += len(stark.ctls)
    return per * num_challenges


def helper_count(lookup) -> int:
    return (_n_entries(lookup) + 1) // 2


def ctl_total(ctl_values_rows: List[List[int]], beta: int, gamma: int) -> int:
    """Host: extra looking sum for one CTL and one challenge set."""
    total = 0
    for row in ctl_values_rows:
        acc = gamma
        b = 1
        for v in row:
            acc = (acc + b * v) % gl.P
            b = b * beta % gl.P
        total = (total + gl.h_inv(acc)) % gl.P
    return total % gl.P


def tree_reduce0(arr: torch.Tensor) -> torch.Tensor:
    """mod-p sum over axis 0 via log-depth halving."""
    while arr.shape[0] > 1:
        m = arr.shape[0]
        if m % 2 == 1:
            arr = torch.cat([gl.add(arr[:1], arr[m - 1 :]), arr[1 : m - 1]], dim=0)
            m -= 1
        half = m // 2
        arr = gl.add(arr[:half], arr[half:])
    return arr[0]


def eval_lookup_ctl_constraints(
    consumer,
    ring,
    stark: Stark,
    local,
    next_,
    aux_local,
    aux_next,
    challenges,
    ctl_totals,
    ctl_weight_specs=None,
):
    """Append lookup/CTL constraints (order must match aux generation).

    `challenges`: list of (beta, gamma) python ints; `ctl_totals[i][c]`
    likewise.  `ctl_weight_specs` (GL ring only): (static column lists per
    ctl, per (challenge, ctl) weight tensors) for the stacked fast path.
    """
    from ..starks.air import GL

    gl_fast = (
        ctl_weight_specs is not None
        and isinstance(local[0], GL)
        and getattr(consumer, "alpha_pows", None) is not None
    )

    for i, (beta, gamma) in enumerate(challenges):
        off = i * (aux_width(stark, 1))
        gamma_v = ring.const(gamma)
        beta_v = ring.const(beta)
        one = ring.one()
        for lk in stark.lookups:
            n_h = helper_count(lk)
            helpers = aux_local[off : off + n_h]
            z_loc = aux_local[off + n_h]
            z_next = aux_next[off + n_h]
            n_ent = _n_entries(lk)
            n_pairs = n_ent // 2
            odd = n_ent % 2 == 1
            keyed = isinstance(lk, KeyedLookup)
            filters = getattr(lk, "filters", None) if keyed else None
            if gl_fast:
                if keyed:
                    kcols = torch.stack([local[k].v for k, _ in lk.pairs])
                    vcols = torch.stack([local[v].v for _, v in lk.pairs])
                    cols = gl.add(kcols, gl.mul(vcols, beta_v.v))
                else:
                    cols = torch.stack([local[c].v for c in lk.columns])
                shifted = gl.add(cols, gamma_v.v[None])
                hs = torch.stack([h.v for h in helpers])
                t1 = shifted[0::2][:n_pairs]
                t2 = shifted[1::2]
                if filters is not None:
                    # helper h = f1/t1 + f2/t2:  h t1 t2 - f1 t2 - f2 t1 = 0
                    fcols = torch.stack(
                        [
                            local[f].v if f is not None else one.v.expand_as(local[0].v)
                            for f in filters
                        ]
                    )
                    f1 = fcols[0::2][:n_pairs]
                    f2 = fcols[1::2]
                    pair_c = gl.sub(
                        gl.mul(gl.mul(hs[:n_pairs], t1), t2),
                        gl.add(gl.mul(f1, t2), gl.mul(f2, t1)),
                    )
                else:
                    pair_c = gl.sub(
                        gl.mul(gl.mul(hs[:n_pairs], t1), t2), gl.add(t1, t2)
                    )
                consumer.constraint_many_arr(pair_c)
                if odd:
                    tail = GL(fcols[-1]) if filters is not None else one
                    consumer.constraint(helpers[-1] * GL(shifted[-1]) - tail)
            else:
                if keyed:
                    entries = [local[k] + local[v] * beta_v for k, v in lk.pairs]
                else:
                    entries = [local[c] for c in lk.columns]

                def fterm(k, t_other):
                    # filter[k] * t_other, skipping the mul when unfiltered
                    if filters is None or filters[k] is None:
                        return t_other
                    return local[filters[k]] * t_other

                for k in range(n_h):
                    t1 = gamma_v + entries[2 * k]
                    if 2 * k + 1 < n_ent:
                        t2 = gamma_v + entries[2 * k + 1]
                        consumer.constraint(
                            helpers[k] * t1 * t2 - fterm(2 * k, t2) - fterm(2 * k + 1, t1)
                        )
                    else:
                        if filters is None or filters[2 * k] is None:
                            consumer.constraint(helpers[k] * t1 - one)
                        else:
                            consumer.constraint(helpers[k] * t1 - local[filters[2 * k]])
            # Z recurrence (backwards sum)
            if keyed:
                table = gamma_v + local[lk.table_key_col] + local[lk.table_val_col] * beta_v
            else:
                table = gamma_v + local[lk.table_col]
            freq = local[lk.freq_col]
            if gl_fast:
                h_sum = GL(tree_reduce0(torch.stack([h.v for h in helpers])))
            else:
                h_sum = helpers[0]
                for h in helpers[1:]:
                    h_sum = h_sum + h
            consumer.constraint_transition((z_loc - z_next - h_sum) * table + freq)
            consumer.constraint_last_row((z_loc - h_sum) * table + freq)
            consumer.constraint_first_row(z_loc)
            off += n_h + 1
        for c_idx, ctl in enumerate(stark.ctls):
            z_loc = aux_local[off]
            z_next = aux_next[off]
            if gl_fast:
                static_cols, weight_arrays = ctl_weight_specs
                gathered = torch.stack([local[c].v for c in static_cols[c_idx]])
                weighted = gl.mul(gathered, weight_arrays[i][c_idx][:, None])
                acc = GL(gl.add(tree_reduce0(weighted), gamma_v.v))
            else:
                combined = ctl.eval_row(local, ring)
                acc = gamma_v
                b_pow = one
                for v in combined:
                    acc = acc + v * b_pow
                    b_pow = b_pow * beta_v
            filt = local[ctl.filter_col]
            consumer.constraint_transition((z_loc - z_next) * acc - filt)
            consumer.constraint_last_row(z_loc * acc - filt)
            consumer.constraint_first_row(z_loc - ring.const(ctl_totals[i][c_idx]))
            off += 1


def eval_all_constraints(
    consumer,
    ring,
    stark: Stark,
    local,
    next_,
    aux_local,
    aux_next,
    challenges,
    ctl_totals,
    ctl_weight_specs=None,
):
    stark.eval_fn(consumer, ring, local, next_)
    eval_lookup_ctl_constraints(
        consumer, ring, stark, local, next_, aux_local, aux_next,
        challenges, ctl_totals, ctl_weight_specs=ctl_weight_specs,
    )
