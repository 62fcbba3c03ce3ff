"""The program's proof object as plain data, for the reference to read."""

from __future__ import annotations

import numpy as np


def plain_proof(proof) -> dict:
    """The program's proof object as plain data (ints, lists, uint64 arrays)."""

    def u64(a):
        return np.asarray(a, dtype=np.uint64)

    def exts(vals):
        return [(int(v.c0), int(v.c1)) for v in vals]

    o = proof.openings
    return {
        "degree_bits": int(proof.degree_bits),
        "trace_cap": u64(proof.trace_cap), "aux_cap": u64(proof.aux_cap),
        "quotient_cap": u64(proof.quotient_cap),
        "openings": {k: exts(getattr(o, k)) for k in (
            "trace_zeta", "trace_zeta_g", "aux_zeta", "aux_zeta_g", "quotient_zeta",
            "quotient_zeta_g")},
        "fri": {"layer_caps": [u64(c) for c in proof.fri.layer_caps],
                "final_coeffs": exts(proof.fri.final_coeffs),
                "pow_nonce": int(proof.fri.pow_nonce)},
        "query_indices": [int(i) for i in proof.query_indices],
        "query_initials": [[(u64(row), [u64(p) for p in path]) for row, path in q]
                           for q in proof.query_initials],
        "fri_query_layers": [[{"group_values": u64(lp.group_values),
                               "path": [u64(p) for p in lp.path]} for lp in q]
                             for q in proof.fri_query_layers],
    }
