"""Carry inputs, tables and proofs between numpy and this package.

Residues live in int64 tensors with the u64 bit pattern, so conversion is a
reinterpreting view in both directions.  `proof_to_fields` flattens a
`prover.prove.Proof` (or the JAX package's, which has the same fields) into
numpy arrays and python ints, and `proof_from_fields` rebuilds this
package's `Proof` from them, so the two packages' proofs can be compared and
handed to either verifier.  `outer_tables_to_numpy` / `outer_tables_from_numpy`
carry the outer circuit's constant columns and verifier key between numpy
(the JAX package's `OuterData`) and tensors.  This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_u64(arr: np.ndarray, device=None) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor with the same bit pattern.

    The copy to a card does not wait for the card's queue (a pageable
    source is staged before the call returns), so a constant handed to
    queued work does not stall the host."""
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    return torch.from_numpy(arr.view(np.int64).copy()).to(device, non_blocking=True)


def u64_from_tensor(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array with the same bit pattern."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64).copy()


def _ext_list(vals):
    return [(int(v.c0), int(v.c1)) for v in vals]


def _u64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint64)


def proof_to_fields(proof) -> dict:
    """A Proof as nested dicts/lists of numpy uint64 arrays and python ints,
    keyed by the fields of `Proof`, `Openings`, `FriProof` and
    `FriLayerProof`; extension values become (c0, c1) tuples."""
    o = proof.openings
    return {
        "degree_bits": int(proof.degree_bits),
        "trace_cap": _u64(proof.trace_cap),
        "aux_cap": _u64(proof.aux_cap),
        "quotient_cap": _u64(proof.quotient_cap),
        "openings": {
            name: _ext_list(getattr(o, name))
            for name in ("trace_zeta", "trace_zeta_g", "aux_zeta", "aux_zeta_g",
                         "quotient_zeta", "quotient_zeta_g")
        },
        "fri": {
            "layer_caps": [_u64(c) for c in proof.fri.layer_caps],
            "final_coeffs": _ext_list(proof.fri.final_coeffs),
            "pow_nonce": int(proof.fri.pow_nonce),
        },
        "query_indices": [int(i) for i in proof.query_indices],
        "query_initials": [
            [(_u64(row), [_u64(p) for p in path]) for row, path in q]
            for q in proof.query_initials
        ],
        "fri_query_layers": [
            [{"group_values": _u64(lp.group_values), "path": [_u64(p) for p in lp.path]}
             for lp in q]
            for q in proof.fri_query_layers
        ],
    }


def proof_from_fields(fields: dict):
    """This package's `Proof` from `proof_to_fields` output (of either
    package's proof)."""
    from .field.extension import GLExt
    from .prover import fri, prove

    def ext(vals):
        return [GLExt(c0, c1) for c0, c1 in vals]

    return prove.Proof(
        degree_bits=fields["degree_bits"],
        trace_cap=_u64(fields["trace_cap"]),
        aux_cap=_u64(fields["aux_cap"]),
        quotient_cap=_u64(fields["quotient_cap"]),
        openings=prove.Openings(**{k: ext(v) for k, v in fields["openings"].items()}),
        fri=fri.FriProof(
            layer_caps=[_u64(c) for c in fields["fri"]["layer_caps"]],
            final_coeffs=ext(fields["fri"]["final_coeffs"]),
            pow_nonce=fields["fri"]["pow_nonce"],
        ),
        query_indices=list(fields["query_indices"]),
        query_initials=[
            [(_u64(row), [_u64(p) for p in path]) for row, path in q]
            for q in fields["query_initials"]
        ],
        fri_query_layers=[
            [fri.FriLayerProof(group_values=_u64(lp["group_values"]),
                               path=[_u64(p) for p in lp["path"]]) for lp in q]
            for q in fields["fri_query_layers"]
        ],
    )


def outer_tables_to_numpy(const_cols: torch.Tensor, vk_coeffs: torch.Tensor):
    """The outer circuit's constant columns and verifier key ([n_const, n]
    each) as numpy uint64, the JAX package's `OuterData` layout."""
    return u64_from_tensor(const_cols), u64_from_tensor(vk_coeffs)


def outer_tables_from_numpy(const_cols: np.ndarray, vk_coeffs: np.ndarray, device=None):
    """numpy uint64 constant columns and verifier key -> int64 tensors."""
    return tensor_from_u64(const_cols, device), tensor_from_u64(vk_coeffs, device)
