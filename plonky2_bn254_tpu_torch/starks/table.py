"""STARK machine descriptors: lookup specs, CTL specs, machine bundle.

Copy of `plonky2_bn254_tpu/starks/table.py` (tests/test_torch_isolation.py
pins it to the original), holding the machine factories this package
ports.  The `Stark` bundle is consumed by the generic prover in `prover/`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple


@dataclass(frozen=True)
class Lookup:
    """LogUp range-check: every value in `columns` appears in `table_col`
    with multiplicities recorded in `freq_col` (starky Lookup equivalent)."""

    columns: List[int]
    table_col: int
    freq_col: int


@dataclass(frozen=True)
class KeyedLookup:
    """LogUp lookup of (key, value) pairs: every pair in `pairs` (each a
    (key_col, value_col) index pair, combined as key + beta·value under the
    LogUp challenge beta) appears among the table rows
    (table_key_col, table_val_col) with multiplicities in `freq_col`.

    The keyed analog of starky's Lookup — binds a *function* table (e.g. a
    preprocessed gate-selector or witness permutation table) instead of a
    plain membership set. Shares the Lookup helper/Z aux layout; entries
    are the combined pair values.

    `filters` (optional, parallel to `pairs`): a filter column per pair —
    a cell participates in the lookup only where its filter is 1 (filter
    values must be boolean).  `None` entries (or filters=None) mean the
    pair binds on every row.  Used by the outer circuit's Poseidon region,
    whose state cells bind wires only on block boundary rows."""

    pairs: List[Tuple[int, int]]
    table_key_col: int
    table_val_col: int
    freq_col: int
    filters: Tuple = None


@dataclass(frozen=True)
class CtlSpec:
    """One looked-table spec of a cross-table lookup with no looking tables
    (CrossTableLookup::new(vec![], looked) — scalar_mul_ctl.rs pattern).

    `columns`: list of entries ("single", col) or ("le_bits", [cols]) —
    the evaluated tuple is bound against externally supplied CTL values.
    """

    columns: List[Tuple]
    filter_col: int

    def eval_row(self, row_values, ring):
        """Combine a row (list of ring values) into the CTL tuple."""
        out = []
        for kind, spec in [(c[0], c[1]) for c in self.columns]:
            if kind == "single":
                out.append(row_values[spec])
            else:  # le_bits
                acc = None
                for j, col in enumerate(spec):
                    term = row_values[col].scalar_mul(1 << j)
                    acc = term if acc is None else acc + term
                out.append(acc)
        return out

    def flat_weights(self, beta: int, p: int):
        """Host: [(raw column, weight)] s.t. combine(row) = gamma +
        sum w_c * row[c]; weights fold beta^j and le_bits powers of two."""
        out = []
        b_pow = 1
        for kind, spec in [(c[0], c[1]) for c in self.columns]:
            if kind == "single":
                out.append((spec, b_pow))
            else:
                for j, col in enumerate(spec):
                    out.append((col, b_pow * (1 << j) % p))
            b_pow = b_pow * beta % p
        return out


@dataclass(frozen=True)
class Stark:
    """A STARK machine: layout + trace gen + AIR + lookup/CTL wiring."""

    name: str
    width: int
    eval_fn: Callable  # (consumer, ring, local_vals, next_vals) -> None
    lookups: List[Lookup]
    ctls: List[CtlSpec]
    constraint_degree: int = 3


def fq_exp_stark() -> Stark:
    from . import fq_exp

    return Stark(
        name="fq_exp",
        width=fq_exp.LAYOUT.width,
        eval_fn=fq_exp.eval_fq_exp,
        lookups=fq_exp.lookups(),
        ctls=fq_exp.ctls(),
    )


def g1_scalar_mul_stark() -> Stark:
    from . import g1_scalar_mul as g1

    return Stark(
        name="g1_scalar_mul",
        width=g1.LAYOUT.width,
        eval_fn=g1.eval_g1_scalar_mul,
        lookups=g1.lookups(),
        ctls=g1.ctls(),
    )


def g2_scalar_mul_stark() -> Stark:
    from . import g2_scalar_mul as g2

    return Stark(
        name="g2_scalar_mul",
        width=g2.LAYOUT.width,
        eval_fn=g2.eval_g2_scalar_mul,
        lookups=g2.lookups(),
        ctls=g2.ctls(),
    )
