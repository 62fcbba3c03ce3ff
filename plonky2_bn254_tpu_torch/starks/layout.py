"""Declarative column layouts over `[rows, width]` trace tensors.

Replaces the reference's `#[repr(C)]` unsafe row-view structs
(e.g. the reference crate's src/starks/fields/exp_view.rs:31-83) with a named
layout spec; the reference's `row_position_correctness` layout tests
(SURVEY.md §4.5) are preserved against these offsets.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

Spec = List[Tuple[str, Union[int, "Layout"]]]


class Layout:
    def __init__(self, spec: Spec):
        self.spec = spec
        self.offsets: Dict[str, int] = {}
        self.sizes: Dict[str, Union[int, "Layout"]] = {}
        off = 0
        for name, size in spec:
            self.offsets[name] = off
            self.sizes[name] = size
            off += size.width if isinstance(size, Layout) else size
        self.width = off

    def range(self, *path) -> range:
        """Column range of a (possibly nested) field."""
        lay, off = self, 0
        for name in path:
            off += lay.offsets[name]
            sub = lay.sizes[name]
            if isinstance(sub, Layout):
                lay = sub
            else:
                return range(off, off + sub)
        return range(off, off + lay.width)

    def col(self, *path) -> int:
        r = self.range(*path)
        assert len(r) == 1, path
        return r.start

    def view(self, row_values):
        """List of `width` ring values -> nested dict view.

        Size-1 fields become scalars; size-n fields become lists;
        sub-layouts become nested dicts.
        """
        out = {}
        for name, size in self.spec:
            off = self.offsets[name]
            if isinstance(size, Layout):
                out[name] = size.view(row_values[off : off + size.width])
            elif size == 1:
                out[name] = row_values[off]
            else:
                out[name] = list(row_values[off : off + size])
        return out


ROUND_FLAGS_LAYOUT = Layout(
    [
        ("is_first_round", 1),
        ("is_last_round", 1),
        ("counter", 1),
        ("inv_counter", 1),
        ("inv_counter_prime", 1),
    ]
)

MODULUS_ZERO_AUX_LAYOUT = Layout(
    [
        ("is_quot_positive", 1),
        ("quot_abs", 17),
        ("aux_lo", 31),
        ("aux_hi", 31),
    ]
)

IS_MODULUS_ZERO_AUX_LAYOUT = Layout(
    [
        ("inv", 16),
        ("modulus_zero_aux", MODULUS_ZERO_AUX_LAYOUT),
    ]
)

G1_ADD_AUX_LAYOUT = Layout(
    [
        ("is_x_eq", 1),
        ("is_x_eq_aux", IS_MODULUS_ZERO_AUX_LAYOUT),
        ("is_x_eq_filter", 1),
        ("lambda", 16),
        ("lambda_aux", MODULUS_ZERO_AUX_LAYOUT),
        ("x_aux", MODULUS_ZERO_AUX_LAYOUT),
        ("y_aux", MODULUS_ZERO_AUX_LAYOUT),
    ]
)
