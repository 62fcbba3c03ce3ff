"""Outer circuit proof: a PLONKish universal-gate STARK over the recorded
constraint system.

Port of `plonky2_bn254_tpu/circuit/outer.py`: the recipe compiler and the
layout are host Python copied from the original; the constant columns, the
verifier key and the outer trace are int64 Goldilocks tensors built on the
compile device (the card unless the caller passes `device="cpu"`), and the
prover is this package's `prover.prove` (K1-K4 on the card).

The outer proof plays the role of the plonky2 PLONK+FRI prover the
reference gets from its fork (the outer proof of the user circuit;
`src/builder.rs` + plonky2 build/prove).  It is NOT a translation of
plonky2's gate system:
instead of plonky2's fixed gate menu + copy-constraint permutation argument,
the whole circuit compiles onto ONE universal gate row form evaluated by the
existing batched STARK prover (`prover/prove.py`), with wires bound by a
LogUp keyed lookup instead of a sigma permutation:

  gate row:   sum_k q_k * v_{2k} * v_{2k+1}            (Q quadratic terms)
            + sum_j c_j * v_j                          (S linear slot terms)
            + sum_j e_j * r_j                          (R range-limb terms)
            + c0                                     == 0

  - v_j  : wire-slot value columns.  Every (idx_j, v_j) pair of every row
           is bound by a `KeyedLookup` against the witness table columns
           (wit_key = row index, wit_val = the committed witness vector),
           so v_j == witness[idx_j] — the PLONK copy-constraint role,
           played by LogUp (reference sigma polys have no counterpart).
  - r_j  : range-limb columns, bound by a plain `Lookup` against a
           2^B-entry range table column (range checks recorded by the
           gadget layer via `biguint.range_check`).
  - q,c,e,c0, idx, wit_key, is_pub, range_table are CONSTANT columns:
    fixed by the circuit, independent of the witness.  They are pinned by
    the verifier key: vk stores their coefficient form, and `verify_outer`
    checks the proof's trace openings of those columns at zeta / zeta*g
    against vk evaluations (Schwartz–Zippel on the committed trace — the
    analog of plonky2's constants_sigmas_cap check).
  - public inputs ride the existing CTL machinery: a `CtlSpec` over
    (wit_key, wit_val) filtered by the constant is_pub column binds the
    multiset {(public wire index, value)} to verifier-supplied values.

Templates recorded by the builder can have any monomial degree (the
Poseidon gadget's sbox template is (x+c)^7); `_rewrite_template` reduces
them to the degree<=2 gate form with auxiliary wires (product chains and
partial-sum accumulators), so the AIR stays degree 3 (q*v*v) and the
prover's rate-1/2 LDE is unchanged.

Reference parity: plonky2 `CircuitBuilder::build` / `prove` / `verify`
as consumed by the reference crate's src/builder.rs:178-260 (outer circuit
build+prove around the BN254 STARK hook).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..field import goldilocks as gl
from ..interop import tensor_from_u64, u64_from_tensor
from ..starks.table import CtlSpec, KeyedLookup, Lookup, Stark
from .builder import Circuit, witness_tensor

P = gl.P

# gate geometry: Q quad terms on slot pairs (2k, 2k+1), S wire slots,
# R range-limb columns (R is computed from the circuit's range checks).
Q_TERMS = 4
S_SLOTS = 10
# Poseidon region: rows per permutation block (30 round rows + output row;
# no pad row needed — `pactive` is 0 on the output row, so the transition
# into the next block is unconstrained)
POS_BLOCK = 31


# ---------------------------------------------------------------------------
# recipe IR: one template/constraint shape -> universal gate rows
# ---------------------------------------------------------------------------

# A Ref names a value available while instantiating one template row:
#   ("s", i)  — template var slot i (a circuit wire id per instance)
#   ("a", j)  — template-local auxiliary wire j (fresh per instance)
Ref = Tuple[str, int]


@dataclass
class RecipeRow:
    """One universal gate row, symbolic over a template instance."""

    quads: List[Tuple[int, Ref, Ref]]  # (coeff, ref_a, ref_b)
    lins: List[Tuple[int, Ref]]  # (coeff, ref)
    const: int = 0
    out: Optional[Ref] = None  # aux defined by this row (its lin coeff is -1)
    # range-limb cells: (e_coeff, spec); spec = ("shr", ref, shift) meaning
    # (value(ref) >> shift) & (2^B - 1), or ("shl", ref, shift) meaning
    # value(ref) << shift (honest values fit in B bits).
    rcols: List[Tuple[int, Tuple]] = None

    def __post_init__(self):
        if self.rcols is None:
            self.rcols = []


@dataclass
class Recipe:
    rows: List[RecipeRow]
    n_aux: int
    n_vars: int


def _reduce_monomials(monomials, new_aux, aux_rows):
    """Degree-reduce: any monomial with >2 factors gets product-chain aux
    wires (cached per factor pair so x^k powers share prefixes)."""
    cache: Dict[Tuple[Ref, Ref], Ref] = {}
    out = []
    for coeff, slots in monomials:
        factors = sorted(("s", s) for s in slots)
        while len(factors) > 2:
            a, b = factors[0], factors[1]
            m = cache.get((a, b))
            if m is None:
                m = new_aux()
                cache[(a, b)] = m
                aux_rows.append(
                    RecipeRow(quads=[(1, a, b)], lins=[(P - 1, m)], out=m)
                )
            factors = sorted([m] + factors[2:])
        out.append((coeff % P, factors))
    return out


def _pack(quads, lins, const, new_aux) -> List[RecipeRow]:
    """Pack terms summing to zero into gate rows, chaining through
    partial-sum accumulator aux wires when one row's capacity (Q quads,
    S slots) is exceeded."""
    rows: List[RecipeRow] = []
    rq = list(quads)
    rl = list(lins)
    carry: Optional[Ref] = None
    while True:
        # slot accounting mirrors _row_layout: each quad claims 2 dedicated
        # slots (even if operands repeat across quads); a linear term
        # attaches to a matching quad slot for free, else needs a new slot.
        row_q: List[Tuple[int, Ref, Ref]] = []
        quad_refs: List[Ref] = []
        lin_only: List[Ref] = []
        row_lin: Dict[Ref, int] = {}
        if carry is not None:
            rl.insert(0, (1, carry))
            carry = None

        def slots_used():
            return 2 * len(row_q) + len(lin_only)

        while rq and len(row_q) < Q_TERMS and slots_used() + 2 <= S_SLOTS - 1:
            coeff, a, b = rq.pop()
            row_q.append((coeff, a, b))
            quad_refs.extend((a, b))
        while rl:
            coeff, ref = rl[0]
            free = ref in quad_refs or ref in lin_only
            if not free and slots_used() >= S_SLOTS - 1:
                break
            if not free:
                lin_only.append(ref)
            row_lin[ref] = (row_lin.get(ref, 0) + coeff) % P
            rl.pop(0)
        done = not rq and not rl
        if done:
            rows.append(
                RecipeRow(
                    quads=row_q,
                    lins=[(c, r) for r, c in row_lin.items()],
                    const=const % P,
                )
            )
            return rows
        acc = new_aux()
        rows.append(
            RecipeRow(
                quads=row_q,
                lins=[(c, r) for r, c in row_lin.items()] + [(P - 1, acc)],
                out=acc,
            )
        )
        carry = acc


def _rewrite_template(monomials) -> Recipe:
    """Template monomials (coeff, slot tuple) summing to zero -> recipe."""
    n_vars = 1 + max(
        (max(s) for _, s in monomials if s), default=-1
    )
    aux_counter = [0]
    aux_rows: List[RecipeRow] = []

    def new_aux() -> Ref:
        j = aux_counter[0]
        aux_counter[0] += 1
        return ("a", j)

    reduced = _reduce_monomials(monomials, new_aux, aux_rows)
    quads = []
    lins = []
    const = 0
    for coeff, factors in reduced:
        if len(factors) == 2:
            quads.append((coeff, factors[0], factors[1]))
        elif len(factors) == 1:
            lins.append((coeff, factors[0]))
        else:
            const = (const + coeff) % P
    main_rows = _pack(quads, lins, const, new_aux)
    return Recipe(rows=aux_rows + main_rows, n_aux=aux_counter[0], n_vars=n_vars)


def _range_recipe(bits: int, table_bits: int):
    """Recipe for `wire < 2^bits` (var slot 0 = the wire), using base-2^B
    limb columns.  Returns (recipe, n_limb_cols_used)."""
    B = table_bits
    aux_counter = [0]

    def new_aux() -> Ref:
        j = aux_counter[0]
        aux_counter[0] += 1
        return ("a", j)

    v: Ref = ("s", 0)
    rows: List[RecipeRow] = []
    max_r = 0
    if bits <= B:
        # v - r0 == 0 pins v < 2^B; v*2^(B-bits) - r0' == 0 tightens to
        # 2^bits (no field wrap: v < 2^B so the product < 2^(2B-bits) < P).
        rows.append(RecipeRow(quads=[], lins=[(1, v)], rcols=[(P - 1, ("shr", v, 0))]))
        max_r = 1
        if bits < B:
            rows.append(
                RecipeRow(
                    quads=[],
                    lins=[(pow(2, B - bits, P), v)],
                    rcols=[(P - 1, ("shl", v, B - bits))],
                )
            )
    else:
        k = -(-bits // B)
        b_top = bits - (k - 1) * B
        if b_top == B:
            # v == sum r_j * 2^(jB), all limbs direct range cells
            rows.append(
                RecipeRow(
                    quads=[],
                    lins=[(1, v)],
                    rcols=[
                        (P - pow(2, j * B, P), ("shr", v, j * B))
                        for j in range(k)
                    ],
                )
            )
            max_r = k
        else:
            # top limb must be tightened below 2^b_top: give it an aux
            # wire t (appears in two equations, so it must be a wire).
            t = new_aux()
            rows.append(
                RecipeRow(
                    quads=[],
                    lins=[(P - 1, t)],
                    out=t,
                    rcols=[(1, ("shr", v, (k - 1) * B))],
                )
            )
            rows.append(
                RecipeRow(
                    quads=[],
                    lins=[(1, v), (P - pow(2, (k - 1) * B, P), t)],
                    rcols=[
                        (P - pow(2, j * B, P), ("shr", v, j * B))
                        for j in range(k - 1)
                    ],
                )
            )
            rows.append(
                RecipeRow(
                    quads=[],
                    lins=[(pow(2, B - b_top, P), t)],
                    rcols=[(P - 1, ("shl_aux", t, B - b_top))],
                )
            )
            max_r = max(k - 1, 1)
    return Recipe(rows=rows, n_aux=aux_counter[0], n_vars=1), max_r


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


W12 = 12  # Poseidon width


@dataclass(frozen=True)
class OuterLayout:
    S: int
    Q: int
    R: int
    NP: int = 0  # 1 when the Poseidon-round region is present

    @property
    def v(self):
        return 0

    @property
    def r(self):
        return self.S

    @property
    def wit_val(self):
        return self.S + self.R

    @property
    def wfreq(self):
        return self.S + self.R + 1

    @property
    def rfreq(self):
        return self.S + self.R + 2

    # --- Poseidon region witness columns (present when NP) ---------------
    @property
    def ps(self):  # 12 state lanes (round-boundary states)
        return self.S + self.R + 3

    @property
    def px3(self):  # 12 sbox aux: (s+rc)^3
        return self.ps + W12

    @property
    def px7(self):  # 12 sbox aux: (s+rc)^7
        return self.px3 + W12

    @property
    def idx(self):
        return self.S + self.R + 3 + (3 * W12 if self.NP else 0)

    @property
    def qcol(self):
        return self.idx + self.S

    @property
    def ccol(self):
        return self.qcol + self.Q

    @property
    def ecol(self):
        return self.ccol + self.S

    @property
    def c0col(self):
        return self.ecol + self.R

    @property
    def wit_key(self):
        return self.c0col + 1

    @property
    def is_pub(self):
        return self.wit_key + 1

    @property
    def range_table(self):
        return self.is_pub + 1

    # --- Poseidon region constant columns (after range_table when NP) ----
    @property
    def prc(self):  # 12 per-row round constants
        return self.range_table + 1

    @property
    def pidx(self):  # 12 wire ids (binding rows only)
        return self.prc + W12

    @property
    def pactive(self):  # 1 on round rows 0..29 of each block
        return self.pidx + W12

    @property
    def pfull(self):  # 1 on full-round rows
        return self.pactive + 1

    @property
    def pbind(self):  # 1 on block rows 0 (inputs) and 30 (outputs)
        return self.pfull + 1

    @property
    def width(self):
        return self.range_table + 1 + ((2 * W12 + 3) if self.NP else 0)

    @property
    def const_cols(self):
        return list(range(self.idx, self.width))


def _make_eval_fn(lay: OuterLayout):
    from ..field.poseidon_constants import MDS as _MDS

    mds = [[int(x) for x in row] for row in _MDS]

    def eval_outer_gate(consumer, ring, local, next_):
        acc = local[lay.c0col]
        for k in range(lay.Q):
            acc = acc + local[lay.qcol + k] * (
                local[lay.v + 2 * k] * local[lay.v + 2 * k + 1]
            )
        for j in range(lay.S):
            acc = acc + local[lay.ccol + j] * local[lay.v + j]
        for j in range(lay.R):
            acc = acc + local[lay.ecol + j] * local[lay.r + j]
        consumer.constraint(acc)

        if not lay.NP:
            return
        # --- Poseidon-round region (plonky2 PoseidonGate analog) ---------
        # Row r of a 32-row block holds the state BEFORE round r (r<30);
        # row 30 holds the output state; row 31 pads.  u = state + rc;
        # x3/x7 are unfiltered sbox aux (outside blocks ps=rc=0 so 0=0^3
        # holds); the transition (filtered by the constant `pactive`
        # column, which is 0 on block/trace boundaries so row wraparound
        # is excluded) applies the MDS matrix to the per-lane selection
        # pfull ? x7 : u (lane 0 always sboxed on active rows).
        pfull = local[lay.pfull]
        pactive = local[lay.pactive]
        us, sels = [], []
        for e in range(W12):
            u = local[lay.ps + e] + local[lay.prc + e]
            x3 = local[lay.px3 + e]
            x7 = local[lay.px7 + e]
            consumer.constraint(x3 - u * u * u)
            consumer.constraint(x7 - x3 * x3 * u)
            us.append(u)
            if e == 0:
                sels.append(x7)
            else:
                sels.append(pfull * x7 + u - pfull * u)
        for e in range(W12):
            acc_e = None
            for j in range(W12):
                term = sels[j].scalar_mul(mds[e][j])
                acc_e = term if acc_e is None else acc_e + term
            consumer.constraint(pactive * (next_[lay.ps + e] - acc_e))

    return eval_outer_gate


def outer_stark(lay: OuterLayout) -> Stark:
    pairs = [(lay.idx + j, lay.v + j) for j in range(lay.S)]
    filters = None
    if lay.NP:
        # Poseidon state lanes bind wires only on block boundary rows
        pairs = pairs + [(lay.pidx + e, lay.ps + e) for e in range(W12)]
        filters = tuple([None] * lay.S + [lay.pbind] * W12)
    return Stark(
        name=f"outer_s{lay.S}q{lay.Q}r{lay.R}p{lay.NP}",
        width=lay.width,
        eval_fn=_make_eval_fn(lay),
        lookups=[
            KeyedLookup(
                pairs=pairs,
                table_key_col=lay.wit_key,
                table_val_col=lay.wit_val,
                freq_col=lay.wfreq,
                filters=filters,
            ),
            Lookup(
                columns=[lay.r + j for j in range(lay.R)],
                table_col=lay.range_table,
                freq_col=lay.rfreq,
            ),
        ],
        ctls=[
            CtlSpec(
                columns=[("single", lay.wit_key), ("single", lay.wit_val)],
                filter_col=lay.is_pub,
            )
        ],
    )


# ---------------------------------------------------------------------------
# compiler: builder -> gate blocks
# ---------------------------------------------------------------------------


@dataclass
class _Block:
    """All instances of one recipe: vectorized instantiation data."""

    recipe: Recipe
    vars_mat: np.ndarray  # [n_inst, n_vars] wire ids (int64)
    aux_base: int  # aux wire ids: base + inst*n_aux + j




@dataclass
class OuterData:
    """Compiled circuit: prover blocks + verifier key, on one device."""

    lay: OuterLayout
    stark: Stark
    blocks: List[_Block]
    n_gate_rows: int
    n_wires: int  # circuit targets + outer aux wires
    n_log: int
    table_bits: int
    pub_wires: List[int]
    # verifier key: coefficient form of every constant column ([n_const, n])
    vk_coeffs: torch.Tensor = None
    const_cols: torch.Tensor = None  # [n_const, n] value form (prover)
    # Poseidon region: permutation wire matrices ([n_pos, 12] each)
    pos_in: np.ndarray = None
    pos_out: np.ndarray = None

    @property
    def n_pos(self):
        return 0 if self.pos_in is None else self.pos_in.shape[0]

    @property
    def pos_base(self):  # first row of the Poseidon region
        return self.n_gate_rows

    @property
    def device(self) -> torch.device:
        return self.const_cols.device


def compile_outer(circuit: Circuit, table_bits: int = 16, device="cuda") -> OuterData:
    """Compile the recorded constraint system onto the universal gate, with
    the constant columns and the verifier key on `device`.

    `table_bits` sets the range-table base B (production 16 like the
    reference's STARK-side limbs; tests shrink it so n_rows stays small).
    """
    b = circuit.builder

    # --- gather (monomials, vars matrix) instance groups -----------------
    groups: List[Tuple[Tuple, np.ndarray]] = []
    # templated rows, grouped by template id
    by_tid: Dict[int, List[int]] = {}
    for ri, tid in enumerate(b.tpl_tids):
        by_tid.setdefault(tid, []).append(ri)
    for tid, rows in by_tid.items():
        tpl = b.templates[tid]
        mat = np.stack(
            [np.frombuffer(b.tpl_rows[ri], dtype=np.int64) for ri in rows]
        )
        groups.append((tuple(tpl.monomials), mat))
    # ad-hoc constraints, interned by shape
    adhoc: Dict[Tuple, List[List[int]]] = {}
    for c in b.constraints:
        slot_of: Dict[int, int] = {}
        vars_: List[int] = []
        shape = []
        for coeff, idxs in c.monomials:
            slots = []
            for i in idxs:
                s = slot_of.get(i)
                if s is None:
                    s = slot_of[i] = len(vars_)
                    vars_.append(i)
                slots.append(s)
            shape.append((coeff % P, tuple(slots)))
        adhoc.setdefault(tuple(shape), []).append(vars_)
    for shape, rows in adhoc.items():
        n_vars = max((len(r) for r in rows), default=0)
        mat = np.zeros((len(rows), max(n_vars, 1)), dtype=np.int64)
        for i, r in enumerate(rows):
            mat[i, : len(r)] = r
        groups.append((shape, mat))

    # --- rewrite each group; allocate aux wires --------------------------
    blocks: List[_Block] = []
    aux_cursor = b.num_targets
    n_gate_rows = 0
    for shape, mat in groups:
        recipe = _rewrite_template(list(shape))
        blk = _Block(recipe=recipe, vars_mat=mat, aux_base=aux_cursor)
        aux_cursor += recipe.n_aux * mat.shape[0]
        n_gate_rows += len(recipe.rows) * mat.shape[0]
        blocks.append(blk)

    # --- range checks, grouped by bit width ------------------------------
    max_R = 1
    by_bits: Dict[int, List[int]] = {}
    for idx, bits in getattr(b, "range_checks", []):
        by_bits.setdefault(bits, []).append(idx)
    for bits, wires in sorted(by_bits.items()):
        recipe, r_used = _range_recipe(bits, table_bits)
        max_R = max(max_R, r_used)
        mat = np.asarray(wires, dtype=np.int64)[:, None]
        blk = _Block(recipe=recipe, vars_mat=mat, aux_base=aux_cursor)
        aux_cursor += recipe.n_aux * mat.shape[0]
        n_gate_rows += len(recipe.rows) * mat.shape[0]
        blocks.append(blk)

    n_wires = aux_cursor
    pub_wires = list(getattr(b, "public_inputs", []))
    pos_ops = list(getattr(b, "poseidon_ops", []))
    n_pos = len(pos_ops)
    used_rows = n_gate_rows + POS_BLOCK * n_pos
    n_rows_min = max(used_rows, n_wires, 1 << table_bits, 8)
    n_log = (n_rows_min - 1).bit_length()

    lay = OuterLayout(S=S_SLOTS, Q=Q_TERMS, R=max_R, NP=1 if n_pos else 0)
    data = OuterData(
        lay=lay,
        stark=outer_stark(lay),
        blocks=blocks,
        n_gate_rows=n_gate_rows,
        n_wires=n_wires,
        n_log=n_log,
        table_bits=table_bits,
        pub_wires=pub_wires,
        pos_in=np.array([i for i, _ in pos_ops], dtype=np.int64).reshape(n_pos, W12)
        if n_pos
        else None,
        pos_out=np.array([o for _, o in pos_ops], dtype=np.int64).reshape(n_pos, W12)
        if n_pos
        else None,
    )
    _build_const_cols(data, torch.device(device))
    return data


def _ref_wire_ids(blk: _Block, ref: Ref, vars_dev: torch.Tensor, inst: torch.Tensor):
    """Wire ids of one Ref over all instances of a block, on the device."""
    if ref[0] == "s":
        return vars_dev[:, ref[1]]
    return blk.aux_base + inst * blk.recipe.n_aux + ref[1]


def _poseidon_region(t: torch.Tensor, data: OuterData) -> torch.Tensor:
    """View of the Poseidon block rows of a [cols, n] tensor as
    [cols, n_pos, POS_BLOCK] (column, permutation, row in block)."""
    base = data.pos_base
    return t[:, base : base + POS_BLOCK * data.n_pos].view(t.shape[0], data.n_pos, POS_BLOCK)


def _build_const_cols(data: OuterData, dev: torch.device):
    """Materialize the constant columns (value form) and the verifier key
    (their coefficients, through the iNTT kernel K3 on the card) once at
    compile."""
    lay = data.lay
    n = 1 << data.n_log
    n_const = lay.width - lay.idx
    cols = torch.zeros((n_const, n), dtype=torch.int64, device=dev)

    def cc(col):  # row of `cols` for an absolute column id
        return col - lay.idx

    row = 0
    for blk in data.blocks:
        n_inst = blk.vars_mat.shape[0]
        vars_dev = torch.from_numpy(blk.vars_mat).to(dev)
        inst = torch.arange(n_inst, dtype=torch.int64, device=dev)
        for rr in blk.recipe.rows:
            sl_idx, qco, cco, eco = _row_layout(rr, lay)
            rows = slice(row, row + n_inst)
            for j, ref in enumerate(sl_idx):
                if ref is not None:
                    cols[cc(lay.idx + j), rows] = _ref_wire_ids(blk, ref, vars_dev, inst)
            for k, q in enumerate(qco):
                cols[cc(lay.qcol + k), rows] = gl.i64(q)
            for j, c in enumerate(cco):
                cols[cc(lay.ccol + j), rows] = gl.i64(c)
            for j, e in enumerate(eco):
                cols[cc(lay.ecol + j), rows] = gl.i64(e)
            cols[cc(lay.c0col), rows] = gl.i64(rr.const % P)
            row += n_inst
    assert row == data.n_gate_rows
    ramp = torch.arange(n, dtype=torch.int64, device=dev)
    cols[cc(lay.wit_key)] = ramp
    if data.pub_wires:
        cols[cc(lay.is_pub), torch.tensor(data.pub_wires, device=dev)] = 1
    cols[cc(lay.range_table)] = ramp & ((1 << data.table_bits) - 1)
    if data.n_pos:
        from ..field.poseidon_constants import FULL_ROUNDS, N_ROUNDS, ROUND_CONSTANTS

        half = FULL_ROUNDS // 2
        rc = tensor_from_u64(np.asarray(ROUND_CONSTANTS).reshape(N_ROUNDS, W12), dev)
        reg = _poseidon_region(cols, data)
        for r in range(N_ROUNDS):
            reg[cc(lay.prc) : cc(lay.prc) + W12, :, r] = rc[r][:, None]
            reg[cc(lay.pactive), :, r] = 1
            if r < half or r >= N_ROUNDS - half:
                reg[cc(lay.pfull), :, r] = 1
        reg[cc(lay.pbind), :, 0] = 1
        reg[cc(lay.pbind), :, N_ROUNDS] = 1
        pidx = slice(cc(lay.pidx), cc(lay.pidx) + W12)
        reg[pidx, :, 0] = torch.from_numpy(data.pos_in.T.copy()).to(dev)
        reg[pidx, :, N_ROUNDS] = torch.from_numpy(data.pos_out.T.copy()).to(dev)
    data.const_cols = cols
    # vk: coefficient form, evaluated at zeta by the verifier
    from ..field import ntt_cuda

    data.vk_coeffs = ntt_cuda.intt(cols)


def _row_layout(rr: RecipeRow, lay: OuterLayout):
    """Assign a RecipeRow's refs to concrete slots; returns
    (slot_refs[S] (ref or None), q_coeffs[Q], c_coeffs[S], e_coeffs[R])."""
    slot_refs: List[Optional[Ref]] = [None] * lay.S
    qco = [0] * lay.Q
    cco = [0] * lay.S
    eco = [0] * lay.R
    # quads at fixed pairs (2k, 2k+1)
    for k, (coeff, a, bref) in enumerate(rr.quads):
        assert k < lay.Q, "quad overflow (packer bug)"
        slot_refs[2 * k] = a
        slot_refs[2 * k + 1] = bref
        qco[k] = coeff % P
    # linear terms: attach to an existing slot with the same ref, else a free one
    for coeff, ref in rr.lins:
        pos = None
        for j, sr in enumerate(slot_refs):
            if sr == ref:
                pos = j
                break
        if pos is None:
            for j, sr in enumerate(slot_refs):
                if sr is None:
                    pos = j
                    slot_refs[j] = ref
                    break
        assert pos is not None, "slot overflow (packer bug)"
        cco[pos] = (cco[pos] + coeff) % P
    for j, (coeff, _spec) in enumerate(rr.rcols):
        assert j < lay.R, "range-limb overflow"
        eco[j] = coeff % P
    return slot_refs, qco, cco, eco


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def _limb_value(spec, val, B):
    """Honest value of one range-limb cell as u64 bit patterns in int64;
    `val` maps Ref -> tensor."""
    kind, ref, shift = spec
    v = val(ref)
    if kind == "shr":
        # logical shift: int64 >> is arithmetic, so mask off the sign copies
        return (v >> shift) & (((1 << B) - 1) & ((1 << (64 - shift)) - 1))
    # shl / shl_aux: honest inputs are < 2^B; the product wraps mod 2^64 as u64 does
    return v * gl.i64(1 << shift)


def build_outer_trace(data: OuterData, values: Dict[int, int]):
    """Witness dict -> (trace [n, width] on the compile device, public
    values, ctl_values).  The trace is the transpose view of a [width, n]
    column tensor, which is the layout the prover commits."""
    lay = data.lay
    n = 1 << data.n_log
    B = data.table_bits
    dev = data.device

    # the device fills the constant columns while the host packs the witness
    trace = torch.zeros((lay.width, n), dtype=torch.int64, device=dev)
    trace[lay.idx :] = data.const_cols
    # extended witness: circuit targets then aux wires (filled per block)
    W = witness_tensor(values, n, dev)

    row = 0
    for blk in data.blocks:
        n_inst = blk.vars_mat.shape[0]
        rec = blk.recipe
        vars_dev = torch.from_numpy(blk.vars_mat).to(dev)
        n_aux = max(rec.n_aux, 1)
        aux_ids = (
            blk.aux_base
            + torch.arange(n_inst, dtype=torch.int64, device=dev)[:, None] * n_aux
            + torch.arange(n_aux, dtype=torch.int64, device=dev)[None, :]
        )

        def val(ref, vars_dev=vars_dev, aux_ids=aux_ids):
            if ref[0] == "s":
                return W[vars_dev[:, ref[1]]]
            return W[aux_ids[:, ref[1]]]

        for rr in rec.rows:
            # aux definition row: its gate equation has `out` with linear
            # coefficient -1, so out = const + quads + other lins + rcols.
            if rr.out is not None:
                acc = torch.full((n_inst,), gl.i64(rr.const % P), dtype=torch.int64, device=dev)
                for coeff, a, bref in rr.quads:
                    acc = gl.add(acc, gl.mul(gl.mul(val(a), val(bref)), coeff))
                for coeff, ref in rr.lins:
                    if ref == rr.out:
                        continue
                    acc = gl.add(acc, gl.mul(val(ref), coeff))
                for coeff, spec in rr.rcols:
                    acc = gl.add(acc, gl.mul(_limb_value(spec, val, B), coeff % P))
                W[aux_ids[:, rr.out[1]]] = acc
            # fill slot values + range cells
            rows = slice(row, row + n_inst)
            sl_idx, _, _, _ = _row_layout(rr, lay)
            for j, ref in enumerate(sl_idx):
                if ref is not None:
                    trace[lay.v + j, rows] = val(ref)
            for j, (_, spec) in enumerate(rr.rcols):
                trace[lay.r + j, rows] = _limb_value(spec, val, B)
            row += n_inst

    # every slot cell not written above binds to wire 0 (its idx const is
    # 0), so it must carry W[0] for the keyed lookup to hold (cells with
    # idx 0 always hold W[0]; written cells with idx != 0 stay).
    slots = trace[lay.v : lay.v + lay.S]
    slots.copy_(torch.where(data.const_cols[0 : lay.S] == 0, W[0], slots))

    # --- Poseidon region: round-boundary states + sbox aux ---------------
    if data.n_pos:
        from ..field.poseidon import _mds_layer, _tables
        from ..field.poseidon_constants import FULL_ROUNDS, N_ROUNDS

        half = FULL_ROUNDS // 2
        rc, mds = _tables(dev)
        reg = _poseidon_region(trace, data)
        state = W[torch.from_numpy(data.pos_in).to(dev)]  # [n_pos, 12]
        for r in range(N_ROUNDS + 1):
            u = gl.add(state, rc[r][None, :]) if r < N_ROUNDS else state
            x3 = gl.mul(gl.mul(u, u), u)
            x7 = gl.mul(gl.mul(x3, x3), u)
            reg[lay.ps : lay.ps + W12, :, r] = state.T
            reg[lay.px3 : lay.px3 + W12, :, r] = x3.T
            reg[lay.px7 : lay.px7 + W12, :, r] = x7.T
            if r == N_ROUNDS:
                break
            full = r < half or r >= N_ROUNDS - half
            sel = x7 if full else torch.cat([x7[:, :1], u[:, 1:]], dim=1)
            state = _mds_layer(sel, mds)
        # No check against W[pos_out] here: for an adversarial witness the
        # recomputed region disagrees with the witnessed outputs; the binding
        # rows then make the keyed witness lookup unsatisfiable and
        # verification rejects the proof, which is the intended failure path.

    # witness table + frequencies
    trace[lay.wit_val] = W
    wfreq = torch.bincount(data.const_cols[0 : lay.S].reshape(-1), minlength=n)
    if data.n_pos:
        # binding rows contribute their pidx cells to the witness lookup
        bind_idx = torch.from_numpy(np.concatenate([data.pos_in.ravel(), data.pos_out.ravel()]))
        wfreq = wfreq + torch.bincount(bind_idx.to(dev), minlength=n)
    trace[lay.wfreq] = wfreq
    # range-table frequencies; a dishonest cell outside [0, 2^B) counts nowhere
    r_cells = trace[lay.r : lay.r + lay.R].reshape(-1)
    in_table = (r_cells >= 0) & (r_cells < (1 << B))
    trace[lay.rfreq, : 1 << B] = torch.bincount(r_cells[in_table], minlength=1 << B)

    pub = u64_from_tensor(W[torch.tensor(data.pub_wires, dtype=torch.int64, device=dev)])
    public_values = [int(v) for v in pub]
    ctl_values = {0: [[int(i), int(v)] for i, v in zip(data.pub_wires, pub)]}
    return trace.T, public_values, ctl_values


def prove_outer(data: OuterData, values: Dict[int, int], config=None, timing=None):
    """Prove the compiled circuit for one witness on the compile device.
    Returns (proof, public_values)."""
    from ..prover import prove as prove_mod
    from ..prover.config import DEFAULT_CONFIG
    from ..utils import timing as timing_mod

    config = config or DEFAULT_CONFIG
    tt = timing_mod.get(timing)
    with tt.scope("prove_outer"):
        with tt.scope("outer trace"):
            trace, public_values, ctl_values = build_outer_trace(data, values)
        proof = prove_mod.prove(data.stark, trace, ctl_values, config, timing=tt)
    return proof, public_values


def verify_outer(data: OuterData, proof, public_values: List[int], config=None):
    """Native verification: STARK verify + constant-column pinning.

    The constant columns (gate coefficients, wire indices, witness keys,
    public filter, range table) are evaluated at zeta and zeta*g from the
    verifier key's coefficient form and compared against the proof's trace
    openings: a committed trace that disagrees with the circuit's
    constants anywhere agrees at the post-commitment challenge zeta with
    probability <= 2n/|F^2| (Schwartz–Zippel), the same binding plonky2
    gets from its constants_sigmas_cap."""
    from ..prover import prove as prove_mod
    from ..prover import verify as verify_mod
    from ..prover.config import DEFAULT_CONFIG

    config = config or DEFAULT_CONFIG
    lay = data.lay
    if proof.degree_bits != data.n_log:
        raise verify_mod.VerificationError("degree_bits != circuit size")
    if len(public_values) != len(data.pub_wires):
        raise verify_mod.VerificationError("public value count")
    ctl_values = {
        0: [[int(i), int(v) % P] for i, v in zip(data.pub_wires, public_values)]
    }
    zeta = verify_mod.verify(data.stark, proof, ctl_values, config)

    g = gl.primitive_root_of_unity(data.n_log)
    mine = u64_from_tensor(prove_mod._openings(data.vk_coeffs, (zeta, zeta.scalar_mul(g))))
    for (c0s, c1s), opened in zip(mine, (proof.openings.trace_zeta,
                                         proof.openings.trace_zeta_g)):
        for j, col in enumerate(range(lay.idx, lay.width)):
            o = opened[col]
            if int(c0s[j]) != o.c0 or int(c1s[j]) != o.c1:
                raise verify_mod.VerificationError(
                    f"constant column {col} opening mismatch at zeta"
                )
