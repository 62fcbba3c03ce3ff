"""Constraint tapes: a machine's whole constraint system recorded once as a
straight-line Goldilocks program, which the quotient kernel K5 runs at
every point of the LDE coset.

The constraint code is generic over rings (`starks/air.py`): every GL fast
path is guarded by `isinstance(..., GL)` or by the consumer's
`alpha_pows`, and falls back to the generic path the verifier's ring
takes.  `TapeRing` is one more ring, whose values are nodes of a graph:
running `constraints.eval_all_constraints` through it once, with a
consumer that has no `alpha_pows`, records every add, sub and mul of the
AIR, the LogUp helpers and Z recurrences, the CTL Z's with their
selectors and the alpha combination; `lower` adds the division by Z_H and
turns the graph into a tape.

Recording folds constants (`x + 0`, `x * 1`, `x * 0`, constant op
constant) and merges equal operations, both exact in F_p, so the tape's
outputs are the eager evaluation's bits.  Lowering splits the graph:

  * the uniform program: operations on constants and the scalar inputs
    (alphas, betas, gammas, CTL totals) alone, the same at every point;
    the kernel runs it once a block into shared memory;
  * the point program: every other operation, in recording order, each
    writing a slot; an operand is a slot, a uniform, or an LDE value read
    straight from its column (local or next row, trace or aux), or a
    selector (z_last, l_first, l_last, 1/Z_H).  Slots are allocated by
    liveness, the lowest free slot first, so a point holds only what is
    still to be read.

An instruction is four int32 words (op, dst, a, b); an operand is
`(source << SRC_SHIFT) | index`.  `run` executes a tape in plain torch,
instruction by instruction on the kernel's slots: it is the kernel's
emulation, as `ntt_cuda.emulate` is for K3/K4.
"""

from __future__ import annotations

import heapq
import weakref
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..field import goldilocks as gl
from ..interop import tensor_from_u64
from ..starks.air import ConstraintConsumer
from ..starks.table import Stark
from . import constraints as cons

# operand sources: the top byte of an encoded operand
SLOT, UNI, TLOC, TNXT, ALOC, ANXT, SEL = range(7)
SRC_SHIFT = 24
INDEX_MASK = (1 << SRC_SHIFT) - 1
# rows of the selector input [4, N]
Z_LAST, L_FIRST, L_LAST, INV_ZH = range(4)
# opcodes; OUT stores operand a into output row dst
ADD, SUB, MUL, OUT = range(4)

_CONST, _INPUT, _LEAF = -1, -2, -3  # node kinds beside the opcodes


class _Graph:
    """Nodes (kind, a, b) in recording order, with constant folding and
    one node for equal operations."""

    def __init__(self):
        self.nodes: list = []
        self.memo: dict = {}
        self.value: dict = {}  # const node -> its residue

    def _node(self, key) -> int:
        got = self.memo.get(key)
        if got is None:
            got = self.memo[key] = len(self.nodes)
            self.nodes.append(key)
        return got

    def const(self, v: int) -> int:
        v %= gl.P
        i = self._node((_CONST, v, 0))
        self.value[i] = v
        return i

    def op(self, kind: int, a: int, b: int) -> int:
        va, vb = self.value.get(a), self.value.get(b)
        if va is not None and vb is not None:
            return self.const(va + vb if kind == ADD else va - vb if kind == SUB else va * vb)
        if kind == ADD:
            if va == 0:
                return b
            if vb == 0:
                return a
        elif kind == SUB:
            if vb == 0:
                return a
        elif kind == MUL:
            if va == 0 or vb == 0:
                return self.const(0)
            if va == 1:
                return b
            if vb == 1:
                return a
        if kind != SUB and a > b:
            a, b = b, a
        return self._node((kind, a, b))


class TapeValue:
    """A ring value of `TapeRing`: one node of the graph."""

    __slots__ = ("g", "i")

    def __init__(self, g: _Graph, i: int):
        self.g = g
        self.i = i

    def __add__(self, o):
        return TapeValue(self.g, self.g.op(ADD, self.i, o.i))

    def __sub__(self, o):
        return TapeValue(self.g, self.g.op(SUB, self.i, o.i))

    def __mul__(self, o):
        return TapeValue(self.g, self.g.op(MUL, self.i, o.i))

    def neg(self):
        return TapeValue(self.g, self.g.op(SUB, self.g.const(0), self.i))

    __neg__ = neg

    def scalar_mul(self, c: int):
        return TapeValue(self.g, self.g.op(MUL, self.i, self.g.const(c)))


class ScalarInput:
    """Placeholder for entry `k` of the scalar inputs in a recording."""

    __slots__ = ("k",)

    def __init__(self, k: int):
        self.k = k


class TapeRing:
    """Ring factory for `TapeValue`s: `const` takes a python int or a
    `ScalarInput`."""

    def __init__(self, g: _Graph):
        self.g = g

    def const(self, x) -> TapeValue:
        if isinstance(x, ScalarInput):
            return TapeValue(self.g, self.g._node((_INPUT, x.k, 0)))
        return TapeValue(self.g, self.g.const(int(x)))

    def zero(self) -> TapeValue:
        return self.const(0)

    def one(self) -> TapeValue:
        return self.const(1)

    def wrap(self, v):
        return v

    def leaf(self, src: int, j: int) -> TapeValue:
        return TapeValue(self.g, self.g._node((_LEAF, src, j)))


@dataclass(frozen=True, eq=False)
class Tape:
    """A lowered constraint system.  `uprog` [n, 4] and `prog` [m, 4]
    int32; `consts` the uniform table's first entries (u64), followed by
    the `n_inputs` scalar inputs and then one entry per uniform-program
    instruction; `n_slots` slots a point; `n_out` output rows;
    `on_device` the arrays copied to each device (`quotient_cuda`)."""

    uprog: np.ndarray
    prog: np.ndarray
    consts: np.ndarray
    n_inputs: int
    n_slots: int
    n_out: int
    width: int
    aux_width: int
    on_device: dict = field(default_factory=dict, repr=False)

    @property
    def n_ops(self) -> int:
        """Goldilocks operations a point runs (OUT stores excluded)."""
        return int((self.prog[:, 0] != OUT).sum())


def input_layout(stark: Stark, nc: int):
    """The scalar inputs' order: (alphas [nc], (beta, gamma) per challenge
    set, CTL totals [nc][n_ctls]) as `ScalarInput`s."""
    n_ctl = len(stark.ctls)
    alphas = [ScalarInput(i) for i in range(nc)]
    challenges = [(ScalarInput(nc + 2 * i), ScalarInput(nc + 2 * i + 1)) for i in range(nc)]
    totals = [[ScalarInput(3 * nc + i * n_ctl + c) for c in range(n_ctl)] for i in range(nc)]
    return alphas, challenges, totals


def record(stark: Stark, nc: int):
    """(graph, output node per challenge set): the alpha-combined
    constraints, each divided by Z_H (times 1/Z_H)."""
    g = _Graph()
    ring = TapeRing(g)
    aw = cons.aux_width(stark, nc)
    local = [ring.leaf(TLOC, j) for j in range(stark.width)]
    next_ = [ring.leaf(TNXT, j) for j in range(stark.width)]
    aux_local = [ring.leaf(ALOC, j) for j in range(aw)]
    aux_next = [ring.leaf(ANXT, j) for j in range(aw)]
    alphas, challenges, totals = input_layout(stark, nc)
    consumer = ConstraintConsumer(ring, [ring.const(a) for a in alphas],
                                  ring.leaf(SEL, Z_LAST), ring.leaf(SEL, L_FIRST),
                                  ring.leaf(SEL, L_LAST))
    cons.eval_all_constraints(consumer, ring, stark, local, next_, aux_local, aux_next,
                              challenges, totals)
    inv_zh = ring.leaf(SEL, INV_ZH)
    return g, [(acc * inv_zh).i for acc in consumer.accs]


def lower(g: _Graph, outs: List[int], stark: Stark, nc: int) -> Tape:
    """The tape of a recording: the nodes the outputs read, split into the
    uniform program and the point program, the point program's values in
    slots by liveness (a slot is free again once its value's last reader
    has read it, so a reader's result may take its operand's slot)."""
    nodes = g.nodes
    live = [False] * len(nodes)
    stack = list(outs)
    while stack:
        i = stack.pop()
        if live[i]:
            continue
        live[i] = True
        kind, a, b = nodes[i]
        if kind >= 0:
            stack += [a, b]
    uniform = [False] * len(nodes)
    for i, (kind, a, b) in enumerate(nodes):
        uniform[i] = kind in (_CONST, _INPUT) or (kind >= 0 and uniform[a] and uniform[b])

    n_inputs = 3 * nc + nc * len(stark.ctls)
    consts = [i for i in range(len(nodes)) if live[i] and nodes[i][0] == _CONST]
    uni_ops = [i for i in range(len(nodes)) if live[i] and uniform[i] and nodes[i][0] >= 0]
    uidx = {i: k for k, i in enumerate(consts)}
    for i in range(len(nodes)):
        if live[i] and nodes[i][0] == _INPUT:
            uidx[i] = len(consts) + nodes[i][1]
    for k, i in enumerate(uni_ops):
        uidx[i] = len(consts) + n_inputs + k
    uprog = [(nodes[i][0], uidx[i], uidx[nodes[i][1]], uidx[nodes[i][2]]) for i in uni_ops]

    pt_ops = [i for i in range(len(nodes)) if live[i] and not uniform[i] and nodes[i][0] >= 0]
    pos = {i: t for t, i in enumerate(pt_ops)}
    last = {}
    for t, i in enumerate(pt_ops):
        for o in nodes[i][1:]:
            if o in pos:
                last[o] = t
    for o in outs:
        if o in pos:
            last[o] = len(pt_ops)
    free: list = []
    n_slots = 0
    slot = {}

    def operand(o: int) -> int:
        if o in pos:
            return (SLOT << SRC_SHIFT) | slot[o]
        if uniform[o]:
            return (UNI << SRC_SHIFT) | uidx[o]
        _, src, j = nodes[o]
        return (src << SRC_SHIFT) | j

    prog = []
    for t, i in enumerate(pt_ops):
        kind, a, b = nodes[i]
        ea, eb = operand(a), operand(b)
        for o in {a, b}:
            if last.get(o) == t:
                heapq.heappush(free, slot[o])
        if free:
            s = heapq.heappop(free)
        else:
            s, n_slots = n_slots, n_slots + 1
        slot[i] = s
        prog.append((kind, s, ea, eb))
    for k, o in enumerate(outs):
        prog.append((OUT, k, operand(o), 0))
    return Tape(
        uprog=np.array(uprog, dtype=np.int32).reshape(-1, 4),
        prog=np.array(prog, dtype=np.int32).reshape(-1, 4),
        consts=np.array([g.value[i] for i in consts], dtype=np.uint64),
        n_inputs=n_inputs, n_slots=max(n_slots, 1), n_out=len(outs),
        width=stark.width, aux_width=cons.aux_width(stark, nc),
    )


# One tape a `Stark` object and challenge count, recorded at first use: a
# machine's tape follows its own eval function, lookups and CTLs, so the
# cache is keyed by the object's identity, never by its name, and an entry
# goes with its object.
_TAPES: dict = {}


def tape_of(stark: Stark, nc: int) -> Tape:
    key = (id(stark), nc)
    got = _TAPES.get(key)
    if got is None or got[0]() is not stark:
        got = _TAPES[key] = (weakref.ref(stark), lower(*record(stark, nc), stark, nc))
        weakref.finalize(stark, _TAPES.pop, key, None)
    return got[1]


def scalar_inputs(stark: Stark, alphas, challenges, ctl_totals, device) -> torch.Tensor:
    """The scalar inputs as one int64 tensor on `device`, in `input_layout`
    order: 0-d device tensors (the device transcript) are stacked there;
    python ints (the host transcript) are copied in without blocking."""
    vals = list(alphas) + [x for pair in challenges for x in pair]
    vals += [ctl_totals[i][c] for i in range(len(challenges)) for c in range(len(stark.ctls))]
    if vals and isinstance(vals[0], torch.Tensor):
        return torch.stack([v.to(device).reshape(()) for v in vals])
    return tensor_from_u64(np.array([int(v) % gl.P for v in vals], dtype=np.uint64), device)


# ---------------------------------------------------------------------------
# The kernel's algorithm in plain torch
# ---------------------------------------------------------------------------

_OPS = {ADD: gl.add, SUB: gl.sub, MUL: gl.mul}


def run(tape: Tape, t_loc, t_nxt, a_loc, a_nxt, sel, inputs) -> torch.Tensor:
    """[n_out, C]: the tape at C points, instruction by instruction on
    `n_slots` slots, as the kernel runs it.  `t_loc`/`t_nxt` [w, C],
    `a_loc`/`a_nxt` [aux, C] (the next rows already aligned), `sel` [4, C],
    `inputs` [n_inputs] int64."""
    dev = t_loc.device
    uni = [t.reshape(1) for t in
           torch.cat([tensor_from_u64(tape.consts, dev), inputs.to(dev)]).unbind()]
    for op, _, a, b in tape.uprog.tolist():
        uni.append(_OPS[op](uni[a], uni[b]))
    srcs = {TLOC: t_loc, TNXT: t_nxt, ALOC: a_loc, ANXT: a_nxt, SEL: sel}
    slots = [None] * tape.n_slots
    out = torch.empty((tape.n_out, t_loc.shape[1]), dtype=torch.int64, device=dev)

    def fetch(e):
        src, j = e >> SRC_SHIFT, e & INDEX_MASK
        if src == SLOT:
            return slots[j]
        if src == UNI:
            return uni[j]
        return srcs[src][j]

    for op, dst, a, b in tape.prog.tolist():
        if op == OUT:
            out[dst] = fetch(a)
        else:
            slots[dst] = _OPS[op](fetch(a), fetch(b))
    return out
