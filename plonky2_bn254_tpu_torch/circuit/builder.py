"""Circuit builder: targets, constraints, generators, hooks.

Port of `plonky2_bn254_tpu/circuit/builder.py`, itself a rebuild of the
circuit machinery the reference gets from plonky2 (`CircuitBuilder`,
virtual targets, the `SimpleGenerator` fixpoint, `BuilderHook` deferred
constraints; the reference crate's src/hook.rs, builder.rs).  Recording and
the witness fixpoint are host Python on ints, copied from the original.
`check` evaluates every recorded constraint as int64 Goldilocks tensors
(`field/goldilocks.py`) on an explicit device, and `prove_all` runs the
hooks' inner provers and the outer prover there: the card unless the
caller passes `device="cpu"`.
"""

from __future__ import annotations

from array import array as _array
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..field import goldilocks as gl
from ..interop import tensor_from_u64


@dataclass(frozen=True)
class Template:
    """Interned constraint shape: sum of monomials over var slots == 0."""

    monomials: Tuple[Tuple[int, Tuple[int, ...]], ...]
    out_slot: Optional[int] = None

    def eval_row(self, values, vars_) -> int:
        acc = 0
        for coeff, slots in self.monomials:
            term = coeff
            for s in slots:
                term = term * values[vars_[s]] % gl.P
            acc += term
        return acc % gl.P

    def solve_out(self, values, vars_) -> int:
        """Value of vars[out_slot] from the other monomials."""
        acc = 0
        for coeff, slots in self.monomials:
            if len(slots) == 1 and slots[0] == self.out_slot:
                continue
            term = coeff
            for s in slots:
                term = term * values[vars_[s]] % gl.P
            acc += term
        return acc % gl.P


class Target:
    """A wire: index into the witness vector."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __repr__(self):
        return f"t{self.index}"

    def __eq__(self, o):
        return isinstance(o, Target) and o.index == self.index

    def __hash__(self):
        return hash(("t", self.index))


@dataclass
class Constraint:
    """sum of monomials == 0; monomial = (coeff, [target indices])."""

    monomials: List[Tuple[int, List[int]]]
    tag: str = ""

    def eval(self, witness) -> int:
        acc = 0
        for coeff, idxs in self.monomials:
            term = coeff
            for i in idxs:
                term = term * witness[i] % gl.P
            acc += term
        return acc % gl.P


@dataclass
class Generator:
    """Witness generator: when all `deps` are known, compute `outputs`."""

    deps: List[int]
    outputs: List[int]
    run: Callable  # (witness dict) -> {index: value}
    name: str = ""


class Witness:
    """Partial witness assignment."""

    def __init__(self):
        self.values: Dict[int, int] = {}

    def set_target(self, t: Target, value: int):
        value %= gl.P
        old = self.values.get(t.index)
        if old is not None and old != value:
            raise ValueError(f"conflicting witness for {t}: {old} vs {value}")
        self.values[t.index] = value

    def try_get(self, t: Target) -> Optional[int]:
        return self.values.get(t.index)

    def get(self, t: Target) -> int:
        return self.values[t.index]


def witness_tensor(values: Dict[int, int], n: int, device) -> torch.Tensor:
    """Witness dict -> [n] int64 tensor of canonical residues (0 elsewhere)."""
    w = np.zeros(n, dtype=np.uint64)
    if values:
        keys = np.fromiter(values.keys(), dtype=np.int64, count=len(values))
        w[keys] = np.fromiter((v % gl.P for v in values.values()), dtype=np.uint64,
                              count=len(values))
    return tensor_from_u64(w, device)


class CircuitBuilder:
    """Records constraints in two interchangeable forms:

    - `constraints`: ad-hoc `Constraint` objects (low-volume: connects,
      assertions, one-off gadget identities).
    - templated rows: an interned `Template` (monomials over var SLOTS,
      optionally solvable for one out slot) plus, per emission, one compact
      `array('q')` of target indices.  Recursion-scale circuits emit
      millions of structurally identical constraints (Poseidon rounds, ring
      arithmetic); interning makes each one ~2 small allocations instead of
      ~15 — decisive on this VM, where first-touch heap pages fault in at
      ~10 MB/s — and gives the outer prover a vectorizable gate DB.
    """

    def __init__(self):
        self.num_targets = 0
        self.constraints: List[Constraint] = []
        self.generators: List[Generator] = []
        self.constants: Dict[int, Target] = {}
        self.hooks: Dict[str, object] = {}
        self._built = False
        # templated constraints
        self.templates: List["Template"] = []
        self._template_ids: Dict[tuple, int] = {}
        self.tpl_tids: List[int] = []  # one per templated row
        self.tpl_rows: List[_array] = []  # one index array per row
        # wires exposed as public inputs of the outer proof
        self.public_inputs: List[int] = []
        # first-class Poseidon permutation ops: (in_indices[12], out_indices[12]).
        # Constrained by the outer proof's dedicated Poseidon-round region
        # (circuit/outer.py) — the plonky2 PoseidonGate analog — instead of
        # ~500 universal-gate rows each; checked natively by Circuit.check.
        self.poseidon_ops: List[Tuple[List[int], List[int]]] = []

    # -- targets ---------------------------------------------------------

    def add_virtual_target(self) -> Target:
        t = Target(self.num_targets)
        self.num_targets += 1
        return t

    def add_virtual_targets(self, n: int) -> List[Target]:
        return [self.add_virtual_target() for _ in range(n)]

    def reserve_indices(self, n: int) -> int:
        """Allocate n target indices without Target objects; returns the
        first index (bulk-emission fast path)."""
        base = self.num_targets
        self.num_targets += n
        return base

    # -- templated constraints (interned shapes) --------------------------

    def add_template(self, monomials, out_slot: Optional[int] = None) -> int:
        """Intern a constraint shape: `monomials` is [(coeff, (slots...))]
        summing to zero over vars; if `out_slot` is given, the constraint
        must have the form  sum(other monomials) - vars[out_slot] == 0  so
        witness generation can solve for it."""
        key = (
            tuple((c % gl.P, tuple(s)) for c, s in monomials),
            out_slot,
        )
        tid = self._template_ids.get(key)
        if tid is None:
            tid = len(self.templates)
            self.templates.append(Template(key[0], out_slot))
            self._template_ids[key] = tid
        return tid

    def emit(self, tid: int, var_indices) -> None:
        """Record one templated constraint row (indices, not Targets)."""
        self.tpl_tids.append(tid)
        self.tpl_rows.append(_array("q", var_indices))

    def constant(self, value: int) -> Target:
        value %= gl.P
        if value not in self.constants:
            t = self.add_virtual_target()
            self.constraints.append(
                Constraint([(1, [t.index]), (-value % gl.P, [])], tag="const")
            )
            self.generators.append(
                Generator([], [t.index], lambda w, t=t, v=value: {t.index: v})
            )
            self.constants[value] = t
        return self.constants[value]

    def zero(self) -> Target:
        return self.constant(0)

    def one(self) -> Target:
        return self.constant(1)

    # -- arithmetic ------------------------------------------------------

    def add(self, a: Target, b: Target) -> Target:
        return self._arith([(1, [a.index]), (1, [b.index])], "add", [a, b])

    def sub(self, a: Target, b: Target) -> Target:
        return self._arith([(1, [a.index]), (gl.P - 1, [b.index])], "sub", [a, b])

    def mul(self, a: Target, b: Target) -> Target:
        return self._arith([(1, [a.index, b.index])], "mul", [a, b])

    def mul_const(self, c: int, a: Target) -> Target:
        return self._arith([(c % gl.P, [a.index])], "mul_const", [a])

    def mul_add(self, a: Target, b: Target, c: Target) -> Target:
        """a*b + c"""
        return self._arith(
            [(1, [a.index, b.index]), (1, [c.index])], "mul_add", [a, b, c]
        )

    def add_linear(self, terms, const: int = 0) -> Target:
        """out = const + sum coeff*t over `terms` = [(coeff, Target)] with
        ONE constraint and ONE generator (the workhorse of wide gadgets
        like the Poseidon MDS layer)."""
        monomials = [(c % gl.P, [t.index]) for c, t in terms]
        if const % gl.P:
            monomials.append((const % gl.P, []))
        return self._arith(monomials, "linear", [t for _, t in terms])

    def _arith(self, monomials, tag, deps: List[Target]) -> Target:
        """out = sum of monomials, as ONE templated row: the interned
        template doubles as the constraint and the witness rule."""
        out_index = self.reserve_indices(1)
        slot_of: Dict[int, int] = {}
        vars_: List[int] = []
        tpl_monomials = []
        for coeff, idxs in monomials:
            slots = []
            for i in idxs:
                s = slot_of.get(i)
                if s is None:
                    s = slot_of[i] = len(vars_)
                    vars_.append(i)
                slots.append(s)
            tpl_monomials.append((coeff, tuple(slots)))
        out_slot = len(vars_)
        vars_.append(out_index)
        tpl_monomials.append((gl.P - 1, (out_slot,)))
        tid = self.add_template(tpl_monomials, out_slot)
        self.emit(tid, vars_)
        return Target(out_index)

    # -- constraints -----------------------------------------------------

    def assert_zero(self, t: Target):
        self.constraints.append(Constraint([(1, [t.index])], tag="assert_zero"))

    def connect(self, a: Target, b: Target):
        self.constraints.append(
            Constraint([(1, [a.index]), (gl.P - 1, [b.index])], tag="connect")
        )
        # propagate witness values in either direction
        self.generators.append(
            Generator([a.index], [b.index], lambda w, a=a, b=b: {b.index: w[a.index]})
        )

    def assert_bool(self, t: Target):
        self.constraints.append(
            Constraint([(1, [t.index, t.index]), (gl.P - 1, [t.index])], tag="bool")
        )

    def select(self, flag: Target, a: Target, b: Target) -> Target:
        """flag ? a : b  (flag boolean): out = flag*(a-b) + b."""
        return self._arith(
            [
                (1, [flag.index, a.index]),
                (gl.P - 1, [flag.index, b.index]),
                (1, [b.index]),
            ],
            "select",
            [flag, a, b],
        )

    def add_generator(self, gen: Generator):
        self.generators.append(gen)

    def register_public_input(self, t: Target):
        """Expose a wire as a public input of the outer proof (bound to
        verifier-supplied values via the outer CTL — reference:
        plonky2 register_public_input as used by builder.rs tests)."""
        if t.index not in self.public_inputs:
            self.public_inputs.append(t.index)

    # -- hooks (deferred constraint emission; reference hook.rs) ---------

    def get_hook(self, key: str, factory):
        if key not in self.hooks:
            self.hooks[key] = factory()
        return self.hooks[key]

    # -- build -----------------------------------------------------------

    def build(self) -> "Circuit":
        assert not self._built
        self._built = True
        for hook in self.hooks.values():
            hook.constrain(self)
        return Circuit(self)


class Circuit:
    def __init__(self, builder: CircuitBuilder):
        self.builder = builder

    def generate_witness(self, pw: Witness, device="cuda") -> Dict[int, int]:
        """Run the generator fixpoint (reference: plonky2
        generate_partial_witness), in linear time: a target-index ->
        waiting-generators map drives a ready queue, so each generator is
        examined only when one of its deps lands (a rescan loop would be
        quadratic on recursion-scale circuits).  Hooks that prove at
        witness time (the BN254 batch STARKs) do so on `device`."""
        b = self.builder
        for hook in b.hooks.values():
            hook.device = torch.device(device)
        values = dict(pw.values)
        gens = b.generators
        n_obj = len(gens)
        # templated rows whose template can be solved for an out slot act
        # as generators too (index space n_obj..)
        tpl_gen_rows = [
            ri
            for ri in range(len(b.tpl_tids))
            if b.templates[b.tpl_tids[ri]].out_slot is not None
        ]
        n_total = n_obj + len(tpl_gen_rows)

        def deps_of(gi):
            if gi < n_obj:
                return set(gens[gi].deps)
            ri = tpl_gen_rows[gi - n_obj]
            vars_ = b.tpl_rows[ri]
            out = vars_[b.templates[b.tpl_tids[ri]].out_slot]
            return {v for v in vars_ if v != out}

        waiting_on: Dict[int, List[int]] = {}
        remaining = [0] * n_total
        ready = []
        for gi in range(n_total):
            missing = [d for d in deps_of(gi) if d not in values]
            remaining[gi] = len(missing)
            if not missing:
                ready.append(gi)
            for d in missing:
                waiting_on.setdefault(d, []).append(gi)
        n_run = 0

        def land(k: int):
            for gi in waiting_on.pop(k, ()):
                remaining[gi] -= 1
                if remaining[gi] == 0:
                    ready.append(gi)

        for k in list(values):
            land(k)
        while ready:
            gi = ready.pop()
            n_run += 1
            if gi < n_obj:
                gen = gens[gi]
                out = gen.run(values)
                name = gen.name
            else:
                ri = tpl_gen_rows[gi - n_obj]
                tpl = b.templates[b.tpl_tids[ri]]
                vars_ = b.tpl_rows[ri]
                out = {vars_[tpl.out_slot]: tpl.solve_out(values, vars_)}
                name = "tpl"
            for k, v in out.items():
                v %= gl.P
                if k in values:
                    if values[k] != v:
                        raise ValueError(
                            f"generator {name} conflicts at t{k}: "
                            f"{values[k]} vs {v}"
                        )
                    continue
                values[k] = v
                land(k)
        if n_run != n_total:
            stuck = [
                gens[gi].name if gi < n_obj else "tpl"
                for gi in range(n_total)
                if remaining[gi] > 0
            ][:5]
            raise ValueError(f"witness generation stuck; pending: {stuck}")
        return values

    def _compiled_check(self):
        """Group constraints by (n_monomials, max_degree) into padded index /
        coefficient arrays, so `check` is a handful of vectorized modmul
        passes instead of a per-gate python loop."""
        groups: Dict = {}
        for i, c in enumerate(self.builder.constraints):
            m = len(c.monomials)
            d = max((len(idxs) for _, idxs in c.monomials), default=0)
            groups.setdefault((m, max(d, 1)), []).append(i)
        compiled = []
        one_slot = self.builder.num_targets  # sentinel index holding 1
        for (m, d), idx_list in groups.items():
            coeffs = np.zeros((len(idx_list), m), dtype=np.uint64)
            var_idx = np.full((len(idx_list), m, d), one_slot, dtype=np.int64)
            for r, ci in enumerate(idx_list):
                for j, (coeff, idxs) in enumerate(
                    self.builder.constraints[ci].monomials
                ):
                    coeffs[r, j] = coeff % gl.P
                    for k, t in enumerate(idxs):
                        var_idx[r, j, k] = t
            compiled.append((np.asarray(idx_list), coeffs, var_idx))
        return compiled

    def _template_plan(self):
        """Templated rows grouped by template: (tid, row ids, [rows, k] vars)."""
        by_tid: Dict[int, List[int]] = {}
        for ri, tid in enumerate(self.builder.tpl_tids):
            by_tid.setdefault(tid, []).append(ri)
        return [
            (
                tid,
                np.asarray(rows),
                np.stack(
                    [
                        np.frombuffer(self.builder.tpl_rows[ri], dtype=np.int64)
                        for ri in rows
                    ]
                ),
            )
            for tid, rows in by_tid.items()
        ]

    def check(self, values: Dict[int, int], device="cuda"):
        """Check every constraint on `device` (the 'fake backend'
        verification path; the reference's not-constrain-bn254-stark
        feature skips exactly this for the STARK hook).  Raises ValueError
        naming the first violated constraint, as the original does."""
        from ..field import poseidon_cuda

        dev = torch.device(device)
        b = self.builder
        if not hasattr(self, "_check_plan"):
            self._check_plan = self._compiled_check()
            self._tpl_plan = self._template_plan()
        w = witness_tensor(values, b.num_targets + 1, dev)
        w[b.num_targets] = 1  # sentinel: empty monomial slots

        def first_nonzero(acc):
            bad = torch.nonzero(acc)
            return int(bad[0, 0]) if bad.numel() else None

        for idx_list, coeffs, var_idx in self._check_plan:
            term = tensor_from_u64(coeffs, dev)
            vi = torch.from_numpy(var_idx).to(dev)
            for k in range(var_idx.shape[2]):
                term = gl.mul(term, w[vi[:, :, k]])
            acc = term[:, 0]
            for j in range(1, term.shape[1]):
                acc = gl.add(acc, term[:, j])
            bad = first_nonzero(acc)
            if bad is not None:
                ci = int(idx_list[bad])
                c = b.constraints[ci]
                raise ValueError(f"constraint {ci} ({c.tag}) violated")
        # templated rows: vectorized per template
        for tid, row_ids, mat in self._tpl_plan:
            tpl = b.templates[tid]
            w_vars = w[torch.from_numpy(mat).to(dev)]  # [n, k]
            acc = None
            for coeff, slots in tpl.monomials:
                term = torch.full((mat.shape[0],), gl.i64(coeff % gl.P), dtype=torch.int64,
                                  device=dev)
                for s in slots:
                    term = gl.mul(term, w_vars[:, s])
                acc = term if acc is None else gl.add(acc, term)
            bad = first_nonzero(acc)
            if bad is not None:
                ri = int(row_ids[bad])
                raise ValueError(
                    f"templated constraint row {ri} (template {tid}) violated"
                )
        checks = getattr(b, "range_checks", [])
        if checks:
            idx = torch.tensor([i for i, _ in checks], dtype=torch.int64, device=dev)
            bits = torch.tensor([k for _, k in checks], dtype=torch.int64, device=dev)
            # an arithmetic shift of the u64 pattern is nonzero iff v >= 2^bits
            bad = first_nonzero((w[idx] >> bits) != 0)
            if bad is not None:
                i, k = checks[bad]
                raise ValueError(f"range check violated: t{i} = {values[i]} >= 2^{k}")
        # Poseidon permutation ops (outer proof: dedicated round region)
        if b.poseidon_ops:
            ins = torch.tensor([i for i, _ in b.poseidon_ops], dtype=torch.int64, device=dev)
            outs = torch.tensor([o for _, o in b.poseidon_ops], dtype=torch.int64, device=dev)
            got = poseidon_cuda.permute_states(w[ins].contiguous())
            bad = first_nonzero((got != w[outs]).any(dim=1))
            if bad is not None:
                raise ValueError(f"poseidon op {bad} violated")

    def prove(self, pw: Witness, device="cuda"):
        """Witness generation + constraint check + deferred proof payloads.

        Returns (values, proofs) where `proofs` holds the batch STARK
        proofs produced by hooks during witness generation (stored on the
        hook objects).
        """
        values = self.generate_witness(pw, device)
        self.check(values, device)
        proofs = {}
        for key, hook in self.builder.hooks.items():
            if getattr(hook, "proof", None) is not None:
                proofs[key] = hook.proof
        return values, proofs

    # -- composed product: ONE verifiable artifact ------------------------

    def outer_data(self, table_bits: int = 16, device="cuda"):
        """Compile (once per table size and device) the whole recorded
        constraint system, including any in-circuit recursive STARK
        verifiers the hooks emitted, onto the universal-gate outer STARK.
        The result doubles as the verifier key (`OuterData.vk_coeffs` pins
        every constant column)."""
        cache = getattr(self, "_outer_cache", None)
        if cache is None:
            cache = self._outer_cache = {}
        key = (table_bits, torch.device(device))
        if key not in cache:
            from . import outer

            cache[key] = outer.compile_outer(self, table_bits, device)
        return cache[key]

    def prove_all(self, pw: Witness, config=None, table_bits: int = 16, device="cuda"):
        """The reference's `data.prove(pw)` (plonky2 prove as driven by the
        reference crate's src/builder.rs:178-260): generate the witness (the
        hooks prove and inject the batch STARK proofs, whose recursive
        verifiers live in this constraint system), then produce ONE outer
        STARK proof over the whole circuit, all on `device`.  Returns
        (proof, publics): a single artifact a third party verifies with
        `verify_all` (or `outer.verify_outer` given only the verifier key),
        no witness regeneration involved."""
        from . import outer

        values = self.generate_witness(pw, device)
        data = self.outer_data(table_bits, device)
        return outer.prove_outer(data, values, config)

    def verify_all(self, proof, publics, config=None, table_bits: int = 16, device="cuda"):
        """Verify the composed artifact against this circuit's verifier
        key (reference: `data.verify(proof)`)."""
        from . import outer

        outer.verify_outer(self.outer_data(table_bits, device), proof, publics, config)
