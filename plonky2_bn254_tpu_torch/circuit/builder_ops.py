"""STARK-accelerated batch ops on the circuit builder + the BN254 hook.

Port of `plonky2_bn254_tpu/circuit/builder_ops.py`, a rebuild of the
reference crate's src/builder.rs:23-151 (trait BuilderBn254Stark) and
src/hook.rs:19-98 (Bn254Hook): `fq_exp` / `g1_scalar_mul` / `g2_scalar_mul`
record (input, fresh unchecked output) pairs into a keyed hook and attach a
per-op native generator; at `build()` the hook's `constrain` runs once per
op kind and registers a batch generator that, at witness time, builds the
whole trace with this package's machines on `hook.device` (the card unless
the caller asks for the CPU), produces ONE STARK proof for all ops of that
kind, self-verifies it, and binds the circuit's witness values as the
proof's CTL values (the reference's StarkProofGenerator role,
generators/g1/stark_proof.rs:39-195).

Set `hook.prove_starks = False` for the reference's
`not-constrain-bn254-stark` fast-debug mode (hook.rs:92-93).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..bn254 import oracle, params
from ..starks import fq_exp as fq_exp_machine
from ..starks import g1_scalar_mul as g1_machine
from ..starks import g2_scalar_mul as g2_machine
from ..starks import table
from . import biguint as bu
from . import to_u16
from .builder import CircuitBuilder, Generator
from .curves import G1Target, G2Target
from .fq import FqTarget

HOOK_KEY = "bn254"
PERIOD = 512  # rows per op: G1_PERIOD == G2_PERIOD == FQ_PERIOD
MIN_ROWS = 1 << 16  # the machines' range-counter column needs 2^16 rows


def _fq_exp_rows(builder, inp, out):
    """An fq_exp op's CTL value targets, its timestamp left out: (x, s) and x^s."""
    s, x = inp
    return (to_u16.fq_to_u16(builder, x) + to_u16.limbs32_to_u16(builder, s.limbs, 16),
            to_u16.fq_to_u16(builder, out))


def _scalar_mul_rows(point_to_u16):
    """A scalar-mul op's CTL value targets, its timestamp left out: (x,
    offset, s) and s x + offset."""

    def ctl_rows(builder, inp, out):
        s, x, offset = inp
        return (point_to_u16(builder, x) + point_to_u16(builder, offset)
                + to_u16.limbs32_to_u16(builder, s.limbs, 16), point_to_u16(builder, out))

    return ctl_rows


# op kind -> (machine module, Stark factory, CTL value targets of one op)
MACHINES = {
    "fq_exp": (fq_exp_machine, table.fq_exp_stark, _fq_exp_rows),
    "g1_scalar_mul": (g1_machine, table.g1_scalar_mul_stark, _scalar_mul_rows(to_u16.g1_to_u16)),
    "g2_scalar_mul": (g2_machine, table.g2_scalar_mul_stark, _scalar_mul_rows(to_u16.g2_to_u16)),
}


class Bn254Hook:
    def __init__(self):
        self.inputs_fq: List = []  # (s_biguint_target, x_fq_target)
        self.outputs_fq: List[FqTarget] = []
        self.inputs_g1: List = []  # (s, x, offset)
        self.outputs_g1: List[G1Target] = []
        self.inputs_g2: List = []
        self.outputs_g2: List[G2Target] = []
        self.prove_starks = True
        self.stark_config = None  # default chosen at constrain time
        self.proof = None  # {kind: (proof, ctl_values)}
        self.proof_targets = {}  # {kind: StarkProofTarget} (set at build)
        self.device = torch.device("cuda")  # set by Circuit.generate_witness
        self.timing = None  # TimingTree of the witness-time stages; None: the process tree

    def constrain(self, builder: CircuitBuilder):
        """Emit the deferred batch-STARK generators (hook.rs:56-90)."""
        from ..prover.config import DEFAULT_CONFIG

        config = self.stark_config or DEFAULT_CONFIG
        self.proof = {}
        if not self.prove_starks:
            # the reference's `not-constrain-bn254-stark` feature: constrain
            # becomes a no-op (hook.rs:92-93); single-op generators still
            # fill the outputs natively.
            return

        if self.inputs_fq:
            self._constrain_kind(
                builder, config, "fq_exp", self.inputs_fq, self.outputs_fq
            )
        if self.inputs_g1:
            self._constrain_kind(
                builder, config, "g1_scalar_mul", self.inputs_g1, self.outputs_g1
            )
        if self.inputs_g2:
            self._constrain_kind(
                builder, config, "g2_scalar_mul", self.inputs_g2, self.outputs_g2
            )

    def _constrain_kind(self, builder, config, kind, inputs, outputs):
        """The reference's StarkProofGenerator::new (stark_proof.rs:55-109):
        at build time, resplit the recorded circuit wires into 16-bit CTL
        value targets (ToU16), allocate the whole STARK proof as witness
        targets, and emit the in-circuit recursive verifier whose CTL
        extra-looking sums BIND those wires to the proven trace; at witness
        time (run_once, stark_proof.rs:136-179), prove the batch STARK,
        self-verify, and write the proof into its targets."""
        from .stark_verifier import (
            add_virtual_stark_proof,
            flatten_proof_targets,
            set_stark_proof_target,
            verify_stark_proof_circuit,
        )

        hook = self
        n_ops = len(inputs)
        degree = max(MIN_ROWS, n_ops * PERIOD)
        degree_bits = (degree - 1).bit_length()

        dep_targets = []
        for inp, out in zip(inputs, outputs):
            for part in inp:
                dep_targets.extend(t.index for t in _to_vec(part))
            dep_targets.extend(t.index for t in _to_vec(out))

        machine, make_stark, ctl_rows = MACHINES[kind]
        # ---- build-time: CTL value targets (ToU16 resplit) --------------
        in_rows, out_rows = [], []
        for t_idx, (inp, out) in enumerate(zip(inputs, outputs)):
            ts = builder.constant(t_idx)
            in_row, out_row = ctl_rows(builder, inp, out)
            in_rows.append(in_row + [ts])
            out_rows.append(out_row + [ts])
        ctl_target_rows = {0: in_rows, 1: out_rows}

        # ---- build-time: recursive STARK verifier sub-circuit -----------
        stark = make_stark()
        proof_t = add_virtual_stark_proof(builder, stark, degree_bits, config)
        self.proof_targets[kind] = proof_t
        verify_stark_proof_circuit(builder, stark, proof_t, ctl_target_rows, config)

        # ---- witness-time: prove, self-verify, inject proof -------------
        proof_targets = flatten_proof_targets(proof_t)

        def run(w):
            from ..prover import prove as prove_mod
            from ..prover import verify as verify_mod
            from ..utils import timing as timing_mod

            stark_inputs = [
                tuple(part.get_witness(w) for part in inp) + (t,)
                for t, inp in enumerate(inputs)
            ]
            tt = timing_mod.get(hook.timing)
            with tt.scope(f"{kind} trace gen"):
                trace = machine.generate_trace(stark_inputs, MIN_ROWS, device=hook.device)
            ctl_values = machine.generate_ctl_values(stark_inputs)
            assert trace.shape[0] == 1 << degree_bits
            with tt.scope(f"{kind} prove"):
                proof = prove_mod.prove(stark, trace, ctl_values, config, timing=tt)
            del trace
            # self-verify (stark_proof.rs:136-179 does the same)
            with tt.scope(f"{kind} self-verify"):
                verify_mod.verify(stark, proof, ctl_values, config)
            hook.proof[kind] = (proof, ctl_values)
            with tt.scope("inject"):
                return set_stark_proof_target(proof_t, proof)

        builder.add_generator(
            Generator(
                dep_targets,
                [t.index for t in proof_targets],
                run,
                f"stark:{kind}",
            )
        )


def _to_vec(part):
    if hasattr(part, "to_vec"):
        return part.to_vec()
    if hasattr(part, "limbs"):
        return part.limbs
    return [part]


def get_bn254_hook(builder: CircuitBuilder) -> Bn254Hook:
    return builder.get_hook(HOOK_KEY, Bn254Hook)


# ---------------------------------------------------------------------------
# The BuilderBn254Stark trait surface (builder.rs:25-125)
# ---------------------------------------------------------------------------


def fq_exp(builder: CircuitBuilder, s, x: FqTarget) -> FqTarget:
    """x^s via the batched FqExp STARK; O(1) circuit cost at call time.

    The base is canonicalised (`take_mod`) before recording: the STARK
    trace holds the REDUCED x (exp_stark.rs feeds canonical values), and
    the hook's build-time ToU16 resplit requires exactly 8 u32 limbs.
    The reference never needs this because its FqTarget is always 8 limbs
    with lazy reduction as a flag (fq.rs:42-44); ours carries extra limbs
    when unreduced, so e.g. `is_square` on an Fq2-norm product (17 limbs)
    would crash at build() without this guard."""
    if isinstance(s, int):
        s = bu.constant_biguint(builder, s)
        if s.num_limbs < 8:
            s = bu.BigUintTarget(s.limbs + [builder.zero()] * (8 - s.num_limbs))
    x = x.take_mod(builder)
    out = FqTarget.new_unchecked(builder)
    hook = get_bn254_hook(builder)
    hook.inputs_fq.append((s, x))
    hook.outputs_fq.append(out)

    def run(w, s=s, x=x, out=out):
        res_v = pow(x.get_witness(w), s.get_witness(w), params.P)
        return {
            t.index: (res_v >> (32 * i)) & bu.LIMB_MASK
            for i, t in enumerate(out.value.limbs)
        }

    builder.add_generator(
        Generator(
            [t.index for t in s.limbs + x.value.limbs],
            [t.index for t in out.value.limbs],
            run,
            "fq_single",
        )
    )
    return out


def g1_scalar_mul(
    builder: CircuitBuilder, s, x: G1Target, offset: G1Target
) -> G1Target:
    """s*x + offset via the batched G1 STARK (builder.rs:56-78)."""
    if isinstance(s, int):
        s = bu.constant_biguint(builder, s)
    # canonicalise coordinates before recording (see fq_exp docstring):
    # points assembled from gadget algebra can carry unreduced limbs.
    x = G1Target(x.x.take_mod(builder), x.y.take_mod(builder))
    offset = G1Target(offset.x.take_mod(builder), offset.y.take_mod(builder))
    out = G1Target.new_unchecked(builder)
    hook = get_bn254_hook(builder)
    hook.inputs_g1.append((s, x, offset))
    hook.outputs_g1.append(out)

    def run(w, s=s, x=x, offset=offset, out=out):
        res = oracle.g1_add(
            oracle.g1_mul(x.get_witness(w), s.get_witness(w)), offset.get_witness(w)
        )
        values = {}
        for i, t in enumerate(out.x.value.limbs):
            values[t.index] = (res[0] >> (32 * i)) & bu.LIMB_MASK
        for i, t in enumerate(out.y.value.limbs):
            values[t.index] = (res[1] >> (32 * i)) & bu.LIMB_MASK
        return values

    builder.add_generator(
        Generator(
            [t.index for t in s.limbs + x.to_vec() + offset.to_vec()],
            [t.index for t in out.to_vec()],
            run,
            "g1_single",
        )
    )
    return out


def g2_scalar_mul(
    builder: CircuitBuilder, s, x: G2Target, offset: G2Target
) -> G2Target:
    """s*x + offset via the batched G2 STARK (builder.rs:80-103)."""
    if isinstance(s, int):
        s = bu.constant_biguint(builder, s)
    # canonicalise coordinates before recording (see fq_exp docstring).
    x = G2Target(x.x.take_mod(builder), x.y.take_mod(builder))
    offset = G2Target(offset.x.take_mod(builder), offset.y.take_mod(builder))
    out = G2Target.new_unchecked(builder)
    hook = get_bn254_hook(builder)
    hook.inputs_g2.append((s, x, offset))
    hook.outputs_g2.append(out)

    def run(w, s=s, x=x, offset=offset, out=out):
        res = oracle.g2_add(
            oracle.g2_mul(x.get_witness(w), s.get_witness(w)), offset.get_witness(w)
        )
        values = {}
        flat = (
            out.x.c0.value.limbs,
            out.x.c1.value.limbs,
            out.y.c0.value.limbs,
            out.y.c1.value.limbs,
        )
        vals = (res[0][0], res[0][1], res[1][0], res[1][1])
        for limbs, v in zip(flat, vals):
            for i, t in enumerate(limbs):
                values[t.index] = (v >> (32 * i)) & bu.LIMB_MASK
        return values

    builder.add_generator(
        Generator(
            [t.index for t in s.limbs + x.to_vec() + offset.to_vec()],
            [t.index for t in out.to_vec()],
            run,
            "g2_single",
        )
    )
    return out


# ---------------------------------------------------------------------------
# Random blinding generators (generators/{g1,g2}/random.rs)
# ---------------------------------------------------------------------------


def set_random_g1(builder: CircuitBuilder, target: G1Target, seed: Optional[int] = None):
    """Unconstrained witness hint: sample a random G1 point."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def run(w, target=target, rng=rng):
        pt = oracle.random_g1(rng)
        values = {}
        for i, t in enumerate(target.x.value.limbs):
            values[t.index] = (pt[0] >> (32 * i)) & bu.LIMB_MASK
        for i, t in enumerate(target.y.value.limbs):
            values[t.index] = (pt[1] >> (32 * i)) & bu.LIMB_MASK
        return values

    builder.add_generator(
        Generator([], [t.index for t in target.to_vec()], run, "random_g1")
    )


def set_random_g2(builder: CircuitBuilder, target: G2Target, seed: Optional[int] = None):
    import numpy as np

    rng = np.random.default_rng(seed)

    def run(w, target=target, rng=rng):
        pt = oracle.random_g2(rng)
        values = {}
        flat = (
            target.x.c0.value.limbs,
            target.x.c1.value.limbs,
            target.y.c0.value.limbs,
            target.y.c1.value.limbs,
        )
        vals = (pt[0][0], pt[0][1], pt[1][0], pt[1][1])
        for limbs, v in zip(flat, vals):
            for i, t in enumerate(limbs):
                values[t.index] = (v >> (32 * i)) & bu.LIMB_MASK
        return values

    builder.add_generator(
        Generator([], [t.index for t in target.to_vec()], run, "random_g2")
    )
