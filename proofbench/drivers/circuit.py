"""Driver of a circuit cell: a closed loop of circuit proofs.

A proof is what a circuit builder pays for each time: `generate_witness`
(the BN254 hook's inner batch STARK traced, proved, self-verified and its
values injected, then the generator fixpoint) and `prove_outer` (the outer
universal-gate STARK at the configuration's StarkConfig, device
transcript), ending in a synchronise.  The circuit is built once, in
set-up, with the operations' scalars drawn from the seed (stream
"circuit") and every output's limbs public, in order; each proof sets
fresh bases x, drawn from the seed.

The traced run adds synchronised spans around the witness and the outer
proof, the program's TimingTree "quotient" scope of the outer proof, and
after the window the last proof's outer proof made once more under the
profiler, with the scopes the traffic file names in `profile_skip` left
out (the outer quotient launches ~2.5 M kernels, more than a profiler
window of a 360 s run can hold).

The judge holds a sample of the window's proofs against the plain
reference: every operation's public output against x^s worked out by
integer arithmetic, and the outer proof against the reference's outer
verifier, whose constant columns it evaluates itself from the compiled
circuit's values (the program's state; the reference does not recompile
the circuit, so what ties an output to its inputs is the statement check).
"""

from __future__ import annotations

import time
import traceback

from reference import bn254, outer, verify
from yardstick import profile, traffic, work
from yardstick.proofs import plain_proof

OUT_LIMBS = 8  # 32-bit limbs of an Fq output, as the circuit makes it public


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device, traced: bool, log,
                 profiled: bool = False):
        import torch

        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.traced, self.profiled, self.log = traced, profiled or traced, log
        self.outputs = []  # per window proof: (publics, proof object)
        self.spans = {"witness_s": [], "outer_prove_s": [], "quotient_s": []}
        self.last = None

    def setup(self) -> None:
        import torch

        from plonky2_bn254_tpu_torch import kernels
        from plonky2_bn254_tpu_torch.circuit import builder_ops, outer as prog_outer
        from plonky2_bn254_tpu_torch.circuit.builder import CircuitBuilder, Witness
        from plonky2_bn254_tpu_torch.circuit.fq import FqTarget
        from plonky2_bn254_tpu_torch.field import native
        from plonky2_bn254_tpu_torch.prover.config import StarkConfig
        from plonky2_bn254_tpu_torch.utils.timing import TimingTree

        self.torch, self.Witness, self.TimingTree = torch, Witness, TimingTree
        self.prove_outer = prog_outer.prove_outer
        native.library()
        if self.device.type == "cuda":
            kernels.library()
        self.stark_config = StarkConfig(**self.config["stark_config"])
        t0 = time.perf_counter()
        builder = CircuitBuilder()
        builder_ops.get_bn254_hook(builder).stark_config = self.stark_config
        g = traffic.rng(self.seed, "circuit")
        self.scalars = [traffic.draw("scalar", g, self.mix["scalar"])
                        for _ in range(self.mix["ops_per_proof"])]
        bases, outs = [], []
        for s in self.scalars:
            x_t = FqTarget.new_unchecked(builder)
            outs.append(builder_ops.fq_exp(builder, s, x_t))
            bases.append(x_t)
        self.compile(builder, bases, outs)
        self._sync()
        self.log(f"# circuit: build and outer_data {time.perf_counter() - t0:.3f} s, "
                 f"{self.circuit.builder.num_targets:,} targets, outer 2^{self.data.n_log} x "
                 f"{self.data.lay.width}")
        for k in range(self.config["warmup_proofs"].get(self.mix["driver"], 0)):
            t0 = time.perf_counter()
            self._proof("warmup", k)
            self.log(f"# warm-up proof {k}: {time.perf_counter() - t0:.3f} s")

    def compile(self, builder, bases, outs) -> None:
        """Every output's limbs made public, in order; the circuit built and
        its outer data laid out."""
        for out in outs:
            for t in out.value.limbs:
                builder.register_public_input(t)
        self.bases, self.circuit = bases, builder.build()
        self.data = self.circuit.outer_data(self.config["circuit"]["table_bits"], self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _xs(self, stream: str, k: int) -> list:
        g = traffic.rng(self.seed, stream, k)
        return [traffic.draw("fq", g) for _ in self.scalars]

    def _proof(self, stream: str, k: int, tt=None, spans=None):
        pw = self.Witness()
        for x_t, x in zip(self.bases, self._xs(stream, k)):
            x_t.set_witness(pw, x)
        t0 = time.perf_counter()
        values = self.circuit.generate_witness(pw, self.device)
        if spans is not None:
            self._sync()
            t1 = time.perf_counter()
        proof, publics = self.prove_outer(self.data, values, self.stark_config, timing=tt)
        self._sync()
        if spans is not None:
            spans["witness_s"].append(t1 - t0)
            spans["outer_prove_s"].append(time.perf_counter() - t1)
            spans["quotient_s"].append(tt.total("quotient"))
        if self.profiled:
            self.last = values
        return publics, proof

    def step(self, k: int) -> bool:
        tt = self.TimingTree(enabled=True) if self.traced else None
        try:
            self.outputs.append(self._proof("window", k, tt, self.spans if self.traced else None))
        except Exception:  # a failed proof is counted, and the window goes on
            self.log(f"# proof {k} failed:\n{traceback.format_exc()}")
            self.outputs.append(None)
            return False
        return True

    def ops_per_proof(self) -> int:
        return len(self.scalars)

    def after_window(self) -> dict:
        """Profiled run: the spans (traced run only), and the last proof's
        outer proof made once more under the profiler."""
        if not self.profiled or self.last is None:
            return {}
        values, self.last = self.last, None
        skip = self.mix.get("profile_skip", [])
        session = profile.Session(skip)
        tree = session.annotate(self.TimingTree(enabled=False))
        _, reduced = session.run(
            lambda: self.prove_outer(self.data, values, self.stark_config, timing=tree),
            self.log)
        lay, cfg = self.data.lay, self.config["stark_config"]
        machine = outer.outer_machine(outer.OuterLayout(lay.S, lay.Q, lay.R, lay.NP),
                                      self.data.pub_wires)
        least = work.batch_prove_least_s(machine.width,
                                         verify.aux_width(machine) * cfg["num_challenges"],
                                         self.data.n_log, cfg, skip)
        return {"spans": self.spans, "profile": reduced, "least_kernel_s": least}

    def release(self) -> None:
        """Keep what the judge reads (the compiled circuit's constant columns
        in value form, its shape and public wires) on the host; drop the rest."""
        from plonky2_bn254_tpu_torch.interop import u64_from_tensor

        lay = self.data.lay
        self.circuit_state = {
            "layout": (lay.S, lay.Q, lay.R, lay.NP), "n_log": self.data.n_log,
            "pub_wires": list(self.data.pub_wires),
            "const_values": u64_from_tensor(self.data.const_cols.cpu())}
        self.outputs = [None if o is None else (o[0], plain_proof(o[1])) for o in self.outputs]
        self.data = self.circuit = self.bases = None
        self.torch.cuda.empty_cache()

    def outputs_wrong(self, publics, xs) -> int:
        """Operations whose public output differs from x^s (all of them
        where the publics are not one output of OUT_LIMBS limbs each)."""
        if len(publics) != OUT_LIMBS * len(xs):
            return len(xs)
        wrong = 0
        for j, (s, x) in enumerate(zip(self.scalars, xs)):
            limbs = publics[OUT_LIMBS * j:OUT_LIMBS * (j + 1)]
            wrong += sum(int(v) << (32 * i) for i, v in enumerate(limbs)) != pow(x, s, bn254.P)
        return wrong

    def judge(self) -> dict:
        """{check: (value, limit)}: proofs the reference rejects (a sampled
        proof that failed counts as rejected) and operations whose public
        output differs from x^s."""
        n = len(self.outputs)
        size = min(n, self.mix["judge_proofs"])
        sample = sorted(traffic.rng(self.seed, "judge").choice(n, size=size, replace=False))
        st = self.circuit_state
        machine = outer.outer_machine(outer.OuterLayout(*st["layout"]), st["pub_wires"])
        rejected = wrong = 0
        for k in sample:
            if self.outputs[k] is None:
                rejected += 1
                continue
            publics, proof = self.outputs[k]
            wrong += self.outputs_wrong(publics, self._xs("window", int(k)))
            check = outer.constant_column_check(outer.OuterLayout(*st["layout"]),
                                                st["const_values"], st["n_log"],
                                                traffic.rng(self.seed, "judge", int(k) + 1))
            t0 = time.perf_counter()
            reason = verify.verify(machine, proof, machine.ctl_values(publics),
                                   self.config["stark_config"], st["n_log"], check)
            self.log(f"# proof {k}: reference {'accepts' if reason is None else 'rejects'} "
                     f"({time.perf_counter() - t0:.2f} s){'' if reason is None else ': ' + reason}")
            rejected += reason is not None
        return {"proofs_rejected": (rejected, 0), "outputs_wrong": (wrong, 0)}
