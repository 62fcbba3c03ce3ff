"""Driver of a batch STARK cell: a closed loop of machine proofs.

A proof is what a user of the machine pays for: the statement (the
program's `generate_ctl_values`), the trace (`generate_trace` on the card)
and `prove` at the configuration's StarkConfig with the Fiat-Shamir
transcript on the device, ending in a synchronise.  Each proof's
operations are new, drawn from the seed (`yardstick.traffic`).

The traced run adds, per window proof, synchronised spans around the trace
and the prove call and the program's own TimingTree scopes (which
synchronise too).  After the window of a profiled run (a traced run, or one
that reports a metric read from the device trace) the last proof's trace is
proved once more under the profiler (`yardstick.profile`): the device
metrics read that fixed part of a proof, not the trace generation's
millions of launches.

The judge draws a sample of the window's proofs from the seed and holds
each against the plain reference: the statement against one worked out by
BN254 arithmetic, the proof against the reference verifier at the
configuration's settings.
"""

from __future__ import annotations

import importlib
import time
import traceback

from reference import machines, verify
from yardstick import profile, traffic, work
from yardstick.proofs import plain_proof


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device, traced: bool, log,
                 profiled: bool = False):
        import torch

        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.traced, self.profiled, self.log = traced, profiled or traced, log
        self.n_ops = mix["ops_per_proof"]
        rows = max(1 << config["min_rows_log2"], config["rows_per_op"] * self.n_ops)
        self.degree_bits = rows.bit_length() - 1
        self.outputs = []  # per window proof: (program's statement, proof object)
        self.spans = {"trace_gen_s": [], "prove_s": [], "quotient_s": []}
        self.last = None  # profiled run: the last proof's (statement, trace)

    # -- the program ---------------------------------------------------------

    def setup(self) -> None:
        import torch

        from plonky2_bn254_tpu_torch import kernels
        from plonky2_bn254_tpu_torch.field import native
        from plonky2_bn254_tpu_torch.prover import prove
        from plonky2_bn254_tpu_torch.prover.config import StarkConfig
        from plonky2_bn254_tpu_torch.starks import table
        from plonky2_bn254_tpu_torch.utils.timing import TimingTree

        self.torch, self.prove_fn, self.TimingTree = torch, prove.prove, TimingTree
        prog = self.config["program"]
        self.module = importlib.import_module(prog["module"])
        self.stark = getattr(table, prog["stark"])()
        self.stark_config = StarkConfig(**self.config["stark_config"])
        native.library()
        if self.device.type == "cuda":
            kernels.library()
        for k in range(self.config["warmup_proofs"].get(self.mix["driver"], 0)):
            t0 = time.perf_counter()
            self._proof("warmup", k)
            self.log(f"# warm-up proof {k}: {time.perf_counter() - t0:.3f} s")

    def _inputs(self, stream: str, k: int) -> tuple:
        """(the operations, the program's inputs: each with its timestamp)."""
        ops = traffic.operations(self.seed, stream, k, self.config["operands"], self.n_ops,
                                 self.mix["scalar"])
        return ops, [op + (t,) for t, op in enumerate(ops)]

    def _proof(self, stream: str, k: int, tt=None, spans=None):
        """One proof: (the program's statement, its proof)."""
        _, inputs = self._inputs(stream, k)
        t0 = time.perf_counter()
        ctl = self.module.generate_ctl_values(inputs)
        trace = self.module.generate_trace(inputs, device=self.device)
        if spans is not None:
            self._sync()
            t1 = time.perf_counter()
        proof = self.prove_fn(self.stark, trace, ctl, self.stark_config, timing=tt,
                             device_fs=True)
        self._sync()
        if spans is not None:
            spans["trace_gen_s"].append(t1 - t0)
            spans["prove_s"].append(time.perf_counter() - t1)
            spans["quotient_s"].append(tt.total("quotient"))
        if self.profiled:
            self.last = (ctl, trace)
        return ctl, proof

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def step(self, k: int) -> bool:
        """The window's proof k; False if the program raised."""
        tt = self.TimingTree(enabled=True) if self.traced else None
        try:
            self.outputs.append(self._proof("window", k, tt, self.spans if self.traced else None))
        except Exception:  # a failed proof is counted, and the window goes on
            self.log(f"# proof {k} failed:\n{traceback.format_exc()}")
            self.outputs.append(None)
            return False
        return True

    def ops_per_proof(self) -> int:
        return self.n_ops

    def after_window(self) -> dict:
        """Profiled run: the spans (traced run only), and the last window
        proof's trace proved once more under the profiler."""
        if not self.profiled or self.last is None:
            return {}
        ctl, trace = self.last
        self.last = None

        skip = self.mix.get("profile_skip", [])
        session = profile.Session(skip)
        tree = session.annotate(self.TimingTree(enabled=False))
        _, reduced = session.run(
            lambda: self.prove_fn(self.stark, trace, ctl, self.stark_config, timing=tree,
                                 device_fs=True),
            self.log)
        machine, cfg = machines.machine(self.config["machine"]), self.config["stark_config"]
        least = work.batch_prove_least_s(machine.width,
                                         verify.aux_width(machine) * cfg["num_challenges"],
                                         self.degree_bits, cfg, skip)
        return {"spans": self.spans, "profile": reduced, "least_kernel_s": least}

    def release(self) -> None:
        """Drop the program's device state before the reference runs."""
        self.outputs = [None if o is None else (o[0], plain_proof(o[1])) for o in self.outputs]
        self.module = self.stark = self.last = None
        self.torch.cuda.empty_cache()

    # -- the judge -----------------------------------------------------------

    def judge(self) -> dict:
        """{check: (value, limit)}: proofs the reference rejects (a sampled
        proof that failed counts as rejected) and operations whose statement
        differs from the reference's."""
        n = len(self.outputs)
        size = min(n, self.mix["judge_proofs"])
        sample = sorted(traffic.rng(self.seed, "judge").choice(n, size=size, replace=False))
        machine = machines.machine(self.config["machine"])
        rejected = wrong = 0
        for k in sample:
            if self.outputs[k] is None:
                rejected += 1
                continue
            ctl, proof = self.outputs[k]
            ops, _ = self._inputs("window", int(k))
            want = machine.ctl_values(ops)
            wrong += sum(got != exp for c in want for got, exp in
                         zip(ctl.get(c, []), want[c])) + sum(
                abs(len(ctl.get(c, [])) - len(want[c])) for c in want)
            t0 = time.perf_counter()
            reason = verify.verify(machine, proof, want, self.config["stark_config"],
                                   self.degree_bits)
            self.log(f"# proof {k}: reference {'accepts' if reason is None else 'rejects'} "
                     f"({time.perf_counter() - t0:.2f} s){'' if reason is None else ': ' + reason}")
            rejected += reason is not None
        return {"proofs_rejected": (rejected, 0), "outputs_wrong": (wrong, 0)}
