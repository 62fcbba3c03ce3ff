"""`correct` comes out false when the timed path is broken, and for the control.

The card tests drive the rest of a run (run.run_cell: set-up, the window,
the judge) past run.py's look for a card, on the card, with the program
broken underneath by `patch`.  They skip without a card: the machines
prove only at 2^16 rows and more, about ten minutes a proof on the CPU.

The control is the program at a weaker configuration than the cell states
(42 FRI queries for 84, in the outer proof for the circuit cell): the step
that would tempt a later change.  The faults are those a cell can have: an
answer altered where it is produced (in a batch trace; in the stated
outputs; in the circuit's witness), half of a batch or of a circuit's
operations left out, and a proof served again from the previous request.

    python -m pytest proofbench/tests/test_proofbench_faults.py -m cuda -q -s
"""

import dataclasses
import json
import pathlib

import pytest

import run

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEEDS = [2**31 + 101, 3_000_000_019, 4_294_967_311]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the machines prove only at 2^16 rows and more, "
                    "about ten minutes a proof on the CPU")
    return torch.device("cuda", 0)


def _run(card, cell, seed, seconds, patch=None):
    result = run.run_cell(BENCH, cell, seed, seconds, False, card, patch)
    print(f"\n{cell} seed {seed}: correct {result['correct']}, attempted "
          f"{result['attempted']}, checks {json.dumps(result['checks'])}")
    return result


def weaker_config(driver):
    driver.stark_config = dataclasses.replace(driver.stark_config, num_query_rounds=42)


def answer_altered_in_trace(driver):
    """Op 0's first output column on its last row, as generate_trace
    produces it (the output columns are those of the machine's second
    cross-table lookup)."""
    from reference import machines, stark

    kind, col = machines.machine(driver.config["machine"]).ctls[1].columns[0]
    assert kind == "single"
    make = driver.module.generate_trace

    def generate_trace(inputs, **kw):
        trace = make(inputs, **kw)
        trace[stark.PERIOD - 1, col] += 1
        return trace

    driver.module = _Wrapped(driver.module, generate_trace=generate_trace)


def answer_altered_in_statement(driver):
    make = driver.module.generate_ctl_values

    def generate_ctl_values(inputs):
        ctl = make(inputs)
        ctl[1][0][0] ^= 1
        return ctl

    driver.module = _Wrapped(driver.module, generate_ctl_values=generate_ctl_values)


def half_batch(driver):
    mod = driver.module
    driver.module = _Wrapped(
        mod, generate_ctl_values=lambda inputs: mod.generate_ctl_values(inputs[:len(inputs) // 2]),
        generate_trace=lambda inputs, **kw: mod.generate_trace(inputs[:len(inputs) // 2], **kw))


def answer_altered_in_witness(driver):
    """The circuit's first public output, altered in the witness that
    generate_witness produces, before the outer proof."""
    make = driver.circuit.generate_witness
    wire = driver.data.pub_wires[0]

    def generate_witness(pw, device):
        values = make(pw, device)
        values[wire] = (values[wire] + 1) % (2**64 - 2**32 + 1)
        return values

    driver.circuit.generate_witness = generate_witness


def half_circuit(driver):
    """Op 1 left out of the circuit: the hook proves op 0 alone, and the
    circuit states op 0's output for op 1 as well (the rest of the batch
    standing in for the half left out).  Every constraint the circuit has
    holds, so the outer proof verifies; only op 1's statement is wrong."""
    from plonky2_bn254_tpu_torch.circuit import builder_ops
    from plonky2_bn254_tpu_torch.circuit.builder import CircuitBuilder
    from plonky2_bn254_tpu_torch.circuit.fq import FqTarget

    builder = CircuitBuilder()
    builder_ops.get_bn254_hook(builder).stark_config = driver.stark_config
    bases = [FqTarget.new_unchecked(builder) for _ in driver.scalars]
    out = builder_ops.fq_exp(builder, driver.scalars[0], bases[0])
    copies = [out]
    for _ in driver.scalars[1:]:
        copy = FqTarget.new_unchecked(builder)
        for a, b in zip(out.value.limbs, copy.value.limbs):
            builder.connect(a, b)
        copies.append(copy)
    driver.compile(builder, bases, copies)


def served_again(driver):
    """Every proof after the first is made, and the previous answer served."""
    proof = driver._proof

    def cached(stream, k, tt=None, spans=None):
        fresh = proof(stream, k, tt, spans)
        return driver.outputs[-1] if stream == "window" and k > 0 else fresh

    driver._proof = cached


class _Wrapped:
    """A module with some functions replaced."""

    def __init__(self, module, **fns):
        self._module, self._fns = module, fns

    def __getattr__(self, name):
        return self._fns.get(name) or getattr(self._module, name)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["g1.batch128", "fq_exp.circuit2", "fq_exp.batch128"])
def test_sound_run_is_correct(card, cell):
    assert _run(card, cell, SEEDS[0], 1)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["g1.batch128", "fq_exp.circuit2", "fq_exp.batch128"])
def test_control_is_not_correct(card, cell, seed):
    result = _run(card, cell, seed, 1, weaker_config)
    assert not result["correct"]
    assert result["checks"]["proofs_rejected"]["value"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("fault,cell,seconds", [
    (answer_altered_in_trace, "fq_exp.batch128", 1),
    (answer_altered_in_trace, "g1.batch128", 1),
    (answer_altered_in_statement, "fq_exp.batch128", 1),
    (half_batch, "fq_exp.batch128", 1),
    (served_again, "fq_exp.batch128", 8),
    (answer_altered_in_witness, "fq_exp.circuit2", 1),
    (half_circuit, "fq_exp.circuit2", 1),
])
def test_fault_is_not_correct(card, fault, cell, seconds):
    result = _run(card, cell, SEEDS[1], seconds, fault)
    assert not result["correct"]


def test_judge_counts_a_wrong_statement_and_a_rejected_proof():
    """The judge on the CPU: a sampled proof the reference cannot accept and
    an operation whose stated output differs both count."""
    drv_mod = run.load_module(run.HERE / "drivers" / "batch.py", "test_batch_driver")
    config = run.load_json(run.HERE / "configs" / "fq_exp.json")
    mix = dict(run.load_json(run.HERE / "traffic" / "batch128.json"), ops_per_proof=4)
    drv = drv_mod.Driver(config, mix, 5, "cpu", False, lambda msg: None)
    from reference import machines

    ops, _ = drv._inputs("window", 0)
    stated = machines.machine("fq_exp").ctl_values(ops)
    stated[1][2][0] ^= 1
    drv.outputs = [(stated, {"degree_bits": 16})]
    checks = drv.judge()
    assert checks == {"proofs_rejected": (1, 0), "outputs_wrong": (1, 0)}


def test_circuit_judge_holds_every_output_to_its_inputs():
    """Each of the circuit's public outputs is held to x^s by integer
    arithmetic: a wrong second output counts, and so do missing limbs."""
    from reference import bn254

    drv_mod = run.load_module(run.HERE / "drivers" / "circuit.py", "test_circuit_driver")
    config = run.load_json(run.HERE / "configs" / "fq_exp.json")
    mix = run.load_json(run.HERE / "traffic" / "circuit2.json")
    drv = drv_mod.Driver(config, mix, 5, "cpu", False, lambda msg: None)
    drv.scalars = [3 << 150 | 7, 5 << 150 | 11]
    xs = drv._xs("window", 0)
    outs = [pow(x, s, bn254.P) for s, x in zip(drv.scalars, xs)]
    publics = [(y >> (32 * i)) & 0xFFFFFFFF for y in outs for i in range(drv_mod.OUT_LIMBS)]
    assert drv.outputs_wrong(publics, xs) == 0
    second = publics[:drv_mod.OUT_LIMBS] * 2  # op 0's output stated for op 1
    assert drv.outputs_wrong(second, xs) == 1
    assert drv.outputs_wrong(publics[:drv_mod.OUT_LIMBS], xs) == 2
