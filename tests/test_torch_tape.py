"""Constraint tapes (prover/tape.py): each machine's constraint system
recorded once as a straight-line program, run instruction by instruction
in plain torch (K5's emulation, `quotient_cuda.quotient_values` on a CPU
tensor), equals the prover's eager GL-ring evaluation bit for bit, with
the challenges as python ints (host transcript) and as 0-d tensors
(device transcript).  The card tests (tests/test_torch_cuda.py) hold K5 to
the same emulation.
"""

import pytest
import torch

from plonky2_bn254_tpu_torch.field import goldilocks as gl
from plonky2_bn254_tpu_torch.prover import quotient_cuda
from plonky2_bn254_tpu_torch.prover import tape as tape_mod
from plonky2_bn254_tpu_torch.starks.demo import demo_stark
from plonky2_bn254_tpu_torch.starks.table import Lookup, Stark
from torch_tape_machines import MACHINES, eager_values, random_case

torch.set_num_threads(2)
N_POINTS = 19  # not a power of two: the tape is pointwise


def _run_tape(stark, case, nxt_shift=0):
    tape = tape_mod.tape_of(stark, len(case["alphas"]))
    inputs = tape_mod.scalar_inputs(stark, case["alphas"], case["challenges"], case["totals"],
                                    case["t_loc"].device)
    return quotient_cuda.quotient_values(tape, case["t_loc"], case["t_nxt"], case["a_loc"],
                                         case["a_nxt"], case["sel"], inputs, nxt_shift)


@pytest.mark.parametrize("scalars", ["ints", "tensors"])
@pytest.mark.parametrize("machine", list(MACHINES))
def test_tape_equals_the_eager_gl_ring(machine, scalars):
    stark = MACHINES[machine]()
    case = random_case(stark, N_POINTS, seed=len(machine), as_tensors=scalars == "tensors")
    got = _run_tape(stark, case)
    assert got.shape == (2, N_POINTS)
    assert torch.equal(got, eager_values(stark, case))


@pytest.mark.parametrize("machine", ["demo", "mod_zero", "outer_poseidon"])
def test_next_rows_by_shift_equal_the_rolled_rows(machine):
    """With `nxt_shift` the next row of point i is column i + shift of the
    local LDEs themselves, as the prover passes them off a mesh."""
    stark = MACHINES[machine]()
    case = random_case(stark, 16, seed=5)
    shift = 2
    rolled = dict(case, t_nxt=torch.roll(case["t_loc"], -shift, 1),
                  a_nxt=torch.roll(case["a_loc"], -shift, 1))
    shifted = dict(case, t_nxt=case["t_loc"], a_nxt=case["a_loc"])
    assert torch.equal(_run_tape(stark, shifted, nxt_shift=shift), eager_values(stark, rolled))


def test_tapes_follow_the_stark_object_not_its_name():
    """Two machines named alike with different lookups record different
    tapes; one machine records once a process."""
    a = demo_stark()
    b = Stark(name=a.name, width=a.width, eval_fn=a.eval_fn,
              lookups=[Lookup(columns=[0, 1, 2], table_col=4, freq_col=3)], ctls=a.ctls)
    ta, tb = tape_mod.tape_of(a, 2), tape_mod.tape_of(b, 2)
    assert ta is not tb and (ta.aux_width, tb.aux_width) == (6, 8)
    assert len(ta.prog) != len(tb.prog)
    assert tape_mod.tape_of(a, 2) is ta
    assert tape_mod.tape_of(a, 1) is not ta and tape_mod.tape_of(a, 1).n_out == 1


def test_recording_folds_constants_and_frees_slots():
    """The tape holds no operation on constants alone nor a product by 1,
    and reuses the slot of a value read for the last time."""
    g = tape_mod._Graph()
    ring = tape_mod.TapeRing(g)
    x = ring.leaf(tape_mod.TLOC, 0)
    assert (ring.const(3) * ring.const(5)).i == ring.const(15).i
    assert (x * ring.one()).i == x.i and (x + ring.zero()).i == x.i
    assert (x * ring.zero()).i == ring.zero().i
    assert (x * x).i == (x * x).i  # one node for equal operations
    stark = MACHINES["g1_scalar_mul"]()
    tape = tape_mod.tape_of(stark, 2)
    assert tape.n_slots < len(tape.prog) // 20
    ops = tape.prog[:, 0]
    assert set(ops.tolist()) <= {tape_mod.ADD, tape_mod.SUB, tape_mod.MUL, tape_mod.OUT}
    assert (ops == tape_mod.OUT).sum() == 2 and tape.n_ops == len(tape.prog) - 2


def test_scalar_inputs_are_the_same_from_either_transcript():
    stark = MACHINES["g1_add"]()
    ints = random_case(stark, 1, seed=3)
    tens = random_case(stark, 1, seed=3, as_tensors=True)
    dev = torch.device("cpu")
    a = tape_mod.scalar_inputs(stark, ints["alphas"], ints["challenges"], ints["totals"], dev)
    b = tape_mod.scalar_inputs(stark, tens["alphas"], tens["challenges"], tens["totals"], dev)
    assert torch.equal(a, b) and a.shape == (tape_mod.tape_of(stark, 2).n_inputs,)
    assert int(a[0]) % (1 << 64) == ints["alphas"][0] % gl.P


def test_plain_path_rejects_wrong_shapes():
    stark = demo_stark()
    case = random_case(stark, 8, seed=1)
    tape = tape_mod.tape_of(stark, 2)
    inputs = tape_mod.scalar_inputs(stark, case["alphas"], case["challenges"], case["totals"],
                                    torch.device("cpu"))
    with pytest.raises(ValueError, match="a_loc"):
        quotient_cuda.quotient_values(tape, case["t_loc"], case["t_nxt"], case["a_loc"][:-1],
                                      case["a_nxt"], case["sel"], inputs)
    with pytest.raises(ValueError, match="inputs"):
        quotient_cuda.quotient_values(tape, case["t_loc"], case["t_nxt"], case["a_loc"],
                                      case["a_nxt"], case["sel"], inputs[:-1])
