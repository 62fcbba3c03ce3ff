"""`correct` in the G2 cell: true for a sound run, false for the control and
for an answer altered in the trace or in the statement.

The control and the faults are those of test_proofbench_faults.py, run in
`g2.batch128`.  They skip without a card: a G2 proof has 2^16 rows.

    python -m pytest proofbench/tests/test_proofbench_g2_faults.py -m cuda -q -s
"""

import pytest

from test_proofbench_faults import (SEEDS, _run, answer_altered_in_statement,  # noqa: F401
                                    answer_altered_in_trace, card, weaker_config)

CELL = "g2.batch128"


@pytest.mark.cuda
def test_sound_g2_run_is_correct(card):
    result = _run(card, CELL, SEEDS[0], 1)
    assert result["correct"]
    assert result["checks"] == {"proofs_rejected": {"value": 0, "limit": 0},
                                "outputs_wrong": {"value": 0, "limit": 0}}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_g2_control_is_not_correct(card, seed):
    result = _run(card, CELL, seed, 1, weaker_config)
    assert not result["correct"]
    assert result["checks"]["proofs_rejected"]["value"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [answer_altered_in_trace, answer_altered_in_statement])
def test_g2_fault_is_not_correct(card, fault):
    result = _run(card, CELL, SEEDS[1], 1, fault)
    assert not result["correct"]
