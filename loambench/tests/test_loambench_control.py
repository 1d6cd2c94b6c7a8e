"""The control of `correct`, on the card: for each cell, a run with a short
window whose check also puts the reference in TF32 in the port's place.
The port's readings pass the cell's limits and the control's fail them.
`python3 -m loambench.control` makes the same readings over many seeds;
this keeps one of each cell as a test (skipped without a card)."""

import time

import pytest

from loambench import check, harness, run

SEEDS = {"vlp16.replay.lap": 2 ** 32 + 101, "hdl64e.replay.lap": 2 ** 32 + 102}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SEEDS))
def test_the_tf32_control_is_not_correct(card, cell):
    harness.set_cache_dirs()
    bench = harness.load_bench()
    r = run.prepare(bench, cell, SEEDS[cell], 12.0, False, card, t_start=time.perf_counter())
    r.control = True
    rec = harness.driver(r.mix["driver"]).run(r)
    limits = harness.limits(cell)
    assert check.passed(check.judged(rec["readings"], limits)), rec["readings"]
    assert not check.passed(check.judged(rec["control"], limits)), rec["control"]
