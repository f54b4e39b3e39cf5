"""The readers of the program's host-step stages: each gives its stage's
seconds over the window divided by the searches, and None where the stage
never ran."""

import pytest

from benchmark import harness

READERS = {"detect_bits_s": "detect_bits", "stack_s": "stack",
           "decode_s": "decode", "filter_s": "filter", "render_s": "render"}


def _run(stages, n_searches=4):
    run = harness.Run(setup_s=1.0)
    run.stages = stages
    run.searches = [{"wall_s": 1.0, "work": 1, "stages": {}}] * n_searches
    return run


@pytest.mark.parametrize("metric,stage", sorted(READERS.items()))
def test_reader_gives_its_stage_a_search(metric, stage):
    stages = {name: {"seconds": 0.25 * (i + 1), "calls": 4, "items": 100}
              for i, name in enumerate(READERS.values())}
    stages["decode+group"] = {"seconds": 9.0, "calls": 4, "items": 100}
    want = stages[stage]["seconds"] / 4
    assert harness.load_reader(metric)(_run(stages)) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_of_a_stage_that_never_ran_is_none(metric):
    stages = {"read_fasta": {"seconds": 1.0, "calls": 4, "items": 0}}
    assert harness.load_reader(metric)(_run(stages)) is None
