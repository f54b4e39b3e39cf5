"""Each cell's control (the reference with the reverse strand left out,
judged by the benchmark's comparison) comes out as not correct, on three
seeds, at a size a test run holds."""

import pytest

from benchmark import control
from benchmark.tests import tiny

CELLS = [(w["config"], w["traffic"]) for w in tiny.manifest()["workloads"]]


@pytest.mark.parametrize("config,mix", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 9, 987_654_321])
def test_control_is_not_correct(config, mix, seed):
    r = control.control_reading(tiny.config(config, 60_000),
                                tiny.traffic(mix), seed, "cpu")
    assert not r["passes"]
    assert r["numbers"]["csv_lines_wrong"] > 0
