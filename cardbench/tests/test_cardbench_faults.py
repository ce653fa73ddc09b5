"""The comparison that decides ``correct`` fails the program broken under
the timed path, once for each fault a cell can have, and fails the
control (the reference in bfloat16 in the program's place)."""

import pytest

from cardbench import control
from cardbench.tests import faults
from cardbench.tests.small import SEED, SMALL, run_small


@pytest.mark.parametrize("fault", [faults.state_unchanged_iterate,
                                   faults.answer_altered_iterate])
def test_resident_jobs_see_a_broken_iterate(fault):
    with fault():
        line = run_small("c4_rgb65536_resident")
    assert line["correct"] is False
    assert line["checks"]["bad_bytes"]["value"] > 0


@pytest.mark.parametrize("fault", [faults.half_batch_left_out,
                                   faults.state_unchanged_iterate,
                                   faults.answer_altered_iterate])
def test_image_calls_see_a_broken_call(fault):
    with fault():
        line = run_small("c2_rgb2520_batch8")
    assert line["correct"] is False


def test_solves_see_a_smoother_that_leaves_the_state():
    with faults.smoother_unchanged():
        line = run_small("c5_field32768_vcycle")
    assert line["correct"] is False


@pytest.mark.parametrize("child", [faults.exchange_left_out_child,
                                   faults.state_unchanged_child])
def test_four_ranks_see_a_broken_rank(child):
    line = run_small("c4_rgb65536_4cards", child=child)
    assert line["correct"] is False
    assert line["checks"]["bad_bytes"]["value"] > 0


def test_four_ranks_refuse_a_rank_that_loaded_jax():
    import sys

    assert "jax" not in sys.modules
    with pytest.raises(SystemExit, match="jax"):
        run_small("c4_rgb65536_4cards", child=faults.jax_loaded_child)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails(name):
    from cardbench import spec

    config_over, traffic_over = SMALL[name]
    cell = spec.cell(name, config_over=config_over,
                     traffic_over=traffic_over)
    got = control.readings(name, SEED, "cpu", config_over, traffic_over)
    limits = cell.config["limits"]
    assert any(got[k] > limits[k] for k in limits), got


def test_a_diverged_solve_reads_finite_numbers():
    import math

    import torch

    from cardbench.kinds.solves import judge
    from cardbench.reference import Solve

    ref = Solve(torch.ones(1, 4, 4), 9, [1.0, 0.5], True)
    got = judge(torch.full((1, 4, 4), float("nan")), 3,
                [float("inf"), 0.5], ref)
    assert all(math.isfinite(v) for v in got.values())
    assert got == {"field_gap": 1.0, "residual_gap": 1.0, "cycles_gap": 6}
