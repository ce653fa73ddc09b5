"""Every cell runs whole at its small size on the CPU (the plain backend
in the CUDA kernels' place) and comes out correct, traced and not."""

import pytest

from cardbench.tests.small import SMALL, run_small


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_small_cell_runs_correct(name, trace):
    line = run_small(name, trace=trace)
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    from cardbench import spec

    cell = spec.cell(name)
    want = ({m["name"] for m in cell.per_layer} if trace else
            {m["name"] for m in cell.end_to_end})
    got = set(line["metrics"])
    if trace:
        # On the CPU there is no device trace: what only it gives is
        # left out, never read as 0.
        assert got <= want
        assert line["device"]["window_s"] > 0
        assert "breakdown" in line
    else:
        assert got == want
        assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["count"] == cell.chips
