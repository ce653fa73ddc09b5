"""On the card: a short run of each one-card cell at its own size, correct
(``python -m pytest cardbench/tests -m cuda`` on a machine with a card;
skipped without one)."""

import pytest

from cardbench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]
                                  if w["chips"] == 1])
def test_a_cell_runs_correct_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is absent here")
    from cardbench import run

    line = run.run(["--workload", name, "--seed", "424242", "--seconds",
                    "3", "--trace", "0"])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
