"""The seeded inputs remake any window, and every rank's block, alike."""

import pytest
import torch

from cardbench import inputs


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 3])
def test_any_window_is_the_whole_images_slice(seed):
    H, W = 37, 53
    whole = inputs.image(seed, 2, 3, (H, W), "cpu")
    for y0, x0, h, w in [(0, 0, 5, 7), (30, 40, 7, 13), (-4, -6, 12, 15),
                         (33, 50, 9, 9), (-3, 10, H + 6, 20)]:
        win = inputs.image_window(seed, 2, 3, (H, W), y0, x0, h, w, "cpu")
        rows = torch.arange(y0, y0 + h)
        cols = torch.arange(x0, x0 + w)
        inside = ((rows >= 0) & (rows < H))[:, None] & \
            ((cols >= 0) & (cols < W))[None, :]
        assert torch.equal(win[:, ~inside], torch.zeros_like(win[:, ~inside]))
        ys, xs = torch.nonzero(inside, as_tuple=True)
        assert torch.equal(win[:, ys, xs], whole[:, y0 + ys, x0 + xs])


def test_four_ranks_blocks_are_the_image(monkeypatch):
    monkeypatch.setattr(inputs, "BAND_ROWS", 5)
    H, W = 40, 60
    whole = inputs.image(11, 0, 3, (H, W), "cpu")
    for i in range(2):
        for j in range(2):
            block = inputs.image_window(11, 0, 3, (H, W), i * 20, j * 30,
                                        20, 30, "cpu")
            assert torch.equal(block, whole[:, i * 20:(i + 1) * 20,
                                            j * 30:(j + 1) * 30])


def test_seeds_and_images_differ_and_values_spread():
    a = inputs.image(1, 0, 3, (64, 64), "cpu")
    assert not torch.equal(a, inputs.image(2, 0, 3, (64, 64), "cpu"))
    assert not torch.equal(a, inputs.image(1, 1, 3, (64, 64), "cpu"))
    assert not torch.equal(a[0], a[1])
    assert int(a.min()) < 8 and int(a.max()) > 247
    assert 120 < float(a.float().mean()) < 135


def test_fields_are_remade_alike():
    a = inputs.normal_field(2 ** 35 + 1, 1, 1, (30, 40), "cpu")
    assert torch.equal(a, inputs.normal_field(2 ** 35 + 1, 1, 1, (30, 40),
                                              "cpu"))
    assert not torch.equal(a, inputs.normal_field(2 ** 35 + 1, 0, 1,
                                                  (30, 40), "cpu"))
    assert abs(float(a.std()) - 1.0) < 0.2
