"""The yardstick's fewest-operations count and its bound."""

import numpy as np
import pytest

from cardbench import roofline, spec


def test_blur3_counts_its_separable_form():
    blur3 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]]) / 16.0
    # Two 3-tap passes of 1 multiply and 2 FMAs (5 each), the round.
    assert roofline.ops_per_pixel_level(blur3, quantize=True) == 11
    assert roofline.ops_per_pixel_level(blur3, quantize=False) == 10


def test_edge5_counts_its_direct_form():
    from parallel_convolution_tpu_torch.ops.filters import get_filter

    edge5 = get_filter("edge5").taps
    n = int(np.count_nonzero(edge5))
    # Not separable: one dot product of n taps, then round, min and max
    # (negative taps leave [0, 255]).
    assert roofline.ops_per_pixel_level(edge5, quantize=True) == 2 * n - 1 + 3


def test_jacobi3_is_not_separable():
    jacobi3 = np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]]) / 4.0
    assert roofline.ops_per_pixel_level(jacobi3, quantize=False) == 7


@pytest.mark.parametrize("ops,nbytes", [(1e12, 1e9), (1e9, 1e12),
                                        (6.7e13, 3.35e12), (0.0, 1.0)])
def test_a_roofline_share_never_passes_one(ops, nbytes):
    least, which = roofline.least_seconds(ops, nbytes)
    assert least == max(ops / 67e12, nbytes / 3.35e12)
    assert which == ("ops" if ops / 67e12 >= nbytes / 3.35e12 else "bytes")
    read = spec.metric_reader("kernel_roofline.iterate")
    for kernel_s in (least, least * 1.5, least * 10):
        ctx = {"trace": {"kernels": {"k": kernel_s}}, "jobs": 1,
               "job_ops": ops, "job_bytes": nbytes}
        assert read(ctx) <= 100.0 + 1e-9
    ctx["trace"]["kernels"]["k"] = least
    assert read(ctx) == pytest.approx(100.0)


def test_config_4_work():
    blur3 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]]) / 16.0
    ops, nbytes = roofline.iterate_work(blur3, True, 3 * 65536 ** 2, 100,
                                        "u8")
    assert ops == 11 * 3 * 65536 ** 2 * 100
    assert nbytes == 2 * 3 * 65536 ** 2
    least, which = roofline.least_seconds(ops, nbytes)
    assert which == "ops" and 0.2 < least < 0.22
