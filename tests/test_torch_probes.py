"""The probes of the port (``parallel_convolution_tpu_torch/probes``, TPU
kernel 5) on the CPU: their plain versions at a small size.

* 5a ``op_chain``: the integer, add, rint, magic-round and clamp chains
  exact against numpy; the FMA chains exact against an emulation that
  rounds the exact rational y·a + b once (``fractions``); the magic round
  equal to rint half-to-even for |x| < 2**22, ties included.
* 5b ``smem_probe``: the error classes and the steps, against the TPU
  probe's intent.
* 5c ``rdma_ladder``: the rung list against the TPU ladder's
  (``scripts/tiled_repro_probe.py``), r2's plain version the halo exchange
  and r3's ``fused_rdma_step_plain``.

The kernels themselves run on the card (tests/test_torch_kernels_cuda.py).
"""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from parallel_convolution_tpu_torch import convert, probes
from parallel_convolution_tpu_torch.ops import oracle, rdma, stencil
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import halo, mesh
from parallel_convolution_tpu_torch.probes import (
    op_price, rdma_ladder, smem_budget,
)
from parallel_convolution_tpu_torch.utils import imageio

REPO = Path(__file__).resolve().parent.parent
ROWS, COLS = 6, 16


def _numpy_chain(x: np.ndarray, op: str, dtype: str, c: int) -> np.ndarray:
    """Chain c of op_chain in numpy's own arithmetic."""
    if dtype in ("i32", "i16"):
        ut = np.uint32 if dtype == "i32" else np.uint16
        st = np.int32 if dtype == "i32" else np.int16
        y = x.astype(np.int64).astype(ut)
        a, b = ut(op_price.A_I[c] % (1 << (8 * ut().itemsize))), \
            ut(op_price.B_I[c] % (1 << (8 * ut().itemsize)))
        with np.errstate(over="ignore"):
            for _ in range(op_price.STEPS):
                y = (y * a + b) if op == "muladd" else (y + b)
                y = y.astype(ut)
        return y.view(st)
    y = x.astype(np.float32)
    b, m = np.float32(op_price.B_F[c]), np.float32(op_price.MAGIC)
    for _ in range(op_price.STEPS):
        if op == "rint+add":
            y = np.rint(y)
        elif op == "magicround+add":
            y = (y + m) - m
        elif op == "clamp+add":
            y = np.minimum(np.maximum(y, np.float32(0)), np.float32(255))
        y = (y + b).astype(np.float32)
    return y


@pytest.mark.parametrize("op,dtype", [(op, dt) for op, dt, _ in
                                      op_price.CANDIDATES if op != "fma"])
def test_chains_exact_against_numpy(op, dtype):
    x = op_price.make_input(dtype, ROWS, COLS, seed=1)
    got = op_price.op_chain(x, op, dtype)  # CPU: the plain version
    assert got.shape == (op_price.CHAINS, ROWS, COLS) and got.dtype == x.dtype
    for c in range(op_price.CHAINS):
        np.testing.assert_array_equal(got[c].numpy(),
                                      _numpy_chain(x.numpy(), op, dtype, c))


def _round_f32(q: Fraction) -> float:
    v = float(q)
    assert Fraction(v) == q  # y*a + b is exact in float64 for these inputs
    return float(np.float32(v))


def _round_bf16(q: Fraction) -> float:
    v = np.float32(_round_f32(q))
    assert Fraction(float(v)) == q  # ... and in float32 for bf16 inputs
    bits = int(v.view(np.uint32))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000  # RNE to bf16
    return float(np.uint32(bits).view(np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fma_chain_exact_against_single_rounding(dtype):
    """Each step rounds the exact y*a + b once, as __fmaf_rn and __hfma2
    do: emulated here in rationals."""
    x = op_price.make_input(dtype, 2, 8, seed=2)
    got = op_price.op_chain(x, "fma", dtype)
    rnd = _round_bf16 if dtype == "bf16" else _round_f32
    for c in range(op_price.CHAINS):
        a, b = Fraction(op_price.A_F[c]), Fraction(op_price.B_F[c])
        for i, v in enumerate(x.flatten().tolist()):
            y = Fraction(v)
            for _ in range(op_price.STEPS):
                y = Fraction(rnd(y * a + b))
            assert got[c].flatten()[i].item() == float(y)


def test_magic_round_is_rint_half_to_even():
    rng = np.random.default_rng(3)
    lim = 2.0 ** 22
    ties = np.arange(-2000, 2000, dtype=np.float32) + np.float32(0.5)
    edges = np.array([lim - 0.5, -(lim - 0.5), lim - 1.5, 0.5, -0.5, 1.5,
                      2.5, -2.5], dtype=np.float32)
    rand = rng.uniform(-lim, lim, 100_000).astype(np.float32)
    m = np.float32(op_price.MAGIC)
    for x in (ties, edges, rand):
        np.testing.assert_array_equal((x + m) - m, np.rint(x))
        t = torch.from_numpy(x)
        assert torch.equal((t + op_price.MAGIC) - op_price.MAGIC,
                           torch.round(t))


def test_op_chain_rejects_bad_requests():
    x = op_price.make_input("f32", 2, 4)
    with pytest.raises(ValueError, match="no op_chain candidate"):
        op_price.op_chain(x, "fma", "i8")
    with pytest.raises(ValueError, match="takes torch.bfloat16"):
        op_price.op_chain(x, "fma", "bf16")
    assert [c[:2] for c in op_price.CANDIDATES][:2] == [("fma", "f32"),
                                                       ("fma", "bf16")]
    assert len(op_price.CANDIDATES) == 10  # the TPU probe's ten


def test_smem_error_classes_follow_the_tpu_probe():
    ec = smem_budget.error_class
    assert ec(0, 0, True, True) == "ok"
    assert ec(0, 0, False, True) == "wrong"
    assert ec(1, 1, False, True) == "clean_refusal"   # attribute refused
    assert ec(0, 1, False, True) == "clean_refusal"   # launch refused
    assert ec(0, 0, False, False) == "sticky"         # context lost
    assert ec(1, 1, False, False) == "sticky"
    # The TPU probe's two failure forms are the card's two.
    assert smem_budget.TPU_CLASS == {"clean_resource_error": "clean_refusal",
                                     "helper_http500": "sticky"}
    tpu = (REPO / "scripts" / "helper_crash_probe.py").read_text()
    for tpu_class in smem_budget.TPU_CLASS:
        assert f'"{tpu_class}"' in tpu


def test_smem_steps_straddle_both_limits():
    optin = 232448
    steps = smem_budget.steps(optin)
    assert steps == [(49152, False), (49153, False), (102400, True),
                     (optin, True), (optin + 1, True), (262144, True)]
    assert [smem_budget.fits(b, o, optin) for b, o in steps] == [
        True, False, True, True, False, False]
    x = torch.arange(12, dtype=torch.float32)
    out, attr, err = smem_budget.smem_probe(x, 10 ** 6, True)  # CPU: plain
    assert (attr, err) == (0, 0) and torch.equal(out, x + 1)


def test_ladder_rungs_follow_the_tpu_ladder():
    """One construct per rung, in the TPU ladder's order: every TPU rung
    maps onto exactly one card rung, and the last is the whole kernel."""
    tpu = re.findall(r'run\("(\w+)"',
                     (REPO / "scripts" / "tiled_repro_probe.py").read_text())
    assert tpu == ["a0_any_operands_only", "a_unused_hbm_scratch",
                   "b_hbm_roundtrip", "c_hbm_internal_copy",
                   "d_windowed_from_hbm", "e_when_step0",
                   "f_collective_params"]
    assert tuple(rdma_ladder.TPU_RUNGS) == rdma_ladder.RUNGS
    assert [r for rungs in rdma_ladder.TPU_RUNGS.values()
            for r in rungs] == tpu
    assert rdma_ladder.RUNGS[-1] == "r3_levels"
    with pytest.raises(ValueError, match="rung must be one of"):
        rdma_ladder._rung_index(4)


def _stacked(grid_shape, storage="u8", seed=5):
    img = imageio.generate_test_image(29, 43, "grey", seed=seed)
    g = mesh.make_grid(grid_shape, "cpu")
    blocks = convert.blocks_from_numpy(img[None].astype(np.float32), g,
                                       storage)
    return img, blocks, rdma.stack_blocks(blocks, grid_shape)


@pytest.mark.parametrize("grid_shape,boundary", [((2, 2), "zero"),
                                                 ((1, 3), "periodic"),
                                                 ((3, 1), "zero")])
def test_ladder_plain_versions(grid_shape, boundary):
    f = get_filter("blur3")
    img, blocks, x = _stacked(grid_shape)
    T = 3
    for rung in ("r0_tile_copy", "r1_pointer_table"):
        assert torch.equal(rdma_ladder.rdma_ladder(x, f, grid_shape,
                                                   boundary, T, rung), x)
    r2 = rdma_ladder.rdma_ladder(x, f, grid_shape, boundary, T,
                                 "r2_ghost_gather")
    want = halo.halo_exchange(blocks, f.radius * T, grid_shape, boundary)
    assert torch.equal(r2, rdma.stack_blocks(want, grid_shape))
    valid = None if boundary == "periodic" else img.shape
    r3 = rdma_ladder.rdma_ladder(x, f, grid_shape, boundary, T, "r3_levels",
                                 valid)
    assert torch.equal(r3, rdma.stack_blocks(rdma.fused_rdma_step_plain(
        blocks, f, grid_shape, boundary, fuse=T, valid_hw=valid),
        grid_shape))
    if boundary == "zero":
        out = mesh.join_blocks(rdma.unstack_blocks(r3, grid_shape))
        np.testing.assert_array_equal(
            out[0, :img.shape[0], :img.shape[1]].numpy(),
            oracle.run_serial_u8(img, f, T))


def test_cpu_probe_wrappers_count_no_launches():
    probes.reset_launch_counts()
    f = get_filter("blur3")
    _, _, x = _stacked((2, 2))
    op_price.op_chain(op_price.make_input("f32", 2, 4), "add", "f32")
    smem_budget.smem_probe(torch.zeros(4), 0, False)
    rdma_ladder.rdma_ladder(x, f, (2, 2), "zero", 1, 0)
    assert probes.launch_counts() == {"op_chain": 0, "smem_probe": 0,
                                      "rdma_ladder": 0}
    assert stencil.launch_counts() == {k: 0 for k in stencil.launch_counts()}
