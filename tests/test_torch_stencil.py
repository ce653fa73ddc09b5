"""The port's two kernels (ops/stencil.py) against the JAX package's Pallas
kernels, on the same seeded inputs.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels run
in Pallas interpret mode, as tests/test_pallas.py and
tests/test_temporal_fusion.py run them.  u8 (quantize) mode must agree
byte for byte.  Float mode agrees within ``stencil.float_tolerance``: the
JAX CPU tier contracts each tap into one FMA, PyTorch's eager CPU ops round
the product and the sum separately.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.ops import pallas_stencil
from parallel_convolution_tpu_torch import convert
from parallel_convolution_tpu_torch.ops import rdma, stencil

FILTERS = ["blur3", "gaussian5", "edge5", "sharpen3"]
# (storage, quantize): u8 carries exist only in quantize mode.
MODES = [("f32", True), ("bf16", True), ("u8", True), ("f32", False),
         ("bf16", False)]
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "u8": jnp.uint8}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}


def _filters(name):
    jf = jfilters.get_filter(name)
    return jf, convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)


def _inputs(seed, shape, storage):
    """Seeded u8-range data as (jax array, torch tensor) in ``storage``."""
    x = np.random.default_rng(seed).integers(0, 256, size=shape)
    x = x.astype(np.float32)
    return jnp.asarray(x, JNP[storage]), torch.from_numpy(x).to(TORCH[storage])


def _to_f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_agree(got, want, filt, levels, storage, quantize):
    got, want = _to_f32(got), _to_f32(want)
    assert got.shape == want.shape
    if quantize:
        np.testing.assert_array_equal(got, want)
    else:
        rtol, atol = stencil.float_tolerance(filt, levels, TORCH[storage])
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("storage,quantize", MODES)
@pytest.mark.parametrize("name", FILTERS)
def test_step_plain_matches_pallas(name, storage, quantize, separable):
    jf, tf = _filters(name)
    r = jf.radius
    jx, tx = _inputs(FILTERS.index(name), (3, 29 + 2 * r, 131 + 2 * r),
                     storage)
    want = pallas_stencil.correlate_padded_pallas(
        jx, jf, quantize=quantize, out_dtype=JNP[storage],
        separable=separable)
    got = stencil.stencil_step(tx, tf, quantize=quantize,
                               out_dtype=TORCH[storage], separable=separable)
    assert got.dtype == TORCH[storage]
    _assert_agree(got, want, tf, 1, storage, quantize)


# A block at global offset (4, 100) of a 26 x 130 image: its deep halo
# crosses the top, bottom and right image edges.
OFFSETS, VALID_HW, BLOCK_HW = (4, 100), (26, 130), (20, 36)


@pytest.mark.parametrize("storage,quantize", MODES)
@pytest.mark.parametrize("name", FILTERS)
def test_fused_plain_matches_pallas(name, storage, quantize):
    jf, tf = _filters(name)
    T = 3
    d = jf.radius * T
    shape = (2, BLOCK_HW[0] + 2 * d, BLOCK_HW[1] + 2 * d)
    jx, tx = _inputs(10 + FILTERS.index(name), shape, storage)
    want = pallas_stencil.fused_iterate_pallas(
        jx, jnp.asarray(OFFSETS, jnp.int32), jf, T, VALID_HW,
        quantize=quantize, out_dtype=JNP[storage], separable=True)
    got = stencil.fused_iterate(tx, OFFSETS, tf, T, VALID_HW,
                                quantize=quantize,
                                out_dtype=TORCH[storage], separable=True)
    _assert_agree(got, want, tf, T, storage, quantize)


@pytest.mark.parametrize("name,T,storage", [("blur3", 4, "u8"),
                                            ("gaussian5", 2, "bf16"),
                                            ("edge5", 2, "f32")])
@pytest.mark.parametrize("separable", [False, True])
def test_fused_plain_matches_pallas_periodic(name, T, storage, separable):
    # valid_hw=None: no masks (the periodic torus) at offset (0, 0).
    jf, tf = _filters(name)
    d = jf.radius * T
    jx, tx = _inputs(20 + T, (1, 24 + 2 * d, 40 + 2 * d), storage)
    want = pallas_stencil.fused_iterate_pallas(
        jx, jnp.zeros((2,), jnp.int32), jf, T, None, quantize=True,
        out_dtype=JNP[storage], separable=separable)
    got = stencil.fused_iterate(tx, (0, 0), tf, T, None, quantize=True,
                                out_dtype=TORCH[storage], separable=separable)
    _assert_agree(got, want, tf, T, storage, True)


def test_fused_equals_chained_steps_with_masks():
    # The fused plain version is T masked single steps: hold it against
    # K1's plain version chained level by level with explicit masks.
    _, tf = _filters("gaussian5")
    T, r = 3, 2
    _, tx = _inputs(31, (2, BLOCK_HW[0] + 2 * r * T, BLOCK_HW[1] + 2 * r * T),
                    "f32")
    H, W = VALID_HW
    rows = OFFSETS[0] - r * T + torch.arange(tx.shape[1])
    cols = OFFSETS[1] - r * T + torch.arange(tx.shape[2])
    ok = ((rows >= 0) & (rows < H))[:, None] & ((cols >= 0) & (cols < W))
    cur = tx * ok
    for s in range(1, T + 1):
        cur = stencil.stencil_step(cur, tf, quantize=True,
                                   out_dtype=torch.float32)
        cur = cur * ok[r * s:ok.shape[0] - r * s, r * s:ok.shape[1] - r * s]
    got = stencil.fused_iterate(tx, OFFSETS, tf, T, VALID_HW)
    np.testing.assert_array_equal(got.numpy(), cur.numpy())


def test_fused_plan_groups_levels_to_fit_shared_memory():
    # r=1, T=32 fits one launch at the default 64x64 tile (2 x 128^2 f32);
    # r=2, T=32 does not (2 x 192^2 f32 > 227 KB) and splits evenly.
    th, tw, groups = stencil.fused_plan(1, 32, (1920, 2520))
    assert (th, tw, groups) == (64, 64, [32])
    th, tw, groups = stencil.fused_plan(2, 32, (8192, 8192))
    assert sum(groups) == 32 and len(groups) == 2 and max(groups) == 16
    assert all(stencil.fused_smem_bytes(2, g, (th, tw))
               <= stencil.H100_SMEM_OPTIN for g in groups)
    # A block smaller than the tile clamps the tile.
    assert stencil.fused_plan(1, 4, (20, 36))[:2] == (20, 36)
    with pytest.raises(ValueError, match="shared memory"):
        stencil.fused_plan(1, 1, (4096, 4096), tile=(512, 512))
    assert stencil.rim_tax(1, 32, (64, 64)) == 4.0


def test_wrappers_check_arguments():
    _, tf = _filters("blur3")
    x = torch.zeros((1, 10, 10))
    with pytest.raises(ValueError, match="needs quantize"):
        stencil.stencil_step(x, tf, out_dtype=torch.uint8)
    with pytest.raises(ValueError, match="dtype"):
        stencil.stencil_step(x.to(torch.float64), tf)
    with pytest.raises(ValueError, match=r"\(C, H, W\)"):
        stencil.stencil_step(x[0], tf)
    with pytest.raises(ValueError, match="T must be"):
        stencil.fused_iterate(x, (0, 0), tf, 0, None)


def test_cpu_wrappers_count_no_launches():
    _, tf = _filters("blur3")
    stencil.reset_launch_counts()
    x = torch.zeros((1, 12, 12))
    stencil.stencil_step(x, tf)
    stencil.fused_iterate(x, (0, 0), tf, 2, (8, 8))
    rdma.fused_rdma_step([[x, x]], tf, (1, 2), fuse=2, valid_hw=(12, 24))
    assert stencil.launch_counts() == {"stencil_step": 0, "fused_iterate": 0,
                                       "rdma_block": 0, "rdma_tiled": 0}
