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
from parallel_convolution_tpu.ops.pallas_stencil import _round_mode_for
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
    # One f32 buffer of the level-0 window, the levels in place: r=1, T=32
    # at the default tile is one launch (128^2 f32 = 64 KB); r=2, T=32
    # (192^2 f32 = 144 KB) would fit too, but its ghost depth 64 is more
    # than half the 64-row tile, so it splits evenly at depth 32.
    th, tw = stencil.FUSED_TILE
    assert stencil.fused_smem_bytes(1, 32, (64, 64)) == 4 * 128 * 128
    th, tw, groups = stencil.fused_plan(1, 32, (1920, 2520))
    assert (th, tw) == stencil.FUSED_TILE
    assert groups == [32 // -(-32 // stencil.max_group_levels(1, (th, tw)))] \
        * -(-32 // stencil.max_group_levels(1, (th, tw)))
    th, tw, groups = stencil.fused_plan(2, 32, (8192, 8192))
    assert sum(groups) == 32 and len(groups) >= 2
    assert max(groups) <= stencil.max_group_levels(2, (th, tw))
    assert all(stencil.fused_smem_bytes(2, g, (th, tw))
               <= stencil.H100_SMEM_OPTIN for g in groups)
    # A block smaller than the tile clamps the tile.
    assert stencil.fused_plan(1, 4, (20, 36))[:2] == (20, 36)
    with pytest.raises(ValueError, match="shared memory"):
        stencil.fused_plan(1, 1, (4096, 4096), tile=(512, 512))
    assert stencil.rim_tax(1, 32, (64, 64)) == 4.0


@pytest.mark.parametrize("r", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("tile", [None, (32, 128), (64, 64), (64, 128),
                                  (128, 128), (200, 200), (8, 300)])
def test_fused_plan_groups_fit_and_are_fewest(r, tile):
    # Over a sweep of depths: every launch's window fits the card's opt-in
    # shared memory as ONE f32 buffer, its ghost depth is within the cap,
    # the groups are near-equal, and one group fewer could not satisfy
    # both rules.
    limit = stencil.H100_SMEM_OPTIN
    for T in (1, 2, 3, 7, 8, 16, 17, 32, 33):
        try:
            th, tw, groups = stencil.fused_plan(r, T, (4096, 4096), tile)
        except ValueError:
            assert stencil.fused_smem_bytes(r, 1, tile) > limit
            continue
        assert sum(groups) == T and max(groups) - min(groups) <= 1
        cap = stencil.max_group_levels(r, (th, tw))
        fits = [g for g in range(1, T + 1)
                if g <= cap and stencil.fused_smem_bytes(r, g, (th, tw))
                <= limit]
        assert max(groups) <= max(fits)
        assert len(groups) == -(-T // max(fits))
        assert stencil.fused_smem_bytes(r, max(groups), (th, tw)) == \
            4 * (th + 2 * r * max(groups)) * (tw + 2 * r * max(groups))


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
    rdma.fused_rdma_slots([[x, x]], tf, (1, 2), fuse=2, valid_hw=(12, 24),
                          col_mode="packed")
    rdma.fused_rdma_slots([[x, x]], tf, (1, 2), fuse=2, valid_hw=(12, 24),
                          col_mode="packed", overlap=True)
    assert stencil.launch_counts() == {
        "stencil_step": 0, "fused_iterate": 0, "rdma_block": 0,
        "rdma_tiled": 0, "rdma_block_slot": 0, "rdma_tiled_slot": 0,
        "rdma_block_region": 0, "rdma_tiled_region": 0, "rdma_pack": 0}


# ---------------------------------------------------------------- round mode
def _scaled_taps(name, l1):
    """A registry filter's taps scaled in float32 to an L1 norm near l1."""
    t = jfilters.get_filter(name).taps.astype(np.float32)
    return (t * np.float32(l1 / float(np.abs(t.astype(np.float64)).sum()))
            ).astype(np.float32)


_BOUND_L1 = 2.0 ** 21 / 255.0
ROUND_CASES = ([(name, jfilters.get_filter(name).taps)
                for name in sorted(jfilters.FILTERS)]
               + [(f"{name}*{f}", _scaled_taps(name, f * _BOUND_L1))
                  for name in ("blur3", "edge5", "sharpen3")
                  for f in (0.5, 0.999, 0.99999, 1.00001, 1.001, 2.0)])


@pytest.mark.parametrize("name,taps", ROUND_CASES,
                         ids=[c[0] for c in ROUND_CASES])
def test_round_mode_matches_jax(name, taps):
    # The kernels' magic round is chosen by the JAX package's own rule:
    # magic iff JAX's interpret-mode selector does not say "rint" (it says
    # "magic_barrier" there), summed over the same float32 taps.
    flat = tuple(float(t) for t in np.asarray(taps, np.float32).reshape(-1))
    want = "rint" if _round_mode_for(flat, interpret=True) == "rint" \
        else "magic"
    assert stencil.round_mode(taps) == want
    if "*" not in name:
        assert want == "magic"          # every shipped filter is far inside
    f = convert.filter_from_numpy(name, np.asarray(taps, np.float32))
    assert stencil.epilogue_code(f, False) == 0
    assert stencil.epilogue_code(f, True) == (
        (1 if want == "magic" else 3) + (0 if f.convex else 1))


def test_magic_round_equals_round_half_even():
    # The two-add round in float32, as the kernels compute it with
    # __fadd_rn, against torch.round (half to even) on every quarter of
    # [-2^21, 2^21] -- every half-integer tie, every integer, the quarters
    # between -- and on random floats there.
    magic = np.float32(12582912.0)
    q = np.arange(-2 ** 23, 2 ** 23 + 1, dtype=np.int64)
    rng = np.random.default_rng(0)
    x = np.concatenate([(q / 4).astype(np.float32),
                        rng.uniform(-2 ** 21, 2 ** 21, 2 ** 20)
                        .astype(np.float32)])
    assert np.all(np.abs(x) <= 2 ** 21)
    got = (x + magic) - magic
    assert got.dtype == np.float32
    want = torch.round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
