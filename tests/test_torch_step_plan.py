"""K1's launch geometry (``ops/stencil.py:step_plan``), on the CPU.

K1 (``csrc/step.cu``) walks a persistent grid over its output tiles and
copies each window row into shared memory as the 16-byte-aligned superset
of its span, at the row's own byte shift; its outputs leave through a
shared-memory tile congruent with the output rows.  The kernel takes that
geometry from the host, and these tests hold the host's plan (the tile
walk, and the copies and stores the kernel makes from it, re-derived here
as ``_row_copies`` and ``_row_stores``) to what the kernel relies on: every output stored exactly once, every copy
the aligned superset of its row and inside the tensor or copied byte by
byte, every shared-memory row congruent with its source mod 16 and inside
its stage.  The kernel itself is held against its plain version on the
card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from parallel_convolution_tpu_torch.ops import _build, stencil
from parallel_convolution_tpu_torch.ops.filters import get_filter, make_filter

# (output rows, output cols): a tiny block, an odd one, the main path's.
SHAPES = [(3, 5), (67, 301), (1920, 2520)]
SIZES = {"f32": 4, "bf16": 2, "u8": 1}
TILES = [None, (16, 64), (13, 40), (37, 33), (1, 1)]
BASE = 0x7F3A_0000_0000   # a 16-byte-aligned device address


def _plan(k, hw, size, tile=None, out_size=None, channels=3, **kw):
    shape = (channels, hw[0] + k - 1, hw[1] + k - 1)
    return stencil.step_plan(k, shape, size, out_size or size, tile, **kw)


@pytest.mark.parametrize("grid", [1, 7, 528])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("hw", SHAPES[:2])
@pytest.mark.parametrize("k", [3, 5, 9])
def test_step_tiles_cover_every_output_once(k, hw, tile, grid):
    plan = _plan(k, hw, 4, tile)
    g = stencil.step_grid(plan, grid, 1)
    count = np.zeros((3, *hw), np.int32)
    per_block = np.zeros(g, np.int64)
    for b, c, y0, x0, oh, ow in stencil.step_tiles(plan, g):
        assert 0 <= b < g and oh >= 1 and ow >= 1
        assert oh <= plan.tile[0] <= plan.extent[0]
        assert ow <= plan.tile[1] <= plan.extent[1]
        count[c, y0:y0 + oh, x0:x0 + ow] += 1
        per_block[b] += 1
    assert (count == 1).all()
    # Round robin: no block holds more than one tile above another.
    assert per_block.max() - per_block.min() <= 1 and per_block.min() >= 1


@pytest.mark.parametrize("storage", list(SIZES))
def test_step_tiles_cover_the_main_path_once(storage):
    plan = _plan(3, SHAPES[2], SIZES[storage])
    assert plan.tile == stencil.STEP_TILE and plan.stages == 2
    g = stencil.step_grid(plan, 4, 132)
    assert g == 528
    count = np.zeros((3, *SHAPES[2]), np.int8)
    for _, c, y0, x0, oh, ow in stencil.step_tiles(plan, g):
        count[c, y0:y0 + oh, x0:x0 + ow] += 1
    assert (count == 1).all()


def _row_copies(plan, in_addr, c, y0, x0):
    """The copies one tile's window issues (``csrc/step.cu:issue_tile``),
    one row per window row inside the input: ``[a, lo, hi, dst]`` with
    ``a`` the address of the row's first byte, [lo, hi) the 16-byte-aligned
    superset of its span, and ``dst`` where lo lands, as a byte offset into
    the stage.  Chunks of [lo, hi) outside the tensor's bytes
    [in_addr, in_addr + C·Hp·Wp·size) are copied byte by byte, the bytes
    inside only."""
    C, Hp, Wp = plan.shape
    k, es = plan.k, plan.in_size
    th, tw = plan.tile
    nrows = min(th + k - 1, Hp - y0)
    span = min(tw + k - 1, Wp - x0) * es
    a0 = in_addr + ((c * Hp + y0) * Wp + x0) * es
    a = a0 + np.arange(nrows, dtype=np.int64) * (Wp * es)
    lo = a & ~15
    hi = (a + span + 15) & ~15
    dst = (a0 & 15) + np.arange(nrows, dtype=np.int64) * plan.pitch - (a & 15)
    return np.stack([a, lo, hi, dst], axis=1)


def _row_stores(plan, out_addr, c, y0, x0):
    """The stores one tile makes (``csrc/step.cu:store_tile``), one row per
    output row it stores: ``[b, lo, hi, src]`` with [b, b + ow·size) the
    row's bytes in the output, [lo, hi) their 16-byte-aligned superset,
    and ``src`` the byte offset of lo's image in the output tile.  Chunks
    wholly inside [b, b + ow·size) go out as 16-byte stores, the rest
    element by element."""
    H, W = plan.out_hw
    es = plan.out_size
    oh, ow = min(plan.tile[0], H - y0), min(plan.tile[1], W - x0)
    o0 = out_addr + ((c * H + y0) * W + x0) * es
    b = o0 + np.arange(oh, dtype=np.int64) * (W * es)
    lo = b & ~15
    hi = (b + ow * es + 15) & ~15
    src = (o0 & 15) + np.arange(oh, dtype=np.int64) * plan.out_pitch - (b & 15)
    return np.stack([b, lo, hi, src], axis=1)


def _check_copies(plan, in_addr):
    """Every window row's copy against what the kernel relies on; returns
    how many chunks fell outside the tensor (copied byte by byte)."""
    C, Hp, Wp = plan.shape
    k, es = plan.k, plan.in_size
    (th, tw), (rows, cols) = plan.tile, plan.extent
    in_lo, in_hi = in_addr, in_addr + C * Hp * Wp * es
    outside = 0
    for _, c, y0, x0, oh, ow in stencil.step_tiles(plan, 1):
        r = _row_copies(plan, in_addr, c, y0, x0)
        a, lo, hi, dst = r.T
        span = min(tw + k - 1, Wp - x0) * es
        assert len(r) == min(th + k - 1, Hp - y0) >= oh + k - 1
        # The 16-byte-aligned superset of [a, a + span), no wider.
        assert (lo % 16 == 0).all() and (hi % 16 == 0).all()
        assert (lo <= a).all() and (a - lo < 16).all()
        assert (hi >= a + span).all() and (hi - (a + span) < 16).all()
        # Every byte of the span lies inside the tensor.
        assert (a >= in_lo).all() and (a + span <= in_hi).all()
        outside += int((lo < in_lo).sum() + (hi > in_hi).sum())
        # Lands 16-byte aligned, congruent with its source, at the
        # window's uniform pitch, inside the stage, rows apart.
        assert (dst % 16 == 0).all() and (dst >= 0).all()
        base = (a[0] & 15)
        wy = np.arange(len(r))
        assert (dst + (a - lo) == base + wy * plan.pitch).all()
        assert ((dst + (a - lo)) % 16 == a % 16).all()
        assert (dst[:-1] + (hi - lo)[:-1] <= dst[1:]).all()
        assert dst[-1] + (hi - lo)[-1] <= plan.stage_bytes
        # What the strips read: rows + k - 1 rows of cols + k - 1 columns.
        assert base + (rows + k - 2) * plan.pitch + (cols + k - 1) * es \
            <= plan.stage_bytes
        # Stored outputs read only copied bytes.
        assert (ow + k - 1) * es <= span and oh + k - 1 <= len(r)
    return outside


@pytest.mark.parametrize("k", [1, 3, 5, 9])
@pytest.mark.parametrize("storage", list(SIZES))
@pytest.mark.parametrize("hw", SHAPES[:2])
def test_step_copies_are_aligned_supersets(hw, storage, k):
    es = SIZES[storage]
    for tile in TILES[:3]:
        plan = _plan(k, hw, es, tile)
        for off in range(0, 16, es):   # every residue of data_ptr()
            outside = _check_copies(plan, BASE + off)
            if off:  # the first row's floor falls before the tensor
                assert outside >= 1


@pytest.mark.parametrize("storage", list(SIZES))
def test_step_copies_at_the_main_path_shape(storage):
    es = SIZES[storage]
    plan = _plan(3, SHAPES[2], es)
    # Odd pitches: 10 088 B (f32), 5 044 B (bf16), 2 522 B (u8) a row.
    assert plan.shape[2] * es % 16 != 0
    assert (plan.pitch - plan.shape[2] * es) % 16 == 0
    _check_copies(plan, BASE + 16 - es)


@pytest.mark.parametrize("out", list(SIZES))
@pytest.mark.parametrize("hw", SHAPES)
def test_step_stores_leave_from_congruent_rows(hw, out):
    es = SIZES[out]
    plan = _plan(3, hw, 4, out_size=es)
    H, W = hw
    for off in (0, es):
        stored = np.zeros((3, H, W), np.int8) if hw != SHAPES[2] else None
        for _, c, y0, x0, oh, ow in stencil.step_tiles(plan, 1):
            r = _row_stores(plan, BASE + off, c, y0, x0)
            b, lo, hi, src = r.T
            assert len(r) == oh
            assert (lo % 16 == 0).all() and (hi % 16 == 0).all()
            assert (lo <= b).all() and (hi >= b + ow * es).all()
            assert (src % 16 == 0).all() and (src >= 0).all()
            assert (src + (b - lo) == (b[0] & 15)
                    + np.arange(oh) * plan.out_pitch).all()
            assert src[-1] + (hi - lo)[-1] <= plan.out_bytes
            # The tile's computed row fits its pitch, rows never overlap.
            assert plan.extent[1] * es + 30 <= plan.out_pitch
            if stored is not None:
                rows = (b - (BASE + off)) // (W * es)
                for row in rows:
                    cc, yy = divmod(int(row), H)
                    stored[cc, yy, x0:x0 + ow] += 1
        if stored is not None:
            assert (stored == 1).all()


def test_step_plan_fits_shared_memory():
    # The default tile keeps two stages and two blocks per SM in f32
    # (2 x (109 072 B + 1 KB) within the SM's 228 KB), one stage at k = 5,
    # where two would leave room for one block.
    plan = _plan(3, SHAPES[2], 4)
    assert plan.smem == 109072 and plan.stages == 2
    assert 2 * (plan.smem + 1024) <= stencil.H100_SMEM_PER_SM
    edge = _plan(5, (8192, 8192), 4, channels=1)
    assert edge.stages == 1
    assert 2 * (edge.smem + edge.stage_bytes + 1024) > stencil.H100_SMEM_PER_SM
    # A tile too large for two stages runs with one; larger still, raises.
    big = _plan(3, (2048, 2048), 4, (96, 192))
    assert big.stages == 1 and big.smem <= stencil.H100_SMEM_OPTIN
    with pytest.raises(ValueError, match="smaller tile"):
        _plan(3, (2048, 2048), 4, (256, 256))
    # step_smem_bytes bounds every shape's plan (the tuner's legality).
    for hw in SHAPES[:2] + [(1919, 2521), (2047, 2049)]:
        for es in SIZES.values():
            for tile in TILES + [(64, 128), (128, 128)]:
                for k in (3, 5, 9):
                    p = _plan(k, hw, es, tile)
                    assert p.smem <= stencil.step_smem_bytes(
                        k, p.tile, es, es, p.stages)
                    assert p.extent[0] % stencil.strip_height(k) == 0
                    assert p.extent[1] % 32 == 0


def test_epilogue_code_picks_k1_store_back():
    """K1's ``epi`` argument is epilogue_code's, as K2-K4's: the magic
    round (1, convex; 2 with the clip), rintf above the L1 bound (4), none
    in float mode (0)."""
    big = make_filter("big3", [[0, -1, 0], [-1, 8304, -1], [0, -1, 0]])
    for filt, quantize, want in ((get_filter("blur3"), True, 1),
                                 (get_filter("sharpen3"), True, 2),
                                 (big, True, 4),
                                 (get_filter("edge5"), False, 0)):
        plan = stencil.step_plan(filt.size, (1, 7 + filt.size, 9 + filt.size),
                                 4, 4)
        args = stencil._step_args(filt, quantize, False, plan, torch.float32,
                                  torch.float32)
        assert args["epi"] == stencil.epilogue_code(filt, quantize) == want


def test_k1_parts_cover_every_input_dtype_and_order():
    parts = [extra for src, extra in _build.LIBRARIES["stencil"]
             if src == "step"]
    assert sorted(parts) == sorted(
        (f"-DPC_STEP_IN={code}", f"-DPC_STEP_SEP={sep}")
        for code in stencil.DTYPE_CODES.values() for sep in (0, 1))


def test_copy_only_build_is_a_library_of_its_own():
    """K1 without its compute (the copies alone, a measurement) builds as
    ``stencil_copy`` from libstencil's parts plus one define, into a file
    of its own; it is not among the libraries the port builds and loads
    (``SOURCES``), so no wrapper can launch it."""
    parts, api = _build.MEASUREMENT_LIBRARIES["stencil_copy"]
    assert api == "stencil" and "stencil_copy" not in _build.SOURCES
    assert [(src, tuple(e for e in extra if e != "-DPC_STEP_COPY_ONLY"))
            for src, extra in parts] == list(_build.LIBRARIES["stencil"])
    assert all("-DPC_STEP_COPY_ONLY" in extra
               for src, extra in parts if src == "step")
    (lib, digest), (copy_lib, copy_digest) = (
        _build._paths(n) for n in ("stencil", "stencil_copy"))
    assert lib.name == "libstencil.so" and copy_lib.name == "libstencil_copy.so"
    assert digest != copy_digest
