"""The packed transport's gather as planned on the host: ``rdma.pack_plan``
(the vector width and launch shape of ``csrc/rdma.cu:rdma_pack_kernel``)
and a plain NumPy emulation of the kernel's mapping under that plan.

The emulation moves bytes as the kernel does (one ``vec``-byte vector a
thread and step, the grid-strided loops over (block, side, channel) and
staged rows, the source row picked from the upper, own or lower block) in
a flat byte array standing in for device memory, with every block and
staging at an address of its own.  It must write every staged byte exactly
once, touch nothing else, move only aligned vectors, and leave each
staging byte-equal to ``rdma.rdma_pack_plain`` and to the column slabs of
the JAX package's halo exchange on its CPU mesh.  The kernel itself runs
on the card (``tests/test_torch_kernels_cuda.py``).
"""

import ctypes
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parallel_convolution_tpu.parallel import halo as jhalo
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.utils.jax_compat import shard_map
from parallel_convolution_tpu_torch.ops import rdma
from parallel_convolution_tpu_torch.parallel import channels, mesh

TORCH = {"u8": torch.uint8, "bf16": torch.bfloat16, "f32": torch.float32}
BASE = 1 << 20  # the emulated memory's first address


def _blocks(seed, grid_shape, bhw, storage, channels_=2):
    R, Cg = grid_shape
    x = np.random.default_rng(seed).integers(
        0, 256, size=(channels_, R * bhw[0], Cg * bhw[1])).astype(np.float32)
    grid = mesh.make_grid(grid_shape, devices=["cpu"] * (R * Cg))
    return mesh.split_blocks(torch.from_numpy(x).to(TORCH[storage]), grid), x


def _bytes(t):
    return t.contiguous().view(torch.uint8).reshape(-1).numpy()


class Memory:
    """A flat byte array with every block and every staging of a grid at
    an address of its own: each buffer starts ``skew`` bytes past a
    multiple of ``align``."""

    def __init__(self, flat, D, align=256, skew=0):
        C, h, w = flat[0].shape
        self.elt = flat[0].element_size()
        self.stage_bytes = 2 * C * (h + 2 * D) * D * self.elt
        self.block_addr, self.stage_addr, chunks, at = [], [], [], BASE
        for b in flat:
            for addrs, data in ((self.block_addr, _bytes(b)),
                                (self.stage_addr, np.zeros(
                                    self.stage_bytes, np.uint8))):
                at = -(-at // align) * align + skew
                addrs.append(at)
                chunks.append((at, data))
                at += data.size
        self.mem = np.full(at - BASE, 0xAB, np.uint8)
        for a, data in chunks:
            self.mem[a - BASE:a - BASE + data.size] = data
        self.writes = np.zeros(self.mem.size, np.int32)

    def staging(self, b):
        a = self.stage_addr[b] - BASE
        return self.mem[a:a + self.stage_bytes]


def emulate(mem, table, b0, count, C, h, w, D, plan):
    """rdma_pack_kernel's loops over the launch ``plan``, in ``mem``."""
    V = plan.vec
    tx_n, ty_n = plan.threads
    _, gy, gz = plan.grid
    elt = mem.elt
    H2, row_bytes, pitch = h + 2 * D, D * elt, w * elt
    nv, per = row_bytes // V, 2 * C
    nz = count * per

    def move(dst, src):
        assert dst % V == 0 and (src is None or src % V == 0)
        d = dst - BASE
        mem.mem[d:d + V] = 0 if src is None else mem.mem[src - BASE:
                                                         src - BASE + V]
        mem.writes[d:d + V] += 1

    for bz in range(gz):
        for by in range(gy):
            for ty in range(ty_n):
                for tx in range(tx_n):
                    for z in range(bz, nz, gz):
                        bi, sc = divmod(z, per)
                        side, c = divmod(sc, C)
                        b = b0 + bi
                        srcs = [None if table[b][k] < 0
                                else mem.block_addr[table[b][k]]
                                for k in (1, 4, 7)]
                        col0 = 0 if side == 0 else (w - D) * elt
                        stage = (mem.stage_addr[b]
                                 + (side * C + c) * H2 * row_bytes)
                        for row in range(by * ty_n + ty, H2, gy * ty_n):
                            ly = row - D
                            di = 0 if ly < 0 else (1 if ly < h else 2)
                            sy = ly - (di - 1) * h
                            src = srcs[di]
                            dst = stage + row * row_bytes
                            s = (None if src is None
                                 else src + (c * h + sy) * pitch + col0)
                            for v in range(tx, nv, tx_n):
                                move(dst + v * V,
                                     None if s is None else s + v * V)


def _plan_for(mem, table, b0, count, C, h, w, D):
    addrs = [mem.stage_addr[b] for b in range(b0, b0 + count)]
    addrs += [mem.block_addr[n] for b in range(b0, b0 + count)
              for n in (table[b][1], b, table[b][7]) if n >= 0]
    return rdma.pack_plan(C, h, w, D, mem.elt, addrs, count)


def _check_range(blocks, grid_shape, boundary, D, b0, count, **layout):
    flat = [b for row in blocks for b in row]
    C, h, w = flat[0].shape
    table = channels.neighbour_table(grid_shape, boundary)
    mem = Memory(flat, D, **layout)
    plan = _plan_for(mem, table, b0, count, C, h, w, D)
    emulate(mem, table, b0, count, C, h, w, D, plan)
    want = rdma.rdma_pack_plain(blocks, grid_shape, boundary, D)
    written = np.zeros(mem.mem.size, bool)
    for b in range(b0, b0 + count):
        a = mem.stage_addr[b] - BASE
        written[a:a + mem.stage_bytes] = True
        np.testing.assert_array_equal(mem.staging(b), _bytes(want[b]))
    # Every staged byte of the range exactly once, nothing else at all.
    assert (mem.writes[written] == 1).all()
    assert (mem.writes[~written] == 0).all()
    return plan, mem, want


# ------------------------------------------------------------- the vector


# (C, h, w, D, elt, skew): BASELINE config 2's blocks (2x2, bf16, fuse 32),
# config 3's (4x4 of 8192², edge5, fuse 32), the 256-rank split (16x16 of
# 1920x2520 grey, u8, fuse 8), odd widths in every dtype, D = min(h, w) on
# either axis, and buffers off their alignment.
SWEEP = [
    ((3, 960, 1260, 32, 2, 0), 8),
    ((1, 2048, 2048, 64, 2, 0), 16),
    ((1, 120, 158, 8, 1, 0), 2),
    ((2, 23, 37, 4, 1, 0), 1),
    ((2, 23, 37, 4, 2, 0), 2),
    ((2, 23, 37, 4, 4, 0), 4),
    ((1, 17, 33, 5, 4, 0), 4),
    ((3, 31, 45, 3, 2, 0), 2),
    ((1, 12, 40, 12, 2, 0), 8),
    ((1, 30, 16, 16, 4, 0), 16),
    ((1, 16, 64, 16, 1, 0), 16),
    ((1, 16, 64, 4, 2, 0), 8),
    ((3, 960, 1260, 32, 2, 4), 4),
    ((1, 2048, 2048, 64, 2, 2), 2),
    ((1, 2048, 2048, 64, 1, 1), 1),
]


@pytest.mark.parametrize("shape,want", SWEEP)
def test_pack_vector_divides_every_offset(shape, want):
    C, h, w, D, elt, skew = shape
    stride = C * h * w * elt
    stage = 2 * C * (h + 2 * D) * D * elt
    addrs = [BASE + skew + k * stride for k in range(3)]
    addrs += [BASE + 8 * stride + skew + k * stage for k in range(2)]
    plan = rdma.pack_plan(C, h, w, D, elt, addrs)
    assert plan.vec == want
    offsets = [w * elt, (w - D) * elt, D * elt] + addrs
    assert all(o % plan.vec == 0 for o in offsets)
    # The widest: twice the vector divides some offset no more.
    assert plan.vec == 16 or any(o % (2 * plan.vec) for o in offsets)
    nv = D * elt // plan.vec
    tx, ty = plan.threads
    assert tx * ty == rdma.PACK_THREADS and tx >= min(nv, tx)
    assert tx == min(1 << (nv - 1).bit_length(), rdma.PACK_THREADS)
    assert plan.grid == (1, -(-(h + 2 * D) // ty), 2 * C)


def test_pack_plan_caps_the_grid_and_refuses_a_deep_ring():
    # 70000 + 2048 staged rows of 4096 B: a row a block row, 65535 row tiles.
    plan = rdma.pack_plan(1, 70000, 2048, 1024, 4, [BASE])
    assert plan.vec == 16 and plan.threads == (256, 1)
    assert plan.grid == (1, 65535, 2)
    assert rdma.pack_plan(40000, 8, 8, 2, 1, [0]).grid[2] == 65535
    for D in (0, 9):
        with pytest.raises(ValueError, match="no pack of depth"):
            rdma.pack_plan(1, 8, 12, D, 2, [0])


# -------------------------------------------------------- the emulation


@pytest.mark.parametrize("storage", ["u8", "bf16", "f32"])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("grid_shape", [(1, 4), (4, 1), (3, 3)])
def test_emulated_pack_equals_plain(grid_shape, boundary, storage):
    # Odd block sizes: every dtype's vector from 1 to 4 bytes; the 1 x N
    # grid has no upper or lower neighbour under zero, the N x 1 grid
    # reads both; each slot packed alone, as the per-slot path launches it.
    blocks, _ = _blocks(3, grid_shape, (9, 14), storage)
    for s in range(grid_shape[0] * grid_shape[1]):
        _check_range(blocks, grid_shape, boundary, 3, s, 1)


@pytest.mark.parametrize("storage", ["u8", "bf16", "f32"])
@pytest.mark.parametrize("grid_shape,boundary,b0,count",
                         [((3, 3), "zero", 0, 9), ((2, 4), "periodic", 2, 5),
                          ((4, 1), "zero", 1, 3)])
def test_emulated_pack_of_a_range(grid_shape, boundary, b0, count, storage):
    blocks, _ = _blocks(4, grid_shape, (10, 16), storage)
    plan, *_ = _check_range(blocks, grid_shape, boundary, 4, b0, count)
    assert plan.grid[2] == count * 2 * 2


@pytest.mark.parametrize("bhw,D,storage,want", [
    ((8, 64), 8, "bf16", 16),     # pitch 128 B, D·elt 16 B
    ((8, 36), 4, "bf16", 8),      # pitch 72 B
    ((8, 30), 6, "u8", 2),        # pitch 30 B
    ((6, 6), 6, "f32", 8),        # D = min(h, w): the whole block, 24 B
    ((11, 7), 7, "u8", 1),        # D = w, an odd pitch
])
def test_emulated_pack_at_every_vector(bhw, D, storage, want):
    blocks, _ = _blocks(5, (3, 2), bhw, storage)
    for s in range(6):
        plan, *_ = _check_range(blocks, (3, 2), "periodic", D, s, 1,
                                align=512)
        assert plan.vec == want


@pytest.mark.parametrize("skew,want", [(8, 8), (4, 4), (2, 2), (1, 1)])
def test_emulated_pack_off_alignment(skew, want):
    # A pitch of 128 B would allow 16-byte vectors; buffers off their
    # alignment cut the vector to what the addresses allow.
    blocks, _ = _blocks(6, (2, 2), (8, 64), "bf16")
    plan, *_ = _check_range(blocks, (2, 2), "zero", 8, 0, 4, align=256,
                            skew=skew)
    assert plan.vec == want


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_emulated_pack_grid_strides(monkeypatch, cap):
    # A grid capped below the work: every block loops over (block, side,
    # channel) triples and row tiles, and still writes each byte once.
    monkeypatch.setattr(rdma, "_GRID_MAX", cap)
    blocks, _ = _blocks(7, (2, 3), (13, 20), "u8")
    plan, *_ = _check_range(blocks, (2, 3), "zero", 5, 0, 6)
    assert plan.grid[1:] == (min(cap, 1), min(cap, 24))


@pytest.mark.parametrize("grid_shape,boundary", [((2, 2), "zero"),
                                                 ((1, 4), "periodic"),
                                                 ((4, 2), "periodic")])
def test_emulated_pack_is_the_jax_exchange_slabs(grid_shape, boundary):
    # The staging is the JAX package's halo exchange (rows, then columns
    # of the row-padded slab) cut to its two d-wide edge column slabs.
    R, Cg = grid_shape
    bhw, D = (7, 10), 3
    blocks, x = _blocks(8, grid_shape, bhw, "f32")
    jmeshed = jmesh.make_grid_mesh(jax.devices()[:R * Cg], grid_shape)
    padded = np.asarray(jax.jit(shard_map(
        lambda b: jhalo.halo_exchange(b, D, grid_shape, boundary),
        mesh=jmeshed, in_specs=P(None, "x", "y"),
        out_specs=P(None, "x", "y"), check_vma=False))(x))
    ph, pw = bhw[0] + 2 * D, bhw[1] + 2 * D
    flat = [b for row in blocks for b in row]
    table = channels.neighbour_table(grid_shape, boundary)
    mem = Memory(flat, D)
    plan = _plan_for(mem, table, 0, R * Cg, 2, *bhw, D)
    emulate(mem, table, 0, R * Cg, 2, *bhw, D, plan)
    for b in range(R * Cg):
        i, j = divmod(b, Cg)
        p = padded[:, i * ph:(i + 1) * ph, j * pw:(j + 1) * pw]
        want = np.stack([p[:, :, D:2 * D], p[:, :, bhw[1]:bhw[1] + D]])
        got = mem.staging(b).view(np.float32).reshape(want.shape)
        np.testing.assert_array_equal(got, want)


def test_pack_args_mirror_the_c_struct():
    # ops/rdma.py:_PackArgs is passed by address to pc_rdma_pack: its
    # fields are csrc/rdma.cu's PackArgs, in order, at the C types' widths.
    src = (Path(rdma.__file__).parent.parent / "csrc" / "rdma.cu").read_text()
    body = re.search(r"struct PackArgs \{(.*?)\};", src, re.S).group(1)
    c_fields = []
    for ctype, names in re.findall(r"(long long|int) ([^;]+);", body):
        c_fields += [(n.strip(), ctype) for n in names.split(",")]
    py = {ctypes.c_longlong: "long long", ctypes.c_int: "int"}
    assert [(n, py[t]) for n, t in rdma._PackArgs._fields_] == c_fields
    assert ctypes.sizeof(rdma._PackArgs) == 3 * 8 + 14 * 4
