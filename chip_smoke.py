#!/usr/bin/env python3
"""On-card proof of parallel_convolution_tpu_torch: build, check, drive, time.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``parallel_convolution_tpu_torch/csrc`` with
   nvcc (every part of every library at once) and print the build seconds,
   and ptxas's registers for every template instance of K1 and of the level
   loop (K2, K3, K4, 5c r3); a spill fails;
3. every kernel against its plain PyTorch version on the card: filters
   blur3 / gaussian5 / edge5 / sharpen3, storage f32 / bf16 / u8, quantize
   on and off, separable on and off, T in {1, 2, 8, 32}, zero and periodic
   boundaries, odd shapes with a ragged last tile, and the main path's own
   shapes; every K1 instance the wrapper reaches (k = 1, 3, 5, 7, 9, every
   input dtype against every output dtype, quantize on and off, both
   orders) on a view whose data_ptr() is not 16-byte aligned; K3 / K4 on
   grids 1x1, 2x2, 1x4 (periodic self-wrap) and 4x1,
   T in {1, 3} and a 32-level chunk split into level groups.  Quantize mode
   must be byte-equal; float mode within ``stencil.float_tolerance`` (the
   kernels round once per tap as an FMA, the plain versions twice);
4. the main paths at full size, 100 iterations each, through the user
   entry points, with the launch counters set to 0 just before each run
   and read just after: ``ConvolutionModel`` (cuda_sep / bf16 / fuse 32,
   and cuda / f32 / fuse 1) on a 1920x2520 RGB image, the ``run`` CLI with
   ``--fast`` on 1920x2520 grey blur3 and 8192x8192 grey edge5, and the
   ``cuda_rdma`` backend: ``ConvolutionModel`` on the RGB image at a 2x2
   grid (bf16, fuse 32; beside it ``cuda`` at the same grid), the CLI
   ``--backend cuda_rdma --mesh 4x4 --fast`` on the 8192x8192 edge5 image,
   and ``ConvolutionModel`` on the grey 1920x2520 image at a 16x16 grid
   (u8, fuse 8).  Each must be byte-equal to the plain ``shifted`` path run
   on the card, and a 3-iteration run must equal the NumPy oracle; the
   ``cuda_rdma`` paths must never call the halo exchange;
5. times with CUDA events after a warm-up: each kernel at the main path's
   shapes (``ms``: K1 as back-to-back wrapper calls, K3 / K4 as the launch
   alone, its arguments bound once, and as the whole wrapper call;
   ``device_ms``: the same launches queued ahead of the card, its own
   time), its plain version, ``F.conv2d`` (TF32 off) as the one-call
   yardstick of K1 and of K3 / K4 at T = 1, each kernel's bound and its
   fraction of it, the level loop's launch shape (strip height V, tile,
   threads, blocks per SM from the occupancy calculator), K1 at f32, bf16
   and u8 storage, separable, and on the 8192x8192 edge5 block, each with
   its launch shape (tile, stages, persistent grid) and a plain device copy
   of the same bytes as its ceiling, and
   end-to-end Gpx/s of each path's counted first run, of a second (warm)
   run, and of the model on an image already on the card (the host's share
   of the time is the difference);
6. the probes (TPU kernel 5, ``csrc/probes.cu``), after the kernel checks:
   5a ``op_chain`` prices ten op chains (every row printed; the f32 FMA
   rate at most 105% of the data sheet's), 5b ``smem_probe`` steps across
   the shared-memory limits (each step within a limit ``ok``, each above it
   a ``clean_refusal``), 5c ``rdma_ladder`` takes K4 apart construct by
   construct (every rung equal to its plain version, r3 byte-equal to K4);
   launches counted by the probes themselves;
7. ``backend="auto"``: ``ConvolutionModel(backend="auto", fuse=None)`` on
   the RGB image at 1x1 and 2x2 (bf16), the CLI ``run --backend auto
   --mesh 4x4 --fast`` on 8192x8192 edge5, and auto on the grey image at
   16x16 (u8), each byte-equal to ``shifted`` and to the oracle over 3
   iterations, its ``Resolution`` printed beside its Gpx/s and the
   explicit path at the same grid; a measured ``tune`` (4 candidates, 32
   iterations each, no error row) at each of those grids, the model's pick
   beside the measured winner; then the RGB 2x2 tune with
   ``--emit-plans --verify-auto``, whose plan file ``auto`` must resolve
   with ``source == "measured"`` (byte-equal to shifted, timed first,
   warm and resident);
8. the hardware-model constants of ``tuning.costmodel.H100`` as this run
   measures them, beside the committed ones;
9. the ``kernels`` JSON line (seven kernels), then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate
# and FP32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
ITERS = 100
RGB_HW = (1920, 2520)      # BASELINE configs 1-2
BIG_HW = (8192, 8192)      # BASELINE config 3
ORACLE_CROP = 1024         # the oracle's 3-iteration check crops above this
GREY_GRID = (16, 16)       # the reference program's split at 256 ranks
REPLACES = {
    "stencil_step": "parallel_convolution_tpu/ops/pallas_stencil.py:405",
    "fused_iterate": "parallel_convolution_tpu/ops/pallas_stencil.py:736",
    "rdma_block": "parallel_convolution_tpu/ops/pallas_rdma.py:1226",
    "rdma_tiled": "parallel_convolution_tpu/ops/pallas_rdma.py:1316",
    "op_chain": "scripts/vpu_op_probe.py:102",
    "smem_probe": "scripts/helper_crash_probe.py:100",
    "rdma_ladder": "scripts/tiled_repro_probe.py:101",
}
KERNELS = ("stencil_step", "fused_iterate", "rdma_block", "rdma_tiled")
PROBE_SOURCE = "parallel_convolution_tpu_torch/csrc/probes.cu"
# K1's typed instances: 3 input dtypes x k in (1, 3, 5, 7, 9) x 2 orders x
# 11 (output dtype, store-back) pairs (no u8 output in float mode, no rintf
# without the clip).
K1_INSTANCES = 3 * 5 * 2 * 11
SOURCES = {
    "stencil_step": "parallel_convolution_tpu_torch/csrc/step.cu",
    "fused_iterate": "parallel_convolution_tpu_torch/csrc/stencil.cu",
    "rdma_block": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "rdma_tiled": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "op_chain": PROBE_SOURCE,
    "smem_probe": PROBE_SOURCE,
    "rdma_ladder": PROBE_SOURCE,
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip() != "",
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, queue_ahead: bool = False) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events; with
    ``queue_ahead`` the calls are enqueued before the card starts them, so
    the host's time between calls is not counted (the device's time)."""
    from parallel_convolution_tpu_torch.utils.bench import cuda_ms as ms

    return ms(fn, reps, warmup, queue_ahead)


def max_abs_err(a, b) -> float:
    import torch

    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def agree(got, want, filt, levels, quantize) -> tuple[bool, float]:
    """Quantize mode: byte-equal.  Float mode: within float_tolerance."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil

    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    err = max_abs_err(got, want)
    if quantize:
        return bool(torch.equal(got, want)), err
    rtol, atol = stencil.float_tolerance(filt, levels, got.dtype)
    return bool(torch.allclose(got.to(torch.float32), want.to(torch.float32),
                               rtol=rtol, atol=atol)), err


# K1 and the kernels that run the level loop
# (csrc/stencil_common.cuh:run_levels), by library, and the names of their
# template parameters.
PTXAS_KERNELS = {
    "stencil": {"stencil_step_kernel": ("IN", "OUT", "K", "EPI", "SEP"),
                "fused_iterate_kernel": ("K", "EPI", "SEP")},
    "rdma": {"rdma_block_kernel": ("K", "EPI"),
             "rdma_tiled_kernel": ("K", "EPI")},
    "probes": {"rdma_ladder_kernel": ("RUNG", "K", "EPI")},
}


def print_ptxas() -> None:
    """ptxas's registers and spills for every template instance of K1 and
    the level loop, one line per kernel (K1's registers by k and order);
    fails on a spill."""
    import re

    from parallel_convolution_tpu_torch.ops import _build

    for lib, kernels in PTXAS_KERNELS.items():
        usage = _build.ptxas_usage(lib)
        for kernel, params in kernels.items():
            inst = {}
            for sym, u in usage.items():
                m = re.search(kernel + r"I((?:L[ib]\d+E)+)E", sym)
                if not m:
                    continue
                vals = re.findall(r"L[ib](\d+)E", m.group(1))
                if kernel == "rdma_ladder_kernel" and vals[0] != "3":
                    continue  # r0-r2 run no levels
                key = " ".join(f"{p}={v}" for p, v in zip(params, vals))
                inst[key] = [u.get("registers"), u.get("spill_stores", 0),
                             u.get("spill_loads", 0)]
            check(inst != {}, f"ptxas: no instance of {kernel} in lib{lib}")
            regs = [v[0] for v in inst.values()]
            spills = {k: v for k, v in inst.items() if v[1] or v[2]}
            if kernel == "stencil_step_kernel":  # 330 instances: by k, order
                check(len(inst) == K1_INSTANCES,
                      f"ptxas: {len(inst)} K1 instances, expected "
                      f"{K1_INSTANCES}")
                by = {}
                for key, v in inst.items():
                    p = dict(kv.split("=") for kv in key.split())
                    by.setdefault(f"K={p['K']} SEP={p['SEP']}", []).append(v[0])
                shown = {k: [min(v), max(v)] for k, v in sorted(by.items())}
            else:
                shown = {k: v[0] for k, v in inst.items()}
            print(f"ptxas {kernel}: {len(inst)} instances, registers "
                  f"{min(regs)}-{max(regs)}, spilling {len(spills)}; "
                  + json.dumps(shown))
            check(not spills, f"ptxas: {kernel} spills in {spills}")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(dev) -> dict:
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}
    modes = [("f32", True), ("bf16", True), ("u8", True), ("f32", False),
             ("bf16", False)]
    gen = torch.Generator(device="cpu").manual_seed(1234)

    def data(shape, storage):
        x = torch.randint(0, 256, shape, generator=gen).to(torch.float32)
        return x.to(device=dev, dtype=dtypes[storage])

    n, worst = 0, {"stencil_step": 0.0, "fused_iterate": 0.0}
    for name in ("blur3", "gaussian5", "edge5", "sharpen3"):
        f = get_filter(name)
        r = f.radius
        for storage, quantize in modes:
            for sep in (False, True):
                # K1 on an odd shape: 67 x 301 ragged against the 32 x 128 tile.
                x = data((3, 67 + 2 * r, 301 + 2 * r), storage)
                kw = dict(quantize=quantize, out_dtype=dtypes[storage],
                          separable=sep)
                got = stencil.stencil_step(x, f, **kw)
                want = stencil.stencil_step_plain(x, f, **kw)
                ok, err = agree(got, want, f, 1, quantize)
                check(ok, f"K1 {name} {storage} q={quantize} sep={sep}: "
                          f"max abs err {err}")
                worst["stencil_step"] = max(worst["stencil_step"], err)
                n += 1
                for T, boundary in ((1, "zero"), (2, "periodic"), (8, "zero"),
                                    (32, "zero")):
                    if not quantize and not f.convex and T > 2:
                        continue  # float mode grows by L1(taps) per level
                    d = r * T
                    x = data((2, 77 + 2 * d, 139 + 2 * d), storage)
                    valid = None if boundary == "periodic" else (90, 150)
                    got = stencil.fused_iterate(x, (3, 5), f, T, valid, **kw)
                    want = stencil.fused_iterate_plain(x, (3, 5), f, T, valid,
                                                       **kw)
                    ok, err = agree(got, want, f, T, quantize)
                    check(ok, f"K2 {name} {storage} q={quantize} sep={sep} "
                              f"T={T} {boundary}: max abs err {err}")
                    worst["fused_iterate"] = max(worst["fused_iterate"], err)
                    n += 1
    worst["stencil_step"] = max(worst["stencil_step"], check_step_instances(
        dev, data))
    n += 6 * 15 * 2
    torch.cuda.synchronize()
    print(f"kernel checks: {n} cases agree (quantize mode byte-equal; float "
          f"mode within stencil.float_tolerance, max abs err "
          f"K1 {worst['stencil_step']:.3g}, K2 {worst['fused_iterate']:.3g})")
    return worst


def check_step_instances(dev, data) -> float:
    """Every K1 instance the wrapper reaches against its plain version:
    k = 1, 3, 5, 7, 9, each input dtype against each output dtype (u8 out
    only with the store-back), quantize on and off, both orders, on a view
    one element past a 16-byte boundary with odd rows; max abs err."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter, make_filter

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}
    filters = [make_filter("identity1", [[1.0]]), get_filter("blur3"),
               get_filter("edge5"),
               make_filter("binomial7",
                           np.outer(*[[1, 6, 15, 20, 15, 6, 1]] * 2), 4096),
               make_filter("binomial9",
                           np.outer(*[[1, 8, 28, 56, 70, 56, 28, 8, 1]] * 2),
                           65536),
               get_filter("gaussian5")]
    worst = 0.0
    for f in filters:
        shape = (2, 45 + f.size - 1, 77 + f.size - 1)
        n = shape[0] * shape[1] * shape[2]
        for src in dtypes:
            x = data((n + 1,), src)[1:].view(shape)
            for dst in dtypes:
                for quantize in (True, False):
                    if dst == "u8" and not quantize:
                        continue
                    for sep in (False, True):
                        kw = dict(quantize=quantize, out_dtype=dtypes[dst],
                                  separable=sep)
                        got = stencil.stencil_step(x, f, **kw)
                        want = stencil.stencil_step_plain(x, f, **kw)
                        ok, err = agree(got, want, f, 1, quantize)
                        check(ok, f"K1 {f.name} {src}->{dst} q={quantize} "
                                  f"sep={sep}: max abs err {err}")
                        worst = max(worst, err)
    return worst


def check_rdma_kernels(dev) -> dict:
    """K3 and K4 (one launch each) against the plain version (halo exchange
    plus K2's plain levels), and a 32-level chunk through
    ``fused_rdma_step``: K3 whole at r = 1, K4 then K2 in level groups at
    r = 2."""
    import torch

    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}
    modes = [("f32", True), ("bf16", True), ("u8", True), ("f32", False),
             ("bf16", False)]
    gen = torch.Generator(device="cpu").manual_seed(4321)

    def blocks_of(grid_shape, bhw, storage, channels=2):
        R, Cg = grid_shape
        x = torch.randint(0, 256, (channels, R * bhw[0], Cg * bhw[1]),
                          generator=gen).to(torch.float32)
        return mesh.split_blocks(x.to(device=dev, dtype=dtypes[storage]),
                                 mesh.Grid(R, Cg, dev))

    n, worst = 0, {"rdma_block": 0.0, "rdma_tiled": 0.0}
    bhw = (23, 37)
    for grid_shape, boundary in (((1, 1), "zero"), ((2, 2), "zero"),
                                 ((1, 4), "periodic"), ((4, 1), "zero"),
                                 ((2, 2), "periodic")):
        R, Cg = grid_shape
        # Zero boundary: an image a little smaller than the padded grid, so
        # the pad-to-multiple rim is masked too.
        valids = ([None] if boundary == "periodic"
                  else [(R * bhw[0] - 2, Cg * bhw[1] - 3), None])
        for name in ("blur3", "gaussian5", "edge5"):
            f = get_filter(name)
            for storage, quantize in modes:
                blocks = blocks_of(grid_shape, bhw, storage)
                kw = dict(quantize=quantize, out_dtype=dtypes[storage])
                for T in (1, 3):
                    if not quantize and not f.convex and T > 2:
                        continue  # float mode grows by L1(taps) per level
                    for valid in valids if T == 1 else valids[:1]:
                        want = mesh.join_blocks(rdma.fused_rdma_step_plain(
                            blocks, f, grid_shape, boundary, fuse=T,
                            valid_hw=valid, **kw))
                        for kind, launch, extra in (
                                ("rdma_block", rdma.rdma_block, {}),
                                ("rdma_tiled", rdma.rdma_tiled,
                                 {"tile": (8, 16)})):
                            got = mesh.join_blocks(rdma.unstack_blocks(launch(
                                rdma.stack_blocks(blocks, grid_shape), f,
                                grid_shape, boundary, T, valid, **kw, **extra),
                                grid_shape))
                            ok, err = agree(got, want, f, T, quantize)
                            check(ok, f"{kind} {name} {storage} q={quantize} "
                                      f"grid {grid_shape} {boundary} T={T} "
                                      f"valid {valid}: max abs err {err}")
                            worst[kind] = max(worst[kind], err)
                            n += 1
    # 32 levels in one chunk: K3 whole (r = 1, 100 x 100 blocks fit), and
    # K4 for 8 levels then K2 for 3 x 8 (r = 2, 130 x 136 blocks do not).
    for name, bhw, groups in (("blur3", (100, 100), 1),
                              ("edge5", (130, 136), 4),
                              ("gaussian5", (130, 136), 4)):
        f = get_filter(name)
        for storage in ("bf16", "u8"):
            blocks = blocks_of((2, 2), bhw, storage, channels=1)
            valid = (2 * bhw[0] - 1, 2 * bhw[1] - 5)
            plan = rdma.rdma_plan(f.radius, 32, bhw)
            check(len(plan.groups) == groups, f"rdma_plan {name}: {plan}")
            stencil_counts = _counts()
            got = mesh.join_blocks(rdma.fused_rdma_step(
                blocks, f, (2, 2), "zero", fuse=32, valid_hw=valid))
            delta = {k: v - stencil_counts[k] for k, v in _counts().items()}
            want_counts = {"rdma_block": int(plan.kernel == "block"),
                           "rdma_tiled": int(plan.kernel == "tiled"),
                           "fused_iterate": 4 * (groups - 1),
                           "stencil_step": 0}
            check(delta == want_counts,
                  f"fused_rdma_step {name} T=32 launched {delta}, expected "
                  f"{want_counts}")
            want = mesh.join_blocks(rdma.fused_rdma_step_plain(
                blocks, f, (2, 2), "zero", fuse=32, valid_hw=valid))
            ok, err = agree(got, want, f, 32, True)
            check(ok, f"fused_rdma_step {name} {storage} T=32 ({plan}): max "
                      f"abs err {err}")
            n += 1
    torch.cuda.synchronize()
    print(f"rdma kernel checks: {n} cases agree (quantize mode byte-equal; "
          f"float mode within stencil.float_tolerance, max abs err "
          f"K3 {worst['rdma_block']:.3g}, K4 {worst['rdma_tiled']:.3g})")
    return worst


def _counts() -> dict:
    from parallel_convolution_tpu_torch.ops import stencil

    return stencil.launch_counts()


# ---------------------------------------------------------------------------
# Main-path shapes: inputs, checks, times and bounds
# ---------------------------------------------------------------------------


def padded_block(img, storage, depth, dev):
    """The block K1/K2 get on the main path: the image as planar storage,
    zero-padded by the halo depth (the 1x1 grid's exchange)."""
    import torch

    from parallel_convolution_tpu_torch.parallel import halo
    from parallel_convolution_tpu_torch.parallel.step import STORAGE_DTYPES
    from parallel_convolution_tpu_torch.utils import imageio

    x = torch.from_numpy(imageio.interleaved_to_planar(img).copy()).to(
        device=dev, dtype=STORAGE_DTYPES[storage])
    return halo.halo_exchange([[x]], depth, (1, 1), "zero")[0][0]


def level_ops(filt, sep: bool, h: int, w: int, quantize: bool,
              masks: bool) -> float:
    """FP32 operations of one level producing (h, w): an FMA counts 2."""
    k, r = filt.size, filt.radius
    if sep:
        fma = (h + 2 * r) * w * k + h * w * k
    else:
        fma = h * w * k * k
    per_px = (1 + (0 if filt.convex else 2)) if quantize else 0
    per_px += 2 if masks else 0
    return 2.0 * fma + per_px * h * w


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def launch_shape(blocks_per_sm: int) -> dict:
    """The level loop's launch shape: strip height V (as built), threads
    per block, and the blocks one SM holds (the occupancy calculator)."""
    from parallel_convolution_tpu_torch.ops import _build, stencil

    return {"V": _build.load_library("stencil").pc_strip_height(),
            "threads": stencil.FUSED_THREADS, "blocks_per_sm": blocks_per_sm}


def time_step(img, filt, storage, dev, separable: bool = False) -> dict:
    """K1 as ConvolutionModel(backend='cuda', fuse=1) calls it, beside its
    plain version, ``F.conv2d`` (TF32 off) and a plain device copy of the
    same bytes (the output's window of the input, out.copy_(p[:, r:-r,
    r:-r])): the ceiling a kernel that reads and writes these bytes once
    reaches through PyTorch's own copy."""
    import torch
    import torch.nn.functional as F

    from parallel_convolution_tpu_torch.ops import stencil

    r = filt.radius
    p = padded_block(img, storage, r, dev)
    kw = dict(quantize=True, out_dtype=p.dtype, separable=separable)
    got = stencil.stencil_step(p, filt, **kw)
    want = stencil.stencil_step_plain(p, filt, **kw)
    ok, err = agree(got, want, filt, 1, True)
    check(ok, f"K1 at the main path's shape {tuple(p.shape)} {storage} "
              f"sep={separable}: err {err}")
    shape = stencil.step_launch_shape(p, filt, **kw)
    # ms: back-to-back wrapper calls, as the fuse-1 path makes them (where
    # the host's time per call is the longer, it shows); device_ms: the same
    # launches queued ahead of the card, the kernel's own time.
    ms = cuda_ms(lambda: stencil.stencil_step(p, filt, **kw), reps=200,
                 warmup=20)
    device_ms = cuda_ms(lambda: stencil.stencil_step(p, filt, **kw),
                        reps=200, warmup=20, queue_ahead=True)
    plain_ms = cuda_ms(lambda: stencil.stencil_step_plain(p, filt, **kw),
                       reps=10)
    # The one-call yardstick: F.conv2d in full FP32 (cuDNN's TF32 off),
    # timed here only; the port never calls it for K1's work.
    torch.backends.cudnn.allow_tf32 = False
    taps = torch.as_tensor(filt.taps, device=dev)[None, None]
    pf = p.to(torch.float32)
    lib_ms = cuda_ms(lambda: F.conv2d(pf[:, None], taps), reps=50, warmup=5)
    out = torch.empty_like(got)
    window = p[:, r:p.shape[1] - r, r:p.shape[2] - r]
    copy_ms = cuda_ms(lambda: out.copy_(window), reps=200, warmup=20,
                      queue_ahead=True)
    C, H, W = got.shape
    use_sep = separable and filt.separable() is not None
    nbytes = p.numel() * p.element_size() + got.numel() * got.element_size()
    b_ms, b_by = bound(nbytes, C * level_ops(filt, use_sep, H, W, True,
                                             False))
    plan = shape["plan"]
    return dict(shape=list(p.shape), dtype=str(p.dtype), separable=separable,
                tile=list(plan.tile), extent=list(plan.extent),
                stages=plan.stages, threads=plan.threads, smem=plan.smem,
                blocks_per_sm=shape["blocks_per_sm"], grid=shape["grid"],
                max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=lib_ms, copy_ms=copy_ms,
                bound_ms=b_ms, bound_by=b_by, fraction_of_bound=b_ms / ms,
                device_fraction_of_bound=b_ms / device_ms,
                copy_fraction_of_bound=b_ms / copy_ms, bytes=nbytes,
                achieved_gbps=nbytes / (ms / 1e3) / 1e9,
                device_gbps=nbytes / (device_ms / 1e3) / 1e9)


def time_fused(img, filt, storage, T, sep, dev) -> dict:
    """K2 as the fused chunk of a fuse=T run on a 1x1 grid calls it."""
    from parallel_convolution_tpu_torch.ops import stencil

    r = filt.radius
    p = padded_block(img, storage, r * T, dev)
    C, Hp, Wp = p.shape
    h, w = Hp - 2 * r * T, Wp - 2 * r * T
    kw = dict(quantize=True, out_dtype=p.dtype, separable=sep)
    args = (p, (0, 0), filt, T, (h, w))
    before = stencil.fused_iterate.launches
    got = stencil.fused_iterate(*args, **kw)
    per_call = stencil.fused_iterate.launches - before
    want = stencil.fused_iterate_plain(*args, **kw)
    ok, err = agree(got, want, filt, T, True)
    check(ok, f"K2 at the main path's shape {tuple(p.shape)}: err {err}")
    ms = cuda_ms(lambda: stencil.fused_iterate(*args, **kw), reps=10)
    plain_ms = cuda_ms(lambda: stencil.fused_iterate_plain(*args, **kw),
                       reps=2, warmup=1)
    use_sep = sep and filt.separable() is not None
    ops = sum(C * level_ops(filt, use_sep, h + 2 * r * (T - s),
                            w + 2 * r * (T - s), True, True)
              for s in range(1, T + 1))
    nbytes = p.numel() * p.element_size() + got.numel() * got.element_size()
    b_ms, b_by = bound(nbytes, ops)
    th, tw, groups = stencil.fused_plan(r, T, (h, w))
    return dict(shape=list(p.shape), dtype=str(p.dtype), T=T, tile=[th, tw],
                groups=groups, launches_per_call=per_call,
                rim_tax=[stencil.rim_tax(r, g, (th, tw)) for g in groups],
                **launch_shape(stencil.fused_blocks_per_sm(
                    p, filt, T, (h, w), separable=sep)),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, fraction_of_bound=b_ms / ms)


def time_rdma(kind, img, filt, storage, grid_shape, T, dev) -> dict:
    """K3 (``kind`` rdma_block) or K4 (rdma_tiled) as a fuse=T chunk of the
    ``cuda_rdma`` backend calls it on the image's blocks, one launch for
    the grid.  At T = 1 its one-call yardstick is ``F.conv2d`` (TF32 off)
    on the joined f32 image with zero padding; deeper chunks have none."""
    import torch
    import torch.nn.functional as F

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    planar = imageio.interleaved_to_planar(img)
    blocks = convert.blocks_from_numpy(planar, mesh.make_grid(grid_shape, dev),
                                       storage)
    valid = planar.shape[1:]
    x = rdma.stack_blocks(blocks, grid_shape)
    launch = rdma.rdma_block if kind == "rdma_block" else rdma.rdma_tiled
    call = lambda: launch(x, filt, grid_shape, "zero", T, valid)
    plain = lambda: rdma.fused_rdma_step_plain(blocks, filt, grid_shape,
                                               "zero", fuse=T, valid_hw=valid)
    got = mesh.join_blocks(rdma.unstack_blocks(call(), grid_shape))
    want = mesh.join_blocks(plain())
    ok, err = agree(got, want, filt, T, True)
    check(ok, f"{kind} at the main path's blocks {grid_shape} x "
              f"{tuple(blocks[0][0].shape)} T={T}: err {err}")
    # ms: the launch alone, its arguments bound once; device_ms: the same
    # launches queued ahead of the card (the kernel's own time); call_ms:
    # the whole wrapper call as the path makes it, with its checks, pointer
    # table and output allocation.
    tile = stencil.FUSED_TILE if kind == "rdma_tiled" else None
    fire, _ = rdma._bind(kind == "rdma_tiled", x, filt, grid_shape, "zero",
                         T, valid, True, None, 0, tile)
    shape = launch_shape(fire(occupancy=True))
    ms = cuda_ms(fire, reps=50 if T == 1 else 20)
    device_ms = cuda_ms(fire, reps=50 if T == 1 else 20, queue_ahead=True)
    call_ms = cuda_ms(call, reps=20 if T == 1 else 10)
    plain_ms = cuda_ms(plain, reps=2, warmup=1)
    lib_ms = None
    r = filt.radius
    if T == 1:
        torch.backends.cudnn.allow_tf32 = False
        taps = torch.as_tensor(filt.taps, device=dev)[None, None]
        full = mesh.join_blocks(blocks).to(torch.float32)[:, None]
        lib_ms = cuda_ms(lambda: F.conv2d(full, taps, padding=r), reps=20)
    nb, C, h, w = x.shape
    # The function needs T levels over every block and nothing more: the
    # ghost ring is its neighbours' own pixels, so the rim the kernels
    # recompute and their masks are not counted.
    ops = nb * C * T * level_ops(filt, False, h, w, True, False)
    nbytes = 2 * got.numel() * got.element_size()  # each block in once, out once
    b_ms, b_by = bound(nbytes, ops)
    return dict(grid=list(grid_shape), block=[C, h, w], dtype=str(got.dtype),
                T=T, tile=list(tile) if tile else [h, w], **shape,
                max_abs_err=err, ms=ms, device_ms=device_ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, fraction_of_bound=b_ms / ms)


def time_rdma_chunk(img, filt, storage, grid_shape, T, dev) -> dict:
    """One whole ``cuda_rdma`` chunk (``fused_rdma_step``) where its levels
    split into groups: K3 / K4 for the first, then K2 per block."""
    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    planar = imageio.interleaved_to_planar(img)
    blocks = convert.blocks_from_numpy(planar, mesh.make_grid(grid_shape, dev),
                                       storage)
    x = rdma.stack_blocks(blocks, grid_shape)
    kw = dict(fuse=T, valid_hw=planar.shape[1:])
    chunk = lambda: rdma.fused_rdma_stacked(x, filt, grid_shape, "zero", **kw)
    before = _counts()
    got = mesh.join_blocks(rdma.unstack_blocks(chunk(), grid_shape))
    per_call = {k: v - before[k] for k, v in _counts().items()}
    want = mesh.join_blocks(rdma.fused_rdma_step_plain(
        blocks, filt, grid_shape, "zero", **kw))
    ok, err = agree(got, want, filt, T, True)
    check(ok, f"fused_rdma_step at {grid_shape} x {tuple(blocks[0][0].shape)}"
              f" T={T}: err {err}")
    return dict(grid=list(grid_shape), block=list(blocks[0][0].shape), T=T,
                plan=rdma.rdma_plan(filt.radius, T,
                                    tuple(blocks[0][0].shape[1:]))._asdict(),
                launches_per_call=per_call, max_abs_err=err,
                ms=cuda_ms(chunk, reps=5),
                plain_ms=cuda_ms(lambda: rdma.fused_rdma_step_plain(
                    blocks, filt, grid_shape, "zero", **kw), reps=1, warmup=1))


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def host_seconds(fn) -> tuple[object, float]:
    """``fn()`` and its host-clock seconds, the card synchronised on both
    sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive(label, fn, expect: dict, pixels: int,
          no_halo: bool = False) -> tuple[object, dict, float]:
    """Run one main-path entry point with the counters zeroed just before
    and read just after; check the expected launch counts and, with
    ``no_halo``, that the halo exchange was never called."""
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.parallel import halo

    stencil.reset_launch_counts()
    halo.halo_exchange.calls = 0
    out, secs = host_seconds(fn)
    counts = stencil.launch_counts()
    calls = halo.halo_exchange.calls
    for name, want in expect.items():
        check(counts[name] == want,
              f"{label}: {name} launched {counts[name]} times, expected {want}")
    check(any(counts.values()), f"{label}: no kernel launched")
    check(not no_halo or calls == 0,
          f"{label}: the halo exchange was called {calls} times")
    print(f"main path {label}: launches {counts}, {secs:.4f} s, "
          f"{pixels * ITERS / secs / 1e9:.3f} Gpx/s end to end")
    return out, counts, secs


def expected_launches(filt, fuse: int, hw, tile=None) -> dict:
    """Launches of one ``ITERS``-iteration run on a 1x1 grid: K2 per
    fused chunk (one per level group), K1 per single-level step."""
    from parallel_convolution_tpu_torch.ops import stencil

    none = {"rdma_block": 0, "rdma_tiled": 0}
    if fuse == 1:
        return {"stencil_step": ITERS, "fused_iterate": 0, **none}
    n_chunks, rem = divmod(ITERS, fuse)
    per = lambda T: len(stencil.fused_plan(filt.radius, T, hw, tile)[2])
    return {"stencil_step": 1 if rem == 1 else 0,
            "fused_iterate": n_chunks * per(fuse) + (per(rem) if rem > 1 else 0),
            **none}


def expected_rdma_launches(filt, fuse: int, grid_shape, block_hw,
                           tile=None) -> dict:
    """Launches of one ``ITERS``-iteration ``cuda_rdma`` run: one K3 or K4
    launch per chunk, and K2 once per block for each later level group."""
    from parallel_convolution_tpu_torch.ops import rdma

    counts = {k: 0 for k in KERNELS}
    n_chunks, rem = divmod(ITERS, fuse)
    for T, n in ((fuse, n_chunks), (rem, 1 if rem else 0)):
        if n == 0:
            continue
        plan = rdma.rdma_plan(filt.radius, T, block_hw, tile)
        counts["rdma_" + plan.kernel] += n
        counts["fused_iterate"] += (n * grid_shape[0] * grid_shape[1]
                                    * (len(plan.groups) - 1))
    return counts


def main_paths(dev, tmp: Path) -> tuple[dict, list]:
    import numpy as np

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import oracle
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import imageio

    import torch

    totals = {k: 0 for k in KERNELS}
    rows = []

    def add(label, counts, pixels, first, warm, resident=None):
        """Record one path: the counted first run, a second (warm) run of
        the same call, and, for the model, ``run_planar`` on an image
        already on the card (no host conversions or copies)."""
        for k, v in counts.items():
            totals[k] += v
        row = dict(path=label, launches=counts, seconds_first=first,
                   seconds_warm=warm, seconds_resident=resident)
        for key in ("first", "warm", "resident"):
            s = row[f"seconds_{key}"]
            row[f"gpx_per_s_{key}"] = None if s is None else pixels * ITERS / s / 1e9
        rows.append(row)

    def plain(filt, img, iters):
        return ConvolutionModel(filt, backend="shifted", device=dev).run_image(
            img, iters)

    blur3 = get_filter("blur3")
    rgb = imageio.generate_test_image(*RGB_HW, "rgb", seed=1)
    hw = "x".join(map(str, RGB_HW))
    px = RGB_HW[0] * RGB_HW[1] * 3
    ref = plain("blur3", rgb, ITERS)
    for label, kw in (
            (f"rgb {hw} blur3 cuda_sep bf16 fuse 32",
             dict(backend="cuda_sep", storage="bf16", fuse=32)),
            (f"rgb {hw} blur3 cuda f32 fuse 1",
             dict(backend="cuda", storage="f32", fuse=1))):
        model = ConvolutionModel("blur3", device=dev, **kw)
        expect = expected_launches(blur3, kw["fuse"], RGB_HW)
        out, counts, secs = drive(label, lambda: model.run_image(rgb, ITERS),
                                  expect, px)
        check(np.array_equal(out, ref), f"{label}: differs from shifted")
        check(np.array_equal(model.run_image(rgb, 3),
                             oracle.run_serial_u8(rgb, blur3, 3)),
              f"{label}: 3 iterations differ from the NumPy oracle")
        _, warm = host_seconds(lambda: model.run_image(rgb, ITERS))
        planar = torch.from_numpy(imageio.interleaved_to_planar(rgb).copy()).to(
            device=dev, dtype=torch.float32)
        _, resident = host_seconds(lambda: model.run_planar(planar, ITERS))
        add(label, counts, px, secs, warm, resident)

    greys, grey_refs = {}, {}
    for (rows_, cols_), name in ((RGB_HW, "blur3"), (BIG_HW, "edge5")):
        filt = get_filter(name)
        # --fast on the card: cuda_sep / bf16 / fuse min(32, block // r).
        expect = expected_launches(
            filt, max(1, min(32, min(rows_, cols_) // filt.radius)),
            (rows_, cols_))
        img = imageio.generate_test_image(rows_, cols_, "grey", seed=2)
        src, dst = tmp / f"{name}.raw", tmp / f"{name}.out.raw"
        imageio.write_raw(src, img)
        label = f"cli run grey {rows_}x{cols_} {name} --fast"
        argv = ["run", str(src), str(rows_), str(cols_), str(ITERS), "grey",
                "-o", str(dst), "--filter", name, "--fast"]
        def run_cli():
            rc = cli_main(argv)
            check(rc == 0, f"{label}: the CLI exited {rc}")

        _, counts, secs = drive(label, run_cli, expect, rows_ * cols_)
        out = imageio.read_raw(dst, rows_, cols_, "grey")
        greys[name], grey_refs[name] = img, plain(name, img, ITERS)
        check(np.array_equal(out, grey_refs[name]),
              f"{label}: differs from shifted")
        crop = img[:ORACLE_CROP, :ORACLE_CROP]
        fast = ConvolutionModel(name, backend="cuda_sep", storage="bf16",
                                fuse=32, device=dev)
        check(np.array_equal(fast.run_image(crop, 3),
                             oracle.run_serial_u8(crop, filt, 3)),
              f"{label}: 3 iterations on {crop.shape} differ from the oracle")
        _, warm = host_seconds(run_cli)
        add(label, counts, rows_ * cols_, secs, warm)

    # The cuda_rdma backend: every block of the grid on the one card, the
    # exchange inside K3 / K4.  Any grid gives the 1x1 grid's bytes, so the
    # shifted references above stand.  Beside it, cuda at the same grid:
    # the halo exchange and one K2 launch per block that it replaces.
    grid2 = make_grid((2, 2), dev)
    block_rgb = tuple(-(-n // 2) for n in RGB_HW)
    per_block = expected_launches(blur3, 32, block_rgb)
    for label, kw, expect in (
            (f"rgb {hw} blur3 cuda_rdma bf16 fuse 32 grid 2x2",
             dict(backend="cuda_rdma", storage="bf16", fuse=32),
             expected_rdma_launches(blur3, 32, (2, 2), block_rgb)),
            (f"rgb {hw} blur3 cuda bf16 fuse 32 grid 2x2",
             dict(backend="cuda", storage="bf16", fuse=32),
             {k: 4 * v for k, v in per_block.items()})):
        model = ConvolutionModel("blur3", grid=grid2, **kw)
        rdma_path = kw["backend"] == "cuda_rdma"
        out, counts, secs = drive(label, lambda: model.run_image(rgb, ITERS),
                                  expect, px, no_halo=rdma_path)
        check(np.array_equal(out, ref), f"{label}: differs from shifted")
        if rdma_path:
            check(np.array_equal(model.run_image(rgb, 3),
                                 oracle.run_serial_u8(rgb, blur3, 3)),
                  f"{label}: 3 iterations differ from the NumPy oracle")
        _, warm = host_seconds(lambda: model.run_image(rgb, ITERS))
        planar = torch.from_numpy(imageio.interleaved_to_planar(rgb).copy()).to(
            device=dev, dtype=torch.float32)
        _, resident = host_seconds(lambda: model.run_planar(planar, ITERS))
        add(label, counts, px, secs, warm, resident)

    edge5 = get_filter("edge5")
    src, dst = tmp / "edge5.raw", tmp / "edge5.rdma.raw"
    label = f"cli run grey {BIG_HW[0]}x{BIG_HW[1]} edge5 --backend cuda_rdma --mesh 4x4 --fast"
    argv = ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]), str(ITERS),
            "grey", "-o", str(dst), "--filter", "edge5", "--backend",
            "cuda_rdma", "--mesh", "4x4", "--fast"]

    def run_rdma_cli():
        rc = cli_main(argv)
        check(rc == 0, f"{label}: the CLI exited {rc}")

    expect = expected_rdma_launches(edge5, 32, (4, 4),
                                    tuple(n // 4 for n in BIG_HW))
    _, counts, secs = drive(label, run_rdma_cli, expect,
                            BIG_HW[0] * BIG_HW[1], no_halo=True)
    check(np.array_equal(imageio.read_raw(dst, *BIG_HW, "grey"),
                         grey_refs["edge5"]), f"{label}: differs from shifted")
    crop = greys["edge5"][:ORACLE_CROP, :ORACLE_CROP]
    small = ConvolutionModel("edge5", grid=make_grid((4, 4), dev),
                             backend="cuda_rdma", storage="bf16", fuse=32)
    check(np.array_equal(small.run_image(crop, 3),
                         oracle.run_serial_u8(crop, edge5, 3)),
          f"{label}: 3 iterations on {crop.shape} differ from the oracle")
    _, warm = host_seconds(run_rdma_cli)
    add(label, counts, BIG_HW[0] * BIG_HW[1], secs, warm)

    grey = greys["blur3"]
    label = (f"grey {hw} blur3 cuda_rdma u8 fuse 8 grid "
             f"{GREY_GRID[0]}x{GREY_GRID[1]}")
    model = ConvolutionModel("blur3", grid=make_grid(GREY_GRID, dev),
                             backend="cuda_rdma", storage="u8", fuse=8)
    block_grey = tuple(-(-n // g) for n, g in zip(RGB_HW, GREY_GRID))
    expect = expected_rdma_launches(blur3, 8, GREY_GRID, block_grey)
    out, counts, secs = drive(label, lambda: model.run_image(grey, ITERS),
                              expect, RGB_HW[0] * RGB_HW[1], no_halo=True)
    check(np.array_equal(out, grey_refs["blur3"]),
          f"{label}: differs from shifted")
    check(np.array_equal(model.run_image(grey, 3),
                         oracle.run_serial_u8(grey, blur3, 3)),
          f"{label}: 3 iterations differ from the NumPy oracle")
    _, warm = host_seconds(lambda: model.run_image(grey, ITERS))
    planar = torch.from_numpy(grey[None].copy()).to(device=dev,
                                                    dtype=torch.float32)
    _, resident = host_seconds(lambda: model.run_planar(planar, ITERS))
    add(label, counts, RGB_HW[0] * RGB_HW[1], secs, warm, resident)

    check(all(totals.values()), f"a kernel never ran on the main path: {totals}")
    refs = {"rgb": rgb, "rgb_ref": ref, "greys": greys, "grey_refs": grey_refs}
    return totals, rows, refs


def expected_for(res, filt, grid_shape, shape) -> dict:
    """Launches of one ``ITERS``-iteration run at a resolution: a plain
    backend none, ``cuda`` / ``cuda_sep`` its 1x1 counts on every block,
    ``cuda_rdma`` one K3 / K4 per chunk plus K2 per later level group."""
    block = tuple(-(-n // g) for n, g in zip(shape[1:], grid_shape))
    if res.backend == "cuda_rdma":
        return expected_rdma_launches(filt, res.fuse, grid_shape, block,
                                      res.tile)
    if res.backend in ("cuda", "cuda_sep"):
        nb = grid_shape[0] * grid_shape[1]
        return {k: nb * v for k, v in expected_launches(
            filt, res.fuse, block, res.tile).items()}
    return {k: 0 for k in KERNELS}


# ---------------------------------------------------------------------------
# Phase 6: the probes (TPU kernel 5)
# ---------------------------------------------------------------------------


def probe_phase(dev) -> dict:
    """5a, 5b and 5c on the card, every row printed; returns each probe's
    entry of the kernels line (launches: the probe phase's own count)."""
    import torch

    from parallel_convolution_tpu_torch import probes
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.probes import (
        op_price, rdma_ladder, smem_budget,
    )

    probes.reset_launch_counts()
    price = op_price.measure(dev)
    for row in price:
        print("probe op_price: " + json.dumps(row))
    check([(r["op"], r["dtype"]) for r in price]
          == [c[:2] for c in op_price.CANDIDATES],
          "op_price: a candidate gave no row")
    check(all(r["correct"] for r in price),
          "op_price: a chain differs from its plain version")
    fma = price[0]
    check(2 * fma["gops_per_s"] * 1e9 <= 1.05 * FP32_OPS_PER_S,
          f"op_price: f32 FMA at {2 * fma['gops_per_s']:.0f} Gop/s, above "
          f"105% of the card's {FP32_OPS_PER_S / 1e9:.0f}")

    budget = smem_budget.measure(dev)
    for row in budget:
        print("probe smem_budget: " + json.dumps(row))
        want = "ok" if row["fits"] else "clean_refusal"
        check(row["error_class"] == want and (row["correct"] or not row["fits"]),
              f"smem_budget: {row['bytes']} B opt_in={row['opt_in']} gave "
              f"{row['error_class']}, expected {want}")
    x = (torch.arange(smem_budget.SHAPE[0] * smem_budget.SHAPE[1],
                      dtype=torch.float32, device=dev)
         .reshape(smem_budget.SHAPE) % 251.0)
    probe_ms = cuda_ms(lambda: smem_budget.smem_probe(x, 100 * 1024, True),
                       reps=50)
    probe_plain_ms = cuda_ms(lambda: smem_budget.smem_probe_plain(x), reps=50)
    probe_lib_ms = cuda_ms(lambda: torch.add(x, 1.0), reps=50)
    got = smem_budget.smem_probe(x, 100 * 1024, True)[0]
    probe_err = max_abs_err(got, smem_budget.smem_probe_plain(x))

    ladder = rdma_ladder.measure(dev)
    for row in ladder:
        print("probe rdma_ladder: " + json.dumps(row))
        check(row["built"] and row["correct"],
              f"rdma_ladder {row['rung']}: built {row['built']}, "
              f"correct {row['correct']}")
    check(ladder[-1]["equal_k4"], "rdma_ladder r3 differs from K4")
    counts = probes.launch_counts()

    n = fma["elems"]
    b_fma = bound(4.0 * n * (1 + op_price.CHAINS),
                  2.0 * n * op_price.CHAINS * op_price.STEPS)
    b_probe = bound(2.0 * x.numel() * 4, float(x.numel()))
    nb, C, h, w = ladder[-1]["shape"]
    blur3 = get_filter(rdma_ladder.FILTER)
    b_ladder = bound(2.0 * nb * C * h * w * 2,
                     nb * C * rdma_ladder.T_LEVELS
                     * level_ops(blur3, False, h, w, True, False))
    # library_ms: one PyTorch call of the same function, where there is one
    # (out = in + 1 is torch.add); none runs a 128-step chain or T levels.
    entries = {
        "op_chain": dict(ms=fma["ms"], plain_ms=fma["plain_ms"],
                         max_abs_err=fma["max_abs_err"], bound=b_fma,
                         library_ms=None),
        "smem_probe": dict(ms=probe_ms, plain_ms=probe_plain_ms,
                           max_abs_err=probe_err, bound=b_probe,
                           library_ms=probe_lib_ms),
        "rdma_ladder": dict(ms=ladder[-1]["ms"], plain_ms=ladder[-1]["plain_ms"],
                            max_abs_err=ladder[-1]["max_abs_err"],
                            bound=b_ladder, library_ms=None),
    }
    for name, e in entries.items():
        e["launches"] = counts[name]
    print(f"probe launches: {counts}")
    return {"entries": entries, "op_price": price, "ladder": ladder}


def time_host_calls(dev, n: int = 400) -> dict:
    """Host seconds per K1 wrapper call and per eager PyTorch op (a slice
    copy), each on a tiny block so the card is idle: the cost model's
    ``launch_s`` and ``op_s``."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter

    blur3 = get_filter("blur3")
    p = torch.zeros((1, 10, 10), device=dev)
    a, b = torch.zeros((1, 12, 12), device=dev), torch.ones((1, 10, 10),
                                                            device=dev)

    def per_call(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    before = stencil.stencil_step.launches
    launch_s = per_call(lambda: stencil.stencil_step(
        p, blur3, quantize=True, out_dtype=p.dtype))
    stencil.stencil_step.launches = before  # not main-path launches

    def copy():
        a[:, 1:11, 1:11] = b

    return {"launch_s": launch_s, "op_s": per_call(copy), "calls": n}


def hardware_constants(k1, k2, k4, price, host) -> dict:
    """``tuning.costmodel.H100``'s constants as this run measures them."""
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.tuning import costmodel

    blur3 = get_filter("blur3")
    rows = {(r["op"], r["dtype"]): r for r in price}
    step = lambda op: rows[(op, "f32")]["per_step_vs_f32_fma"]  # noqa: E731
    q = 2 * (step("magicround+add") - step("add"))
    q_rint = 2 * (step("rint+add") - step("add"))

    def slots_rate(pixels, T, tile, sep, ms):
        """The model's executed slots for T levels over ``pixels`` in
        ``tile`` tiles, per second of the kernel's time."""
        slots = costmodel.flops_per_px_iter(blur3.size, sep, True, T, tile,
                                            blur3.radius, q)
        return slots * pixels * T / (ms / 1e3) / 1e9

    C, Hp, Wp = k2["shape"]
    d = blur3.radius * k2["T"]
    k2_px = C * (Hp - 2 * d) * (Wp - 2 * d)
    k4_px = k4["grid"][0] * k4["grid"][1] * k4["block"][0] * k4["block"][1] \
        * k4["block"][2]
    # The memory rate from K1's device time: its wrapper-call time counts
    # the host too.
    return {"hbm_gbps": k1["device_gbps"],
            "flop_gops": 2 * rows[("fma", "f32")]["gops_per_s"],
            "tap_gops": slots_rate(k4_px, k4["T"], stencil.FUSED_TILE,
                                   False, k4["ms"]),
            "sep_tap_gops": slots_rate(k2_px, k2["T"], tuple(k2["tile"]),
                                       True, k2["ms"]),
            "quantize_slots": q, "rint_quantize_slots": q_rint,
            "launch_s": host["launch_s"], "op_s": host["op_s"]}


# ---------------------------------------------------------------------------
# Phase 7: backend="auto" and a measured tune
# ---------------------------------------------------------------------------


def auto_paths(dev, tmp: Path, refs: dict, rows: list, totals: dict) -> list:
    """The four auto runs, each byte-equal to shifted and (3 iterations)
    to the oracle, printed with its Resolution beside the explicit path
    at the same grid."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch import tuning
    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import oracle
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import imageio

    os.environ.pop(tuning.PLAN_FILE_ENV, None)  # the model, not a plan file
    by_label = {r["path"]: r for r in rows}
    hw = "x".join(map(str, RGB_HW))
    rgb, grey = refs["rgb"], refs["greys"]["blur3"]
    out_rows = []

    def report(label, res, counts, pixels, first, warm, resident, explicit):
        for k, v in counts.items():
            totals[k] += v
        row = {"path": label, "resolution": {
            "backend": res.backend, "fuse": res.fuse,
            "tile": list(res.tile) if res.tile else None,
            "source": res.source, "predicted_gpx": res.predicted_gpx},
            "launches": counts}
        for key, secs in (("first", first), ("warm", warm),
                          ("resident", resident)):
            row[f"gpx_per_s_{key}"] = (None if secs is None
                                       else pixels * ITERS / secs / 1e9)
        ex = by_label[explicit]
        row["explicit"] = {"path": explicit, **{
            f"gpx_per_s_{k}": ex[f"gpx_per_s_{k}"]
            for k in ("first", "warm", "resident")}}
        print("auto: " + json.dumps(row))
        out_rows.append(row)

    blur3, edge5 = get_filter("blur3"), get_filter("edge5")
    for grid_shape, storage, img, ref, explicit in (
            ((1, 1), "bf16", rgb, refs["rgb_ref"],
             f"rgb {hw} blur3 cuda_sep bf16 fuse 32"),
            ((2, 2), "bf16", rgb, refs["rgb_ref"],
             f"rgb {hw} blur3 cuda_rdma bf16 fuse 32 grid 2x2"),
            (GREY_GRID, "u8", grey, refs["grey_refs"]["blur3"],
             f"grey {hw} blur3 cuda_rdma u8 fuse 8 grid "
             f"{GREY_GRID[0]}x{GREY_GRID[1]}")):
        grid = make_grid(grid_shape, dev)
        model = ConvolutionModel("blur3", grid=grid, backend="auto",
                                 storage=storage, fuse=None)
        planar = torch.from_numpy(imageio.interleaved_to_planar(img).copy())
        shape = tuple(planar.shape)
        res = tuning.resolve(grid, blur3, shape, storage=storage)
        label = (f"auto {'rgb' if shape[0] == 3 else 'grey'} {hw} blur3 "
                 f"{storage} grid {grid_shape[0]}x{grid_shape[1]}")
        out, counts, secs = drive(
            label, lambda: model.run_image(img, ITERS),
            expected_for(res, blur3, grid_shape, shape), shape[0] * RGB_HW[0]
            * RGB_HW[1], no_halo=res.backend == "cuda_rdma")
        check(model.resolution == res,
              f"{label}: resolved {model.resolution}, expected {res}")
        check(np.array_equal(out, ref), f"{label}: differs from shifted")
        check(np.array_equal(model.run_image(img, 3),
                             oracle.run_serial_u8(img, blur3, 3)),
              f"{label}: 3 iterations differ from the NumPy oracle")
        _, warm = host_seconds(lambda: model.run_image(img, ITERS))
        resident_in = planar.to(device=dev, dtype=torch.float32)
        _, resident = host_seconds(lambda: model.run_planar(resident_in,
                                                            ITERS))
        report(label, res, counts, shape[0] * RGB_HW[0] * RGB_HW[1], secs,
               warm, resident, explicit)

    # The CLI with an explicit --backend auto and --fast: storage bf16 and
    # fuse 32 fill in, auto tunes backend and tile.
    src, dst = tmp / "edge5.raw", tmp / "edge5.auto.raw"
    label = (f"cli run grey {BIG_HW[0]}x{BIG_HW[1]} edge5 --backend auto "
             "--mesh 4x4 --fast")
    argv = ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]), str(ITERS),
            "grey", "-o", str(dst), "--filter", "edge5", "--backend", "auto",
            "--mesh", "4x4", "--fast"]

    def run_cli():
        rc = cli_main(argv)
        check(rc == 0, f"{label}: the CLI exited {rc}")

    grid4 = make_grid((4, 4), dev)
    res = tuning.resolve(grid4, edge5, (1, *BIG_HW), storage="bf16", fuse=32)
    _, counts, secs = drive(label, run_cli,
                            expected_for(res, edge5, (4, 4), (1, *BIG_HW)),
                            BIG_HW[0] * BIG_HW[1],
                            no_halo=res.backend == "cuda_rdma")
    check(np.array_equal(imageio.read_raw(dst, *BIG_HW, "grey"),
                         refs["grey_refs"]["edge5"]),
          f"{label}: differs from shifted")
    crop = refs["greys"]["edge5"][:ORACLE_CROP, :ORACLE_CROP]
    small = ConvolutionModel("edge5", grid=grid4, backend="auto",
                             storage="bf16", fuse=32)
    check(np.array_equal(small.run_image(crop, 3),
                         oracle.run_serial_u8(crop, edge5, 3)),
          f"{label}: 3 iterations on {crop.shape} differ from the oracle")
    _, warm = host_seconds(run_cli)
    report(label, res, counts, BIG_HW[0] * BIG_HW[1], secs, warm, None,
           f"cli run grey {BIG_HW[0]}x{BIG_HW[1]} edge5 --backend cuda_rdma "
           "--mesh 4x4 --fast")
    return out_rows


def run_tune(argv: list, label: str) -> tuple[dict, list]:
    """The ``tune`` subcommand in this process: its summary and its
    measured rows, each printed; no row may be an error."""
    from parallel_convolution_tpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    rows = []
    for line in err.getvalue().splitlines():
        print(f"tune {label} row: {line}")
        if line.startswith("{"):
            rows.append(json.loads(line))
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and lines != [], f"tune {label} exited {rc}")
    summary = json.loads(lines[-1])
    print(f"tune {label} summary: " + json.dumps(summary))
    check(summary["errors"] == 0 and summary["measured_points"] >= 1,
          f"tune {label}: {summary['errors']} error rows, "
          f"{summary['measured_points']} measured")
    return summary, rows


def tune_auto_grids(tmp: Path) -> list:
    """A measured tune (4 candidates, 32 iterations each) at each auto
    grid: the model's pick (the shortlist's first row) beside the measured
    winner, on the same measurement."""
    out = []
    for rows_, cols_, mode, name, storage, mesh_, fuses in (
            (*RGB_HW, "rgb", "blur3", "bf16", "1x1", None),
            (*RGB_HW, "rgb", "blur3", "bf16", "2x2", None),
            (*BIG_HW, "grey", "edge5", "bf16", "4x4", "32"),
            (*RGB_HW, "grey", "blur3", "u8",
             f"{GREY_GRID[0]}x{GREY_GRID[1]}", None)):
        label = f"{mode} {rows_}x{cols_} {name} {storage} grid {mesh_}"
        argv = ["tune", "--rows", str(rows_), "--cols", str(cols_), "--mode",
                mode, "--filter", name, "--storage", storage, "--mesh", mesh_,
                "--iters", "32", "--max-measure", "4"]
        summary, rows = run_tune(argv + (["--fuses", fuses] if fuses else []),
                                 label)
        pick, best = rows[0], max(rows, key=lambda r: r["gpixels_per_s_per_chip"])
        row = {"grid": label,
               "pick": {k: pick[k] for k in ("effective_backend", "fuse",
                                             "tile", "gpixels_per_s_per_chip",
                                             "predicted_gpx_per_chip")},
               "winner": {k: best[k] for k in ("effective_backend", "fuse",
                                               "tile", "gpixels_per_s_per_chip",
                                               "predicted_gpx_per_chip")},
               "winner_over_pick": best["gpixels_per_s_per_chip"]
               / pick["gpixels_per_s_per_chip"]}
        print("pick vs measured winner: " + json.dumps(row))
        out.append(row)
    return out


def measured_tune(dev, tmp: Path, refs: dict, totals: dict) -> dict:
    """``tune`` the RGB 2x2 bf16 workload on the card (4 candidates, each
    at least one full chunk), ``--verify-auto``, then ``auto`` through the
    plan file must resolve to the measured winner, byte-equal to shifted."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch import tuning
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import imageio

    plans = tmp / "plans.json"
    summary, _ = run_tune(
        ["tune", "--rows", str(RGB_HW[0]), "--cols", str(RGB_HW[1]),
         "--mode", "rgb", "--filter", "blur3", "--storage", "bf16",
         "--mesh", "2x2", "--iters", "32", "--max-measure", "4",
         "--emit-plans", "--out", str(plans), "--verify-auto"],
        "rgb 2x2 --emit-plans")
    check(summary["auto_ok"], "tune --verify-auto did not round-trip")
    plan = summary["plan"]
    check(plan["source"] == "measured", f"tune plan {plan}")

    os.environ[tuning.PLAN_FILE_ENV] = str(plans)
    try:
        blur3 = get_filter("blur3")
        grid = make_grid((2, 2), dev)
        model = ConvolutionModel("blur3", grid=grid, backend="auto",
                                 storage="bf16", fuse=None)
        res = tuning.resolve(grid, blur3, (3, *RGB_HW), storage="bf16")
        label = "auto rgb blur3 bf16 grid 2x2 through the measured plan file"
        out_img, counts, secs = drive(
            label, lambda: model.run_image(refs["rgb"], ITERS),
            expected_for(res, blur3, (2, 2), (3, *RGB_HW)),
            3 * RGB_HW[0] * RGB_HW[1], no_halo=res.backend == "cuda_rdma")
    finally:
        os.environ.pop(tuning.PLAN_FILE_ENV, None)
    for k, v in counts.items():
        totals[k] += v
    got = model.resolution
    check(got.source == "measured"
          and [got.backend, got.fuse, list(got.tile) if got.tile else None]
          == [plan["backend"], plan["fuse"], plan["tile"]],
          f"{label}: resolved {got}, the plan file holds {plan}")
    check(np.array_equal(out_img, refs["rgb_ref"]),
          f"{label}: differs from shifted")
    os.environ[tuning.PLAN_FILE_ENV] = str(plans)
    try:
        _, warm = host_seconds(lambda: model.run_image(refs["rgb"], ITERS))
        planar = torch.from_numpy(imageio.interleaved_to_planar(
            refs["rgb"]).copy()).to(device=dev, dtype=torch.float32)
        _, resident = host_seconds(lambda: model.run_planar(planar, ITERS))
    finally:
        os.environ.pop(tuning.PLAN_FILE_ENV, None)
    px = 3 * RGB_HW[0] * RGB_HW[1] * ITERS / 1e9
    return {"plan": plan, "resolution": [got.backend, got.fuse, got.tile,
                                         got.source],
            "launches": counts, "gpx_per_s_first": px / secs,
            "gpx_per_s_warm": px / warm, "gpx_per_s_resident": px / resident}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    try:
        import parallel_convolution_tpu_torch as port
        from parallel_convolution_tpu_torch.ops import _build, stencil
        from parallel_convolution_tpu_torch.ops.filters import get_filter
        from parallel_convolution_tpu_torch.utils import imageio
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    if Path(port.__file__).resolve().parent.parent != here:
        # An installed copy elsewhere is not the checkout under test.
        print(f"chip_smoke: the port imported from {port.__file__}, not from "
              f"the checkout at {here}", file=sys.stderr)
        return 1

    try:
        card = card_line()
        print(f"card: {card}")
        dev = torch.device("cuda", 0)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")

        t0 = time.perf_counter()
        built = _build.build_all()
        each = ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items())
        print(f"build: {time.perf_counter() - t0:.2f} s "
              f"({each or 'up to date'})")
        for name in _build.SOURCES:
            _build.load_library(name)
        print_ptxas()

        check_kernels(dev)
        check_rdma_kernels(dev)
        probe = probe_phase(dev)

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            totals, rows, refs = main_paths(dev, Path(tmp))
            auto_rows = auto_paths(dev, Path(tmp), refs, rows, totals)
            picks = tune_auto_grids(Path(tmp))
            tuned = measured_tune(dev, Path(tmp), refs, totals)

        rgb = imageio.generate_test_image(*RGB_HW, "rgb", seed=1)
        grey8k = imageio.generate_test_image(*BIG_HW, "grey", seed=2)
        blur3, edge5 = get_filter("blur3"), get_filter("edge5")
        k1 = time_step(rgb, blur3, "f32", dev)
        k1_rows = {"stencil_step rgb blur3 bf16": time_step(rgb, blur3, "bf16",
                                                            dev),
                   "stencil_step rgb blur3 u8": time_step(rgb, blur3, "u8",
                                                          dev),
                   "stencil_step rgb blur3 f32 sep": time_step(
                       rgb, blur3, "f32", dev, separable=True),
                   "stencil_step grey8k edge5 f32": time_step(grey8k, edge5,
                                                              "f32", dev)}
        k2 = time_fused(rgb, blur3, "bf16", 32, True, dev)
        k2_edge = time_fused(grey8k, edge5, "bf16", 32, True, dev)
        grey = imageio.generate_test_image(*RGB_HW, "grey", seed=2)
        k3 = time_rdma("rdma_block", grey, blur3, "u8", GREY_GRID, 8, dev)
        k3_t1 = time_rdma("rdma_block", grey, blur3, "u8", GREY_GRID, 1, dev)
        k4 = time_rdma("rdma_tiled", rgb, blur3, "bf16", (2, 2), 32, dev)
        k4_t1 = time_rdma("rdma_tiled", rgb, blur3, "bf16", (2, 2), 1, dev)
        chunk8k = time_rdma_chunk(grey8k, edge5, "bf16", (4, 4), 32, dev)
        for name, t in (("stencil_step rgb blur3 f32", k1),
                        *k1_rows.items(),
                        ("fused_iterate rgb blur3 bf16 T=32", k2),
                        ("fused_iterate grey8k edge5 bf16 T=32", k2_edge),
                        ("rdma_block grey 16x16 blur3 u8 T=8", k3),
                        ("rdma_block grey 16x16 blur3 u8 T=1", k3_t1),
                        ("rdma_tiled rgb 2x2 blur3 bf16 T=32", k4),
                        ("rdma_tiled rgb 2x2 blur3 bf16 T=1", k4_t1),
                        ("fused_rdma_step grey8k 4x4 edge5 bf16 T=32", chunk8k)):
            print(f"time {name}: " + json.dumps(t))
        for row in rows:
            print("end to end: " + json.dumps(row))
        for row in auto_rows:
            print("end to end auto: " + json.dumps(row))
        print("measured tune: " + json.dumps(tuned))
        host = time_host_calls(dev)
        print("time host calls: " + json.dumps(host))
        from parallel_convolution_tpu_torch.tuning import costmodel

        measured = hardware_constants(k1, k2, k4, probe["op_price"], host)
        committed = {k: getattr(costmodel.H100, k) for k in measured}
        print("hardware model: " + json.dumps(
            {"measured": measured, "committed": committed, "card": card}))

        kernels = []
        for name, t in (("stencil_step", k1), ("fused_iterate", k2),
                        ("rdma_block", k3), ("rdma_tiled", k4)):
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": totals[name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        for name, e in probe["entries"].items():
            b_ms, b_by = e["bound"]
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": e["launches"],
                "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                "plain_ms": e["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": e["library_ms"]})
        print("fraction of bound: " + json.dumps(
            {k["name"]: k["bound_ms"] / k["ms"] for k in kernels}))
        print(f"card: {card}")
        print(json.dumps({"kernels": kernels}))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
