#!/usr/bin/env python3
"""On-card proof of parallel_convolution_tpu_torch: build, check, drive, time.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``parallel_convolution_tpu_torch/csrc`` with
   nvcc (every part of every library at once) and the g++ baseline of
   ``native/`` (so that every file read of the run goes through the native
   reader, whatever an earlier run left built), and print the build seconds,
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
4f. K2's interior split (``interior_split=True``, the 9-patch launch),
   counted into the kernels line: ``ConvolutionModel`` on the RGB
   1920x2520 image (blur3 ``cuda_sep`` bf16 fuse 32) at 1x1 and 2x2 and
   on the 8192x8192 grey edge5 image (``cuda`` fuse 8) at 4x4, each with
   and without the split: the two byte-equal and equal to ``shifted``,
   K2's launches as the plan says (more than the single launch's, at
   most 9 a level group and block), both runs' resident seconds;
4g. rank-3 volumes (plain PyTorch: the JAX package's forms have no Pallas
   kernel): fd25 at 512^3 (two fields, 1.07 GB), zero boundary, 40 sweeps
   at fuse 4 through ``run --rank 3 --depth 512`` from a seeded raw file
   under ``build/``, at 1x1 and 2x2, the outputs byte-equal (the peak
   reckoned first and measured); fd7, wave and grayscott at 512^3 x 100
   sweeps, 1x1 against 2x2 bitwise; the fd7 / fd25 ``_stack`` twins and
   fuse 1 against fuse 4 bitwise; every form at 64^3 x 3 sweeps on 2x2,
   zero and periodic, within 2e-5 of the port's ``oracle3``;
   ``volume_converge`` with fd7 on the periodic manufactured problem of
   ``scripts/volume_smoke.py`` at N = 64 to tol 1e-5 (cap 5000), its
   iterations, readbacks and stop, the chunks byte-equal to the fixed
   count; one sweep of every form at 512^3 timed with CUDA events, beside
   the byte bound (``costmodel.volume_bytes_per_cell_iter`` over this
   run's ``hbm_gbps``), the least bytes over the data sheet's rate, the
   cost model's prediction and the peak device memory;
4b. run to convergence (``sharded_converge``), counted into the kernels
   line: BASELINE config 5 (``JacobiSolver``: jacobi3, tol 1e-3, f32,
   ``cuda`` fuse 9, check every 10) on a seeded normal 32768x32768 field,
   capped at 200 iterations, against the plain ``shifted`` converge on the
   card: the same iteration count, and through ``sharded_converge_stream``
   every chunk's diff (the stop quantity, since the cap stops both runs),
   field and diffs bit-equal (jacobi3's taps are dyadic); with the
   peak device memory, K2 / K1 / the diff timed at that size; ``run
   --converge 0.5 --check-every 10`` on the grey 1920x2520 image with
   ``--fast`` and with ``--backend cuda_rdma --mesh 16x16 --storage u8
   --fuse 8`` (K3), each converged, byte-equal to ``shifted`` and with its
   iteration count; ``sharded_converge_stream`` there, one yield and one
   readback a chunk, its last image ``sharded_converge``'s bytes;
4h. blocks on separate devices (ROADMAP item 10), after phase 4b,
   counted into the kernels line: the number of cards and a slot map
   printed first; BASELINE config 2 (RGB 1920x2520 blur3, 2x2 on 4 slots
   of one card) through ``ConvolutionModel`` with ``cuda_rdma`` bf16 fuse
   32 (``col_mode`` packed and strided: one K4 launch per slot a chunk,
   K2 per slot for the later level groups, a pack per slot when packed),
   ``cuda_sep`` bf16 fuse 32 and ``cuda`` f32 fuse 1; the 256-rank split
   (grey 1920x2520, 16x16 on 256 slots, u8 fuse 8: K3 per slot) with both
   transports; BASELINE config 3 (8192x8192 edge5, 4x4 on 16 slots)
   through ``run --device <16 slots>`` with ``cuda_rdma`` (both
   transports) and ``cuda``; ``run --converge 0.5 --check-every 10`` on
   config 1's image at 2x2 slots with ``cuda_rdma`` and ``cuda`` (2730
   iterations) -- each byte-equal to the one-card form and to ``shifted``,
   its resident seconds beside the one-card form's; a 1 ms spin queued on
   one slot's stream before every chunk of config 2's ``cuda_rdma`` run
   leaving its bytes unchanged (the barrier); the per-slot K3 / K4 and the
   pack at those shapes against their plain versions, timed over the
   grid; the pack alone at each of the three shapes (one slot's launches
   queued ahead on its stream, beside an empty kernel's there, its vector
   width and byte bound, and the parent's time where it was measured);
   the column-transport probe (the per-slot launches reading the
   staging against reading in place, the pack, a barrier wait on the
   host) that ``costmodel.pick_col_mode`` reads.  With two cards or more
   the paths run again round-robin over the cards (``--device all``),
   peer access on;
4i. the overlapped pipeline (ROADMAP item 10b), after phase 4h, counted
   into the kernels line: BASELINE config 2 (2x2 on 4 slots, bf16 fuse
   32) and the 256-rank split (16x16 on 256 slots, u8 fuse 8: K3) through
   ``ConvolutionModel(overlap=True)``, BASELINE config 3 (4x4 on 16
   slots) through ``run --overlap on --device <16 slots>``, and ``run
   --converge 0.5 --overlap on`` on config 1's image at 2x2 slots, each
   with both column transports and in three schedules: overlapped and
   partitioned (each slot's K3 / K4 region by region, the interior with
   no wait; the launches as ``rdma.overlap_regions`` counts them),
   overlapped in the JAX phase order (``partitioned=False``) and
   serialized; each byte-equal to the serialized per-slot run, the
   one-card form and ``shifted``, the resident seconds of each schedule
   printed; the skew check (a 10 ms spin on slot 0 before every chunk of
   config 2) with overlap on, both schedules and transports; the region
   launches of K3 and K4 at the paths' first level groups, assembled and
   held against the plain first group, timed beside the same group as
   one launch a slot.  With two cards or more the paths run again
   round-robin over the cards;
4d. multigrid (``--solver multigrid``), counted into the kernels line:
   BASELINE config 5's field (32768x32768, jacobi3, tol 1e-3, f32) under
   the Jacobi run's budget of 200 fine-grid work units, through
   ``JacobiSolver(solver="multigrid")`` with ``cuda`` at 1x1 (K1 on every
   level) from a host array and resident on the card, at 2x2 (bitwise the
   1x1 field), with ``cuda_rdma`` at 4x4 (K4 on the fine levels, K3 at
   T = 1 on the small blocks, the coarsest level on a 2x2 sub-grid) and
   the plain ``shifted`` run: the same residual every cycle and the same
   field bit for bit (jacobi3's taps and the transfers' weights are
   dyadic), max |field| printed; each run's launches equal to its
   schedule's per-cycle launches times its cycles, one readback a cycle;
   cycles, work units, the residual of every cycle, the level grids and
   shapes, seconds first and resident, the predicted against the measured
   seconds a cycle and the peak device memory printed, beside the Jacobi
   run's work units at the same cap; ``run --converge 0.5 --solver
   multigrid`` on the grey 1920x2520 image with ``cuda`` and with
   ``cuda_rdma`` at 16x16 (coarse levels on 8x8, 4x4 and 2x2 sub-grids),
   each saying the ``shifted`` CLI run's cycles and work units, its bytes
   equal to its;
4e. the host tools, after phase 4c:
   ``serial --impl native`` on BASELINE config 1 (grey 1920x2520 blur3,
   100 iterations) byte-equal to the NumPy oracle, with the host CPU's
   model and OpenMP threads, and the one-thread baseline
   (``bench_oracle_proxy``); ``bench`` on RGB 1920x2520 ``cuda_sep``
   bf16 fuse 32 (one JSON row with the card's name and power limit);
   ``bench_halo_p50`` at BASELINE config 2's block (960x1260 RGB on 2x2,
   r = 1) and config 3's (2048x2048 grey on 4x4, r = 2); ``convert`` and
   ``info`` once each;
4c. the huge-image workflow, after phase 7, each run counted into the
   kernels line: BASELINE config 4 (3x3 blur, 65536x65536 RGB, 100
   iterations) from a seeded file under ``build/`` (the disk and RAM found
   are printed; a disk too small for the input and one output shrinks the
   image, printed as a cut) through ``run --sharded-io --storage u8 --fuse
   32`` at 1x1 ``cuda_sep`` (7 K2 launches) and at 4x4 ``cuda_rdma`` (K4
   and K2), its bands read through the native reader, each with its
   first-run seconds and Gpx/s, the host's read + copy in and copy out +
   write, the kernels' time, the peak device memory and the host's
   resident-set growth (under 1 GB: bands, never a block);
   nine 256x256 output windows (corners, centre, far edges, the 4x4 seams)
   read back from the written file must equal the NumPy oracle on input
   crops reaching 100 pixels beyond them, and the two outputs must be
   CRC32-equal band by band; K2 and K4 timed at those shapes beside their
   bounds.  On BASELINE config 3's image (8192x8192 edge5): ``run
   --checkpoint --checkpoint-every 25 --backend cuda_rdma --mesh 4x4`` in
   a child process that dies with an injected fault in its second
   snapshot, resumed here from iteration 25 (75 K4 launches), byte-equal to
   an uninterrupted ``--sharded-io`` run and to ``shifted``, and a second
   torn run resumed on ``--mesh 2x2`` (the reshard warning, the same
   bytes), ``save_state`` / ``load_state`` timed; ``--fallback`` without a
   fault keeping ``cuda_rdma`` and ``cuda_sep`` (the probe's launches
   counted), with ``PCTPU_FAULTS=backend_compile:1`` degrading
   ``cuda_rdma`` to ``cuda`` (warned, named in the summary line, the same
   bytes), with every tier refused stopping at ``cuda`` and raising (no
   plain run, no launch), and 5b's refused launch named by the runtime and
   classified transient, a canary launch after it passing;
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
   a ``clean_refusal``) and is timed beside ``torch.add`` both per call and
   queued ahead (the device's time), 5c ``rdma_ladder`` takes K4 apart construct by
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
9. the ``kernels`` JSON line (twelve kernels: K1-K4, the per-slot K3 /
   K4, the pack, their region launches, the three probes), then the last
   line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
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
CONVERGE_HW = (32768, 32768)  # BASELINE config 5
# Config 5's one cut: an iteration cap.  jacobi3 on a normal field leaves
# the modes near the checkerboard, whose factor is close to -1, alternating,
# so the diff decays slowly and tol 1e-3 is not reached within it.
CONVERGE_MAX_ITERS = 200
CONVERGE_CLI_MAX = 5000    # the CLI's converges (about 2730 iterations)
MG_RDMA_GRID = (4, 4)      # config 5's cuda_rdma multigrid run
CONFIG4_SIDE = 65536       # BASELINE config 4: 65536x65536 RGB, 12.9 GB
WINDOW = 256               # config 4's oracle windows
HOST_GROWTH_LIMIT = 1 << 30  # config 4: at most 16 bands of host memory
CKPT_EVERY = 25            # the checkpoint phase's snapshots
CKPT_KILL = 20             # shard write 20: in the second snapshot at 4x4
VOLUME_N = 512             # the volume phase's cube: 2 fields, 1.07 GB
VOLUME_SWEEPS = 100        # fd7 / wave / grayscott, 1x1 against 2x2
VOLUME_FD25_SWEEPS = 40    # fd25 through run --rank 3, fuse 4
VOLUME_TOL = 1e-5          # fd7 on the N = 64 manufactured problem
VOLUME_CAP = 5000
VOLUME_CHECK = 50
REPLACES = {
    "stencil_step": "parallel_convolution_tpu/ops/pallas_stencil.py:405",
    "fused_iterate": "parallel_convolution_tpu/ops/pallas_stencil.py:736",
    "rdma_block": "parallel_convolution_tpu/ops/pallas_rdma.py:1226",
    "rdma_tiled": "parallel_convolution_tpu/ops/pallas_rdma.py:1316,1330",
    "rdma_block_slot": "parallel_convolution_tpu/ops/pallas_rdma.py:1226",
    "rdma_tiled_slot": "parallel_convolution_tpu/ops/pallas_rdma.py:1316,1330",
    "rdma_pack": "parallel_convolution_tpu/ops/pallas_rdma.py:743",
    "rdma_block_region": "parallel_convolution_tpu/ops/pallas_rdma.py:303,486",
    "rdma_tiled_region": "parallel_convolution_tpu/ops/pallas_rdma.py:619,884",
    "op_chain": "scripts/vpu_op_probe.py:102",
    "smem_probe": "scripts/helper_crash_probe.py:100",
    "rdma_ladder": "scripts/tiled_repro_probe.py:101",
}
# The pack and 5b of the parent commit of their redesign, measured by
# parallel_convolution_tpu_torch/probes/pack_ab.py on an H100 80GB HBM3 at
# 700 W beside the redesigned kernels (the means of its parent turns):
# device_ms queued ahead, host_ms back to back, slot_launch_ms every slot
# between a fork and a join.
PACK_PARENT_MS = {
    "config 2": {"device_ms": 0.004974848031997681,
                 "host_ms": 0.013226848125457763,
                 "slot_launch_ms": 0.10507519721984863},
    "config 3": {"device_ms": 0.006008319854736328,
                 "host_ms": 0.012163551807403564,
                 "slot_launch_ms": 0.45226079940795905},
    "grey 16x16": {"device_ms": 0.003482143998146057,
                   "host_ms": 0.013566751956939698,
                   "slot_launch_ms": 7.150134887695312},
}
SMEM_PARENT_MS = {"ms": 0.028789119720458986,
                  "device_ms": 0.002914799898862839}
# The one-card kernels, then the per-slot forms of K3 / K4 and the pack
# (a grid of slots, phase 4h), then their region launches (the overlapped
# pipeline, phase 4i).
ONE_CARD_KERNELS = ("stencil_step", "fused_iterate", "rdma_block",
                    "rdma_tiled")
KERNELS = ONE_CARD_KERNELS + ("rdma_block_slot", "rdma_tiled_slot",
                              "rdma_pack", "rdma_block_region",
                              "rdma_tiled_region")
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
    "rdma_block_slot": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "rdma_tiled_slot": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "rdma_pack": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "rdma_block_region": "parallel_convolution_tpu_torch/csrc/rdma.cu",
    "rdma_tiled_region": "parallel_convolution_tpu_torch/csrc/rdma.cu",
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
            want_counts = {k: 0 for k in KERNELS}
            want_counts.update({"rdma_block": int(plan.kernel == "block"),
                                "rdma_tiled": int(plan.kernel == "tiled"),
                                "fused_iterate": 4 * (groups - 1)})
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
    """K2 as the fused chunk of a fuse=T run on a 1x1 grid calls it, and
    as its interior split (``split_ms``)."""
    import torch

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
    # The same call as the interior split's 9-patch launches (a 1x1
    # grid's block: offset (0, 0)): the same bits, its own time.
    split = dict(kw, interior_split=True, block_off=(0, 0))
    before = stencil.fused_iterate.launches
    check(torch.equal(stencil.fused_iterate(*args, **split), got),
          f"K2's interior split at {tuple(p.shape)} differs from one launch")
    split_launches = stencil.fused_iterate.launches - before
    split_ms = cuda_ms(lambda: stencil.fused_iterate(*args, **split), reps=10)
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
                split_launches_per_call=split_launches, split_ms=split_ms,
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

    check(all(totals[k] for k in ONE_CARD_KERNELS),
          f"a kernel never ran on the main path: {totals}")
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
# Phase 4f: K2's interior split (ROADMAP item 2)
# ---------------------------------------------------------------------------


def split_launches(filt, fuse: int, grid_shape, valid_hw,
                   tile=None) -> dict:
    """Launches of one ``ITERS``-iteration ``cuda`` / ``cuda_sep`` run with
    the interior split: for every block, every fused step's level groups,
    each the patches of its offset class's plan (``stencil.
    launch_patches``), and K1 once a block for a 1-level tail."""
    from parallel_convolution_tpu_torch.ops import stencil

    R, C = grid_shape
    bh, bw = (-(-n // g) for n, g in zip(valid_hw, grid_shape))
    r = filt.radius
    classes = (stencil.axis_offset_classes(R, bh),
               stencil.axis_offset_classes(C, bw))

    def per_step(T):
        th, tw, groups = stencil.fused_plan(r, T, (bh, bw), tile)
        n = 0
        for i in range(R):
            for j in range(C):
                off = (classes[0][stencil.axis_class_index(i, R)],
                       classes[1][stencil.axis_class_index(j, C)])
                left = T
                for g in groups:
                    left -= g
                    oh, ow = bh + 2 * r * left, bw + 2 * r * left
                    n += len(stencil.launch_patches(
                        valid_hw, (min(th, oh), min(tw, ow)), r * g,
                        (oh, ow), off, r * left))
        return n

    n_chunks, rem = divmod(ITERS, fuse)
    return {"stencil_step": R * C if rem == 1 else 0,
            "fused_iterate": n_chunks * per_step(fuse)
            + (per_step(rem) if rem > 1 else 0),
            "rdma_block": 0, "rdma_tiled": 0}


def interior_split_phase(dev, refs: dict, totals: dict) -> list:
    """The main path with and without ``interior_split``: RGB 1920x2520
    blur3 ``cuda_sep`` bf16 fuse 32 at 1x1 and 2x2, and the 8192x8192 grey
    edge5 image ``cuda`` fuse 8 at 4x4.  Each pair byte-equal and equal to
    ``shifted``; K2's launches as the plan says (at most 9 a level group
    and block, more than the single launch's); both runs' resident
    seconds.  The launches count into ``totals``."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import imageio

    rows = []
    cases = (
        ("rgb 1920x2520 blur3 cuda_sep bf16 fuse 32", refs["rgb"],
         refs["rgb_ref"], "blur3", (1, 1),
         dict(backend="cuda_sep", storage="bf16", fuse=32)),
        ("rgb 1920x2520 blur3 cuda_sep bf16 fuse 32", refs["rgb"],
         refs["rgb_ref"], "blur3", (2, 2),
         dict(backend="cuda_sep", storage="bf16", fuse=32)),
        ("grey 8192x8192 edge5 cuda f32 fuse 8", refs["greys"]["edge5"],
         refs["grey_refs"]["edge5"], "edge5", (4, 4),
         dict(backend="cuda", storage="f32", fuse=8)))
    for label, img, ref, name, gshape, kw in cases:
        filt = get_filter(name)
        grid = make_grid(gshape, dev)
        hw = img.shape[:2]
        px = hw[0] * hw[1] * (img.shape[2] if img.ndim == 3 else 1)
        label = f"{label} grid {gshape[0]}x{gshape[1]}"
        planar = torch.from_numpy(
            imageio.interleaved_to_planar(img).copy()).to(
            device=dev, dtype=torch.float32)
        block = tuple(-(-n // g) for n, g in zip(hw, gshape))
        plain = {k: v * gshape[0] * gshape[1] for k, v in
                 expected_launches(filt, kw["fuse"], block).items()}
        split = split_launches(filt, kw["fuse"], gshape, hw)
        check(plain["fused_iterate"] < split["fused_iterate"]
              <= 9 * plain["fused_iterate"],
              f"{label}: {split['fused_iterate']} split launches against "
              f"{plain['fused_iterate']} single ones")
        row = {"path": label, "card": card_line()}
        outs = {}
        for key, on, expect in (("unsplit", False, plain),
                                ("split", True, split)):
            model = ConvolutionModel(name, grid=grid, interior_split=on,
                                     **kw)
            out, counts, secs = drive(f"{label} interior_split={on}",
                                      lambda: model.run_image(img, ITERS),
                                      expect, px)
            for k, v in counts.items():
                totals[k] += v
            outs[key] = out
            resident = [host_seconds(lambda: model.run_planar(
                planar, ITERS))[1] for _ in range(2)]
            row[key] = {"launches": counts, "seconds_first": secs,
                        "seconds_resident": resident,
                        "gpx_per_s_resident": px * ITERS / min(resident)
                        / 1e9}
        check(np.array_equal(outs["split"], outs["unsplit"]),
              f"{label}: the split run differs from the single launch")
        check(np.array_equal(outs["split"], ref),
              f"{label}: the split run differs from shifted")
        row["split_over_unsplit_resident"] = (
            min(row["split"]["seconds_resident"])
            / min(row["unsplit"]["seconds_resident"]))
        print("interior split: " + json.dumps(row))
        rows.append(row)
        del planar
    return rows


# ---------------------------------------------------------------------------
# Phase 4g: rank-3 volumes (ROADMAP item 6)
# ---------------------------------------------------------------------------


def volume_state(name: str, shape, seed: int):
    """The seeded (2, D, H, W) f32 start of a form: [0, 1) noise, or for
    Gray-Scott the classic bounded start (U = 1, V = 0, a perturbed blob;
    raw noise leaves the reaction's stable basin at dt = 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if name != "grayscott":
        return rng.random((2, *shape), dtype=np.float32)
    vol = 0.01 * rng.random((2, *shape), dtype=np.float32)
    vol[0] += 1.0
    D, H, W = shape
    blob = (slice(None), slice(H // 2 - H // 8, H // 2 + H // 8),
            slice(W // 2 - W // 8, W // 2 + W // 8))
    vol[0][blob] -= 0.5
    vol[1][blob] += 0.25
    return vol


def reckon_volume_peak(shape, r: int, fuse: int, grid_shape,
                       terms: int) -> int:
    """The peak device bytes reckoned for one fused volume step on the
    stacked grid: the state, its padded exchange, ``terms`` one-field
    temporaries of the padded extent (the sum, the scratch product, the
    damped update's; every term for a _stack twin) and the merged
    output."""
    D, H, W = shape
    R, C = grid_shape
    d = r * fuse
    field = 4 * D * H * W
    padded = 4 * (D + 2 * d) * (H + 2 * d * R) * (W + 2 * d * C)
    return 2 * field + 2 * padded + terms * padded + 2 * padded


def volume_phase(dev, work: Path) -> dict:
    """Rank-3 volumes on the card (all plain PyTorch: the JAX package's
    forms have no Pallas kernel).  fd25 at 512^3 (two fields, 1.07 GB),
    zero boundary, 40 sweeps at fuse 4 through ``run --rank 3 --depth
    512`` from a raw file under ``build/``, at 1x1 and 2x2, the outputs
    byte-equal; fd7, wave and grayscott at 512^3 x 100 sweeps, 1x1 against
    2x2 bitwise; the fd7 / fd25 _stack twins and fuse 1 against fuse 4
    bitwise; every form at 64^3 x 3 sweeps on 2x2, zero and periodic,
    against the port's ``oracle3`` at atol 2e-5; ``volume_converge`` with
    fd7 on the periodic manufactured problem at N = 64 (tol 1e-5, cap
    5000), its chunks byte-equal to the fixed count; a sweep of each form
    timed with CUDA events, with its peak device memory."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils.config import (
        VOLUME_FORMS, VOLUME_RADII,
    )
    from parallel_convolution_tpu_torch.volumes import driver, oracle3

    out = {"card": card_line(), "forms": {}}
    g1, g2 = make_grid((1, 1), dev), make_grid((2, 2), dev)
    n = VOLUME_N
    shape = (n, n, n)

    # fd25 through the CLI, 1x1 and 2x2, from a raw file.
    work.mkdir(parents=True, exist_ok=True)
    src = work / "fd25.raw"
    vol = volume_state("fd25", shape, 31)
    vol.tofile(src)
    reckoned = reckon_volume_peak(shape, VOLUME_RADII["fd25"], 4, (1, 1), 4)
    print(f"volume fd25 {n}^3 fuse 4: reckoned peak {reckoned / 1e9:.2f} GB "
          f"(state {vol.nbytes / 1e9:.3f} GB)")
    cli = {}
    for spec in ("1x1", "2x2"):
        dst = work / f"fd25.{spec}.raw"
        argv = ["run", str(src), str(n), str(n), str(VOLUME_FD25_SWEEPS),
                "grey", "-o", str(dst), "--rank", "3", "--depth", str(n),
                "--filter", "fd25", "--fuse", "4", "--mesh", spec]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        rc, secs = host_seconds(lambda: cli_main(argv))
        check(rc == 0, f"run --rank 3 fd25 --mesh {spec}: exit {rc}")
        cli[spec] = {"seconds": secs, "peak_bytes":
                     torch.cuda.max_memory_allocated(dev) - base}
    a = np.fromfile(work / "fd25.1x1.raw", np.float32)
    b = np.fromfile(work / "fd25.2x2.raw", np.float32)
    check(a.size == vol.size and np.isfinite(a).all(),
          "run --rank 3 fd25: the output is not the input's size, or "
          "not finite")
    check(a.tobytes() == b.tobytes(),
          "run --rank 3 fd25: 1x1 and 2x2 outputs differ")
    out["cli_fd25"] = dict(cli, sweeps=VOLUME_FD25_SWEEPS, fuse=4,
                           reckoned_peak_bytes=reckoned)
    for p in work.glob("fd25*.raw"):
        p.unlink()
    del a, b

    def run(state, name, iters, grid, **kw):
        return driver.volume_iterate(state, name, iters, grid=grid, **kw)

    # fd7, wave, grayscott at 512^3 x 100 sweeps: 1x1 against 2x2.
    for name in ("fd7", "wave", "grayscott"):
        vol = volume_state(name, shape, 37)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        x1, s1 = host_seconds(lambda: run(vol, name, VOLUME_SWEEPS, g1))
        peak = torch.cuda.max_memory_allocated(dev)
        x2, s2 = host_seconds(lambda: run(vol, name, VOLUME_SWEEPS, g2))
        check(x1.device == x2.device == dev
              and bool(torch.isfinite(x1).all()),
              f"volume {name}: not on {dev}, or not finite")
        check(torch.equal(x1, x2), f"volume {name}: 1x1 and 2x2 differ")
        out["forms"][name] = {"sweeps": VOLUME_SWEEPS, "seconds_1x1": s1,
                              "seconds_2x2": s2, "peak_bytes": peak}
        del x1, x2

    # The twins and fusion, bitwise at 512^3.
    vol = volume_state("fd7", shape, 41)
    for base, sweeps in (("fd7", 8), ("fd25", 2)):
        torch.cuda.empty_cache()
        x = run(vol, base, sweeps, g2)
        torch.cuda.reset_peak_memory_stats(dev)
        y = run(vol, base + "_stack", sweeps, g2)
        check(torch.equal(x, y), f"volume {base}_stack differs from {base}")
        out["forms"].setdefault(base + "_stack", {})["peak_bytes"] = (
            torch.cuda.max_memory_allocated(dev))
        del x, y
    for name, fuse in (("fd7", 4), ("fd25", 4), ("wave", 4)):
        x = run(vol, name, 8, g1, fuse=1)
        y = run(vol, name, 8, g1, fuse=fuse)
        check(torch.equal(x, y), f"volume {name}: fuse 1 and {fuse} differ")
        del x, y
    out["bitwise"] = ("1x1 = 2x2 (fd25 CLI, fd7, wave, grayscott); "
                      "fd7 / fd25 = their _stack twins; fuse 1 = fuse 4 "
                      "(fd7, fd25, wave)")

    # Every form against the oracle at 64^3 on 2x2, both boundaries.
    worst = 0.0
    for boundary in ("zero", "periodic"):
        for name in VOLUME_FORMS:
            small = volume_state(name, (64, 64, 64), 43)
            got = run(small, name, 3, g2, boundary=boundary).cpu().numpy()
            err = float(np.abs(got - oracle3.run_oracle(
                small, name, 3, boundary)).max())
            check(err <= 2e-5, f"volume {name} {boundary}: {err} from "
                  "oracle3 (atol 2e-5)")
            worst = max(worst, err)
    out["oracle_64_max_abs_err"] = worst

    # fd7 to tol on the periodic manufactured problem (scripts/
    # volume_smoke.py): u0 = 0, f = 3 (2 pi)^2 u* h^2, u* a sine product.
    N = 64
    h = 1.0 / N
    s = np.sin(2.0 * np.pi * np.arange(N) * h)
    ustar = np.einsum("i,j,k->ijk", s, s, s)
    problem = np.stack([np.zeros_like(ustar), 3.0 * (2.0 * np.pi) ** 2
                        * ustar * h * h]).astype(np.float32)
    driver.volume_converge.readbacks = 0
    (field, iters, diff), secs = host_seconds(lambda: driver.volume_converge(
        problem, "fd7", tol=VOLUME_TOL, max_iters=VOLUME_CAP,
        check_every=VOLUME_CHECK, grid=g2, boundary="periodic", fuse=4))
    fixed = run(problem, "fd7", iters, g2, boundary="periodic")
    check(torch.equal(field, fixed),
          "volume_converge: the chunks differ from the fixed count")
    err = float(np.abs(field[0].double().cpu().numpy() - ustar).max())
    out["converge_fd7_64"] = {
        "iters": iters, "diff": diff, "tol": VOLUME_TOL, "cap": VOLUME_CAP,
        "stopped_by": "tol" if diff < VOLUME_TOL else "cap",
        "readbacks": driver.volume_converge.readbacks, "seconds": secs,
        "max_err_vs_u_star": err}
    check(diff < VOLUME_TOL, f"volume_converge: not converged in {iters}")

    # One sweep of each form at 512^3 on 1x1, by CUDA events.
    from parallel_convolution_tpu_torch.volumes import forms

    for name in VOLUME_FORMS:
        xs, valid = driver.prepare_volume(volume_state(name, shape, 47), g1)
        stepf = forms.build_volume_step(name, (1, 1), n, valid, (n, n), 1,
                                        "zero")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ms = cuda_ms(lambda: stepf(xs), reps=3, warmup=1)
        row = out["forms"].setdefault(name, {})
        row.update(ms_per_sweep=ms, cells=n ** 3, fields=2,
                   step_peak_bytes=torch.cuda.max_memory_allocated(dev)
                   - base)
        del xs
    torch.cuda.empty_cache()
    return out


def volume_bounds(vol: dict, hbm_gbps: float) -> None:
    """Each form's sweep beside the cost model: the byte bound
    (``volume_bytes_per_cell_iter`` over this run's ``hbm_gbps``), the
    least bytes (both fields read and written once) over the data sheet's
    rate, and ``predict_volume_seconds_per_cell_iter`` on the committed
    H100 model, at 1x1."""
    from parallel_convolution_tpu_torch.tuning import costmodel
    from parallel_convolution_tpu_torch.utils.config import VOLUME_RADII

    for name, row in vol["forms"].items():
        if "ms_per_sweep" not in row:
            continue
        cells = row["cells"]
        row["bound_ms"] = (costmodel.volume_bytes_per_cell_iter("f32", 2)
                           * cells / (hbm_gbps * 1e9) * 1e3)
        row["least_bytes_ms"] = 16.0 * cells / HBM_BYTES_PER_S * 1e3
        n = round(cells ** (1 / 3))
        row["predicted_ms"] = costmodel.predict_volume_seconds_per_cell_iter(
            (1, 1), (n, n), n, VOLUME_RADII[name], 1, name,
            costmodel.H100) * cells * 1e3
        row["fraction_of_bound"] = row["bound_ms"] / row["ms_per_sweep"]
        row["hbm_gbps"] = hbm_gbps


# ---------------------------------------------------------------------------
# Phase 4b: run to convergence
# ---------------------------------------------------------------------------


def expected_converge_launches(filt, backend: str, fuse: int,
                               check_every: int, iters: int, max_iters: int,
                               grid_shape, block_hw) -> dict:
    """Launches of a convergence run that ran ``iters`` iterations: per
    chunk of n, ``(n-1)//f`` fused steps, ``(n-1)%f`` single ones and the
    pair step, f the run's fuse clamped to the chunk (step.py)."""
    from parallel_convolution_tpu_torch.ops import rdma, stencil

    counts = {k: 0 for k in KERNELS}
    nb = grid_shape[0] * grid_shape[1]

    def add(T, times):
        if times == 0:
            return
        if backend == "cuda_rdma":
            plan = rdma.rdma_plan(filt.radius, T, block_hw)
            counts["rdma_" + plan.kernel] += times
            counts["fused_iterate"] += times * nb * (len(plan.groups) - 1)
        elif T == 1:
            counts["stencil_step"] += times * nb
        else:
            groups = stencil.fused_plan(filt.radius, T, block_hw)[2]
            counts["fused_iterate"] += times * nb * len(groups)

    run_fuse = max(1, min(fuse, check_every - 1))
    done = 0
    while done < iters:
        n = min(check_every, max_iters - done)
        f = max(1, min(run_fuse, max(1, n - 1)))
        fused = (n - 1) // f if f > 1 and n > 1 else 0
        add(f, fused)
        add(1, n - 1 - fused * f + 1)
        done += n
    return counts


def converge_phase(dev, tmp: Path, totals: dict, keep: dict) -> list:
    """BASELINE config 5 at full size on one card, ``run --converge``
    through the CLI (--fast, and cuda_rdma at 16x16: K3), and the stream;
    each against the plain ``shifted`` converge on the card, its launches
    counted into ``totals``.  Config 5's field stays on the card in
    ``keep["config5"]`` for the multigrid phase (the same problem)."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import JacobiSolver
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import halo, step
    from parallel_convolution_tpu_torch.utils import imageio
    from parallel_convolution_tpu_torch.utils.bench import converge_input

    rows = []

    def counted(label, fn, expect_of):
        """``fn()`` with the counters at 0 before and read after; its
        launches checked against ``expect_of(result)`` and added to the
        totals."""
        def readbacks():
            return (step.sharded_converge.readbacks
                    + step.sharded_converge_stream.readbacks)

        stencil.reset_launch_counts()
        reads = readbacks()
        out, secs = host_seconds(fn)
        counts = stencil.launch_counts()
        reads = readbacks() - reads
        want = expect_of(out)
        check(counts == want,
              f"{label}: launches {counts}, expected {want}")
        check(any(counts.values()), f"{label}: no kernel launched")
        for k, v in counts.items():
            totals[k] += v
        print(f"converge {label}: launches {counts}, {secs:.4f} s, "
              f"{reads} readbacks")
        return out, counts, secs, reads

    # (a) BASELINE config 5: jacobi3 to tol 1e-3 on a normal field at
    # 32768x32768, one card, every 10 iterations a check.
    jacobi3 = get_filter("jacobi3")
    H, W = CONVERGE_HW
    t0 = time.perf_counter()
    x = converge_input(CONVERGE_HW, 1, seed=0)
    make_s = time.perf_counter() - t0
    solver = JacobiSolver("jacobi3", tol=1e-3, max_iters=CONVERGE_MAX_ITERS,
                          check_every=10, backend="cuda", quantize=False,
                          storage="f32", fuse=9, device=dev)
    label = f"config 5 jacobi3 {H}x{W} f32 cuda fuse 9 check_every 10"
    torch.cuda.reset_peak_memory_stats(dev)

    def expect5(res):
        return expected_converge_launches(jacobi3, "cuda", 9, 10, res[1],
                                          CONVERGE_MAX_ITERS, (1, 1), (H, W))

    (out, iters), counts, first, reads = counted(label,
                                                 lambda: solver.solve(x),
                                                 expect5)
    peak = torch.cuda.max_memory_allocated(dev)
    check(reads == -(-iters // 10), f"{label}: {reads} readbacks for "
          f"{iters} iterations")
    check(out.shape == (1, H, W) and bool(np.isfinite(out).all()),
          f"{label}: result not finite or of shape {out.shape}")
    _, warm = host_seconds(lambda: solver.solve(x))
    xd = torch.from_numpy(x).to(dev)
    del x
    _, resident = host_seconds(lambda: step.sharded_converge(
        xd, jacobi3, 1e-3, CONVERGE_MAX_ITERS, check_every=10,
        backend="cuda", fuse=9, device=dev))
    stencil.reset_launch_counts()  # not main-path launches

    def stream(backend, **kw):
        """The stream of the same run: every chunk's (iterations, diff),
        and the last image (only it is kept: 4.29 GB a yield)."""
        diffs, last = [], None
        for last, done, d in step.sharded_converge_stream(
                xd, jacobi3, 1e-3, CONVERGE_MAX_ITERS, check_every=10,
                backend=backend, device=dev, **kw):
            diffs.append((done, d))
        return last, diffs

    # A run capped short of convergence stops at the cap on both sides, so
    # the stop quantity itself is compared: every chunk's diff.
    last, diffs = stream("cuda", fuse=9)
    check(diffs[-1][0] == iters and np.array_equal(last, out),
          f"{label}: the stream ran {diffs[-1][0]} iterations, or its last "
          "image differs from the solver's")
    del last
    ref, ref_diffs = stream("shifted")
    stencil.reset_launch_counts()  # not main-path launches
    diff, ref_iters = diffs[-1][1], ref_diffs[-1][0]
    check(ref_iters == iters,
          f"{label}: {iters} iterations, shifted {ref_iters}")
    got, ref = torch.from_numpy(out).to(dev), torch.from_numpy(ref).to(dev)
    del out
    # In f32: agree()'s float64 copies would take 26 GB at this size.
    err = float((got - ref).abs_().max())
    # jacobi3's taps are dyadic: every product is exact, so FMA and
    # multiply-then-add round alike and the kernels must give the plain
    # version's bits, field and diffs.
    check(err == 0.0 and diffs == ref_diffs,
          f"{label}: differs from shifted by {err}, or its diffs "
          f"{diffs[-3:]} from shifted's {ref_diffs[-3:]}")
    del got, ref
    # The pieces of one chunk, at this size: K2 (9 levels), K1 (the pair
    # step), the diff.
    padded9 = halo.halo_exchange([[xd]], 9, (1, 1), "zero")[0][0]
    k2_ms = cuda_ms(lambda: stencil.fused_iterate(
        padded9, (0, 0), jacobi3, 9, (H, W), quantize=False), reps=3,
        warmup=1)
    del padded9
    padded1 = halo.halo_exchange([[xd]], 1, (1, 1), "zero")[0][0]
    k1_ms = cuda_ms(lambda: stencil.stencil_step(padded1, jacobi3,
                                                 quantize=False), reps=5,
                    warmup=1)
    del padded1
    prev = xd + 1
    diff_ms = cuda_ms(lambda: step._max_abs_diff(xd, prev), reps=5, warmup=1)
    del prev
    keep["config5"] = xd
    del xd
    stencil.reset_launch_counts()  # not main-path launches
    torch.cuda.empty_cache()
    px = H * W
    rows.append({
        "path": label, "iters": iters, "max_iters": CONVERGE_MAX_ITERS,
        "final_diff": diff, "final_diff_shifted": ref_diffs[-1][1],
        "converged": diff < 1e-3, "launches": counts, "readbacks": reads,
        "max_abs_err": err,
        "input_s": make_s, "seconds_first": first, "seconds_warm": warm,
        "seconds_resident": resident,
        "gpx_per_s_first": iters * px / first / 1e9,
        "gpx_per_s_warm": iters * px / warm / 1e9,
        "gpx_per_s_resident": iters * px / resident / 1e9,
        "k2_T9_ms": k2_ms, "k1_ms": k1_ms, "diff_ms": diff_ms,
        "kernel_ms": (counts["fused_iterate"] * k2_ms
                      + counts["stencil_step"] * k1_ms),
        "diff_ms_per_run": reads * diff_ms,
        "max_memory_allocated": peak, "card": card_line()})
    print(f"config 5: {iters} iterations, final diff {diff}, converged "
          f"{rows[-1]['converged']}, max_memory_allocated {peak} B "
          f"({peak / 2**30:.2f} GiB)")

    # (b) run --converge through the CLI on BASELINE config 1's image.
    blur3 = get_filter("blur3")
    rows_, cols_ = RGB_HW
    img = imageio.generate_test_image(rows_, cols_, "grey", seed=2)
    src = tmp / "converge.raw"
    imageio.write_raw(src, img)
    xg = img[None].astype(np.float32)
    want, want_iters = step.sharded_converge(
        xg, blur3, 0.5, CONVERGE_CLI_MAX, check_every=10, quantize=True,
        backend="shifted", device=dev)
    stencil.reset_launch_counts()  # not main-path launches
    want = np.clip(np.rint(want.cpu().numpy()), 0, 255).astype(np.uint8)[0]
    check(want_iters < CONVERGE_CLI_MAX,
          f"shifted did not converge in {CONVERGE_CLI_MAX} iterations")
    # The separate-devices phase runs the same converge on slots.
    keep["cli_converge"] = (src, want, want_iters)
    block16 = tuple(-(-n // g) for n, g in zip(RGB_HW, GREY_GRID))
    grid16 = f"{GREY_GRID[0]}x{GREY_GRID[1]}"
    for tag, extra, expect in (
            ("--fast", ["--fast"],
             lambda it: expected_converge_launches(
                 blur3, "cuda_sep", 32, 10, it, CONVERGE_CLI_MAX, (1, 1),
                 RGB_HW)),
            (f"--backend cuda_rdma --mesh {grid16} --storage u8 --fuse 8",
             ["--backend", "cuda_rdma", "--mesh", grid16, "--storage", "u8",
              "--fuse", "8"],
             lambda it: expected_converge_launches(
                 blur3, "cuda_rdma", 8, 10, it, CONVERGE_CLI_MAX, GREY_GRID,
                 block16))):
        dst = tmp / "converge.out.raw"
        label = f"cli run --converge 0.5 --check-every 10 grey {rows_}x{cols_} blur3 {tag}"
        argv = ["run", str(src), str(rows_), str(cols_), str(CONVERGE_CLI_MAX),
                "grey", "-o", str(dst), "--converge", "0.5", "--check-every",
                "10"] + extra
        said = []

        def run_cli():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(argv)
            check(rc == 0, f"{label}: the CLI exited {rc}")
            said.append(buf.getvalue().strip().splitlines()[-1])
            return int(said[-1].split()[2])

        it, counts, secs, reads = counted(label, run_cli, expect)
        check(it == want_iters and said[-1].startswith(
            f"converged after {want_iters} iters"),
              f"{label}: said {said[-1]!r}, shifted ran {want_iters}")
        check(np.array_equal(imageio.read_raw(dst, rows_, cols_, "grey"),
                             want), f"{label}: differs from shifted")
        stencil.reset_launch_counts()
        _, warm = host_seconds(run_cli)
        stencil.reset_launch_counts()  # counted once, in the first run
        rows.append({"path": label, "iters": it, "converged": True,
                     "launches": counts, "readbacks": reads,
                     "seconds_first": secs, "seconds_warm": warm,
                     "gpx_per_s_first": it * rows_ * cols_ / secs / 1e9,
                     "gpx_per_s_warm": it * rows_ * cols_ / warm / 1e9})

    # (c) the stream: one yield and one readback a chunk, its last image
    # sharded_converge's bytes.
    kw = dict(check_every=10, quantize=True, backend="cuda_sep",
              storage="bf16", fuse=9, device=dev)
    label = f"sharded_converge_stream grey {rows_}x{cols_} blur3 cuda_sep bf16 fuse 9"
    streamed = []

    def stream():
        streamed.clear()
        before = step.sharded_converge_stream.readbacks
        streamed.extend(step.sharded_converge_stream(
            xg, blur3, 0.5, CONVERGE_CLI_MAX, **kw))
        return step.sharded_converge_stream.readbacks - before

    reads, counts, secs, _ = counted(
        label, stream, lambda r: expected_converge_launches(
            blur3, "cuda_sep", 9, 10, streamed[-1][1], CONVERGE_CLI_MAX,
            (1, 1), RGB_HW))
    whole, whole_iters = step.sharded_converge(xg, blur3, 0.5,
                                               CONVERGE_CLI_MAX, **kw)
    stencil.reset_launch_counts()  # not main-path launches
    chunks = -(-whole_iters // 10)
    check(len(streamed) == reads == chunks and streamed[-1][1] == whole_iters,
          f"{label}: {len(streamed)} yields, {reads} readbacks, "
          f"{chunks} chunks")
    check(streamed[-1][0].tobytes() == whole.cpu().numpy().tobytes(),
          f"{label}: the last image differs from sharded_converge's")
    check(streamed[-1][2] < 0.5, f"{label}: did not converge")
    rows.append({"path": label, "iters": whole_iters, "yields": len(streamed),
                 "readbacks": reads, "launches": counts, "seconds": secs})
    return rows


# ---------------------------------------------------------------------------
# Phase 4h: blocks on separate devices (ROADMAP item 10)
# ---------------------------------------------------------------------------


def slot_devices(dev, shape, layout: str):
    """A grid's slots: every one on ``dev`` (one card), or round-robin over
    the cards (``all``)."""
    return [dev] * (shape[0] * shape[1]) if layout == "one card" else "all"


def expected_slot_launches(filt, fuse: int, grid_shape, block_hw,
                           packed: bool) -> dict:
    """Launches of one ``ITERS``-iteration ``cuda_rdma`` run on a grid of
    slots: per chunk one K3 or K4 launch per slot (and one pack per slot
    with the packed transport on more than one column), and K2 once per
    slot for each later level group."""
    from parallel_convolution_tpu_torch.ops import rdma

    counts = {k: 0 for k in KERNELS}
    nb = grid_shape[0] * grid_shape[1]
    n_chunks, rem = divmod(ITERS, fuse)
    for T, n in ((fuse, n_chunks), (rem, 1 if rem else 0)):
        if n == 0:
            continue
        plan = rdma.rdma_plan(filt.radius, T, block_hw)
        counts[f"rdma_{plan.kernel}_slot"] += n * nb
        counts["fused_iterate"] += n * nb * (len(plan.groups) - 1)
        if packed and grid_shape[1] > 1:
            counts["rdma_pack"] += n * nb
    return counts


def slot_launch_ms(run, per_slot, reps: int) -> float:
    """CUDA-event ms of one launch on every slot of ``run`` (``per_slot(s)``
    on slot s's stream), between the fork from and the join into the
    current stream: the per-slot form's cost for the grid's work."""
    def once():
        run.fork()
        for s, st in enumerate(run.streams):
            per_slot(s)
            run.launched[s].record(st)
        run.join()

    return cuda_ms(once, reps=reps)


def first_group_plain(blocks, filt, grid_shape, T: int, levels: int,
                      valid, out_dtype):
    """Plain version of the first level group of a ``T``-level chunk on a
    grid of slots, as the per-slot K3 / K4 launch computes it: each block
    padded at depth r·T by the per-block exchange (NaN until its slab
    lands), then ``levels`` of K2's plain levels into the block widened by
    r·(T - levels) on each side, at that rim's global offsets."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.parallel import halo

    r = filt.radius
    ext = r * (T - levels)
    h, w = blocks[0][0].shape[1:]
    padded = halo.exchange_per_block(blocks, r * T, grid_shape, "zero",
                                     dtype=torch.float32, fill=float("nan"))
    return torch.stack([
        stencil.fused_iterate_plain(p, (i * h - ext, j * w - ext), filt,
                                    levels, valid, True, out_dtype)
        for i, row in enumerate(padded) for j, p in enumerate(row)])


def time_pack_alone(run, depth: int, nbytes: float) -> dict:
    """Slot 0's pack alone (``rdma.rdma_pack``), on its stream: launched
    back to back and queued ahead of the card (``device_ms``, the kernel's
    own time), beside an empty kernel (``torch.cuda._sleep(0)``) timed the
    same way on that stream (``floor_ms``: the launch's floor) and the
    same calls not queued ahead (``host_ms``); ``vec`` is the bytes a
    thread moves (``rdma.pack_plan``), ``bound_ms`` one slot's staging
    (``nbytes``) read once and written once."""
    import torch

    from parallel_convolution_tpu_torch.ops import rdma

    one = lambda: rdma.rdma_pack(run, 0, 0, depth)  # noqa: E731
    with torch.cuda.stream(run.streams[0]):
        device_ms = cuda_ms(one, reps=500, warmup=20, queue_ahead=True)
        floor_ms = cuda_ms(lambda: torch.cuda._sleep(0), reps=500,
                           warmup=20, queue_ahead=True)
        host_ms = cuda_ms(one, reps=500, warmup=20)
    b_ms, b_by = bound(nbytes, 0.0)
    return dict(vec=run.pack_plans[(0, 0, depth, 1)].vec,
                threads=list(run.pack_plans[(0, 0, depth, 1)].threads),
                device_ms=device_ms, floor_ms=floor_ms, host_ms=host_ms,
                bound_ms=b_ms, bound_by=b_by,
                over_floor=device_ms / max(b_ms, floor_ms))


def time_slot_kernels(dev, rgb, grey, big, blur3, edge5) -> dict:
    """The per-slot kernels at the separate-devices phase's launches, each
    over the whole grid (one launch a slot): the first level group of a
    chunk as ``rdma._slots_step`` plans it (its kernel, its levels and its
    widened output), beside its plain version and its bound; and the
    column-transport probe that ``pick_col_mode`` reads: those launches
    reading the staging (packed) against reading in place (strided), the
    pack launches, and the host's seconds a barrier wait.  The kernels
    line takes config 2's K4 and the 16x16 split's K3; config 3's K4 is
    reported beside them."""
    import torch

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.tuning import costmodel
    from parallel_convolution_tpu_torch.utils import imageio

    out, probe = {}, {}
    for key, img, storage, shape, T, filt in (
            ("config 2", rgb, "bf16", (2, 2), 32, blur3),
            ("config 3", big, "bf16", (4, 4), 32, edge5),
            ("grey 16x16", grey, "u8", GREY_GRID, 8, blur3)):
        planar = imageio.interleaved_to_planar(img)
        grid = mesh.make_grid(shape, devices=slot_devices(dev, shape,
                                                          "one card"))
        blocks = convert.blocks_from_numpy(planar, grid, storage)
        valid = planar.shape[1:]
        C, h, w = blocks[0][0].shape
        nb = shape[0] * shape[1]
        r = filt.radius
        plan = rdma.rdma_plan(r, T, (h, w), None, stencil._smem_limit(dev))
        levels = plan.groups[0]
        ext = r * (T - levels)
        tiled = plan.kernel == "tiled"
        launch = rdma.rdma_tiled_slot if tiled else rdma.rdma_block_slot
        kind = "rdma_tiled_slot" if tiled else "rdma_block_slot"
        mid = stencil.group_dtype(True, blocks[0][0].dtype)
        runs = {cm: rdma.slot_carry(blocks, grid, "zero", r * T, cm).run
                for cm in ("strided", "packed")}
        outs = [torch.empty((C, h + 2 * ext, w + 2 * ext), dtype=mid,
                            device=dev) for _ in range(nb)]
        kw = dict(ext=ext, **(dict(tile=plan.tile) if tiled else {}))

        def main(run):
            return lambda s: launch(run, 0, s, outs[s], filt, levels, valid,
                                    **kw)

        depth = r * T
        pack = lambda s: rdma.rdma_pack(runs["packed"], 0, s, depth)
        slot_launch_ms(runs["packed"], pack, reps=3)  # the staging filled
        reps = 20 if T * r * r <= 8 else 10
        ms = slot_launch_ms(runs["strided"], main(runs["strided"]), reps)
        got = torch.stack(outs)
        plain = lambda: first_group_plain(blocks, filt, shape, T, levels,
                                          valid, mid)
        want = plain()
        ok, err = agree(got, want, filt, levels, True)
        check(ok, f"{kind} at {key}'s blocks {shape} x {(C, h, w)}, the "
                  f"first {levels} of {T} levels into a {ext}-pixel rim: "
                  f"err {err}")
        packed_ms = slot_launch_ms(runs["packed"], main(runs["packed"]),
                                   reps)
        check(torch.equal(torch.stack(outs), got),
              f"{kind} at {key}: the packed transport differs from strided")
        plain_ms = cuda_ms(plain, reps=1, warmup=1)
        # The least work of the launch: each block's pixels once a level
        # (the rim is its neighbours' pixels, computed by them), each
        # block read once and its widened output written once.
        ops = nb * C * levels * level_ops(filt, False, h, w, True, False)
        nbytes = (nb * C * h * w * blocks[0][0].element_size()
                  + got.numel() * got.element_size())
        b_ms, b_by = bound(nbytes, ops)
        row = dict(grid=list(shape), block=[C, h, w], T=T, levels=levels,
                   ext=ext, filter=filt.name, dtype=str(got.dtype), ms=ms,
                   packed_ms=packed_ms, plain_ms=plain_ms, max_abs_err=err,
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   fraction_of_bound=b_ms / ms)
        if kind in out:
            out[kind].setdefault("also", {})[key] = row
        else:
            out[kind] = dict(row, at=key)
        pack_ms = slot_launch_ms(runs["packed"], pack, reps=20)
        slabs = [rdma.staged_slabs(runs["packed"], s, depth)
                 for s in range(nb)]
        wants = rdma.rdma_pack_plain(blocks, shape, "zero", depth)
        perr = max(max_abs_err(a, b) for a, b in zip(slabs, wants))
        check(all(torch.equal(a, b) for a, b in zip(slabs, wants)),
              f"rdma_pack at {key}: staging differs from its plain version")
        rows = h + 2 * depth
        elt = blocks[0][0].element_size()
        nbytes = 2 * nb * 2 * C * rows * depth * elt
        pb_ms, pb_by = bound(nbytes, 0.0)
        alone = time_pack_alone(runs["packed"], depth, nbytes / nb)
        alone.update(slot_launch_ms=pack_ms,
                     parent=PACK_PARENT_MS.get(key))
        if key == "config 2":
            out["rdma_pack"] = dict(
                grid=list(shape), slab=[2, C, rows, depth], ms=pack_ms,
                plain_ms=cuda_ms(lambda: rdma.rdma_pack_plain(
                    blocks, shape, "zero", depth), reps=2, warmup=1),
                max_abs_err=perr, library_ms=None, bound_ms=pb_ms,
                bound_by=pb_by, fraction_of_bound=pb_ms / pack_ms,
                device_ms=alone["device_ms"], alone={})
        out["rdma_pack"]["alone"][key] = alone
        # The prices pick_col_mode reads: a padded row of one channel read
        # in place over read from the staging, and a pack launch's fixed
        # part (its time less its bytes at the data sheet's rate).
        probe[key] = dict(
            grid=list(shape), block=[C, h, w], radius=r, T=T,
            storage=storage, strided_ms=ms, packed_ms=packed_ms,
            pack_ms=pack_ms,
            col_row_s=max(0.0, (ms - packed_ms) / 1e3) / (nb * 2 * C * rows),
            pack_s=max(0.0, pack_ms / 1e3 / nb - nbytes / nb
                       / HBM_BYTES_PER_S))
        del runs, outs, got, want
    waits = torch.cuda.Stream(device=dev)
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.perf_counter()
    for _ in range(2000):
        waits.wait_event(ev)
    probe["event_s"] = (time.perf_counter() - t0) / 2000
    # The least over the shapes: where the launches are host-bound (256
    # slots of small blocks) the strided / packed difference is the host's
    # noise, not the column read.
    probe["col_row_s"] = min(p["col_row_s"] for k, p in probe.items()
                             if isinstance(p, dict))
    probe["pack_s"] = min(p["pack_s"] for k, p in probe.items()
                          if isinstance(p, dict))
    measured = dataclasses.replace(costmodel.H100,
                                   col_row_s=probe["col_row_s"],
                                   pack_s=probe["pack_s"],
                                   event_s=probe["event_s"])
    probe["picks"] = {
        k: costmodel.pick_col_mode(p["grid"], p["block"][1:], p["radius"],
                                   p["T"], p["storage"], measured,
                                   p["block"][0])
        for k, p in probe.items() if isinstance(p, dict)}
    probe["committed"] = {k: getattr(costmodel.H100, k)
                          for k in ("col_row_s", "pack_s", "event_s")}
    return {"kernels": out, "probe": probe}


def separate_devices_phase(dev, tmp: Path, refs: dict, totals: dict,
                           keep: dict) -> dict:
    """BASELINE configs 2 (2x2, 4 slots) and 3 (4x4, 16 slots), the 256-rank
    split (16x16, K3 per slot) and ``run --converge`` on config 1's image
    at 2x2, every block on a device slot of its own: the port's per-slot
    form against its one-card form and ``shifted``, counted into the
    kernels line; the per-slot kernels against their plain versions; the
    column-transport probe; and a 1 ms spin before each chunk on one
    slot's stream leaving the bytes unchanged.  With two cards or more the
    paths run again round-robin over the cards, peer access on."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    cards = torch.cuda.device_count()
    layouts = ["one card"] + (["all"] if cards >= 2 else [])
    blur3, edge5 = get_filter("blur3"), get_filter("edge5")
    rgb, rgb_ref = refs["rgb"], refs["rgb_ref"]
    grey, grey_ref = refs["greys"]["blur3"], refs["grey_refs"]["blur3"]
    edge_ref = refs["grey_refs"]["edge5"]
    report = {"cards": cards, "layouts": layouts, "runs": []}
    px2 = RGB_HW[0] * RGB_HW[1] * 3
    block2 = tuple(-(-n // 2) for n in RGB_HW)
    block3 = tuple(n // 4 for n in BIG_HW)
    block16 = tuple(-(-n // g) for n, g in zip(RGB_HW, GREY_GRID))
    per = lambda f, T, hw, nb: {k: nb * v for k, v in
                                expected_launches(f, T, hw).items()}

    def resident(model, planar):
        return min(host_seconds(lambda: model.run_planar(planar, ITERS))[1]
                   for _ in range(2))

    for layout in layouts:
        print(f"separate devices ({layout}): {cards} card(s); slots of 2x2 "
              f"{mesh.make_grid((2, 2), devices=slot_devices(dev, (2, 2), layout)).slot_map()}")
        # (a) configs 2 and 3 and the 16x16 split through the model.
        planar_rgb = torch.from_numpy(
            imageio.interleaved_to_planar(rgb).copy()).to(dev, torch.float32)
        planar_grey = torch.from_numpy(grey[None].copy()).to(dev,
                                                             torch.float32)
        cases = []
        for cm in ("packed", "strided"):
            cases.append((f"config 2 rgb blur3 cuda_rdma bf16 fuse 32 "
                          f"col_mode {cm}", rgb, rgb_ref, planar_rgb, px2,
                          (2, 2), dict(backend="cuda_rdma", storage="bf16",
                                       fuse=32, col_mode=cm),
                          expected_slot_launches(blur3, 32, (2, 2), block2,
                                                 cm == "packed")))
        cases += [
            ("config 2 rgb blur3 cuda_sep bf16 fuse 32", rgb, rgb_ref,
             planar_rgb, px2, (2, 2),
             dict(backend="cuda_sep", storage="bf16", fuse=32),
             per(blur3, 32, block2, 4)),
            ("config 2 rgb blur3 cuda f32 fuse 1", rgb, rgb_ref, planar_rgb,
             px2, (2, 2), dict(backend="cuda", storage="f32", fuse=1),
             per(blur3, 1, block2, 4))]
        for cm in ("packed", "strided"):
            cases.append((f"grey 16x16 blur3 cuda_rdma u8 fuse 8 col_mode "
                          f"{cm}", grey, grey_ref, planar_grey,
                          RGB_HW[0] * RGB_HW[1], GREY_GRID,
                          dict(backend="cuda_rdma", storage="u8", fuse=8,
                               col_mode=cm),
                          expected_slot_launches(blur3, 8, GREY_GRID,
                                                 block16, cm == "packed")))
        for label, img, want, planar, pixels, shape, kw, expect in cases:
            grid = mesh.make_grid(shape, devices=slot_devices(dev, shape,
                                                              layout))
            model = ConvolutionModel("blur3", grid=grid, **kw)
            out, counts, secs = drive(f"{label} on {layout} slots",
                                      lambda: model.run_image(img, ITERS),
                                      expect, pixels,
                                      no_halo=kw["backend"] == "cuda_rdma")
            for k, v in counts.items():
                totals[k] += v
            check(np.array_equal(out, want), f"{label}: differs from shifted")
            one = ConvolutionModel("blur3", grid=mesh.make_grid(shape, dev),
                                   **kw)
            check(np.array_equal(one.run_image(img, ITERS), out),
                  f"{label}: differs from the one-card form")
            report["runs"].append(dict(
                path=label, layout=layout, slots=grid.slot_map()
                if layout != "one card" else f"{shape[0] * shape[1]} x {dev}",
                col_mode=model.effective_col_mode, launches=counts,
                seconds_first=secs,
                seconds_resident_slots=resident(model, planar),
                seconds_resident_one_card=resident(one, planar)))
        # (b) config 3 through the CLI (--device takes the slot list).
        src = tmp / "edge5.raw"
        dst = tmp / "edge5.slots.raw"
        shape = (4, 4)
        slots = slot_devices(dev, shape, layout)
        spec = ",".join(map(str, slots)) if layout == "one card" else "all"
        planar8k = torch.from_numpy(refs["greys"]["edge5"][None].copy()).to(
            dev, torch.float32)
        for backend, cm in (("cuda_rdma", "packed"), ("cuda_rdma", "strided"),
                            ("cuda", "auto")):
            label = (f"config 3 cli run grey 8192x8192 edge5 --backend "
                     f"{backend} --mesh 4x4 --device <16 slots> --storage "
                     f"bf16 --fuse 32 --col-mode {cm}")
            argv = ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]),
                    str(ITERS), "grey", "-o", str(dst), "--filter", "edge5",
                    "--backend", backend, "--mesh", "4x4", "--device", spec,
                    "--storage", "bf16", "--fuse", "32", "--col-mode", cm]

            def run_cli():
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli_main(argv)
                check(rc == 0, f"{label}: the CLI exited {rc}")
                return buf.getvalue().strip().splitlines()[-1]

            expect = (expected_slot_launches(edge5, 32, shape, block3,
                                             cm == "packed")
                      if backend == "cuda_rdma" else
                      per(edge5, 32, block3, 16))
            line, counts, secs = drive(f"{label} on {layout} slots", run_cli,
                                       expect, BIG_HW[0] * BIG_HW[1],
                                       no_halo=backend == "cuda_rdma")
            for k, v in counts.items():
                totals[k] += v
            check("slots " in line, f"{label}: said {line!r}")
            check(np.array_equal(imageio.read_raw(dst, *BIG_HW, "grey"),
                                 edge_ref), f"{label}: differs from shifted")
            kw = dict(backend=backend, storage="bf16", fuse=32, col_mode=cm)
            model = ConvolutionModel(
                "edge5", grid=mesh.make_grid(shape, devices=slots), **kw)
            one = ConvolutionModel("edge5", grid=mesh.make_grid(shape, dev),
                                   **kw)
            check(torch.equal(model.run_planar(planar8k, ITERS),
                              one.run_planar(planar8k, ITERS)),
                  f"{label}: differs from the one-card form")
            report["runs"].append(dict(
                path=label, layout=layout, said=line, launches=counts,
                seconds_first=secs,
                seconds_resident_slots=resident(model, planar8k),
                seconds_resident_one_card=resident(one, planar8k)))
        # (c) run --converge 0.5 --check-every 10 on config 1's image at
        # 2x2 slots, against the one-card 2x2 run and shifted.
        csrc, cwant, citers = keep["cli_converge"]
        spec = (",".join(map(str, slot_devices(dev, (2, 2), layout)))
                if layout == "one card" else "all")
        for backend in ("cuda_rdma", "cuda"):
            outs = {}
            for where, dflag in (("slots", ["--device", spec]),
                                 ("one card", [])):
                cdst = tmp / f"converge.{where.replace(' ', '_')}.raw"
                label = (f"cli run --converge 0.5 --check-every 10 grey "
                         f"1920x2520 blur3 --backend {backend} --mesh 2x2 "
                         f"on {where}")
                argv = (["run", str(csrc), str(RGB_HW[0]), str(RGB_HW[1]),
                         str(CONVERGE_CLI_MAX), "grey", "-o", str(cdst),
                         "--converge", "0.5", "--check-every", "10",
                         "--backend", backend, "--mesh", "2x2"] + dflag)
                buf = io.StringIO()
                stencil.reset_launch_counts()
                with contextlib.redirect_stdout(buf):
                    rc, secs = host_seconds(lambda: cli_main(argv))
                counts = stencil.launch_counts()
                check(rc == 0, f"{label}: the CLI exited {rc}")
                said = buf.getvalue().strip().splitlines()[-1]
                check(said.startswith(f"converged after {citers} iters"),
                      f"{label}: said {said!r}, shifted ran {citers}")
                outs[where] = imageio.read_raw(cdst, *RGB_HW, "grey")
                check(np.array_equal(outs[where], cwant),
                      f"{label}: differs from shifted")
                if where == "slots":
                    slot_kernel = ("rdma_tiled_slot" if backend == "cuda_rdma"
                                   else "stencil_step")
                    check(counts[slot_kernel] > 0
                          and counts["rdma_tiled"] == 0,
                          f"{label}: launches {counts}")
                    for k, v in counts.items():
                        totals[k] += v
                report["runs"].append(dict(path=label, layout=layout,
                                           iters=citers, launches=counts,
                                           seconds=secs))
                print(f"separate devices {label}: {counts}, {secs:.4f} s")
    # (d) the skew: ~1 ms of spin on slot 1's stream before each chunk of
    # config 2's cuda_rdma run leaves every byte where it was.
    planar = imageio.interleaved_to_planar(rgb)
    for cm in ("packed", "strided"):
        grid = mesh.make_grid((2, 2), devices=slot_devices(dev, (2, 2),
                                                           "one card"))
        carry = rdma.slot_carry(convert.blocks_from_numpy(planar, grid,
                                                          "bf16"),
                                grid, "zero", 32, cm)
        for T in (32, 32, 32, ITERS % 32):
            with torch.cuda.stream(carry.run.streams[1]):
                torch.cuda._sleep(2_000_000)
            carry = rdma.fused_rdma_slots(carry, blur3, (2, 2), "zero",
                                          fuse=T, valid_hw=RGB_HW,
                                          col_mode=cm)
        got = mesh.join_blocks(rdma.slot_blocks(carry, (2, 2)))
        got = got[:, :RGB_HW[0], :RGB_HW[1]].to(torch.uint8).cpu().numpy()
        check(np.array_equal(imageio.planar_to_interleaved(got), rgb_ref),
              f"skew ({cm}): the skewed run differs from shifted")
    report["skew"] = "equal under a 1 ms spin before every chunk on slot 1"
    stencil.reset_launch_counts()  # not main-path launches
    report["timed"] = time_slot_kernels(dev, rgb, grey,
                                        refs["greys"]["edge5"], blur3, edge5)
    return report


# ---------------------------------------------------------------------------
# Phase 4i: the overlapped pipeline (ROADMAP item 10b)
# ---------------------------------------------------------------------------


def expected_overlap_launches(filt, fuse: int, grid_shape, block_hw,
                              packed: bool) -> dict:
    """Launches of one ``ITERS``-iteration overlapped ``cuda_rdma`` run on a
    grid of slots: per chunk and slot the first level group's K3 or K4
    region by region (``rdma.overlap_regions`` on its rim-extended
    output), K2 for each later group, and a pack with the packed transport
    on more than one column."""
    from parallel_convolution_tpu_torch.ops import rdma

    counts = {k: 0 for k in KERNELS}
    nb = grid_shape[0] * grid_shape[1]
    r = filt.radius
    n_chunks, rem = divmod(ITERS, fuse)
    for T, n in ((fuse, n_chunks), (rem, 1 if rem else 0)):
        if n == 0:
            continue
        plan = rdma.rdma_plan(r, T, block_hw)
        ext = r * (T - plan.groups[0])
        regions = sum(len(g) for g in rdma.overlap_regions(
            block_hw[0] + 2 * ext, block_hw[1] + 2 * ext, r * T))
        counts[f"rdma_{plan.kernel}_region"] += n * nb * regions
        counts["fused_iterate"] += n * nb * (len(plan.groups) - 1)
        if packed and grid_shape[1] > 1:
            counts["rdma_pack"] += n * nb
    return counts


def slot_kernel_run(planar, grid, filt, storage: str, fuse: int, col_mode,
                    skew: bool = False, **kw):
    """``ITERS`` iterations of ``cuda_rdma`` on the grid of slots straight
    at the kernel layer (``rdma.fused_rdma_slots``: ``kw`` its overlap and
    partitioned), ``skew`` a ~10 ms spin on slot 0's stream before every
    chunk (slot 0 is a neighbour of every slot of a 2x2 grid, the
    diagonal of slot 3; and the host enqueues a step of region launches in
    about a millisecond, so phase 4h's 1 ms would leave no skew on the
    card); the interleaved u8 image."""
    import torch

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    shape = grid.shape
    valid = planar.shape[1:]
    carry = rdma.slot_carry(convert.blocks_from_numpy(planar, grid, storage),
                            grid, "zero", filt.radius * fuse, col_mode)
    n, rem = divmod(ITERS, fuse)
    for T in [fuse] * n + ([rem] if rem else []):
        if skew:
            with torch.cuda.stream(carry.run.streams[0]):
                torch.cuda._sleep(20_000_000)
        carry = rdma.fused_rdma_slots(carry, filt, shape, "zero", fuse=T,
                                      valid_hw=valid, col_mode=col_mode,
                                      **kw)
    got = mesh.join_blocks(rdma.slot_blocks(carry, shape))
    got = got[:, :valid[0], :valid[1]].to(torch.uint8).cpu().numpy()
    return imageio.planar_to_interleaved(got)


@contextlib.contextmanager
def phase_order():
    """Every overlapped step in the JAX phase order (``partitioned=False``)
    while it is open: the entry points pass the knob's default."""
    import functools

    from parallel_convolution_tpu_torch.ops import rdma

    inner = rdma.fused_rdma_slots
    rdma.fused_rdma_slots = functools.partial(inner, partitioned=False)
    try:
        yield
    finally:
        rdma.fused_rdma_slots = inner


def time_region_kernels(dev, rgb, grey, big, blur3, edge5) -> dict:
    """The overlapped pipeline's region launches of K3 / K4 at the phase's
    shapes, each over the whole grid: the first level group of a chunk as
    ``rdma._slots_step`` plans it, its regions (``rdma.overlap_schedule``)
    launched one after another on every slot (the waits left out: the
    launches alone), assembled into the widened output and held against
    the plain first group; beside it the same group as one launch a slot
    (``rdma_*_slot``), in the same call."""
    import torch

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    out = {}
    for key, img, storage, shape, T, filt in (
            ("config 2", rgb, "bf16", (2, 2), 32, blur3),
            ("config 3", big, "bf16", (4, 4), 32, edge5),
            ("grey 16x16", grey, "u8", GREY_GRID, 8, blur3)):
        planar = imageio.interleaved_to_planar(img)
        grid = mesh.make_grid(shape, devices=slot_devices(dev, shape,
                                                          "one card"))
        blocks = convert.blocks_from_numpy(planar, grid, storage)
        valid = planar.shape[1:]
        C, h, w = blocks[0][0].shape
        nb = shape[0] * shape[1]
        r = filt.radius
        plan = rdma.rdma_plan(r, T, (h, w), None, stencil._smem_limit(dev))
        levels = plan.groups[0]
        ext = r * (T - levels)
        tiled = plan.kernel == "tiled"
        region = rdma.rdma_tiled_region if tiled else rdma.rdma_block_region
        whole = rdma.rdma_tiled_slot if tiled else rdma.rdma_block_slot
        kind = region.__name__
        mid = stencil.group_dtype(True, blocks[0][0].dtype)
        run = rdma.slot_carry(blocks, grid, "zero", r * T, "strided").run
        outs = [torch.full((C, h + 2 * ext, w + 2 * ext), float("nan"),
                           dtype=mid, device=dev) if mid.is_floating_point
                else torch.zeros((C, h + 2 * ext, w + 2 * ext), dtype=mid,
                                 device=dev) for _ in range(nb)]
        kw = dict(ext=ext, **(dict(tile=plan.tile) if tiled else {}))
        sched = rdma.overlap_schedule(h + 2 * ext, w + 2 * ext, r * T, ext)

        def regions(s):
            for _, rect, _ in sched:
                region(run, 0, s, outs[s], filt, levels, valid, rect, **kw)

        reps = 20 if T * r * r <= 8 else 10
        ms = slot_launch_ms(run, regions, reps)
        got = torch.stack(outs)
        want = first_group_plain(blocks, filt, shape, T, levels, valid, mid)
        ok, err = agree(got, want, filt, levels, True)
        check(ok, f"{kind} at {key}'s blocks {shape} x {(C, h, w)}, "
                  f"{len(sched)} regions of the first {levels} of {T} "
                  f"levels into a {ext}-pixel rim: err {err}")
        whole_ms = slot_launch_ms(
            run, lambda s: whole(run, 0, s, outs[s], filt, levels, valid,
                                 **kw), reps)
        check(torch.equal(torch.stack(outs), got),
              f"{kind} at {key}: the regions differ from the whole launch")
        plain_ms = cuda_ms(lambda: first_group_plain(
            blocks, filt, shape, T, levels, valid, mid), reps=1, warmup=1)
        ops = nb * C * levels * level_ops(filt, False, h, w, True, False)
        nbytes = (nb * C * h * w * blocks[0][0].element_size()
                  + got.numel() * got.element_size())
        b_ms, b_by = bound(nbytes, ops)
        row = dict(grid=list(shape), block=[C, h, w], T=T, levels=levels,
                   ext=ext, filter=filt.name, dtype=str(got.dtype),
                   regions=[lab for lab, _, _ in sched], ms=ms,
                   whole_launch_ms=whole_ms, plain_ms=plain_ms,
                   max_abs_err=err, library_ms=None, bound_ms=b_ms,
                   bound_by=b_by, fraction_of_bound=b_ms / ms)
        if kind in out:
            out[kind].setdefault("also", {})[key] = row
        else:
            out[kind] = dict(row, at=key)
        del run, outs, got, want
    return out


def overlap_phase(dev, tmp: Path, refs: dict, totals: dict,
                  keep: dict) -> dict:
    """BASELINE configs 2 (2x2, 4 slots) and 3 (4x4, 16 slots), the 256-rank
    split and ``run --converge`` on config 1's image at 2x2 slots, with
    ``cuda_rdma``'s overlapped pipeline, each in its three schedules:
    overlapped and partitioned through the entry points (counted into
    the kernels line), overlapped in the JAX phase order
    (``partitioned=False``) and serialized; both column transports; each
    byte-equal to the serialized per-slot run, to the one-card form and
    to ``shifted``, with both resident times.  Then the skew check with
    overlap on, and the region launches timed.  With two cards or more
    the paths run again round-robin over the cards."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio

    cards = torch.cuda.device_count()
    layouts = ["one card"] + (["all"] if cards >= 2 else [])
    blur3, edge5 = get_filter("blur3"), get_filter("edge5")
    rgb, grey, big = refs["rgb"], refs["greys"]["blur3"], refs["greys"]["edge5"]
    report = {"cards": cards, "layouts": layouts, "runs": []}
    block2 = tuple(-(-n // 2) for n in RGB_HW)
    block3 = tuple(n // 4 for n in BIG_HW)
    block16 = tuple(-(-n // g) for n, g in zip(RGB_HW, GREY_GRID))

    def resident(model, planar):
        return min(host_seconds(lambda: model.run_planar(planar, ITERS))[1]
                   for _ in range(2))

    for layout in layouts:
        cases = []
        for cm in ("packed", "strided"):
            cases += [
                (f"config 2 rgb blur3 cuda_rdma bf16 fuse 32 col_mode {cm}",
                 rgb, refs["rgb_ref"], (2, 2), "blur3", "bf16", 32, cm,
                 block2),
                (f"grey 16x16 blur3 cuda_rdma u8 fuse 8 col_mode {cm}", grey,
                 refs["grey_refs"]["blur3"], GREY_GRID, "blur3", "u8", 8, cm,
                 block16)]
        for label, img, want, shape, name, storage, fuse, cm, bhw in cases:
            filt = get_filter(name)
            grid = mesh.make_grid(shape, devices=slot_devices(dev, shape,
                                                              layout))
            kw = dict(backend="cuda_rdma", storage=storage, fuse=fuse,
                      col_mode=cm)
            model = ConvolutionModel(name, grid=grid, overlap=True, **kw)
            out, counts, secs = drive(
                f"overlapped {label} on {layout} slots",
                lambda: model.run_image(img, ITERS),
                expected_overlap_launches(filt, fuse, shape, bhw,
                                          cm == "packed"),
                int(np.prod(img.shape)), no_halo=True)
            for k, v in counts.items():
                totals[k] += v
            check(model.effective_overlap is True,
                  f"{label}: the model ran with overlap "
                  f"{model.effective_overlap}")
            check(np.array_equal(out, want), f"{label}: overlapped differs "
                                             "from shifted")
            planar = imageio.interleaved_to_planar(img)
            phase = slot_kernel_run(planar, grid, filt, storage, fuse, cm,
                                    overlap=True, partitioned=False)
            serial = ConvolutionModel(name, grid=grid, **kw)
            one = ConvolutionModel(name, grid=mesh.make_grid(shape, dev),
                                   **kw)
            for what, other in (("the phase order", phase),
                                ("the serialized per-slot run",
                                 serial.run_image(img, ITERS)),
                                ("the one-card form",
                                 one.run_image(img, ITERS))):
                check(np.array_equal(out, other),
                      f"{label}: overlapped differs from {what}")
            resident_in = torch.from_numpy(planar.copy()).to(dev,
                                                             torch.float32)
            with phase_order():
                phase_s = resident(model, resident_in)
            report["runs"].append(dict(
                path=label, layout=layout, launches=counts,
                seconds_first=secs,
                seconds_resident_overlapped=resident(model, resident_in),
                seconds_resident_phase_order=phase_s,
                seconds_resident_serialized=resident(serial, resident_in),
                seconds_resident_one_card=resident(one, resident_in)))
        # Config 3 through the CLI: --overlap on with the 16 slots.
        src, dst = tmp / "edge5.raw", tmp / "edge5.overlap.raw"
        shape = (4, 4)
        slots = slot_devices(dev, shape, layout)
        spec = ",".join(map(str, slots)) if layout == "one card" else "all"
        planar8k = torch.from_numpy(big[None].copy()).to(dev, torch.float32)
        for cm in ("strided", "packed"):
            label = (f"config 3 cli run grey 8192x8192 edge5 --backend "
                     f"cuda_rdma --mesh 4x4 --device <16 slots> --storage "
                     f"bf16 --fuse 32 --col-mode {cm} --overlap on")
            argv = ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]),
                    str(ITERS), "grey", "-o", str(dst), "--filter", "edge5",
                    "--backend", "cuda_rdma", "--mesh", "4x4", "--device",
                    spec, "--storage", "bf16", "--fuse", "32", "--col-mode",
                    cm, "--overlap", "on"]

            def run_cli():
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli_main(argv)
                check(rc == 0, f"{label}: the CLI exited {rc}")
                return buf.getvalue().strip().splitlines()[-1]

            line, counts, secs = drive(
                f"{label} on {layout} slots", run_cli,
                expected_overlap_launches(edge5, 32, shape, block3,
                                          cm == "packed"),
                BIG_HW[0] * BIG_HW[1], no_halo=True)
            for k, v in counts.items():
                totals[k] += v
            check("overlapped halo pipeline" in line,
                  f"{label}: said {line!r}")
            got = imageio.read_raw(dst, *BIG_HW, "grey")
            check(np.array_equal(got, refs["grey_refs"]["edge5"]),
                  f"{label}: differs from shifted")
            grid = mesh.make_grid(shape, devices=slots)
            kw = dict(backend="cuda_rdma", storage="bf16", fuse=32,
                      col_mode=cm)
            model = ConvolutionModel("edge5", grid=grid, overlap=True, **kw)
            serial = ConvolutionModel("edge5", grid=grid, **kw)
            one = ConvolutionModel("edge5", grid=mesh.make_grid(shape, dev),
                                   **kw)
            phase = slot_kernel_run(big[None], grid, edge5, "bf16", 32, cm,
                                    overlap=True, partitioned=False)
            check(np.array_equal(phase, got),
                  f"{label}: differs from the phase order")
            ser_out = serial.run_planar(planar8k, ITERS)
            check(torch.equal(model.run_planar(planar8k, ITERS), ser_out)
                  and torch.equal(one.run_planar(planar8k, ITERS), ser_out),
                  f"{label}: differs from the serialized per-slot run or "
                  "the one-card form")
            with phase_order():
                phase_s = resident(model, planar8k)
            report["runs"].append(dict(
                path=label, layout=layout, said=line, launches=counts,
                seconds_first=secs,
                seconds_resident_overlapped=resident(model, planar8k),
                seconds_resident_phase_order=phase_s,
                seconds_resident_serialized=resident(serial, planar8k),
                seconds_resident_one_card=resident(one, planar8k)))
        # run --converge 0.5 --check-every 10 on config 1's image at 2x2.
        csrc, cwant, citers = keep["cli_converge"]
        spec = (",".join(map(str, slot_devices(dev, (2, 2), layout)))
                if layout == "one card" else "all")
        for cm in ("strided", "packed"):
            seconds = {}
            for sched, flags in (("overlapped", ["--overlap", "on"]),
                                 ("phase order", ["--overlap", "on"]),
                                 ("serialized", [])):
                cdst = tmp / f"converge.{sched.replace(' ', '_')}.raw"
                label = (f"cli run --converge 0.5 --check-every 10 grey "
                         f"1920x2520 blur3 --backend cuda_rdma --mesh 2x2 "
                         f"--device <4 slots> --col-mode {cm} ({sched})")
                argv = (["run", str(csrc), str(RGB_HW[0]), str(RGB_HW[1]),
                         str(CONVERGE_CLI_MAX), "grey", "-o", str(cdst),
                         "--converge", "0.5", "--check-every", "10",
                         "--backend", "cuda_rdma", "--mesh", "2x2",
                         "--device", spec, "--col-mode", cm] + flags)
                buf = io.StringIO()
                stencil.reset_launch_counts()
                with contextlib.redirect_stdout(buf), (
                        phase_order() if sched == "phase order"
                        else contextlib.nullcontext()):
                    rc, secs = host_seconds(lambda: cli_main(argv))
                counts = stencil.launch_counts()
                check(rc == 0, f"{label}: the CLI exited {rc}")
                said = buf.getvalue().strip().splitlines()[-1]
                check(said.startswith(f"converged after {citers} iters"),
                      f"{label}: said {said!r}, shifted ran {citers}")
                check(np.array_equal(imageio.read_raw(cdst, *RGB_HW, "grey"),
                                     cwant), f"{label}: differs from shifted")
                overlapped = sched != "serialized"
                check((counts["rdma_tiled_region"] > 0) == overlapped
                      and (counts["rdma_tiled_slot"] > 0) != overlapped,
                      f"{label}: launches {counts}")
                if sched == "overlapped":
                    for k, v in counts.items():
                        totals[k] += v
                seconds[sched] = secs
                report["runs"].append(dict(path=label, layout=layout,
                                           iters=citers, launches=counts,
                                           seconds=secs))
                print(f"overlap {label}: {counts}, {secs:.4f} s")
    # The skew: ~10 ms of spin on slot 0's stream before each chunk of
    # config 2's run, overlapped, in both schedules and transports.
    planar = imageio.interleaved_to_planar(rgb)
    grid = mesh.make_grid((2, 2), devices=slot_devices(dev, (2, 2),
                                                       "one card"))
    for cm in ("packed", "strided"):
        for partitioned in (True, False):
            got = slot_kernel_run(planar, grid, blur3, "bf16", 32, cm,
                                  skew=True, overlap=True,
                                  partitioned=partitioned)
            check(np.array_equal(got, refs["rgb_ref"]),
                  f"skew ({cm}, partitioned={partitioned}): the skewed "
                  "overlapped run differs from shifted")
    report["skew"] = ("equal under a 10 ms spin before every chunk on slot "
                      "0, overlapped, both schedules and transports")
    stencil.reset_launch_counts()  # not main-path launches
    report["timed"] = time_region_kernels(dev, rgb, grey, big, blur3, edge5)
    return report


# ---------------------------------------------------------------------------
# Phase 4d: multigrid (ROADMAP item 5)
# ---------------------------------------------------------------------------


def mg_counted(label, fn, levels, backend, totals: dict):
    """``fn()`` -> ``(field, MGResult)`` with the counters at 0 before and
    read after: its launches must be the schedule's per-cycle launches
    (``multigrid.cycle_launches``) times its cycles, one readback a cycle;
    they are added to the totals."""
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.solvers import multigrid as mg

    stencil.reset_launch_counts()
    reads = mg.mg_converge.readbacks
    (out, res), secs = host_seconds(fn)
    counts = stencil.launch_counts()
    reads = mg.mg_converge.readbacks - reads
    per = mg.cycle_launches(levels, backend, 1)
    want = {k: v * res.cycles for k, v in per.items()}
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    check(any(counts.values()), f"{label}: no kernel launched")
    check(reads == res.cycles == len(res.residuals),
          f"{label}: {reads} readbacks for {res.cycles} cycles")
    for k, v in counts.items():
        totals[k] += v
    print(f"multigrid {label}: {res.cycles} cycles, {res.work_units} work "
          f"units, launches {counts} ({per} a cycle), {secs:.4f} s")
    return out, res, counts, per, secs


def mg_row(label, res, counts, per, secs, **extra) -> dict:
    return {"path": label, "backend": res.backend, "cycles": res.cycles,
            "work_units": res.work_units, "converged": res.converged,
            "residuals": res.residuals, "levels": res.levels,
            "level_grids": res.level_grids, "level_shapes": res.level_shapes,
            "launches": counts, "launches_per_cycle": per, "seconds": secs,
            "measured_s_per_cycle": secs / max(1, res.cycles),
            "predicted_s_per_cycle": res.predicted_s_per_cycle, **extra}


def multigrid_phase(dev, tmp: Path, totals: dict, field,
                    jacobi_row: dict) -> list:
    """BASELINE config 5 with ``--solver multigrid``: the field of the
    Jacobi phase on the card, jacobi3, tol 1e-3, f32, the Jacobi phase's
    budget in fine-grid work units, with ``cuda`` at 1x1 (through
    ``JacobiSolver`` from the host, and resident) and at 2x2 (bitwise the
    1x1 field), ``cuda_rdma`` at 4x4 and the plain ``shifted`` run (the
    same residuals and the same field bit for bit); then
    ``run --converge 0.5 --solver multigrid`` through the CLI on the grey
    1920x2520 image with ``cuda`` and with ``cuda_rdma`` at 16x16 (coarse
    levels on sub-grids), against the CLI's ``shifted`` run."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import JacobiSolver
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.solvers import multigrid as mg
    from parallel_convolution_tpu_torch.utils import imageio

    rows = []
    card = card_line()
    jacobi3 = get_filter("jacobi3")
    H, W = CONVERGE_HW
    tol, budget = 1e-3, CONVERGE_MAX_ITERS
    field_bytes = field.numel() * field.element_size()

    def solve(grid_shape, backend):
        return lambda: mg.mg_converge(field, jacobi3, tol, budget,
                                      grid=make_grid(grid_shape, dev),
                                      backend=backend)

    def levels_of(grid_shape, shape=CONVERGE_HW):
        return mg.plan_levels(make_grid(grid_shape, dev), shape, 1)

    # (a) cuda at 1x1 through JacobiSolver, from a host array as a user
    # calls it, then resident: the input already on the card.
    host = field.cpu().numpy()
    solver = JacobiSolver("jacobi3", tol=tol, max_iters=budget,
                          backend="cuda", quantize=False, storage="f32",
                          solver="multigrid", device=dev)
    label = f"config 5 multigrid jacobi3 {H}x{W} f32 cuda 1x1"
    out_host, res_a, counts, per, first = mg_counted(
        label, lambda: (solver.solve(host)[0], solver.last_mg),
        levels_of((1, 1)), "cuda", totals)
    del host
    check(out_host.shape == (1, H, W) and bool(np.isfinite(out_host).all()),
          f"{label}: result not finite or of shape {out_host.shape}")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    (out_a, res), resident = host_seconds(solve((1, 1), "cuda"))
    peak = torch.cuda.max_memory_allocated(dev)
    stencil.reset_launch_counts()  # counted once, in the first run
    check(res.cycles == res_a.cycles and res.residuals == res_a.residuals,
          f"{label}: resident run {res.cycles} cycles, first {res_a.cycles}")
    check(torch.equal(out_a, torch.from_numpy(out_host).to(dev)),
          f"{label}: the resident field differs from JacobiSolver's")
    del out_host
    rows.append(mg_row(
        label, res_a, counts, per, first, seconds_first=first,
        seconds_resident=resident,
        measured_s_per_cycle=resident / res_a.cycles, max_units=budget,
        max_memory_allocated=peak, allocated_before=before,
        fields_at_peak=(peak - before) / field_bytes, card=card))

    # (b) cuda at 2x2: the 1x1 field, bit for bit.
    label = f"config 5 multigrid jacobi3 {H}x{W} f32 cuda 2x2"
    out_b, res_b, counts, per, secs = mg_counted(
        label, solve((2, 2), "cuda"), levels_of((2, 2)), "cuda", totals)
    check(res_b.cycles == res_a.cycles and torch.equal(out_b, out_a),
          f"{label}: differs from cuda 1x1 ({res_b.cycles} cycles, "
          f"{res_a.cycles})")
    del out_b
    rows.append(mg_row(label, res_b, counts, per, secs, bitwise_1x1=True,
                       card=card))

    # (c) the plain shifted run on the card: the reference.  jacobi3's
    # taps and the transfers' weights are dyadic, so every product is exact
    # and the kernels' FMA gives the plain bits: the fields and every
    # cycle's residual must be equal, not close.
    (out_d, res_d), shifted_s = host_seconds(solve((1, 1), "shifted"))
    stencil.reset_launch_counts()  # not main-path launches
    field_max = float(out_d.abs().max())
    err_a = float((out_a - out_d).abs_().max())
    print(f"config 5 multigrid: max |field| {field_max} after "
          f"{res_d.cycles} cycles; cuda max err vs shifted {err_a}")
    check(res_a.residuals == res_d.residuals and torch.equal(out_a, out_d),
          f"config 5 multigrid cuda: {res_a.cycles} cycles against "
          f"shifted's {res_d.cycles}, residuals {res_a.residuals} against "
          f"{res_d.residuals}, max err {err_a} (max |field| {field_max})")
    rows[0].update(max_abs_err_vs_shifted=err_a, bitwise_shifted=True,
                   max_abs_field=field_max)
    del out_a

    # (d) cuda_rdma at 4x4: K4 on the fine levels, K3 on the small blocks.
    g = MG_RDMA_GRID
    label = f"config 5 multigrid jacobi3 {H}x{W} f32 cuda_rdma {g[0]}x{g[1]}"
    out_c, res_c, counts, per, secs = mg_counted(
        label, solve(g, "cuda_rdma"), levels_of(g), "cuda_rdma", totals)
    err_c = float((out_c - out_d).abs_().max())
    print(f"{label}: max err vs shifted {err_c}")
    check(res_c.residuals == res_d.residuals and torch.equal(out_c, out_d),
          f"{label}: {res_c.cycles} cycles against shifted's "
          f"{res_d.cycles}, residuals {res_c.residuals} against "
          f"{res_d.residuals}, max err {err_c} (max |field| {field_max})")
    del out_c, out_d
    rows.append(mg_row(label, res_c, counts, per, secs,
                       max_abs_err_vs_shifted=err_c, bitwise_shifted=True,
                       max_abs_field=field_max, card=card))
    rows.append(mg_row(f"config 5 multigrid jacobi3 {H}x{W} f32 shifted 1x1",
                       res_d, {}, {}, shifted_s, card=card))
    torch.cuda.empty_cache()
    print("config 5 work units to tol 1e-3 (cap "
          f"{budget}): " + json.dumps({
              "jacobi": {"work_units": jacobi_row["iters"],
                         "converged": jacobi_row["converged"],
                         "final_diff": jacobi_row["final_diff"]},
              "multigrid": {"work_units": res_a.work_units,
                            "converged": res_a.converged,
                            "final_residual": res_a.residual,
                            "cycles": res_a.cycles},
              "jacobi_over_multigrid_at_least": (
                  jacobi_row["iters"] / res_a.work_units
                  if res_a.converged else None)}))

    # (e) run --converge 0.5 --solver multigrid through the CLI on BASELINE
    # config 1's grey image.
    rows_, cols_ = RGB_HW
    img = imageio.generate_test_image(rows_, cols_, "grey", seed=2)
    src = tmp / "mg.raw"
    imageio.write_raw(src, img)

    def cli(extra, dst):
        argv = ["run", str(src), str(rows_), str(cols_),
                str(CONVERGE_CLI_MAX), "grey", "-o", str(dst), "--converge",
                "0.5", "--solver", "multigrid"] + extra
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        check(rc == 0, f"cli {extra}: exited {rc}")
        line = buf.getvalue().strip().splitlines()[-1]
        return line, int(line.split()[2])

    ref_dst = tmp / "mg.shifted.raw"
    ref_line, ref_cycles = cli(["--backend", "shifted"], ref_dst)
    stencil.reset_launch_counts()  # not main-path launches
    ref = imageio.read_raw(ref_dst, rows_, cols_, "grey")
    grid16 = f"{GREY_GRID[0]}x{GREY_GRID[1]}"
    for backend, extra, shape in (
            ("cuda", ["--backend", "cuda"], (1, 1)),
            ("cuda_rdma", ["--backend", "cuda_rdma", "--mesh", grid16],
             GREY_GRID)):
        dst = tmp / f"mg.{backend}.raw"
        label = (f"cli run --converge 0.5 --solver multigrid grey "
                 f"{rows_}x{cols_} blur3 {' '.join(extra)}")
        levels = mg.plan_levels(make_grid(shape, dev), RGB_HW, 1)
        per = mg.cycle_launches(levels, backend, 1)
        stencil.reset_launch_counts()
        (line, cycles), secs = host_seconds(lambda: cli(extra, dst))
        counts = stencil.launch_counts()
        want = {k: v * cycles for k, v in per.items()}
        check(counts == want and any(counts.values()),
              f"{label}: launches {counts}, expected {want}")
        for k, v in counts.items():
            totals[k] += v
        out = imageio.read_raw(dst, rows_, cols_, "grey")
        delta = np.abs(out.astype(int) - ref.astype(int))
        # blur3's taps are dyadic too: the bytes of the shifted run.
        check(line.split("->")[0] == ref_line.split("->")[0]
              and np.array_equal(out, ref),
              f"{label}: said {line!r}, shifted {ref_line!r}, max byte "
              f"delta {int(delta.max())}")
        stencil.reset_launch_counts()
        _, warm = host_seconds(lambda: cli(extra, dst))
        stencil.reset_launch_counts()  # counted once, in the first run
        print(f"multigrid {label}: {line}")
        rows.append({"path": label, "said": line, "cycles": cycles,
                     "launches": counts, "launches_per_cycle": per,
                     "level_grids": [f"{lv.grid.rows}x{lv.grid.cols}"
                                     for lv in levels],
                     "bytes_differing_from_shifted": int((delta > 0).sum()),
                     "seconds_first": secs, "seconds_warm": warm,
                     "card": card})
    return rows


# ---------------------------------------------------------------------------
# Phase 4e: the host tools (ROADMAP item 12)
# ---------------------------------------------------------------------------


def cpu_brand(tmp: Path) -> str:
    """The host CPU's brand string from ``cpuid`` (x86), for a host whose
    ``/proc/cpuinfo`` does not name its model (some virtualised hosts)."""
    src, exe = tmp / "brand.cpp", tmp / "brand"
    src.write_text(
        "#include <cpuid.h>\n#include <cstdio>\n#include <cstring>\n"
        "int main() { unsigned r[12] = {0}; char s[49] = {0};\n"
        "  for (unsigned i = 0; i < 3; ++i)\n"
        "    __get_cpuid(0x80000002u + i, &r[4 * i], &r[4 * i + 1],\n"
        "                &r[4 * i + 2], &r[4 * i + 3]);\n"
        "  std::memcpy(s, r, 48); std::puts(s); }\n")
    res = subprocess.run(["g++", "-O1", "-o", str(exe), str(src)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        return f"not known (cpuid: {res.stderr.strip()[:120]})"
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=60)
    return run.stdout.strip() or "not known"


def host_tools_phase(dev, tmp: Path, native_build_s: float) -> dict:
    """``serial --impl native`` on BASELINE config 1 (grey 1920x2520,
    blur3, 100 iterations) byte-equal to the NumPy oracle, with the host
    CPU and its threads (and the strict one-thread baseline,
    ``bench_oracle_proxy``); ``bench`` on RGB 1920x2520 cuda_sep bf16 fuse
    32; ``bench_halo_p50`` at BASELINE config 2's block (960x1260 RGB on
    2x2, r = 1) and config 3's (2048x2048 grey on 4x4, r = 2); ``convert``
    and ``info`` once each."""
    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.native import build as nbuild
    from parallel_convolution_tpu_torch.native import serial_native
    from parallel_convolution_tpu_torch.ops import oracle
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import bench, imageio

    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main([str(a) for a in argv])
        check(rc == 0, f"cli {argv[0]}: exited {rc}")
        return buf.getvalue().strip().splitlines()

    out = {"native_build_s": native_build_s}
    rows_, cols_ = RGB_HW
    img = imageio.generate_test_image(rows_, cols_, "grey", seed=2)
    src, dst = tmp / "config1.raw", tmp / "config1.native.raw"
    imageio.write_raw(src, img)
    t0 = time.perf_counter()
    said = cli(["serial", src, rows_, cols_, ITERS, "grey", "-o", dst,
                "--impl", "native"])
    secs = time.perf_counter() - t0
    check(said[-1].startswith("serial[native]:"), f"serial said {said}")
    t0 = time.perf_counter()
    want = oracle.run_serial_u8(img, get_filter("blur3"), ITERS)
    oracle_s = time.perf_counter() - t0
    check(np.array_equal(imageio.read_raw(dst, rows_, cols_, "grey"), want),
          "serial --impl native differs from the NumPy oracle")
    px = rows_ * cols_ * ITERS
    out["serial_native"] = {
        "path": f"cli serial --impl native grey {rows_}x{cols_} blur3 "
                f"{ITERS} iterations",
        "seconds": secs, "gpx_per_s": px / secs / 1e9,
        "threads": serial_native.num_threads(),
        "cpuinfo_model": nbuild.host_cpu(), "cpuid_brand": cpu_brand(tmp),
        "os_cpu_count": os.cpu_count(), "oracle_seconds": oracle_s,
        "oracle_gpx_per_s": px / oracle_s / 1e9, "byte_equal_oracle": True}
    out["serial_one_thread"] = bench.bench_oracle_proxy(RGB_HW, iters=2,
                                                        reps=3)
    check(out["serial_one_thread"]["impl"] == "cpp-serial",
          f"the one-thread baseline ran {out['serial_one_thread']['impl']}")

    row = json.loads(cli(["bench", rows_, cols_, ITERS, "rgb", "--backend",
                          "cuda_sep", "--storage", "bf16", "--fuse", "32"])[-1])
    check(row["effective_backend"] == "cuda_sep" and row["gpixels_per_s"] > 0
          and row["device_kind"] == torch.cuda.get_device_name(dev)
          and row["power_limit_w"] is not None, f"bench row {row}")
    out["bench"] = row

    out["halo_p50_config2"] = bench.bench_halo_p50(
        (960, 1260), r=1, grid=make_grid((2, 2), dev), trials=20,
        chain_rounds=128, channels=3)
    out["halo_p50_config3"] = bench.bench_halo_p50(
        (2048, 2048), r=2, grid=make_grid((4, 4), dev), trials=20,
        chain_rounds=64)
    for key in ("halo_p50_config2", "halo_p50_config3"):
        h = out[key]
        check(h["p50_us"] is not None or h.get("noise_floor"),
              f"{key}: {h}")

    pgm = tmp / "config1.pgm"
    cli(["convert", dst, rows_, cols_, "grey", "-o", pgm])
    head = f"P5\n{cols_} {rows_}\n255\n".encode()
    check(pgm.read_bytes() == head + want.tobytes(),
          "convert: the PGM is not the header and the image's bytes")
    info = cli(["info"])
    check(any(torch.cuda.get_device_name(dev) in ln for ln in info),
          f"info did not name the card: {info}")
    out["info"] = info
    return out


# ---------------------------------------------------------------------------
# Phase 4c: the huge-image workflow — BASELINE config 4 through
# run --sharded-io, checkpoints and backend fallback
# ---------------------------------------------------------------------------


def machine_room(work: Path) -> dict:
    """Free disk where the config-4 files go, and the host's RAM (GB)."""
    import shutil

    work.mkdir(parents=True, exist_ok=True)
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                mem[key] = int(value.split()[0]) * 1024 / 1e9
    return {"disk_free_gb": shutil.disk_usage(work).free / 1e9,
            "work": str(work), "ram_total_gb": mem.get("MemTotal"),
            "ram_available_gb": mem.get("MemAvailable")}


def host_rss() -> int:
    """This process's resident set now, in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise SmokeFailure("no VmRSS in /proc/self/status")


@contextlib.contextmanager
def host_rss_growth(out: dict):
    """Sample the resident set every 10 ms in a thread while the block
    runs; ``out["growth"]``: its peak over its size at the start."""
    import threading

    stop, start = threading.Event(), host_rss()
    peak = [start]

    def sample():
        while not stop.wait(0.01):
            peak[0] = max(peak[0], host_rss())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()
        out["growth"] = max(peak[0], host_rss()) - start


def config4_side(free_bytes: float) -> int:
    """The side of the square RGB image the phase runs: BASELINE config
    4's 65536 when the input and one output fit on the disk with 10% to
    spare, else the largest multiple of 4096 that does (a printed cut)."""
    side = CONFIG4_SIDE
    while side > 4096 and 2 * 3 * side * side * 1.1 > free_bytes:
        side -= 4096
    return side


def write_seeded_raw(path: Path, side: int, dev, seed: int) -> float:
    """A seeded side x side RGB u8 image, made on the card a row band at a
    time by an explicit generator (uniform bytes plus a 256-pixel
    checkerboard ramp, so that the filter has edges to blur) and written
    with ``imageio.write_block``; returns the seconds."""
    import torch

    from parallel_convolution_tpu_torch.utils import imageio

    t0 = time.perf_counter()
    imageio.allocate_raw(path, side, side, "rgb")
    gen = torch.Generator(device=dev).manual_seed(seed)
    band = max(1, (64 << 20) // (3 * side))
    cols = torch.arange(side, device=dev)[None, :, None] // 256
    chan = torch.arange(3, device=dev)[None, None, :] * 85
    for r0 in range(0, side, band):
        n = min(band, side - r0)
        rows = torch.arange(r0, r0 + n, device=dev)[:, None, None] // 256
        noise = torch.randint(0, 64, (n, side, 3), generator=gen, device=dev,
                              dtype=torch.int32)
        img = (noise + ((rows + cols) * 37 + chan) % 192).to(torch.uint8)
        imageio.write_block(path, side, side, "rgb", r0, 0,
                            img.cpu().numpy())
    return time.perf_counter() - t0


@contextlib.contextmanager
def timed_sharded_io(times: dict):
    """Add the host seconds of every ``sharded_io.load_sharded`` and
    ``save_sharded`` call (the card synchronised on both sides) to
    ``times`` while the block runs."""
    import torch

    from parallel_convolution_tpu_torch.utils import sharded_io

    orig = {n: getattr(sharded_io, n) for n in ("load_sharded",
                                                  "save_sharded")}

    def wrap(name):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](*args, **kwargs)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for name in orig:
        setattr(sharded_io, name, wrap(name))
    try:
        yield times
    finally:
        for name, fn in orig.items():
            setattr(sharded_io, name, fn)


def oracle_windows(src: Path, dst: Path, side: int, filt) -> list:
    """Every config-4 window of the written output against the NumPy oracle
    on the input crop that reaches ITERS * r pixels beyond it (clamped to
    the image, whose edge is the true zero boundary; every other edge of a
    crop is that far from the window), read back from the files; one
    thread a window.  Returns the windows."""
    from concurrent.futures import ThreadPoolExecutor

    from parallel_convolution_tpu_torch.ops import oracle
    from parallel_convolution_tpu_torch.utils import imageio

    s, m, half, q = WINDOW, ITERS * filt.radius, side // 2, side // 4
    wins = [(0, 0), (0, side - s), (side - s, 0), (side - s, side - s),
            (half - s // 2, half - s // 2), (side - s, half - s // 2),
            (half - s // 2, side - s),
            # the 4x4 grid's seams: (16384, 16384) and (32768, 49152)
            (q - s // 2, q - s // 2), (half - s // 2, 3 * q - s // 2)]

    def one(win):
        y, x = win
        cy0, cx0 = max(0, y - m), max(0, x - m)
        cy1, cx1 = min(side, y + s + m), min(side, x + s + m)
        crop = imageio.read_block(src, side, side, "rgb", cy0, cy1, cx0, cx1)
        want = oracle.run_serial_u8(crop, filt, ITERS)[
            y - cy0:y - cy0 + s, x - cx0:x - cx0 + s]
        got = imageio.read_block(dst, side, side, "rgb", y, y + s, x, x + s)
        return bool((got == want).all())

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        ok = list(ex.map(one, wins))
    bad = [w for w, good in zip(wins, ok) if not good]
    check(not bad, f"config 4: windows {bad} differ from the NumPy oracle")
    return wins


def band_crcs(path: Path) -> list:
    """CRC32 of the file in 256 MB bands, one thread a band at a time."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    band = 256 << 20

    def crc(i):
        with open(path, "rb") as f:
            f.seek(i * band)
            return zlib.crc32(f.read(band))

    n = -(-path.stat().st_size // band)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        return list(ex.map(crc, range(n)))


def config4_kernel_rows(dev, side: int) -> dict:
    """K2 and K4 at config 4's shapes on the card, each beside its bound
    (``level_ops``, ``bound``): K2 T = 16 as the 1x1 run's second
    level-group launch (u8 in, u8 out; the first reads 0.1% more) and its
    T = 4 tail; K4 T = 16 on
    the 4x4 grid's 16 blocks (the exchange in the launch, 16 ghost rows
    out), K2 T = 16 on one such extended block, and K4's T = 4 tail.  The
    plain versions at these shapes would need more than the card's memory
    (their f32 levels): none is timed; no one PyTorch call runs T levels."""
    import torch

    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter

    f, r, C = get_filter("blur3"), 1, 3
    gen = torch.Generator(device=dev).manual_seed(4)
    u8 = dict(dtype=torch.uint8, device=dev)
    valid = (side, side)
    rows = {}

    def k2_row(T, hw, sep, reps=3):
        h, w = hw
        p = torch.randint(0, 256, (C, h + 2 * r * T, w + 2 * r * T),
                          generator=gen, **u8)
        kw = dict(quantize=True, out_dtype=torch.uint8, separable=sep)
        ms = cuda_ms(lambda: stencil.fused_iterate(p, (0, 0), f, T, valid,
                                                   **kw), reps=reps,
                     warmup=1)
        ops = sum(C * level_ops(f, sep, h + 2 * r * (T - s),
                                w + 2 * r * (T - s), True, True)
                  for s in range(1, T + 1))
        b_ms, b_by = bound(p.numel() + C * h * w, ops)
        del p
        torch.cuda.empty_cache()
        return dict(shape=[C, h + 2 * r * T, w + 2 * r * T], T=T,
                    separable=sep, ms=ms, bound_ms=b_ms, bound_by=b_by,
                    fraction_of_bound=b_ms / ms, plain_ms=None,
                    library_ms=None)

    def k4_row(T, ext, grid_shape, reps=3):
        nb = grid_shape[0] * grid_shape[1]
        h, w = side // grid_shape[0], side // grid_shape[1]
        x = torch.randint(0, 256, (nb, C, h, w), generator=gen, **u8)
        fire, out = rdma._bind(True, x, f, grid_shape, "zero", T, valid,
                               True, torch.uint8, ext, stencil.FUSED_TILE)
        ms = cuda_ms(fire, reps=reps, warmup=1)
        ops = nb * C * T * level_ops(f, False, h + 2 * ext, w + 2 * ext,
                                     True, False)
        b_ms, b_by = bound(x.numel() + out.numel(), ops)
        del x, out, fire
        torch.cuda.empty_cache()
        return dict(grid=list(grid_shape), block=[C, h, w], T=T, ext=ext,
                    ms=ms, bound_ms=b_ms, bound_by=b_by,
                    fraction_of_bound=b_ms / ms, plain_ms=None,
                    library_ms=None)

    rows["fused_iterate 1x1 T=16 group"] = k2_row(16, (side, side), True)
    rows["fused_iterate 1x1 T=4 tail"] = k2_row(4, (side, side), True)
    q = side // 4
    rows["rdma_tiled 4x4 T=16 group"] = k4_row(16, 16, (4, 4))
    rows["fused_iterate 4x4 block T=16 group"] = k2_row(16, (q, q), False,
                                                        reps=10)
    rows["rdma_tiled 4x4 T=4 tail"] = k4_row(4, 0, (4, 4))
    return rows


def config4_phase(dev, work: Path, totals: dict) -> dict:
    """BASELINE config 4 (3x3 blur, 65536x65536 RGB, 100 iterations) from a
    seeded file through ``run --sharded-io`` twice: (a) 1x1 ``cuda_sep`` u8
    fuse 32 (K2) and (b) 4x4 ``cuda_rdma`` u8 fuse 32 (K4 and K2), the
    counters at 0 before each and read after.  Oracle windows of (a)'s
    output file; (b)'s file byte-equal to (a)'s by CRC32 in bands; at most
    the input and one output on disk.  Its bands are read through the
    native reader (``main`` builds the library first)."""
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import halo
    from parallel_convolution_tpu_torch.utils import sharded_io

    room = machine_room(work)
    side = config4_side(room["disk_free_gb"] * 1e9)
    print("config 4 machine: " + json.dumps(room))
    if side != CONFIG4_SIDE:
        print(f"config 4 CUT: {side}x{side} RGB, not {CONFIG4_SIDE}: "
              f"{room['disk_free_gb']:.1f} GB free at {work} hold no "
              f"input and output of the full size")
    blur3 = get_filter("blur3")
    src, dst = work / "config4.raw", work / "config4.out.raw"
    report = {"side": side, "room": room,
              "write_input_s": write_seeded_raw(src, side, dev, seed=4)}
    px = 3 * side * side
    runs = {}
    for key, flags, expect, no_halo in (
            ("1x1 cuda_sep", ["--backend", "cuda_sep"],
             expected_launches(blur3, 32, (side, side)), False),
            ("4x4 cuda_rdma", ["--backend", "cuda_rdma", "--mesh", "4x4"],
             expected_rdma_launches(blur3, 32, (4, 4),
                                    (side // 4, side // 4)), True)):
        label = f"config 4 {side}x{side} rgb blur3 {key} u8 fuse 32"
        argv = ["run", str(src), str(side), str(side), str(ITERS), "rgb",
                "-o", str(dst), "--sharded-io", "--storage", "u8",
                "--fuse", "32", *flags]

        def run_cli():
            rc = cli_main(argv)
            check(rc == 0, f"{label}: the CLI exited {rc}")

        torch.cuda.reset_peak_memory_stats()
        io_s, rss = {}, {}
        with timed_sharded_io(io_s), host_rss_growth(rss):
            _, counts, secs = drive(label, run_cli, expect, px,
                                    no_halo=no_halo)
        # What the run added to the host's resident set at its peak: bands
        # of BAND_BYTES, never a block (12.9 GB at 1x1).
        growth = rss["growth"]
        check(growth < HOST_GROWTH_LIMIT,
              f"{label}: the host's resident set grew by {growth} B")
        for k, v in counts.items():
            totals[k] += v
        halo_calls = halo.halo_exchange.calls
        row = {"launches": counts, "halo_exchange_calls": halo_calls,
               "seconds_first": secs, "gpx_per_s_first": px * ITERS / secs
               / 1e9, "read_and_copy_in_s": io_s.get("load_sharded"),
               "copy_out_and_write_s": io_s.get("save_sharded"),
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "host_peak_growth_bytes": growth}
        if key.startswith("1x1"):
            t0 = time.perf_counter()
            row["windows"] = oracle_windows(src, dst, side, blur3)
            row["windows_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        row["crcs"] = band_crcs(dst)
        row["crc_s"] = time.perf_counter() - t0
        dst.unlink()
        runs[key] = row
    check(runs["1x1 cuda_sep"]["crcs"] == runs["4x4 cuda_rdma"]["crcs"],
          "config 4: the 4x4 cuda_rdma output differs from the 1x1 cuda_sep "
          "output")
    src.unlink()
    for row in runs.values():
        row["crcs"] = len(row["crcs"])
    report["runs"] = runs
    # main() built the native library first: the bands were read through it.
    report["reader"] = sharded_io.default_reader()
    check(report["reader"] == "native",
          f"config 4 read through the {report['reader']} reader")
    report["kernels"] = config4_kernel_rows(dev, side)
    k = report["kernels"]
    # Kernel time of each run: the launches it counted times the event time
    # at their shape (the 1x1 run's first group reads a slightly larger
    # block).  The last chunk's ITERS % 32 levels are one launch of the
    # kernel that starts a chunk (K2 at 1x1, K4 at 4x4); every other launch
    # runs a group of 16.
    tail = 1 if ITERS % 32 else 0
    c = runs["1x1 cuda_sep"]["launches"]
    runs["1x1 cuda_sep"]["kernels_s"] = (
        (c["fused_iterate"] - tail) * k["fused_iterate 1x1 T=16 group"]["ms"]
        + tail * k["fused_iterate 1x1 T=4 tail"]["ms"]) / 1e3
    c = runs["4x4 cuda_rdma"]["launches"]
    runs["4x4 cuda_rdma"]["kernels_s"] = (
        (c["rdma_tiled"] - tail) * k["rdma_tiled 4x4 T=16 group"]["ms"]
        + tail * k["rdma_tiled 4x4 T=4 tail"]["ms"]
        + c["fused_iterate"]
        * k["fused_iterate 4x4 block T=16 group"]["ms"]) / 1e3
    for row in runs.values():
        row["host_s"] = row["seconds_first"] - row["kernels_s"]
    return report


def ckpt_argv(src: Path, dst: Path, ck: Path, mesh_spec: str) -> list:
    return ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]), str(ITERS),
            "grey", "-o", str(dst), "--filter", "edge5", "--checkpoint",
            str(ck), "--checkpoint-every", str(CKPT_EVERY), "--backend",
            "cuda_rdma", "--mesh", mesh_spec]


def killed_run(argv: list, here: Path) -> dict:
    """The first process: the ``run`` CLI in a child process with a fault
    plan that tears the second snapshot; it must die with the fault."""
    env = dict(os.environ, PCTPU_FAULTS=f"checkpoint_write_shard:{CKPT_KILL}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "parallel_convolution_tpu_torch", *argv],
                          cwd=here, env=env, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode != 0 and "injected fault at "
          f"'checkpoint_write_shard' (hit {CKPT_KILL}" in proc.stderr,
          f"checkpoint: the faulted process exited {proc.returncode} without "
          f"the injected fault: {proc.stderr[-2000:]}")
    return {"rc": proc.returncode, "seconds": time.perf_counter() - t0}


def checkpoint_phase(dev, tmp: Path, here: Path, refs: dict,
                     totals: dict) -> dict:
    """BASELINE config 3's image (8192x8192 grey edge5, 100 iterations) with
    ``--checkpoint --checkpoint-every 25 --backend cuda_rdma --mesh 4x4``:
    a child process dies in the second snapshot; this process resumes from
    iteration 25 (75 K4 launches), byte-equal to an uninterrupted
    ``--sharded-io`` run and to ``shifted``; a second torn run resumes on
    ``--mesh 2x2`` with the reshard warning and the same bytes; then
    ``save_state`` / ``load_state`` timed on the snapshot."""
    import warnings

    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils import checkpoint, imageio

    src = tmp / "edge5.raw"  # written by main_paths
    want = refs["grey_refs"]["edge5"]
    report = {}

    def resumed(label, argv, expect):
        def run():
            rc = cli_main(argv)
            check(rc == 0, f"{label}: the CLI exited {rc}")

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, counts, secs = drive(label, run, expect, BIG_HW[0] * BIG_HW[1])
        for k, v in counts.items():
            totals[k] += v
        check(np.array_equal(imageio.read_raw(argv[7], *BIG_HW, "grey"),
                             want), f"{label}: differs from shifted")
        return counts, secs, [str(w.message) for w in caught]

    def torn(ck):
        report.setdefault("killed", []).append(
            killed_run(ckpt_argv(src, tmp / "ck_dead.raw", ck, "4x4"), here))
        latest = (ck / checkpoint.LATEST_NAME).read_text()
        check(latest == f"it_{CKPT_EVERY:08d}",
              f"checkpoint: LATEST is {latest} after the kill")
        check(not (ck / f"it_{2 * CKPT_EVERY:08d}"
                   / checkpoint.META_NAME).exists(),
              "checkpoint: the torn snapshot has a meta")

    k4 = {"stencil_step": 0, "fused_iterate": 0, "rdma_block": 0}
    ck = tmp / "ck4"
    torn(ck)
    counts, secs, _ = resumed(
        "checkpoint resume 4x4 cuda_rdma from 25",
        ckpt_argv(src, tmp / "ck_resume.raw", ck, "4x4"),
        dict(k4, rdma_tiled=ITERS - CKPT_EVERY))
    report["resume"] = {"launches": counts, "seconds": secs}
    counts, secs, _ = resumed(
        "uninterrupted --sharded-io 4x4 cuda_rdma f32",
        ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]), str(ITERS), "grey",
         "-o", str(tmp / "ck_whole.raw"), "--filter", "edge5", "--sharded-io",
         "--backend", "cuda_rdma", "--mesh", "4x4"],
        dict(k4, rdma_tiled=ITERS))
    report["uninterrupted"] = {"launches": counts, "seconds": secs}
    check((tmp / "ck_resume.raw").read_bytes()
          == (tmp / "ck_whole.raw").read_bytes(),
          "checkpoint: the resumed run differs from the uninterrupted one")

    ck2 = tmp / "ck2"
    torn(ck2)
    counts, secs, caught = resumed(
        "checkpoint resume onto 2x2 from 25",
        ckpt_argv(src, tmp / "ck_2x2.raw", ck2, "2x2"),
        dict(k4, rdma_tiled=ITERS - CKPT_EVERY))
    check(any(f"from grid 4x4 onto 2x2" in m for m in caught),
          f"checkpoint: no reshard warning in {caught}")
    report["reshard"] = {"launches": counts, "seconds": secs,
                         "warnings": caught}

    # save_state / load_state on the 4x4 snapshot, timed.
    grid = make_grid((4, 4), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks, meta = checkpoint.load_state(ck, grid)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint.save_state(tmp / "ck_saved", blocks, meta)
    save_s = time.perf_counter() - t0
    report.update(load_s=load_s, save_s=save_s, snapshot_bytes=sum(
        s["bytes"] for s in meta["shards"].values()),
        snapshot=f"it_{meta['iters_done']:08d}")
    return report


def fallback_phase(dev, tmp: Path, refs: dict, totals: dict) -> dict:
    """``--fallback`` on BASELINE config 3's image: with
    ``PCTPU_FAULTS=backend_compile:1`` ``cuda_rdma`` degrades to ``cuda``
    (warned, named in the summary line, the same bytes); without a fault
    every ``--fallback`` run keeps the backend asked for (the probe ran
    the real kernel at the real block size: its launches are counted);
    with every tier refused the walk stops at ``cuda`` and raises, with no
    launch; and a real refused launch (5b over the opt-in limit) is named
    by the runtime and classifies as transient, a canary launch after it
    passing."""
    import warnings

    import numpy as np
    import torch

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.ops import _build, rdma, stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.probes import smem_budget
    from parallel_convolution_tpu_torch.resilience import (
        degrade, faults, retry,
    )
    from parallel_convolution_tpu_torch.utils import imageio

    src, want = tmp / "edge5.raw", refs["grey_refs"]["edge5"]
    edge5 = get_filter("edge5")
    block = (BIG_HW[0] // 4, BIG_HW[1] // 4)
    report = {}

    def plus(run, probe):
        return {k: run.get(k, 0) + probe.get(k, 0) for k in KERNELS}

    # bf16, fuse 32 (--fast's).  Each run's launches are its own plus the
    # probe's one 32-level chunk at the real block.
    rdma_groups = len(rdma.rdma_plan(edge5.radius, 32, block).groups)
    k2_groups = lambda hw: len(stencil.fused_plan(edge5.radius, 32, hw)[2])
    on_grid = {k: 16 * v for k, v in
               expected_launches(edge5, 32, block).items()}

    def run(label, flags, expect, fault=None):
        dst = tmp / "fallback.raw"
        argv = ["run", str(src), str(BIG_HW[0]), str(BIG_HW[1]), str(ITERS),
                "grey", "-o", str(dst), "--filter", "edge5", "--storage",
                "bf16", "--fuse", "32", "--fallback", *flags]
        degrade.clear_probe_cache()
        if fault:
            os.environ["PCTPU_FAULTS"] = fault
        out = io.StringIO()

        def call():
            with contextlib.redirect_stdout(out):
                rc = cli_main(argv)
            check(rc == 0, f"{label}: the CLI exited {rc}")

        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _, counts, secs = drive(label, call, expect,
                                        BIG_HW[0] * BIG_HW[1],
                                        no_halo="cuda_rdma" in flags
                                        and not fault)
        finally:
            os.environ.pop("PCTPU_FAULTS", None)
            faults.uninstall_plan()
            degrade.clear_probe_cache()
        for k, v in counts.items():
            totals[k] += v
        line = out.getvalue().strip().splitlines()[-1]
        print(f"{label}: {line}")
        check(np.array_equal(imageio.read_raw(dst, *BIG_HW, "grey"), want),
              f"{label}: differs from shifted")
        return {"launches": counts, "seconds": secs, "summary": line,
                "warnings": [str(w.message)[:160] for w in caught
                             if issubclass(w.category,
                                           degrade.BackendDegradedWarning)]}

    report["cuda_rdma"] = run(
        "fallback cuda_rdma 4x4, no fault",
        ["--backend", "cuda_rdma", "--mesh", "4x4"],
        plus(expected_rdma_launches(edge5, 32, (4, 4), block),
             {"rdma_tiled": 1, "fused_iterate": 16 * (rdma_groups - 1)}))
    report["cuda_sep"] = run(
        "fallback cuda_sep 1x1, no fault", ["--backend", "cuda_sep"],
        plus(expected_launches(edge5, 32, BIG_HW),
             {"fused_iterate": k2_groups(BIG_HW)}))
    for key, name in (("cuda_rdma", "cuda_rdma"), ("cuda_sep", "cuda_sep")):
        r = report[key]
        check(f"({name}, bf16, fuse 32," in r["summary"]
              and not r["warnings"],
              f"fallback: {name} did not stay {name}: {r}")
    # The fault fails the cuda_rdma probe's build (no launch); the cuda
    # probe runs one chunk on every block, then the run on cuda.
    report["degraded"] = run(
        "fallback cuda_rdma 4x4, backend_compile:1",
        ["--backend", "cuda_rdma", "--mesh", "4x4"],
        plus(on_grid, {"fused_iterate": 16 * k2_groups(block)}),
        fault="backend_compile:1")
    r = report["degraded"]
    check("(cuda_rdma degraded to cuda, bf16, fuse 32," in r["summary"]
          and any("'cuda_rdma' degraded to 'cuda'" in w
                  for w in r["warnings"]),
          f"fallback: the injected fault did not degrade to cuda: {r}")

    # Every tier refused on the card: the walk stops at cuda and raises;
    # nothing runs the plain version in a kernel's place, nothing launches.
    stencil.reset_launch_counts()
    degrade.clear_probe_cache()
    stopped = None
    try:
        with faults.injected("backend_compile:*"):
            degrade.resolve_backend(mesh.make_grid((4, 4), dev), edge5,
                                    "cuda_rdma", fuse=32, storage="bf16",
                                    block_hw=block)
    except retry.RetryExhausted as e:
        stopped = e
    finally:
        degrade.clear_probe_cache()
    launched = sum(stencil.launch_counts().values())
    check(stopped is not None and launched == 0,
          f"fallback: every tier refused on the card gave {stopped!r} "
          f"after {launched} launches, not RetryExhausted after none")
    report["every_tier_refused"] = {"error": str(stopped)[:160],
                                    "launches": launched}

    # A real refused launch: 5b asks for one byte over the opt-in limit.
    x = torch.ones(256, device=dev)
    _, attr, err = smem_budget.smem_probe(x, stencil._smem_limit(dev) + 1,
                                          True)
    code = attr or err
    check(code != 0, "fallback: the over-limit 5b launch was not refused")
    try:
        stencil._raise_on(code, "smem_probe (5b)")
    except RuntimeError as e:
        refused = e
    verdict = retry.classify(refused)
    # The names come from the runtime (pc_error_name), and the stand-ins
    # used before a library loads agree with it.
    lib = _build.load_library("probes")
    stand_ins = {c: lib.pc_error_name(c).decode()
                 for c in _build.FALLBACK_ERROR_NAMES}
    check(stand_ins == _build.FALLBACK_ERROR_NAMES,
          f"fallback: the runtime names {stand_ins} differ from the "
          f"stand-ins")
    out, attr, err = smem_budget.smem_probe(x, 0, False)
    torch.cuda.synchronize()
    canary = (attr, err) == (0, 0) and bool(torch.equal(out, x + 1))
    check(verdict == retry.TRANSIENT and canary,
          f"fallback: the refused launch ({refused}) classified {verdict}, "
          f"canary {'passed' if canary else 'failed'}")
    report["refused_launch"] = {"error": str(refused), "class": verdict,
                                "canary_ok": canary}
    return report


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
    # The same two calls queued ahead of the card: each one's device time.
    probe_dev_ms = cuda_ms(
        lambda: smem_budget.smem_probe(x, 100 * 1024, True), reps=200,
        warmup=20, queue_ahead=True)
    probe_lib_dev_ms = cuda_ms(lambda: torch.add(x, 1.0), reps=200,
                               warmup=20, queue_ahead=True)
    print("probe smem_probe times: " + json.dumps(dict(
        shape=list(smem_budget.SHAPE), bytes=100 * 1024, ms=probe_ms,
        device_ms=probe_dev_ms, add_ms=probe_lib_ms,
        add_device_ms=probe_lib_dev_ms,
        bound_ms=bound(2.0 * x.numel() * 4, float(x.numel()))[0],
        parent=SMEM_PARENT_MS)))
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
        from parallel_convolution_tpu_torch.native import build as nbuild
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
        # The g++ baseline before any file is read: every load_sharded of
        # this process (config 4's included) then reads through the native
        # reader, whatever an earlier run left under build/.
        t0 = time.perf_counter()
        nbuild.build()
        native_s = time.perf_counter() - t0
        print(f"native build: {native_s:.2f} s")
        for name in _build.SOURCES:
            _build.load_library(name)
        print_ptxas()

        check_kernels(dev)
        check_rdma_kernels(dev)
        probe = probe_phase(dev)

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            totals, rows, refs = main_paths(dev, Path(tmp))
            split_rows = interior_split_phase(dev, refs, totals)
            torch.cuda.empty_cache()
            work = here / "build" / "chip_smoke_volume"
            try:
                volume = volume_phase(dev, work)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            torch.cuda.empty_cache()
            keep = {}
            converge_rows = converge_phase(dev, Path(tmp), totals, keep)
            slots = separate_devices_phase(dev, Path(tmp), refs, totals,
                                           keep)
            t0 = time.perf_counter()
            overlap = overlap_phase(dev, Path(tmp), refs, totals, keep)
            overlap["seconds"] = time.perf_counter() - t0
            mg_rows = multigrid_phase(dev, Path(tmp), totals,
                                      keep.pop("config5"), converge_rows[0])
            torch.cuda.empty_cache()
            auto_rows = auto_paths(dev, Path(tmp), refs, rows, totals)
            picks = tune_auto_grids(Path(tmp))
            tuned = measured_tune(dev, Path(tmp), refs, totals)
            ckpt = checkpoint_phase(dev, Path(tmp), here, refs, totals)
            fallback = fallback_phase(dev, Path(tmp), refs, totals)
        work = here / "build" / "chip_smoke_config4"
        try:
            config4 = config4_phase(dev, work, totals)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            host_tools = host_tools_phase(dev, Path(tmp), native_s)

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
        for row in converge_rows:
            print("end to end converge: " + json.dumps(row))
        for row in mg_rows:
            print("end to end multigrid: " + json.dumps(row))
        for key, row in host_tools.items():
            print(f"host tools {key}: " + json.dumps(row))
        for row in auto_rows:
            print("end to end auto: " + json.dumps(row))
        for key, row in config4.pop("runs").items():
            print(f"end to end config 4 {key}: " + json.dumps(row))
        for key, row in config4.pop("kernels").items():
            print(f"time config 4 {key}: " + json.dumps(row))
        print("config 4: " + json.dumps(config4))
        print("checkpoint: " + json.dumps(ckpt))
        print("fallback: " + json.dumps(fallback))
        print("measured tune: " + json.dumps(tuned))
        host = time_host_calls(dev)
        print("time host calls: " + json.dumps(host))
        from parallel_convolution_tpu_torch.tuning import costmodel

        measured = hardware_constants(k1, k2, k4, probe["op_price"], host)
        committed = {k: getattr(costmodel.H100, k) for k in measured}
        print("hardware model: " + json.dumps(
            {"measured": measured, "committed": committed, "card": card}))
        volume_bounds(volume, measured["hbm_gbps"])
        for name, row in volume.pop("forms").items():
            print(f"volume {name}: " + json.dumps(row))
        print("volume: " + json.dumps(volume))
        for row in split_rows:
            print("end to end interior split: " + json.dumps(row))
        for row in slots.pop("runs"):
            print("end to end separate devices: " + json.dumps(row))
        slot_timed = slots.pop("timed")
        for name, row in slot_timed["kernels"].items():
            print(f"time {name}: " + json.dumps(row))
        print("probe col_mode: " + json.dumps(
            dict(slot_timed["probe"], card=card)))
        print("separate devices: " + json.dumps(slots))
        for row in overlap.pop("runs"):
            print("end to end overlap: " + json.dumps(row))
        region_timed = overlap.pop("timed")
        for name, row in region_timed.items():
            print(f"time {name}: " + json.dumps(row))
        print("overlap: " + json.dumps(overlap))
        check(all(totals[k] for k in KERNELS),
              f"a kernel never ran on a main path: {totals}")

        kernels = []
        for name, t in (("stencil_step", k1), ("fused_iterate", k2),
                        ("rdma_block", k3), ("rdma_tiled", k4),
                        *slot_timed["kernels"].items(),
                        *region_timed.items()):
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
