"""Measurements behind the level loop's launch shape (K2, K4; see
``csrc/stencil_common.cuh``), on the card.

Two commands, each printing one JSON object per measured point:

* ``sweep`` times K4 (one 32-level launch alone, and the whole
  ``cuda_rdma`` chunk as the planner splits it) and K2 (the wrapper call)
  at the main path's shapes -- RGB 1920x2520 blur3 bf16 T = 32 on a 2x2
  grid (K4) and on one block, separable (K2), and grey 8192x8192 edge5
  bf16 T = 32 (K2) -- over output tiles, threads per block and strip
  heights (one process per height, built with ``PCTPU_STRIP_V``), each
  point with the blocks one SM holds (the CUDA occupancy calculator); then
  K2 with the 32 levels forced into level groups of 32, 16, 8 and 4 at a
  few tiles.

      python -m parallel_convolution_tpu_torch.probes.loop_sweep sweep

* ``ab --parent DIR`` times the three kernels at those shapes in the
  checkout at DIR (another commit of this repository, say the parent of a
  change) and in this one, in turns: parent, this, this, parent, ... each
  turn in a process of its own importing that checkout's package and
  building its kernels there, each kernel checked byte-equal to its plain
  version in every turn.

      python parallel_convolution_tpu_torch/probes/loop_sweep.py ab --parent DIR

Both need the card; the card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]          # the checkout this file belongs to
RGB_HW, BIG_HW, T_LEVELS = (1920, 2520), (8192, 8192), 32
SWEEP_TILES = ((64, 64), (64, 128), (128, 64), (96, 96), (128, 128))
SWEEP_THREADS = (256, 512)
SWEEP_STRIPS = (8, 16)
GROUP_DEPTHS = (32, 16, 8, 4)
GROUP_TILES = ((64, 64), (64, 128), (96, 96))


def _card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""


def _inputs(dev):
    """The three main-path inputs: K2's deep-padded RGB and 8192^2 blocks,
    K4's stacked 2x2 RGB grid, all bf16, from the repository's seeded test
    images."""
    import torch

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import halo, mesh
    from parallel_convolution_tpu_torch.utils import imageio

    blur3, edge5 = get_filter("blur3"), get_filter("edge5")

    def padded(img, depth):
        x = torch.from_numpy(imageio.interleaved_to_planar(img).copy()).to(
            device=dev, dtype=torch.bfloat16)
        return halo.halo_exchange([[x]], depth, (1, 1), "zero")[0][0]

    rgb = imageio.generate_test_image(*RGB_HW, "rgb", seed=1)
    big = imageio.generate_test_image(*BIG_HW, "grey", seed=2)
    planar = imageio.interleaved_to_planar(rgb)
    blocks = convert.blocks_from_numpy(planar, mesh.make_grid((2, 2), dev),
                                       "bf16")
    return {
        "k2_rgb": (padded(rgb, blur3.radius * T_LEVELS), blur3, RGB_HW),
        "k2_edge5": (padded(big, edge5.radius * T_LEVELS), edge5, BIG_HW),
        "k4_rgb": (rdma.stack_blocks(blocks, (2, 2)), blur3, RGB_HW),
        "k4_blocks": blocks,
    }


def _time_k2(x, filt, valid, reps, check, tile=None):
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.utils.bench import cuda_ms

    args = (x, (0, 0), filt, T_LEVELS, valid)
    kw = dict(quantize=True, out_dtype=x.dtype, separable=True)
    if tile is not None:
        kw["tile"] = tile
    ok = None
    if check:
        ok = bool(torch.equal(stencil.fused_iterate(*args, **kw),
                              stencil.fused_iterate_plain(
                                  *args, quantize=True, out_dtype=x.dtype,
                                  separable=True)))
    return cuda_ms(lambda: stencil.fused_iterate(*args, **kw), reps), ok


def _time_k4(x, blocks, filt, valid, reps, check, tile=None, threads=None):
    import torch

    from parallel_convolution_tpu_torch.ops import rdma, stencil
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils.bench import cuda_ms

    tile = tile or stencil.FUSED_TILE
    if threads is not None:
        stencil.FUSED_THREADS = threads
    fire, out = rdma._bind(True, x, filt, (2, 2), "zero", T_LEVELS, valid,
                           True, None, 0, tile)
    ok = None
    if check:
        fire()
        want = rdma.fused_rdma_step_plain(blocks, filt, (2, 2), "zero",
                                          fuse=T_LEVELS, valid_hw=valid)
        ok = bool(torch.equal(
            mesh.join_blocks(rdma.unstack_blocks(out, (2, 2))),
            mesh.join_blocks(want)))
    blocks_per_sm = fire(occupancy=True) if threads is not None else None
    return cuda_ms(fire, reps), ok, blocks_per_sm


def worker_main(what: str) -> None:
    """Runs in a process whose ``sys.path`` starts at the checkout under
    test; prints one JSON line per point."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil

    dev = torch.device("cuda", 0)
    inp = _inputs(dev)

    def emit(row):
        print(json.dumps(row), flush=True)

    if what == "ab":
        x, f, valid = inp["k2_rgb"]
        ms, ok = _time_k2(x, f, valid, 10, True)
        emit({"kernel": "fused_iterate rgb blur3 bf16 T=32 sep", "ms": ms,
              "equal_plain": ok})
        x, f, valid = inp["k2_edge5"]
        ms, ok = _time_k2(x, f, valid, 5, True)
        emit({"kernel": "fused_iterate grey8k edge5 bf16 T=32", "ms": ms,
              "equal_plain": ok})
        x, f, valid = inp["k4_rgb"]
        ms, ok, _ = _time_k4(x, inp["k4_blocks"], f, valid, 20, True)
        emit({"kernel": "rdma_tiled rgb 2x2 blur3 bf16 T=32", "ms": ms,
              "equal_plain": ok})
        return

    from parallel_convolution_tpu_torch.ops import _build, rdma

    v = _build.load_library("stencil").pc_strip_height()
    x4, f4, valid4 = inp["k4_rgb"]
    for tile in SWEEP_TILES:
        for threads in SWEEP_THREADS:
            ms, ok, occ = _time_k4(x4, inp["k4_blocks"], f4, valid4, 10,
                                   tile == SWEEP_TILES[0] and threads == 256,
                                   tile, threads)
            emit({"kernel": "rdma_tiled rgb 2x2", "V": v, "tile": tile,
                  "threads": threads, "blocks_per_sm": occ, "ms": ms,
                  "equal_plain": ok})
            ms = _time_chunk(x4, f4, valid4, tile)
            emit({"kernel": "rdma chunk rgb 2x2", "V": v, "tile": tile,
                  "threads": threads, "plan": rdma.rdma_plan(
                      f4.radius, T_LEVELS, tuple(x4.shape[2:]), tile),
                  "ms": ms})
    for name in ("k2_rgb", "k2_edge5"):
        x, f, valid = inp[name]
        for tile in SWEEP_TILES:
            for threads in SWEEP_THREADS:
                stencil.FUSED_THREADS = threads
                occ = stencil.fused_blocks_per_sm(x, f, T_LEVELS, valid,
                                                  separable=True, tile=tile)
                ms, _ = _time_k2(x, f, valid, 3, False, tile)
                r = f.radius
                groups = stencil.fused_plan(r, T_LEVELS, valid, tile)[2]
                emit({"kernel": f"fused_iterate {name}", "V": v,
                      "tile": tile, "threads": threads, "groups": groups,
                      "blocks_per_sm": occ, "ms": ms})
    stencil.FUSED_THREADS = 512
    for name in ("k2_rgb", "k2_edge5"):
        x, f, valid = inp[name]
        for tile in GROUP_TILES:
            for g in GROUP_DEPTHS:
                if stencil.fused_smem_bytes(f.radius, g, tile) > \
                        stencil.H100_SMEM_OPTIN:
                    continue
                ms = _time_groups(x, f, valid, [g] * (T_LEVELS // g), tile)
                emit({"kernel": f"fused_iterate {name} forced groups",
                      "V": v, "tile": tile, "threads": 512,
                      "groups_of": g, "ms": ms})


def _time_chunk(x, filt, valid, tile) -> float:
    """One 32-level ``cuda_rdma`` chunk on the stacked 2x2 grid: K4 for
    the first level group, K2 per block for the rest."""
    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.utils.bench import cuda_ms

    return cuda_ms(lambda: rdma.fused_rdma_stacked(
        x, filt, (2, 2), "zero", fuse=T_LEVELS, valid_hw=valid, tile=tile), 5)


def _time_groups(x, filt, valid, groups, tile) -> float:
    """K2 over T_LEVELS levels in the given level groups, one launch each
    (``stencil._fused_call``, bypassing the planner's choice)."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.utils.bench import cuda_ms

    r = filt.radius
    h, w = valid
    th, tw = tile
    bufs, left = [], sum(groups)
    for g in groups:
        left -= g
        oh, ow = h + 2 * r * left, w + 2 * r * left
        bufs.append(torch.empty((x.shape[0], oh, ow), device=x.device,
                                dtype=x.dtype if left == 0 else torch.float32))

    def run():
        cur, left = x, sum(groups)
        for g, out in zip(groups, bufs):
            left -= g
            stencil._fused_call(cur, out, (-r * left, -r * left), filt, g,
                                valid, True, True, (min(th, out.shape[1]),
                                                    min(tw, out.shape[2])))
            cur = out

    return cuda_ms(run, 3)


def _run_worker(root: Path, what: str, env=None) -> list[dict]:
    cmd = [sys.executable, str(HERE), "worker", "--root", str(root), what]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=1500)
    if res.returncode != 0:
        raise RuntimeError(f"worker {root} {what} exited {res.returncode}:\n"
                           f"{res.stderr[-4000:]}")
    return [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("sweep")
    s.add_argument("--strips", default=",".join(map(str, SWEEP_STRIPS)))
    a = sub.add_parser("ab")
    a.add_argument("--parent", required=True, type=Path)
    a.add_argument("--runs", type=int, default=2)
    w = sub.add_parser("worker")
    w.add_argument("--root", required=True, type=Path)
    w.add_argument("what", choices=("ab", "sweep"))
    args = p.parse_args(argv)
    if args.cmd == "worker":
        sys.path.insert(0, str(args.root.resolve()))
        worker_main(args.what)
        return 0
    print(json.dumps({"card": _card()}), flush=True)
    if args.cmd == "sweep":
        for v in args.strips.split(","):
            env = dict(os.environ, PCTPU_STRIP_V=v.strip())
            for row in _run_worker(ROOT, "sweep", env):
                print(json.dumps(row), flush=True)
        return 0
    # parent, this, this, parent, parent, this, ...
    turns = []
    for i in range(args.runs):
        pair = [("parent", args.parent.resolve()), ("this", ROOT)]
        turns += pair if i % 2 == 0 else pair[::-1]
    bad = False
    for n, (side, root) in enumerate(turns):
        for row in _run_worker(root, "ab"):
            row.update(side=side, turn=n)
            bad |= row.get("equal_plain") is False
            print(json.dumps(row), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
