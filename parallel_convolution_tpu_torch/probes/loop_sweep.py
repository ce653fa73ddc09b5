"""Measurements behind the level loop's launch shape (K2, K4; see
``csrc/stencil_common.cuh``) and K1's (``csrc/step.cu``), on the card.

Three commands, each printing one JSON object per measured point:

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

* ``step`` times K1 (one step, quantize) at the main path's shapes --
  RGB 1920x2520 blur3 f32, bf16 and u8, and grey 8192x8192 edge5 f32 --
  over output tiles, input stages and threads per block, each point with
  its plan, the blocks one SM holds and the persistent grid, beside a
  plain device copy of the same bytes and K1 built without its compute
  (its copies in and stores out alone: the ``stencil_copy`` library of
  ``ops/_build.py``).  A value listed twice is measured twice, in that
  order (``--stages 1,2,2,1`` interleaves).

      python -m parallel_convolution_tpu_torch.probes.loop_sweep step \
          [--tiles 16x512,32x128] [--stages 1,2] [--threads 256]

* ``ab --parent DIR`` times the three level-loop kernels at those shapes
  and K1 at its rows (RGB blur3 f32, bf16, u8, separable f32, and grey
  8192x8192 edge5 f32) in the checkout at DIR (another commit of this
  repository, say the parent of a change) and in this one, in turns:
  parent, this, this, parent, ... each turn in a process of its own
  importing that checkout's package and building its kernels there, each
  kernel checked byte-equal to its plain version in every turn.

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
STEP_TILES = ((32, 128), (16, 256), (32, 256), (16, 512), (32, 512),
              (16, 1024))
STEP_STAGES = (1, 2)
STEP_THREADS = (256, 512)


def _card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""


def _inputs(dev):
    """The main-path inputs, from the repository's seeded test images:
    K1's padded RGB block in each storage and 8192^2 block in f32, K2's
    deep-padded RGB and 8192^2 blocks and K4's stacked 2x2 RGB grid in
    bf16."""
    import torch

    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import halo, mesh
    from parallel_convolution_tpu_torch.utils import imageio

    blur3, edge5 = get_filter("blur3"), get_filter("edge5")

    def padded(img, depth, dtype=torch.bfloat16):
        x = torch.from_numpy(imageio.interleaved_to_planar(img).copy()).to(
            device=dev, dtype=dtype)
        return halo.halo_exchange([[x]], depth, (1, 1), "zero")[0][0]

    rgb = imageio.generate_test_image(*RGB_HW, "rgb", seed=1)
    big = imageio.generate_test_image(*BIG_HW, "grey", seed=2)
    planar = imageio.interleaved_to_planar(rgb)
    blocks = convert.blocks_from_numpy(planar, mesh.make_grid((2, 2), dev),
                                       "bf16")
    return {
        "k1": {f"rgb blur3 {name}": (padded(rgb, 1, dt), blur3, False)
               for name, dt in (("f32", torch.float32),
                                ("bf16", torch.bfloat16),
                                ("u8", torch.uint8))},
        "k1_sep": (padded(rgb, 1, torch.float32), blur3, True),
        "k1_edge5": (padded(big, 2, torch.float32), edge5, False),
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


def _warm_up(fn, seconds: float = 1.0) -> None:
    """Keep the card busy with ``fn`` for ``seconds`` before a measurement:
    its clocks ramp up under load, and a cold first row reads slow."""
    import time

    import torch

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()


def _ms(fn, reps: int, queue_ahead: bool) -> float:
    """Mean CUDA-event ms of ``fn()`` over ``reps`` calls after 20, as
    ``utils.bench.cuda_ms`` times it; kept here so that an A/B times both
    checkouts with this code."""
    import time

    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queue_ahead:
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e9 * (2 * host * reps + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _time_k1(x, filt, sep, reps, check, library="stencil", **extra):
    """K1 on ``x`` (quantize, output in x's dtype), each time the mean of
    ``reps`` launches after 20: ``ms``, back-to-back wrapper calls (the
    host's time where it is the longer, as the main path pays it);
    ``device_ms``, the same launches queued ahead of the card (the
    device's own time); ``copy_ms``, a plain device copy of the same bytes;
    ``equal_plain``, byte-equal to its plain version (when ``check``).
    ``library`` names a measurement build (``ops/_build.py``), launched
    through ``stencil._step_call`` into one output; its outputs are not
    the step's and are not checked."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil

    kw = dict(quantize=True, out_dtype=x.dtype, separable=sep)
    r = filt.radius
    out = torch.empty((x.shape[0], x.shape[1] - 2 * r, x.shape[2] - 2 * r),
                      dtype=x.dtype, device=x.device)
    if library == "stencil":
        step = lambda: stencil.stencil_step(x, filt, **kw, **extra)  # noqa: E731
    else:
        step = lambda: stencil._step_call(  # noqa: E731
            x, out, filt, True, sep, extra.get("tile"), library=library)
    ok = None
    if check and library == "stencil":
        ok = bool(torch.equal(step(), stencil.stencil_step_plain(x, filt,
                                                                 **kw)))
    window = x[:, r:x.shape[1] - r, r:x.shape[2] - r]
    return {"ms": _ms(step, reps, False), "device_ms": _ms(step, reps, True),
            "copy_ms": _ms(lambda: out.copy_(window), reps, True),
            "equal_plain": ok}


def worker_main(what: str, spec: dict) -> None:
    """Runs in a process whose ``sys.path`` starts at the checkout under
    test; prints one JSON line per point."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil

    dev = torch.device("cuda", 0)
    inp = _inputs(dev)

    def emit(row):
        print(json.dumps(row), flush=True)

    if what == "ab":
        k1_rows = [(f"stencil_step {name}", v)
                   for name, v in inp["k1"].items()]
        k1_rows += [("stencil_step rgb blur3 f32 sep", inp["k1_sep"]),
                    ("stencil_step grey8k edge5 f32", inp["k1_edge5"])]
        x, f, sep = inp["k1"]["rgb blur3 f32"]
        _warm_up(lambda: stencil.stencil_step(x, f, quantize=True,
                                              out_dtype=x.dtype))
        for name, (x, f, sep) in k1_rows:
            emit({"kernel": name, **_time_k1(x, f, sep, 200, True)})
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

    if what == "step":
        x, f, sep = inp["k1"]["rgb blur3 f32"]
        _warm_up(lambda: stencil.stencil_step(x, f, quantize=True,
                                              out_dtype=x.dtype))
        for name, (x, f, sep) in (*inp["k1"].items(),
                                  ("grey8k edge5 f32", inp["k1_edge5"])):
            for tile in spec["tiles"]:
                for stages in spec["stages"]:
                    for threads in spec["threads"]:
                        stencil.STEP_STAGES, stencil.STEP_THREADS = (
                            stages, threads)
                        shape = stencil.step_launch_shape(
                            x, f, quantize=True, out_dtype=x.dtype,
                            tile=tile)
                        plan = shape["plan"]
                        point = {"kernel": f"stencil_step {name}",
                                 "tile": tile, "stages": plan.stages,
                                 "threads": threads, "smem": plan.smem,
                                 "blocks_per_sm": shape["blocks_per_sm"],
                                 "grid": shape["grid"]}
                        for library in ("stencil", "stencil_copy"):
                            emit({**point, "library": library,
                                  **_time_k1(x, f, sep, 100, True, library,
                                             tile=tile)})
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


def _run_worker(root: Path, what: str, env=None, spec=None) -> list[dict]:
    cmd = [sys.executable, str(HERE), "worker", "--root", str(root), what,
           "--spec", json.dumps(spec or {})]
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
    t = sub.add_parser("step")
    t.add_argument("--tiles", default=",".join(f"{a}x{b}"
                                               for a, b in STEP_TILES))
    t.add_argument("--stages", default=",".join(map(str, STEP_STAGES)))
    t.add_argument("--threads", default=",".join(map(str, STEP_THREADS)))
    a = sub.add_parser("ab")
    a.add_argument("--parent", required=True, type=Path)
    a.add_argument("--runs", type=int, default=2)
    w = sub.add_parser("worker")
    w.add_argument("--root", required=True, type=Path)
    w.add_argument("what", choices=("ab", "sweep", "step"))
    w.add_argument("--spec", default="{}")
    args = p.parse_args(argv)
    if args.cmd == "worker":
        sys.path.insert(0, str(args.root.resolve()))
        worker_main(args.what, json.loads(args.spec))
        return 0
    print(json.dumps({"card": _card()}), flush=True)
    if args.cmd == "step":
        ints = lambda v: [int(a) for a in v.split(",")]  # noqa: E731
        spec = {"tiles": [[int(a) for a in t.split("x")]
                          for t in args.tiles.split(",")],
                "stages": ints(args.stages), "threads": ints(args.threads)}
        bad = False
        for row in _run_worker(ROOT, "step", spec=spec):
            bad |= row.get("equal_plain") is False
            print(json.dumps(row), flush=True)
        return 1 if bad else 0
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
