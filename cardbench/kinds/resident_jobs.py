"""Resident jobs: one seeded image prepared once into blocks on the cards,
then ``iterations``-long jobs back to back through
``step.iterate_prepared``, one caller, every job from the same blocks.

With ``processes`` > 1 in the configuration each rank is a process with a
card of its own in one group (NCCL on the cards, gloo on the CPU), makes
only its own block from the seed, and runs every job in lockstep with the
others: a job ends when every rank's blocks are done, and rank 0 decides
after each job whether another starts.

What is checked: windows of every job's output blocks, at the image's
corners and edges, at the boundaries between blocks (both sides, and
where four blocks meet) and at places drawn from the seed, against
:func:`cardbench.reference.iterate_u8` of the same windows remade from
the seed with their apron.  Traffic keys: ``channels``, ``height``,
``width``, ``window`` (the side of a checked window), ``windows_drawn``
(the windows drawn per block).
"""

from __future__ import annotations

import random
import traceback

from cardbench import inputs, reference, trace
from cardbench.kinds import (
    Outcome, build_kernels, clock, device_of, memory_peak, synchronize,
)


def _geometry(cell):
    cfg, tr = cell.config, cell.traffic
    H, W = int(tr["height"]), int(tr["width"])
    R, C = (int(v) for v in cfg["grid"])
    if H % R or W % C:
        raise ValueError(f"a {H}x{W} image does not split into {R}x{C} "
                         "equal blocks")
    return H, W, R, C, H // R, W // C


def windows(cell, seed: int) -> list[tuple[int, int, int, int]]:
    """Every checked window as (block row, block column, row, column) of
    its top-left corner inside the block; each lies in one block."""
    H, W, R, C, bh, bw = _geometry(cell)
    s = int(cell.traffic["window"])
    if s > min(bh, bw):
        raise ValueError(f"window {s} exceeds the {bh}x{bw} block")
    rng = random.Random(inputs.key(seed, 0xB10C))
    out = set()
    for i in range(R):
        for j in range(C):
            # The block's corners and edge midpoints: the image's edges
            # on an outer block, the boundaries between blocks elsewhere.
            for y in (0, (bh - s) // 2, bh - s):
                for x in (0, (bw - s) // 2, bw - s):
                    out.add((i, j, y, x))
            for _ in range(int(cell.traffic["windows_drawn"])):
                out.add((i, j, rng.randrange(bh - s + 1),
                         rng.randrange(bw - s + 1)))
    return sorted(out)


def reference_windows(cell, seed: int, wins, device, dtype=None):
    """The reference's (N, C, s, s) u8 answers for ``wins``."""
    import torch

    H, W, R, C, bh, bw = _geometry(cell)
    cfg = cell.config
    s, ch = int(cell.traffic["window"]), int(cell.traffic["channels"])
    t = reference.taps(cfg)
    a = (t.shape[0] - 1) // 2 * int(cfg["iterations"])
    out = []
    for k in range(0, len(wins), 32):
        part = wins[k:k + 32]
        src, inside = [], []
        for i, j, y, x in part:
            gy, gx = i * bh + y - a, j * bw + x - a
            src.append(inputs.image_window(seed, 0, ch, (H, W), gy, gx,
                                           s + 2 * a, s + 2 * a, device))
            rows = torch.arange(gy, gy + s + 2 * a, device=device)
            cols = torch.arange(gx, gx + s + 2 * a, device=device)
            inside.append((((rows >= 0) & (rows < H))[:, None]
                           & ((cols >= 0) & (cols < W))[None, :])[None])
        out.append(reference.iterate_u8(
            torch.stack(src), torch.stack(inside), t, int(cfg["iterations"]),
            a, dtype=dtype or torch.float32))
    return torch.cat(out)


def _rank(cell, seed: int, seconds: float, traced: bool, device,
          rank: int, n: int, port) -> dict:
    """One rank's run; returns its row for :func:`_combine`."""
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh, multihost, step

    cfg, tr = cell.config, cell.traffic
    H, W, R, C, bh, bw = _geometry(cell)
    cpu = device is not None and torch.device(device).type == "cpu"
    if n > 1:
        multihost.initialize(f"localhost:{port}", num_processes=n,
                             process_id=rank,
                             backend="gloo" if cpu else None)
        dev = torch.device("cpu") if cpu else multihost.card()
        grid = mesh.make_grid((R, C), devices="all",
                              device="cpu" if cpu else None)
    else:
        dev = device_of(device)
        grid = mesh.make_grid((R, C), device=dev)
    build_kernels(dev)
    ch, iters = int(tr["channels"]), int(cfg["iterations"])
    blocks = [[inputs.image_window(seed, 0, ch, (H, W), i * bh, j * bw,
                                   bh, bw, dev)
               if grid.is_local(i, j) else None for j in range(C)]
              for i in range(R)]
    filt = get_filter(cfg["filter"])
    kw = dict(quantize=bool(cfg["quantize"]), backend=cfg["backend"],
              fuse=int(cfg["fuse"]), boundary=cfg["boundary"])
    s = int(tr["window"])
    mine = [w for w in windows(cell, seed) if grid.is_local(w[0], w[1])]

    def grab(out):
        return torch.stack([out[i][j][:, y:y + s, x:x + s]
                            for i, j, y, x in mine])

    def job():
        with trace.span("cardbench.job"):
            out = step.iterate_prepared(blocks, filt, iters, grid, (H, W),
                                        **kw)
            got = grab(out)
            del out
            synchronize(dev)
        return got

    grabs = [job()]  # warm-up: the first job loads the kernels
    multihost.barrier("cardbench-window")
    stencil.reset_launch_counts()
    with trace.Window(traced) as win:
        start = clock()
        while True:
            grabs.append(job())
            stop = clock() - start >= seconds
            if n > 1:
                stop = multihost.broadcast_scalar(float(stop)) > 0.5
            if stop:
                break
        elapsed = clock() - start
    jobs = len(grabs) - 1
    launches = stencil.launch_counts()
    peak = memory_peak(dev)
    del blocks
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_windows(cell, seed, mine, dev)
    bad = sum(int((g != want).sum()) for g in grabs[1:])
    from cardbench.run import forbidden_modules

    return {"rank": rank, "jobs": jobs, "elapsed": elapsed, "start": start,
            "bad_bytes": bad, "compared": jobs * want.numel(),
            "launches": launches, "peak": peak, "trace": win.summary,
            "group": multihost.backend(), "forbidden": forbidden_modules()}


def _child(cell, seed, seconds, traced, device, rank, n, port, queue):
    import torch.distributed as dist

    try:
        queue.put(_rank(cell, seed, seconds, traced, device, rank, n, port))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def _spawn(cell, seed, seconds, traced, device, n, child) -> list[dict]:
    import multiprocessing
    import queue as queue_mod

    from parallel_convolution_tpu_torch.utils.multihost_job import free_port

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=child, args=(cell, seed, seconds, traced,
                                             device, r, n, port, q))
             for r in range(n)]
    for p in procs:
        p.start()
    rows = []
    deadline = clock() + 300.0 + float(seconds)
    try:
        while len(rows) < n and clock() < deadline:
            try:
                rows.append(q.get(timeout=1.0))
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            if "error" in rows[-1]:
                break
    finally:
        whole = len(rows) == n and not any("error" in r for r in rows)
        for p in procs:
            p.join(60.0 if whole else 10.0)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [r["error"] for r in rows if "error" in r]
    if errors or len(rows) < n:
        raise RuntimeError(f"{n - len(rows)} ranks gave no row; "
                           f"exit codes {[p.exitcode for p in procs]}; "
                           + "\n".join(errors))
    return sorted(rows, key=lambda r: r["rank"])


def run(cell, seed: int, seconds: float, traced: bool, device=None,
        child=None) -> Outcome:
    """The run of ``cell``; ``child`` replaces the rank's entry in the
    spawned processes (the fault tests break the program there)."""
    n = int(cell.config.get("processes", 1))
    if n == 1:
        rows = [_rank(cell, seed, seconds, traced, device, 0, 1, None)]
    else:
        # Built here once, so that the ranks find the libraries built.
        build_kernels(device_of(device))
        rows = _spawn(cell, seed, seconds, traced, device, n,
                      child or _child)
    return _combine(cell, rows)


def _combine(cell, rows: list[dict]) -> Outcome:
    from cardbench import roofline

    found = sorted({m for r in rows for m in r["forbidden"]})
    if found:
        # A spawned rank's modules are its own: the parent's look at
        # sys.modules does not see them.
        raise SystemExit(f"cardbench: a rank loaded {found}, which the "
                         "port must not use")
    H, W, *_ = _geometry(cell)
    cfg = cell.config
    ch, iters = int(cell.traffic["channels"]), int(cfg["iterations"])
    jobs = rows[0]["jobs"]
    if any(r["jobs"] != jobs for r in rows):
        raise RuntimeError(f"the ranks ran different jobs: "
                           f"{[r['jobs'] for r in rows]}")
    elapsed = rows[0]["elapsed"]
    pixels = ch * H * W
    limit = cfg["limits"]["bad_bytes"]
    launches: dict = {}
    for r in rows:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    summaries = [r["trace"] for r in rows if r["trace"] is not None]
    ops, nbytes = roofline.iterate_work(reference.taps(cfg).numpy(),
                                        bool(cfg["quantize"]), pixels, iters,
                                        cfg["storage"])
    ctx = {"trace": (trace.merge(summaries) if len(summaries) > 1 else
                     summaries[0] if summaries else None),
           "launches": launches, "jobs": jobs, "job_ops": ops,
           "job_bytes": nbytes}
    return Outcome(
        attempted=jobs, failed=0,
        end_to_end={name: pixels * iters * jobs / elapsed / 1e9
                    for name in ("gpx_per_s", "cards_gpx_per_s")},
        checks={"bad_bytes": (sum(r["bad_bytes"] for r in rows), limit)},
        ctx=ctx, memory_peak_bytes=max(r["peak"] for r in rows),
        cards=len(rows), window_start=min(r["start"] for r in rows),
        notes=[f"jobs {jobs} in {elapsed:.6f} s; bytes compared "
               f"{sum(r['compared'] for r in rows)}; group "
               f"{rows[0]['group']}"])


def control(cell, seed: int, device) -> dict:
    """The control's readings: the reference in bfloat16 in the program's
    place, judged as a run judges the program's windows."""
    import torch

    wins = windows(cell, seed)
    want = reference_windows(cell, seed, wins, device)
    low = reference_windows(cell, seed, wins, device, dtype=torch.bfloat16)
    return {"bad_bytes": int((low != want).sum())}
