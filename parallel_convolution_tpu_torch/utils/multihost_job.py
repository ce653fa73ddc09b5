"""One job over several processes through the port: the JAX package's
two-process job (``tests/_multihost_worker.py``) on a grid of slots that
spans the processes (``mesh.make_grid(devices="all")`` after
``multihost.initialize``), each process holding only its own blocks.

Per rank: join the group; rank 0 writes a seeded raw image and every
rank waits for it; a sharded load of this rank's blocks; a checkpointed
iterate (a snapshot every ``every`` iterations, this rank's shards only,
rank 0 writing the meta and the pointer); a sharded save (rank 0
allocates the file before a barrier); a resume from the last snapshot,
which must land bit-identical on every rank; ``broadcast_scalar``; and
the same iterate again on the loaded blocks, timed (the resident
seconds).  A row carries this rank's kernel launches of the legs before
the resident run (``stencil.launch_counts``).  A ``bf16`` storage runs
``ConvolutionModel.run_raw_file_sharded`` in place of the checkpointed
legs: a snapshot holds f32 or u8 blocks.  ``--col-mode`` is
``cuda_rdma``'s column transport; ``--legs multigrid,volume`` adds a
V-cycle (``mg_converge`` of a seeded jacobi3 field on the job's backend)
and an fd7 volume (``volume_iterate`` of a seeded (2, 8, rows, cols)
state), each row stamping its output's SHA-256 (after the resident
run).

Spawn the ranks from one parent (``spawn``: CUDA does not survive
``fork``), or run one rank a process under ``torchrun``:

    python -m parallel_convolution_tpu_torch.utils.multihost_job \\
        --processes 2 --device cpu --backend shifted --work /tmp/job
    python -m parallel_convolution_tpu_torch.utils.multihost_job \\
        --processes 2 --device cpu --backend cuda_rdma --col-mode packed \\
        --legs multigrid,volume --work /tmp/job_r
    torchrun --nproc-per-node 2 -m parallel_convolution_tpu_torch.utils.multihost_job \\
        --work /tmp/job --rows 1920 --cols 2520 --mode rgb \\
        --iters 100 --every 50 --backend cuda

Like the port's other entry points it runs on the card unless
``--device cpu`` asks for the CPU.  Across hosts, start it under
``torchrun`` on every host with one coordinator (``--nnodes N
--node-rank K --master-addr HOST0 --master-port P``) and a ``--work``
directory that every host sees; ``cuda_rdma`` then reads a neighbour on
another host from a mirror that an exchange fills once a chunk.

The group is ``multihost.initialize``'s default: NCCL where the host has
a card for each of its ranks (one card a process, the slabs kept on the
cards), else gloo.  Ranks that see one card (``CUDA_VISIBLE_DEVICES``)
get gloo and share it (its slots time-slice between two CUDA contexts),
the halo slabs crossing through host memory; so does ``job(group=
"gloo")`` on any machine.  The output file
is ``<work>/out.raw``; each rank's result is a dict (printed as one JSON
line a rank from the CLI).
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import time
from pathlib import Path

import numpy as np

__all__ = ["free_port", "job", "spawn"]


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def job(rank: int | None, processes: int | None, port: int | None, work,
        *, device: str | None = None, shape=(2, 2), rows: int = 37,
        cols: int = 53, mode: str = "grey", iters: int = 4, every: int = 2,
        filt: str = "blur3", backend: str = "cuda", storage: str = "f32",
        fuse: int = 1, seed: int = 3, col_mode: str | None = None,
        legs=(), group: str | None = None, slots=None) -> dict:
    """This rank's share of the job; returns its result row.  ``rank`` /
    ``processes`` / ``port`` None read torchrun's environment.  ``device``
    None is the card (raising without CUDA); ``"cpu"`` runs the plain
    versions.  ``group`` is the process group's backend (None: the
    default, ``multihost.default_backend``); a group that exists already
    is kept.  ``slots`` (one process) names the grid's slots, as
    ``mesh.make_grid(devices=)`` takes them, in place of every card's."""
    import torch

    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh, multihost, step
    from parallel_convolution_tpu_torch.utils import (
        checkpoint, imageio, sharded_io,
    )

    from parallel_convolution_tpu_torch.obs import events

    # Every rank appends to the one PCTPU_OBS_EVENTS log (if set), each
    # its own seq stream under its pid.
    events.install_from_env()
    multihost.initialize(None if port is None else f"localhost:{port}",
                         num_processes=processes, process_id=rank,
                         backend=group)
    info = multihost.process_info()
    rank = info["process_index"]
    grid = (mesh.make_grid(tuple(shape), devices=slots) if slots
            else mesh.make_grid(tuple(shape), devices="all", device=device))
    work = Path(work)
    src, dst, ckpt = work / "in.raw", work / "out.raw", work / "ckpt"
    f = get_filter(filt)
    if rank == 0:
        work.mkdir(parents=True, exist_ok=True)
        imageio.write_raw(src, imageio.generate_test_image(rows, cols, mode,
                                                           seed=seed))
    multihost.barrier("input-written")
    stencil.reset_launch_counts()

    def timed(fn):
        multihost.barrier("timed")
        if grid.device.type == "cuda":
            torch.cuda.synchronize(grid.device)
        t0 = time.perf_counter()
        out = fn()
        if grid.device.type == "cuda":
            torch.cuda.synchronize(grid.device)
        multihost.barrier("timed")
        return out, time.perf_counter() - t0

    row = {"rank": rank, **info, "group": multihost.backend(),
           "slots": grid.slot_map(),
           "owners": list(grid.owners or ()), "backend": backend,
           "storage": storage, "fuse": fuse, "output": str(dst)}
    if storage == "bf16":
        model = ConvolutionModel(filt, grid=grid, backend=backend,
                                 storage=storage, fuse=fuse,
                                 col_mode=col_mode)
        _, row["first_s"] = timed(lambda: model.run_raw_file_sharded(
            str(src), str(dst), rows, cols, mode, iters))
        blocks = sharded_io.load_sharded(src, rows, cols, mode, grid,
                                         dtype=torch.bfloat16)
        row["resume_bitexact"] = None
    else:
        dtype = torch.uint8 if storage == "u8" else torch.float32

        def first():
            blocks = sharded_io.load_sharded(src, rows, cols, mode, grid,
                                             dtype=dtype)
            out = checkpoint.run_checkpointed(
                blocks, f, iters, grid, (rows, cols), ckpt_dir=ckpt,
                every=every, backend=backend, fuse=fuse, col_mode=col_mode)
            if rank == 0:
                imageio.allocate_raw(dst, rows, cols, mode)
            multihost.barrier("output-allocated")
            sharded_io.save_sharded(dst, out, rows, cols, mode,
                                    allocate=False, grid=grid)
            multihost.barrier("output-saved")
            return blocks, out

        (blocks, out), row["first_s"] = timed(first)
        # LATEST is the last snapshot before the end (the final state is
        # the caller's to persist): a fresh run resumes from it.
        out2 = checkpoint.run_checkpointed(
            None, f, iters, grid, (rows, cols), ckpt_dir=ckpt, every=every,
            backend=backend, fuse=fuse, col_mode=col_mode)
        row["resume_bitexact"] = all(
            torch.equal(a, out2[i][j])
            for (i, j), a in mesh.local_blocks(out))
    row["broadcast"] = multihost.broadcast_scalar(float(rank + 7))
    # This rank's kernel launches of the job's legs (the resident run's
    # are not counted).
    row["launches"] = stencil.launch_counts()
    _, row["resident_s"] = timed(lambda: step.iterate_prepared(
        blocks, f, iters, grid, (rows, cols), backend=backend, fuse=fuse,
        col_mode=col_mode))
    rng = np.random.default_rng(seed)
    if "multigrid" in legs:
        from parallel_convolution_tpu_torch.solvers import multigrid

        field = rng.standard_normal((1, rows, cols)).astype(np.float32)
        (out, res), secs = timed(lambda: multigrid.mg_converge(
            field, get_filter("jacobi3"), 1e-3, 40, grid=grid,
            backend=backend, col_mode=col_mode))
        row["multigrid"] = {"cycles": res.cycles, "residual": res.residual,
                            "level_grids": res.level_grids, "seconds": secs,
                            "sha256": _sha(out)}
    if "volume" in legs:
        from parallel_convolution_tpu_torch.volumes import driver

        vol = rng.random((2, 8, rows, cols), dtype=np.float32)
        out, secs = timed(lambda: driver.volume_iterate(vol, "fd7", 3,
                                                        grid=grid))
        row["volume"] = {"seconds": secs, "sha256": _sha(out)}
    multihost.barrier("done")
    return row


def _sha(t) -> str:
    """The SHA-256 of a tensor's bytes (on the host)."""
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def _child(rank: int, processes: int, port: int, work: str, kw: dict,
           results) -> None:
    import torch.distributed as dist

    try:
        results[rank] = job(rank, processes, port, work, **kw)
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        results[rank] = {"rank": rank, "error": f"{type(e).__name__}: {e}"}
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(processes: int, work, timeout: float = 600.0, **kw) -> list[dict]:
    """Run :func:`job` in ``processes`` spawned processes; returns every
    rank's row in rank order.  Raises if a rank fails or outlives
    ``timeout`` seconds (every child is then killed)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    with ctx.Manager() as manager:
        results = manager.dict()
        procs = [ctx.Process(target=_child,
                             args=(r, processes, port, str(work), kw,
                                   results))
                 for r in range(processes)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        rows = [dict(results.get(r, {"rank": r, "error": "no result"}))
                for r in range(processes)]
        codes = [p.exitcode for p in procs]
    failed = [r for r in rows if "error" in r]
    if failed or any(codes):
        raise RuntimeError(f"the job failed: exit codes {codes}, {failed}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=None,
                    help="spawn this many ranks (default: one rank of "
                         "torchrun's job)")
    ap.add_argument("--work", required=True)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card; raises without "
                         "CUDA)")
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--rows", type=int, default=37)
    ap.add_argument("--cols", type=int, default=53)
    ap.add_argument("--mode", default="grey", choices=["grey", "rgb"])
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--every", type=int, default=2)
    ap.add_argument("--filter", default="blur3")
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--storage", default="f32")
    ap.add_argument("--fuse", type=int, default=1)
    ap.add_argument("--col-mode", default=None,
                    choices=["packed", "strided", "auto"],
                    help="cuda_rdma's column transport (default: the cost "
                         "model's pick)")
    ap.add_argument("--legs", default="",
                    help="comma list of extra legs: multigrid, volume")
    args = ap.parse_args(argv)
    kw = dict(device=args.device,
              shape=tuple(int(v) for v in args.mesh.split("x")),
              rows=args.rows, cols=args.cols, mode=args.mode,
              iters=args.iters, every=args.every, filt=args.filter,
              backend=args.backend, storage=args.storage, fuse=args.fuse,
              col_mode=args.col_mode,
              legs=tuple(v for v in args.legs.split(",") if v))
    if args.processes:
        rows = spawn(args.processes, args.work, **kw)
    else:
        rows = [job(None, None, None, args.work, **kw)]
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
