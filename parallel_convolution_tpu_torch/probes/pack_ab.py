"""The packed transport's gather (``rdma.rdma_pack``,
``csrc/rdma.cu:rdma_pack_kernel``) and probe 5b (``smem_budget.smem_probe``,
``csrc/probes.cu:smem_probe_kernel``) timed in this checkout and in
another (say the parent of a change), in turns on one card.

    python parallel_convolution_tpu_torch/probes/pack_ab.py --parent DIR

Both checkouts' kernels are built first, at once; then each turn (parent,
this, this, parent, ...) runs in a process of its own that imports that
checkout's package.  Every row is checked byte-equal to its plain version.

* ``pack`` rows, at the three shapes the main paths pack -- BASELINE
  config 2 (RGB 1920x2520 on 2x2 slots, bf16, depth 32), config 3 (8192^2
  on 4x4 slots, bf16, edge5 at fuse 32: depth 64) and the 256-rank split
  (1920x2520 grey on 16x16 slots, u8, depth 8): ``device_ms``, one slot's
  pack launched back to back on its stream, queued ahead of the card (the
  kernel's own time); ``floor_ms``, an empty kernel (``torch.cuda._sleep
  (0)``) timed the same way on the same stream; ``host_ms``, the same
  pack calls not queued ahead (the wrapper's time where it is the longer);
  ``slot_launch_ms``, every slot's pack between a fork and a join, as
  ``chip_smoke.py``'s ``rdma_pack`` row times it; ``bound_ms``, one slot's
  staging read once and written once at the data sheet's 3.35 TB/s; and
  ``vec``, the bytes a thread moves (None where the checkout has no plan).
* a ``smem_probe`` row at ``smem_budget.SHAPE`` with 100 KB of opt-in
  scratch: ``ms`` (back-to-back calls) and ``device_ms`` (queued ahead),
  beside ``torch.add(x, 1.0)`` timed both ways, and ``device_ms_by_bytes``
  (queued ahead with 0 and 48 KB of scratch without the opt-in, and 100 KB
  with it: what the scratch costs).

The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]          # the checkout this file belongs to
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
# (name, grid, block (C, h, w), ring depth, storage)
SHAPES = (("config 2", (2, 2), (3, 960, 1260), 32, "bf16"),
          ("config 3", (4, 4), (1, 2048, 2048), 64, "bf16"),
          ("grey 16x16", (16, 16), (1, 120, 158), 8, "u8"))
REPS = 500


def _card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""


def _ms(fn, reps: int, queue_ahead: bool) -> float:
    """Mean CUDA-event ms of ``fn()`` over ``reps`` calls after 20 on the
    current stream, as ``utils.bench.cuda_ms`` times it; kept here so that
    both checkouts are timed with this code."""
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


def _pack_row(key, shape, chw, depth, storage) -> dict:
    import torch

    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.parallel import mesh

    dev = torch.device("cuda", 0)
    dtype = {"bf16": torch.bfloat16, "u8": torch.uint8}[storage]
    g = torch.Generator(device=dev).manual_seed(12)
    nb = shape[0] * shape[1]
    blocks = [[torch.randint(0, 256, chw, generator=g, device=dev,
                             dtype=torch.int32).to(dtype)
               for _ in range(shape[1])] for _ in range(shape[0])]
    run = rdma.slot_carry(blocks, mesh.make_grid(shape, devices=[dev] * nb),
                          "zero", depth, "packed").run

    def every_slot():
        run.fork()
        for s, st in enumerate(run.streams):
            rdma.rdma_pack(run, 0, s, depth)
            run.launched[s].record(st)
        run.join()

    every_slot()
    torch.cuda.synchronize()
    want = rdma.rdma_pack_plain(blocks, shape, "zero", depth)
    equal = all(torch.equal(rdma.staged_slabs(run, s, depth), want[s])
                for s in range(nb))
    one = lambda: rdma.rdma_pack(run, 0, 0, depth)  # noqa: E731
    with torch.cuda.stream(run.streams[0]):
        device_ms = _ms(one, REPS, True)
        floor_ms = _ms(lambda: torch.cuda._sleep(0), REPS, True)
        host_ms = _ms(one, REPS, False)
    slot_ms = _ms(every_slot, 50, False)
    C, h, _ = chw
    nbytes = 2 * 2 * C * (h + 2 * depth) * depth * blocks[0][0].element_size()
    plan = getattr(run, "pack_plans", {}).get((0, 0, depth, 1))
    return {"what": "pack", "at": key, "grid": list(shape),
            "slab": [2, C, h + 2 * depth, depth],
            "vec": plan.vec if plan else None, "device_ms": device_ms,
            "floor_ms": floor_ms, "host_ms": host_ms,
            "slot_launch_ms": slot_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "equal_plain": equal}


def _smem_row() -> dict:
    import torch

    from parallel_convolution_tpu_torch.probes import smem_budget

    x = (torch.arange(smem_budget.SHAPE[0] * smem_budget.SHAPE[1],
                      dtype=torch.float32, device="cuda")
         .reshape(smem_budget.SHAPE) % 251.0)
    probe = lambda: smem_budget.smem_probe(x, 100 * 1024, True)  # noqa: E731
    out, attr, err = probe()
    torch.cuda.synchronize()
    equal = (attr, err) == (0, 0) and bool(torch.equal(out, x + 1.0))
    add = lambda: torch.add(x, 1.0)  # noqa: E731
    # The device time at smaller scratches too: what the scratch costs.
    by_bytes = {str(n): _ms(lambda n=n, o=o: smem_budget.smem_probe(x, n, o),
                            200, True)
                for n, o in ((0, False), (48 * 1024, False),
                             (100 * 1024, True))}
    return {"what": "smem_probe", "shape": list(smem_budget.SHAPE),
            "bytes": 100 * 1024, "ms": _ms(probe, 200, False),
            "device_ms": _ms(probe, 200, True), "add_ms": _ms(add, 200, False),
            "add_device_ms": _ms(add, 200, True),
            "device_ms_by_bytes": by_bytes,
            "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
            "equal_plain": equal}


def worker_main(what: str) -> None:
    """Runs in a process whose ``sys.path`` starts at the checkout under
    test: builds its kernels, or prints one JSON line a row."""
    if what == "build":
        from parallel_convolution_tpu_torch.ops import _build

        _build.build_all(("rdma", "probes"))
        return
    for spec in SHAPES:
        print(json.dumps(_pack_row(*spec)), flush=True)
    print(json.dumps(_smem_row()), flush=True)


def _worker(root: Path, what: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(HERE), "--worker", what, "--root", str(root)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _rows(proc: subprocess.Popen, root: Path) -> list[dict]:
    out, err = proc.communicate(timeout=1500)
    if proc.returncode != 0:
        raise RuntimeError(f"worker {root} exited {proc.returncode}:\n"
                           f"{err[-4000:]}")
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", type=Path)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--worker", choices=("build", "rows"))
    p.add_argument("--root", type=Path, default=ROOT)
    args = p.parse_args(argv)
    if args.worker:
        sys.path.insert(0, str(args.root.resolve()))
        worker_main(args.worker)
        return 0
    if args.parent is None:
        p.error("--parent DIR is required")
    print(json.dumps({"card": _card()}), flush=True)
    sides = [("parent", args.parent.resolve()), ("this", ROOT)]
    builds = [(_worker(root, "build"), root) for _, root in sides]
    for proc, root in builds:
        _rows(proc, root)
    bad = False
    for i in range(args.runs):
        for n, (side, root) in enumerate(sides if i % 2 == 0
                                         else sides[::-1]):
            for row in _rows(_worker(root, "rows"), root):
                row.update(side=side, turn=2 * i + n)
                bad |= not row["equal_plain"]
                print(json.dumps(row), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
