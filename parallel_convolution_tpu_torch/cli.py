"""Command-line entry point of the PyTorch port
(``python -m parallel_convolution_tpu_torch``).

Mirrors the JAX package's ``pconv-tpu`` vocabulary — ``image path, rows,
cols, loops, grey|rgb`` — and takes every subcommand and flag of its parser:

  run       filter a raw image on the card (the parallel main()), or with
            --converge TOL run it to convergence (loops = max iterations;
            --solver multigrid runs the V-cycle, loops = max fine-grid
            work units); --sharded-io streams an image too large for one
            host buffer block by block, --checkpoint DIR snapshots and
            resumes it, --fallback degrades a backend that fails
            transiently; --rank 3 --depth D iterates a raw float32
            (2, D, rows, cols) volume with a rank-3 form (fd7, fd25,
            wave, grayscott)
  serial    the same on the host: the native C++ baseline (built with g++
            on first use) or the NumPy oracle, byte for byte alike
  generate  write a deterministic test image
  compare   byte-compare two raw images
  convert   raw -> PGM/PPM
  bench     time a synthetic workload; one JSON row
  info      cards, default grid, filters, backends
  tune      rank (and measure) the knobs of one workload and write the
            plan file that --backend auto reads (the JAX package's
            scripts/tune.py)

A flag or subcommand that a later slice ports exits 2 with the
``NotImplementedError`` that names its item in ROADMAP.md.  ``PCTPU_FAULTS``
/ ``PCTPU_FAULT_SEED`` and ``PCTPU_DISK_MODES`` install a fault plan and
disk modes at start (``resilience.faults``, ``resilience.diskio``), as in
the JAX CLI; ``PCTPU_OBS_EVENTS`` names the event log the run appends to
(``obs.events``; ``PCTPU_OBS=0`` turns every obs hook off).
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np


def _add_image_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("image", help="input .raw image path")
    p.add_argument("rows", type=int)
    p.add_argument("cols", type=int)
    p.add_argument("loops", type=int)
    p.add_argument("mode", choices=["grey", "rgb"])


def _add_perf_args(p: argparse.ArgumentParser) -> None:
    """Filter / grid / kernel knobs of run and bench (the JAX CLI's, plus
    --device)."""
    from parallel_convolution_tpu_torch.utils.config import STORAGES

    p.add_argument("--filter", default="blur3", dest="filter_name")
    p.add_argument("--mesh", default=None, metavar="RxC",
                   help="block grid (default: $PCTPU_MESH if set — the "
                        "supervisor's reshape env — else 1x1, or with a "
                        "--device list or 'all' dims_create of the slots). "
                        "A --checkpoint resume accepts a different grid "
                        "than the one that wrote the snapshot: its blocks "
                        "reshard, the bytes do not change")
    # No argparse choices: check_backend names the port's counterpart of
    # a JAX backend name (pallas -> cuda, ...).
    p.add_argument("--backend", default=None,
                   help="correlate implementation (default: shifted); "
                        "shifted / separable / xla_conv are plain PyTorch, "
                        "cuda / cuda_sep / cuda_rdma the CUDA kernels "
                        "(the JAX package's pallas / pallas_sep / "
                        "pallas_rdma); auto resolves it, and --fuse / "
                        "--tile left unset, through the plan file "
                        "($PCTPU_PLAN_FILE, written by tune) or the cost "
                        "model")
    p.add_argument("--storage", default=None, choices=list(STORAGES),
                   help="iteration-carry dtype (default: f32)")
    p.add_argument("--fuse", type=int, default=None, metavar="T",
                   help="iterations per halo exchange (default 1)")
    p.add_argument("--tile", default=None, metavar="TH,TW",
                   help="output tile of the CUDA kernels (same bytes "
                        "for any tile)")
    p.add_argument("--overlap", default="auto", choices=["auto", "on", "off"],
                   help="interior-first overlapped halo pipeline: 'on' "
                        "launches cuda_rdma's kernels region by region on a "
                        "grid of slots, the interior first with no wait "
                        "(elsewhere it warns and runs serialized; on the "
                        "CPU only with PCTPU_OVERLAP_INTERPRET=1); 'auto' "
                        "is off for an explicit backend and the tuner's "
                        "choice under --backend auto; the same bytes")
    p.add_argument("--col-mode", default="auto", dest="col_mode",
                   choices=["auto", "packed", "strided"],
                   help="cuda_rdma's column-slab transport between the "
                        "slots of a grid of slots: stage the slabs first "
                        "(packed) or read them in place (strided); auto "
                        "asks the cost model; the same bytes")
    p.add_argument("--interior-split", action="store_true",
                   dest="interior_split",
                   help="launch K2 as the 9-patch unmasked-interior split "
                        "(cuda / cuda_sep at --fuse > 1 on the zero "
                        "boundary; the same bytes)")
    p.add_argument("--fallback", action="store_true",
                   help="probe the backend first and, on a transient "
                        "failure, walk cuda_rdma -> cuda (warned, and named "
                        "in the summary line); on the card a refused cuda "
                        "raises, on the CPU it steps down to shifted")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu, every block on that "
                        "device; 'all' (a slot per block, round-robin over "
                        "the cards) or a comma list of RxC slots, a device "
                        "per block (e.g. cuda:0,cuda:0,cuda:0,cuda:0 or "
                        "cpu,cpu); without CUDA the default raises")
    p.add_argument("--fast", action="store_true",
                   help="on the card, fill unset --backend/--storage/"
                        "--fuse with cuda_sep / bf16 / 32")


def _parse_tile(spec: str | None):
    if not spec:
        return None
    tile = tuple(int(v) for v in spec.split(","))
    if len(tile) != 2 or min(tile) <= 0:
        raise ValueError(f"--tile must be TH,TW positive ints, got {spec!r}")
    return tile


def _resolve_perf_knobs(args, grid) -> None:
    """Fill backend/storage/fuse left unset (None = not passed).

    ``--fast`` on the card fills them with the flagship family: cuda_sep,
    bf16 carries, fuse 32 (clamped so blocks stay >= radius·fuse); with an
    explicit ``--backend`` (e.g. cuda_rdma, or auto, which then tunes the
    backend and tile only) only storage and fuse fill in.  On the CPU the
    plain versions run anyway, so ``--fast`` leaves the defaults.
    ``--backend auto`` keeps an unset fuse at None: the tuner picks it.
    Explicit flags always win; every combination gives the same bytes.
    """
    from parallel_convolution_tpu_torch.ops.filters import get_filter

    if args.fast and grid.device.type == "cuda":
        if args.backend is None:
            args.backend = "cuda_sep"
        if args.storage is None:
            args.storage = "bf16"
        if args.fuse is None:
            block = min(-(-args.rows // grid.rows), -(-args.cols // grid.cols))
            r = get_filter(args.filter_name).radius
            args.fuse = max(1, min(32, block // max(1, r)))
        print(f"# --fast resolved: backend={args.backend} "
              f"storage={args.storage} fuse={args.fuse}", file=sys.stderr)
    if args.backend is None:
        args.backend = "shifted"
    if args.storage is None:
        args.storage = "f32"
    if args.fuse is None and args.backend != "auto":
        args.fuse = 1
    # --overlap: 'auto' -> None (off for an explicit backend, the tuner's
    # verdict under auto); on / off -> a request (step.resolve_overlap).
    args.overlap = {"auto": None, "on": True, "off": False}[args.overlap]


def _tune(args) -> int:
    """The ``tune`` subcommand: one summary JSON row on stdout, every
    measured (or error) row on stderr."""
    import json

    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import grid_from_spec
    from parallel_convolution_tpu_torch.tuning import (
        PlanCache, Workload, resolve, search,
    )

    grid = grid_from_spec(args.mesh, args.device)
    filt = get_filter(args.filter_name)
    shape = (3 if args.mode == "rgb" else 1, args.rows, args.cols)
    w = Workload.from_grid(grid, filt, shape, storage=args.storage)
    fuses = ([int(v) for v in args.fuses.split(",")] if args.fuses
             else None)
    result = search.tune(
        w, grid, dry_run=args.dry_run, fuses=fuses, iters=args.iters,
        max_measure=args.max_measure, interior_split=args.interior_split,
        overlap={"auto": None, "on": True, "off": False}[args.overlap])
    for row in result.rows:
        print(json.dumps(row), file=sys.stderr, flush=True)
    plan = result.plan
    summary = {
        "workload": {"shape": list(shape), "filter": filt.name,
                     "storage": args.storage,
                     "mesh": f"{w.grid[0]}x{w.grid[1]}",
                     "platform": w.platform, "device_kind": w.device_kind},
        "plan": plan.to_record(),
        "plan_key": w.key(),
        "measured_points": sum(1 for r in result.rows if "error" not in r),
        "errors": sum(1 for r in result.rows if "error" in r),
    }
    if summary["errors"]:
        # Legality is enumerated from the kernels' own planners, so an
        # error row is a fault: write no plan that auto would follow.
        print(json.dumps(summary), flush=True)
        print(f"error: {summary['errors']} candidate(s) failed to measure; "
              "no plan written", file=sys.stderr)
        return 1
    if args.emit_plans:
        cache = PlanCache()
        cache.put(w, plan)
        summary["plan_file"] = cache.merge_save(args.out)
        summary["plans_in_file"] = len(cache)
    if args.verify_auto:
        # Round trip: auto against the file just written must hand back
        # this plan with its provenance.
        res = resolve(grid, filt, shape, storage=args.storage,
                      fuse=fuses[0] if fuses and len(fuses) == 1 else None,
                      plans=PlanCache.load(args.out))
        summary["auto_resolved"] = {
            "backend": res.backend, "fuse": res.fuse,
            "tile": list(res.tile) if res.tile else None,
            "plan_source": res.source}
        summary["auto_ok"] = bool(
            (res.backend, res.fuse, res.tile, res.source)
            == (plan.backend, plan.fuse, plan.tile, plan.source))
    print(json.dumps(summary), flush=True)
    return 1 if args.verify_auto and not summary["auto_ok"] else 0


@functools.cache
def _parser() -> argparse.ArgumentParser:
    """The parser, built once a process: building it costs milliseconds,
    which a caller that runs ``main`` many times (``chip_smoke.py``) would
    otherwise pay on every call."""
    from parallel_convolution_tpu_torch.utils.config import (
        BOUNDARIES, SOLVERS, STORAGES,
    )

    ap = argparse.ArgumentParser(prog="python -m parallel_convolution_tpu_torch",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="iterate a filter over a raw image")
    _add_image_args(run)
    run.add_argument("-o", "--output", required=True)
    _add_perf_args(run)
    run.add_argument("--boundary", default="zero", choices=list(BOUNDARIES))
    run.add_argument("--converge", type=float, default=None, metavar="TOL",
                     help="run to convergence: stop when one iteration "
                          "changes no value by TOL or more (loops becomes "
                          "the iteration cap)")
    run.add_argument("--check-every", type=int, default=10, metavar="N",
                     help="iterations between convergence checks (one "
                          "readback each)")
    run.add_argument("--solver", default="jacobi", choices=list(SOLVERS),
                     help="convergence strategy (with --converge): plain "
                          "jacobi sweeps, or the geometric multigrid "
                          "V-cycle (same stopping measure, far fewer "
                          "fine-grid work units; f32 storage only)")
    run.add_argument("--mg-levels", type=int, default=None, metavar="N",
                     help="multigrid level-count cap (default: coarsen "
                          "to the planner's floor)")
    run.add_argument("--rank", type=int, default=2, choices=[2, 3],
                     help="workload rank: 2 = u8 images (the default), "
                          "3 = (2, D, rows, cols) raw float32 volumes (two "
                          "interleaved fields) through the rank-3 forms: "
                          "fd7 / fd25 FD Laplacians, wave leapfrog, "
                          "Gray-Scott reaction-diffusion")
    run.add_argument("--depth", type=int, default=None, metavar="D",
                     help="volume depth (required with --rank 3): the "
                          "resident D axis; rows / cols split on the grid")
    run.add_argument("--sharded-io", action="store_true",
                     help="stream the image between the file and the "
                          "card's blocks in row bands: no host buffer "
                          "holds the image (huge images)")
    run.add_argument("--checkpoint", default=None, metavar="DIR",
                     help="snapshot the blocks every --checkpoint-every "
                          "iterations and resume from DIR's newest valid "
                          "snapshot (any grid); the carry is f32, as in "
                          "the JAX CLI, whatever --storage says")
    run.add_argument("--checkpoint-every", type=int, default=100,
                     metavar="N",
                     help="iterations between snapshots (default 100)")

    ser = sub.add_parser("serial", help="serial NumPy oracle (golden path)")
    _add_image_args(ser)
    ser.add_argument("-o", "--output", required=True)
    ser.add_argument("--filter", default="blur3", dest="filter_name")
    ser.add_argument("--impl", default="auto",
                     choices=["auto", "oracle", "native"],
                     help="auto = the native C++ baseline when it builds "
                          "(byte-identical), else the NumPy oracle")

    gen = sub.add_parser("generate", help="write a deterministic test image")
    gen.add_argument("output")
    gen.add_argument("rows", type=int)
    gen.add_argument("cols", type=int)
    gen.add_argument("mode", choices=["grey", "rgb"])
    gen.add_argument("--seed", type=int, default=0)

    cmp_ = sub.add_parser("compare", help="byte-compare two raw images")
    cmp_.add_argument("a")
    cmp_.add_argument("b")

    tune = sub.add_parser("tune", help="tune one workload; write its plan")
    tune.add_argument("--rows", type=int, required=True)
    tune.add_argument("--cols", type=int, required=True)
    tune.add_argument("--mode", default="grey", choices=["grey", "rgb"])
    tune.add_argument("--filter", default="blur3", dest="filter_name")
    tune.add_argument("--storage", default="f32", choices=list(STORAGES))
    tune.add_argument("--mesh", default=None, metavar="RxC",
                      help="block grid (default: $PCTPU_MESH if set, else "
                           "1x1)")
    tune.add_argument("--device", default=None,
                      help="cuda (default) or cpu")
    tune.add_argument("--fuses", default=None, metavar="T,T,...",
                      help="restrict the fusion depths (a pin: an illegal "
                           "one is an error)")
    tune.add_argument("--iters", type=int, default=8,
                      help="iterations per measured rep (at least one "
                           "full chunk of each candidate's fuse)")
    tune.add_argument("--max-measure", type=int, default=8,
                      help="measured-refinement budget (model-pruned)")
    tune.add_argument("--dry-run", action="store_true",
                      help="cost model only, no device work; the plan "
                           "carries source='predicted'")
    tune.add_argument("--emit-plans", action="store_true",
                      help="merge the winning plan into --out (atomic)")
    tune.add_argument("--out", default="plans.json",
                      help="plan file for --emit-plans")
    tune.add_argument("--verify-auto", action="store_true",
                      help="after emitting, resolve auto against --out and "
                           "record auto_ok (requires --emit-plans)")
    tune.add_argument("--overlap", default="auto",
                      choices=["auto", "on", "off"],
                      help="the overlapped pipeline in the candidate space: "
                           "auto enumerates both where it is legal "
                           "(cuda_rdma on a grid of slots with an "
                           "interior), on / off a request clamped to that; "
                           "the plan keeps the winner's")
    tune.add_argument("--interior-split", action="store_true",
                      dest="interior_split",
                      help="measure every candidate with K2's 9-patch "
                           "launch")

    conv_ = sub.add_parser(
        "convert", help="raw -> PGM/PPM for visual inspection (no deps)")
    conv_.add_argument("image")
    conv_.add_argument("rows", type=int)
    conv_.add_argument("cols", type=int)
    conv_.add_argument("mode", choices=["grey", "rgb"])
    conv_.add_argument("-o", "--output", required=True,
                       help=".pgm (grey) or .ppm (rgb) path")

    bench_p = sub.add_parser("bench", help="time a synthetic workload; one "
                                           "JSON row to stdout")
    bench_p.add_argument("rows", type=int)
    bench_p.add_argument("cols", type=int)
    bench_p.add_argument("loops", type=int)
    bench_p.add_argument("mode", choices=["grey", "rgb"])
    _add_perf_args(bench_p)
    bench_p.add_argument("--reps", type=int, default=3,
                         help="timing repetitions (min 1)")

    info = sub.add_parser("info", help="cards, default grid, filters")
    info.add_argument("--device", default=None,
                      help="cuda (default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> int:
    from parallel_convolution_tpu_torch.obs import events
    from parallel_convolution_tpu_torch.resilience import diskio, faults

    # Injected-fault drills run end to end through the CLI (no-op unless
    # PCTPU_FAULTS / PCTPU_DISK_MODES are set), and PCTPU_OBS_EVENTS
    # names the event log a run appends to (a log already installed in
    # this process stays: its seq stream goes on).
    faults.install_from_env()
    diskio.install_from_env()
    if events.get_log() is None:
        events.install_from_env()
    ap = _parser()
    args = ap.parse_args(argv)
    try:
        return _dispatch(ap, args)
    except (NotImplementedError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _dispatch(ap: argparse.ArgumentParser, args) -> int:
    if args.cmd == "info":
        return _info(args)
    if args.cmd == "bench":
        return _bench(args)
    if args.cmd == "tune":
        if args.verify_auto and not args.emit_plans:
            ap.error("--verify-auto requires --emit-plans")
        try:
            return _tune(args)
        except (RuntimeError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    from parallel_convolution_tpu_torch.utils import imageio

    if args.cmd == "generate":
        img = imageio.generate_test_image(args.rows, args.cols, args.mode,
                                          seed=args.seed)
        imageio.write_raw(args.output, img)
        print(f"wrote {args.output}: {args.rows}x{args.cols} {args.mode}")
        return 0

    if args.cmd == "convert":
        img = imageio.read_raw(args.image, args.rows, args.cols, args.mode)
        magic = b"P5" if args.mode == "grey" else b"P6"
        with open(args.output, "wb") as f:
            f.write(magic + b"\n%d %d\n255\n" % (args.cols, args.rows))
            f.write(np.ascontiguousarray(img).tobytes())
        print(f"wrote {args.output} "
              f"({'PGM' if args.mode == 'grey' else 'PPM'})")
        return 0

    if args.cmd == "compare":
        a = np.fromfile(args.a, dtype=np.uint8)
        b = np.fromfile(args.b, dtype=np.uint8)
        if a.shape == b.shape and np.array_equal(a, b):
            print("identical")
            return 0
        if a.shape != b.shape:
            print(f"size mismatch: {a.size} vs {b.size} bytes")
        else:
            n = int((a != b).sum())
            print(f"differ: {n} bytes ({100.0 * n / a.size:.4f}%), max delta "
                  f"{int(np.abs(a.astype(int) - b.astype(int)).max())}")
        return 1

    from parallel_convolution_tpu_torch.ops.filters import get_filter

    if args.cmd == "serial":
        from parallel_convolution_tpu_torch.ops import oracle

        img = imageio.read_raw(args.image, args.rows, args.cols, args.mode)
        filt = get_filter(args.filter_name)
        impl = args.impl
        if impl in ("auto", "native"):
            from parallel_convolution_tpu_torch.native import serial_native

            try:
                out = serial_native.run_serial_u8(img, filt, args.loops)
                impl = "native"
            except RuntimeError as e:  # the library does not build
                if impl == "native":
                    print(f"error: {e}", file=sys.stderr)
                    return 2
                impl = "oracle"
        if impl == "oracle":
            out = oracle.run_serial_u8(img, filt, args.loops)
        imageio.write_raw(args.output, out)
        print(f"serial[{impl}]: {args.loops} x {args.filter_name} "
              f"-> {args.output}")
        return 0

    # run
    from parallel_convolution_tpu_torch.models import (
        ConvolutionModel, JacobiSolver,
    )
    from parallel_convolution_tpu_torch.parallel import multihost
    from parallel_convolution_tpu_torch.parallel.mesh import grid_from_spec
    from parallel_convolution_tpu_torch.utils.config import check_solver
    from parallel_convolution_tpu_torch.utils.platform import device_kind

    check_solver(args.solver)
    # One process of a job (torchrun's WORLD_SIZE / RANK / MASTER_ADDR /
    # MASTER_PORT, and LOCAL_WORLD_SIZE / LOCAL_RANK): --device all then
    # spans every process's slots, one card a process over NCCL where the
    # host has a card for each of its ranks, else over gloo.
    multihost.initialize()
    try:
        tile = _parse_tile(args.tile)
        grid = grid_from_spec(args.mesh, args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    _resolve_perf_knobs(args, grid)
    if args.rank == 3:
        return _run_volume(args, grid)
    if args.solver != "jacobi" and args.converge is None:
        print(f"--solver {args.solver} requires --converge TOL: without "
              "it the run is a fixed-count iterate and the solver choice "
              "would be silently ignored", file=sys.stderr)
        return 2
    if args.solver == "multigrid" and args.storage != "f32":
        print(f"--solver multigrid requires --storage f32 (got "
              f"{args.storage}): residual/correction fields need full "
              "float carries", file=sys.stderr)
        return 2
    if args.converge is not None:
        # The JAX CLI's converge branch takes none of these and ignores
        # them; here a flag that would do nothing is refused.
        unused = [flag for flag, on in (("--fallback", args.fallback),
                                        ("--sharded-io", args.sharded_io),
                                        ("--checkpoint", args.checkpoint))
                  if on]
        if unused:
            raise ValueError(f"{', '.join(unused)} with --converge: a "
                             "convergence run has no such branch")
        # Quantized semantics for Jacobi, as the JAX CLI's: u8-range states
        # with a store-back every iteration.  Multigrid carries signed
        # float residual and correction fields, which a store-back would
        # clamp: it runs unquantized.
        mg = args.solver == "multigrid"
        solver = JacobiSolver(
            filt=args.filter_name, tol=args.converge, max_iters=args.loops,
            check_every=args.check_every, grid=grid, backend=args.backend,
            quantize=not mg, fuse=args.fuse, tile=tile,
            boundary=args.boundary, storage=args.storage, solver=args.solver,
            mg_levels=args.mg_levels, interior_split=args.interior_split,
            overlap=args.overlap, col_mode=args.col_mode)
        img = imageio.read_raw(args.image, args.rows, args.cols, args.mode)
        x = imageio.interleaved_to_planar(img).astype(np.float32)
        out, iters = solver.solve(x)
        _write_once(grid, lambda: imageio.write_raw(
            args.output,
            imageio.planar_to_interleaved(
                np.clip(np.rint(out), 0, 255).astype(np.uint8))))
        if mg:
            # The JAX CLI's line, as it is: it says "converged after" also
            # when the work-unit cap stopped the run (ROADMAP Queue 3).
            res = solver.last_mg
            print(f"converged after {res.cycles} V-cycles "
                  f"({res.work_units} fine-grid work units, "
                  f"{res.levels} levels {res.level_shapes}, "
                  f"residual {res.residual:.3g}, tol {args.converge}) "
                  f"-> {args.output}")
        else:
            print(f"converged after {iters} iters (tol {args.converge}) "
                  f"-> {args.output}")
        return 0
    model = ConvolutionModel(filt=args.filter_name, grid=grid,
                             backend=args.backend, storage=args.storage,
                             fuse=args.fuse, boundary=args.boundary,
                             tile=tile, fallback=args.fallback,
                             interior_split=args.interior_split,
                             overlap=args.overlap, col_mode=args.col_mode)
    storage = args.storage
    if args.checkpoint:
        _run_checkpointed(args, model, grid, tile)
        storage = "f32"  # the checkpointed carry, as in the JAX CLI
    elif args.sharded_io:
        model.run_raw_file_sharded(args.image, args.output, args.rows,
                                   args.cols, args.mode, args.loops)
    else:
        model.run_raw_file(args.image, args.output, args.rows, args.cols,
                           args.mode, args.loops)
    eff = model.effective_backend
    if model.resolution is not None:
        res = model.resolution
        label = (f"auto resolved to {res.backend} [{res.source}]"
                 + ("" if eff == res.backend else f" degraded to {eff}")
                 + f", {storage}, fuse {res.fuse}, tile "
                 f"{'x'.join(map(str, res.tile)) if res.tile else 'default'}")
    else:
        label = ((args.backend if eff == args.backend
                  else f"{args.backend} degraded to {eff}")
                 + f", {storage}, fuse {model.effective_fuse}")
    if grid.slotted:
        label += (f", slots {grid.slot_map()}, col_mode "
                  f"{model.effective_col_mode}")
    if model.effective_overlap:
        label += ", overlapped halo pipeline"
    print(f"ran {args.loops} x {args.filter_name} on {grid.rows}x{grid.cols} "
          f"grid ({label}, {device_kind(grid.device)}) -> {args.output}")
    return 0


def _write_once(grid, write) -> None:
    """``write()`` the output: on a grid over several processes every rank
    holds the result, rank 0 writes it and the others wait for the file."""
    if not grid.spans_processes:
        write()
        return
    from parallel_convolution_tpu_torch.parallel import multihost

    if grid.rank == 0:
        write()
    multihost.barrier("output-written")


def _run_volume(args, grid) -> int:
    """The ``--rank 3`` arm of ``run`` (the JAX CLI's ``_run_volume``): the
    input file is raw float32 ``(2, D, rows, cols)`` bytes (two interleaved
    fields: u / v for Gray-Scott, u / u_prev for wave, field and rhs for
    the FD forms), the output the same layout after ``loops`` sweeps, or a
    ``--converge`` run.  Volumes stay float end to end: no u8
    quantization.  The same exit-2 refusals and summary lines as the JAX
    CLI."""
    from parallel_convolution_tpu_torch.utils.config import (
        VOLUME_FIELDS, VOLUME_FORMS,
    )
    from parallel_convolution_tpu_torch.volumes import driver

    if args.depth is None or args.depth < 1:
        print("--rank 3 requires --depth D (the resident volume depth)",
              file=sys.stderr)
        return 2
    if args.filter_name not in VOLUME_FORMS:
        print(f"--rank 3 --filter must name a rank-3 form "
              f"({', '.join(VOLUME_FORMS)}), got {args.filter_name!r}",
              file=sys.stderr)
        return 2
    if args.solver != "jacobi":
        print(f"--rank 3 supports --solver jacobi only (got "
              f"{args.solver}): rank-3 multigrid transfer ships as "
              "registry forms, not a CLI solver", file=sys.stderr)
        return 2
    want = (VOLUME_FIELDS, args.depth, args.rows, args.cols)
    raw = np.fromfile(args.image, dtype=np.float32)
    if raw.size != int(np.prod(want)):
        print(f"{args.image}: {raw.size} f32 values, expected "
              f"{int(np.prod(want))} for {want}", file=sys.stderr)
        return 2
    vol = raw.reshape(want)
    fuse = max(1, args.fuse or 1)
    r, c = grid.shape
    if args.converge is not None:
        out, iters, diff = driver.volume_converge(
            vol, args.filter_name, tol=args.converge,
            max_iters=args.loops, check_every=args.check_every, grid=grid,
            boundary=args.boundary, fuse=fuse)
        _write_once(grid, lambda: out.cpu().numpy().tofile(args.output))
        print(f"volume converged after {iters} iters (diff {diff:.3g}, "
              f"tol {args.converge}) on {r}x{c} mesh -> {args.output}")
        return 0
    out = driver.volume_iterate(vol, args.filter_name, args.loops, grid=grid,
                                boundary=args.boundary, fuse=fuse)
    _write_once(grid, lambda: out.cpu().numpy().tofile(args.output))
    print(f"ran {args.loops} x {args.filter_name} on "
          f"{args.depth}x{args.rows}x{args.cols} volume, {r}x{c} mesh "
          f"-> {args.output}")
    return 0


def _info(args) -> int:
    """The ``info`` subcommand: the cards (or the CPU), the default grid
    over them, the filter and backend registries."""
    import torch

    from parallel_convolution_tpu_torch.ops.filters import FILTERS
    from parallel_convolution_tpu_torch.parallel.mesh import dims_create
    from parallel_convolution_tpu_torch.utils.config import (
        BACKENDS, BOUNDARIES, SOLVERS, STORAGES,
    )
    from parallel_convolution_tpu_torch.utils.platform import (
        device_kind, resolve_device,
    )

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    print(f"backend: {dev.type}  devices: {len(devs)}")
    for d in devs[:8]:
        print(f"  {d}: {device_kind(d)}")
    shape = dims_create(len(devs))
    slots = ",".join(str(d) for d in devs) if dev.type == "cuda" else "cpu"
    print(f"default grid: {shape} over {len(devs)} device(s); --device "
          f"all would use the slots {slots}")
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.parallel.step import overlap_clamp

    clamp = overlap_clamp("cuda_rdma", make_grid((1, 2), devices=[dev, dev]))
    print("overlap: --overlap on with cuda_rdma on a grid of slots of "
          f"{dev} resolves to "
          + ("on" if clamp is None else f"off ({clamp[1]})"))
    print(f"filters: {', '.join(sorted(FILTERS))}")
    print(f"backends: {', '.join(BACKENDS)}")
    print(f"storages: {', '.join(STORAGES)}  "
          f"boundaries: {', '.join(BOUNDARIES)}  "
          f"solvers: {', '.join(SOLVERS)}")
    print("perf knobs: --fuse T, --tile TH,TW, --fast (measured flagship "
          "preset)")
    return 0


def _bench(args) -> int:
    """The ``bench`` subcommand: one JSON row of ``utils.bench.
    bench_iterate`` on stdout, with the card's name and power limit."""
    import json

    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel.mesh import grid_from_spec
    from parallel_convolution_tpu_torch.utils import bench as bench_lib
    from parallel_convolution_tpu_torch.utils.platform import power_limit_w

    try:
        tile = _parse_tile(args.tile)
        grid = grid_from_spec(args.mesh, args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    _resolve_perf_knobs(args, grid)
    row = bench_lib.bench_iterate(
        (args.rows, args.cols), get_filter(args.filter_name), args.loops,
        grid=grid, channels=3 if args.mode == "rgb" else 1,
        backend=args.backend, storage=args.storage, fuse=args.fuse,
        reps=args.reps, tile=tile, fallback=args.fallback,
        interior_split=args.interior_split, overlap=args.overlap,
        col_mode=args.col_mode)
    row["power_limit_w"] = power_limit_w(grid.device)
    print(json.dumps(row))
    return 0


def _run_checkpointed(args, model, grid, tile) -> None:
    """``run --checkpoint DIR``: the JAX CLI's branch.  The image is loaded
    block by block (``sharded_io``) as f32, whatever ``--storage`` says, as
    the JAX CLI loads it, and iterated with a snapshot every
    ``--checkpoint-every`` iterations, resuming from DIR's newest valid
    snapshot.  ``--fallback`` is resolved once here, at the loaded blocks,
    and every chunk runs the tier it picked; the model records it."""
    from parallel_convolution_tpu_torch.parallel import step as step_lib
    from parallel_convolution_tpu_torch.parallel.mesh import first_block
    from parallel_convolution_tpu_torch.utils import checkpoint, sharded_io

    blocks = sharded_io.load_sharded(args.image, args.rows, args.cols,
                                     args.mode, grid)
    block_hw = tuple(first_block(blocks).shape[1:])
    fuse = max(1, min(args.fuse, args.checkpoint_every, args.loops))
    eff = args.backend
    if args.fallback:
        # (--backend auto stops in run_checkpointed, at min(fuse=None,
        # every), as in the JAX package: ROADMAP Queue 3.)
        eff = step_lib._resolve_fallback(
            grid, model.filt, args.backend, True, fuse, args.boundary, tile,
            "f32", block_hw, args.interior_split)
    # The column transport and the overlap as every chunk resolves them.
    col_mode = step_lib.resolve_col_mode(args.col_mode, eff, grid, block_hw,
                                         model.filt.radius, fuse, "f32")
    overlap = step_lib.resolve_overlap(args.overlap, eff, grid)
    out = checkpoint.run_checkpointed(
        blocks, model.filt, args.loops, grid, (args.rows, args.cols),
        ckpt_dir=args.checkpoint, every=args.checkpoint_every,
        backend=args.backend, fuse=args.fuse, boundary=args.boundary,
        tile=tile, interior_split=args.interior_split, overlap=overlap,
        col_mode=col_mode, run_backend=eff)
    del blocks
    sharded_io.save_sharded(args.output, out, args.rows, args.cols,
                            args.mode, grid=grid)
    model.effective_backend, model.effective_fuse = eff, args.fuse
    model.effective_col_mode, model.effective_overlap = col_mode, overlap


if __name__ == "__main__":
    sys.exit(main())
