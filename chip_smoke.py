#!/usr/bin/env python3
"""On-card proof of parallel_convolution_tpu_torch: build, check, drive, time.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``parallel_convolution_tpu_torch/csrc`` with
   nvcc (all sources at once) and print the build seconds and ptxas usage;
3. every kernel against its plain PyTorch version on the card: filters
   blur3 / gaussian5 / edge5 / sharpen3, storage f32 / bf16 / u8, quantize
   on and off, separable on and off, T in {1, 2, 8, 32}, zero and periodic
   boundaries, odd shapes with a ragged last tile, and the main path's own
   shapes.  Quantize mode must be byte-equal; float mode within
   ``stencil.float_tolerance`` (the kernels round once per tap as an FMA,
   the plain versions twice);
4. the main path at full size, 100 iterations each, through the user entry
   points, with the launch counters set to 0 just before each run and read
   just after: ``ConvolutionModel`` (cuda_sep / bf16 / fuse 32, and cuda /
   f32 / fuse 1) on a 1920x2520 RGB image, and the ``run`` CLI with
   ``--fast`` on 1920x2520 grey blur3 and 8192x8192 grey edge5.  Each must
   be byte-equal to the plain ``shifted`` path run on the card, and a
   3-iteration run must equal the NumPy oracle;
5. times with CUDA events after a warm-up: each kernel at the main path's
   shapes, its plain version, ``F.conv2d`` (TF32 off) as K1's one-call
   yardstick, each kernel's bound, and end-to-end Gpx/s of each path's
   counted first run, of a second (warm) run, and of the model on an image
   already on the card (the host's share of the time is the difference);
6. the ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
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
REPLACES = {
    "stencil_step": "parallel_convolution_tpu/ops/pallas_stencil.py:405",
    "fused_iterate": "parallel_convolution_tpu/ops/pallas_stencil.py:736",
}
SOURCE = "parallel_convolution_tpu_torch/csrc/stencil.cu"


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


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
    torch.cuda.synchronize()
    print(f"kernel checks: {n} cases agree (quantize mode byte-equal; float "
          f"mode within stencil.float_tolerance, max abs err "
          f"K1 {worst['stencil_step']:.3g}, K2 {worst['fused_iterate']:.3g})")
    return worst


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


def time_step(img, filt, storage, dev) -> dict:
    """K1 as ConvolutionModel(backend='cuda', f32, fuse=1) calls it."""
    import torch
    import torch.nn.functional as F

    from parallel_convolution_tpu_torch.ops import stencil

    p = padded_block(img, storage, filt.radius, dev)
    kw = dict(quantize=True, out_dtype=p.dtype, separable=False)
    got = stencil.stencil_step(p, filt, **kw)
    want = stencil.stencil_step_plain(p, filt, **kw)
    ok, err = agree(got, want, filt, 1, True)
    check(ok, f"K1 at the main path's shape {tuple(p.shape)}: err {err}")
    ms = cuda_ms(lambda: stencil.stencil_step(p, filt, **kw), reps=50)
    plain_ms = cuda_ms(lambda: stencil.stencil_step_plain(p, filt, **kw),
                       reps=10)
    # The one-call yardstick: F.conv2d in full FP32 (cuDNN's TF32 off),
    # timed here only; the port never calls it for K1's work.
    torch.backends.cudnn.allow_tf32 = False
    taps = torch.as_tensor(filt.taps, device=dev)[None, None]
    lib_ms = cuda_ms(lambda: F.conv2d(p[:, None], taps), reps=50)
    C, H, W = got.shape
    nbytes = p.numel() * p.element_size() + got.numel() * got.element_size()
    b_ms, b_by = bound(nbytes, C * level_ops(filt, False, H, W, True, False))
    return dict(shape=list(p.shape), dtype=str(p.dtype), max_abs_err=err,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


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
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)


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


def drive(label, fn, expect: dict, pixels: int) -> tuple[object, dict, float]:
    """Run one main-path entry point with the counters zeroed just before
    and read just after; check the expected launch counts."""
    from parallel_convolution_tpu_torch.ops import stencil

    stencil.reset_launch_counts()
    out, secs = host_seconds(fn)
    counts = stencil.launch_counts()
    for name, want in expect.items():
        check(counts[name] == want,
              f"{label}: {name} launched {counts[name]} times, expected {want}")
    check(any(counts.values()), f"{label}: no kernel launched")
    print(f"main path {label}: launches {counts}, {secs:.4f} s, "
          f"{pixels * ITERS / secs / 1e9:.3f} Gpx/s end to end")
    return out, counts, secs


def expected_launches(filt, fuse: int, hw) -> dict:
    """Launches of one ``ITERS``-iteration run on a 1x1 grid: K2 per
    fused chunk (one per level group), K1 per single-level step."""
    from parallel_convolution_tpu_torch.ops import stencil

    if fuse == 1:
        return {"stencil_step": ITERS, "fused_iterate": 0}
    n_chunks, rem = divmod(ITERS, fuse)
    per = lambda T: len(stencil.fused_plan(filt.radius, T, hw)[2])
    return {"stencil_step": 1 if rem == 1 else 0,
            "fused_iterate": n_chunks * per(fuse) + (per(rem) if rem > 1 else 0)}


def main_paths(dev, tmp: Path) -> tuple[dict, list]:
    import numpy as np

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import oracle
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.utils import imageio

    import torch

    totals = {"stencil_step": 0, "fused_iterate": 0}
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
        check(np.array_equal(out, plain(name, img, ITERS)),
              f"{label}: differs from shifted")
        crop = img[:ORACLE_CROP, :ORACLE_CROP]
        fast = ConvolutionModel(name, backend="cuda_sep", storage="bf16",
                                fuse=32, device=dev)
        check(np.array_equal(fast.run_image(crop, 3),
                             oracle.run_serial_u8(crop, filt, 3)),
              f"{label}: 3 iterations on {crop.shape} differ from the oracle")
        _, warm = host_seconds(run_cli)
        add(label, counts, rows_ * cols_, secs, warm)
    check(all(totals.values()), f"a kernel never ran on the main path: {totals}")
    return totals, rows


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
        built = _build.build_all(ptxas_verbose=True)
        each = ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items())
        print(f"build: {time.perf_counter() - t0:.2f} s "
              f"({each or 'up to date'})")
        for v in built.values():
            for line in v["log"].splitlines():
                if "Used" in line or "Function properties" in line:
                    print(f"  ptxas: {line.strip()}")
        _build.load_library("stencil")

        check_kernels(dev)

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            totals, rows = main_paths(dev, Path(tmp))

        rgb = imageio.generate_test_image(*RGB_HW, "rgb", seed=1)
        grey8k = imageio.generate_test_image(*BIG_HW, "grey", seed=2)
        blur3, edge5 = get_filter("blur3"), get_filter("edge5")
        k1 = time_step(rgb, blur3, "f32", dev)
        k2 = time_fused(rgb, blur3, "bf16", 32, True, dev)
        k2_edge = time_fused(grey8k, edge5, "bf16", 32, True, dev)
        for name, t in (("stencil_step rgb blur3 f32", k1),
                        ("fused_iterate rgb blur3 bf16 T=32", k2),
                        ("fused_iterate grey8k edge5 bf16 T=32", k2_edge)):
            print(f"time {name}: " + json.dumps(t))
        for row in rows:
            print("end to end: " + json.dumps(row))

        kernels = []
        for name, t in (("stencil_step", k1), ("fused_iterate", k2)):
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": totals[name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
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
