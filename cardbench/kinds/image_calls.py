"""Image calls: a closed loop with one caller, each call
``ConvolutionModel.run_images`` on ``batch`` distinct seeded host images
(``height`` × ``width`` × ``channels`` u8, interleaved, as a user holds
them), ``iterations`` iterations, the answers back on the host as u8.
A pool of ``pool`` images is made in set-up; call k takes images
``k·batch .. k·batch + batch - 1`` of it, modulo its size.

What is checked: every image of ``kept_calls`` calls drawn from the seed
among those of the window, whole, against
:func:`cardbench.reference.iterate_u8` of the image remade from the seed
(planar, on the card).
"""

from __future__ import annotations

from cardbench import inputs, reference, roofline, trace
from cardbench.kinds import (
    Outcome, Reservoir, build_kernels, clock, device_of, memory_peak,
    percentile,
)


def reference_images(cell, seed: int, indices, device, dtype=None):
    """The reference's answers for pool images ``indices``: {index:
    (C, H, W) u8}."""
    import torch

    cfg, tr = cell.config, cell.traffic
    H, W, ch = int(tr["height"]), int(tr["width"]), int(tr["channels"])
    t = reference.taps(cfg)
    out = {}
    indices = sorted(set(indices))
    for k in range(0, len(indices), 8):
        part = indices[k:k + 8]
        src = torch.stack([inputs.image(seed, p, ch, (H, W), device)
                           for p in part])
        inside = torch.ones((len(part), 1, H, W), dtype=torch.bool,
                            device=device)
        got = reference.iterate_u8(src, inside, t, int(cfg["iterations"]), 0,
                                   dtype=dtype or torch.float32)
        out.update(zip(part, got))
    return out


def run(cell, seed: int, seconds: float, traced: bool, device=None,
        child=None) -> Outcome:
    import torch

    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.parallel import mesh

    cfg, tr = cell.config, cell.traffic
    dev = device_of(device)
    build_kernels(dev)
    H, W, ch = int(tr["height"]), int(tr["width"]), int(tr["channels"])
    B, P, iters = int(tr["batch"]), int(tr["pool"]), int(cfg["iterations"])
    model = ConvolutionModel(
        cfg["filter"], grid=mesh.make_grid(tuple(cfg["grid"]), device=dev),
        backend=cfg["backend"], quantize=bool(cfg["quantize"]),
        storage=cfg["storage"], fuse=int(cfg["fuse"]),
        boundary=cfg["boundary"])
    pool = [inputs.image(seed, p, ch, (H, W), dev).permute(1, 2, 0)
            .contiguous().cpu().numpy() for p in range(P)]

    def batch(k):
        return [(k * B + j) % P for j in range(B)]

    for k in range(2):  # warm-up: the first call loads the kernels
        model.run_images([pool[p] for p in batch(k)], iters)
    kept = Reservoir(int(tr["kept_calls"]), inputs.key(seed, 0xCA11))
    lat = []
    stencil.reset_launch_counts()
    with trace.Window(traced) as win:
        start = clock()
        while True:
            idx = batch(len(lat))
            t0 = clock()
            with trace.span("cardbench.call"):
                outs = model.run_images([pool[p] for p in idx], iters)
            lat.append(clock() - t0)
            kept.offer((idx, outs))
            if clock() - start >= seconds:
                break
        elapsed = clock() - start
    launches = stencil.launch_counts()
    peak = memory_peak(dev)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_images(cell, seed, [p for idx, _ in kept.items
                                         for p in idx], dev)
    bad = compared = 0
    for idx, outs in kept.items:
        for p, got in zip(idx, outs):
            w = want[p].permute(1, 2, 0).cpu().numpy()
            if got.ndim == 2:
                got = got[..., None]
            bad += int((got != w).sum()) if got.shape == w.shape else w.size
            compared += w.size
    calls = len(lat)
    pixels = ch * H * W * B
    ops, nbytes = roofline.iterate_work(reference.taps(cfg).numpy(),
                                        bool(cfg["quantize"]), pixels, iters,
                                        cfg["storage"])
    ctx = {"trace": win.summary, "launches": launches, "jobs": calls,
           "calls": calls, "job_ops": ops, "job_bytes": nbytes}
    return Outcome(
        attempted=calls, failed=0,
        end_to_end={"call_gpx_per_s": pixels * iters * calls / elapsed / 1e9},
        checks={"bad_bytes": (bad, cfg["limits"]["bad_bytes"])},
        ctx=ctx, memory_peak_bytes=peak, cards=1, window_start=start,
        notes=[f"calls {calls} in {elapsed:.6f} s; p50 "
               f"{percentile(lat, 50) * 1e3:.6f} ms; p95 "
               f"{percentile(lat, 95) * 1e3:.6f} ms; max "
               f"{max(lat) * 1e3:.6f} ms; calls kept {len(kept.items)}; "
               f"bytes compared {compared}"])


def control(cell, seed: int, device) -> dict:
    """The control's readings: the reference in bfloat16 in the program's
    place, on the images of the first ``kept_calls`` calls."""
    import torch

    B, P = int(cell.traffic["batch"]), int(cell.traffic["pool"])
    idx = sorted({(k * B + j) % P for k in range(int(
        cell.traffic["kept_calls"])) for j in range(B)})
    want = reference_images(cell, seed, idx, device)
    low = reference_images(cell, seed, idx, device, dtype=torch.bfloat16)
    return {"bad_bytes": sum(int((low[p] != want[p]).sum()) for p in idx)}
