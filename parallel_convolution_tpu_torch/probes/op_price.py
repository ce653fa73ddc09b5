"""5a, the op-price probe: ``op_chain`` (``csrc/probes.cu:op_chain_kernel``)
replaces the TPU probe ``scripts/vpu_op_probe.py:102`` (a Pallas kernel
running K dependent elementwise steps per element of (8192, 512) arrays in
VMEM, to price the ops the kernels issue).

What bounds it on this card: instruction issue.  Each thread reads one
element, runs four independent chains (:data:`CHAINS`) of 128 dependent
steps (:data:`STEPS`) on it in registers, and writes each chain's result:
512 steps for 20 bytes of f32, where the H100 issues about 10 FMAs per
byte it moves.  The independent chains keep several instructions of each
thread in flight, so the row prices issue, not the latency of one chain.

What it measures, for the same ten candidates as the TPU probe: f32 FMA
(``__fmaf_rn``); bf16 FMA on packed pairs (``__hfma2`` on
``__nv_bfloat162`` — the TPU probe's "packed-2x issue?" is the card's
question too); i32 and i16 multiply-add and add; f32 add; rint + add
(``rintf``); the magic round (y + 1.5·2²³) − 1.5·2²³ + add, in ``__fadd_rn``
so nvcc can neither contract nor fold it; clamp + add.  Rows:
``gops_per_s`` (element-steps × ops per step) and ``per_step_vs_f32_fma``,
the price of one step in f32-FMA steps.  The f32 FMA row sets
``tuning.costmodel.H100.flop_gops``; rint + add minus add, the quantize.

    python -m parallel_convolution_tpu_torch.probes.op_price

The plain version (:func:`op_chain_plain`) runs the same chains in
PyTorch: the float chains one IEEE operation at a time; the FMA chains as
the exact product and sum in float64, rounded once (exact for these
inputs: y·a + b needs at most 48 significant bits); the integer chains in
int64, wrapped to 32 or 16 bits after every step as the card's unsigned
registers wrap.
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from parallel_convolution_tpu_torch.ops import stencil

ROWS, COLS = 8192, 512
STEPS = 128    # dependent steps per chain (csrc/probes.cu kSteps)
CHAINS = 4     # independent chains per thread (kChains)
MAGIC = 12582912.0  # 1.5 * 2**23: an f32 add rounds half to even at ulp 1

# (op, dtype, ops per step), in the order of csrc/probes.cu's Op codes.
CANDIDATES = (
    ("fma", "f32", 1), ("fma", "bf16", 1), ("muladd", "i32", 1),
    ("muladd", "i16", 1), ("add", "i32", 1), ("add", "i16", 1),
    ("add", "f32", 1), ("rint+add", "f32", 2), ("magicround+add", "f32", 3),
    ("clamp+add", "f32", 3),
)
OP_CODES = {(op, dt): i for i, (op, dt, _) in enumerate(CANDIDATES)}

# Per-chain constants, exact in bf16 as in f32.  Multipliers near 1 and
# small addends keep 128 float steps in range.
A_F = (0.9921875, 1.0078125, 0.99609375, 0.984375)
B_F = (0.25, -0.375, 0.125, -0.0625)
A_I = (3, 5, 7, 9)
B_I = (1, -2, 3, -4)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32,
          "i16": torch.int16}
_BITS = {"i32": 32, "i16": 16}


def make_input(dtype: str, rows: int = ROWS, cols: int = COLS,
               seed: int = 0) -> torch.Tensor:
    """The probe's seeded (rows, cols) input on the CPU: floats in
    [10, 200), integers in [0, 255)."""
    rng = np.random.default_rng(seed)
    if dtype in ("f32", "bf16"):
        x = rng.uniform(10.0, 200.0, (rows, cols)).astype(np.float32)
    else:
        x = rng.integers(0, 255, (rows, cols)).astype(np.int32)
    return torch.from_numpy(x).to(DTYPES[dtype])


def _round_bf16(s: torch.Tensor) -> torch.Tensor:
    """float64 values rounded once, half to even, to bf16's 8 significant
    bits (still float64)."""
    m, e = torch.frexp(s)
    return torch.ldexp(torch.round(torch.ldexp(m, torch.full_like(e, 8))),
                       e - 8)


def _check(x: torch.Tensor, op: str, dtype: str) -> None:
    if (op, dtype) not in OP_CODES:
        raise ValueError(f"no op_chain candidate {op!r} in {dtype!r}; "
                         f"candidates: {[c[:2] for c in CANDIDATES]}")
    if x.dtype != DTYPES[dtype]:
        raise ValueError(f"{op} {dtype} takes {DTYPES[dtype]}, got {x.dtype}")


def op_chain_plain(x: torch.Tensor, op: str, dtype: str) -> torch.Tensor:
    """Plain PyTorch version of ``op_chain``: (CHAINS, *x.shape), chain c
    being :data:`STEPS` steps with constants ``A_*[c]``, ``B_*[c]``."""
    _check(x, op, dtype)
    outs = []
    for c in range(CHAINS):
        if dtype in _BITS:
            bits = _BITS[dtype]
            mask = (1 << bits) - 1
            a, b = A_I[c] & mask, B_I[c] & mask
            y = x.to(torch.int64) & mask
            for _ in range(STEPS):
                y = ((y * a + b) if op == "muladd" else (y + b)) & mask
            y = torch.where(y >= 1 << (bits - 1), y - (1 << bits), y)
        elif op == "fma":
            a, b = float(A_F[c]), float(B_F[c])
            y = x.to(torch.float64)
            for _ in range(STEPS):
                s = y * a + b  # exact in float64 for these inputs
                y = (_round_bf16(s) if dtype == "bf16"
                     else s.to(torch.float32).to(torch.float64))
        else:
            b = float(B_F[c])
            y = x.clone()
            for _ in range(STEPS):
                if op == "rint+add":
                    y = torch.round(y)
                elif op == "magicround+add":
                    y = (y + MAGIC) - MAGIC
                elif op == "clamp+add":
                    y = torch.clamp(y, 0.0, 255.0)
                y = y + b
        outs.append(y.to(x.dtype))
    return torch.stack(outs)


def op_chain(x: torch.Tensor, op: str, dtype: str) -> torch.Tensor:
    """``op_chain`` on ``x``: the kernel on a CUDA tensor, the plain version
    on a CPU one.  Returns (CHAINS, *x.shape) in ``x``'s dtype."""
    _check(x, op, dtype)
    if x.device.type == "cpu":
        return op_chain_plain(x, op, dtype)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("op_chain takes a contiguous CPU or CUDA tensor")
    n = x.numel()
    if n == 0 or (dtype == "bf16" and n % 2):
        raise ValueError(f"op_chain needs a non-empty input (an even count "
                         f"for bf16 pairs), got {n} elements")
    out = torch.empty((CHAINS, *x.shape), dtype=x.dtype, device=x.device)
    af, bf = (np.asarray(v, np.float32) for v in (A_F, B_F))
    ai, bi = (np.asarray(v, np.int32) for v in (A_I, B_I))
    ip = ctypes.POINTER(ctypes.c_int)
    from parallel_convolution_tpu_torch.ops import _build

    lib = _build.load_library("probes")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pc_op_chain(OP_CODES[(op, dtype)], x.data_ptr(),
                              out.data_ptr(), n // 2 if dtype == "bf16" else n,
                              stencil._fptr(af), stencil._fptr(bf),
                              ai.ctypes.data_as(ip), bi.ctypes.data_as(ip),
                              stream)
    stencil._raise_on(err, "op_chain (5a)")
    op_chain.launches += 1
    return out


op_chain.launches = 0


def measure(device, reps: int = 20) -> list[dict]:
    """One row per candidate on the card: the kernel against its plain
    version (``correct``), its time by CUDA events, and its rates."""
    from parallel_convolution_tpu_torch.utils.bench import cuda_ms
    from parallel_convolution_tpu_torch.utils.platform import device_kind

    rows, f32_step = [], None
    for op, dtype, ops in CANDIDATES:
        x = make_input(dtype).to(device)
        got = op_chain(x, op, dtype)
        want = op_chain_plain(x, op, dtype)
        err = float((got.double() - want.double()).abs().max())
        ms = cuda_ms(lambda: op_chain(x, op, dtype), reps)
        plain_ms = cuda_ms(lambda: op_chain_plain(x, op, dtype), 1, warmup=0)
        wall_s = ms / 1e3
        row = {"op": op, "dtype": dtype, "ops_per_step": ops,
               "elems": x.numel(), "k": STEPS, "chains": CHAINS,
               "wall_s": wall_s,
               "gops_per_s": x.numel() * CHAINS * STEPS * ops / wall_s / 1e9,
               "correct": bool(torch.equal(got, want)), "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms,
               "device": device_kind(device)}
        if (op, dtype) == ("fma", "f32"):
            f32_step = wall_s / STEPS
        if f32_step:
            row["per_step_vs_f32_fma"] = wall_s / STEPS / f32_step
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"probe": "op_price", "error": "needs CUDA"}))
        return 1
    rows = measure(torch.device("cuda", 0))
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
