"""5b, the shared-memory budget probe: ``smem_probe``
(``csrc/probes.cu:smem_probe_kernel``) replaces the TPU probe
``scripts/helper_crash_probe.py:100`` (a trivial out = in + 1 kernel with
a 4 to 32 MB VMEM scratch, stepping across the scoped-VMEM budget to see
whether an overrun fails as a clean resource error or crashes the compile
helper).

What bounds it on this card: nothing but launch latency; the work is
trivial.  What it measures: the card's question in place of the TPU's.
The kernel computes out = in + 1 on a (256, 512) f32 array with a dynamic
shared-memory scratch it writes and reads, at sizes stepping across the
card's two limits — 48 KB without the opt-in attribute, and the opt-in
limit with it: 48 KB and 48 KB + 1 without opt-in; 100 KB, exactly the
opt-in limit, the limit + 1 and 256 KB with it.  Each row records the
bytes, the opt-in, the return codes of ``cudaFuncSetAttribute`` and of the
launch (and their names), whether the output is right, and ``error_class``:

* ``ok`` — launched and right;
* ``clean_refusal`` — refused, and a small canary launch right after is
  right (the TPU's clean resource error);
* ``sticky`` — the context is lost: the canary fails (the TPU's crashed
  compile helper).

This is the ground truth for the legality the tuner enumerates
(``tuning.search``), which rests on the opt-in limit; the rows print both
readings of it, torch's ``shared_memory_per_block_optin`` and the runtime's
``cudaDevAttrMaxSharedMemoryPerBlockOptin``, beside what launches accept.

    python -m parallel_convolution_tpu_torch.probes.smem_budget
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from parallel_convolution_tpu_torch.ops import stencil

DEFAULT_LIMIT = 48 * 1024  # dynamic shared memory without the opt-in
SHAPE = (256, 512)
# What each class of the TPU probe is on the card.
TPU_CLASS = {"clean_resource_error": "clean_refusal",
             "helper_http500": "sticky"}


def steps(optin: int) -> list[tuple[int, bool]]:
    """(bytes, opt_in) of each step for an opt-in limit of ``optin``."""
    return [(DEFAULT_LIMIT, False), (DEFAULT_LIMIT + 1, False),
            (100 * 1024, True), (optin, True), (optin + 1, True),
            (256 * 1024, True)]


def fits(nbytes: int, opt_in: bool, optin: int) -> bool:
    """Whether a launch with ``nbytes`` of dynamic shared memory is within
    the card's limit for that step."""
    return nbytes <= (optin if opt_in else DEFAULT_LIMIT)


def error_class(attr_err: int, launch_err: int, correct: bool,
                canary_ok: bool) -> str:
    """The step's class from its return codes, its output and the canary
    launched after it."""
    if not canary_ok:
        return "sticky"
    if attr_err == 0 and launch_err == 0:
        return "ok" if correct else "wrong"
    return "clean_refusal"


def smem_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: out = in + 1 (the scratch changes nothing)."""
    return x + 1.0


def smem_probe(x: torch.Tensor, nbytes: int,
               opt_in: bool) -> tuple[torch.Tensor, int, int]:
    """One launch with ``nbytes`` of dynamic shared memory (the attribute
    raised first when ``opt_in``).  Returns ``(out, attr_err,
    launch_err)``: a refusal is the datum, not an exception.  On a CPU
    tensor the plain version, with both codes 0."""
    if x.dtype != torch.float32:
        raise ValueError(f"smem_probe takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return smem_probe_plain(x), 0, 0
    if x.device.type != "cuda" or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("smem_probe takes a non-empty contiguous tensor")
    out = torch.empty_like(x)
    attr = ctypes.c_int(0)
    from parallel_convolution_tpu_torch.ops import _build

    lib = _build.load_library("probes")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pc_smem_probe(x.data_ptr(), out.data_ptr(), x.numel(),
                                int(nbytes), int(opt_in), ctypes.byref(attr),
                                stream)
    if err == 0:
        smem_probe.launches += 1
    return out, attr.value, err


smem_probe.launches = 0


def optin_readings(device) -> dict:
    """The opt-in limit as torch and as the CUDA runtime report it."""
    from parallel_convolution_tpu_torch.ops import _build

    props = torch.cuda.get_device_properties(device)
    value = ctypes.c_int(0)
    err = _build.load_library("probes").pc_smem_optin(
        torch.device(device).index or 0, ctypes.byref(value))
    return {"torch": getattr(props, "shared_memory_per_block_optin", None),
            "runtime": value.value if err == 0 else None}


def measure(device) -> list[dict]:
    """One row per step on the card."""
    from parallel_convolution_tpu_torch.ops import _build
    from parallel_convolution_tpu_torch.utils.platform import device_kind

    readings = optin_readings(device)
    limit = readings["runtime"] or stencil._smem_limit(device)
    x = (torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.float32,
                      device=device).reshape(SHAPE) % 251.0)
    want = smem_probe_plain(x)
    canary_in = torch.zeros(64, dtype=torch.float32, device=device)
    rows = []
    for nbytes, opt in steps(limit):
        out, attr_err, launch_err = smem_probe(x, nbytes, opt)
        try:
            torch.cuda.synchronize(device)
            correct = (attr_err == 0 and launch_err == 0
                       and bool(torch.equal(out, want)))
            c_out, c_attr, c_err = smem_probe(canary_in, 0, False)
            torch.cuda.synchronize(device)
            canary_ok = (c_attr == 0 and c_err == 0
                         and bool(torch.equal(c_out, canary_in + 1.0)))
        except RuntimeError:
            correct, canary_ok = False, False
        rows.append({"bytes": nbytes, "opt_in": opt,
                     "fits": fits(nbytes, opt, limit),
                     "attr_err": attr_err, "launch_err": launch_err,
                     "attr_error": _build.error_text(attr_err),
                     "launch_error": _build.error_text(launch_err),
                     "correct": correct, "canary_ok": canary_ok,
                     "error_class": error_class(attr_err, launch_err,
                                                correct, canary_ok),
                     "optin_torch": readings["torch"],
                     "optin_runtime": readings["runtime"],
                     "device": device_kind(device)})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"probe": "smem_budget", "error": "needs CUDA"}))
        return 1
    rows = measure(torch.device("cuda", 0))
    for row in rows:
        print(json.dumps(row), flush=True)
    ok = all(r["error_class"] == ("ok" if r["fits"] else "clean_refusal")
             for r in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
