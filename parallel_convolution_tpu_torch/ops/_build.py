"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into
``build/torch_kernels/lib<name>.so`` at the root of the checkout, the first
time it is needed, and loaded with ``ctypes`` (a plain C interface: the
sources include no PyTorch header, so a build takes seconds).  A stamp file
holds the hash of the source, the shared headers (``csrc/*.cuh``) and the
flags; a changed source or header rebuilds.  Every build runs ptxas with
``-v`` and keeps its report in ``lib<name>.log`` (:func:`ptxas_usage` reads
the registers, spills and shared memory of each kernel from it).  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

SOURCES = ("stencil", "rdma", "probes")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures (argtypes) of every entry point, by library.
_SIGNATURES = {
    "stencil": {
        # in, in_dtype, out, out_dtype, C, Hp, Wp, H, W, taps, col, row,
        # k, sep, quantize, convex, th, tw, stream
        "pc_stencil_step": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                            _I, _I, _I, _I, _I, _I, _P],
        # in, in_dtype, out, out_dtype, C, Hp, Wp, h, w, T, taps, col, row,
        # k, sep, quantize, convex, off_r, off_c, mask, valid_h, valid_w,
        # th, tw, stream
        "pc_fused_iterate": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                             _F, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    },
    "rdma": {
        # tiled, ptrs, nbr, in_dtype, out, out_dtype, nb, gcols, C, h, w,
        # E, T, taps, k, quantize, convex, mask, valid_h, valid_w, th, tw,
        # stream
        "pc_rdma_step": [_I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "probes": {
        # op, in, out, n, af, bf, ai, bi, stream
        "pc_op_chain": [_I, _P, _P, _L, _F, _F, _IP, _IP, _P],
        # in, out, n, bytes, opt_in, attr_err, stream
        "pc_smem_probe": [_P, _P, _I, _L, _I, _IP, _P],
        # device, value
        "pc_smem_optin": [_I, _IP],
        # rung, base, ptrs, nbr, in_dtype, out, out_dtype, nb, gcols, C, h,
        # w, T, taps, k, quantize, convex, mask, valid_h, valid_w, th, tw,
        # stream
        "pc_rdma_ladder": [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                           _I, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
}


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin):"
        " the port's CUDA kernels are built from csrc/ on the machine with "
        "the card")


def _paths(name: str) -> tuple[Path, Path, str]:
    src = CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}.so", digest


def _is_fresh(lib: Path, digest: str) -> bool:
    stamp = lib.with_suffix(".sha256")
    return lib.is_file() and stamp.is_file() and stamp.read_text() == digest


def build_all(names=SOURCES) -> dict:
    """Compile every stale source, all ``nvcc`` processes started together.

    Returns ``{name: {"seconds": s, "log": compiler output}}`` for the
    sources it built (an up-to-date library is not rebuilt).  Raises
    ``RuntimeError`` with the compiler's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib, digest = _paths(name)
        if _is_fresh(lib, digest):
            continue
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, lib, digest, time.perf_counter())
    done = {}
    for name, (proc, tmp, lib, digest, t0) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{out}{err}")
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(err + out)
        lib.with_suffix(".sha256").write_text(digest)
        done[name] = {"seconds": time.perf_counter() - t0, "log": err + out}
    return done


def ptxas_usage(name: str) -> dict:
    """Per kernel symbol of ``lib<name>.so``'s last build: ``registers``,
    ``spill_stores``, ``spill_loads`` (bytes) and ``smem`` (static bytes),
    as ptxas reported them.  Empty when no report was kept."""
    log = _paths(name)[1].with_suffix(".log")
    usage, current = {}, None
    for line in (log.read_text().splitlines() if log.is_file() else []):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = usage.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            current["smem"] = int(s.group(1)) if s else 0
    return usage


@functools.lru_cache(maxsize=None)
def load_library(name: str = "stencil") -> ctypes.CDLL:
    """Build (if stale) and load ``lib<name>.so`` with its C signatures."""
    build_all((name,))
    lib = ctypes.CDLL(str(_paths(name)[1]))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
