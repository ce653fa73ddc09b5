"""Build and load the port's CUDA kernels.

Each library ``build/torch_kernels/lib<name>.so`` (at the root of the
checkout) is linked from the parts :data:`LIBRARIES` lists: a
``csrc/<source>.cu`` compiled by ``nvcc`` with its own defines, every part
of every stale library compiled at once, each in its own process.  It is
built the first time it is needed and loaded with ``ctypes`` (a plain C
interface: the sources include no PyTorch header).  A stamp file holds the
hash of the sources, the shared headers (``csrc/*.cuh``) and the flags; a
changed source or header rebuilds.  Every build runs ptxas with ``-v`` and
keeps its report in ``lib<name>.log`` (:func:`ptxas_usage` reads the
registers, spills and shared memory of each kernel from it).  Nothing here
runs at import time.

``PCTPU_STRIP_V=<n>`` in the environment builds the level loop with
register strips of n outputs instead of the default (``kStripV`` in
``csrc/stencil_common.cuh``), into ``lib<name>.v<n>.so``: a measurement
knob (``probes/loop_sweep.py`` compares strip heights with it).
:data:`MEASUREMENT_LIBRARIES` are built only when named: ``stencil_copy``
is K1 without its compute (its copies in and stores out alone; its outputs
are not the step's), which ``probes/loop_sweep.py step`` times beside the
kernel.  No wrapper loads it: ``ops/stencil.py`` launches K1 from
``libstencil.so`` only.
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



def _stencil_parts(*extra):
    """libstencil's parts: csrc/stencil.cu and K1's instances (csrc/step.cu)
    split by input dtype and order, so that they compile in parallel;
    csrc/stencil.cu's pc_stencil_step dispatches to the parts."""
    return (("stencil", ()),) + tuple(
        ("step", (f"-DPC_STEP_IN={dt}", f"-DPC_STEP_SEP={sep}", *extra))
        for dt in (0, 1, 2) for sep in (0, 1))


# Library -> its parts: (source in csrc/, extra nvcc flags).
LIBRARIES = {
    "stencil": _stencil_parts(),
    "rdma": (("rdma", ()),),
    "probes": (("probes", ()),),
}
SOURCES = tuple(LIBRARIES)
# Measurement builds, with the C interface of the library named beside.
MEASUREMENT_LIBRARIES = {
    "stencil_copy": (_stencil_parts("-DPC_STEP_COPY_ONLY"), "stencil"),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
        # k, sep, epi, th, tw, rows, cols, pitch, out_pitch, stages,
        # threads, grid, blocks, stream
        "pc_stencil_step": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _IP, _P],
        "pc_step_strip": [_I],
        # in, in_dtype, out, out_dtype, C, Hp, Wp, h, w, T, taps, col, row,
        # k, sep, epi, off_r, off_c, mask_rows, mask_cols, valid_h,
        # valid_w, th, tw, ti0, tj0, gh, gw, threads, blocks, stream
        "pc_fused_iterate": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                             _F, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _IP, _P],
        "pc_strip_height": [],
    },
    "rdma": {
        # tiled, ptrs, nbr, in_dtype, out, out_dtype, nb, gcols, b0, count,
        # C, h, w, E, T, taps, k, epi, mask, valid_h, valid_w, th, tw,
        # y0, x0, rh, rw, threads, blocks, stream
        "pc_rdma_step": [_I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _IP, _P],
        # the address of a PackArgs (ops/rdma.py:_PackArgs)
        "pc_rdma_pack": [_P],
        # device, peer
        "pc_enable_peer": [_I, _I],
    },
    "probes": {
        # op, in, out, n, af, bf, ai, bi, stream
        "pc_op_chain": [_I, _P, _P, _L, _F, _F, _IP, _IP, _P],
        # in, out, n, bytes, opt_in, attr_err, stream
        "pc_smem_probe": [_P, _P, _I, _L, _I, _IP, _P],
        # device, value
        "pc_smem_optin": [_I, _IP],
        # rung, base, ptrs, nbr, in_dtype, out, out_dtype, nb, gcols, C, h,
        # w, T, taps, k, epi, mask, valid_h, valid_w, th, tw, threads,
        # stream
        "pc_rdma_ladder": [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                           _I, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
}


# Every C entry point returns a cudaError_t, and every library exports the
# runtime's name of one (pc_error_name, cudaGetErrorName), so that an error
# says which one it is and resilience/retry.py can tell a refused launch
# (the context survives) from a lost context (sticky).  Until a library is
# loaded (the CPU, or a build that failed) the names of the codes that
# retry.classify tells apart stand in; any other code reads
# "cudaError_t (N)", which classify takes as terminal.
FALLBACK_ERROR_NAMES = {
    1: "cudaErrorInvalidValue", 2: "cudaErrorMemoryAllocation",
    214: "cudaErrorECCUncorrectable", 700: "cudaErrorIllegalAddress",
    701: "cudaErrorLaunchOutOfResources", 702: "cudaErrorLaunchTimeout",
    709: "cudaErrorContextIsDestroyed", 710: "cudaErrorAssert",
    714: "cudaErrorHardwareStackError", 715: "cudaErrorIllegalInstruction",
    716: "cudaErrorMisalignedAddress", 717: "cudaErrorInvalidAddressSpace",
    718: "cudaErrorInvalidPc", 719: "cudaErrorLaunchFailure",
}
# The libraries loaded in this process (load_library appends each once).
_LOADED: list[ctypes.CDLL] = []


def error_text(err: int) -> str:
    """``cudaErrorName (code)`` of a cudaError_t value."""
    err = int(err)
    if _LOADED:
        name = _LOADED[0].pc_error_name(err).decode()
    else:
        name = FALLBACK_ERROR_NAMES.get(err, "cudaError_t")
    return f"{name} ({err})"


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


STRIP_V_ENV = "PCTPU_STRIP_V"


def _flags() -> tuple[tuple[str, ...], str]:
    """nvcc's flags and the library name's suffix for this process."""
    flags, suffix = NVCC_FLAGS, ""
    v = os.environ.get(STRIP_V_ENV, "").strip()
    if v:
        if not v.isdigit() or not 1 <= int(v) <= 16:
            raise ValueError(f"{STRIP_V_ENV}={v!r}: expected 1..16")
        flags, suffix = flags + (f"-DPC_STRIP_V={int(v)}",), f".v{int(v)}"
    return flags, suffix


def _parts(name: str) -> tuple:
    if name in MEASUREMENT_LIBRARIES:
        return MEASUREMENT_LIBRARIES[name][0]
    return LIBRARIES[name]


def _paths(name: str) -> tuple[Path, str]:
    """The library's path and the digest of everything it is built from."""
    flags, suffix = _flags()
    h = hashlib.sha256()
    for src, extra in _parts(name):
        h.update((CSRC / f"{src}.cu").read_bytes())
        h.update(" ".join(extra).encode() + b"\0")
    for p in sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}{suffix}.so", h.hexdigest()


def _is_fresh(lib: Path, digest: str) -> bool:
    stamp = lib.with_suffix(".sha256")
    return lib.is_file() and stamp.is_file() and stamp.read_text() == digest


def _wait(proc, what: str) -> str:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what} (exit {proc.returncode}):"
                           f"\n{out}{err}")
    return err + out


def build_all(names=SOURCES) -> dict:
    """Compile every part of every stale library, all ``nvcc`` processes
    started together, then link each library from its parts.

    Returns ``{name: {"seconds": s, "log": compiler output}}`` for the
    libraries it built (an up-to-date library is not rebuilt).  Raises
    ``RuntimeError`` with the compiler's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = _flags()[0]
    jobs = {}
    for name in names:
        lib, digest = _paths(name)
        if _is_fresh(lib, digest):
            continue
        parts = []
        for i, (src, extra) in enumerate(_parts(name)):
            obj = lib.with_name(f".{lib.stem}.{i}.{os.getpid()}.o")
            cmd = [nvcc_path(), *flags, *extra, "-c", "-o", str(obj),
                   str(CSRC / f"{src}.cu")]
            parts.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True),
                          obj, f"csrc/{src}.cu {' '.join(extra)}".strip()))
        jobs[name] = (parts, lib, digest, time.perf_counter())
    done = {}
    try:
        for name, (parts, lib, digest, t0) in jobs.items():
            log = "".join(_wait(proc, what) for proc, _, what in parts)
            tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
            link = subprocess.Popen(
                [nvcc_path(), "-shared", "-o", str(tmp),
                 *(str(obj) for _, obj, _ in parts)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            try:
                log += _wait(link, f"linking lib{name}")
            except RuntimeError:
                tmp.unlink(missing_ok=True)
                raise
            os.replace(tmp, lib)
            lib.with_suffix(".log").write_text(log)
            lib.with_suffix(".sha256").write_text(digest)
            done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    finally:  # no compiler outlives a failed build; no object file stays
        for parts, *_ in jobs.values():
            for proc, obj, _ in parts:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                obj.unlink(missing_ok=True)
    return done


def ptxas_usage(name: str) -> dict:
    """Per kernel symbol of ``lib<name>.so``'s last build: ``registers``,
    ``spill_stores``, ``spill_loads`` (bytes) and ``smem`` (static bytes),
    as ptxas reported them.  Empty when no report was kept."""
    log = _paths(name)[0].with_suffix(".log")
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
    lib = ctypes.CDLL(str(_paths(name)[0]))
    api = MEASUREMENT_LIBRARIES[name][1] if name in MEASUREMENT_LIBRARIES \
        else name
    for fn, argtypes in _SIGNATURES[api].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.pc_error_name.argtypes = [_I]
    lib.pc_error_name.restype = ctypes.c_char_p
    _LOADED.append(lib)
    return lib
