"""Build the native library with g++ (no network, no external deps).

Usage: ``python -m parallel_convolution_tpu_torch.native.build``

The library goes to ``build/native/libpctpu.so`` at the root of the
checkout, never beside its source.  Flag notes (the JAX package's flags):
``-O3 -march=native -fopenmp`` mirror the reference's ``-O3 -fopenmp``
Makefiles; ``-ffp-contract=off`` is load-bearing — an fma contraction of
``acc += tap * px`` would round once instead of twice and break
bit-exactness against the NumPy oracle.

Two processes may ask for the library at once (a test run spread over
workers): the build holds an exclusive ``flock`` on ``build/native/.lock``,
compiles to a temporary name and ``os.replace`` s it into place, so a
reader never maps a half-written file.  A stamp beside the library holds a
hash of the source, the flags and the host CPU (``-march=native`` code
from another CPU may not run here); a change rebuilds.  A failed build
raises with g++'s stderr.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "src" / "pctpu.cpp"
BUILD_DIR = HERE.parent.parent / "build" / "native"
LIB = BUILD_DIR / "libpctpu.so"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared",
         "-ffp-contract=off", "-fno-fast-math")


def _cpuinfo(key: str) -> str | None:
    """The first ``key`` line's value in ``/proc/cpuinfo``, if any."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.split(":", 1)[0].strip() == key:
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def host_cpu() -> str:
    """The host CPU's model name (``/proc/cpuinfo``), else the machine
    type."""
    return _cpuinfo("model name") or platform.machine() or "unknown"


def _digest() -> str:
    """The stamp: the source, the flags, and what ``-march=native``
    compiled for (the CPU's model and feature flags)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(host_cpu().encode())
    h.update((_cpuinfo("flags") or "").encode())
    return h.hexdigest()


def _stamp() -> Path:
    return LIB.with_suffix(".stamp")


def is_fresh() -> bool:
    """The library exists and was built from this source, with these
    flags, for this CPU."""
    try:
        return LIB.exists() and _stamp().read_text() == _digest()
    except OSError:
        return False


def build(verbose: bool = False, force: bool = False) -> Path:
    """Build ``build/native/libpctpu.so`` unless it is fresh (or
    ``force``); returns its path.  Raises ``RuntimeError`` naming g++'s
    stderr when the compile fails, or when g++ is missing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if is_fresh() and not force:
            return LIB
        tmp = BUILD_DIR / f".libpctpu.{os.getpid()}.so"
        cmd = ["g++", *FLAGS, "-o", str(tmp), str(SOURCE)]
        if verbose:
            print(" ".join(cmd))
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native build: cannot run g++ ({e})") from e
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native build failed (g++ exit {res.returncode}): "
                f"{res.stderr.strip()}")
        os.replace(tmp, LIB)
        _stamp().write_text(_digest())
    return LIB


if __name__ == "__main__":
    path = build(verbose=True, force=True)
    print(f"built {path}")
    sys.exit(0)
