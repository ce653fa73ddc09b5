"""Faults planted under the timed path, for the fault tests: each breaks
the program in place and leaves the harness as it is.  The ``*_child``
functions are the entries of spawned ranks, which plant the fault in
their own process before running the rank."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def state_unchanged_iterate():
    """``iterate_prepared``'s runner returns the blocks it was given."""
    from parallel_convolution_tpu_torch.parallel import step

    return patched(step, "_build_iterate",
                   lambda *a, **k: (lambda blocks: blocks))


def answer_altered_iterate():
    """Every 37th byte of each output block comes out one higher."""
    from parallel_convolution_tpu_torch.parallel import step

    real = step._build_iterate

    def build(*a, **k):
        run = real(*a, **k)

        def altered(blocks):
            out = run(blocks)
            for row in out:
                for b in row:
                    if b is not None:
                        flat = b.view(-1)
                        flat[::37] += 1
            return out
        return altered
    return patched(step, "_build_iterate", build)


def half_batch_left_out():
    """``run_planar`` iterates the first half of the planes; the rest
    come back as they went in."""
    from parallel_convolution_tpu_torch.models import ConvolutionModel

    real = ConvolutionModel.run_planar

    def run_planar(self, x, iters):
        half = x.shape[0] // 2
        done = real(self, x[:half], iters)
        rest = torch.as_tensor(x[half:]).to(done.device, torch.float32)
        return torch.cat([done, rest])
    return patched(ConvolutionModel, "run_planar", run_planar)


def smoother_unchanged():
    """The V-cycle's smoother step returns its state unchanged."""
    from parallel_convolution_tpu_torch.parallel import step

    return patched(step, "_make_block_step",
                   lambda *a, **k: (lambda state: state))


def exchange_left_out_child(*args):
    """A rank whose halo exchange between processes moves nothing."""
    from cardbench.kinds import resident_jobs
    from parallel_convolution_tpu_torch.parallel import multihost

    with patched(multihost, "swap", lambda sends, recvs: None):
        return resident_jobs._child(*args)


def state_unchanged_child(*args):
    """A rank whose runner returns the blocks it was given."""
    from cardbench.kinds import resident_jobs

    with state_unchanged_iterate():
        return resident_jobs._child(*args)


def jax_loaded_child(*args):
    """A rank that loads a module named ``jax`` (a stub) on its way."""
    import sys
    import types

    sys.modules["jax"] = types.ModuleType("jax")
    from cardbench.kinds import resident_jobs

    return resident_jobs._child(*args)
