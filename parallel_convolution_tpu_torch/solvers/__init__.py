"""Iterative solvers over the port's stencil machinery (the JAX package's
``solvers/``).

``solvers.multigrid`` is the geometric multigrid V-cycle: restriction and
prolongation are stencil forms registered in the kernel-form registry
(``solvers.transfer``, ``parallel.kernels``), smoothing runs the same
per-backend steps ``parallel.step`` builds (K1 for ``cuda``, K3 / K4 for
``cuda_rdma`` on the card), and coarse levels collapse onto smaller grids
of blocks on the same device.
"""

from parallel_convolution_tpu_torch.solvers import multigrid, transfer  # noqa: F401

__all__ = ["multigrid", "transfer"]
