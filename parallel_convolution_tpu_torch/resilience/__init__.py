"""Resilience layer of the PyTorch port (the JAX package's ``resilience/``
modules this slice needs): fault injection, guarded disk IO, classified
retry and backend degradation.

* :mod:`.faults` — the seeded, process-global fault plan and its named
  sites (``PCTPU_FAULTS`` / ``PCTPU_FAULT_SEED``), the port's own copy.
* :mod:`.diskio` — storage-shaped failures at the checkpoint sites
  (``PCTPU_DISK_MODES``), the port's own copy of ``consult``.
* :mod:`.retry` — the transient/terminal taxonomy (:func:`classify`),
  with the CUDA error classes of the card, and :func:`with_retry`.
* :mod:`.degrade` — probe a backend once per (grid, config) per process
  and walk ``cuda_rdma → cuda`` on a transient failure (on the card the
  kernel tiers stop at ``cuda``; on the CPU it steps down to ``shifted``).
* :mod:`.elastic` — detect a shrunken device set against the distinct
  devices a grid needs, the grid ladder, ``PCTPU_MESH``, and
  ``reshape_grid``.
* :mod:`.supervisor` — the leg queue with its ledger, HALT sentinel,
  retries and grid ladder (``python -m
  parallel_convolution_tpu_torch.resilience.supervisor``).
* :mod:`.breaker` — the per-replica circuit breaker (its user, the
  router, is ROADMAP item 8b).

Nothing here imports JAX or the JAX package.
"""

from parallel_convolution_tpu_torch.resilience.faults import (  # noqa: F401
    InjectedFault,
    KNOWN_SITES,
    fault_point,
    injected,
    install_plan,
    plan_from_env,
    plan_from_spec,
    uninstall_plan,
)
from parallel_convolution_tpu_torch.resilience.retry import (  # noqa: F401
    RetryExhausted,
    RetryPolicy,
    classify,
    with_retry,
)

__all__ = [
    "InjectedFault", "KNOWN_SITES", "fault_point", "injected",
    "install_plan", "plan_from_env", "plan_from_spec", "uninstall_plan",
    "RetryExhausted", "RetryPolicy", "classify", "with_retry",
]
