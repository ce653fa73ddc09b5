"""Shared harness pieces for the chaos drills.

``python -m parallel_convolution_tpu_torch.soak --chaos`` (randomized
cycles), its ``--router-restart`` and ``--shard-kill`` drills and
``serving.chaos_matrix`` drive the same pool shape and contract; these
helpers keep them from drifting:
the converge-job wire body, the three-replica chaos pool (one replica
per failure shape), the clean-router oracle run, and the client
retry-with-backoff loop every drill's traffic uses.
"""

from __future__ import annotations

import time

# One replica per failure shape: c0 drops (send + recv), c1 corrupts
# response bodies, c2 injects send latency.
CHAOS_POOL_MODES = (None,
                    {"transport_recv": "corrupt"},
                    {"transport_send": "latency"})


def converge_body(b64: str, rows: int, cols: int, rid: str,
                  tenant: str | None = None, **kw) -> dict:
    """The drills' canonical convergence-job wire body (jacobi3 to a
    fixed 40-iteration budget unless overridden)."""
    body = {"image_b64": b64, "rows": int(rows), "cols": int(cols),
            "mode": "grey", "filter": "jacobi3", "backend": "shifted",
            "quantize": False, "tol": 0.0, "max_iters": 40,
            "check_every": 10, "request_id": rid}
    if tenant is not None:
        body["tenant"] = tenant
    body.update(kw)
    return body


def chaos_pool(factory, seed: int, latency_s: float = 0.02):
    """Three in-process replicas c0/c1/c2, each wrapped in a
    ChaosTransport with its own failure shape (CHAOS_POOL_MODES)."""
    from parallel_convolution_tpu_torch.serving.chaos import ChaosTransport
    from parallel_convolution_tpu_torch.serving.router import InProcessReplica

    return [ChaosTransport(InProcessReplica(factory, name=f"c{i}"),
                           modes=m, seed=seed + i, latency_s=latency_s)
            for i, m in enumerate(CHAOS_POOL_MODES)]


def oracle_converge_final(factory, body: dict) -> dict:
    """The uninterrupted oracle run: one clean replica behind a plain
    router; returns the final row (raises if the job did not finish)."""
    from parallel_convolution_tpu_torch.serving.router import (
        InProcessReplica, ReplicaRouter,
    )

    router = ReplicaRouter([InProcessReplica(factory, name="clean")],
                           start_health=False)
    try:
        _, rows = router.converge(dict(body))
        final = list(rows)[-1]
    finally:
        router.close()
    if final.get("kind") != "final":
        raise RuntimeError(f"oracle converge failed: {final}")
    return final


def request_with_backoff(router, body: dict, attempts: int = 6,
                         cap_s: float = 0.3) -> dict:
    """One batch request through the router, honoring typed RETRYABLE
    rejections with capped backoff (the loadgen client contract)."""
    wire: dict = {}
    for _ in range(attempts):
        _, wire = router.request(dict(body))
        if wire.get("ok") or not wire.get("retryable"):
            break
        time.sleep(min(float(wire.get("retry_after_s") or 0.05), cap_s))
    return wire
