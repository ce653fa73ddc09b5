"""Serving layer of the PyTorch port (the JAX package's ``serving/``): the
in-process core that runs kernels.

``engine.py``   the warm engine: a cache of built runners keyed on the
                full build identity (shape, filter, storage, iters, fuse,
                grid, backend, ...), LRU eviction, startup warmup, per-key
                single flight, the degrade walk per key, the converge
                stream (Jacobi and multigrid, resumable), volumes, and
                ``reshape`` onto another grid mid-process.
``batcher.py``  the bounded request queue with shape-bucketed lanes and
                continuous batching: same-lane requests coalesce onto the
                leading axis, flushed on size or deadline.

The service with its admission control, the HTTP frontend, the binary
frames, durable jobs, the result cache and pricing are ROADMAP item 8a-ii;
the fleet (router, write-ahead log, peers, autoscaler, chaos transport)
is item 8b.  Their names raise ``NotImplementedError`` naming the item.
"""

from parallel_convolution_tpu_torch.serving.batcher import MicroBatcher, Slot
from parallel_convolution_tpu_torch.serving.engine import (
    EngineKey, WarmEngine, bucket_extent, bucket_key,
)
from parallel_convolution_tpu_torch.utils.config import (
    FLEET_ITEM, SERVICE_ITEM, pending,
)

__all__ = ["EngineKey", "MicroBatcher", "Slot", "WarmEngine",
           "bucket_extent", "bucket_key"]

# The JAX package's serving names that later slices port.
_PENDING = {
    **dict.fromkeys(("ConvolutionService", "Rejected", "Request", "Response",
                     "Snapshot", "WorkPricer", "JobLedger", "InProcessClient",
                     "make_http_server"), SERVICE_ITEM),
    **dict.fromkeys(("AutoScaler", "ChaosTransport", "CorruptReplicaBody",
                     "HTTPReplica", "InProcessReplica", "ReplicaRouter",
                     "TenantQuotas"), FLEET_ITEM),
}


def __getattr__(name: str):
    if name in _PENDING:
        raise pending(f"serving.{name}", _PENDING[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
