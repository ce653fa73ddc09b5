"""Serving layer of the PyTorch port (the JAX package's ``serving/``): one
replica's service over the card.

``engine.py``   the warm engine: a cache of built runners keyed on the
                full build identity (shape, filter, storage, iters, fuse,
                grid, backend, ...), LRU eviction, startup warmup, per-key
                single flight, the degrade walk per key, the converge
                stream (Jacobi and multigrid, resumable), volumes, and
                ``reshape`` onto another grid mid-process.
``batcher.py``  the bounded request queue with shape-bucketed lanes and
                continuous batching: same-lane requests coalesce onto the
                leading axis, flushed on size or deadline.
``service.py``  admission control (queue bound, deadlines, typed
                rejections), dedup by ``request_id``, the router-epoch
                fences, ``reshape``, ``warmup``, readiness, the progressive
                converge stream and the volume arm.
``cache.py``    the content-addressed result cache (memory LRU, a CRC'd
                disk spill tier, journaled deaths).
``pricing.py``  predicted device-seconds a request (the batcher's lane
                priority), on the port's cost model.
``jobs.py``     the resume-token ledger of converge jobs.
``frames.py``   the binary tensor-frame wire.
``frontend.py`` ``InProcessClient`` and the stdlib HTTP server (both
                wires, NDJSON and framed streams).
``serve.py``    ``python -m parallel_convolution_tpu_torch.serving.serve``.
``router.py``   the fleet's front tier: a consistent-hash router over N
                replicas (in process or over HTTP) with bounded-load
                spill, breakers, hedging, failover of idempotent work,
                tenant token buckets, durable converge streams that
                resume mid-stream, and its own HTTP server.
``wal.py``      the router's write-ahead log (CRC'd records, rotation
                with a head snapshot, torn-tail tolerance, quarantine):
                fencing epochs and exactly-once finals across a crash.
``chaos.py``    the chaos transport: seeded network-shaped failures at
                the ``PCTPU_FAULTS`` transport sites.
``route.py``    ``python -m parallel_convolution_tpu_torch.serving.route``
                (the router over in-process or HTTP replicas).
``loadgen.py``  ``python -m parallel_convolution_tpu_torch.serving.loadgen``
                (closed / open-loop load, one summary row; ``--shardmap``
                routes to a sharded fleet's owners).
``peers.py``    the sharded control plane: N active routers, each owning
                its shards' WAL lineages, peer anti-entropy, fenced
                takeover of a dead peer's shards, the shard-aware client.
``autoscaler.py`` the control loop that grows and shrinks the replica
                pool, pre-warming a joining replica's ring shard.
``chaos_matrix.py`` ``python -m parallel_convolution_tpu_torch.serving.
                chaos_matrix`` (every storage fault mode crossed with
                every workload shape).
"""

from parallel_convolution_tpu_torch.serving import autoscaler, peers
from parallel_convolution_tpu_torch.serving.autoscaler import AutoScaler
from parallel_convolution_tpu_torch.serving.batcher import MicroBatcher, Slot
from parallel_convolution_tpu_torch.serving.chaos import ChaosTransport
from parallel_convolution_tpu_torch.serving.engine import (
    EngineKey, WarmEngine, bucket_extent, bucket_key,
)
from parallel_convolution_tpu_torch.serving.frontend import (
    InProcessClient, make_http_server,
)
from parallel_convolution_tpu_torch.serving.jobs import JobLedger
from parallel_convolution_tpu_torch.serving.pricing import WorkPricer
from parallel_convolution_tpu_torch.serving.router import (
    CorruptReplicaBody, HTTPReplica, InProcessReplica, ReplicaRouter,
    TenantQuotas,
)
from parallel_convolution_tpu_torch.serving.service import (
    ConvolutionService, Rejected, Request, Response, Snapshot,
)

__all__ = ["AutoScaler", "ChaosTransport", "ConvolutionService",
           "CorruptReplicaBody", "EngineKey", "HTTPReplica",
           "InProcessClient", "InProcessReplica", "JobLedger",
           "MicroBatcher", "Rejected", "ReplicaRouter", "Request",
           "Response", "Slot", "Snapshot", "TenantQuotas", "WarmEngine",
           "WorkPricer", "bucket_extent", "bucket_key", "make_http_server"]
