"""Several processes (the reference's multi-node ``mpiexec`` tier; the JAX
package's ``parallel/multihost.py`` on ``torch.distributed``).

The JAX package scales past one host with its multi-controller runtime: one
Python process per host, ``jax.distributed.initialize`` (the ``MPI_Init``
analog) and a mesh over every host's chips.  Here the process group is
``torch.distributed``'s: ``gloo`` on the CPU, ``nccl`` between cards.  The
helpers keep the JAX contracts (``process_info`` / ``barrier`` /
``broadcast_scalar``), each a no-op in a single process, so a launch is:

    from parallel_convolution_tpu_torch.parallel import multihost
    multihost.initialize("localhost:29500", num_processes=2, process_id=rank)

Nothing tells a program of a cluster: the caller gives the address, the
process count and its rank (or the ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK`` environment of ``torchrun``).  A grid whose slots
span processes is ROADMAP item 10c: ``mesh.make_grid(devices="all")``
raises ``NotImplementedError`` naming it in a job of several processes
(:func:`process_count`, which makes no collective call).
"""

from __future__ import annotations

import os

import torch


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """``MPI_Init``: join the process group.  A no-op when single-process
    (``num_processes`` <= 1, or none given and no ``WORLD_SIZE`` above 1
    in the environment) and when the group already exists.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` / ``env://``
    URL); ``backend`` defaults to ``gloo`` without CUDA and ``nccl``
    with it.
    """
    import torch.distributed as dist

    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or _dist() is not None:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend or ("nccl" if torch.cuda.is_available() else "gloo"),
        init_method=url, world_size=int(num_processes), rank=int(process_id))


def process_count() -> int:
    """The processes of the job (1 without a group); no collective."""
    dist = _dist()
    return 1 if dist is None else dist.get_world_size()


def _local_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def process_info() -> dict:
    """This process's index, the process count, and the devices this
    process and the whole job have (cards, or 1 for the CPU)."""
    dist = _dist()
    local = _local_devices()
    if dist is None:
        return {"process_index": 0, "process_count": 1,
                "local_devices": local, "global_devices": local}
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local)
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_devices": local, "global_devices": sum(counts)}


def barrier(name: str = "pctpu_barrier") -> None:
    """Cross-process sync point (the ``MPI_Barrier`` before and after
    timing).  ``name`` is the JAX contract's label; the group's barrier
    has none."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return
    dist.barrier()


def broadcast_scalar(value: float) -> float:
    """Agree on one host-side scalar across processes (rank 0 wins)."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return value
    dev = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.broadcast(t, src=0)
    return float(t.item())
