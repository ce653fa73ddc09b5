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
``WORLD_SIZE`` / ``RANK`` environment of ``torchrun``).

In a job of several processes ``mesh.make_grid(devices="all")`` spans
them: each rank owns an equal share of the slots and holds only its
blocks.  What crosses ranks goes through this module and host memory, the
transport gloo carries (two ranks on one card share it; NCCL refuses
that): the halo slabs and the pieces of a re-blocked grid (:func:`swap`,
point to point), the convergence diff (:func:`all_max`), a block another
rank holds (:func:`fill_blocks`) and small objects (:func:`gather_object`,
:func:`peer_records`: the CUDA IPC handles through which ``cuda_rdma``
reads a neighbour's buffer in place where the ranks share a host, and the
hosts, :func:`hosts_of`, which say where it reads a mirror instead).  A
job across hosts is launched the same way on every host, each rank given
the one coordinator's address.  The NCCL transport (one card a process)
and ``cuda_rdma`` between cards of one host are ROADMAP item 10d-ii-b.
"""

from __future__ import annotations

import os
import socket

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
    URL); ``backend`` defaults to ``nccl`` where every process can have a
    card of its own (at least ``num_processes`` visible), else ``gloo``:
    without CUDA, and whenever two ranks share a card, which NCCL refuses.
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
    if backend is None:
        own_card = (torch.cuda.is_available()
                    and torch.cuda.device_count() >= int(num_processes))
        backend = "nccl" if own_card else "gloo"
    dist.init_process_group(
        backend,
        init_method=url, world_size=int(num_processes), rank=int(process_id))


def process_count() -> int:
    """The processes of the job (1 without a group); no collective."""
    dist = _dist()
    return 1 if dist is None else dist.get_world_size()


def rank() -> int:
    """This process's rank (0 without a group); no collective."""
    dist = _dist()
    return 0 if dist is None else dist.get_rank()


def backend() -> str | None:
    """The group's backend name, None without a group."""
    dist = _dist()
    return None if dist is None else str(dist.get_backend())


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


def gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order, on every rank (``[obj]``
    without a group)."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def hostname() -> str:
    """This host's name, as :func:`peer_records` reports it."""
    return socket.gethostname()


def card_uuid(device) -> str:
    """The card's UUID (``""`` for the CPU): two ranks on one card see one
    UUID whatever index each gives it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return ""
    return str(torch.cuda.get_device_properties(dev).uuid)


def peer_records(record: dict) -> list[dict]:
    """Every rank's small record (CUDA IPC handles, offsets), in rank
    order, on every rank, each with its rank's ``host``
    (:func:`hostname`) added: one ``gather_object``.  A collective: every
    rank of the group calls it at the same point."""
    return gather_object(dict(record, host=hostname()))


def hosts_of(records) -> list[str]:
    """The host of each rank of :func:`peer_records`' result, in rank
    order: ``cuda_rdma`` reads a neighbour on this host in place (CUDA
    IPC) and one on another host from a mirror that gloo fills."""
    return [r["host"] for r in records]


def portable(err: BaseException) -> BaseException:
    """``err`` as another rank can unpickle it: itself where it
    round-trips, else a ``RuntimeError`` with its type and text (an
    exception whose constructor takes other arguments than its message
    does not)."""
    import pickle

    try:
        pickle.loads(pickle.dumps(err))
        return err
    except Exception:  # noqa: BLE001 -- any failure to round-trip
        return RuntimeError(f"{type(err).__name__}: {err}")


def agreed(fn):
    """``fn()`` on rank 0, its result (or the exception it raised) on
    every rank: one ``gather_object``.  Every rank calls it at the same
    point; the others never call ``fn``."""
    out = err = None
    if rank() == 0:
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 -- raised on every rank
            err = e
    out, shared = gather_object((out, err and portable(err)))[0]
    if shared is not None:
        raise err if err is not None else shared
    return out


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The max over ranks of a 0-d tensor, as a 0-d f32 host tensor, NaN
    if any rank's is NaN: gloo's MAX need not carry a NaN, so a NaN flag
    is reduced beside the value (NaN taken as -inf there), in one call.
    The copy to the host is the caller's one readback."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return x
    v = x.detach().to("cpu", torch.float64).reshape(())
    nan = bool(torch.isnan(v))
    buf = torch.tensor([float("-inf") if nan else float(v), float(nan)],
                       dtype=torch.float64)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return torch.tensor(float("nan") if buf[1] > 0 else float(buf[0]),
                        dtype=torch.float32)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, flat, in host memory (pinned for a card's)."""
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    if flat.device.type == "cpu":
        return flat
    host = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(flat)
    return host


def _host_buffer(nbytes: int, device) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")


class HostStaging:
    """Host buffers a caller keeps for every round of :func:`swap`,
    allocated once and pinned where there is a card: a pinned allocation
    a round would cost more than the slabs it carries."""

    def __init__(self):
        self._bufs: dict = {}

    def buffer(self, key, nbytes: int) -> torch.Tensor:
        """The flat uint8 buffer named ``key``, ``nbytes`` long (grown,
        never shrunk, when a later round asks for more)."""
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[key] = torch.empty(
                nbytes, dtype=torch.uint8,
                pin_memory=torch.cuda.is_available())
        return buf[:nbytes]


def swap(sends, recvs) -> None:
    """One round of point-to-point slabs between ranks.  ``sends`` are
    ``(rank, tag, tensor)``; ``recvs`` are ``(rank, tag, out)``, each
    ``out`` a tensor (any device) the slab is written into.  Every receive
    is posted before any send, all of them non-blocking, and the round
    ends when all have completed, so no ring of ranks deadlocks; a card's
    slab is staged through pinned host memory (gloo's point-to-point calls
    take host tensors), and a contiguous host ``out`` (a
    :class:`HostStaging` buffer) is received into in place.  Tags name
    the receiving slab, so one round may carry several slabs between the
    same two ranks."""
    dist = _dist()
    landing, reqs = [], []
    for src, tag, out in recvs:
        if out.device.type == "cpu" and out.is_contiguous():
            buf = out.reshape(-1).view(torch.uint8)
        else:
            buf = _host_buffer(out.numel() * out.element_size(), out.device)
            landing.append((buf, out))
        reqs.append(dist.irecv(buf, src=int(src), tag=int(tag)))
    staged = [(dst, tag, _to_host(t)) for dst, tag, t in sends]
    for dst, tag, buf in staged:
        reqs.append(dist.isend(buf, dst=int(dst), tag=int(tag)))
    for req in reqs:
        req.wait()
    for buf, out in landing:
        out.copy_(buf.view(out.dtype).view(out.shape))


def fill_blocks(blocks, owners) -> list:
    """The R×C blocks with every entry filled: each block is broadcast from
    the rank that holds it (``owners``, row-major) through host memory,
    and lands on the device of this process's first block (a grid over
    several processes: every rank calls this)."""
    dist = _dist()
    mine = next(b for row in blocks for b in row if b is not None)
    cols = len(blocks[0])
    out = [list(row) for row in blocks]
    for k, owner in enumerate(owners):
        i, j = divmod(k, cols)
        buf = (_to_host(out[i][j]) if out[i][j] is not None
               else _host_buffer(mine.numel() * mine.element_size(),
                                 mine.device))
        dist.broadcast(buf, src=int(owner))
        if out[i][j] is None:
            out[i][j] = buf.view(mine.dtype).view(mine.shape).to(
                mine.device)
    return out
