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
blocks.  What crosses ranks goes through this module: the halo slabs and
the pieces of a re-blocked grid (:func:`swap`, point to point), the
convergence diff (:func:`all_max`), a block another rank holds
(:func:`fill_blocks`) and small objects (:func:`gather_object`,
:func:`peer_records`: the CUDA IPC handles through which ``cuda_rdma``
reads a neighbour's buffer in place where the ranks share a host, and the
hosts, :func:`hosts_of`, which say where it reads a mirror instead).  A
job across hosts is launched the same way on every host, each rank given
the one coordinator's address.

The transport (:func:`transport`) is decided here, once:

* ``"host"`` (gloo): the slabs travel through host memory, pinned where
  they come from a card.  Two ranks may share one card, which NCCL
  refuses.
* ``"device"`` (NCCL: one card a process, ``cuda:LOCAL_RANK``): the
  slabs stay on the card, sent and received as card tensors in one
  batched round.  NCCL matches a pair's messages by their order alone,
  so both sides order a pair's slabs by the receiving slab's tag
  (:func:`wire_order`).
"""

from __future__ import annotations

import datetime
import os
import socket

import torch

# NCCL matches point-to-point messages by order, not tag: a mismatched
# order hangs until the group's timeout, which is this (seconds).
NCCL_TIMEOUT_S = 300.0

# This process's card under NCCL (``cuda:LOCAL_RANK``), set by
# :func:`initialize`.
_LOCAL_RANK: int | None = None


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def host_processes(num_processes: int, env=None) -> int:
    """The processes of the job on this host: torchrun's
    ``LOCAL_WORLD_SIZE``, else ``num_processes`` (every rank on one host,
    as ``utils.multihost_job.spawn`` starts them)."""
    env = os.environ if env is None else env
    return int(env.get("LOCAL_WORLD_SIZE", num_processes))


def local_rank(process_id: int, num_processes: int, env=None) -> int:
    """This process's index among its host's: torchrun's ``LOCAL_RANK``,
    else the rank modulo :func:`host_processes`."""
    env = os.environ if env is None else env
    if "LOCAL_RANK" in env:
        return int(env["LOCAL_RANK"])
    return int(process_id) % host_processes(num_processes, env)


def default_backend(host_cards: int, host_processes: int) -> str:
    """``nccl`` where every process of this host can have a card of its
    own (at least as many cards as the host's processes), else ``gloo``:
    without a card, and whenever two ranks of a host would share one,
    which NCCL refuses.  The host's processes, not the job's: with
    ``torchrun --nnodes 2 --nproc-per-node 4`` on four-card hosts every
    rank has a card."""
    return "nccl" if 0 < int(host_processes) <= int(host_cards) else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """``MPI_Init``: join the process group.  A no-op when single-process
    (``num_processes`` <= 1, or none given and no ``WORLD_SIZE`` above 1
    in the environment) and when the group already exists.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` / ``env://``
    URL); ``backend`` defaults to :func:`default_backend` of this host's
    cards and processes.  Under ``nccl`` the process binds its card,
    ``cuda:LOCAL_RANK`` (:func:`local_rank`), for the group's life, the
    group times out after :data:`NCCL_TIMEOUT_S` (a send order that does
    not match hangs, where gloo's tags would not), and one collective
    runs at once, so that a later point-to-point round may involve only
    some of the ranks.
    """
    import torch.distributed as dist

    global _LOCAL_RANK
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
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = default_backend(cards, host_processes(num_processes))
    kw = {}
    if backend == "nccl":
        _LOCAL_RANK = local_rank(process_id, num_processes)
        card = torch.device("cuda", _LOCAL_RANK)
        torch.cuda.set_device(card)
        kw = dict(device_id=card,
                  timeout=datetime.timedelta(seconds=NCCL_TIMEOUT_S))
    dist.init_process_group(
        backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id), **kw)
    if backend == "nccl":
        barrier("group-made")


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


def transport() -> str:
    """How slabs cross ranks: ``"device"`` under NCCL, else ``"host"``."""
    return "device" if backend() == "nccl" else "host"


def one_card_a_process() -> bool:
    """Whether this job runs one card a process (an NCCL group)."""
    return backend() == "nccl"


def card() -> torch.device:
    """This process's card in an NCCL group: ``cuda:LOCAL_RANK`` as
    :func:`initialize` bound it, or the current card of a group made
    elsewhere."""
    if _LOCAL_RANK is not None:
        return torch.device("cuda", _LOCAL_RANK)
    if one_card_a_process() and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError("no NCCL group: this process has no card of its "
                       "own (multihost.initialize)")


def _local_devices() -> int:
    if one_card_a_process():
        return 1
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
    if one_card_a_process() and torch.cuda.is_available():
        dist.barrier(device_ids=[card().index])
    else:
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
    """The max over ranks of a 0-d tensor, as a 0-d f32 tensor, NaN if
    any rank's is NaN: gloo's MAX need not carry a NaN, so a NaN flag is
    reduced beside the value (NaN taken as -inf there), in one call.  On
    the host under the host transport (the copy there is the caller's one
    readback); under the device transport the pair is reduced on ``x``'s
    device and the result stays there, for the caller's one readback."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return x
    if transport() == "device":
        v = x.detach().to(torch.float64).reshape(())
        nan = torch.isnan(v)
        buf = torch.stack([torch.where(nan, float("-inf"), v),
                           nan.to(torch.float64)])
        dist.all_reduce(buf, op=dist.ReduceOp.MAX)
        return torch.where(buf[1] > 0, float("nan"), buf[0]).to(
            torch.float32)
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

    def _alloc(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=torch.cuda.is_available())

    def buffer(self, key, nbytes: int) -> torch.Tensor:
        """The flat uint8 buffer named ``key``, ``nbytes`` long (grown,
        never shrunk, when a later round asks for more)."""
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[key] = self._alloc(nbytes)
        return buf[:nbytes]


class DeviceStaging(HostStaging):
    """:class:`HostStaging`'s counterpart for the device transport: the
    buffers lie on ``device`` (this process's card), where NCCL sends and
    receives them."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)

    def _alloc(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, device=self.device)


def wire_order(items) -> list:
    """``(rank, tag, tensor)`` items in the order the device transport
    puts them on the wire: by peer rank, then by tag (the receiving
    slab's name).  A sender's list to a peer and the peer's receives
    from it sort alike, so NCCL, which matches a pair's messages by
    order alone, pairs each slab with its own receive."""
    return sorted(items, key=lambda it: (int(it[0]), int(it[1])))


def swap(sends, recvs) -> None:
    """One round of point-to-point slabs between ranks.  ``sends`` are
    ``(rank, tag, tensor)``; ``recvs`` are ``(rank, tag, out)``, each
    ``out`` a tensor the slab is written into.  Tags name the receiving
    slab, so one round may carry several slabs between the same two
    ranks.  The round ends when every slab has landed, so no ring of
    ranks deadlocks.

    * Host transport (gloo): every receive is posted before any send, all
      non-blocking; a card's slab is staged through pinned host memory
      (gloo's point-to-point calls take host tensors), and a contiguous
      host ``out`` (a :class:`HostStaging` buffer) is received into in
      place.
    * Device transport (NCCL): the tensors themselves, in one
      ``batch_isend_irecv`` in :func:`wire_order` with every tag 0; an
      ``out`` that is not contiguous lands in a buffer on its own device
      first.  The host does not wait: the caller's current stream is
      ordered after the round."""
    dist = _dist()
    if transport() == "device":
        _swap_device(dist, sends, recvs)
        return
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


def _swap_device(dist, sends, recvs) -> None:
    ops, landing = [], []
    for src, _, out in wire_order(recvs):
        buf = out if out.is_contiguous() else torch.empty(
            out.shape, dtype=out.dtype, device=out.device)
        if buf is not out:
            landing.append((buf, out))
        ops.append(dist.P2POp(dist.irecv, buf, int(src), tag=0))
    for dst, _, t in wire_order(sends):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), int(dst), tag=0))
    if not ops:
        return
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for buf, out in landing:
        out.copy_(buf)


def fill_blocks(blocks, owners) -> list:
    """The R×C blocks with every entry filled: each block is broadcast from
    the rank that holds it (``owners``, row-major) and lands on the device
    of this process's first block (a grid over several processes: every
    rank calls this).  Through host memory under the host transport; on
    the card itself under the device transport."""
    dist = _dist()
    mine = next(b for row in blocks for b in row if b is not None)
    cols = len(blocks[0])
    out = [list(row) for row in blocks]
    on_card = transport() == "device"
    for k, owner in enumerate(owners):
        i, j = divmod(k, cols)
        if on_card:
            buf = (out[i][j].contiguous() if out[i][j] is not None
                   else torch.empty(mine.shape, dtype=mine.dtype,
                                    device=mine.device))
        else:
            buf = (_to_host(out[i][j]) if out[i][j] is not None
                   else _host_buffer(mine.numel() * mine.element_size(),
                                     mine.device))
        dist.broadcast(buf, src=int(owner))
        if out[i][j] is None:
            out[i][j] = buf if on_card else buf.view(mine.dtype).view(
                mine.shape).to(mine.device)
    return out
