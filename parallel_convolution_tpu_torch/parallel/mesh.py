"""The block grid of the PyTorch port (the JAX package's ``parallel/mesh.py``:
``make_grid_mesh`` / ``mesh_from_spec``).

The JAX package maps an R×C grid of blocks onto an R×C mesh of devices, one
device per block.  The port has two forms of :class:`Grid`:

* one device: the grid shape plus the device every block lives on (one
  card, or the CPU);
* a grid of **slots** (``devices``): one slot per block, row-major, each
  naming the torch device its block lives on.  Slots may repeat a device:
  on the CPU every slot is ``cpu``, on one card every slot is ``cuda:0``,
  over several cards the slots go round-robin.  Code written per slot has
  one allocation per block, and for ``cuda_rdma`` one stream and one
  launch per slot behind a barrier between slots (``ops/rdma.py``), so a
  grid of slots on one card runs what separate cards run, and over several
  cards it runs across them.

A grid of slots may span the processes of a job (``make_grid(devices=
"all")`` with several processes, ``parallel/multihost.py``): ``owners``
names the rank that owns each slot, row-major, each rank owning an equal
share, and ``rank`` is this process's.  Each process holds only its own
blocks; the others' entries in a list of blocks are ``None``
(:func:`local_blocks` walks what this process holds).  A grid made from
another's first slots (a multigrid level's sub-grid) keeps their owners,
so a rank may hold none of its blocks.  Under gloo a rank's slots go
round-robin over its host's cards (two ranks may share one); one card a
process (an NCCL group) puts every slot of rank r on its own card,
``cuda:LOCAL_RANK``.

The image state is an R×C list of lists of ``(C, h, w)`` block tensors,
each on its slot's device.  Axis convention as in the JAX package: grid
rows split H, grid columns split W.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from parallel_convolution_tpu_torch.utils.platform import resolve_device


def dims_create(n: int) -> tuple[int, int]:
    """Near-square factorization of ``n`` — the MPI_Dims_create contract.

    Returns (R, C) with R*C == n and R <= C, R as close to sqrt(n) as the
    factorization allows: the default grid over the cards (``make_grid(
    devices="all")``), as the JAX package's default mesh over its devices.
    """
    if n < 1:
        raise ValueError("need at least one device")
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def padded_extent(total: int, parts: int) -> int:
    """Smallest multiple of ``parts`` ≥ ``total`` (blocks are equal-sized;
    the rim beyond the image is padded and re-masked to zero)."""
    return -(-total // parts) * parts


@dataclasses.dataclass(frozen=True)
class Grid:
    """An R×C grid of blocks: all on ``device``, or with ``devices`` one
    slot per block (row-major; a device may repeat), ``device`` then being
    slot 0's (the device results are gathered on).  ``owners`` (a grid of
    slots over several processes) is the rank owning each slot and
    ``rank`` this process's; ``device`` is then this process's first
    slot's."""

    rows: int = 1
    cols: int = 1
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    devices: tuple[torch.device, ...] | None = None
    owners: tuple[int, ...] | None = None
    rank: int = 0

    def __post_init__(self) -> None:
        if self.rows < 1 or self.cols < 1:
            raise ValueError(f"grid shape must be positive, got "
                             f"{(self.rows, self.cols)}")
        if self.devices is None:
            object.__setattr__(self, "device", torch.device(self.device))
            return
        devs = tuple(torch.device(d) for d in self.devices)
        if len(devs) != self.rows * self.cols:
            raise ValueError(f"a {self.rows}x{self.cols} grid needs "
                             f"{self.rows * self.cols} slots, got {len(devs)}")
        if len({d.type for d in devs}) != 1:
            raise ValueError("the slots of one grid are all cpu or all cuda, "
                             f"got {[str(d) for d in devs]}")
        object.__setattr__(self, "devices", devs)
        if self.owners is None:
            object.__setattr__(self, "device", devs[0])
            return
        owners = tuple(int(o) for o in self.owners)
        if len(owners) != len(devs) or min(owners) < 0 or self.rank < 0:
            raise ValueError(f"owners {owners} do not give each of the "
                             f"{len(devs)} slots a rank")
        object.__setattr__(self, "owners", owners)
        if self.rank in owners:
            mine = devs[owners.index(self.rank)]
        elif devs[0].type == "cuda" and torch.cuda.is_available():
            mine = torch.device("cuda", torch.cuda.current_device())
        else:
            mine = devs[0]
        object.__setattr__(self, "device", mine)

    @property
    def shape(self) -> tuple[int, int]:
        return self.rows, self.cols

    @property
    def slotted(self) -> bool:
        """Whether every block has a slot of its own (``devices``)."""
        return self.devices is not None

    @property
    def slots(self) -> tuple[torch.device, ...]:
        """The device of every block, row-major."""
        if self.devices is not None:
            return self.devices
        return (self.device,) * (self.rows * self.cols)

    def slot_device(self, i: int, j: int) -> torch.device:
        return self.slots[i * self.cols + j]

    def slot_map(self) -> str:
        """The slots as ``--device`` takes them (a comma list)."""
        return ",".join(str(d) for d in self.slots)

    @property
    def spans_processes(self) -> bool:
        """Whether the slots belong to more than one process."""
        return self.owners is not None and len(set(self.owners)) > 1

    @property
    def local_devices(self) -> tuple[torch.device, ...]:
        """The distinct devices of the slots this process holds, in slot
        order (every slot's in one process): what it synchronizes, never
        another rank's card."""
        return tuple(dict.fromkeys(
            d for k, d in enumerate(self.slots)
            if self.owners is None or self.owners[k] == self.rank))

    def is_local(self, i: int, j: int) -> bool:
        """Whether this process holds block (i, j)."""
        return self.owners is None or (
            self.owners[i * self.cols + j] == self.rank)


def _slot_device(spec) -> torch.device:
    """One slot's device: ``cpu`` or an existing card; a card the machine
    does not have raises (a slot is never mapped elsewhere)."""
    dev = torch.device(spec)
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.index is None:
            dev = resolve_device(dev)
        if not 0 <= dev.index < n:
            raise RuntimeError(f"slot {str(spec)!r} names a card this "
                               f"machine does not have ({n} visible)")
        return dev
    return resolve_device(dev)


def make_grid(shape: tuple[int, int] | None = None, device=None,
              devices=None) -> Grid:
    """A grid of ``shape`` on ``device`` (default: the card; raises without
    CUDA unless ``device='cpu'``), as today's one-device grid.

    ``devices`` makes a grid of slots: a list of R·C devices (row-major,
    repeats allowed), or ``"all"``: round-robin over
    ``torch.cuda.device_count()`` cards, or every slot ``cpu`` when
    ``device='cpu'``.  The default shape is then ``dims_create`` of the
    slot count (of the cards for ``"all"``).  ``"all"`` in a job of
    several processes spans them: each rank owns an equal row-major share
    of the slots, round-robin over its own cards (or ``cpu``), and holds
    only its blocks (:func:`_process_grid`).
    """
    if devices is None:
        r, c = shape if shape is not None else (1, 1)
        return Grid(int(r), int(c), resolve_device(device))
    if isinstance(devices, str) and devices == "all":
        from parallel_convolution_tpu_torch.parallel import multihost

        if multihost.process_count() > 1:
            return _process_grid(shape, device)
        if device is not None and torch.device(device).type == "cpu":
            r, c = shape if shape is not None else (1, 1)
            return Grid(int(r), int(c), devices=("cpu",) * (int(r) * int(c)))
        resolve_device(device)  # raises without CUDA
        n = torch.cuda.device_count()
        r, c = shape if shape is not None else dims_create(n)
        return Grid(int(r), int(c), devices=tuple(
            torch.device("cuda", k % n) for k in range(int(r) * int(c))))
    if isinstance(devices, str):
        devices = [d for d in devices.split(",") if d.strip()]
    devs = tuple(_slot_device(d.strip() if isinstance(d, str) else d)
                 for d in devices)
    if device is not None and resolve_device(device) != devs[0]:
        raise ValueError(f"device={device!r} is not slot 0's {devs[0]}")
    r, c = shape if shape is not None else dims_create(len(devs))
    return Grid(int(r), int(c), devices=devs)


def _process_grid(shape, device) -> Grid:
    """``devices="all"`` in a job of ``n`` processes: R·C slots (default
    ``dims_create`` of every process's devices), rank ``r`` owning slots
    ``[r·k, (r+1)·k)`` with ``k = R·C / n`` (every slot ``cpu`` with
    ``device='cpu'``).  Under gloo a rank's slots go round-robin over its
    host's cards from ``cuda:0``, and the halo slabs between ranks travel
    through host memory; one card a process (NCCL) puts them all on the
    rank's own card (``multihost.card``; the default shape is then
    ``dims_create(n)``), and the slabs stay on the cards.  ``cuda_rdma``
    reads a neighbour on another rank of the host in place through CUDA
    IPC, on its card or another, and one on another host from a mirror
    (``ops/rdma.py``)."""
    from parallel_convolution_tpu_torch.parallel import multihost

    info = multihost.process_info()
    n, rank = info["process_count"], info["process_index"]
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        resolve_device(device)  # raises without CUDA
    r, c = shape if shape is not None else dims_create(
        info["global_devices"] if not cpu else n)
    if cpu:
        devs = [torch.device("cpu")]
    elif multihost.one_card_a_process():
        cards = multihost.gather_object(multihost.card().index)
        devs = {q: torch.device("cuda", i) for q, i in enumerate(cards)}
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return _spread(int(r), int(c), range(n), devs, rank)


def _spread(r: int, c: int, ranks, devs, rank: int) -> Grid:
    """An r×c grid of slots over ``ranks`` (in order), each owning an
    equal row-major share.  ``devs`` is a list, which a rank's ``k``
    slots go round-robin over (on one host every rank sees the same
    list), or a dict naming each rank's one device (one card a
    process)."""
    ranks = list(ranks)
    n = len(ranks)
    if (r * c) % n:
        raise ValueError(f"a {r}x{c} grid does not split into equal shares "
                         f"of {n} processes")
    k = r * c // n
    owners = tuple(ranks[s // k] for s in range(r * c))
    if isinstance(devs, dict):
        slots = tuple(devs[o] for o in owners)
    else:
        slots = tuple(devs[(s % k) % len(devs)] for s in range(r * c))
    return Grid(r, c, devices=slots, owners=owners, rank=rank)


def grid_from_spec(spec: str | None, device=None) -> Grid:
    """The grid the CLI's ``--mesh RxC`` and ``--device`` flags name.
    ``--mesh`` None/empty falls back to the supervisor's reshape env
    (``PCTPU_MESH``, ``resilience.elastic.MESH_ENV``), as the JAX
    package's ``mesh_from_spec`` does, and then to 1×1, or
    ``dims_create`` of the slots.  ``--device`` is ``cpu`` / ``cuda[:N]``
    (one device), ``all`` (a slot per block, round-robin over the cards)
    or a comma list of R·C slots."""
    if not spec:
        import os

        from parallel_convolution_tpu_torch.resilience.elastic import MESH_ENV

        spec = os.environ.get(MESH_ENV)
    shape = None
    if spec:
        try:
            shape = tuple(int(v) for v in spec.lower().split("x"))
            if len(shape) != 2:
                raise ValueError
        except ValueError as e:
            raise ValueError(f"grid spec must be RxC, got {spec!r}") from e
    if isinstance(device, str) and (device == "all" or "," in device):
        return make_grid(shape, devices=device)
    return make_grid(shape, device)


def grid_like(grid: Grid, shape: tuple[int, int]) -> Grid:
    """A grid of ``shape`` in ``grid``'s form: the one-device form on its
    device, a slot per block round-robin over the grid's distinct devices
    in their order (one process), or over the processes of ``grid`` in
    ``_process_grid``'s layout (each rank an equal share, round-robin over
    the devices its slots name, or on its own card where each rank has
    one): what a model's grid becomes when it is swapped by an ``"RxC"``
    spec (``ConvolutionModel.set_grid``)."""
    r, c = (int(v) for v in shape)
    if not grid.slotted:
        return Grid(r, c, grid.device)
    devs = list(dict.fromkeys(grid.slots))
    if grid.owners is not None:
        from parallel_convolution_tpu_torch.parallel import multihost

        own = (dict(zip(grid.owners, grid.slots))
               if multihost.one_card_a_process() else devs)
        return _spread(r, c, sorted(set(grid.owners)), own, grid.rank)
    return Grid(r, c, devices=tuple(devs[k % len(devs)]
                                    for k in range(r * c)))


def local_grid(grid: Grid) -> Grid:
    """This process's share of a grid over several processes as a grid of
    its own (no owners): its slots in order, as whole rows of ``grid``
    where the share is, else one row.  What each rank probes alone
    (``resilience.degrade``)."""
    mine = [d for d, o in zip(grid.slots, grid.owners) if o == grid.rank]
    k = len(mine)
    rows = k // grid.cols if k % grid.cols == 0 else 1
    return Grid(rows, k // rows, devices=tuple(mine))


def split_blocks(x: torch.Tensor, grid: Grid) -> list[list[torch.Tensor]]:
    """Cut a (C, R*h, C*w) tensor into the grid's R×C contiguous blocks,
    each on its slot's device (``None`` where another process holds
    it)."""
    R, Cc = grid.shape
    _, Hp, Wp = x.shape
    if Hp % R or Wp % Cc:
        raise ValueError(f"extent {(Hp, Wp)} not divisible by grid {(R, Cc)}")
    bh, bw = Hp // R, Wp // Cc
    if not grid.slotted:
        return [[x[:, i * bh:(i + 1) * bh, j * bw:(j + 1) * bw].contiguous()
                 for j in range(Cc)] for i in range(R)]
    # One allocation per block, even where slots share a device.
    return [[x[:, i * bh:(i + 1) * bh, j * bw:(j + 1) * bw].to(
                grid.slot_device(i, j), copy=True,
                memory_format=torch.contiguous_format)
             if grid.is_local(i, j) else None
             for j in range(Cc)] for i in range(R)]


def join_blocks(blocks: list[list[torch.Tensor]], device=None) -> torch.Tensor:
    """Inverse of :func:`split_blocks`, gathered on ``device`` (default: the
    first block's)."""
    dev = blocks[0][0].device if device is None else torch.device(device)
    return torch.cat([torch.cat([b.to(dev) for b in row], dim=2)
                      for row in blocks], dim=1)


def local_blocks(blocks):
    """``((i, j), block)`` for every block this process holds (a grid over
    several processes leaves the others' entries ``None``)."""
    for i, row in enumerate(blocks):
        for j, b in enumerate(row):
            if b is not None:
                yield (i, j), b


def spans(grid: Grid | None, blocks) -> bool:
    """Whether ``blocks`` are this process's share of ``grid``, a grid
    over several processes (``grid.spans_processes``).  Blocks with
    another process's holes (``None``) and no such grid raise: the caller
    must pass the grid the blocks belong to."""
    if grid is not None and grid.spans_processes:
        return True
    if any(b is None for row in blocks for b in row):
        raise ValueError("blocks that another process holds (None) need "
                         "the grid over the processes (grid=)")
    return False


def first_block(blocks, default=StopIteration) -> torch.Tensor:
    """The first block this process holds (its shape and dtype are every
    block's); ``default`` where it holds none (a sub-grid of another's
    first slots), else ``StopIteration`` raises."""
    for _, b in local_blocks(blocks):
        return b
    if default is StopIteration:
        raise StopIteration("this process holds none of the blocks")
    return default


def reblock(blocks, valid_hw, grid: Grid, block_hw, src_grid: Grid | None = None,
            src_hw=None, like=None) -> list[list[torch.Tensor]]:
    """Move the blocks of one grid onto ``(grid, block_hw)`` by the
    reshard rule (crop to the valid extent, re-pad, re-block), each target
    block assembled on its slot's device from the source blocks it
    overlaps, its rim beyond ``valid_hw`` zero: no device ever holds more
    than its own block and one piece of a source block.  The source
    blocks are any equal-sized R'×C' grid of (C, h', w') blocks.

    Over several processes: ``src_grid`` is the grid the source blocks
    belong to (its ``owners``; None: this process holds every block it
    is given, as every rank holds a field it was given whole), and
    ``grid``'s owners say which rank assembles each target block.  A
    piece whose source lives on another rank arrives point to point
    (``multihost.swap``: every receive posted first), never through a
    gathered image; a rank builds only its own target blocks (``None``
    elsewhere).  ``src_hw`` / ``like`` = (channels, dtype) describe the
    source blocks where this rank holds none of them."""
    H, W = (int(v) for v in valid_hw)
    mine = first_block(blocks, None)
    if mine is not None:
        src_hw = tuple(mine.shape[1:]) if src_hw is None else src_hw
        like = (mine.shape[0], mine.dtype) if like is None else like
    sbh, sbw = (int(v) for v in src_hw)
    C, dtype = like
    bh, bw = (int(v) for v in block_hw)
    rank = grid.rank
    cols = len(blocks[0])

    def src_owner(si, sj, owner):
        if src_grid is None or src_grid.owners is None:
            return owner  # every rank holds the source
        return src_grid.owners[si * cols + sj]

    out = [[None] * grid.cols for _ in range(grid.rows)]
    sends, recvs, landed = [], [], []
    for i in range(grid.rows):
        for j in range(grid.cols):
            here = grid.is_local(i, j)
            dev = grid.slot_device(i, j)
            b = (torch.zeros((C, bh, bw), dtype=dtype, device=dev)
                 if here else None)
            r0, c0 = i * bh, j * bw
            r1, c1 = min(r0 + bh, H), min(c0 + bw, W)
            owner = grid.owners[i * grid.cols + j] if grid.owners else rank
            for si in range(r0 // sbh, -(-r1 // sbh)) if r1 > r0 else ():
                for sj in range(c0 // sbw, -(-c1 // sbw)) if c1 > c0 else ():
                    g0, g1 = max(r0, si * sbh), min(r1, (si + 1) * sbh)
                    h0, h1 = max(c0, sj * sbw), min(c1, (sj + 1) * sbw)
                    dst = (slice(None), slice(g0 - r0, g1 - r0),
                           slice(h0 - c0, h1 - c0))
                    src = (slice(None), slice(g0 - si * sbh, g1 - si * sbh),
                           slice(h0 - sj * sbw, h1 - sj * sbw))
                    holder = src_owner(si, sj, owner)
                    tag = (i * grid.cols + j) * len(blocks) * cols + (
                        si * cols + sj)
                    if here and holder == rank:
                        b[dst] = blocks[si][sj][src].to(dev)
                    elif here:
                        piece = torch.empty((C, g1 - g0, h1 - h0),
                                            dtype=dtype, device=dev)
                        recvs.append((holder, tag, piece))
                        landed.append((b, dst, piece))
                    elif holder == rank:
                        sends.append((owner, tag, blocks[si][sj][src]))
            out[i][j] = b
    if sends or recvs:
        from parallel_convolution_tpu_torch.parallel import multihost

        multihost.swap(sends, recvs)
        for b, dst, piece in landed:
            b[dst] = piece
    return out
