"""Checkpoint / resume for long runs (the PyTorch port of the JAX package's
``utils/checkpoint.py``).

Every K iterations the grid's blocks are snapshotted **per block** (no
gather: each block becomes one ``.npy`` keyed by its grid coordinates),
with a JSON sidecar recording progress and config.  A restarted run
validates the sidecar against its own config and continues from the
saved iteration.  In u8 mode every iteration ends quantized to exact
integers, and float-mode blocks are saved as raw float32, so save/restore
is lossless and the checkpointed run is bit-identical to an uninterrupted
one.

The on-disk format is the JAX package's, byte for byte:
``it_<NNNNNNNN>/shard_<r>_<c>.npy`` written by ``np.save`` of the block as
a C-contiguous (C, h, w) array, ``meta.json`` with each shard's CRC32 and
length, and the ``LATEST`` pointer, flipped last.  The resume config is
the same too (filter, quantize, backend, fuse, boundary, valid_hw; the
grid is left out), so a snapshot written by one package resumes in the
other wherever the backend names agree (``shifted``, ``xla_conv``,
``separable``); a kernel backend is named differently in the two
(``pallas`` here is ``cuda``) and its snapshot is refused with the config
mismatch.  NumPy has no bfloat16, so a snapshot holds f32 or u8 blocks.

Snapshots are verifiable: each shard is written atomically (tmp +
rename), its CRC32 and length recorded in the meta; loading checks them
and raises :class:`CheckpointCorrupt` on a torn snapshot, and
``load_state(..., fallback=True)`` — the default inside
:func:`run_checkpointed` — quarantines it (a :class:`CheckpointWarning`
naming the snapshot, the shard and the cause) and walks back to the newest
snapshot that validates.  Snapshots are grid-agnostic: one written on an
R×C grid loads onto any other, each target block assembled from the
source shards it overlaps (memmap windows), its pad rim re-derived.
Fault sites ``checkpoint_write_shard`` / ``checkpoint_write_meta`` (through
``resilience.diskio``) and ``io_read`` let tests kill a save between any
two writes.

On a grid of slots each block is saved from and loaded onto its slot's
device.  On a grid over several processes each rank writes only its own
shards, each under a temporary name of its own; the shards' CRCs are
gathered to rank 0, which alone writes ``meta.json`` (every shard listed,
the single-process format) and then flips ``LATEST``, each after a
barrier; a resume loads on each rank only its own blocks.  Every writer's
temporary names are its own (the JAX package's ``meta.json.tmp`` and
``LATEST.tmp`` are shared by every process, which races).

Each save, load, reshard and quarantine is observed (``obs``): the
``pctpu_checkpoint_seconds{op}`` histogram, ``pctpu_checkpoint_bytes_total
{op}`` (the shard files' bytes: the ones this process wrote for a save,
the snapshot's for a load) and the ``checkpoint_save`` /
``checkpoint_load`` / ``checkpoint_reshard`` / ``quarantine`` events;
every rank of a job emits its own.
"""

from __future__ import annotations

import io
import json
import os
import time
import warnings
import zlib
from pathlib import Path

import numpy as np
import torch

from parallel_convolution_tpu_torch.obs import (
    events as obs_events, metrics as obs_metrics,
)
from parallel_convolution_tpu_torch.parallel import multihost
from parallel_convolution_tpu_torch.parallel.mesh import (
    Grid, first_block, local_blocks, padded_extent, spans,
)
from parallel_convolution_tpu_torch.resilience import diskio
from parallel_convolution_tpu_torch.resilience.faults import (
    InjectedFault, fault_point,
)

__all__ = ["KEEP_SNAPSHOTS", "LATEST_NAME", "META_NAME", "CheckpointCorrupt",
           "CheckpointWarning", "load_meta", "load_state", "run_checkpointed",
           "save_state"]



def _note_ckpt(op: str, wall_s: float, nbytes: int, **fields) -> None:
    """One checkpoint op's telemetry: the duration histogram, the byte
    counter and the ``checkpoint_<op>`` event.  One branch when obs is
    off."""
    if not obs_metrics.enabled():
        return
    obs_metrics.histogram(
        "pctpu_checkpoint_seconds", "checkpoint operation wall time",
        ("op",)).observe(wall_s, op=op)
    obs_metrics.counter(
        "pctpu_checkpoint_bytes_total", "checkpoint bytes written/read",
        ("op",)).inc(nbytes, op=op)
    obs_events.emit(f"checkpoint_{op}", wall_s=round(wall_s, 6),
                    bytes=int(nbytes), **fields)


def _note_quarantine(snap_name: str, problems) -> None:
    if not obs_metrics.enabled():
        return
    c = obs_metrics.counter(
        "pctpu_quarantines_total",
        "shard validation failures by cause (missing/truncated/...)",
        ("cause",))
    for cause, _shard in problems:
        c.inc(cause=cause)
    obs_events.emit("quarantine", snap=snap_name,
                    problems=[[c_, s] for c_, s in problems][:16])


META_NAME = "meta.json"
LATEST_NAME = "LATEST"
KEEP_SNAPSHOTS = 2


class CheckpointCorrupt(RuntimeError):
    """A snapshot's meta exists but its shard set is incomplete/damaged.

    ``snap`` names the snapshot directory; ``problems`` is the per-shard
    diagnosis — ``(cause, shard_name)`` pairs with cause one of
    ``missing | truncated | checksum | unreadable | torn-meta``.
    """

    def __init__(self, msg: str, snap: str = "",
                 problems: tuple = ()):  # (cause, shard) pairs
        super().__init__(msg)
        self.snap = snap
        self.problems = tuple(problems)


class CheckpointWarning(UserWarning):
    """A corrupt snapshot was quarantined (skipped in favor of an older or
    fresh state), or a snapshot was resharded onto a different grid."""


def _snap_dir(ckpt_dir, iters_done: int) -> Path:
    return Path(ckpt_dir) / f"it_{int(iters_done):08d}"


def _latest_snap(ckpt_dir) -> Path | None:
    p = Path(ckpt_dir) / LATEST_NAME
    if not p.exists():
        return None
    try:
        snap = Path(ckpt_dir) / p.read_text().strip()
    except OSError:  # pointer pruned/replaced mid-read
        return None
    return snap if (snap / META_NAME).exists() else None


def _candidate_snaps(ckpt_dir) -> list[Path]:
    """Snapshots to try, newest-claim first: the LATEST pointer's target,
    then every other ``it_*`` dir with a meta, newest iteration first.
    Entries that vanish between the listing and the check drop out."""
    d = Path(ckpt_dir)
    first = _latest_snap(d)
    out = [first] if first is not None else []
    rest: list[Path] = []
    try:
        for p in d.iterdir():
            try:
                if (p.is_dir() and p.name.startswith("it_")
                        and (p / META_NAME).exists()):
                    rest.append(p)
            except OSError:
                continue  # entry pruned mid-check
    except OSError:
        pass  # ckpt dir itself missing/unreadable: only LATEST's claim
    rest.sort(key=lambda p: p.name, reverse=True)
    out += [p for p in rest if first is None or p.name != first.name]
    return out


def _read_meta(snap: Path) -> dict:
    """Parse a snapshot's meta; unreadable/invalid JSON raises
    :class:`CheckpointCorrupt` with cause ``torn-meta``."""
    try:
        return json.loads((snap / META_NAME).read_text())
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(
            f"snapshot {snap.name} is torn: unreadable meta ({e})",
            snap=snap.name, problems=(("torn-meta", META_NAME),),
        ) from e


def _expected_shards(meta: dict) -> list[str]:
    g0, g1 = meta["grid"]
    return [f"shard_{r}_{c}.npy" for r in range(g0) for c in range(g1)]


def _validate_snapshot(snap: Path, meta: dict) -> None:
    """Raise :class:`CheckpointCorrupt` unless every expected shard file is
    present and matches its recorded CRC32/length (a shard without a CRC
    record degrades to a header parse).  An I/O failure mid-read
    (``io_read``) counts as ``unreadable``: it quarantines the snapshot
    rather than killing the recovery walk."""
    problems: list[tuple[str, str]] = []   # (cause, shard)
    notes: list[str] = []
    recorded = meta.get("shards", {})
    for name in _expected_shards(meta):
        p = snap / name
        if not p.exists():
            problems.append(("missing", name))
            notes.append(f"missing {name}")
            continue
        rec = recorded.get(name)
        if rec is not None:
            # Stream the CRC in chunks, never a whole-file read.
            crc, n = 0, 0
            try:
                fault_point("io_read")  # one consult per shard validation
                with open(p, "rb") as f:
                    while chunk := f.read(1 << 20):
                        crc = zlib.crc32(chunk, crc)
                        n += len(chunk)
            except (OSError, InjectedFault) as e:
                problems.append(("unreadable", name))
                notes.append(f"unreadable {name} ({e})")
                continue
            if n != rec["bytes"]:
                problems.append(("truncated", name))
                notes.append(f"truncated {name} ({n} != {rec['bytes']} bytes)")
            elif crc != rec["crc32"]:
                problems.append(("checksum", name))
                notes.append(f"checksum mismatch in {name}")
        else:
            try:
                np.load(p, mmap_mode="r")
            except Exception:
                problems.append(("unreadable", name))
                notes.append(f"unreadable {name} (no CRC recorded)")
    if problems:
        raise CheckpointCorrupt(
            f"snapshot {snap.name} is torn: {'; '.join(notes[:8])}"
            + (f" (+{len(notes) - 8} more)" if len(notes) > 8 else ""),
            snap=snap.name, problems=problems,
        )


def _host_block(block: torch.Tensor) -> np.ndarray:
    """A block as the C-contiguous NumPy array its shard file holds."""
    if block.dtype == torch.bfloat16:
        raise ValueError("snapshots hold f32 or u8 blocks: NumPy, the shard "
                         "format, has no bfloat16")
    return np.ascontiguousarray(block.detach().cpu().numpy())


def _own_tmp(path: Path) -> Path:
    """A temporary name beside ``path`` that no other writer uses: the
    rank and the process id in it."""
    return path.with_name(f"{path.name}.{multihost.rank()}.{os.getpid()}"
                          ".tmp")


def save_state(ckpt_dir, blocks, meta: dict,
               grid: Grid | None = None) -> None:
    """Snapshot the grid's padded blocks + metadata.

    ``blocks`` is the R×C list of (C, h, w) blocks (the ``cuda_rdma``
    carry is unstacked at ``iterate_prepared``'s return).  On a ``grid``
    over several processes they are ``None`` where another rank holds a
    block: every rank calls this with the grid, writes its own shards, and
    rank 0 writes the meta and the pointer.  Crash-safe by construction:
    each snapshot is its own ``it_<NNNNNNNN>/`` directory, every shard is serialized in memory
    first and written atomically (a temporary name of the writer's own,
    then a rename) with its CRC32 recorded, meta is written last inside
    the directory, after every shard of every rank (a barrier), and the
    ``LATEST`` pointer flips atomically only after the snapshot is
    complete (another barrier).  Older snapshots beyond KEEP_SNAPSHOTS are
    pruned.

    Fault sites: ``checkpoint_write_shard`` before each shard write;
    ``checkpoint_write_meta`` twice — before the meta write and before the
    LATEST flip.
    """
    t_save0 = time.perf_counter()
    shared = spans(grid, blocks)
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    snap = _snap_dir(d, meta["iters_done"])
    snap.mkdir(exist_ok=True)
    shards: dict[str, dict] = {}
    for (r, c), block in local_blocks(blocks):
        name = f"shard_{r}_{c}.npy"
        buf = io.BytesIO()
        np.save(buf, _host_block(block))
        raw = buf.getvalue()
        diskio.consult("checkpoint_write_shard")
        tmp = _own_tmp(snap / name)
        tmp.write_bytes(raw)
        os.replace(tmp, snap / name)
        shards[name] = {"crc32": zlib.crc32(raw), "bytes": len(raw)}
    # This process's shards: on a grid over several processes each rank
    # emits its own save event with the bytes it wrote.
    own = len(shards), sum(v["bytes"] for v in shards.values())
    if shared:
        # Every rank's shards are on disk once the records are gathered.
        for part in multihost.gather_object(shards):
            shards.update(part)
        shards = dict(sorted(shards.items(), key=lambda kv: _shard_rc(
            kv[0])))
    lead = not shared or grid.rank == 0
    if lead:
        meta = dict(meta, shards=shards)
        diskio.consult("checkpoint_write_meta")
        tmp = _own_tmp(snap / META_NAME)
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, snap / META_NAME)
    if shared:
        multihost.barrier("checkpoint-meta")
    if lead:
        diskio.consult("checkpoint_write_meta")
        ptr_tmp = _own_tmp(d / LATEST_NAME)
        ptr_tmp.write_text(snap.name)
        os.replace(ptr_tmp, d / LATEST_NAME)
        _prune(d)
    if shared:
        multihost.barrier("checkpoint-latest")
    _note_ckpt("save", time.perf_counter() - t_save0, own[1],
               snap=snap.name, iters_done=int(meta["iters_done"]),
               shards=own[0])


def _shard_rc(name: str) -> tuple[int, int]:
    """(r, c) of ``shard_<r>_<c>.npy``."""
    r, c = name[len("shard_"):-len(".npy")].split("_")
    return int(r), int(c)


def _prune(d: Path) -> None:
    """Remove the snapshots beyond the newest KEEP_SNAPSHOTS."""
    try:
        snaps = sorted(p for p in d.iterdir()
                       if p.is_dir() and p.name.startswith("it_"))
    except OSError:
        snaps = []
    for old in snaps[:-KEEP_SNAPSHOTS]:
        try:
            entries = list(old.iterdir())
        except OSError:
            continue  # dir already pruned
        for f in entries:
            try:
                f.unlink()
            except OSError:
                pass
        try:
            old.rmdir()
        except OSError:
            pass


def load_meta(ckpt_dir) -> dict | None:
    """The LATEST snapshot's meta, unvalidated (shards may still be torn —
    use :func:`load_state` for validated loading)."""
    snap = _latest_snap(ckpt_dir)
    if snap is None:
        return None
    return _read_meta(snap)


def _valid_hw_of(meta: dict) -> tuple[int, int]:
    """The snapshot's valid (unpadded) image extent; a meta without
    ``valid_hw`` falls back to the saved padded extent."""
    vh = meta.get("valid_hw")
    if vh:
        return int(vh[0]), int(vh[1])
    return int(meta["shape"][1]), int(meta["shape"][2])


def _reshard_block(snap: Path, meta: dict, target_shape, index,
                   block_hw) -> np.ndarray:
    """Target block ``index`` = (i, j) of ``block_hw`` on another grid,
    assembled from the source shards it overlaps (memmap windows — never a
    full-file read); its pad rim is zero.  The source's own pad rim is
    never read: positions outside the valid image are zero on both grids
    by the masking invariant, so resharding preserves bytes exactly."""
    src_grid = tuple(meta["grid"])
    src_shape = tuple(meta["shape"])
    sbh = src_shape[1] // src_grid[0]
    sbw = src_shape[2] // src_grid[1]
    H, W = _valid_hw_of(meta)
    C = target_shape[0]
    dtype = np.load(snap / "shard_0_0.npy", mmap_mode="r").dtype
    r0, c0 = index[0] * block_hw[0], index[1] * block_hw[1]
    r1, c1 = r0 + block_hw[0], c0 + block_hw[1]
    out = np.zeros((C, r1 - r0, c1 - c0), dtype)
    vr1, vc1 = min(r1, H), min(c1, W)  # only in-image pixels exist
    if vr1 <= r0 or vc1 <= c0:
        return out  # the target block lies entirely in the new pad rim
    for sr in range(r0 // sbh, (vr1 - 1) // sbh + 1):
        for sc in range(c0 // sbw, (vc1 - 1) // sbw + 1):
            blk = np.load(snap / f"shard_{sr}_{sc}.npy", mmap_mode="r")
            gr0, gr1 = max(r0, sr * sbh), min(vr1, (sr + 1) * sbh)
            gc0, gc1 = max(c0, sc * sbw), min(vc1, (sc + 1) * sbw)
            out[:, gr0 - r0:gr1 - r0, gc0 - c0:gc1 - c0] = (
                blk[:, gr0 - sr * sbh:gr1 - sr * sbh,
                    gc0 - sc * sbw:gc1 - sc * sbw])
    return out


def load_state(ckpt_dir, grid: Grid,
               fallback: bool = False) -> tuple[list[list[torch.Tensor]], dict]:
    """Restore the snapshot's blocks onto ``grid`` — ANY grid shape, one
    device or slots — each on its slot's device (on a grid over several
    processes only this rank's, the others ``None``).

    Validates completeness and every shard's CRC32 first; a torn snapshot
    raises :class:`CheckpointCorrupt` — unless ``fallback=True``: then it
    is quarantined (a :class:`CheckpointWarning`) and the walk continues
    to the newest OLDER snapshot that validates.  Returns ``(blocks,
    meta)`` of the snapshot actually loaded.  On another grid than the
    snapshot's, each block is assembled from the shards it overlaps, and
    ``meta['resharded_from']`` records the source grid.
    """
    t_load0 = time.perf_counter()
    candidates = _candidate_snaps(ckpt_dir)
    if not candidates:
        raise FileNotFoundError(f"no checkpoint at {ckpt_dir}")
    shape_rc = grid.shape
    last_err: CheckpointCorrupt | None = None
    for snap in candidates:
        try:
            meta = _read_meta(snap)
            _validate_snapshot(snap, meta)
        except CheckpointCorrupt as e:
            _note_quarantine(e.snap or snap.name, e.problems)
            if not fallback:
                raise
            warnings.warn(
                f"quarantined torn snapshot {e.snap or snap.name}: {e}",
                CheckpointWarning, stacklevel=2)
            last_err = e
            continue
        src_grid = tuple(meta["grid"])
        if src_grid == shape_rc:
            blocks = [[torch.from_numpy(np.load(snap / f"shard_{r}_{c}.npy"))
                       .to(grid.slot_device(r, c)) if grid.is_local(r, c)
                       else None for c in range(shape_rc[1])]
                      for r in range(shape_rc[0])]
        else:
            H, W = _valid_hw_of(meta)
            shape = (int(meta["shape"][0]), padded_extent(H, shape_rc[0]),
                     padded_extent(W, shape_rc[1]))
            block_hw = (shape[1] // shape_rc[0], shape[2] // shape_rc[1])
            blocks = [[torch.from_numpy(_reshard_block(
                snap, meta, shape, (r, c), block_hw)).to(
                    grid.slot_device(r, c)) if grid.is_local(r, c) else None
                for c in range(shape_rc[1])] for r in range(shape_rc[0])]
            meta = dict(meta, resharded_from=list(src_grid),
                        grid=list(shape_rc), shape=list(shape))
            warnings.warn(
                f"resharding snapshot {snap.name} from grid "
                f"{src_grid[0]}x{src_grid[1]} onto "
                f"{shape_rc[0]}x{shape_rc[1]}",
                CheckpointWarning, stacklevel=2)
        nbytes = sum(v.get("bytes", 0)
                     for v in meta.get("shards", {}).values())
        _note_ckpt("load" if src_grid == shape_rc else "reshard",
                   time.perf_counter() - t_load0, nbytes, snap=snap.name,
                   iters_done=int(meta.get("iters_done", 0)),
                   grid=f"{shape_rc[0]}x{shape_rc[1]}",
                   **({"resharded_from": f"{src_grid[0]}x{src_grid[1]}"}
                      if src_grid != shape_rc else {}))
        return blocks, meta
    raise CheckpointCorrupt(
        f"no valid snapshot in {ckpt_dir}: every candidate is torn "
        f"(last: {last_err})"
    )


def run_checkpointed(blocks, filt, total_iters: int, grid: Grid, valid_hw,
                     ckpt_dir, every: int, quantize: bool = True,
                     backend: str = "shifted", fuse: int = 1,
                     boundary: str = "zero", tile=None,
                     interior_split: bool = False, fallback: bool = False,
                     overlap: bool | None = None,
                     col_mode: str | None = None,
                     run_backend: str | None = None):
    """Iterate with a snapshot every ``every`` iterations; auto-resume.

    If ``ckpt_dir`` holds a compatible checkpoint, continues from its
    iteration count (``blocks`` may then be None).  Returns the padded
    blocks after ``total_iters`` total iterations.

    Resume is resilient: a torn LATEST snapshot falls back to the newest
    valid one, and if *no* snapshot validates the run restarts from
    ``blocks`` with a :class:`CheckpointWarning` — never from corrupt
    bytes.  The grid may differ from the one that wrote the checkpoint:
    the snapshot reshards and the bytes stay identical.  ``fallback`` is
    the *backend* degradation knob of ``step.iterate_prepared``, resolved
    once, before the first chunk, at the real blocks; every chunk runs the
    tier it picked.  ``run_backend`` is that tier when the caller resolved
    it already (the CLI, which labels its summary with it); the snapshot
    config records the requested ``backend`` either way.  On a grid of
    slots every chunk runs per slot; on a grid over several processes
    every rank calls this with its own blocks (``None`` elsewhere), saves
    its own shards and resumes its own blocks.
    """
    from parallel_convolution_tpu_torch.parallel import step as step_lib

    # Resume-compatibility config; the grid is not part of it.
    config = {
        "filter": filt.name,
        "quantize": quantize,
        "backend": backend,
        "fuse": fuse,
        "boundary": boundary,
        "valid_hw": list(valid_hw),
    }
    # Gate on the config FIRST (one small JSON read): a mismatch must not
    # cost shard validation and a load before raising.
    try:
        meta0 = load_meta(ckpt_dir)
    except CheckpointCorrupt:
        meta0 = None  # torn meta: the validated walk below handles it
    if meta0 is not None:
        saved_cfg = {k: meta0.get(k) for k in config}
        if saved_cfg != config:
            raise ValueError(
                f"checkpoint config mismatch: {saved_cfg} != {config}"
            )
    meta = None
    try:
        loaded, meta = load_state(ckpt_dir, grid, fallback=True)
    except FileNotFoundError:
        pass
    except CheckpointCorrupt as e:
        warnings.warn(
            f"no usable checkpoint in {ckpt_dir} ({e}); starting fresh",
            CheckpointWarning, stacklevel=2)
    done = 0
    if meta is not None:
        # Re-check against the snapshot actually loaded: with no LATEST
        # pointer yet (a first-save crash) the gate above never ran.
        saved_cfg = {k: meta.get(k) for k in config}
        if saved_cfg != config:
            raise ValueError(
                f"checkpoint config mismatch: {saved_cfg} != {config}"
            )
        blocks = loaded
        done = int(meta["iters_done"])
    if blocks is None:
        raise ValueError("no checkpoint found and no initial state given")
    # The quantize-range contract once, on the entry state; chunk inputs
    # are prior chunk outputs, in contract by induction.
    step_lib._check_quantize_contract(blocks, filt, quantize, grid)
    C, bh, bw = first_block(blocks).shape
    if run_backend is None:
        run_backend = backend
        if fallback and done < total_iters:
            run_backend = step_lib._resolve_fallback(
                grid, filt, backend, quantize,
                min(fuse, every, total_iters - done), boundary, tile,
                step_lib._storage_name(first_block(blocks).dtype), (bh, bw),
                interior_split)
    while done < total_iters:
        chunk = min(every, total_iters - done)
        # tile is a pure performance knob (the same bytes for any value),
        # so it is not part of the config; fuse is: it is bit-identical
        # only in quantize mode.
        blocks = step_lib.iterate_prepared(
            blocks, filt, chunk, grid, valid_hw,
            interior_split=interior_split, quantize=quantize,
            backend=run_backend, fuse=min(fuse, chunk), boundary=boundary,
            tile=tile, check_contract=False,
            overlap=overlap, col_mode=col_mode,
        )
        done += chunk
        if done < total_iters:  # the final state is the caller's to persist
            save_state(
                ckpt_dir, blocks,
                {**config, "grid": list(grid.shape), "iters_done": done,
                 "shape": [C, grid.rows * bh, grid.cols * bw]},
                grid,
            )
    return blocks
