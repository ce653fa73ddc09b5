"""The router's write-ahead log in the port (``serving/wal.py``, ROADMAP
item 8b-i) held against the JAX package's on the CPU.

The WAL is stdlib only in both packages, so the same seeded operations
go through both and the files, records and folded states must be equal:

* the record codec is the JAX package's byte for byte (``<crc32-hex>
  <compact-json>``), and each side parses the other's typed failures the
  same way;
* a journal written by the JAX ``RouterWAL`` replays in the port to the
  same ``WALState``, and the reverse, across rotation (the head
  snapshot);
* torn tails, byte flips, a cut older generation, quarantine, the
  takeover rotation and the fence of the old writer give the same typed
  outcomes;
* the repaired ``diskio`` consults: ``PCTPU_FAULTS`` at ``wal_write`` /
  ``wal_fsync`` in every ``PCTPU_DISK_MODES`` mode (and with no mode)
  raises or tears as the JAX ``guarded_*`` does on the same seed, and the
  failed append heals its tail.

Tolerance: bytes and JSON records equal.
"""

from __future__ import annotations

import base64
import errno
import types

import numpy as np
import pytest

from parallel_convolution_tpu.resilience import diskio as jdiskio
from parallel_convolution_tpu.resilience import faults as jfaults
from parallel_convolution_tpu.serving import wal as jwal
from parallel_convolution_tpu_torch.resilience import diskio, faults
from parallel_convolution_tpu_torch.serving import wal

PORT = types.SimpleNamespace(name="port", wal=wal, faults=faults,
                             diskio=diskio)
JAX = types.SimpleNamespace(name="jax", wal=jwal, faults=jfaults,
                            diskio=jdiskio)
SIDES = [PORT, JAX]


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    for side in SIDES:
        side.faults.uninstall_plan()
        side.diskio.uninstall_modes()


def _records(n_jobs: int = 6) -> list[tuple[str, dict]]:
    """The seeded append sequence of the JAX package's ``_fill_wal``: every
    record kind, enough bytes to rotate a 4096-byte segment."""
    out = [("epoch", {"epoch": 3}), ("ring_add", {"name": "r0"}),
           ("ring_add", {"name": "r1"})]
    for i in range(n_jobs):
        lid = f"t\x1fjob{i}"
        out += [("admit", {"lid": lid, "key": f"k{i}", "cost": 0.5,
                           "budget": 40.0, "wu_start": 0.0}),
                ("token", {"lid": lid, "key": f"k{i}", "token": {
                    "iters": 10 * (i + 1), "diff": 0.5,
                    "work_units": 10.0 * (i + 1), "solver": "jacobi",
                    "state_b64": base64.b64encode(b"\0" * 600).decode(),
                    "state_shape": [1, 10, 15]}}),
                ("debt", {"tenant": "t", "delta": 0.5,
                          "level": 10.0 - 0.5 * i}),
                ("resume", {"lid": lid, "key": f"k{i}",
                            "from_replica": "r1"})]
    out += [("final", {"lid": "t\x1fjob0"}),
            ("job_settled", {"lid": "t\x1fjob1"}),
            ("cache", {"op": "dead", "ckey": "c1"}),
            ("cache", {"op": "live", "ckey": "c1"}),
            ("cache", {"op": "dead", "ckey": "c2"}),
            ("ring_remove", {"name": "r1"})]
    return out


def _fill(side, path, max_bytes=4096, keep=2):
    w = side.wal.RouterWAL(path, max_bytes=max_bytes, keep=keep,
                           fsync=False)
    for kind, fields in _records():
        w.append(kind, **fields)
    return w


def _files(d) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if not p.name.endswith(".lock")}


def _replay(side, path) -> dict:
    records, torn = side.wal.read_wal(path)
    st = side.wal.WALState()
    for rec in records:
        st.apply(rec)
    return {"records": records, "torn": torn is not None,
            "state": st.to_wire()}


def _outcome(side, path):
    """What a reader makes of the lineage: the replay, or the typed
    cause of its corruption."""
    try:
        return _replay(side, path)
    except side.wal.WALCorrupt as e:
        return {"corrupt": e.cause, "line": e.line_no}


# ---------------------------------------------------------------- codec
@pytest.mark.parametrize("kind,fields", _records(2),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_record_bytes_equal_jax(kind, fields):
    rec = {"seq": 7, "kind": kind, **fields}
    line = wal.encode_record(rec)
    assert line == jwal.encode_record(rec)
    assert wal.parse_line(line.rstrip("\n")) == jwal.parse_line(
        line.rstrip("\n")) == rec


@pytest.mark.parametrize("line", [
    "nope", "zzzzzzzz {}", "00000000 {}", "6d4d3e5a {\"a\":1",
    "2d5e38d6 [1,2]"])
def test_parse_failures_typed_as_jax(line):
    causes = []
    for side in SIDES:
        with pytest.raises(ValueError) as e:
            side.wal.parse_line(line)
        causes.append(str(e.value).split(":", 1)[0])
    assert causes[0] == causes[1]


# ----------------------------------------------------- replay each way
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_journal_replays_across_packages(tmp_path, writer, reader):
    """The same appends make the same files (rotated generations and
    their head snapshot included), and a writer's journal replays in the
    other package to the writer's own folded state."""
    dirs = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        _fill(side, d / "r.wal").close()
        dirs[side.name] = d
    assert _files(dirs["port"]) == _files(dirs["jax"])
    assert (dirs["port"] / "r.wal.1").exists()
    path = dirs[writer.name] / "r.wal"
    live = _replay(writer, path)
    assert _replay(reader, path) == live
    # Opening the lineage in the other package is the takeover: the same
    # recovered state and report, and the same rotated files.
    w = reader.wal.RouterWAL(path, fsync=False)
    assert w.state.to_wire() == live["state"]
    assert w.recovery_report == {"records": len(live["records"]),
                                 "torn_tail": None, "quarantined": None}
    w.close()


def test_takeover_fences_the_old_writer_in_both(tmp_path):
    got = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        w1 = _fill(side, d / "r.wal")
        w2 = side.wal.RouterWAL(d / "r.wal", fsync=False)
        with pytest.raises(side.wal.WALFenced):
            w1.append("epoch", epoch=99)
        w2.append("epoch", epoch=4)
        got[side.name] = (w2.snapshot()["seq"], w2.state.to_wire(),
                          _files(d))
        w1.close()
        w2.close()
    assert got["port"] == got["jax"]


# ----------------------------------------------------- damage, typed
@pytest.mark.parametrize("seed", range(6))
def test_truncation_gives_the_same_prefix(tmp_path, seed):
    base = tmp_path / "base"
    base.mkdir()
    _fill(JAX, base / "r.wal").close()
    data = (base / "r.wal").read_bytes()
    cut = int(np.random.default_rng(seed).integers(1, len(data) - 1))
    (base / "r.wal").write_bytes(data[:cut])
    port, jax_ = _outcome(PORT, base / "r.wal"), _outcome(JAX, base / "r.wal")
    assert port == jax_
    assert "corrupt" not in port


@pytest.mark.parametrize("gen", ["r.wal", "r.wal.1"])
@pytest.mark.parametrize("seed", range(5))
def test_byte_flip_gives_the_same_typed_outcome(tmp_path, gen, seed):
    base = tmp_path / "base"
    base.mkdir()
    _fill(JAX, base / "r.wal").close()
    target = base / gen
    data = target.read_bytes()
    off = int(np.random.default_rng(100 + seed).integers(0, len(data) - 1))
    target.write_bytes(data[:off] + bytes([data[off] ^ 0x55])
                       + data[off + 1:])
    assert _outcome(PORT, base / "r.wal") == _outcome(JAX, base / "r.wal")


def test_cut_older_generation_and_quarantine_as_jax(tmp_path):
    """A rotated generation cut short is mid-log damage: both readers call
    it the same cause, and opening the lineage quarantines the same files
    and reports the same, starting empty."""
    got = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        _fill(side, d / "r.wal").close()
        gen1 = d / "r.wal.1"
        gen1.write_bytes(gen1.read_bytes()[:len(gen1.read_bytes()) // 2])
        out = _outcome(side, d / "r.wal")
        with pytest.warns(RuntimeWarning, match="quarantined"):
            w = side.wal.RouterWAL(d / "r.wal", fsync=False)
        rep = dict(w.recovery_report)
        rep.pop("detail")
        got[side.name] = (out, rep, w.state.to_wire(), sorted(_files(d)))
        w.close()
    assert got["port"] == got["jax"]
    assert got["port"][1]["quarantined"] in {"crc", "json", "format",
                                             "seq_gap", "unknown_kind"}


def test_torn_tail_tolerated_and_amputated_as_jax(tmp_path):
    got = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        _fill(side, d / "r.wal").close()
        live = d / "r.wal"
        live.write_bytes(live.read_bytes()[:-7])
        with pytest.warns(RuntimeWarning, match="torn tail"):
            w = side.wal.RouterWAL(live, fsync=False)
        rep = dict(w.recovery_report)
        w.append("epoch", epoch=9)
        got[side.name] = (rep, w.state.to_wire(), _files(d))
        w.close()
    assert got["port"] == got["jax"]
    assert got["port"][0]["torn_tail"]


# ------------------------------------------- diskio at the WAL's sites
MODES = [("wal_write", m) for m in jdiskio.DISK_SITES["wal_write"]] + [
    ("wal_fsync", m) for m in jdiskio.DISK_SITES["wal_fsync"]] + [
    ("wal_write", None), ("wal_fsync", None)]


def test_diskio_consults_the_wal_sites():
    assert {"wal_write", "wal_fsync"} <= set(diskio._CONSULTS)
    assert set(diskio._CONSULTS) == set(jdiskio._CONSULTS)
    assert diskio.DISK_SITES == jdiskio.DISK_SITES


@pytest.mark.parametrize("site,mode", MODES,
                         ids=[f"{s}-{m}" for s, m in MODES])
def test_wal_fault_modes_behave_as_jax(tmp_path, site, mode):
    """A seeded ``PCTPU_FAULTS`` plan hits the WAL's second append at
    ``site``: the same exception (type, errno), the same injection count,
    and the same file afterwards (a torn write's partial bytes healed
    away, so the next append lands on a record boundary)."""
    got = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        side.faults.install_plan(f"{site}:2")
        side.diskio.install_modes({site: mode} if mode else None)
        # The injection counts are per process (other tests add theirs).
        counts0 = side.diskio.injected_counts()
        w = side.wal.RouterWAL(d / "r.wal", fsync=site == "wal_fsync")
        outcomes = []
        for kind, fields in _records(1):
            try:
                w.append(kind, **fields)
                outcomes.append("ok")
            except side.faults.InjectedFault:
                outcomes.append("injected")
            except OSError as e:
                outcomes.append(errno.errorcode.get(e.errno, e.errno))
        counts = {k: v - counts0.get(k, 0)
                  for k, v in side.diskio.injected_counts().items()
                  if v != counts0.get(k, 0)}
        got[side.name] = (outcomes, w.tail_heals, w.records_written, counts,
                          _replay(side, d / "r.wal"), _files(d))
        w.close()
        side.faults.uninstall_plan()
        side.diskio.uninstall_modes()
    assert got["port"] == got["jax"]
    want = {None: "injected", "enospc": "ENOSPC", "eio": "EIO",
            "torn_write": "EIO", "slow_write": "ok"}[mode]
    assert got["port"][0][1] == want
    # A failed write never lands (fsync failures do: written, not durable).
    assert got["port"][2] == len(_records(1)) - (
        want != "ok" and site == "wal_write")
