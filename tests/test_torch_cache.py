"""The result cache, the job ledger and the pricer of the port held against
the JAX package's on the CPU.

* ``input_digest``, ``result_key`` and ``converge_key`` equal JAX's for the
  same key (a kernel backend's JAX key renamed to the port's name);
* one scripted sequence of cache operations drives both ``ResultCache``
  classes in lockstep (memory LRU, the disk spill and promote, CRC
  corruption, adoption past tombstones, a torn ``cache_spill`` through
  ``PCTPU_DISK_MODES``, an ``eio`` promote, the demote / re-probe streak
  on a fake clock): the same journal, the same stats, the same answers,
  and the spill files byte for byte;
* the guarded writers of ``resilience.diskio`` behave as JAX's;
* ``JobLedger`` pin / evict / restore / finalize equal JAX's, and the
  tokens are JAX's wire;
* the pricer's floor, clamp, malformed-body price and hit price equal
  JAX's, and it orders the same bodies the same way.
"""

import dataclasses
import errno
from pathlib import Path

import jax
import numpy as np
import pytest

from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.resilience import diskio as jdiskio
from parallel_convolution_tpu.resilience import faults as jfaults
from parallel_convolution_tpu.serving import cache as jcache
from parallel_convolution_tpu.serving import engine as jengine
from parallel_convolution_tpu.serving import jobs as jjobs
from parallel_convolution_tpu.serving import pricing as jpricing
from parallel_convolution_tpu_torch.parallel import mesh
from parallel_convolution_tpu_torch.resilience import diskio, faults
from parallel_convolution_tpu_torch.serving import cache, engine, jobs, pricing
from parallel_convolution_tpu_torch.utils.config import BACKEND_FROM_REFERENCE

PORT = (cache, diskio, faults)
JAX = (jcache, jdiskio, jfaults)
JAX_NAME = {v: k for k, v in BACKEND_FROM_REFERENCE.items()}


@pytest.fixture(autouse=True)
def _clean_fault_state():
    yield
    for f, d in ((faults, diskio), (jfaults, jdiskio)):
        f.uninstall_plan()
        d.uninstall_modes()


def _arrays(i: int) -> dict:
    rng = np.random.default_rng(i)
    return {"image": rng.integers(0, 256, (6, 8), dtype=np.uint8),
            "state": rng.random((1, 6, 8), dtype=np.float32)}


# ---------------------------------------------------------------- keys
@pytest.mark.parametrize("arr", [
    np.arange(48, dtype=np.uint8).reshape(1, 6, 8),
    np.arange(48, dtype=np.uint8).reshape(6, 8, 1),
    np.arange(48, dtype=np.float32).reshape(1, 6, 8),
    np.asfortranarray(np.arange(48, dtype=np.float32).reshape(6, 8)),
    np.zeros((3, 0, 4), np.uint8),
])
def test_input_digest_equals_jax(arr):
    assert cache.input_digest(arr) == jcache.input_digest(arr)


def _key_pair(backend: str, **kw):
    # The column transport is a grid of slots' (the JAX mesh's devices).
    eng = engine.WarmEngine(
        mesh.make_grid((1, 2), devices=["cpu"] * 2) if backend == "cuda_rdma"
        else mesh.make_grid((1, 2), "cpu"))
    jeng = jengine.WarmEngine(jmesh.make_grid_mesh(jax.devices()[:2], (1, 2)))
    key = eng.key_for((1, 24, 32), backend=backend, **kw)
    jkey = jeng.key_for((1, 24, 32), backend=JAX_NAME[backend], **kw)
    return key, dataclasses.replace(jkey, backend=backend)


@pytest.mark.parametrize("backend,kw", [
    ("shifted", dict(iters=2)), ("shifted", dict(iters=3, fuse=3)),
    ("separable", dict(storage="u8", fuse=2, iters=4)),
    ("cuda", dict(iters=2, boundary="periodic")),
    ("cuda_sep", dict(storage="bf16", iters=5, fuse=5)),
    ("cuda_rdma", dict(iters=4, fuse=2, col_mode="strided")),
    ("shifted", dict(iters=10, quantize=False, solver="multigrid",
                     mg_levels=2)),
])
def test_result_and_converge_keys_equal_jax(backend, kw):
    key, jkey = _key_pair(backend, **kw)
    assert dataclasses.asdict(key) == dataclasses.asdict(jkey)
    d = cache.input_digest(np.ones((1, 24, 32), np.float32))
    assert cache.result_key(d, key) == jcache.result_key(d, jkey)
    for tol in (0.5, 1e-3):
        assert (cache.converge_key(d, tol=tol, solver=key.solver,
                                   mg_levels=key.mg_levels, engine_key=key)
                == jcache.converge_key(d, tol=tol, solver=jkey.solver,
                                       mg_levels=jkey.mg_levels,
                                       engine_key=jkey))
    assert (cache.converge_key(d, tol=0.5, solver="jacobi", mg_levels=None)
            == jcache.converge_key(d, tol=0.5, solver="jacobi",
                                   mg_levels=None))


# ------------------------------------------------------- cache lockstep
def _scenario(name: str, mods, root: Path) -> dict:
    """Run one scripted sequence against ``mods`` = (cache, diskio,
    faults); everything observable comes back."""
    cmod, dmod, fmod = mods
    journal, got = [], []
    clk = [0.0]

    def new(**kw):
        return cmod.ResultCache(journal=lambda op, k: journal.append((op, k)),
                                clock=lambda: clk[0], **kw)

    def look(c, k):
        g = c.get(k)
        got.append(None if g is None else (
            {n: a.tobytes() for n, a in sorted(g[0].items())}, g[1]))

    disk = root / "rc"
    if name == "put_get_copies":
        c = new(capacity_entries=4)
        a = _arrays(0)
        c.put("k0", a, {"effective_backend": "shifted"})
        a["image"][:] = 0
        look(c, "k0")
        look(c, "absent")
    elif name == "memory_eviction_is_a_death":
        c = new(capacity_entries=2)
        for i in range(4):
            c.put(f"k{i}", _arrays(i), {"i": i})
        for i in range(4):
            look(c, f"k{i}")
        c.put("k0", _arrays(9), {})   # a re-store lifts the tombstone
        look(c, "k0")
    elif name == "spill_promote_crc":
        c = new(capacity_entries=1, disk_dir=disk)
        for i in range(3):
            c.put(f"k{i}", _arrays(i), {"i": i})
        look(c, "k0")                 # a disk hit, promoted
        path = disk / "k1.rc"
        blob = bytearray(path.read_bytes())
        blob[-3] ^= 0xFF
        path.write_bytes(bytes(blob))
        look(c, "k1")                 # CRC: a loud miss, journaled dead
        look(c, "k1")
    elif name == "adoption_skips_the_dead":
        c = new(capacity_entries=1, disk_dir=disk)
        for i in range(3):
            c.put(f"k{i}", _arrays(i), {})
        c2 = new(disk_dir=disk, dead=["k0"])
        look(c2, "k0")
        look(c2, "k1")
        got.append(sorted(p.name for p in disk.glob("*.rc")))
    elif name == "torn_spill_from_the_env":
        c = new(capacity_entries=1, disk_dir=disk)
        dmod.install_from_env({"PCTPU_DISK_MODES": "cache_spill=torn_write"})
        with fmod.injected("cache_spill:1"):
            c.put("k0", _arrays(0), {})
            c.put("k1", _arrays(1), {})   # evicts k0: a torn spill
        look(c, "k0")
        got.append(sorted(p.name for p in disk.glob("*")))
        look(new(disk_dir=disk), "k0")
        got.append(dmod.injected_counts().get("cache_spill=torn_write"))
    elif name == "promote_eio":
        c = new(capacity_entries=1, disk_dir=disk)
        c.put("k0", _arrays(0), {})
        c.put("k1", _arrays(1), {})
        dmod.install_modes({"cache_promote": "eio"})
        with fmod.injected("cache_promote:1"):
            look(c, "k0")
        look(c, "k0")
    elif name == "demote_reprobe_restore":
        c = new(capacity_entries=1, disk_dir=disk, demote_after=2,
                reprobe_s=5.0)
        dmod.install_modes({"cache_spill": "eio"})
        with fmod.injected("cache_spill:*"):
            for i in range(3):
                c.put(f"k{i}", _arrays(i), {})
        got.append(dict(c.stats))
        clk[0] = 6.0
        with fmod.injected("cache_spill:*"):
            c.put("k3", _arrays(3), {})
        got.append(dict(c.stats))
        dmod.uninstall_modes()
        clk[0] = 12.0
        c.put("k4", _arrays(4), {})
        c.put("k5", _arrays(5), {})
        look(c, "k4")
    elif name == "invalidate_all_len_keys":
        c = new(capacity_entries=2, disk_dir=disk)
        for i in range(4):
            c.put(f"k{i}", _arrays(i), {})
        got.append((len(c), c.keys()))
        c.invalidate("k3")
        c.invalidate("never")
        c.invalidate_all()
        got.append((len(c), c.keys()))
        look(c, "k2")
    else:
        raise AssertionError(name)
    snap = c.snapshot()
    return {"journal": journal, "got": got, "snapshot": snap,
            "files": {p.name: p.read_bytes() for p in sorted(disk.glob("*"))}
            if disk.exists() else {}}


SCENARIOS = ["put_get_copies", "memory_eviction_is_a_death",
             "spill_promote_crc", "adoption_skips_the_dead",
             "torn_spill_from_the_env", "promote_eio",
             "demote_reprobe_restore", "invalidate_all_len_keys"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_cache_lockstep_with_jax(name, tmp_path):
    got = _scenario(name, PORT, tmp_path / "port")
    want = _scenario(name, JAX, tmp_path / "jax")
    assert got == want
    assert got["snapshot"]["mem_entries"] + got["snapshot"]["disk_entries"] \
        <= 4


def test_spill_file_is_the_jax_format(tmp_path):
    """The disk tier's file: CRC'd header line + body, byte for byte;
    each side reads the other's."""
    for mod, d in ((cache, "p"), (jcache, "j")):
        c = mod.ResultCache(capacity_entries=1, disk_dir=tmp_path / d)
        c.put("kx", _arrays(7), {"effective_backend": "cuda_sep", "n": 3})
        c.put("ky", _arrays(8), {})
    p, j = (tmp_path / "p" / "kx.rc"), (tmp_path / "j" / "kx.rc")
    assert p.read_bytes() == j.read_bytes()
    (tmp_path / "p" / "ky.rc").write_bytes(b"")   # only kx to adopt
    (tmp_path / "j" / "ky.rc").write_bytes(b"")
    for mod, d in ((cache, "j"), (jcache, "p")):
        arrays, meta = mod.ResultCache(disk_dir=tmp_path / d).get("kx")
        assert meta == {"effective_backend": "cuda_sep", "n": 3}
        for n, a in _arrays(7).items():
            np.testing.assert_array_equal(arrays[n], a)


# ------------------------------------------------------- guarded writers
def _guarded(dmod, fmod, path: Path, mode: str):
    """Each writer under ``mode`` at the cache_spill site: what it raised
    and what it left."""
    out = []
    dmod.install_modes({"cache_spill": mode} if mode else {})
    for op in ("write", "open", "replace", "fsync", "deferred"):
        src, dst = path / f"{op}.src", path / f"{op}.dst"
        src.write_bytes(b"")
        try:
            with fmod.injected("cache_spill:1"):
                if op == "write":
                    with open(dst, "wb") as fh:
                        dmod.guarded_write("cache_spill", fh, b"abcdefgh")
                elif op == "open":
                    dmod.guarded_open("cache_spill", dst, "wb").close()
                elif op == "replace":
                    dmod.guarded_replace("cache_spill", src, dst)
                elif op == "fsync":
                    with open(dst, "wb") as fh:
                        dmod.guarded_fsync("cache_spill", fh)
                else:
                    out.append(dmod.deferred_consult("cache_spill"))
            out.append((op, "ok"))
        except OSError as e:
            out.append((op, errno.errorcode[e.errno], str(e)))
        except fmod.InjectedFault as e:
            out.append((op, "fault", str(e)))
        out.append((op, dst.read_bytes() if dst.exists() else None,
                    src.exists()))
    out.append(dmod.installed_modes())
    return out


@pytest.mark.parametrize("mode", [None, "enospc", "eio", "torn_write",
                                  "slow_write"])
def test_guarded_writers_behave_as_jax(mode, tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    assert (_guarded(diskio, faults, tmp_path / "p", mode)
            == _guarded(jdiskio, jfaults, tmp_path / "j", mode))


# ------------------------------------------------------------ job ledger
def _row(i: int, shape=(1, 4, 5), ok=True):
    state = np.full(shape, float(i), np.float32)
    b64, sh = jjobs.state_to_wire(state)
    return {"ok": ok, "iters": 10 * i, "diff": 1.0 / (i + 1),
            "work_units": 10.0 * i, "solver": "jacobi", "state_b64": b64,
            "state_shape": sh}


def _ledger_script(mod) -> list:
    led = mod.JobLedger(capacity=2, shard="s0")
    out = []
    led.pin("a")
    out.append(led.observe("a", "rk1", _row(1)))
    out.append(led.observe("b", "rk1", _row(2)))
    out.append(led.observe("c", "rk1", _row(3)))   # evicts b, not pinned a
    out.append(led.observe("d", "rk1", _row(4, ok=False)))
    out.append((led.token("b", "rk1"), led.token("a", "rk2"),
                led.begin("a", "rk1")))
    out.append(led.note_resume("a", "rk1", "replica-1"))
    out.append(led.resume_info("a"))
    out.append((led.finalize("a"), led.finalize("a"), led.begin("a", "rk1")))
    led.unpin("a")
    out.append(led.export())
    led2 = mod.JobLedger(capacity=1)
    out.append(led2.restore({"x": {"key": "rk", "token": _row(5),
                                   "resume_count": 2,
                                   "resumed_from": ["r1", "r2"]},
                             "y": {"key": "rk", "token": None}},
                            finalized=["z"]))
    out.append((led2.export(), led2.finalize("z"), len(led2)))
    led2.drop("y")
    out.append((led.snapshot(), led2.snapshot()))
    return out


def test_job_ledger_equals_jax():
    assert _ledger_script(jobs) == _ledger_script(jjobs)


@pytest.mark.parametrize("shape", [(1, 4, 5), (3, 2, 7), (2, 3, 4, 5)])
def test_tokens_are_the_jax_wire(shape):
    state = np.random.default_rng(1).random(shape, dtype=np.float32)
    assert jobs.state_to_wire(state) == jjobs.state_to_wire(state)
    b64, sh = jjobs.state_to_wire(state)
    np.testing.assert_array_equal(jobs.state_from_wire(b64, sh), state)
    assert jobs.token_from_row(_row(3)) == jjobs.token_from_row(_row(3))
    assert jobs.token_progress(_row(3)) == jjobs.token_progress(_row(3))
    for bad in ((b64, [1, 2]), (b64, ["x"]), ("!!", sh), (b64[:-8], sh)):
        with pytest.raises(ValueError) as got:
            jobs.state_from_wire(*bad)
        with pytest.raises(ValueError) as want:
            jjobs.state_from_wire(*bad)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------- pricing
# Bodies a factor of two or more apart in work on both models (the two
# host models price small work differently, so near-ties may swap).
BODIES = [
    {"rows": 32, "cols": 32, "depth": 32, "mode": "volume", "filter": "fd7",
     "iters": 10},
    {"rows": 480, "cols": 640, "mode": "rgb", "iters": 10},
    {"rows": 64, "cols": 64, "depth": 64, "mode": "volume", "filter": "fd25",
     "iters": 20},
    {"rows": 480, "cols": 640, "mode": "rgb", "iters": 100},
    {"rows": 2048, "cols": 2048, "iters": 100, "filter": "gaussian5"},
]
CONVERGE = [
    {"rows": 1024, "cols": 1024, "max_iters": 2000, "solver": "multigrid"},
]


def _pricers(**kw):
    return (pricing.WorkPricer((2, 2), "cpu", **kw),
            jpricing.WorkPricer((2, 2), "cpu", **kw))


@pytest.mark.parametrize("body", [
    {"rows": None}, {"rows": "x", "cols": 8}, {"rows": 8, "cols": [8]},
    {"rows": 8, "cols": 8, "filter": "nope"},
    {"rows": 8, "cols": 8, "mode": "volume", "depth": "z"},
    {"rows": 8, "cols": 8, "iters": None, "max_iters": None},
])
def test_pricer_floor_and_malformed_bodies_equal_jax(body):
    """A malformed body prices at the floor on both (never raises), and a
    hit prices at the floor whatever the body."""
    p, jp = _pricers()
    assert p.hit_units() == jp.hit_units() == 1e-4
    assert p.price(body, cache_hit=True) == jp.price(body, cache_hit=True)
    for conv in (False, True):
        assert p.price(body, conv) == jp.price(body, conv) == p.min_units


def test_pricer_clamp_and_order_equal_jax():
    p, jp = _pricers(max_units=1e-3)
    huge = {"rows": 65536, "cols": 65536, "iters": 10000}
    assert p.price(huge) == jp.price(huge) == 1e-3
    p, jp = _pricers()
    bodies = [(b, False) for b in BODIES] + [(b, True) for b in CONVERGE]
    got = [p.price(b, c) for b, c in bodies]
    want = [jp.price(b, c) for b, c in bodies]
    assert np.argsort(got, kind="stable").tolist() == np.argsort(
        want, kind="stable").tolist()
    assert all(p.min_units <= g <= p.max_units for g in got)
    # The LRU serves a repeat from its cache; a kernel backend prices on
    # the port's names.
    assert got == sorted(got) and want == sorted(want)
    assert p.price(BODIES[1]) == got[1]
    assert p.price(dict(BODIES[1], backend="cuda_sep")) > p.min_units


def test_pricer_prices_on_the_h100_model_for_a_card():
    from parallel_convolution_tpu_torch.tuning import costmodel

    p = pricing.WorkPricer((1, 1), "gpu", "NVIDIA H100 80GB HBM3")
    assert p.hw.name == "NVIDIA H100 80GB HBM3"
    assert p.hw.hbm_gbps == costmodel.H100.hbm_gbps
    body = {"rows": 1920, "cols": 2520, "mode": "rgb", "iters": 100,
            "backend": "cuda_sep", "storage": "bf16", "fuse": 32}
    assert pricing.WorkPricer((1, 1)).price(body) > p.price(body) > 0
