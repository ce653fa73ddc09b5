"""The port's checkpoints (``utils/checkpoint.py``, ``run --checkpoint``)
against the JAX package's, u8 byte for byte.

A kill at every checkpoint fault site resumes bit-exactly; torn and
quarantined snapshots fall back to older ones or to a fresh start; a
snapshot reshards onto another grid; and the on-disk format is the JAX
package's: a ``shifted`` run writes the same shard files and meta in both
packages, and a snapshot either package wrote resumes in the other.
"""

import os
import warnings
import zlib

import jax
import numpy as np
import pytest
import torch

from parallel_convolution_tpu import cli as jcli
from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.parallel import step as jstep
from parallel_convolution_tpu.resilience import faults as jfaults
from parallel_convolution_tpu.utils import checkpoint as jcheckpoint
from parallel_convolution_tpu_torch import convert
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.parallel import mesh
from parallel_convolution_tpu_torch.resilience import diskio, faults
from parallel_convolution_tpu_torch.utils import checkpoint, imageio


@pytest.fixture(autouse=True)
def _clean_state():
    faults.uninstall_plan()
    diskio.uninstall_modes()
    yield
    faults.uninstall_plan()
    diskio.uninstall_modes()


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _filters(name="blur3"):
    jf = jfilters.get_filter(name)
    return jf, convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)


def _blocks(img, grid_shape, storage="f32"):
    return convert.blocks_from_numpy(imageio.interleaved_to_planar(img),
                                     mesh.make_grid(grid_shape, "cpu"),
                                     storage)


def _u8(blocks, hw):
    return convert.to_numpy(blocks, hw).astype(np.uint8)


def _run(ck, img, total, every, grid_shape=(2, 2), blocks=None, **kw):
    _, tf = _filters()
    g = mesh.make_grid(grid_shape, "cpu")
    return checkpoint.run_checkpointed(
        blocks, tf, total, g, img.shape[:2], ck, every, **kw)


def _snapshots(tmp_path, img, total=6, every=2):
    ck = tmp_path / "ck"
    _run(ck, img, total, every, blocks=_blocks(img, (2, 2)))
    return ck


def test_meta_records_shard_crcs(tmp_path, grey_odd):
    ck = _snapshots(tmp_path, grey_odd)
    meta = checkpoint.load_meta(ck)
    assert sorted(meta["shards"]) == [f"shard_{r}_{c}.npy" for r in range(2)
                                      for c in range(2)]
    snap = ck / f"it_{meta['iters_done']:08d}"
    for name, rec in meta["shards"].items():
        raw = (snap / name).read_bytes()
        assert (len(raw), zlib.crc32(raw)) == (rec["bytes"], rec["crc32"])
    assert sorted(p.name for p in ck.iterdir()) == [
        "LATEST", "it_00000002", "it_00000004"]  # KEEP_SNAPSHOTS = 2


# A (2, 2) grid writes 4 shards a save; every 3 of 8 saves at 3 and 6.
# checkpoint_write_shard hits 1 and 3 tear the first save, hit 5 the
# second; checkpoint_write_meta hits 1 / 2 are the first save's meta write
# and LATEST flip, 3 / 4 the second save's.
@pytest.mark.parametrize("spec", [
    "checkpoint_write_shard:1", "checkpoint_write_shard:3",
    "checkpoint_write_shard:5", "checkpoint_write_meta:1",
    "checkpoint_write_meta:2", "checkpoint_write_meta:3",
    "checkpoint_write_meta:4",
])
@pytest.mark.parametrize("storage", ["f32", "u8"])
def test_kill_at_each_checkpoint_site_resumes_bitexact(tmp_path, grey_odd,
                                                       spec, storage):
    _, tf = _filters()
    want = oracle.run_serial_u8(grey_odd, tf, 8)
    ck = tmp_path / "ck"
    with faults.injected(spec) as plan:
        with pytest.raises(faults.InjectedFault):
            _run(ck, grey_odd, 8, 3, blocks=_blocks(grey_odd, (2, 2),
                                                    storage))
        assert plan.fired
    out = _run(ck, grey_odd, 8, 3, blocks=_blocks(grey_odd, (2, 2), storage))
    assert out[0][0].dtype == (torch.uint8 if storage == "u8"
                               else torch.float32)
    np.testing.assert_array_equal(_u8(out, grey_odd.shape)[0], want)


@pytest.mark.parametrize("mode", ["enospc", "eio", "torn_write"])
def test_disk_modes_fail_a_save_loudly(tmp_path, grey_odd, mode):
    diskio.install_modes(f"checkpoint_write_shard={mode}")
    with faults.injected("checkpoint_write_shard:2"):
        with pytest.raises(OSError):
            _run(tmp_path / "ck", grey_odd, 6, 3,
                 blocks=_blocks(grey_odd, (2, 2)))
    assert not (tmp_path / "ck" / "LATEST").exists()


@pytest.mark.parametrize("damage", ["missing", "truncated", "bitflip"])
def test_load_state_detects_torn_snapshot(tmp_path, grey_odd, damage):
    ck = _snapshots(tmp_path, grey_odd)
    g = mesh.make_grid((2, 2), "cpu")
    latest = ck / (ck / "LATEST").read_text().strip()
    victim = latest / "shard_1_0.npy"
    if damage == "missing":
        victim.unlink()
    elif damage == "truncated":
        victim.write_bytes(victim.read_bytes()[:-8])
    else:
        raw = bytearray(victim.read_bytes())
        raw[-1] ^= 0xFF
        victim.write_bytes(bytes(raw))
    with pytest.raises(checkpoint.CheckpointCorrupt, match="shard_1_0") as e:
        checkpoint.load_state(ck, g)
    cause = {"missing": "missing", "truncated": "truncated",
             "bitflip": "checksum"}[damage]
    assert e.value.problems == ((cause, "shard_1_0.npy"),)
    with pytest.warns(checkpoint.CheckpointWarning, match="torn"):
        _, meta = checkpoint.load_state(ck, g, fallback=True)
    assert meta["iters_done"] == 2
    # The JAX package reads the same verdicts from the same directory.
    with pytest.raises(jcheckpoint.CheckpointCorrupt, match="shard_1_0"):
        jcheckpoint.load_state(ck, _jax_mesh((2, 2)))


def test_torn_meta_and_unreadable_shards_quarantine(tmp_path, grey_odd):
    ck = _snapshots(tmp_path, grey_odd)
    g = mesh.make_grid((2, 2), "cpu")
    (ck / "it_00000004" / "meta.json").write_text("{not json")
    with pytest.warns(checkpoint.CheckpointWarning, match="torn-meta|torn"):
        _, meta = checkpoint.load_state(ck, g, fallback=True)
    assert meta["iters_done"] == 2
    # A shard that cannot be read (io_read) quarantines its snapshot too.
    (tmp_path / "b").mkdir()
    ck = _snapshots(tmp_path / "b", grey_odd)
    with faults.injected("io_read:1"):
        with pytest.raises(checkpoint.CheckpointCorrupt) as e:
            checkpoint.load_state(ck, g)
    assert e.value.problems == (("unreadable", "shard_0_0.npy"),)
    with faults.injected("io_read:1"):
        with pytest.warns(checkpoint.CheckpointWarning, match="unreadable"):
            _, meta = checkpoint.load_state(ck, g, fallback=True)
    assert meta["iters_done"] == 2


def test_resume_through_torn_latest(tmp_path, grey_odd):
    _, tf = _filters()
    ck = _snapshots(tmp_path, grey_odd)
    latest = ck / (ck / "LATEST").read_text().strip()
    (latest / "shard_0_1.npy").unlink()
    with pytest.warns(checkpoint.CheckpointWarning):
        out = _run(ck, grey_odd, 9, 2)
    np.testing.assert_array_equal(_u8(out, grey_odd.shape)[0],
                                  oracle.run_serial_u8(grey_odd, tf, 9))


def test_fresh_start_when_every_snapshot_is_torn(tmp_path, grey_odd):
    _, tf = _filters()
    ck = _snapshots(tmp_path, grey_odd)
    for snap in ck.glob("it_*"):
        (snap / "shard_0_0.npy").unlink()
    with pytest.warns(checkpoint.CheckpointWarning, match="starting fresh"):
        out = _run(ck, grey_odd, 6, 2, blocks=_blocks(grey_odd, (2, 2)))
    np.testing.assert_array_equal(_u8(out, grey_odd.shape)[0],
                                  oracle.run_serial_u8(grey_odd, tf, 6))
    with pytest.raises(FileNotFoundError):
        checkpoint.load_state(tmp_path / "none", mesh.make_grid((1, 1),
                                                               "cpu"))
    with pytest.raises(ValueError, match="no initial state"):
        _run(tmp_path / "none", grey_odd, 4, 2)


@pytest.mark.parametrize("src,dst", [((2, 2), (1, 1)), ((2, 2), (3, 2)),
                                     ((1, 1), (2, 4))])
def test_reshard_onto_another_grid(tmp_path, rgb_small, src, dst):
    _, tf = _filters()
    ck = tmp_path / "ck"
    _run(ck, rgb_small, 4, 2, grid_shape=src,
         blocks=_blocks(rgb_small, src))
    with pytest.warns(checkpoint.CheckpointWarning,
                      match=f"from grid {src[0]}x{src[1]} onto "
                            f"{dst[0]}x{dst[1]}"):
        out = _run(ck, rgb_small, 7, 2, grid_shape=dst)
    want = oracle.run_serial_u8(rgb_small, tf, 7)
    np.testing.assert_array_equal(
        imageio.planar_to_interleaved(_u8(out, rgb_small.shape[:2])), want)
    meta = checkpoint.load_meta(ck)
    assert meta["grid"] == list(dst) and meta["iters_done"] == 6


def test_config_mismatch_text_is_jax_text(tmp_path, grey_odd):
    jf, tf = _filters()
    ck = tmp_path / "ck"
    _run(ck, grey_odd, 4, 2, blocks=_blocks(grey_odd, (2, 2)))
    with pytest.raises(ValueError, match="checkpoint config mismatch") as got:
        _run(ck, grey_odd, 6, 2, blocks=_blocks(grey_odd, (2, 2)), fuse=2)
    m = _jax_mesh((2, 2))
    xs, valid_hw, _ = jstep._prepare(grey_odd[None].astype(np.float32), m, 1)
    with pytest.raises(ValueError) as want:
        jcheckpoint.run_checkpointed(xs, jf, 6, m, valid_hw, ck, 2, fuse=2)
    assert str(got.value) == str(want.value)
    # A kernel backend is named differently in the two packages: refused.
    ck2 = tmp_path / "ck2"
    jcheckpoint.run_checkpointed(xs, jf, 4, m, valid_hw, ck2, 2,
                                 backend="pallas")
    with pytest.raises(ValueError, match="checkpoint config mismatch"):
        _run(ck2, grey_odd, 6, 2, blocks=_blocks(grey_odd, (2, 2)),
             backend="cuda")


def test_bf16_blocks_are_refused_by_a_save(tmp_path, grey_odd):
    with pytest.raises(ValueError, match="no bfloat16"):
        _run(tmp_path / "ck", grey_odd, 4, 2,
             blocks=_blocks(grey_odd, (2, 2), "bf16"))


@pytest.mark.parametrize("storage", ["f32", "u8"])
def test_shard_files_are_jax_bytes(tmp_path, grey_odd, storage):
    jf, _ = _filters()
    m = _jax_mesh((2, 4))
    xs, valid_hw, _ = jstep._prepare(grey_odd[None].astype(np.float32), m, 1,
                                     storage)
    jcheckpoint.run_checkpointed(xs, jf, 6, m, valid_hw, tmp_path / "j", 2)
    _run(tmp_path / "t", grey_odd, 6, 2, grid_shape=(2, 4),
         blocks=_blocks(grey_odd, (2, 4), storage))
    for snap in ("it_00000002", "it_00000004"):
        names = sorted(os.listdir(tmp_path / "j" / snap))
        assert names == sorted(os.listdir(tmp_path / "t" / snap))
        for name in names:
            assert ((tmp_path / "j" / snap / name).read_bytes()
                    == (tmp_path / "t" / snap / name).read_bytes()), name
    assert ((tmp_path / "j" / "LATEST").read_bytes()
            == (tmp_path / "t" / "LATEST").read_bytes())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_resumes_in_the_other_package(tmp_path, grey_odd, writer):
    """A run torn at its second save (2x4 grid: 8 shards a save, hit 10)
    by one package resumes in the other, byte-equal to an uninterrupted
    run."""
    jf, tf = _filters()
    want = oracle.run_serial_u8(grey_odd, tf, 8)
    ck = tmp_path / "ck"
    m = _jax_mesh((2, 4))
    xs, valid_hw, _ = jstep._prepare(grey_odd[None].astype(np.float32), m, 1)
    if writer == "jax":
        with jfaults.injected("checkpoint_write_shard:10"):
            with pytest.raises(jfaults.InjectedFault):
                jcheckpoint.run_checkpointed(xs, jf, 8, m, valid_hw, ck, 3)
        out = _run(ck, grey_odd, 8, 3, grid_shape=(2, 4))
        got = _u8(out, grey_odd.shape)[0]
    else:
        with faults.injected("checkpoint_write_shard:10"):
            with pytest.raises(faults.InjectedFault):
                _run(ck, grey_odd, 8, 3, grid_shape=(2, 4),
                     blocks=_blocks(grey_odd, (2, 4)))
        out = jcheckpoint.run_checkpointed(None, jf, 8, m, valid_hw, ck, 3)
        got = np.asarray(out)[0, :valid_hw[0], :valid_hw[1]].astype(np.uint8)
    assert (ck / "LATEST").read_text() == "it_00000006"
    np.testing.assert_array_equal(got, want)


def test_cli_checkpoint_kill_and_resume_match_jax_cli(tmp_path):
    import subprocess
    import sys

    img = imageio.generate_test_image(41, 35, "rgb", seed=9)
    src = tmp_path / "in.raw"
    imageio.write_raw(src, img)
    head = ["run", str(src), "41", "35", "10", "rgb", "--mesh", "2x2",
            "--checkpoint-every", "4"]
    jout, out = tmp_path / "j.raw", tmp_path / "t.raw"
    assert jcli.main(head + ["-o", str(jout), "--checkpoint",
                             str(tmp_path / "jck")]) == 0
    # A first port process dies in its second save (hits 5-8).
    env = dict(os.environ, PCTPU_FAULTS="checkpoint_write_shard:6")
    proc = subprocess.run(
        [sys.executable, "-m", "parallel_convolution_tpu_torch"] + head
        + ["-o", str(out), "--checkpoint", str(tmp_path / "ck"),
           "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode != 0
    assert "injected fault at 'checkpoint_write_shard' (hit 6" in proc.stderr
    assert (tmp_path / "ck" / "LATEST").read_text() == "it_00000004"
    assert not out.exists()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cli_main(head + ["-o", str(out), "--checkpoint",
                                str(tmp_path / "ck"), "--device",
                                "cpu"]) == 0
    assert out.read_bytes() == jout.read_bytes()
    # --storage does not change the checkpointed carry (f32, as in JAX).
    assert cli_main(head + ["-o", str(tmp_path / "u.raw"), "--checkpoint",
                            str(tmp_path / "ck_u8"), "--storage", "u8",
                            "--device", "cpu"]) == 0
    assert np.load(tmp_path / "ck_u8" / "it_00000008"
                   / "shard_0_0.npy").dtype == np.float32
    assert (tmp_path / "u.raw").read_bytes() == jout.read_bytes()
    # --checkpoint comes before --sharded-io, as in the JAX CLI.
    assert cli_main(head + ["-o", str(tmp_path / "s.raw"), "--sharded-io",
                            "--checkpoint", str(tmp_path / "ck_s"),
                            "--device", "cpu"]) == 0
    assert (tmp_path / "ck_s" / "LATEST").exists()


def test_cli_checkpoint_with_fallback_names_the_degraded_tier(tmp_path,
                                                              capsys):
    from parallel_convolution_tpu_torch.resilience import degrade

    degrade.clear_probe_cache()
    img = imageio.generate_test_image(20, 24, "grey", seed=4)
    src = tmp_path / "in.raw"
    imageio.write_raw(src, img)
    argv = ["run", str(src), "20", "24", "6", "grey", "--mesh", "2x2",
            "--checkpoint", str(tmp_path / "ck"), "--checkpoint-every", "2",
            "--backend", "cuda_rdma", "--fallback", "--device", "cpu",
            "-o", str(tmp_path / "o.raw")]
    with faults.injected("backend_compile:1"):
        with pytest.warns(UserWarning, match="'cuda_rdma' degraded to 'cuda'"):
            assert cli_main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "(cuda_rdma degraded to cuda, f32, fuse 1, cpu)" in line
    _, tf = _filters()
    np.testing.assert_array_equal(imageio.read_raw(tmp_path / "o.raw", 20,
                                                   24, "grey"),
                                  oracle.run_serial_u8(img, tf, 6))
    degrade.clear_probe_cache()


def test_run_checkpointed_resolves_the_fallback_once(tmp_path, grey_odd,
                                                     monkeypatch):
    from parallel_convolution_tpu_torch.resilience import degrade

    degrade.clear_probe_cache()
    probes = []
    orig = degrade._run_probe
    monkeypatch.setattr(degrade, "_run_probe",
                        lambda *a: probes.append((a[2], a[4])) or orig(*a))
    _, tf = _filters()
    ck = tmp_path / "ck"
    with faults.injected("backend_compile:1"):
        with pytest.warns(UserWarning,
                          match="'cuda_rdma' degraded to 'cuda'"):
            out = _run(ck, grey_odd, 7, 2, blocks=_blocks(grey_odd, (2, 2)),
                       backend="cuda_rdma", fuse=2, fallback=True)
    # Once, before the first chunk, at its fuse: not again for the fuse-1
    # tail chunk, which runs the tier the walk picked.
    assert probes == [("cuda_rdma", 2), ("cuda", 2)]
    assert checkpoint.load_meta(ck)["backend"] == "cuda_rdma"
    np.testing.assert_array_equal(_u8(out, grey_odd.shape)[0],
                                  oracle.run_serial_u8(grey_odd, tf, 7))
    degrade.clear_probe_cache()


# ------------------------------------------------- on a grid of slots (10c)


def _slots(shape):
    return mesh.make_grid(shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("src,dst", [
    ("2x2 slots", "1x1"), ("2x2 slots", "3x2 slots"), ("2x2", "2x3 slots"),
    ("2x2 slots", "2x2 slots")])
def test_save_on_slots_resume_on_another_grid(tmp_path, rgb_small, src, dst):
    def grid_of(spec):
        shape = tuple(int(v) for v in spec.split()[0].split("x"))
        return _slots(shape) if "slots" in spec else mesh.make_grid(shape,
                                                                    "cpu")

    _, tf = _filters()
    hw = rgb_small.shape[:2]
    planar = imageio.interleaved_to_planar(rgb_small).astype(np.float32)
    g0, g1 = grid_of(src), grid_of(dst)
    ck = tmp_path / "ck"
    blocks = convert.blocks_from_numpy(planar, g0, "f32")
    with faults.injected("checkpoint_write_shard:5"):
        with pytest.raises(faults.InjectedFault):
            checkpoint.run_checkpointed(blocks, tf, 7, g0, hw, ck, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", checkpoint.CheckpointWarning)
        out = checkpoint.run_checkpointed(None, tf, 7, g1, hw, ck, 2)
    for (i, j), b in mesh.local_blocks(out):
        assert b.device == g1.slot_device(i, j)
    np.testing.assert_array_equal(
        convert.to_numpy(out, hw).astype(np.uint8),
        imageio.interleaved_to_planar(oracle.run_serial_u8(rgb_small, tf,
                                                           7)))


def test_snapshot_on_slots_is_the_one_device_bytes(tmp_path, grey_odd):
    # The JAX format byte for byte: shard files and meta of a snapshot
    # written from slots are the one-device grid's, and JAX resumes it.
    _, tf = _filters()
    hw = grey_odd.shape[:2]
    outs = {}
    for name, g in (("slots", _slots((2, 2))),
                    ("one", mesh.make_grid((2, 2), "cpu"))):
        ck = tmp_path / name
        checkpoint.run_checkpointed(_blocks(grey_odd, (2, 2)), tf, 5, g, hw,
                                    ck, 2)
        snap = ck / "it_00000004"
        outs[name] = {p.name: p.read_bytes() for p in snap.iterdir()}
        assert not list(ck.rglob("*.tmp"))
    assert outs["slots"] == outs["one"]
    jout = jcheckpoint.run_checkpointed(
        None, _filters()[0], 5, _jax_mesh((2, 2)), hw, tmp_path / "slots", 2)
    np.testing.assert_array_equal(
        np.asarray(jout)[0, :hw[0], :hw[1]].astype(np.uint8),
        oracle.run_serial_u8(grey_odd, tf, 5))
