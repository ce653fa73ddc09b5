"""The port's host tools (ROADMAP item 12) against the JAX package, on the
CPU: the g++ serial baseline (``native/``, the port's own copy of the C++
source, built under ``build/native/``), its block reader in
``utils/sharded_io.py``, ``utils/debug.py``, ``utils/bench.py``'s
``slope_wall`` / ``bench_halo_p50`` / ``bench_oracle_proxy``, and the CLI's
``convert``, ``info``, ``bench`` and ``serial --impl``.

u8 outputs must be byte-equal to the JAX package's and to the NumPy
oracle's; timing rows must carry their keys (a CPU time is no device
metric).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parallel_convolution_tpu import cli as jcli
from parallel_convolution_tpu.native import serial_native as jnative
from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.ops import oracle as joracle
from parallel_convolution_tpu.utils import debug as jdebug
from parallel_convolution_tpu_torch import native
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.native import build as nbuild
from parallel_convolution_tpu_torch.native import serial_native
from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh
from parallel_convolution_tpu_torch.utils import bench, debug, imageio
from parallel_convolution_tpu_torch.utils import sharded_io

REPO = Path(__file__).resolve().parent.parent
# Keys of the JAX bench row that the port's row lacks: none since the
# exchange attribution (obs, item 9) was ported.
JAX_ONLY_BENCH_KEYS: set[str] = set()

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")


# ------------------------------------------------------------- native/


def test_native_builds_under_build_never_beside_its_source():
    native.load()
    assert native.lib_path() == REPO / "build" / "native" / "libpctpu.so"
    assert native.is_built() and nbuild.is_fresh()
    assert not list((REPO / "parallel_convolution_tpu_torch" / "native")
                    .rglob("*.so"))
    # The source is the port's own copy, the JAX package's code.
    ours = nbuild.SOURCE.read_text()
    theirs = (REPO / "parallel_convolution_tpu" / "native" / "src"
              / "pctpu.cpp").read_text()
    assert ours.split("#include", 1)[1] == theirs.split("#include", 1)[1]
    assert nbuild.FLAGS == ("-O3", "-march=native", "-fopenmp", "-fPIC",
                            "-shared", "-ffp-contract=off", "-fno-fast-math")


@pytest.mark.parametrize("mode", ["grey", "rgb"])
@pytest.mark.parametrize("name", ["blur3", "gaussian5", "edge5", "sharpen3"])
def test_native_serial_equals_oracle_and_jax_native(mode, name):
    img = imageio.generate_test_image(33, 47, mode, seed=21)
    f = get_filter(name)
    got = serial_native.run_serial_u8(img, f, 4)
    np.testing.assert_array_equal(got, oracle.run_serial_u8(img, f, 4))
    np.testing.assert_array_equal(
        got, jnative.run_serial_u8(img, jfilters.get_filter(name), 4))
    np.testing.assert_array_equal(serial_native.run_serial_u8(img, f, 4,
                                                              threads=1), got)


@pytest.mark.parametrize("iters", [0, 1, 2, 3])
def test_native_double_buffer_parity(iters):
    img = imageio.generate_test_image(20, 28, "grey", seed=3)
    f = get_filter("blur3")
    np.testing.assert_array_equal(serial_native.run_serial_u8(img, f, iters),
                                  oracle.run_serial_u8(img, f, iters))


@pytest.mark.parametrize("mode", ["grey", "rgb"])
def test_native_block_io_equals_numpy(tmp_path, mode):
    img = imageio.generate_test_image(20, 28, mode, seed=22)
    p = tmp_path / "img.raw"
    imageio.write_raw(p, img)
    for r0, r1, c0, c1 in [(3, 15, 5, 21), (0, 20, 0, 28), (19, 20, 27, 28)]:
        np.testing.assert_array_equal(
            serial_native.read_block(p, 20, 28, mode, r0, r1, c0, c1),
            imageio.read_block(p, 20, 28, mode, r0, r1, c0, c1))
    q, qn = tmp_path / "out.raw", tmp_path / "outn.raw"
    imageio.allocate_raw(q, 20, 28, mode)
    imageio.allocate_raw(qn, 20, 28, mode)
    for r0, c0 in [(0, 0), (10, 0), (0, 14), (10, 14)]:
        blk = img[r0:r0 + 10, c0:c0 + 14]
        serial_native.write_block(q, 20, 28, mode, r0, c0, blk)
        imageio.write_block(qn, 20, 28, mode, r0, c0, blk)
    assert q.read_bytes() == qn.read_bytes() == img.tobytes()
    pl = serial_native.interleaved_to_planar(img)
    np.testing.assert_array_equal(pl, imageio.interleaved_to_planar(img))
    np.testing.assert_array_equal(serial_native.planar_to_interleaved(pl), img)
    with pytest.raises(OSError):
        serial_native.read_block(p, 20, 28, mode, 0, 21, 0, 28)
    with pytest.raises(OSError):
        serial_native.write_block(tmp_path / "absent.raw", 20, 28, mode, 0, 0,
                                  img[:2, :2])


@pytest.mark.parametrize("grid_shape,dtype", [((1, 1), np.float32),
                                              ((2, 3), np.uint8)])
def test_load_sharded_same_through_either_reader(tmp_path, monkeypatch,
                                                 grid_shape, dtype):
    img = imageio.generate_test_image(37, 53, "rgb", seed=5)
    p = tmp_path / "img.raw"
    imageio.write_raw(p, img)
    grid = mesh.make_grid(grid_shape, "cpu")
    calls = []
    real = serial_native.read_block
    monkeypatch.setattr(serial_native, "read_block",
                        lambda *a: calls.append(a) or real(*a))
    nat = sharded_io.load_sharded(p, 37, 53, "rgb", grid, dtype,
                                  reader="native")
    assert calls  # the native reader served every band
    calls.clear()
    plain = sharded_io.load_sharded(p, 37, 53, "rgb", grid, dtype,
                                    reader="numpy")
    assert not calls
    for rn, rp in zip(nat, plain):
        for a, b in zip(rn, rp):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="reader must be one of"):
        sharded_io.load_sharded(p, 37, 53, "rgb", grid, dtype, reader="mmap")


@pytest.mark.parametrize("built", [True, False])
def test_auto_reader_is_chosen_once_per_process(tmp_path, monkeypatch,
                                                built):
    # "auto" asks whether the library is built at its first use only: a
    # library built (or removed) later does not switch the reader within
    # the run, and no band re-hashes the source.
    img = imageio.generate_test_image(20, 12, "grey", seed=6)
    p = tmp_path / "img.raw"
    imageio.write_raw(p, img)
    asked = []
    monkeypatch.setattr(native, "is_built",
                        lambda: asked.append(1) or built)
    sharded_io.default_reader.cache_clear()
    try:
        want = "native" if built else "numpy"
        assert sharded_io.default_reader() == want
        monkeypatch.setattr(native, "is_built", lambda: not built)
        assert sharded_io.default_reader() == want and asked == [1]
        calls = []
        real = serial_native.read_block
        monkeypatch.setattr(serial_native, "read_block",
                            lambda *a: calls.append(a) or real(*a))
        monkeypatch.setattr(sharded_io, "BAND_BYTES", 36)  # 3 rows a band
        got = sharded_io.load_sharded(p, 20, 12, "grey",
                                      mesh.make_grid((1, 1), "cpu"))
        assert len(calls) == (7 if built else 0)
        np.testing.assert_array_equal(got[0][0].numpy()[0, :20, :12], img)
    finally:
        sharded_io.default_reader.cache_clear()


def test_native_read_failure_raises(tmp_path, monkeypatch):
    # The JAX reader swallows a native failure and reads through numpy;
    # the port's raises (ROADMAP Queue 3).
    img = imageio.generate_test_image(16, 16, "grey", seed=5)
    p = tmp_path / "img.raw"
    imageio.write_raw(p, img)
    native.load()

    def broken(*a):
        raise OSError("pctpu_read_block failed with code -3")

    monkeypatch.setattr(serial_native, "read_block", broken)
    with pytest.raises(OSError, match="code -3"):
        sharded_io.load_sharded(p, 16, 16, "grey", mesh.make_grid((1, 1),
                                                                  "cpu"))


def test_native_build_failure_names_gpp_stderr(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(nbuild, "SOURCE", bad)
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(nbuild, "LIB", tmp_path / "b" / "libpctpu.so")
    with pytest.raises(RuntimeError, match="native build failed.*error"):
        nbuild.build()
    assert not list((tmp_path / "b").glob("*.so"))


def test_concurrent_builds_leave_one_good_library(tmp_path):
    # Two processes rebuilding at once (as test workers may): the lock and
    # the atomic rename leave one whole library that loads and runs.
    code = ("from parallel_convolution_tpu_torch.native import build; "
            "build.build(force=True)")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              cwd=tmp_path) for _ in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    assert nbuild.is_fresh()
    assert not list(nbuild.BUILD_DIR.glob(".libpctpu.*.so"))
    out = subprocess.run(
        [sys.executable, "-c",
         "import numpy as np; from parallel_convolution_tpu_torch.native "
         "import serial_native as s; from parallel_convolution_tpu_torch.ops"
         ".filters import get_filter; print(int(s.run_serial_u8(np.full(("
         "8, 8), 16, np.uint8), get_filter('blur3'), 1)[4, 4]))"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "16"


# ------------------------------------------------------------- debug.py


def test_checked_correlate_equals_jax_on_finite_input():
    x = imageio.generate_test_image(19, 23, "grey", seed=4)[None].astype(
        np.float32)
    got = debug.checked_correlate(x, get_filter("blur3"))
    want = jdebug.checked_correlate(x, jfilters.get_filter("blur3"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_checked_correlate_raises_as_jax_does(bad):
    x = np.ones((1, 8, 8), np.float32)
    x[0, 3, 3] = bad
    with pytest.raises(ValueError, match="non-finite") as jerr:
        jdebug.checked_correlate(x, jfilters.get_filter("blur3"))
    with pytest.raises(ValueError, match="non-finite") as err:
        debug.checked_correlate(x, get_filter("blur3"))
    assert isinstance(err.value, debug.NonFiniteError)
    assert isinstance(jerr.value, ValueError)


@pytest.mark.parametrize("values,ok", [
    ([0.0, 255.0, 17.0], True), ([0.0, 256.0], False), ([1.5], False),
    ([-1.0], False), ([], True), ([np.nan], False),
])
def test_assert_u8_range_as_jax(values, ok):
    a = np.array(values, np.float32)
    for fn in (jdebug.assert_u8_range, debug.assert_u8_range):
        if ok:
            fn(a)
        else:
            with pytest.raises(AssertionError, match="invariant"):
                fn(a)
    if not ok:
        with pytest.raises(AssertionError, match="invariant"):
            debug.assert_u8_range(torch.from_numpy(a).to(torch.bfloat16))


def test_find_nonfinite_as_jax():
    a = np.zeros((4, 5), np.float32)
    a[1, 2], a[3, 0] = np.inf, np.nan
    assert debug.find_nonfinite(a) == jdebug.find_nonfinite(a) == [(1, 2),
                                                                    (3, 0)]
    assert debug.find_nonfinite(torch.from_numpy(a)) == [(1, 2), (3, 0)]
    big = np.full((30, 30), np.nan)
    assert len(debug.find_nonfinite(big)) == 10


# ------------------------------------------------------------- bench.py


def test_bench_halo_p50_on_the_cpu():
    grid = mesh.make_grid((2, 2), "cpu")
    row = bench.bench_halo_p50((32, 128), r=1, grid=grid, trials=5,
                               chain_rounds=16)
    assert row["block"] == "32x128" and row["mesh"] == "2x2"
    assert row["exchange"] == "parallel/halo.py"
    assert row["rounds_per_trial"] == 16
    assert row["timing"] == "amortized-diff-16"
    if row.get("noise_floor"):
        assert row["p50_us"] is None
    else:
        assert row["p50_us"] >= 0
        assert row["p90_us"] is None or row["p90_us"] >= row["p50_us"]
    one = bench.bench_halo_p50((32, 128), r=1,
                               grid=mesh.make_grid((1, 1), "cpu"))
    assert one["p50_us"] is None and "no neighbour" in one["unmeasurable"]


def test_halo_bench_rounds_consume_the_ghosts():
    # The live round moves data across blocks (the window starts at the
    # ghost corner); the control round is a local roll of the same shift.
    grid = mesh.make_grid((2, 2), "cpu")
    x = torch.arange(16 * 16, dtype=torch.float32).reshape(1, 16, 16)
    blocks = mesh.split_blocks(x, grid)
    live = bench.halo_bench_rounds(grid, 1, True)(blocks, 1)
    ctl = bench.halo_bench_rounds(grid, 1, False)(blocks, 1)
    # Block (1, 1)'s new corner is block (0, 0)'s last pixel.
    assert float(live[1][1][0, 0, 0]) == float(blocks[0][0][0, 7, 7])
    assert torch.equal(ctl[1][1], torch.roll(blocks[1][1], (1, 1), (1, 2)))
    assert not torch.equal(live[1][1], ctl[1][1])


def test_slope_wall_and_oracle_proxy_on_the_cpu():
    x = torch.zeros((1, 64, 64))
    secs = bench.slope_wall(lambda v: v + 1, x, reps=3, chain=4)
    assert secs > 0
    row = bench.bench_oracle_proxy((64, 64), iters=1, reps=2)
    assert row["impl"] == "cpp-serial" and row["gpixels_per_s"] > 0
    assert set(row) == {"workload", "impl", "wall_s", "gpixels_per_s", "reps",
                        "spread_pct"}


# ------------------------------------------------------------- the CLI


@pytest.mark.parametrize("mode", ["grey", "rgb"])
def test_cli_convert_equals_jax(tmp_path, capsys, mode):
    src = tmp_path / "in.raw"
    imageio.write_raw(src, imageio.generate_test_image(13, 21, mode, seed=6))
    ext = "pgm" if mode == "grey" else "ppm"
    ours, theirs = tmp_path / f"o.{ext}", tmp_path / f"j.{ext}"
    assert cli_main(["convert", str(src), "13", "21", mode, "-o",
                     str(ours)]) == 0
    line = capsys.readouterr().out.strip()
    assert jcli.main(["convert", str(src), "13", "21", mode, "-o",
                      str(theirs)]) == 0
    jline = capsys.readouterr().out.strip()
    assert ours.read_bytes() == theirs.read_bytes()
    assert line.replace(str(ours), "") == jline.replace(str(theirs), "")


@pytest.mark.parametrize("impl", ["native", "oracle", "auto"])
@pytest.mark.parametrize("mode,name", [("grey", "blur3"), ("rgb", "edge5")])
def test_cli_serial_equals_jax(tmp_path, capsys, impl, mode, name):
    src = tmp_path / "in.raw"
    img = imageio.generate_test_image(31, 45, mode, seed=8)
    imageio.write_raw(src, img)
    ours, theirs = tmp_path / "o.raw", tmp_path / "j.raw"
    args = ["31", "45", "5", mode, "--filter", name, "--impl", impl]
    assert cli_main(["serial", str(src)] + args[:4] + ["-o", str(ours)]
                    + args[4:]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert jcli.main(["serial", str(src)] + args[:4] + ["-o", str(theirs)]
                     + args[4:]) == 0
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.read_bytes() == joracle.run_serial_u8(
        img, jfilters.get_filter(name), 5).tobytes()
    # The line names the implementation that ran (native where it builds).
    want = "oracle" if impl == "oracle" else "native"
    assert line.startswith(f"serial[{want}]:")
    assert line.replace(str(ours), "") == jline.replace(str(theirs), "")


def test_cli_serial_native_fails_when_it_cannot_build(tmp_path, capsys,
                                                      monkeypatch):
    src = tmp_path / "in.raw"
    imageio.write_raw(src, imageio.generate_test_image(8, 8, "grey", seed=1))

    def no_build(*a, **k):
        raise RuntimeError("native build failed (g++ exit 1): no g++")

    monkeypatch.setattr(serial_native, "run_serial_u8", no_build)
    argv = ["serial", str(src), "8", "8", "2", "grey", "-o",
            str(tmp_path / "o.raw")]
    assert cli_main(argv + ["--impl", "native"]) == 2
    assert "native build failed" in capsys.readouterr().err
    assert not (tmp_path / "o.raw").exists()
    # auto keeps the JAX rule: the oracle when the native tier fails.
    assert cli_main(argv + ["--impl", "auto"]) == 0
    assert capsys.readouterr().out.startswith("serial[oracle]:")


def test_cli_bench_row_has_the_jax_keys(capsys):
    argv = ["bench", "64", "96", "3", "grey", "--mesh", "2x2", "--fuse", "2",
            "--tile", "16,128", "--reps", "1"]
    assert cli_main(argv + ["--backend", "cuda_sep", "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(argv + ["--backend", "pallas_sep"]) == 0
    jrow = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(jrow) - set(row) == JAX_ONLY_BENCH_KEYS
    assert row["mesh"] == jrow["mesh"] == "2x2"
    assert row["effective_backend"] == "cuda_sep" and row["fuse"] == 2
    assert row["gpixels_per_s"] > 0 and row["devices"] == 4
    assert (row["device_kind"], row["platform"]) == ("cpu", "cpu")
    assert "power_limit_w" in row and row["power_limit_w"] is None


def test_cli_info_runs(capsys):
    assert cli_main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "backend: cpu  devices: 1" in out and "default grid: (1, 1)" in out
    assert "blur3" in out and "cuda_rdma" in out and "multigrid" in out
    assert jcli.main(["info"]) == 0
    jout = capsys.readouterr().out
    # The same filter registry.
    assert [ln for ln in out.splitlines() if ln.startswith("filters:")] == \
        [ln for ln in jout.splitlines() if ln.startswith("filters:")]
