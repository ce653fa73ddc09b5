"""The port's package root, ``RunConfig`` and ``conv.run_u8`` held against
the JAX package's on the CPU.

The same configs go through both ``RunConfig`` classes (backends mapped
with ``utils.config.BACKEND_FROM_REFERENCE``): each accepts and refuses
the same ones with the same exception type, ``to_json`` is JAX's apart
from the mapped backend, ``convert.run_config_from_reference`` round-trips
a JAX config's JSON, and a u8 config's ``build_model(device="cpu")`` run is
the JAX model's bytes and the oracle's.  ``run_u8`` is byte-equal to JAX
``conv.run_u8``.  A bare ``import parallel_convolution_tpu_torch`` is
numpy-only.
"""

import dataclasses
import json
import subprocess
import sys

import jax
import numpy as np
import pytest

import parallel_convolution_tpu as jroot
from parallel_convolution_tpu.ops import conv as jconv
from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.utils.config import RunConfig as JRunConfig
import parallel_convolution_tpu_torch as root
from parallel_convolution_tpu_torch import convert
from parallel_convolution_tpu_torch.ops import conv, oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.utils import imageio
from parallel_convolution_tpu_torch.utils.config import (
    BACKEND_FROM_REFERENCE, RunConfig,
)

JAX_NAME = {v: k for k, v in BACKEND_FROM_REFERENCE.items()}

# Each entry: the JAX RunConfig's keyword arguments (JAX backend names).
ACCEPTED = [
    dict(rows=100, cols=200, mode="rgb", backend="pallas", mesh_shape=(2, 4),
         fuse=4, storage="bf16", tile=(1024, 512)),
    dict(rows=24, cols=36, filter_name="blur3", mesh_shape=(2, 2)),
    dict(rows=8, cols=8, backend="pallas_rdma", storage="u8", fuse=3,
         overlap=1, col_mode="strided", boundary="periodic"),
    dict(rows=8, cols=8, backend="auto", fuse=None, col_mode="auto"),
    dict(rows=8, cols=8, backend="pallas_sep", converge_tol=0.5,
         check_every=5, fallback=True, sharded_io=True,
         checkpoint_dir="ck", checkpoint_every=4),
    dict(rows=16, cols=16, converge_tol=1e-3, solver="multigrid",
         quantize=False, mg_levels=3),
    dict(rows=16, cols=16, rank=3, depth=8, filter_name="fd25",
         quantize=False),
    dict(rows=4, cols=4, iters=0, backend="xla_conv"),
]
REFUSED = [
    dict(rows=1, cols=1, mode="cmyk"),
    dict(rows=0, cols=1),
    dict(rows=1, cols=-3),
    dict(rows=1, cols=1, iters=-1),
    dict(rows=1, cols=1, fuse=0),
    dict(rows=1, cols=1, tile=(0, 128)),
    dict(rows=1, cols=1, tile=(8, 128, 2)),
    dict(rows=1, cols=1, backend="nope"),
    dict(rows=1, cols=1, storage="f16"),
    dict(rows=1, cols=1, boundary="reflect"),
    dict(rows=1, cols=1, storage="u8", quantize=False),
    dict(rows=1, cols=1, solver="sor"),
    dict(rows=1, cols=1, mg_levels=0),
    dict(rows=1, cols=1, solver="multigrid", converge_tol=0.1),
    dict(rows=1, cols=1, solver="multigrid", converge_tol=0.1,
         quantize=False, storage="bf16"),
    dict(rows=1, cols=1, fuse=None),
    dict(rows=1, cols=1, col_mode="diagonal"),
    dict(rows=1, cols=1, rank=4),
    dict(rows=1, cols=1, rank=3),
    dict(rows=1, cols=1, rank=3, depth=4, filter_name="blur3",
         quantize=False),
    dict(rows=1, cols=1, rank=3, depth=4, filter_name="fd7"),
    dict(rows=1, cols=1, depth=4),
]


def _port_kw(kw: dict) -> dict:
    out = dict(kw)
    if "backend" in out:
        out["backend"] = BACKEND_FROM_REFERENCE.get(out["backend"],
                                                    out["backend"])
    return out


def _outcome(cls, kw):
    try:
        return cls(**kw)
    except Exception as e:  # noqa: BLE001 -- the type is what is compared
        return type(e)


@pytest.mark.parametrize("kw", ACCEPTED + REFUSED)
def test_runconfig_accepts_and_refuses_like_jax(kw):
    want = _outcome(JRunConfig, dict(kw))
    got = _outcome(RunConfig, _port_kw(kw))
    if isinstance(want, type):
        assert got is want, (kw, got)
    else:
        assert isinstance(got, RunConfig), (kw, got)
        assert dataclasses.asdict(got) == dict(
            dataclasses.asdict(want), backend=BACKEND_FROM_REFERENCE.get(
                want.backend, want.backend))


def test_runconfig_refuses_a_jax_backend_name_with_the_hint():
    with pytest.raises(ValueError, match="'pallas_sep' is 'cuda_sep' here"):
        RunConfig(rows=4, cols=4, backend="pallas_sep")


@pytest.mark.parametrize("kw", ACCEPTED)
def test_to_json_is_jax_apart_from_the_backend(kw):
    jcfg, cfg = JRunConfig(**kw), RunConfig(**_port_kw(kw))
    got, want = json.loads(cfg.to_json()), json.loads(jcfg.to_json())
    assert list(got) == list(want)
    assert got == dict(want, backend=BACKEND_FROM_REFERENCE.get(
        want["backend"], want["backend"]))
    assert RunConfig.from_json(cfg.to_json()) == cfg


@pytest.mark.parametrize("kw", ACCEPTED)
def test_run_config_from_reference_round_trips(kw):
    jcfg = JRunConfig(**kw)
    for given in (jcfg.to_json(), json.loads(jcfg.to_json())):
        cfg = convert.run_config_from_reference(given)
        assert cfg == RunConfig(**_port_kw(kw))
        assert cfg.tile == jcfg.tile and cfg.mesh_shape == jcfg.mesh_shape


@pytest.mark.parametrize("backend,storage,fuse", [
    ("shifted", "f32", 1), ("pallas", "u8", 2), ("pallas_sep", "bf16", 3),
    ("pallas_rdma", "u8", 3), ("separable", "u8", 2),
])
def test_build_model_run_equals_jax_and_the_oracle(backend, storage, fuse):
    img = imageio.generate_test_image(24, 36, "grey", seed=4)
    kw = dict(rows=24, cols=36, filter_name="blur3", mesh_shape=(2, 2),
              backend=backend, storage=storage, fuse=fuse, iters=3)
    jgot = JRunConfig(**kw).build_model().run_image(img, 3)
    got = RunConfig(**_port_kw(kw)).build_model(device="cpu").run_image(
        img, 3)
    np.testing.assert_array_equal(got, np.asarray(jgot))
    np.testing.assert_array_equal(
        got, oracle.run_serial_u8(img, get_filter("blur3"), 3))


def test_build_model_runs_on_the_card_unless_asked(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RunConfig(rows=8, cols=8).build_model()


@pytest.mark.parametrize("mode,name,iters", [
    ("grey", "blur3", 3), ("grey", "sharpen3", 7), ("rgb", "blur3", 4),
    ("rgb", "gaussian5", 2), ("grey", "box3", 0),
])
def test_run_u8_is_jax_bytes(mode, name, iters):
    img = imageio.generate_test_image(20, 28, mode, seed=9)
    planar = imageio.interleaved_to_planar(img)
    want = np.asarray(jconv.run_u8(planar, jfilters.get_filter(name), iters))
    got = conv.run_u8(planar, get_filter(name), iters, device="cpu")
    assert str(got.dtype) == "torch.uint8" and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        imageio.planar_to_interleaved(got.numpy()) if mode == "rgb"
        else got.numpy()[0],
        oracle.run_serial_u8(img, get_filter(name), iters))


def test_run_u8_runs_on_the_card_unless_asked(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        conv.run_u8(np.zeros((1, 4, 4), np.uint8), get_filter("blur3"), 1)


def test_root_names_resolve_like_jax():
    assert root.__all__ == jroot.__all__
    from parallel_convolution_tpu_torch import (  # noqa: F401
        FILTERS, ConvolutionModel, Filter, JacobiSolver, RunConfig as RC,
        get_filter as gf, oracle as orc,
    )
    from parallel_convolution_tpu_torch.models import (
        ConvolutionModel as CM, JacobiSolver as JS,
    )

    assert ConvolutionModel is CM and JacobiSolver is JS and RC is RunConfig
    assert orc is oracle and sorted(FILTERS) == sorted(jroot.FILTERS)
    for name in jroot.FILTERS:
        np.testing.assert_array_equal(gf(name).taps,
                                      jroot.get_filter(name).taps)
    with pytest.raises(AttributeError):
        root.NoSuchName  # noqa: B018


def test_bare_import_is_numpy_only():
    """A bare import pulls in neither torch nor the models (the JAX root's
    lazy rule); the names that need them load on first use, and that
    first use starts no CUDA work."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import parallel_convolution_tpu_torch as p\n"
        "loaded = sorted(m for m in set(sys.modules) - before if m == "
        "'torch' or m.startswith('parallel_convolution_tpu_torch.models'))\n"
        "p.ConvolutionModel, p.RunConfig\n"
        "import torch\n"
        "print(loaded, torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(jroot.__file__).rsplit("/", 2)[0])
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "False"]


def test_jax_stays_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
