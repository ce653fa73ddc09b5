"""The port's resilience layer (``resilience/faults.py``, ``diskio.py``,
``retry.py``, ``degrade.py``) against the JAX package's, on the same specs,
seeds and inputs.

Fault plans fire the same hits; ``classify`` gives the JAX package's
verdicts, and the card's CUDA errors classify as a refused launch
(transient) or a lost context (terminal); a ``backend_compile`` fault
degrades ``cuda`` / ``cuda_rdma`` one tier down to the oracle's bytes, as
the JAX package degrades ``pallas`` / ``pallas_rdma``.
"""

import errno
import re
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_jax_state import reset_jax_state

from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.parallel import step as jstep
from parallel_convolution_tpu.resilience import degrade as jdegrade
from parallel_convolution_tpu.resilience import diskio as jdiskio
from parallel_convolution_tpu.resilience import faults as jfaults
from parallel_convolution_tpu.resilience import retry as jretry
from parallel_convolution_tpu_torch import convert
from parallel_convolution_tpu_torch.models import ConvolutionModel
from parallel_convolution_tpu_torch.ops import _build, oracle, stencil
from parallel_convolution_tpu_torch.parallel import mesh, step
from parallel_convolution_tpu_torch.resilience import (
    degrade, diskio, faults, retry,
)
from parallel_convolution_tpu_torch.utils import bench, imageio
from parallel_convolution_tpu_torch.utils.config import (
    BACKEND_FROM_REFERENCE,
)

PORT = Path(step.__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_state():
    """No plan, mode map or probe verdict leaks between tests."""
    for mod in (faults, jfaults):
        mod.uninstall_plan()
    for mod in (diskio, jdiskio):
        mod.uninstall_modes()
    degrade.clear_probe_cache()
    jdegrade.clear_probe_cache()
    yield
    for mod in (faults, jfaults):
        mod.uninstall_plan()
    for mod in (diskio, jdiskio):
        mod.uninstall_modes()
    degrade.clear_probe_cache()
    reset_jax_state()  # the JAX build caches too: fallback runs fill them


# ------------------------------------------------------------------ faults

SITES = ["backend_compile", "halo_exchange", "io_read",
         "checkpoint_write_shard", "checkpoint_write_meta"]


def _fire(mod, spec, seed):
    """Consult 60 sites in a fixed order under ``spec``; the (site, hit,
    transient) of every fault raised, and the plan's own record."""
    plan = mod.plan_from_spec(spec, seed=seed)
    raised = []
    for i in range(60):
        site = SITES[(i * 7) % len(SITES)]
        try:
            plan.check(site)
        except mod.InjectedFault as e:
            raised.append((e.site, e.hit, e.transient))
    return raised, plan.fired, {s: plan.hits(s) for s in SITES}


@pytest.mark.parametrize("spec", [
    "checkpoint_write_shard:2",
    "backend_compile:1+",
    "halo_exchange:p0.3,io_read:3+",
    "io_read:*",
    "backend_compile:2!",
    "checkpoint_write_meta:p0.5!,backend_compile:4",
])
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plans_fire_the_same_hits_as_jax(spec, seed):
    got = _fire(faults, spec, seed)
    assert got == _fire(jfaults, spec, seed)
    assert got[0]  # every spec here fires


def test_fault_grammar_and_env_match_jax():
    assert faults.SITE_TABLE == jfaults.SITE_TABLE
    assert faults.KNOWN_SITES == jfaults.KNOWN_SITES
    for bad in ("", "nosuchsite:1", "io_read", "io_read:0", "io_read:p2",
                "io_read:x"):
        with pytest.raises(ValueError) as want:
            jfaults.plan_from_spec(bad)
        with pytest.raises(ValueError) as got:
            faults.plan_from_spec(bad)
        assert str(got.value) == str(want.value)
    env = {"PCTPU_FAULTS": "io_read:2", "PCTPU_FAULT_SEED": "5"}
    plan = faults.plan_from_env(env)
    assert (plan.seed, set(plan.rules)) == (5, {"io_read"})
    assert faults.plan_from_env({}) is None
    faults.fault_point("io_read")  # no plan: a no-op


def test_every_port_consult_is_a_registered_site():
    consulted = set()
    for py in PORT.rglob("*.py"):
        consulted |= set(re.findall(r"fault_point\(\s*['\"]([a-z_]+)['\"]",
                                    py.read_text()))
    assert consulted >= {"backend_compile", "halo_exchange", "io_read",
                         "checkpoint_write_shard", "checkpoint_write_meta"}
    assert consulted <= faults.KNOWN_SITES


def test_injected_restores_the_previous_plan():
    outer = faults.install_plan("io_read:1")
    with faults.injected("backend_compile:1") as plan:
        with pytest.raises(faults.InjectedFault):
            faults.fault_point("backend_compile")
        assert plan.fired == [("backend_compile", 1)]
    with pytest.raises(faults.InjectedFault):
        faults.fault_point("io_read")
    assert outer.fired == [("io_read", 1)]


# ------------------------------------------------------------------ diskio


@pytest.mark.parametrize("spec", [
    "checkpoint_write_shard=enospc", "checkpoint_write_meta=torn_write",
    "checkpoint_write_shard=eio,checkpoint_write_meta=slow_write"])
def test_disk_modes_parse_and_shape_failures_as_jax(spec, monkeypatch):
    assert diskio.modes_from_spec(spec) == jdiskio.modes_from_spec(spec)
    assert diskio.DISK_SITES == jdiskio.DISK_SITES
    monkeypatch.setattr(diskio, "SLOW_WRITE_S", 0.0)
    monkeypatch.setattr(jdiskio, "SLOW_WRITE_S", 0.0)
    outcomes = []
    for mod, fmod in ((diskio, faults), (jdiskio, jfaults)):
        mod.install_modes(spec)
        with fmod.injected("checkpoint_write_shard:*,"
                           "checkpoint_write_meta:*"):
            got = []
            for site in ("checkpoint_write_shard", "checkpoint_write_meta"):
                try:
                    mod.consult(site)
                    got.append(None)
                except OSError as e:
                    got.append(e.errno)
                except fmod.InjectedFault as e:
                    got.append(("raw", e.site))
        outcomes.append(got)
        mod.uninstall_modes()
    assert outcomes[0] == outcomes[1]
    for bad in ("checkpoint_write_shard", "nosite=eio",
                "wal_fsync=torn_write"):
        with pytest.raises(ValueError):
            diskio.modes_from_spec(bad)


def test_disk_modes_from_env():
    assert diskio.install_from_env(
        {"PCTPU_DISK_MODES": "checkpoint_write_meta=enospc"}) == {
        "checkpoint_write_meta": "enospc"}
    with faults.injected("checkpoint_write_meta:1"):
        with pytest.raises(OSError) as e:
            diskio.consult("checkpoint_write_meta")
    assert e.value.errno == errno.ENOSPC


# ------------------------------------------------------------ classify


def _jax_cases():
    return [RuntimeError("UNAVAILABLE: Socket closed"),
            RuntimeError("DEADLINE_EXCEEDED over tunnel"),
            RuntimeError("RESOURCE_EXHAUSTED: probe OOM"),
            RuntimeError("INTERNAL: Mosaic failed to compile"),
            RuntimeError("INTERNAL: Mosaic ... unsupported vector.shape_cast"),
            TimeoutError(), ConnectionError("reset"),
            ValueError("checkpoint grid [2,2] != [1,4]"),
            ValueError("checkpoint config mismatch"),
            RuntimeError("magic_round_guard MISMATCH"),
            TypeError("bad shape"), KeyError("x"),
            NotImplementedError("later"),
            RuntimeError("some unclassified novelty")]


def test_classify_keeps_the_jax_taxonomy():
    for exc in _jax_cases():
        assert retry.classify(exc) == jretry.classify(exc), exc
    for transient in (True, False):
        assert (retry.classify(faults.InjectedFault("io_read", 1, transient))
                == jretry.classify(jfaults.InjectedFault("io_read", 1,
                                                         transient)))
    assert retry.TERMINAL_MARKERS[:len(jretry.TERMINAL_MARKERS)] == \
        jretry.TERMINAL_MARKERS
    assert retry.TRANSIENT_MARKERS[:len(jretry.TRANSIENT_MARKERS)] == \
        jretry.TRANSIENT_MARKERS


def _launch_error(code):
    try:
        stencil._raise_on(code, "fused_iterate (K2)")
    except RuntimeError as e:
        return e
    raise AssertionError("no error raised")


@pytest.mark.parametrize("code,name,verdict", [
    (1, "cudaErrorInvalidValue", "transient"),
    (2, "cudaErrorMemoryAllocation", "transient"),
    (701, "cudaErrorLaunchOutOfResources", "transient"),
    (700, "cudaErrorIllegalAddress", "terminal"),
    (716, "cudaErrorMisalignedAddress", "terminal"),
    (719, "cudaErrorLaunchFailure", "terminal"),
    (715, "cudaErrorIllegalInstruction", "terminal"),
    (710, "cudaErrorAssert", "terminal"),
])
def test_cuda_errors_are_named_and_classified(code, name, verdict):
    e = _launch_error(code)
    assert str(e) == f"fused_iterate (K2) launch failed: {name} ({code})"
    assert _build.error_text(code) == f"{name} ({code})"
    assert retry.classify(e) == verdict


def test_torch_cuda_errors_and_build_failures_classify():
    T, X = retry.TRANSIENT, retry.TERMINAL
    assert retry.classify(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 12.00 GiB")) == T
    assert retry.classify(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) == X
    assert retry.classify(RuntimeError(
        "CUDA error: unspecified launch failure")) == X
    assert retry.classify(RuntimeError(
        "CUDA error: device-side assert triggered")) == X
    # A build fails the same way on every retry, whatever its text says.
    assert retry.classify(RuntimeError(
        "nvcc failed for csrc/step.cu (exit 1): out of memory")) == X
    assert _build.error_text(12345) == "cudaError_t (12345)"
    assert stencil._raise_on(0, "K1") is None


# --------------------------------------------------------------- retry


def test_with_retry_schedule_and_outcomes_match_jax():
    for policy_kw in ({}, {"max_attempts": 3, "base_delay": 0.1, "seed": 4}):
        assert (retry.RetryPolicy(**policy_kw).delays()
                == jretry.RetryPolicy(**policy_kw).delays())
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("fused_iterate (K2) launch failed: "
                               "cudaErrorMemoryAllocation (2)")
        return "ok"

    assert retry.with_retry(flaky, retry.RetryPolicy(seed=1),
                            sleep=sleeps.append) == "ok"
    assert sleeps == retry.RetryPolicy(seed=1).delays()[:2]
    with pytest.raises(RuntimeError, match="IllegalAddress"):
        retry.with_retry(lambda: stencil._raise_on(700, "K4"),
                         sleep=sleeps.append)
    with pytest.raises(retry.RetryExhausted):
        retry.with_retry(lambda: stencil._raise_on(1, "K4"),
                         retry.RetryPolicy(max_attempts=2),
                         sleep=lambda d: None)


# ------------------------------------------------------------- degrade


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _filters(name):
    jf = jfilters.get_filter(name)
    return jf, convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)


def test_degradation_chains_are_the_jax_ladder_renamed():
    for jname in ("pallas_rdma", "pallas_sep", "pallas", "xla_conv",
                  "separable", "shifted"):
        port = BACKEND_FROM_REFERENCE[jname]
        assert degrade.degradation_chain(port) == tuple(
            BACKEND_FROM_REFERENCE[b]
            for b in jdegrade.degradation_chain(jname))
    assert degrade.degradation_chain("cuda_rdma") == (
        "cuda_rdma", "cuda", "shifted")
    # On the card the kernel tiers stop at cuda: no step runs the plain
    # version in a kernel's place.  The plain tiers keep their step.
    for port, chain in (("cuda_rdma", ("cuda_rdma", "cuda")),
                        ("cuda_sep", ("cuda_sep", "cuda")),
                        ("cuda", ("cuda",)),
                        ("xla_conv", ("xla_conv", "shifted")),
                        ("separable", ("separable", "shifted")),
                        ("shifted", ("shifted",))):
        assert degrade.degradation_chain(port, on_card=True) == chain


@pytest.mark.parametrize("backend,jbackend,grid_shape,storage,fuse", [
    ("cuda", "pallas", (2, 2), "f32", 1),
    ("cuda_rdma", "pallas_rdma", (2, 2), "u8", 2),
    ("cuda_sep", "pallas_sep", (1, 1), "bf16", 3),
])
def test_backend_compile_fault_degrades_bitexact(grey_odd, backend, jbackend,
                                                 grid_shape, storage, fuse):
    jf, tf = _filters("blur3")
    x = grey_odd[None].astype(np.float32)
    want = oracle.run_serial_u8(grey_odd, tf, 5)
    with jfaults.injected("backend_compile:1"):
        xs, valid_hw, _ = jstep._prepare(x, _jax_mesh(grid_shape), 1, storage)
        with pytest.warns(jdegrade.BackendDegradedWarning) as jw:
            jout = jstep.iterate_prepared(xs, jf, 5, _jax_mesh(grid_shape),
                                          valid_hw, backend=jbackend,
                                          fuse=fuse, fallback=True)
    g = mesh.make_grid(grid_shape, "cpu")
    with faults.injected("backend_compile:1") as plan:
        blocks = convert.blocks_from_numpy(x, g, storage)
        with pytest.warns(degrade.BackendDegradedWarning) as w:
            out = step.iterate_prepared(blocks, tf, 5, g, grey_odd.shape,
                                        backend=backend, fuse=fuse,
                                        fallback=True)
    jeff = re.search(r"degraded to '(\w+)'", str(jw[0].message)).group(1)
    eff = re.search(r"degraded to '(\w+)'", str(w[0].message)).group(1)
    assert eff == BACKEND_FROM_REFERENCE[jeff] == degrade.degradation_chain(
        backend)[1]
    assert degrade.effective_for(backend) == eff
    assert plan.fired == [("backend_compile", 1)]
    got = convert.to_numpy(out, grey_odd.shape).astype(np.uint8)[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jout)[0, :grey_odd.shape[0], :grey_odd.shape[1]]
        .astype(np.uint8))


def test_terminal_probe_failure_does_not_degrade():
    _, tf = _filters("blur3")
    g = mesh.make_grid((2, 2), "cpu")
    with faults.injected("backend_compile:1!"):
        with pytest.raises(faults.InjectedFault):
            degrade.resolve_backend(g, tf, "cuda")
    # A lost context on the card is terminal too: no degrade hides it.
    degrade.clear_probe_cache()
    calls = []

    def lost(*args, **kw):
        calls.append(args[2])
        stencil._raise_on(700, "rdma_tiled (K4)")

    orig = degrade._run_probe
    degrade._run_probe = lost
    try:
        with pytest.raises(RuntimeError, match="cudaErrorIllegalAddress"):
            degrade.resolve_backend(g, tf, "cuda_rdma")
    finally:
        degrade._run_probe = orig
    assert calls == ["cuda_rdma"]


def test_refused_launch_degrades_and_every_tier_refused_exhausts():
    _, tf = _filters("blur3")
    g = mesh.make_grid((2, 2), "cpu")
    orig = degrade._run_probe

    def refuse(tiers):
        def probe(grid, filt, backend, *rest):
            if backend in tiers:
                stencil._raise_on(1, f"{backend} launch")
            return orig(grid, filt, backend, *rest)
        return probe

    try:
        degrade._run_probe = refuse({"cuda_rdma"})
        with pytest.warns(degrade.BackendDegradedWarning,
                          match="'cuda_rdma' degraded to 'cuda'"):
            assert degrade.resolve_backend(g, tf, "cuda_rdma") == "cuda"
        degrade.clear_probe_cache()
        degrade._run_probe = refuse({"cuda_rdma", "cuda", "shifted"})
        with pytest.raises(retry.RetryExhausted,
                           match="cudaErrorInvalidValue"):
            degrade.resolve_backend(g, tf, "cuda_rdma")
    finally:
        degrade._run_probe = orig


def test_refused_cuda_on_the_card_raises_instead_of_going_plain(
        monkeypatch):
    _, tf = _filters("blur3")
    # A grid on the card; no tensor is made, since every probe is refused.
    g = mesh.Grid(2, 2, torch.device("cuda"))
    tried = []

    def refuse(grid, filt, backend, *rest):
        tried.append(backend)
        stencil._raise_on(1, f"{backend} launch")

    monkeypatch.setattr(degrade, "_run_probe", refuse)
    with pytest.raises(retry.RetryExhausted,
                       match="cudaErrorInvalidValue") as ei:
        degrade.resolve_backend(g, tf, "cuda_rdma", block_hw=(12, 18))
    assert tried == ["cuda_rdma", "cuda"]
    assert "cudaErrorInvalidValue" in str(ei.value.__cause__)
    # A request for cuda itself: the cached refusal, and nothing below it.
    with pytest.raises(retry.RetryExhausted):
        degrade.resolve_backend(g, tf, "cuda", block_hw=(12, 18))
    assert tried == ["cuda_rdma", "cuda"]


def test_probe_runs_once_per_process(monkeypatch):
    _, tf = _filters("blur3")
    g = mesh.make_grid((2, 2), "cpu")
    runs = []
    orig = degrade._run_probe
    monkeypatch.setattr(degrade, "_run_probe",
                        lambda *a: runs.append(a[2]) or orig(*a))
    assert degrade.resolve_backend(g, tf, "cuda", block_hw=(12, 18)) == "cuda"
    # A plan installed after a passing probe does not re-fire it.
    with faults.injected("backend_compile:*"):
        assert degrade.resolve_backend(g, tf, "cuda",
                                       block_hw=(12, 18)) == "cuda"
    assert runs == ["cuda"]
    # Another block size is another configuration: probed again.
    assert degrade.resolve_backend(g, tf, "cuda", block_hw=(8, 8)) == "cuda"
    assert runs == ["cuda", "cuda"]


def test_probe_runs_the_real_block_and_storage(monkeypatch):
    _, tf = _filters("blur3")
    g = mesh.make_grid((2, 2), "cpu")
    seen = []
    orig = step._build_iterate

    def spy(grid, filt, iters, quantize, valid_hw, block_hw, backend, *a):
        seen.append((iters, tuple(valid_hw), tuple(block_hw), backend))
        return orig(grid, filt, iters, quantize, valid_hw, block_hw,
                    backend, *a)

    monkeypatch.setattr(step, "_build_iterate", spy)
    model = ConvolutionModel("blur3", grid=g, backend="cuda_rdma",
                             storage="u8", fuse=2, fallback=True)
    img = imageio.generate_test_image(25, 37, "rgb", seed=4)
    out = model.run_image(img, 4)
    assert model.effective_backend == "cuda_rdma"
    # The probe: one 2-level chunk on the real 13x19 blocks.
    assert seen[0] == (2, (26, 38), (13, 19), "cuda_rdma")
    np.testing.assert_array_equal(
        out, oracle.run_serial_u8(img, tf, 4))


def test_model_and_bench_record_the_effective_backend(grey_odd):
    _, tf = _filters("blur3")
    g = mesh.make_grid((2, 2), "cpu")
    with faults.injected("backend_compile:1"):
        with pytest.warns(degrade.BackendDegradedWarning):
            model = ConvolutionModel("blur3", grid=g, backend="cuda",
                                     fallback=True)
            got = model.run_image(grey_odd, 2)
    assert model.effective_backend == "shifted"
    np.testing.assert_array_equal(got, oracle.run_serial_u8(grey_odd, tf, 2))
    degrade.clear_probe_cache()
    with faults.injected("backend_compile:1"):
        with pytest.warns(degrade.BackendDegradedWarning):
            row = bench.bench_iterate((32, 32), tf, 2, grid=g,
                                      backend="cuda_rdma", reps=1,
                                      fallback=True)
    assert (row["backend"], row["effective_backend"]) == ("cuda_rdma",
                                                          "cuda")
    assert row["platform"] == "cpu"
    row = bench.bench_iterate((32, 32), tf, 2, grid=g, backend="cuda",
                              reps=1, fallback=True)
    assert row["effective_backend"] == "cuda"


def test_halo_exchange_fault_site(grey_odd):
    _, tf = _filters("blur3")
    x = grey_odd[None].astype(np.float32)
    g = mesh.make_grid((2, 2), "cpu")
    for backend in ("shifted", "cuda_rdma"):
        with faults.injected("halo_exchange:1"):
            with pytest.raises(faults.InjectedFault, match="halo_exchange"):
                step.sharded_iterate(x, tf, 1, grid=g, backend=backend)


def test_converge_fallback_degrades_bitexact():
    jf, tf = _filters("jacobi3")
    x = bench.converge_input((24, 36), 1, 3)
    g = mesh.make_grid((2, 2), "cpu")
    want, wit = step.sharded_converge(x, tf, 1e-3, 40, check_every=5,
                                      grid=g)
    with faults.injected("backend_compile:1"):
        with pytest.warns(degrade.BackendDegradedWarning,
                          match="'cuda_rdma' degraded to 'cuda'"):
            got, it = step.sharded_converge(x, tf, 1e-3, 40, check_every=5,
                                            grid=g, backend="cuda_rdma",
                                            fuse=2, fallback=True)
    assert it == wit
    rtol, atol = stencil.float_tolerance(tf, it, torch.float32)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        frames = list(step.sharded_converge_stream(
            x, tf, 1e-3, 40, check_every=5, grid=g, backend="cuda",
            fallback=True))
    assert frames[-1][1] == wit
