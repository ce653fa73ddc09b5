"""The paths of a grid over processes (ROADMAP items 10d-i and 10d-ii-a)
in two gloo processes on the CPU: ``cuda_rdma`` (its plain version per
rank after a gloo exchange of the rims: strided and packed, fuse 1 and 2,
the overlapped schedule with its missed-wait detector), ``auto``,
``fallback=True``, ``reshard_prepared`` / ``mesh.reblock`` / ``grid_like``,
the V-cycle, volumes and the warm engine, each against the oracle, the
one-process port and the JAX package on the same seeded input; the same
legs with the ranks reporting two hosts; and item 10d-ii-b's form (an
NCCL group) running through its grid and the CLI, its slabs on the device
transport.  Without a spawn: the mirror plan of a
neighbour on another host (``rdma.mirror_plan`` / ``far_slabs``) covers
what a launch and a pack read.

The ranks run once a module (``ranks``: one spawn of two processes) and
the tests read their rows.  Against the port's own one-process runs every
result is compared bit for bit (u8 / quantize runs, and float runs whose
plain versions round alike on every rank); against JAX the V-cycle is
held to ``multigrid.float_tolerance`` (``ops/stencil.float_tolerance``
over its stencil applications) and the volume to ``atol=1e-5`` (within
the 2e-5 of ``test_torch_volumes.py``: XLA on the CPU may contract a
multiply and an add the port rounds twice).
"""

import os

import numpy as np
import pytest
import torch.multiprocessing as mp

from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.utils import imageio, multihost_job

IMG_SEED, ITERS = 5, 3
RDMA_CASES = [(fuse, col_mode, overlap) for fuse in (1, 2)
              for col_mode in ("strided", "packed")
              for overlap in (False, True)]
FAR_CASES = [(storage, col_mode) for storage in ("u8", "bf16")
             for col_mode in ("strided", "packed")]
VOLUME_SHAPE = (2, 4, 8, 8)
RESHARD = ((1, 2), (4, 2))


def _img():
    return imageio.generate_test_image(13, 19, "rgb", seed=IMG_SEED)


def _planar():
    return imageio.interleaved_to_planar(_img()).astype(np.float32)


def _field():
    return np.random.default_rng(2).standard_normal((1, 16, 12)).astype(
        np.float32)


def _volume():
    return np.random.default_rng(4).random(VOLUME_SHAPE, dtype=np.float32)


def _rank_checks(rank: int, port: int, work: str) -> dict:
    """Everything one rank does in the shared spawn; returns its row."""
    import warnings

    import torch

    from parallel_convolution_tpu_torch.parallel import mesh, multihost, step
    from parallel_convolution_tpu_torch.resilience import faults
    from parallel_convolution_tpu_torch.serving.engine import WarmEngine
    from parallel_convolution_tpu_torch.solvers import multigrid
    from parallel_convolution_tpu_torch import tuning
    from parallel_convolution_tpu_torch.volumes import driver

    os.environ[step.OVERLAP_INTERPRET_ENV] = "1"
    multihost.initialize(f"localhost:{port}", num_processes=2,
                         process_id=rank)
    grid = mesh.make_grid((2, 2), devices="all", device="cpu")
    x = _planar()
    blur3, jacobi3 = get_filter("blur3"), get_filter("jacobi3")
    row = {}
    row["rdma"] = {
        (fuse, cm, ov): step.sharded_iterate(
            x, blur3, ITERS, grid=grid, backend="cuda_rdma", fuse=fuse,
            col_mode=cm, overlap=ov).numpy()
        for fuse, cm, ov in RDMA_CASES}
    # A float run: the plain K3 / K4 against the one-process port.
    row["rdma_float"] = step.sharded_iterate(
        _field(), jacobi3, 4, grid=grid, backend="cuda_rdma", fuse=2,
        quantize=False, col_mode="packed").numpy()
    row["rdma_converge"] = step.sharded_converge(
        _field(), jacobi3, 1e-2, 40, check_every=4, grid=grid,
        backend="cuda_rdma", fuse=2)[0].numpy()
    # auto: rank 0 resolves, every rank takes its Resolution.
    out = step.sharded_iterate(x, blur3, ITERS, grid=grid, backend="auto")
    row["auto"] = (out.numpy(), tuning.last_resolution())
    # fallback: a fault planted on rank 1's first probe (cuda_rdma) moves
    # both ranks to the rung rank 1 reached.
    if rank == 1:
        faults.install_plan("backend_compile:1")
    from parallel_convolution_tpu_torch.models import ConvolutionModel

    model = ConvolutionModel("blur3", grid=grid, backend="cuda_rdma",
                             fallback=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = model.run_planar(x, ITERS)
    faults.install_plan(None)
    row["fallback"] = (out.numpy(), model.effective_backend,
                       [str(w.message) for w in caught
                        if "degraded" in str(w.message)])
    # Reshard: 2x2 over 2 ranks onto 1x2 and 4x2 over the same ranks.
    blocks, valid_hw, _ = step._prepare(torch.from_numpy(x), grid, "f32")
    row["reshard"] = {}
    for shape in RESHARD:
        g2 = mesh.grid_like(grid, shape)
        moved = step.reshard_prepared(blocks, valid_hw, g2, src_grid=grid)
        full = multihost.fill_blocks(moved, g2.owners)
        row["reshard"][shape] = (g2.owners, [[b is None for b in r]
                                             for r in moved],
                                 mesh.join_blocks(full).numpy())
    # The V-cycle and volumes.
    out, res = multigrid.mg_converge(_field(), jacobi3, 1e-3, 30, grid=grid,
                                     backend="cuda_rdma")
    row["multigrid"] = (out.numpy(), res.cycles, res.level_grids,
                        res.residuals)
    out, res = multigrid.mg_converge(_field(), jacobi3, 1e-3, 30, grid=grid)
    row["multigrid_shifted"] = out.numpy()
    row["volume"] = driver.volume_iterate(_volume(), "fd7", 3, grid=grid,
                                          fuse=2).numpy()
    row["volume_converge"] = driver.volume_converge(
        _volume(), "fd7", tol=1e-9, max_iters=6, check_every=3,
        grid=grid)[0].numpy()
    # The engine: every rank the same calls in the same order.
    eng = WarmEngine(grid, fallback=False)
    key = eng.key_for((3, 13, 19), filter_name="blur3", iters=ITERS,
                      backend="cuda_rdma", storage="u8", fuse=2)
    batch = np.stack([x, x[::-1].copy()])
    out, info = eng.run_batch(key, batch)
    compiles = eng.stats["compiles"]
    reshaped = eng.reshape("1x2")
    key2 = eng.key_for((3, 13, 19), filter_name="blur3", iters=ITERS,
                       backend="cuda_rdma", storage="u8", fuse=2)
    out2, _ = eng.run_batch(key2, batch)
    row["engine"] = (out, info["effective_backend"], out2, reshaped,
                     eng.stats["compiles"] - compiles,
                     eng.grid.owners)
    ckey = eng.key_for((1, 16, 12), filter_name="jacobi3", iters=4,
                       backend="cuda_rdma", quantize=False, fuse=2)
    row["engine_converge"] = [
        (img, done, diff) for img, done, diff, _ in eng.run_converge(
            ckey, _field(), tol=1e-2, max_iters=40, check_every=4)][-1]
    # Item 10d-ii-a: the same legs with the ranks reporting different
    # hosts, as two hosts' ranks do (on the CPU every path runs its plain
    # version over gloo, whatever the hosts).
    real = multihost.hostname
    multihost.hostname = lambda: f"host{rank}"
    try:
        row["far"] = _far_legs(rank, grid, x)
    finally:
        multihost.hostname = real
    # Item 10d-ii-b's form: the group reports nccl, so the slabs take the
    # device transport (on the CPU gloo carries them, every tag 0, matched
    # by order alone), and the CLI's `--device all` grid runs over it (its
    # slots cpu here: the card's half runs on the chip).
    real_backend, real_spec = multihost.backend, mesh.grid_from_spec

    def cpu_all(spec, device=None):
        if device != "all":
            return real_spec(spec, device)
        shape = tuple(int(v) for v in spec.split("x"))
        return mesh.make_grid(shape, devices="all", device="cpu")

    multihost.backend = lambda: "nccl"
    mesh.grid_from_spec = cpu_all
    try:
        g = mesh.make_grid((2, 2), devices="all", device="cpu")
        row["nccl"] = (g.owners, multihost.transport(), step.sharded_iterate(
            x, blur3, ITERS, grid=g, backend="cuda_rdma", fuse=2,
            col_mode="packed").numpy())
        import contextlib
        import io

        from parallel_convolution_tpu_torch.cli import main as cli_main

        src = os.path.join(work, "in.raw")
        if rank == 0:
            imageio.write_raw(src, _img())
        multihost.barrier("input-written")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli_main(["run", src, "13", "19", str(ITERS), "rgb", "-o",
                           os.path.join(work, "out.raw"), "--backend",
                           "cuda_rdma", "--device", "all", "--mesh", "2x2"])
        row["nccl_cli"] = (rc, err.getvalue(), imageio.read_raw(
            os.path.join(work, "out.raw"), 13, 19, "rgb"))
    finally:
        multihost.backend, mesh.grid_from_spec = real_backend, real_spec
    multihost.barrier("done")
    return row


def _far_legs(rank: int, grid, x) -> dict:
    """One rank's legs between two reported hosts (the spawn's second
    half): ``cuda_rdma`` u8 and bf16, strided and packed, overlapped, a
    float converge, ``auto``, ``fallback=True``, the V-cycle, a volume and
    the engine."""
    import warnings

    from parallel_convolution_tpu_torch import tuning
    from parallel_convolution_tpu_torch.models import ConvolutionModel
    from parallel_convolution_tpu_torch.parallel import multihost, step
    from parallel_convolution_tpu_torch.resilience import degrade, faults
    from parallel_convolution_tpu_torch.serving.engine import WarmEngine
    from parallel_convolution_tpu_torch.solvers import multigrid
    from parallel_convolution_tpu_torch.volumes import driver

    blur3, jacobi3 = get_filter("blur3"), get_filter("jacobi3")
    far = {"hosts": multihost.hosts_of(multihost.peer_records({}))}
    for storage, cm in FAR_CASES:
        far[storage, cm] = step.sharded_iterate(
            x, blur3, ITERS, grid=grid, backend="cuda_rdma", fuse=2,
            storage=storage, col_mode=cm).numpy()
    far["overlap"] = step.sharded_iterate(
        x, blur3, ITERS, grid=grid, backend="cuda_rdma", fuse=2,
        storage="u8", col_mode="strided", overlap=True).numpy()
    far["converge"] = step.sharded_converge(
        _field(), jacobi3, 1e-2, 40, check_every=4, grid=grid,
        backend="cuda_rdma", fuse=2)
    far["converge"] = (far["converge"][0].numpy(), far["converge"][1])
    out = step.sharded_iterate(x, blur3, ITERS, grid=grid, backend="auto")
    far["auto"] = (out.numpy(), tuning.last_resolution())
    degrade.clear_probe_cache()  # the first half's verdicts
    if rank == 1:
        faults.install_plan("backend_compile:1")
    model = ConvolutionModel("blur3", grid=grid, backend="cuda_rdma",
                             fallback=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = model.run_planar(x, ITERS)
    faults.install_plan(None)
    far["fallback"] = (out.numpy(), model.effective_backend,
                       [str(w.message) for w in caught
                        if "degraded" in str(w.message)])
    out, res = multigrid.mg_converge(_field(), jacobi3, 1e-3, 30, grid=grid,
                                     backend="cuda_rdma")
    far["multigrid"] = (out.numpy(), res.cycles, res.residuals)
    far["volume"] = driver.volume_iterate(_volume(), "fd7", 3, grid=grid,
                                          fuse=2).numpy()
    eng = WarmEngine(grid, fallback=False)
    key = eng.key_for((3, 13, 19), filter_name="blur3", iters=ITERS,
                      backend="cuda_rdma", storage="u8", fuse=2)
    out, info = eng.run_batch(key, np.stack([x, x[::-1].copy()]))
    far["engine"] = (out, info["effective_backend"])
    return far


def _worker(rank: int, port: int, work: str, results) -> None:
    import torch.distributed as dist

    try:
        results[rank] = _rank_checks(rank, port, work)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("procs")
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        results = manager.dict()
        port = multihost_job.free_port()
        procs = [ctx.Process(target=_worker,
                             args=(r, port, str(work), results))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(400)
        for p in procs:
            if p.is_alive():
                p.kill()
        assert [p.exitcode for p in procs] == [0, 0]
        return {r: dict(results[r]) for r in range(2)}


def _oracle_planar(filt="blur3", iters=ITERS):
    return imageio.interleaved_to_planar(oracle.run_serial_u8(
        _img(), get_filter(filt), iters)).astype(np.float32)


@pytest.mark.parametrize("fuse,col_mode,overlap", RDMA_CASES)
def test_cuda_rdma_across_processes_is_the_oracle_and_one_process(
        ranks, fuse, col_mode, overlap, monkeypatch):
    from parallel_convolution_tpu_torch.parallel import mesh, step

    monkeypatch.setenv(step.OVERLAP_INTERPRET_ENV, "1")
    one = step.sharded_iterate(
        _planar(), get_filter("blur3"), ITERS,
        grid=mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu"),
        backend="cuda_rdma", fuse=fuse, col_mode=col_mode,
        overlap=overlap).numpy()
    np.testing.assert_array_equal(one, _oracle_planar())
    for r in (0, 1):
        np.testing.assert_array_equal(ranks[r]["rdma"][fuse, col_mode,
                                                       overlap], one)


def test_cuda_rdma_float_and_converge_across_processes(ranks):
    # jacobi3's taps are dyadic: the plain levels give one process's bits.
    from parallel_convolution_tpu_torch.parallel import mesh, step

    jacobi3 = get_filter("jacobi3")
    slots = mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu")
    one = step.sharded_iterate(_field(), jacobi3, 4, grid=slots,
                               backend="cuda_rdma", fuse=2, quantize=False,
                               col_mode="packed").numpy()
    conv = step.sharded_converge(_field(), jacobi3, 1e-2, 40, check_every=4,
                                 grid=slots, backend="cuda_rdma",
                                 fuse=2)[0].numpy()
    for r in (0, 1):
        np.testing.assert_array_equal(ranks[r]["rdma_float"], one)
        np.testing.assert_array_equal(ranks[r]["rdma_converge"], conv)


def test_cuda_rdma_across_processes_is_the_jax_rdma_kernel(ranks):
    # The JAX package's pallas_rdma on a 2x2 mesh in interpret mode, as
    # tests/test_rdma.py runs it (skipped where that interpreter is
    # missing), on the same input: the port's two ranks give its bytes.
    import jax

    from parallel_convolution_tpu.ops import filters as jfilters
    from parallel_convolution_tpu.parallel import mesh as jmesh
    from parallel_convolution_tpu.parallel import step as jstep
    from parallel_convolution_tpu.utils import jax_compat

    if not jax_compat.HAS_TPU_INTERPRET:
        pytest.skip("DMA-faithful TPU interpret mode unavailable in this jax")
    want = np.asarray(jstep.sharded_iterate(
        _planar(), jfilters.get_filter("blur3"), ITERS,
        mesh=jmesh.make_grid_mesh(jax.devices()[:4], (2, 2)),
        quantize=True, backend="pallas_rdma"))
    for r in (0, 1):
        np.testing.assert_array_equal(ranks[r]["rdma"][1, "strided", False],
                                      want)
        np.testing.assert_array_equal(ranks[r]["rdma"][2, "packed", False],
                                      want)


def test_auto_across_processes_holds_one_resolution(ranks):
    (a, res0), (b, res1) = ranks[0]["auto"], ranks[1]["auto"]
    assert res0 == res1
    np.testing.assert_array_equal(a, _oracle_planar())
    np.testing.assert_array_equal(b, _oracle_planar())


def test_fallback_agrees_on_the_furthest_rung(ranks):
    from tests._torch_jax_state import reset_jax_state

    reset_jax_state()
    for r in (0, 1):
        out, eff, warned = ranks[r]["fallback"]
        # Rank 1's cuda_rdma probe failed (transient): both run 'cuda'.
        assert eff == "cuda"
        assert warned and "'cuda_rdma' degraded to 'cuda'" in warned[0]
        np.testing.assert_array_equal(out, _oracle_planar())


@pytest.mark.parametrize("shape", RESHARD)
def test_reshard_prepared_across_processes_is_one_process(ranks, shape):
    import torch

    from parallel_convolution_tpu_torch.parallel import mesh, step

    x = torch.from_numpy(_planar())
    one = mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu")
    blocks, valid_hw, _ = step._prepare(x, one, "f32")
    n = shape[0] * shape[1]
    target = mesh.make_grid(shape, devices=",".join(["cpu"] * n))
    want = mesh.join_blocks(step.reshard_prepared(blocks, valid_hw,
                                                  target)).numpy()
    owners = tuple(r for r in (0, 1) for _ in range(n // 2))
    for r in (0, 1):
        got_owners, holes, full = ranks[r]["reshard"][shape]
        assert got_owners == owners
        assert holes == [[owners[i * shape[1] + j] != r
                          for j in range(shape[1])] for i in range(shape[0])]
        np.testing.assert_array_equal(full, want)


def test_multigrid_across_processes(ranks):
    # Within the float tolerance of one process and of JAX mg_converge on
    # the same field (the same V-cycle; jacobi3's dyadic taps make the
    # port's own runs agree bit for bit).
    import jax

    from parallel_convolution_tpu.ops import filters as jfilters
    from parallel_convolution_tpu.parallel import mesh as jmesh
    from parallel_convolution_tpu.solvers import multigrid as jmg
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.solvers import multigrid

    jacobi3 = get_filter("jacobi3")
    slots = mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu")
    one, res = multigrid.mg_converge(_field(), jacobi3, 1e-3, 30, grid=slots,
                                     backend="cuda_rdma")
    jout, jres = jmg.mg_converge(
        _field(), jfilters.get_filter("jacobi3"), 1e-3, 30,
        mesh=jmesh.make_grid_mesh(jax.devices()[:4], (2, 2)))
    rtol, atol = multigrid.float_tolerance(jacobi3, jres.cycles,
                                           float(np.abs(jout).max()))
    assert res.cycles == jres.cycles
    for r in (0, 1):
        out, cycles, grids, residuals = ranks[r]["multigrid"]
        assert (cycles, grids, residuals) == (res.cycles, res.level_grids,
                                              res.residuals)
        np.testing.assert_array_equal(out, one.numpy())
        np.testing.assert_allclose(out, np.asarray(jout), rtol=rtol,
                                   atol=atol)
        np.testing.assert_array_equal(ranks[r]["multigrid_shifted"],
                                      one.numpy())


def test_volumes_across_processes(ranks):
    # Bit-equal to one process, and within the float tolerance of JAX
    # volume_iterate (the same eager ops; fd7's taps are not dyadic).
    import jax

    from parallel_convolution_tpu.parallel import mesh as jmesh
    from parallel_convolution_tpu.volumes import driver as jdriver
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.volumes import driver

    slots = mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu")
    one = driver.volume_iterate(_volume(), "fd7", 3, grid=slots,
                                fuse=2).numpy()
    conv = driver.volume_converge(_volume(), "fd7", tol=1e-9, max_iters=6,
                                  check_every=3, grid=slots)[0].numpy()
    want = np.asarray(jdriver.volume_iterate(
        _volume(), "fd7", 3, mesh=jmesh.make_grid_mesh(jax.devices()[:4],
                                                       (2, 2)), fuse=2))
    for r in (0, 1):
        np.testing.assert_array_equal(ranks[r]["volume"], one)
        np.testing.assert_array_equal(ranks[r]["volume_converge"], conv)
        np.testing.assert_allclose(ranks[r]["volume"], want, rtol=0,
                                   atol=1e-5)


def test_engine_across_processes(ranks):
    x = _planar()
    want = [_oracle_planar(),
            imageio.interleaved_to_planar(oracle.run_serial_u8(
                imageio.planar_to_interleaved(x[::-1].astype(np.uint8)),
                get_filter("blur3"), ITERS)).astype(np.float32)]
    for r in (0, 1):
        out, eff, out2, reshaped, new_compiles, owners = ranks[r]["engine"]
        assert eff == "cuda_rdma"
        np.testing.assert_array_equal(out, np.stack(want))
        np.testing.assert_array_equal(out2, np.stack(want))
        assert reshaped["grid"] == (1, 2) and reshaped["rewarmed"] == 1
        assert new_compiles == 2 and owners == (0, 1)


def test_engine_converge_across_processes(ranks):
    from parallel_convolution_tpu_torch.parallel import mesh, step

    want, iters = step.sharded_converge(
        _field(), get_filter("jacobi3"), 1e-2, 40, check_every=4,
        grid=mesh.make_grid((1, 2), devices="cpu,cpu"), backend="cuda_rdma",
        fuse=2)
    for r in (0, 1):
        img, done, _ = ranks[r]["engine_converge"]
        assert done == iters
        np.testing.assert_array_equal(img, want.numpy())


def test_item_10d_ii_is_refused(ranks):
    # Item 10d-ii-b, refused here until it was ported: an NCCL group (one
    # card a process).  Nothing refuses it now: its grid runs cuda_rdma
    # over the device transport, and the CLI's `run --device all` over it,
    # each the oracle's bytes.
    want = oracle.run_serial_u8(_img(), get_filter("blur3"), ITERS)
    for r in (0, 1):
        owners, transport, out = ranks[r]["nccl"]
        assert owners == (0, 0, 1, 1) and transport == "device"
        np.testing.assert_array_equal(out, _oracle_planar())
        rc, err, got = ranks[r]["nccl_cli"]
        assert rc == 0 and "10d-ii-b" not in err, err
        np.testing.assert_array_equal(got, want)


def test_cpu_grid_over_two_hosts_runs(ranks):
    # Refused until item 10d-ii-a: the ranks report two hosts, and
    # cuda_rdma on their CPU grid runs (its rims over gloo).
    for r in (0, 1):
        far = ranks[r]["far"]
        assert far["hosts"] == ["host0", "host1"]
        assert far["u8", "strided"].shape == _planar().shape


@pytest.mark.parametrize("storage,col_mode", FAR_CASES)
def test_cuda_rdma_between_hosts_is_the_oracle_and_one_process(
        ranks, storage, col_mode):
    from parallel_convolution_tpu_torch.parallel import mesh, step

    one = step.sharded_iterate(
        _planar(), get_filter("blur3"), ITERS,
        grid=mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu"),
        backend="cuda_rdma", fuse=2, storage=storage,
        col_mode=col_mode).numpy()
    np.testing.assert_array_equal(one, _oracle_planar())
    for r in (0, 1):
        np.testing.assert_array_equal(ranks[r]["far"][storage, col_mode],
                                      one)


def test_cuda_rdma_between_hosts_is_the_jax_rdma_kernel(ranks):
    # As test_cuda_rdma_across_processes_is_the_jax_rdma_kernel: the JAX
    # package's pallas_rdma on a 2x2 mesh in interpret mode.
    import jax

    from parallel_convolution_tpu.ops import filters as jfilters
    from parallel_convolution_tpu.parallel import mesh as jmesh
    from parallel_convolution_tpu.parallel import step as jstep
    from parallel_convolution_tpu.utils import jax_compat

    if not jax_compat.HAS_TPU_INTERPRET:
        pytest.skip("DMA-faithful TPU interpret mode unavailable in this jax")
    want = np.asarray(jstep.sharded_iterate(
        _planar(), jfilters.get_filter("blur3"), ITERS,
        mesh=jmesh.make_grid_mesh(jax.devices()[:4], (2, 2)),
        quantize=True, backend="pallas_rdma"))
    for r in (0, 1):
        for key in FAR_CASES + ["overlap"]:
            got = ranks[r]["far"][key]
            np.testing.assert_array_equal(got, want)


def test_overlap_and_converge_between_hosts(ranks, monkeypatch):
    # The overlapped schedule against one process's; the float converge
    # (jacobi3's dyadic taps: one process's bits) the same stop and field.
    from parallel_convolution_tpu_torch.parallel import mesh, step

    monkeypatch.setenv(step.OVERLAP_INTERPRET_ENV, "1")
    slots = mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu")
    one = step.sharded_iterate(
        _planar(), get_filter("blur3"), ITERS, grid=slots,
        backend="cuda_rdma", fuse=2, storage="u8", col_mode="strided",
        overlap=True).numpy()
    conv, iters = step.sharded_converge(
        _field(), get_filter("jacobi3"), 1e-2, 40, check_every=4,
        grid=slots, backend="cuda_rdma", fuse=2)
    for r in (0, 1):
        far = ranks[r]["far"]
        np.testing.assert_array_equal(far["overlap"], one)
        np.testing.assert_array_equal(far["overlap"], _oracle_planar())
        out, done = far["converge"]
        assert done == iters
        np.testing.assert_array_equal(out, conv.numpy())


def test_auto_and_fallback_between_hosts(ranks):
    from tests._torch_jax_state import reset_jax_state

    reset_jax_state()
    assert ranks[0]["far"]["auto"][1] == ranks[1]["far"]["auto"][1]
    for r in (0, 1):
        np.testing.assert_array_equal(ranks[r]["far"]["auto"][0],
                                      _oracle_planar())
        out, eff, warned = ranks[r]["far"]["fallback"]
        assert eff == "cuda"
        assert warned and "'cuda_rdma' degraded to 'cuda'" in warned[0]
        np.testing.assert_array_equal(out, _oracle_planar())


def test_multigrid_volume_and_engine_between_hosts(ranks):
    # Bit-equal to the same legs on one host (the spawn's first half),
    # which the tests above hold against one process, the oracle and JAX
    # (multigrid within multigrid.float_tolerance, the volume within
    # atol=1e-5 of JAX volume_iterate).
    x = _planar()
    want = np.stack([_oracle_planar(),
                     imageio.interleaved_to_planar(oracle.run_serial_u8(
                         imageio.planar_to_interleaved(
                             x[::-1].astype(np.uint8)),
                         get_filter("blur3"), ITERS)).astype(np.float32)])
    for r in (0, 1):
        far, near = ranks[r]["far"], ranks[r]
        out, cycles, residuals = far["multigrid"]
        np.testing.assert_array_equal(out, near["multigrid"][0])
        assert (cycles, residuals) == (near["multigrid"][1],
                                       near["multigrid"][3])
        np.testing.assert_array_equal(far["volume"], near["volume"])
        out, eff = far["engine"]
        assert eff == "cuda_rdma"
        np.testing.assert_array_equal(out, want)


# --------------------- the mirror plan of a neighbour on another host

# (filter, fuse): ghost depth 1 (blur3 x 1) and r*T = 4 (gaussian5 x 2).
MIRROR_DEPTHS = [("blur3", 1), ("gaussian5", 2)]
MIRROR_GRIDS = [(2, 2), (3, 3), (1, 3), (3, 1), (2, 3)]


def _mirror_blocks(grid_shape, seed=0):
    import torch

    R, Cg = grid_shape
    g = torch.Generator().manual_seed(seed)
    return [[torch.rand((2, 6, 7), generator=g) * 255 for _ in range(Cg)]
            for _ in range(R)]


def _mirror_of(block, plan, stage=None, d=0):
    """A far block as a mirror holds it: NaN but for the plan's slices
    (and, packed, its staging's planned sides)."""
    import torch

    m = torch.full_like(block, float("nan"))
    for r0, r1, c0, c1 in plan.rects:
        m[:, r0:r1, c0:c1] = block[:, r0:r1, c0:c1]
    st = None
    if stage is not None:
        st = torch.full_like(stage, float("nan"))
        for side in plan.sides:
            st[side] = stage[side]
    return m, st


def _staged_window(flat, stages, table, s, shape, d):
    """Block ``s``'s level-0 window as K3 reads it with the packed column
    transport: its rows' ghosts from the upper and lower blocks (the
    interior columns), its column ghosts, corners included, from the left
    and right neighbours' staging (side 1 of the left one, 0 of the
    right one), zeros where there is no neighbour."""
    import torch

    C, h, w = shape
    p = torch.zeros((C, h + 2 * d, w + 2 * d))
    p[:, d:d + h, d:d + w] = flat[s]
    for di, rows, src in ((-1, slice(0, d), slice(h - d, h)),
                          (1, slice(d + h, h + 2 * d), slice(0, d))):
        n = table[s][(di + 1) * 3 + 1]
        if n >= 0:
            p[:, rows, d:d + w] = flat[n][:, src, :]
    for dj, cols, side in ((-1, slice(0, d), 1),
                           (1, slice(d + w, w + 2 * d), 0)):
        n = table[s][4 + dj]
        if n >= 0:
            p[:, :, cols] = stages[n][side]
    return p


@pytest.mark.parametrize("filt,fuse", MIRROR_DEPTHS)
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("grid_shape", MIRROR_GRIDS)
def test_mirror_plan_covers_what_a_launch_reads(grid_shape, boundary, filt,
                                                fuse):
    # Every neighbour n of every block s in turn replaced by a mirror
    # filled from mirror_plan(s, n) alone (NaN elsewhere): the plain K3 /
    # K4 gives s the bytes it gives reading the real blocks, strided; and
    # packed, s's window read through the stagings (rows from the upper
    # and lower blocks, columns from the staging sides) and s's own pack
    # are the halo exchange's and the plain pack's.
    import torch

    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.parallel import channels, halo

    R, Cg = grid_shape
    f = get_filter(filt)
    d = f.radius * fuse
    blocks = _mirror_blocks(grid_shape)
    shape = tuple(blocks[0][0].shape)
    table = channels.neighbour_table(grid_shape, boundary)
    valid = (R * shape[1] - 1, Cg * shape[2] - 2)  # ragged last blocks
    kw = dict(boundary=boundary, quantize=False, fuse=fuse,
              valid_hw=valid)
    want = rdma.fused_rdma_step_plain(blocks, f, grid_shape, **kw)
    padded = halo.halo_exchange(blocks, d, grid_shape, boundary)
    stages = rdma.rdma_pack_plain(blocks, grid_shape, boundary, d)
    flat = [b for row in blocks for b in row]
    packed = Cg > 1
    for s in range(R * Cg):
        i, j = divmod(s, Cg)
        for n in sorted(set(table[s]) - {-1, s}):
            plan = rdma.mirror_plan(table, s, n, shape, d)
            seen = [list(row) for row in blocks]
            seen[n // Cg][n % Cg] = _mirror_of(flat[n], plan)[0]
            got = rdma.fused_rdma_step_plain(seen, f, grid_shape, **kw)
            assert torch.equal(got[i][j], want[i][j]), (s, n, plan)
            assert plan.sides == ()
            if not packed:
                continue
            plan = rdma.mirror_plan(table, s, n, shape, d, packed=True)
            mirror, stage = _mirror_of(flat[n], plan, stages[n], d)
            seen_flat = list(flat)
            seen_flat[n] = mirror
            seen_stages = list(stages)
            seen_stages[n] = stage
            window = _staged_window(seen_flat, seen_stages, table, s, shape,
                                    d)
            assert torch.equal(window, padded[i][j]), (s, n, plan)
            own = rdma.rdma_pack_plain(
                [seen_flat[k * Cg:(k + 1) * Cg] for k in range(R)],
                grid_shape, boundary, d)[s]
            assert torch.equal(own, stages[s]), (s, n, plan)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("grid_shape,owners", [
    ((2, 2), (0, 0, 1, 1)), ((2, 2), (0, 1, 0, 1)), ((2, 2), (0, 1, 2, 3)),
    ((4, 4), (0,) * 8 + (1,) * 8), ((3, 2), (0, 0, 1, 1, 2, 2))])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_far_slabs_fill_a_ranks_mirrors(grid_shape, owners, boundary,
                                        packed):
    # Each rank's mirrors of the other ranks' slots filled from
    # far_slabs(reader=rank, owner) alone (the list the owner copies out
    # for that reader, and the reader copies in): its blocks' plain K3 /
    # K4 (strided) or their windows and packs through the stagings
    # (packed) are the real ones.
    import torch

    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.parallel import channels, halo

    R, Cg = grid_shape
    f = get_filter("gaussian5")
    fuse, d = 2, 4
    blocks = _mirror_blocks(grid_shape, seed=3)
    shape = tuple(blocks[0][0].shape)
    table = channels.neighbour_table(grid_shape, boundary)
    valid = (R * shape[1], Cg * shape[2] - 1)
    kw = dict(boundary=boundary, quantize=False, fuse=fuse, valid_hw=valid)
    want = rdma.fused_rdma_step_plain(blocks, f, grid_shape, **kw)
    padded = halo.halo_exchange(blocks, d, grid_shape, boundary)
    stages = rdma.rdma_pack_plain(blocks, grid_shape, boundary, d)
    flat = [b for row in blocks for b in row]
    packed = packed and Cg > 1
    ranks = sorted(set(owners))
    for a in ranks:
        seen, seen_stages = list(flat), list(stages)
        for b in ranks:
            if b == a:
                continue
            slabs = rdma.far_slabs(table, owners, a, b, shape, d, packed)
            assert all(owners[n] == b and (p.rects or p.sides)
                       for n, p in slabs)
            for n in range(len(flat)):
                if owners[n] == b:
                    plan = dict(slabs).get(n, rdma.MirrorPlan((), ()))
                    seen[n], st = _mirror_of(flat[n], plan, stages[n], d)
                    seen_stages[n] = st
        mine = [s for s, o in enumerate(owners) if o == a]
        if packed:
            for s in mine:
                i, j = divmod(s, Cg)
                window = _staged_window(seen, seen_stages, table, s, shape,
                                        d)
                assert torch.equal(window, padded[i][j]), (a, s)
            packs = rdma.rdma_pack_plain(
                [seen[k * Cg:(k + 1) * Cg] for k in range(R)], grid_shape,
                boundary, d)
            for s in mine:
                assert torch.equal(packs[s], stages[s]), (a, s)
        else:
            got = rdma.fused_rdma_step_plain(
                [seen[k * Cg:(k + 1) * Cg] for k in range(R)], f,
                grid_shape, **kw)
            for s in mine:
                i, j = divmod(s, Cg)
                assert torch.equal(got[i][j], want[i][j]), (a, s)
