"""One card a process (ROADMAP item 10d-ii-b) rehearsed on the CPU: four
gloo processes with the device transport forced (``multihost.transport``
patched to ``"device"`` in each child after it joins the group: the slabs
sent as the tensors themselves in one batched round, ordered by tag,
every tag 0, so that gloo matches a pair's messages by order alone, as
NCCL does), a 2x2 grid with one slot a rank.  The ranks
run ``shifted``, the plain versions of ``cuda``, ``cuda_sep`` and
``cuda_rdma`` (strided, packed, overlapped; on 4x4 too, a row of slots a
rank, and periodic: a pair of ranks carrying several slabs a phase, whose
order then matters), a converge with a NaN on
one rank, the V-cycle, a volume, the job's checkpoint save and resume
with its sharded load and save, a reshard, the engine and the CLI's
``run --device all``, each against the port's one-process run and the
oracle, and ``cuda_rdma`` against the JAX package's ``pallas_rdma`` in
interpret mode where that interpreter exists.

Without a spawn: the default backend over a host's cards and processes
and the job's size, the slot placement one card a process, and for every
pair of ranks the sender's slab order against the receiver's in
``halo.exchange_per_block``'s two phases and in the far exchange's plan.

The ranks run once a module (``ranks``) and the tests read their rows.
Against the port's own one-process runs every result is compared bit for
bit; against JAX as ``tests/test_torch_processes.py`` does.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.utils import imageio, multihost_job

RANKS, SHAPE = 4, (2, 2)
IMG_SEED, ITERS = 11, 3
RDMA_CASES = [(col_mode, overlap) for col_mode in ("strided", "packed")
              for overlap in (False, True)]
VOLUME_SHAPE = (2, 4, 8, 8)
JOB = dict(rows=21, cols=26, mode="grey", iters=4, every=2,
           backend="cuda_rdma", fuse=2)


def _img():
    return imageio.generate_test_image(14, 18, "rgb", seed=IMG_SEED)


def _planar():
    return imageio.interleaved_to_planar(_img()).astype(np.float32)


def _field(nan: bool = False):
    f = np.random.default_rng(6).standard_normal((1, 16, 12)).astype(
        np.float32)
    if nan:
        f[0, 12, 9] = np.nan  # rank 3's block
    return f


def _volume():
    return np.random.default_rng(8).random(VOLUME_SHAPE, dtype=np.float32)


def _legs(grid, grid16, x) -> dict:
    """The legs every rank runs on ``grid`` (and the parent on one
    process's 2x2 CPU slots), keyed by name; ``grid16`` is 4x4, a row of
    slots a rank, where one pair of ranks carries several slabs a phase
    (as a periodic boundary makes it on 2x2), so that their order
    matters."""
    from parallel_convolution_tpu_torch.parallel import step
    from parallel_convolution_tpu_torch.solvers import multigrid
    from parallel_convolution_tpu_torch.volumes import driver

    blur3, jacobi3 = get_filter("blur3"), get_filter("jacobi3")
    out = {
        "shifted": step.sharded_iterate(x, blur3, ITERS, grid=grid,
                                        backend="shifted"),
        "cuda": step.sharded_iterate(x, blur3, ITERS, grid=grid,
                                     backend="cuda", fuse=1),
        "cuda_sep": step.sharded_iterate(x, blur3, ITERS, grid=grid,
                                         backend="cuda_sep", storage="bf16",
                                         fuse=2),
    }
    for cm, ov in RDMA_CASES:
        out["rdma", cm, ov] = step.sharded_iterate(
            x, blur3, ITERS, grid=grid, backend="cuda_rdma", storage="u8",
            fuse=2, col_mode=cm, overlap=ov)
    for cm in ("strided", "packed"):
        out["rdma 4x4", cm] = step.sharded_iterate(
            x, blur3, ITERS, grid=grid16, backend="cuda_rdma",
            storage="u8", fuse=2, col_mode=cm)
    out["cuda 4x4"] = step.sharded_iterate(x, blur3, ITERS, grid=grid16,
                                           backend="cuda", fuse=2)
    for backend in ("shifted", "cuda_rdma"):
        out["periodic", backend] = step.sharded_iterate(
            x, blur3, ITERS, grid=grid, backend=backend, fuse=2,
            boundary="periodic")
    img, iters = step.sharded_converge(
        _field(nan=True), jacobi3, 1e-2, 40, check_every=4, grid=grid,
        backend="cuda_rdma", fuse=2)
    out["nan_converge"] = (img, iters)
    out["converge"] = step.sharded_converge(
        _field(), jacobi3, 1e-2, 40, check_every=4, grid=grid,
        backend="cuda_rdma", fuse=2)
    mg, res = multigrid.mg_converge(_field(), jacobi3, 1e-3, 30, grid=grid,
                                    backend="cuda_rdma")
    out["multigrid"] = (mg, res.cycles, res.level_grids, res.residuals)
    out["volume"] = driver.volume_iterate(_volume(), "fd7", 3, grid=grid,
                                          fuse=2)
    return {k: (tuple(t.numpy() if torch.is_tensor(t) else t for t in v)
                if isinstance(v, tuple) else v.numpy())
            for k, v in out.items()}


def _rank_checks(rank: int, port: int, work: str) -> dict:
    """Everything one rank does in the shared spawn; returns its row."""
    import contextlib
    import io

    from parallel_convolution_tpu_torch.cli import main as cli_main
    from parallel_convolution_tpu_torch.parallel import mesh, multihost, step
    from parallel_convolution_tpu_torch.serving.engine import WarmEngine

    os.environ[step.OVERLAP_INTERPRET_ENV] = "1"
    multihost.initialize(f"localhost:{port}", num_processes=RANKS,
                         process_id=rank, backend="gloo")
    # The NCCL form's transport over this gloo group (as
    # tests/test_torch_processes.py patches ``backend``).
    multihost.transport = lambda: "device"
    grid = mesh.make_grid(SHAPE, devices="all", device="cpu")
    x = _planar()
    row = {"owners": grid.owners, "transport": multihost.transport(),
           "legs": _legs(grid, mesh.make_grid((4, 4), devices="all",
                                              device="cpu"), x)}
    # The job: a sharded load, a checkpointed iterate (this rank's shards),
    # a sharded save, a resume from the last snapshot, the broadcast.
    job = multihost_job.job(rank, RANKS, None, os.path.join(work, "job"),
                            device="cpu", shape=SHAPE, **JOB)
    row["job"] = (job["resume_bitexact"], job["broadcast"])
    # A reshard onto 1x4 and 4x2 over the same ranks, filled on every rank.
    blocks, valid_hw, _ = step._prepare(torch.from_numpy(x), grid, "f32")
    row["reshard"] = {}
    for shape in ((1, 4), (4, 2)):
        g2 = mesh.grid_like(grid, shape)
        moved = step.reshard_prepared(blocks, valid_hw, g2, src_grid=grid)
        full = multihost.fill_blocks(moved, g2.owners)
        row["reshard"][shape] = (g2.owners, mesh.join_blocks(full).numpy())
    # The engine: every rank the same calls in the same order.
    eng = WarmEngine(grid, fallback=False)
    key = eng.key_for((3, 14, 18), filter_name="blur3", iters=ITERS,
                      backend="cuda_rdma", storage="u8", fuse=2)
    got, info = eng.run_batch(key, np.stack([x, x[::-1].copy()]))
    row["engine"] = (got, info["effective_backend"])
    # The CLI's `run --device all` (its slots cpu here: no card).
    real_spec = mesh.grid_from_spec

    def cpu_all(spec, device=None):
        if device != "all":
            return real_spec(spec, device)
        shape = tuple(int(v) for v in spec.split("x"))
        return mesh.make_grid(shape, devices="all", device="cpu")

    src, dst = os.path.join(work, "in.raw"), os.path.join(work, "out.raw")
    if rank == 0:
        imageio.write_raw(src, _img())
    multihost.barrier("input-written")
    mesh.grid_from_spec = cpu_all
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli_main(["run", src, "14", "18", str(ITERS), "rgb", "-o",
                           dst, "--backend", "cuda_rdma", "--device", "all",
                           "--mesh", "2x2", "--fuse", "2"])
    finally:
        mesh.grid_from_spec = real_spec
    row["cli"] = (rc, err.getvalue(), imageio.read_raw(dst, 14, 18, "rgb"))
    multihost.barrier("done")
    return row


def _worker(rank: int, port: int, work: str, results) -> None:
    import torch.distributed as dist

    try:
        results[rank] = _rank_checks(rank, port, work)
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        results[rank] = {"error": f"{type(e).__name__}: {e}"}
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("cards")
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        results = manager.dict()
        port = multihost_job.free_port()
        procs = [ctx.Process(target=_worker,
                             args=(r, port, str(work), results))
                 for r in range(RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(400)
        for p in procs:
            if p.is_alive():
                p.kill()
        rows = {r: dict(results.get(r, {"error": "no result"}))
                for r in range(RANKS)}
        assert [p.exitcode for p in procs] == [0] * RANKS, rows
        return rows


@pytest.fixture(scope="module")
def one():
    """The same legs in one process on 2x2 CPU slots."""
    from parallel_convolution_tpu_torch.parallel import mesh, step

    old = os.environ.get(step.OVERLAP_INTERPRET_ENV)
    os.environ[step.OVERLAP_INTERPRET_ENV] = "1"
    try:
        return _legs(mesh.make_grid(SHAPE, devices="cpu,cpu,cpu,cpu"),
                     mesh.make_grid((4, 4), devices=["cpu"] * 16),
                     _planar())
    finally:
        if old is None:
            del os.environ[step.OVERLAP_INTERPRET_ENV]
        else:
            os.environ[step.OVERLAP_INTERPRET_ENV] = old


def _oracle_planar():
    return imageio.interleaved_to_planar(oracle.run_serial_u8(
        _img(), get_filter("blur3"), ITERS)).astype(np.float32)


def test_ranks_hold_one_slot_each_on_the_device_transport(ranks):
    for r in range(RANKS):
        assert ranks[r]["owners"] == (0, 1, 2, 3)
        assert ranks[r]["transport"] == "device"


LEGS = (["shifted", "cuda", "cuda_sep", "cuda 4x4"]
        + [("rdma", cm, ov) for cm, ov in RDMA_CASES]
        + [("rdma 4x4", cm) for cm in ("strided", "packed")])


@pytest.mark.parametrize("leg", LEGS, ids=str)
def test_iterate_is_one_process_and_the_oracle(ranks, one, leg):
    np.testing.assert_array_equal(one[leg], _oracle_planar())
    for r in range(RANKS):
        np.testing.assert_array_equal(ranks[r]["legs"][leg], one[leg])


def test_periodic_is_one_process(ranks, one):
    # Two slabs a pair a phase (the left and the right neighbour are one
    # rank): each lands in its own ghost only if both sides order them
    # alike.
    for backend in ("shifted", "cuda_rdma"):
        for r in range(RANKS):
            np.testing.assert_array_equal(
                ranks[r]["legs"]["periodic", backend],
                one["periodic", backend])
    np.testing.assert_array_equal(one["periodic", "cuda_rdma"],
                                  one["periodic", "shifted"])


def test_cuda_rdma_is_the_jax_rdma_kernel(ranks):
    # The JAX package's pallas_rdma on a 2x2 mesh in interpret mode, as
    # tests/test_rdma.py runs it (skipped where that interpreter is
    # missing): the four ranks give its bytes.
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
    for r in range(RANKS):
        for cm, ov in RDMA_CASES:
            np.testing.assert_array_equal(ranks[r]["legs"]["rdma", cm, ov],
                                          want)


def test_converge_with_a_nan_rank_stops_every_rank(ranks, one):
    # Rank 3's block holds a NaN: the reduced diff is NaN on every rank,
    # so all stop after the same chunk, with one process's field.
    img, iters = one["nan_converge"]
    assert np.isnan(img).any() and iters < 40
    for r in range(RANKS):
        got, done = ranks[r]["legs"]["nan_converge"]
        assert done == iters
        np.testing.assert_array_equal(got, img)
        got, done = ranks[r]["legs"]["converge"]
        assert done == one["converge"][1]
        np.testing.assert_array_equal(got, one["converge"][0])


def test_multigrid_and_volume_are_one_process(ranks, one):
    # jacobi3's dyadic taps make the V-cycle one process's bits; the
    # volume's same eager ops likewise.
    mg, cycles, grids, residuals = one["multigrid"]
    for r in range(RANKS):
        got = ranks[r]["legs"]["multigrid"]
        np.testing.assert_array_equal(got[0], mg)
        assert (got[1], got[2], got[3]) == (cycles, grids, residuals)
        np.testing.assert_array_equal(ranks[r]["legs"]["volume"],
                                      one["volume"])


def test_checkpoint_resume_and_sharded_io(ranks, tmp_path):
    # The job's sharded save is the oracle's bytes, its resume bit-exact
    # on every rank, the broadcast rank 0's.
    work = tmp_path / "one"
    out = multihost_job.job(None, 1, None, work, device="cpu", shape=SHAPE,
                            **JOB)
    img = imageio.generate_test_image(JOB["rows"], JOB["cols"], "grey",
                                      seed=3)
    want = oracle.run_serial_u8(img, get_filter("blur3"), JOB["iters"])
    assert out["resume_bitexact"]
    np.testing.assert_array_equal(
        imageio.read_raw(work / "out.raw", JOB["rows"], JOB["cols"], "grey"),
        want)
    for r in range(RANKS):
        assert ranks[r]["job"] == (True, 7.0)


@pytest.mark.parametrize("shape", [(1, 4), (4, 2)])
def test_reshard_is_one_process(ranks, shape):
    from parallel_convolution_tpu_torch.parallel import mesh, step

    x = torch.from_numpy(_planar())
    blocks, valid_hw, _ = step._prepare(
        x, mesh.make_grid(SHAPE, devices="cpu,cpu,cpu,cpu"), "f32")
    n = shape[0] * shape[1]
    want = mesh.join_blocks(step.reshard_prepared(
        blocks, valid_hw, mesh.make_grid(shape, devices=["cpu"] * n))
    ).numpy()
    owners = tuple(r for r in range(RANKS) for _ in range(n // RANKS))
    for r in range(RANKS):
        got_owners, full = ranks[r]["reshard"][shape]
        assert got_owners == owners
        np.testing.assert_array_equal(full, want)


def test_engine_and_cli_are_the_oracle(ranks):
    x = _planar()
    want = np.stack([_oracle_planar(),
                     imageio.interleaved_to_planar(oracle.run_serial_u8(
                         imageio.planar_to_interleaved(
                             x[::-1].astype(np.uint8)),
                         get_filter("blur3"), ITERS)).astype(np.float32)])
    img = oracle.run_serial_u8(_img(), get_filter("blur3"), ITERS)
    for r in range(RANKS):
        got, eff = ranks[r]["engine"]
        assert eff == "cuda_rdma"
        np.testing.assert_array_equal(got, want)
        rc, err, out = ranks[r]["cli"]
        assert rc == 0, err
        np.testing.assert_array_equal(out, img)


# ------------------------------------------------------- without a spawn

@pytest.mark.parametrize("cards,local,world,want", [
    (0, None, 2, "gloo"),      # no card
    (1, None, 2, "gloo"),      # two ranks would share the card
    (2, None, 2, "nccl"),      # a card each
    (4, None, 2, "nccl"),
    (2, None, 4, "gloo"),      # spawned on one host: four ranks, two cards
    (4, 4, 8, "nccl"),         # torchrun --nnodes 2 --nproc-per-node 4
    (4, 8, 8, "gloo"),         # eight ranks on a four-card host
    (8, 4, 16, "nccl"),
])
def test_default_backend_counts_the_hosts_processes(cards, local, world,
                                                    want):
    from parallel_convolution_tpu_torch.parallel import multihost

    env = {} if local is None else {"LOCAL_WORLD_SIZE": str(local)}
    procs = multihost.host_processes(world, env)
    assert procs == (world if local is None else local)
    assert multihost.default_backend(cards, procs) == want


@pytest.mark.parametrize("env,rank,world,want", [
    ({"LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "4"}, 7, 8, 3),
    ({"LOCAL_WORLD_SIZE": "4"}, 6, 8, 2),
    ({}, 1, 2, 1),
])
def test_local_rank_is_the_hosts_index(env, rank, world, want):
    from parallel_convolution_tpu_torch.parallel import multihost

    assert multihost.local_rank(rank, world, env) == want


@pytest.mark.parametrize("n,shape", [(2, None), (4, None), (4, (4, 4)),
                                     (2, (2, 4))])
def test_slot_placement_one_card_a_process(monkeypatch, n, shape):
    # Under NCCL every slot of rank r lies on r's own card, and a grid
    # made from it by an "RxC" spec keeps that; gloo's round-robin over
    # the host's cards from cuda:0 stays for a gloo group.
    from parallel_convolution_tpu_torch.parallel import mesh, multihost

    cards = [(q + 1) % n for q in range(n)]  # LOCAL_RANK need not be q
    for rank in range(n):
        monkeypatch.setattr(multihost, "process_info", lambda: {
            "process_index": rank, "process_count": n, "local_devices": 1,
            "global_devices": n})
        monkeypatch.setattr(multihost, "one_card_a_process", lambda: True)
        monkeypatch.setattr(multihost, "card",
                            lambda: torch.device("cuda", cards[rank]))
        monkeypatch.setattr(multihost, "gather_object", lambda _: cards)
        monkeypatch.setattr(mesh, "resolve_device", lambda d: d)
        grid = mesh._process_grid(shape, None)
        r, c = shape or mesh.dims_create(n)
        assert grid.shape == (r, c)
        k = r * c // n
        assert grid.owners == tuple(s // k for s in range(r * c))
        assert grid.slots == tuple(torch.device("cuda", cards[s // k])
                                   for s in range(r * c))
        assert grid.device == torch.device("cuda", cards[rank])
        assert grid.local_devices == (torch.device("cuda", cards[rank]),)
        for spec in ((1, n), (n, 2)):
            g2 = mesh.grid_like(grid, spec)
            assert all(d == torch.device("cuda", cards[o])
                       for d, o in zip(g2.slots, g2.owners))
    gloo = mesh._spread(2, 2, range(2), [torch.device("cuda", i)
                                         for i in range(4)], 0)
    assert [d.index for d in gloo.slots] == [0, 1, 0, 1]


GRIDS = [((2, 2), (0, 1, 2, 3)), ((2, 2), (0, 0, 1, 1)),
         ((2, 2), (0, 1, 0, 1)), ((4, 4), tuple(s // 4 for s in range(16))),
         ((3, 2), (0, 0, 1, 1, 2, 2)), ((2, 4), (0, 1, 0, 1, 0, 1, 0, 1))]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("shape,owners", GRIDS)
def test_halo_slab_order_agrees_for_every_pair(monkeypatch, shape, owners,
                                               boundary, packed):
    # exchange_per_block on each rank with multihost.swap recording its
    # lists: for every pair (a, b) and each phase, a's sends to b in wire
    # order are b's receives from a in wire order, slab for slab (tag,
    # shape, dtype), so NCCL's order-only matching pairs each slab with
    # its own ghost.
    from parallel_convolution_tpu_torch.parallel import halo, mesh, multihost

    R, Cg = shape
    n = max(owners) + 1
    phases = {}
    for rank in range(n):
        seen = []
        monkeypatch.setattr(halo, "_swap",
                            lambda s, r, seen=seen: seen.append((s, r)))
        grid = mesh.Grid(R, Cg, devices=("cpu",) * (R * Cg), owners=owners,
                         rank=rank)
        blocks = [[torch.zeros((2, 5, 6)) if owners[i * Cg + j] == rank
                   else None for j in range(Cg)] for i in range(R)]
        halo.exchange_per_block(blocks, 2, shape, boundary, packed=packed,
                                grid=grid)
        phases[rank] = seen

    def wire(items, peer):
        return [(tag, tuple(t.shape), t.dtype)
                for q, tag, t in multihost.wire_order(items) if q == peer]

    assert all(len(p) == 2 for p in phases.values())
    for ph in (0, 1):
        for a in range(n):
            for b in range(n):
                if a == b:
                    continue
                sent = wire(phases[a][ph][0], b)
                got = wire(phases[b][ph][1], a)
                assert sent == got, (ph, a, b)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("shape,owners", GRIDS)
def test_far_exchange_plan_agrees_for_every_pair(shape, owners, boundary,
                                                 staged):
    # The far exchange's plan on every rank, each rank a host of its own:
    # what rank a copies out for b is, slab for slab and in order, what b
    # copies in from a, so one buffer a pair carries the bytes where the
    # reader looks for them.
    import types

    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.parallel import channels

    n = max(owners) + 1
    table = channels.neighbour_table(shape, boundary)
    plans = {}
    for rank in range(n):
        run = types.SimpleNamespace(table=table, block_shape=(2, 6, 7))
        ex = types.SimpleNamespace(
            run=run, owners=owners, rank=rank, plans={},
            ranks=[q for q in range(n) if q != rank])
        plans[rank] = rdma._FarExchange.plan(ex, 3, staged)
    for a in range(n):
        for b in range(n):
            if a != b:
                assert plans[a][0][b] == plans[b][1][a], (a, b)


def test_wire_order_sorts_by_peer_then_tag():
    from parallel_convolution_tpu_torch.parallel import multihost

    items = [(2, 9, "a"), (1, 7, "b"), (2, 3, "c"), (1, 1, "d")]
    assert [x for _, _, x in multihost.wire_order(items)] == ["d", "b", "c",
                                                              "a"]


@pytest.mark.parametrize("group", [None, "gloo", "nccl"])
def test_job_takes_the_groups_default_unless_asked(monkeypatch, tmp_path,
                                                   group):
    # The job joins the group with the default backend (NCCL where the
    # host has a card for each rank), or the one its caller names: gloo
    # for ranks that share a card.
    from parallel_convolution_tpu_torch.parallel import multihost

    class Joined(Exception):
        pass

    seen = {}

    def initialize(*a, **kw):
        seen.update(kw)
        raise Joined

    monkeypatch.setattr(multihost, "initialize", initialize)
    with pytest.raises(Joined):
        multihost_job.job(0, 2, 1234, tmp_path, device="cpu", group=group)
    assert seen == {"num_processes": 2, "process_id": 0, "backend": group}
