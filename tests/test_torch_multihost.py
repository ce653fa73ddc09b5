"""``parallel/multihost.py`` (the JAX package's multihost shim on
``torch.distributed``) in two processes on the CPU: the gloo group, the
JAX contracts of ``process_info`` / ``barrier`` / ``broadcast_scalar``,
and a grid of slots that spans both processes (``make_grid(devices=
"all")``), each rank holding its own blocks: the fixed-count iterate on
every backend that runs there, byte-equal to the oracle; run to
convergence with a NaN planted on rank 1's block, which stops both ranks
after the same chunk; two ranks saving one snapshot at once, each under
temporary names of its own; the JAX package's two-process job
(``tests/_multihost_worker.py``) through ``utils/multihost_job.py``, the
oracle's bytes and a bit-identical resume; and the paths that ran in one
process only until ROADMAP item 10d-i (``cuda_rdma``, the V-cycle,
volumes, ``auto``, ``fallback``) each equal to its one-process run.

The ranks run once a module (``two_ranks``, one spawn of two processes)
and the tests read their rows; the job spawns its own two.
"""

import numpy as np
import pytest
import torch.multiprocessing as mp

from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.utils import imageio, multihost_job

ITERATE_BACKENDS = ("shifted", "xla_conv", "separable", "cuda", "cuda_sep")
# The paths item 10d-i brought across processes.
REFUSED = ("cuda_rdma", "multigrid", "volumes", "auto", "fallback")
IMG_SEED, ITERS = 5, 3


def _img():
    return imageio.generate_test_image(13, 19, "rgb", seed=IMG_SEED)


def _ported_paths() -> dict:
    """What ran in one process only until item 10d-i, each a call on a
    grid returning a field."""
    from parallel_convolution_tpu_torch.parallel import step
    from parallel_convolution_tpu_torch.solvers import multigrid
    from parallel_convolution_tpu_torch.volumes import driver

    x = imageio.interleaved_to_planar(_img()).astype(np.float32)
    blur3, jacobi3 = get_filter("blur3"), get_filter("jacobi3")
    vol = np.random.default_rng(4).random((2, 4, 8, 8), dtype=np.float32)
    return {
        "cuda_rdma": lambda g: step.sharded_iterate(
            x, blur3, 2, grid=g, backend="cuda_rdma"),
        "multigrid": lambda g: multigrid.mg_converge(x, jacobi3, 1e-3, 10,
                                                     grid=g)[0],
        "volumes": lambda g: driver.volume_iterate(vol, "fd7", 1, grid=g),
        "auto": lambda g: step.sharded_iterate(x, blur3, 2, grid=g,
                                               backend="auto"),
        "fallback": lambda g: step.sharded_iterate(x, blur3, 2, grid=g,
                                                   fallback=True),
    }


def _checks(rank: int, port: int, work: str):
    """Everything one rank does in the shared spawn; returns its row."""
    import os

    import torch

    from parallel_convolution_tpu_torch.parallel import mesh, multihost, step
    from parallel_convolution_tpu_torch.utils import checkpoint

    from parallel_convolution_tpu_torch.obs import events, metrics

    # Both ranks append to one event log, each its own seq stream.
    metrics.set_enabled(True)
    events.configure(os.path.join(os.path.dirname(work), "events.jsonl"))
    multihost.initialize(f"localhost:{port}", num_processes=2,
                         process_id=rank)
    row = {"info": multihost.process_info(), "backend": multihost.backend(),
           "pid": os.getpid()}
    multihost.barrier()
    row["agreed"] = multihost.broadcast_scalar(10.0 + rank)
    # One grid per process still works beside the spanning one.
    row["local"] = mesh.make_grid((1, 2), devices="cpu,cpu").slot_map()
    grid = mesh.make_grid((2, 2), devices="all", device="cpu")
    row["grid"] = (grid.slot_map(), grid.owners, grid.rank,
                   grid.spans_processes, str(grid.device))
    x = imageio.interleaved_to_planar(_img()).astype(np.float32)
    blur3, jacobi3 = get_filter("blur3"), get_filter("jacobi3")
    row["iterate"] = {}
    for backend in ITERATE_BACKENDS:
        for fuse in (1, 2):
            out = step.sharded_iterate(x, blur3, ITERS, grid=grid,
                                       backend=backend, fuse=fuse)
            row["iterate"][backend, fuse] = out.numpy()
    row["refused"] = {what: call(grid).numpy()
                      for what, call in _ported_paths().items()}
    # A NaN in rank 1's half (grid rows split H: rank 1 holds block row 1).
    field = np.random.default_rng(2).standard_normal((1, 16, 12)).astype(
        np.float32)
    field[0, 12, 3] = np.nan
    row["nan_stream"] = [(done, diff) for _, done, diff in
                         step.sharded_converge_stream(
                             field, jacobi3, 1e-9, 40, check_every=4,
                             grid=grid)]
    row["nan_done"] = step.sharded_converge(field, jacobi3, 1e-9, 40,
                                            check_every=4, grid=grid)[1]
    # The clean field: every chunk's diff as one process computes it.
    field[0, 12, 3] = 0.0
    row["converge"] = [(done, diff) for _, done, diff in
                       step.sharded_converge_stream(
                           field, jacobi3, 1e-2, 40, check_every=4,
                           grid=grid)]
    # Two ranks saving one snapshot at once: every rename's source logged.
    blocks = mesh.split_blocks(torch.from_numpy(x[:, :12, :18].copy()), grid)
    renamed = []
    real_replace = checkpoint.os.replace

    def logged(src, dst):
        renamed.append(os.path.basename(str(src)))
        return real_replace(src, dst)

    checkpoint.os.replace = logged
    try:
        for it in (1, 2, 3):
            checkpoint.save_state(work, blocks, {"iters_done": it,
                                                 "grid": [2, 2],
                                                 "shape": [3, 12, 18]},
                                  grid)
    finally:
        checkpoint.os.replace = real_replace
    row["renamed"] = renamed
    loaded, meta = checkpoint.load_state(work, grid)
    row["reloaded"] = all(torch.equal(loaded[i][j], b)
                          for (i, j), b in mesh.local_blocks(blocks))
    row["loaded_none"] = [[b is None for b in r] for r in loaded]
    row["meta_shards"] = sorted(meta["shards"])
    multihost.barrier("after")
    events.deconfigure()
    return row


def _worker(rank: int, port: int, work: str, results) -> None:
    import torch.distributed as dist

    try:
        results[rank] = _checks(rank, port, work)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        results = manager.dict()
        port = multihost_job.free_port()
        procs = [ctx.Process(target=_worker,
                             args=(r, port, str(work / "ckpt"), results))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
        assert [p.exitcode for p in procs] == [0, 0]
        got = {r: dict(results[r]) for r in range(2)}
    return got, work / "ckpt"


def test_two_gloo_processes(two_ranks):
    got, _ = two_ranks
    for rank in (0, 1):
        row = got[rank]
        info = row["info"]
        assert info["process_index"] == rank and info["process_count"] == 2
        assert info["global_devices"] == 2 * info["local_devices"]
        assert row["backend"] == "gloo"  # no card: gloo by default
        assert row["agreed"] == 10.0  # rank 0 wins
        assert row["local"] == "cpu,cpu"


def test_grid_of_slots_spans_both_processes(two_ranks):
    got, _ = two_ranks
    for rank in (0, 1):
        slots, owners, grid_rank, spans, dev = got[rank]["grid"]
        assert slots == "cpu,cpu,cpu,cpu" and owners == (0, 0, 1, 1)
        assert (grid_rank, spans, dev) == (rank, True, "cpu")


@pytest.mark.parametrize("backend", ITERATE_BACKENDS)
@pytest.mark.parametrize("fuse", [1, 2])
def test_iterate_across_processes_is_the_oracle(two_ranks, backend, fuse):
    got, _ = two_ranks
    want = imageio.interleaved_to_planar(
        oracle.run_serial_u8(_img(), get_filter("blur3"), ITERS))
    for rank in (0, 1):
        np.testing.assert_array_equal(got[rank]["iterate"][backend, fuse],
                                      want.astype(np.float32))


@pytest.mark.parametrize("what", REFUSED)
def test_one_process_paths_name_item_10d(two_ranks, what):
    # Refused naming item 10d until it was ported (10d-i): each path now
    # gives both ranks its one-process run's bits (the V-cycle's jacobi3
    # and the blur3 / fd7 paths agree exactly on the plain versions).
    from parallel_convolution_tpu_torch.parallel import mesh

    got, _ = two_ranks
    want = _ported_paths()[what](
        mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu")).numpy()
    for rank in (0, 1):
        np.testing.assert_array_equal(got[rank]["refused"][what], want)


def test_nan_on_rank_1_stops_every_rank_after_the_same_chunk(two_ranks):
    got, _ = two_ranks
    for rank in (0, 1):
        stream = got[rank]["nan_stream"]
        assert len(stream) == 1 and stream[0][0] == 4
        assert np.isnan(stream[0][1])
        assert got[rank]["nan_done"] == 4


def test_converge_across_processes_matches_one_process(two_ranks):
    from parallel_convolution_tpu_torch.parallel import step

    got, _ = two_ranks
    field = np.random.default_rng(2).standard_normal((1, 16, 12)).astype(
        np.float32)
    field[0, 12, 3] = 0.0
    want = [(done, diff) for _, done, diff in step.sharded_converge_stream(
        field, get_filter("jacobi3"), 1e-2, 40, check_every=4,
        device="cpu")]
    assert got[0]["converge"] == got[1]["converge"] == want


def test_concurrent_saves_share_no_temp_file(two_ranks):
    got, ckpt = two_ranks
    names = [set(got[r]["renamed"]) for r in (0, 1)]
    assert names[0] and names[1] and not names[0] & names[1]
    # Rank 0 alone writes the meta and flips the pointer.
    assert any(n.startswith("meta.json.") for n in names[0])
    assert not any(n.startswith(("meta.json", "LATEST")) for n in names[1])
    assert not list(ckpt.rglob("*.tmp"))
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "LATEST", "it_00000002", "it_00000003"]
    for rank in (0, 1):
        assert got[rank]["reloaded"]
        assert got[rank]["meta_shards"] == [f"shard_{r}_{c}.npy"
                                            for r in (0, 1) for c in (0, 1)]
        assert got[rank]["loaded_none"] == [[rank == 1] * 2, [rank == 0] * 2]


def test_two_ranks_share_one_event_log(two_ranks):
    from parallel_convolution_tpu_torch.obs import events, report

    got, ckpt = two_ranks
    log = ckpt.parent / "events.jsonl"
    recs = events.read_events(log)
    seqs = {}
    for r in recs:
        assert events.validate_event(r) == []
        seqs.setdefault(r["pid"], []).append(r["seq"])
    pids = {got[rank]["pid"]: rank for rank in (0, 1)}
    assert set(seqs) == set(pids)
    for stream in seqs.values():   # monotone, gap-free per pid
        assert stream == list(range(1, len(stream) + 1))
    assert report.summarize_events(recs)["seq_gaps"] == 0
    for pid, rank in pids.items():
        mine = [r for r in recs if r["pid"] == pid]
        saves = [r for r in mine if r["kind"] == "checkpoint_save"]
        assert [r["iters_done"] for r in saves] == [1, 2, 3]
        # Each rank's save counts the two shards it wrote (block row rank).
        own = sum((ckpt / "it_00000003" / f"shard_{rank}_{c}.npy")
                  .stat().st_size for c in (0, 1))
        assert all(r["shards"] == 2 for r in saves)
        assert saves[-1]["bytes"] == own
        assert sum(r["kind"] == "exchange" for r in mine) >= len(
            ITERATE_BACKENDS) * 2


def test_multihost_worker_job_is_the_oracles_bytes(tmp_path):
    rows = multihost_job.spawn(2, tmp_path, timeout=300, device="cpu",
                               backend="shifted")
    want = oracle.run_serial_u8(
        imageio.generate_test_image(37, 53, "grey", seed=3),
        get_filter("blur3"), 4)
    np.testing.assert_array_equal(
        imageio.read_raw(tmp_path / "out.raw", 37, 53, "grey"), want)
    for rank, row in enumerate(rows):
        assert row["rank"] == rank and row["owners"] == [0, 0, 1, 1]
        assert row["resume_bitexact"] is True and row["broadcast"] == 7.0
        assert row["process_count"] == 2


@pytest.mark.parametrize("col_mode", ["strided", "packed"])
def test_multihost_job_runs_cuda_rdma_multigrid_and_volume(tmp_path,
                                                           col_mode):
    # The job's cuda_rdma leg over two ranks (its plain version on the
    # CPU), and its V-cycle and volume legs: the oracle's bytes, and the
    # legs' outputs the one-process runs' bits on 2x2 slots.
    import hashlib

    import torch

    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.solvers import multigrid
    from parallel_convolution_tpu_torch.volumes import driver

    rows = multihost_job.spawn(2, tmp_path, timeout=300, device="cpu",
                               backend="cuda_rdma", fuse=2,
                               col_mode=col_mode,
                               legs=("multigrid", "volume"))
    want = oracle.run_serial_u8(
        imageio.generate_test_image(37, 53, "grey", seed=3),
        get_filter("blur3"), 4)
    np.testing.assert_array_equal(
        imageio.read_raw(tmp_path / "out.raw", 37, 53, "grey"), want)
    slots = mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu")
    rng = np.random.default_rng(3)
    field = rng.standard_normal((1, 37, 53)).astype(np.float32)
    mg, _ = multigrid.mg_converge(field, get_filter("jacobi3"), 1e-3, 40,
                                  grid=slots, backend="cuda_rdma",
                                  col_mode=col_mode)
    vol = driver.volume_iterate(rng.random((2, 8, 37, 53), dtype=np.float32),
                                "fd7", 3, grid=slots)

    def sha(t):
        return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()

    for row in rows:
        assert row["resume_bitexact"] is True
        assert row["multigrid"]["sha256"] == sha(mg)
        assert row["volume"]["sha256"] == sha(vol)
        assert isinstance(mg, torch.Tensor)


@pytest.mark.parametrize("n", [None, 1])
def test_single_process_is_a_no_op(n, monkeypatch):
    from parallel_convolution_tpu_torch.parallel import multihost

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize(num_processes=n)
    assert multihost.process_info()["process_count"] == 1
    multihost.barrier()
    assert multihost.broadcast_scalar(3.0) == 3.0


@pytest.mark.parametrize("cuda,cards,want", [
    (False, 0, "gloo"), (True, 1, "gloo"), (True, 2, "nccl")])
def test_initialize_picks_gloo_when_ranks_share_a_card(monkeypatch, cuda,
                                                       cards, want):
    import torch
    import torch.distributed as dist

    from parallel_convolution_tpu_torch.parallel import multihost

    import datetime

    seen = {}
    monkeypatch.setattr(multihost, "_dist", lambda: None)
    monkeypatch.setattr(multihost, "_LOCAL_RANK", None)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.update(bound=torch.device(d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    multihost.initialize("localhost:1234", num_processes=2, process_id=1)
    want_kw = {"backend": want, "init_method": "tcp://localhost:1234",
               "world_size": 2, "rank": 1}
    if want == "nccl":
        # One card a process: rank 1 of the host's two binds cuda:1, and
        # the group times out rather than hang on a mismatched order.
        card = torch.device("cuda", 1)
        want_kw.update(bound=card, device_id=card,
                       timeout=datetime.timedelta(
                           seconds=multihost.NCCL_TIMEOUT_S))
    assert seen == want_kw


@pytest.mark.parametrize("entry", ["job", "main"])
def test_job_runs_on_the_card_unless_asked(entry, monkeypatch, tmp_path):
    # Like the port's other entry points the job defaults to the card, and
    # raises where there is none rather than run the plain path on the host.
    import torch

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "job":
            multihost_job.job(None, 1, None, tmp_path)
        else:
            multihost_job.main(["--work", str(tmp_path)])


@pytest.mark.parametrize("save", ["sharded_io", "checkpoint"])
def test_saving_another_ranks_holes_needs_the_grid(save, tmp_path):
    # Blocks with None entries are one rank's share: which rank writes the
    # shared file comes from the grid, never from the holes.
    import torch

    from parallel_convolution_tpu_torch.utils import checkpoint, sharded_io

    blocks = [[torch.zeros((1, 4, 4)), None]]
    with pytest.raises(ValueError, match="grid="):
        if save == "sharded_io":
            sharded_io.save_sharded(tmp_path / "o.raw", blocks, 4, 8, "grey")
        else:
            checkpoint.save_state(tmp_path / "ck", blocks,
                                  {"iters_done": 1, "grid": [1, 2],
                                   "shape": [1, 4, 8]})
    assert not list(tmp_path.iterdir())
