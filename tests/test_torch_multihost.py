"""``parallel/multihost.py`` (the JAX package's multihost shim on
``torch.distributed``) in two processes on the CPU: the gloo group, the
JAX contracts of ``process_info`` / ``barrier`` / ``broadcast_scalar``, and
a grid over the devices of several processes refused as ROADMAP item 10c.
"""

import socket

import pytest
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, port: int, results) -> None:
    import torch.distributed as dist

    from parallel_convolution_tpu_torch.parallel import mesh, multihost

    multihost.initialize(f"localhost:{port}", num_processes=2,
                         process_id=rank, backend="gloo")
    try:
        info = multihost.process_info()
        multihost.barrier()
        agreed = multihost.broadcast_scalar(10.0 + rank)
        try:
            mesh.make_grid(devices="all", device="cpu")
            refused = ""
        except NotImplementedError as e:
            refused = str(e)
        # One device grid per process still works.
        local = mesh.make_grid((1, 2), devices="cpu,cpu").slot_map()
        multihost.barrier("after")
        results[rank] = (info, agreed, refused, local)
    finally:
        dist.destroy_process_group()


def test_two_gloo_processes():
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        results = manager.dict()
        port = _free_port()
        procs = [ctx.Process(target=_worker, args=(r, port, results))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        assert [p.exitcode for p in procs] == [0, 0]
        got = dict(results)
    for rank in (0, 1):
        info, agreed, refused, local = got[rank]
        assert info["process_index"] == rank and info["process_count"] == 2
        assert info["global_devices"] == 2 * info["local_devices"]
        assert agreed == 10.0  # rank 0 wins
        assert "item 10c" in refused and "not ported yet" in refused
        assert local == "cpu,cpu"


@pytest.mark.parametrize("n", [None, 1])
def test_single_process_is_a_no_op(n, monkeypatch):
    from parallel_convolution_tpu_torch.parallel import multihost

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize(num_processes=n)
    assert multihost.process_info()["process_count"] == 1
    multihost.barrier()
    assert multihost.broadcast_scalar(3.0) == 3.0
