"""The card's counterparts of the JAX package's three probe scripts (TPU
kernel 5), one module each, all three kernels in ``csrc/probes.cu``:

* :mod:`.op_price` (5a, ``op_chain``) prices the operations the cost model
  counts: the f32 FMA rate sets ``tuning.costmodel.H100.flop_gops`` and the
  rint row the quantize price;
* :mod:`.smem_budget` (5b, ``smem_probe``) finds what launches the card
  accepts around its shared-memory limits: the legality the tuner's search
  enumerates;
* :mod:`.rdma_ladder` (5c, ``rdma_ladder``) takes K4 apart one construct
  per rung.

Each runs as ``python -m parallel_convolution_tpu_torch.probes.<name>`` on
the card and prints one JSON row per case, each with the card's name.  Each
wrapper takes its plain PyTorch version only for tensors on the CPU, and
counts its launches on its own (``launch_counts``), apart from the main
path's kernels (``ops.stencil.launch_counts``).
"""

from __future__ import annotations

def _wrappers() -> dict:
    from parallel_convolution_tpu_torch.probes import (
        op_price, rdma_ladder, smem_budget,
    )

    return {"op_chain": op_price.op_chain,
            "smem_probe": smem_budget.smem_probe,
            "rdma_ladder": rdma_ladder.rdma_ladder}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    """Launches of each probe kernel since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}
