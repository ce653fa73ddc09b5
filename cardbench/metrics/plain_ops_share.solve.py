"""Percent of the solves' kernel time on the card spent in PyTorch's own
kernels rather than the port's (``csrc``: K1 to K4 and the pack), from
the profiler's device timeline."""

PORT_KERNELS = ("stencil_step_kernel", "fused_iterate_kernel",
                "rdma_block_kernel", "rdma_tiled_kernel", "rdma_pack_kernel")


def read(ctx):
    s = ctx.get("trace")
    total = sum(s["kernels"].values()) if s else 0.0
    if total <= 0:
        return None
    port = sum(v for k, v in s["kernels"].items()
               if any(p in k for p in PORT_KERNELS))
    return 100.0 * (total - port) / total
