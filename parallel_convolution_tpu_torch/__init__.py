"""parallel_convolution_tpu_torch — the PyTorch / CUDA port of
parallel_convolution_tpu, for one NVIDIA H100.

Iterated u8 stencil filtering of grey/RGB images over a block grid, with
halo exchange and temporal fusion; the JAX package's two Pallas stencil
kernels are hand-written CUDA kernels here (``csrc/stencil.cu``, bound in
``ops/stencil.py``).  Entry points run on the card unless the caller asks
for ``device="cpu"``.  The port imports neither JAX nor the JAX package.
"""

from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import (
    FILTERS, Filter, get_filter,
)

__version__ = "0.1.0"

__all__ = ["Filter", "get_filter", "FILTERS", "oracle", "ConvolutionModel",
           "JacobiSolver", "RunConfig", "__version__"]


def __getattr__(name: str):
    # Lazy, as the JAX package's root: the models pull in torch and the
    # whole step stack; a bare import of the package stays numpy-only.
    if name in ("ConvolutionModel", "JacobiSolver"):
        from parallel_convolution_tpu_torch import models

        return getattr(models, name)
    if name == "RunConfig":
        from parallel_convolution_tpu_torch.utils.config import RunConfig

        return RunConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
