"""parallel_convolution_tpu_torch — the PyTorch / CUDA port of
parallel_convolution_tpu, for one NVIDIA H100.

Iterated u8 stencil filtering of grey/RGB images over a block grid, with
halo exchange and temporal fusion; the JAX package's two Pallas stencil
kernels are hand-written CUDA kernels here (``csrc/stencil.cu``, bound in
``ops/stencil.py``).  Entry points run on the card unless the caller asks
for ``device="cpu"``.  The port imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
