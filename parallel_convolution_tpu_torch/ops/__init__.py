"""Stencil operators: numpy spec (filters, oracle), plain PyTorch paths
(conv) and the CUDA kernels with their plain versions (stencil)."""
