"""User-facing models."""

from parallel_convolution_tpu_torch.models.jacobi import JacobiSolver
from parallel_convolution_tpu_torch.models.pipeline import ConvolutionModel

__all__ = ["ConvolutionModel", "JacobiSolver"]
