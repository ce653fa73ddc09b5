"""User-facing models."""

from parallel_convolution_tpu_torch.models.pipeline import ConvolutionModel

__all__ = ["ConvolutionModel"]
