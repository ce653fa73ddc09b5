"""Plain PyTorch convolution paths (the port of the JAX package's
``ops/conv.py``).

Layout is planar ``(C, H, W)`` (grey is ``C == 1``), as in the JAX package.
Three implementations of one zero-padded cross-correlation step:

* :func:`correlate_padded` — the normative fixed-order tap loop of
  ``ops/oracle.py``.  PyTorch's eager ``acc + tap * x`` rounds the product
  and the sum separately, as NumPy does, so float32 results are
  bit-identical to the oracle.
* :func:`correlate_padded_separable` — the rank-1 two-pass form.
* :func:`correlate_xla_conv` — ``F.conv2d`` in full FP32 (cuDNN's TF32 is
  switched off; see there).

These are the plain versions every CUDA kernel of the port is held against
(``ops/stencil.py``) and the ``shifted`` / ``separable`` / ``xla_conv``
backends of ``parallel/step.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from parallel_convolution_tpu_torch.ops.filters import Filter


def pad_zero(x: torch.Tensor, r: int) -> torch.Tensor:
    """Zero ghost ring of width ``r`` around the spatial dims of (C, H, W)."""
    return F.pad(x, (r, r, r, r))


def correlate_padded(padded: torch.Tensor, filt: Filter) -> torch.Tensor:
    """Normative correlation over an already-padded (C, H+2r, W+2r) block.

    Fixed row-major tap order; one multiply and one add per tap, each
    rounded to float32.  Accumulates in f32 whatever the storage dtype.
    """
    k, r = filt.size, filt.radius
    C, Hp, Wp = padded.shape
    H, W = Hp - 2 * r, Wp - 2 * r
    x = padded.to(torch.float32)
    acc = torch.zeros((C, H, W), dtype=torch.float32, device=padded.device)
    taps = [float(t) for t in filt.taps.reshape(-1)]
    i = 0
    for dy in range(k):
        for dx in range(k):
            acc = acc + taps[i] * x[:, dy:dy + H, dx:dx + W]
            i += 1
    return acc


def correlate_shifted(x: torch.Tensor, filt: Filter) -> torch.Tensor:
    """One zero-padded correlation step on (C, H, W)."""
    return correlate_padded(pad_zero(x.to(torch.float32), filt.radius), filt)


def correlate_padded_separable(padded: torch.Tensor,
                               filt: Filter) -> torch.Tensor:
    """Rank-1 two-pass form (2k MACs/px instead of k²): a row pass over all
    H+2r rows, then the column pass.  Falls back to the 2D order when the
    filter has no exact float32 factorization.  With dyadic factors and
    u8-range inputs every intermediate is exact, so the result is
    bit-identical to the 2D path in quantize mode."""
    sep = filt.separable()
    if sep is None:
        return correlate_padded(padded, filt)
    col, row = sep
    k, r = filt.size, filt.radius
    C, Hp, Wp = padded.shape
    H, W = Hp - 2 * r, Wp - 2 * r
    x = padded.to(torch.float32)
    acc1 = torch.zeros((C, Hp, W), dtype=torch.float32, device=padded.device)
    for dx in range(k):
        acc1 = acc1 + float(row[dx]) * x[:, :, dx:dx + W]
    out = torch.zeros((C, H, W), dtype=torch.float32, device=padded.device)
    for dy in range(k):
        out = out + float(col[dy]) * acc1[:, dy:dy + H, :]
    return out


def correlate_padded_conv2d(padded: torch.Tensor,
                            filt: Filter) -> torch.Tensor:
    """The same step as one ``F.conv2d`` call over an already-padded block.

    Channels are independent, so C is the batch dimension with one feature
    channel.  cuDNN runs float32 convolutions in TF32 by default (about
    three decimal digits); the port switches that off so the result is a
    float32 convolution, as the JAX package's ``Precision.HIGHEST``.
    """
    torch.backends.cudnn.allow_tf32 = False
    lhs = padded.to(torch.float32)[:, None]
    rhs = torch.as_tensor(filt.taps, dtype=torch.float32,
                          device=padded.device)[None, None]
    return F.conv2d(lhs, rhs)[:, 0]


def correlate_xla_conv(x: torch.Tensor, filt: Filter) -> torch.Tensor:
    """Zero-padded step via ``F.conv2d`` (the JAX package's ``xla_conv``)."""
    return correlate_padded_conv2d(pad_zero(x.to(torch.float32), filt.radius),
                                   filt)


def quantize_f32(acc: torch.Tensor) -> torch.Tensor:
    """uint8 store-back semantics, kept in f32: clip(round(acc), 0, 255).

    ``torch.round`` rounds half to even, like ``np.rint`` and ``rintf``.
    """
    return torch.clamp(torch.round(acc), 0.0, 255.0)


def iterate_u8(x: torch.Tensor, filt: Filter, iters: int,
               use_xla_conv: bool = False) -> torch.Tensor:
    """``iters`` u8-semantics iterations on planar f32 (C, H, W)."""
    correlate = correlate_xla_conv if use_xla_conv else correlate_shifted
    for _ in range(iters):
        x = quantize_f32(correlate(x, filt))
    return x


def iterate_f32(x: torch.Tensor, filt: Filter, iters: int,
                use_xla_conv: bool = False) -> torch.Tensor:
    """``iters`` float-mode iterations (no quantization)."""
    correlate = correlate_xla_conv if use_xla_conv else correlate_shifted
    for _ in range(iters):
        x = correlate(x, filt)
    return x


def run_u8(img_u8_planar, filt: Filter, iters: int,
           device=None) -> torch.Tensor:
    """uint8 planar (C, H, W) in, uint8 planar out, on one device (default:
    the card; raises without CUDA, ``device="cpu"`` for the CPU): the JAX
    package's ``conv.run_u8`` through :func:`iterate_u8`."""
    from parallel_convolution_tpu_torch.utils.platform import resolve_device

    x = torch.as_tensor(img_u8_planar).to(resolve_device(device),
                                          torch.float32)
    return iterate_u8(x, filt, iters).to(torch.uint8)
