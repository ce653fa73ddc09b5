"""Seeded inputs, made on the device, that any part of the benchmark can
remake on its own.

An image's byte at (channel, global row, global column) is a counter-based
hash of those three and the seed, so a rank can make its own block, and
the reference any window with its apron, without holding the whole image.
The hash works on 32-bit values held in int64 tensors; every product is of
a value under 2**32 and a constant under 2**31, so nothing overflows and
the CPU and the card give the same bytes.

Float fields (the V-cycle's) come from ``torch.randn`` under a generator
seeded from (seed, index) on the field's device: the same call remakes
the same field there.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
# Odd multipliers under 2**31 (see the module docstring).
_K1, _K2 = 0x7FEB352D, 0x68E31DA5
_GOLDEN = 0x9E3779B9
# Rows made at once: the int64 temporaries of a band stay under 1 GB at
# 65536 columns.
BAND_ROWS = 1024


def _mix_int(x: int) -> int:
    """The tensor hash's mix on a Python int (keys are mixed on the host)."""
    x &= M32
    x ^= x >> 16
    x = (x * _K1) & M32
    x ^= x >> 15
    x = (x * _K2) & M32
    return x ^ (x >> 16)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """The same mix over an int64 tensor of values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _K1) & M32
    x = x ^ (x >> 15)
    x = (x * _K2) & M32
    return x ^ (x >> 16)


def key(seed: int, *parts: int) -> int:
    """A 32-bit key from a seed of any size and further small integers."""
    seed = int(seed)
    k = _mix_int(seed & M32) ^ _mix_int((seed >> 32) & M32 ^ _GOLDEN)
    for p in parts:
        k = _mix_int(k ^ _mix_int(int(p) + _GOLDEN))
    return k


def image_window(seed: int, image: int, channels: int, shape_hw,
                 y0: int, x0: int, h: int, w: int, device,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The (channels, h, w) u8 window at global (y0, x0) of seeded image
    number ``image`` of extent ``shape_hw``; positions outside the image
    read 0 (the zero ghost ring), so a window may reach past an edge."""
    H, W = (int(v) for v in shape_hw)
    if out is None:
        out = torch.empty((channels, h, w), dtype=torch.uint8, device=device)
    cols = torch.arange(x0, x0 + w, device=device, dtype=torch.int64)
    col_ok = (cols >= 0) & (cols < W)
    colsm = cols & M32
    for c in range(channels):
        kr, kc = key(seed, image, c, 0), key(seed, image, c, 1)
        cx = _mix(colsm ^ kc)
        for b0 in range(0, h, BAND_ROWS):
            b1 = min(h, b0 + BAND_ROWS)
            rows = torch.arange(y0 + b0, y0 + b1, device=device,
                                dtype=torch.int64)
            ry = _mix((rows & M32) ^ kr)
            v = (_mix(ry[:, None] ^ cx[None, :]) >> 24).to(torch.uint8)
            ok = ((rows >= 0) & (rows < H))[:, None] & col_ok[None, :]
            out[c, b0:b1] = v * ok.to(torch.uint8)
    return out


def image(seed: int, index: int, channels: int, shape_hw,
          device) -> torch.Tensor:
    """Seeded image number ``index`` whole, planar (channels, H, W) u8."""
    H, W = (int(v) for v in shape_hw)
    return image_window(seed, index, channels, (H, W), 0, 0, H, W, device)


def normal_field(seed: int, index: int, channels: int, shape_hw,
                 device) -> torch.Tensor:
    """Seeded field number ``index``: (channels, H, W) f32 standard
    normal values, made on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(key(seed, index, 0x5EED) | (key(seed, index, 1) << 32))
    return torch.randn((channels, *(int(v) for v in shape_hw)),
                       generator=g, device=device, dtype=torch.float32)
