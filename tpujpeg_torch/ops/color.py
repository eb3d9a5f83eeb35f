"""YCbCr -> RGB (plain PyTorch): the f32 colour with exactness-risk
flags, and the reference's exact colour.

`color_core` / `color_channels` / `ycbcr_to_rgb` (interleaved) are the
counterpart of tpujpeg/ops/color.py: the same f32 constants (rounded from the
reference's double constants exactly as there), the same operation
order, and the same EPS band.  A pixel whose pre-truncation value lies
within EPS of an integer is flagged `risky`.  torch.round is
round-half-even, like jnp.round.  The JAX package computes colour this
way because a TPU has no f64, and repairs flagged pixels on the host.

`color_exact` is the reference's own mixed-precision colour
(oracle.decoder.ycbcr_to_rgb_exact) in float64, so it needs no flag and
no repair: strict decodes use it (on the card for grayscale and the
stripe-sharded plane path; the pixel and planes kernels have it as their
exact mode).
`pack_mask` packs risk masks 8 pixels a byte; `unpack_mask` reads them
back on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import C_BLUE, C_GY_B, C_GY_DIV, C_GY_R, C_RED

EPS = np.float32(1e-3)

_F_RED = np.float32(C_RED)
_F_BLUE = np.float32(C_BLUE)
_F_GY_B = np.float32(C_GY_B)
_F_GY_R = np.float32(C_GY_R)
_F_GY_INV = np.float32(1.0 / C_GY_DIV)
_F_128 = np.float32(128.0)

# (red, blue, gy_b, gy_r, gy_inv, eps): the order the pixel kernel takes
KERNEL_CONSTS = np.array(
    [_F_RED, _F_BLUE, _F_GY_B, _F_GY_R, _F_GY_INV, EPS], np.float32
)
# (red, blue, gy_b, gy_r, gy_div): the pixel kernel's exact-mode doubles
EXACT_CONSTS = np.array([C_RED, C_BLUE, C_GY_B, C_GY_R, C_GY_DIV], np.float64)


def color_core(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """int planes -> ([r, g, b] int32 in [0, 255], risky bool)."""
    yf = y.to(torch.float32)
    r = float(_F_RED) * cr.to(torch.float32) + yf
    b = float(_F_BLUE) * cb.to(torch.float32) + yf
    g = (yf - float(_F_GY_B) * b - float(_F_GY_R) * r) * float(_F_GY_INV)

    rgb = []
    risky = None
    for ch in (r, g, b):
        shifted = ch + float(_F_128)
        trunc = torch.trunc(shifted)
        dist = torch.abs(shifted - torch.round(shifted))
        flag = dist < float(EPS)
        risky = flag if risky is None else (risky | flag)
        rgb.append(torch.clamp(trunc.to(torch.int32), 0, 255))
    return rgb, risky


def color_exact(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """int planes -> [r, g, b] uint8, the reference's exact colour.

    The oracle's operation order: r and b in double, each rounded once
    to float32; g from the float32 r and b widened back to double; +128
    in float32, truncation, clamp to [0, 255].  Each product, sum and
    quotient is one float64 PyTorch op, so nothing is contracted."""
    yf = y.to(torch.float64)
    r32 = (C_RED * cr.to(torch.float64) + yf).to(torch.float32)
    b32 = (C_BLUE * cb.to(torch.float64) + yf).to(torch.float32)
    g32 = ((yf - C_GY_B * b32.to(torch.float64)
            - C_GY_R * r32.to(torch.float64)) / C_GY_DIV).to(torch.float32)
    return [
        torch.clamp(torch.trunc(ch + float(_F_128)).to(torch.int32), 0, 255)
        .to(torch.uint8)
        for ch in (r32, g32, b32)
    ]


def color_channels(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """int planes -> ([r, g, b] uint8, risky bool)."""
    rgb, risky = color_core(y, cb, cr)
    return [ch.to(torch.uint8) for ch in rgb], risky


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """int planes -> (rgb uint8 [..., 3] interleaved, risky bool [...]):
    the f32 colour of `color_core`; `risky` marks every pixel whose value
    the f32 math may get wrong against the exact colour."""
    rgb, risky = color_channels(y, cb, cr)
    return torch.stack(rgb, dim=-1), risky


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """Pack a [..., W] bool mask into [..., ceil(W/8)] uint8, LSB first."""
    w = mask.shape[-1]
    pad = (-w) % 8
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    m = mask.reshape(mask.shape[:-1] + (-1, 8)).to(torch.int32)
    weights = torch.tensor(
        [1 << i for i in range(8)], dtype=torch.int32, device=mask.device
    )
    return (m * weights).sum(dim=-1).to(torch.uint8)


def unpack_mask(packed: np.ndarray, width: int) -> np.ndarray:
    """Host-side inverse of `pack_mask`: uint8 [..., ceil(W/8)] -> bool
    [..., width]."""
    bits = np.unpackbits(packed, axis=-1, bitorder="little")
    return bits[..., :width].astype(bool)
