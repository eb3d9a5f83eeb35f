"""YCbCr -> RGB in f32 with exactness-risk flags (plain PyTorch).

Counterpart of tpujpeg/ops/color.py: the same f32 constants (rounded
from the reference's double constants exactly as there), the same
operation order, and the same EPS band.  A pixel whose pre-truncation
value lies within EPS of an integer is flagged `risky`; strict decodes
recompute flagged pixels with the reference's exact mixed-precision math
on the host (pipeline._repair).  torch.round is round-half-even, like
jnp.round.
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


def color_channels(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """int planes -> ([r, g, b] uint8, risky bool)."""
    rgb, risky = color_core(y, cb, cr)
    return [ch.to(torch.uint8) for ch in rgb], risky


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
    """Host-side inverse of :func:`pack_mask` -> bool [..., width]."""
    bits = np.unpackbits(packed, axis=-1, bitorder="little")
    return bits[..., :width].astype(bool)
