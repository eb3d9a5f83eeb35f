"""Fused pixel stage: dequant + DC substitution + integer IDCT + colour
+ risk flags over 4:4:4 MCU planes (kernel 3 of the port).

Counterpart of tpujpeg/ops/pixels_pallas.py.  The input is three
components' coefficient planes in k-major row order (row 8k+rr holds
natural coefficient 8rr+k, the layout the JAX prologue builds); the
output packs two 8-bit results per int16: rg = r | g<<8 and
bk = b | risky<<8, row p = raster position p of every MCU.

`rgb_soa_fused` launches the CUDA kernel (csrc/pixels.cu) for CUDA
tensors and runs `rgb_soa_fused_plain`, the plain PyTorch version, for
CPU tensors.  There is no fallback between the two.
"""

from __future__ import annotations

import torch

from .color import KERNEL_CONSTS, color_core
from .idct import _colpass, _rowpass, _w32

# MCU-axis padding unit of the planes (the JAX kernel's lane tile; the
# CUDA kernel needs a multiple of its 32-MCU block).
TILE = 512

# Input row 8k+rr holds natural coefficient 8rr+k (see module doc).
KMAJOR_OF_NATURAL = [8 * (j % 8) + j // 8 for j in range(64)]


def _sext16(v: torch.Tensor) -> torch.Tensor:
    """Low 16 bits of an int tensor, reinterpreted as int16."""
    v = v.to(torch.int32) & 0xFFFF
    return torch.where(v >= 0x8000, v - 0x10000, v).to(torch.int16)


def _idct64(x: torch.Tensor) -> torch.Tensor:
    """[..., 64, T] int64 k-major coefficients -> [..., 64, T] natural
    pixel rows (int64 values in [-256, 255])."""
    c = [x[..., 8 * k : 8 * k + 8, :] for k in range(8)]   # [..., 8(rr), T]
    r = _rowpass(c[0], c[4], c[6], c[2], c[1], c[7], c[5], c[3])
    # r[cc][..., rr, :] is the row-pass result at (rr, cc); the column pass
    # for column cc takes rows 0..7 of it
    rt = torch.stack(r, dim=-2)                 # [..., 8(rr), 8(cc), T]
    z = [rt[..., rr, :, :] for rr in range(8)]  # [..., 8(cc), T]
    o = _colpass(z[0], z[4], z[6], z[2], z[1], z[7], z[5], z[3])
    return torch.cat(o, dim=-2)                 # row 8*rr + cc


def rgb_soa_fused_plain(zp, quant_km, dc_planes):
    """Plain PyTorch version of the pixel kernel (same contract)."""
    pix = []
    for c in range(3):
        x = zp[..., c, :, :].to(torch.int64)               # [..., 64, P]
        q = quant_km[..., c, :, :].to(torch.int64)         # [..., 64, 1]
        deq = _w32(x * q)
        d0 = _w32(dc_planes[..., c, :, :].to(torch.int64) * q[..., 0:1, :])
        pix.append(_idct64(torch.cat([d0, deq[..., 1:, :]], dim=-2)))
    (r, g, b), risky = color_core(*pix)
    rg = _sext16(r | (g << 8))
    bk = _sext16(b | (risky.to(torch.int32) << 8))
    return rg, bk


def rgb_soa_fused(zp: torch.Tensor, quant_km: torch.Tensor,
                  dc_planes: torch.Tensor):
    """Natural-order SoA coefficient planes -> packed pixel planes.

    zp:        int16 [B, 3, 64, P] k-major coefficient planes (P = MCUs
               padded to a TILE multiple).
    quant_km:  int32 [B, 3, 64, 1] k-major quant columns.
    dc_planes: int32 [B, 3, 1, P] resolved DC coefficients.

    Returns (rg, bk) int16 [B, 64, P].  CUDA tensors run kernel 3; CPU
    tensors run the plain version.
    """
    if not zp.is_cuda:
        return rgb_soa_fused_plain(zp, quant_km, dc_planes)
    from ..runtime import kernels

    B, C, R, P = zp.shape
    if C != 3 or R != 64 or P % TILE:
        raise ValueError(f"rgb_soa_fused: bad plane shape {tuple(zp.shape)}")
    if tuple(quant_km.shape) != (B, 3, 64, 1):
        raise ValueError(f"rgb_soa_fused: bad quant {tuple(quant_km.shape)}")
    if tuple(dc_planes.shape) != (B, 3, 1, P):
        raise ValueError(f"rgb_soa_fused: bad dc {tuple(dc_planes.shape)}")
    kernels.check_cuda_tensor("zp", zp, torch.int16)
    kernels.check_cuda_tensor("quant_km", quant_km, torch.int32)
    kernels.check_cuda_tensor("dc_planes", dc_planes, torch.int32)
    rg = torch.empty((B, 64, P), dtype=torch.int16, device=zp.device)
    bk = torch.empty_like(rg)
    consts = KERNEL_CONSTS
    kernels.launch(
        "pixels",
        zp.data_ptr(), quant_km.data_ptr(), dc_planes.data_ptr(),
        rg.data_ptr(), bk.data_ptr(), B, P,
        consts.ctypes.data, kernels.current_stream(zp.device),
    )
    return rg, bk


def unpack_pixels(rg: torch.Tensor, bk: torch.Tensor):
    """Packed int16 planes -> ([r, g, b] uint8, risky bool)."""
    rgi = rg.to(torch.int32) & 0xFFFF
    bki = bk.to(torch.int32) & 0xFFFF
    r = (rgi & 0xFF).to(torch.uint8)
    g = (rgi >> 8).to(torch.uint8)
    b = (bki & 0xFF).to(torch.uint8)
    risky = ((bki >> 8) & 1).to(torch.bool)
    return [r, g, b], risky
