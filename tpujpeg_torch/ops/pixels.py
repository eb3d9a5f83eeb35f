"""Fused 4:4:4 pixel stage: zigzag coefficients where the chain leaves
them -> raster RGB (kernel 3 of the port).

Counterpart of tpujpeg/ops/pixels_pallas.py and of the 4:4:4 branch of
tpujpeg/pipeline.py::_decode_rgb_planar_fused.  The JAX kernel takes
SoA coefficient planes that an XLA prologue builds and leaves packed
pixels for an XLA epilogue; the port's kernel (csrc/pixels.cu) takes the
coefficients in place and writes the cropped raster itself:

  * coefficients: the chains' dense lane matrix int16 [max_blk*64, L]
    (block j of lane l at rows j*64.., lane axis fastest) with resolved
    DC int32 [L, max_blk], or int16 [B, n_blocks, 64] with DC int32
    [B, n_blocks] or in coefficient row 0 (dc=None);
  * a lane table (`LaneTable`): per entry (image, first MCU, MCU count,
    src), a run of consecutive raster MCUs of one image that starts at
    lane `src` (lane matrix) or block `src` ([B, n_blocks, 64]); src < 0
    is a run of zero coefficients, image < 0 an unused entry.  The
    chains build theirs (runtime/fused.py), `block_lanes` the one of
    [B, n_blocks, 64];
  * output rgb uint8 [B, 3, H, W] and, in the f32 mode, the packed risk
    bits uint8 [B, H, ceil(W/8)] of pipeline.device_decode_fn.

Two colour modes: the f32 colour with risk flags (color.color_core, the
JAX contract) and, with exact=True, the reference's exact colour
(color.color_exact) with no flags.

`rgb_444` launches the CUDA kernel for CUDA tensors and runs
`rgb_444_plain` for CPU tensors; there is no fallback between the two.
`rgb_444_plain` is built from `rgb_soa_fused_plain`'s IDCT, the plain
mirror of the JAX `_pixel_kernel` (k-major SoA planes in, packed rg/bk
out), which stays with its CPU tests.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..constants import ZIGZAG_TO_NATURAL
from .color import (EXACT_CONSTS, KERNEL_CONSTS, color_channels, color_core,
                    color_exact, pack_mask)
from .idct import _colpass, _rowpass, _w32

# MCU-axis padding unit of the SoA planes (the JAX kernel's lane tile).
TILE = 512

# Input row 8k+rr holds natural coefficient 8rr+k (see module doc).
KMAJOR_OF_NATURAL = [8 * (j % 8) + j // 8 for j in range(64)]

# zigzag index of each k-major row: the SoA prologue's single row permute
_KMAJOR_ZZ = np.asarray(ZIGZAG_TO_NATURAL)[KMAJOR_OF_NATURAL]


class LaneTable(NamedTuple):
    """The pixel kernel's runs: int32 [T, 4] (image, first MCU, MCU
    count, src) on the coefficients' device, and the largest count."""

    table: torch.Tensor
    max_n: int


def lane_table(rows: np.ndarray, device) -> LaneTable:
    """A LaneTable from host rows int [T, 4]."""
    rows = np.ascontiguousarray(rows, np.int32).reshape(-1, 4)
    live = rows[:, 0] >= 0
    max_n = int(rows[live, 2].max()) if live.any() else 0
    return LaneTable(torch.as_tensor(rows).to(device), max_n)


@functools.lru_cache(maxsize=64)
def block_lanes(B: int, mcus_y: int, mcus_x: int, device) -> LaneTable:
    """The runs of [B, n_blocks, 64] 4:4:4 coefficients: one per MCU row
    of each image (three blocks per MCU)."""
    b, my = np.divmod(np.arange(B * mcus_y), mcus_y)
    m0 = my * mcus_x
    rows = np.stack([b, m0, np.full_like(b, mcus_x),
                     b * (mcus_y * mcus_x * 3) + m0 * 3], axis=1)
    return lane_table(rows, device)


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


def soa_planes(coeffs: torch.Tensor, quant: torch.Tensor,
               dc: torch.Tensor | None):
    """The JAX kernel's inputs (its XLA prologue): one zigzag -> k-major
    row permute and SoA transpose, the DC plane, TILE padding.

    coeffs [B, n_blocks, 64] zigzag 4:4:4 blocks, quant [B, 3, 64]
    (zigzag), dc [B, n_blocks] resolved DC or None.  Returns (zp int16
    [B, 3, 64, P], quant_km int32 [B, 3, 64, 1], dc_planes int32
    [B, 3, 1, P])."""
    B = coeffs.shape[0]
    n = coeffs.shape[1] // 3
    dev = coeffs.device
    zz = coeffs.reshape(B, n, 3, 64).permute(0, 2, 3, 1)  # [B, 3, 64, n]
    perm = torch.as_tensor(_KMAJOR_ZZ, dtype=torch.long, device=dev)
    zp = zz.index_select(2, perm).to(torch.int16)
    if dc is None:
        dcp = zz[:, :, 0:1, :].to(torch.int32)
    else:
        dcp = dc.reshape(B, n, 3).permute(0, 2, 1)[:, :, None, :]
        dcp = dcp.to(torch.int32)
    q = quant.to(torch.int32).index_select(2, perm)[..., None].contiguous()
    pad = (-n) % TILE
    zp = torch.nn.functional.pad(zp, (0, pad)).contiguous()
    dcp = torch.nn.functional.pad(dcp, (0, pad)).contiguous()
    return zp, q, dcp


def _idct_soa(zp, quant_km, dc_planes):
    """Dequant, DC substitution and IDCT of SoA planes -> three int64
    pixel planes [..., 64, P] (row p = raster position p of every MCU)."""
    pix = []
    for c in range(3):
        x = zp[..., c, :, :].to(torch.int64)               # [..., 64, P]
        q = quant_km[..., c, :, :].to(torch.int64)         # [..., 64, 1]
        deq = _w32(x * q)
        d0 = _w32(dc_planes[..., c, :, :].to(torch.int64) * q[..., 0:1, :])
        pix.append(_idct64(torch.cat([d0, deq[..., 1:, :]], dim=-2)))
    return pix


def rgb_soa_fused_plain(zp, quant_km, dc_planes):
    """Plain mirror of the JAX `_pixel_kernel`: SoA planes -> (rg, bk)
    int16 [..., 64, P] packing r | g<<8 and b | risky<<8."""
    (r, g, b), risky = color_core(*_idct_soa(zp, quant_km, dc_planes))
    rg = _sext16(r | (g << 8))
    bk = _sext16(b | (risky.to(torch.int32) << 8))
    return rg, bk


def raster_from_blocks(geom, chans, risky):
    """Block-domain colour planes ([B, 64, n_mcus] each, full resolution)
    -> (rgb uint8 [B, 3, H, W], packed riskbits or None): one uint8
    raster transpose and the crop."""
    B = chans[0].shape[0]
    my, mx = geom.mcus_y, geom.mcus_x
    rgb = torch.stack(chans, dim=1)                       # [B, 3, 64, n]
    rgb = (
        rgb.reshape(B, 3, 8, 8, my, mx)
        .permute(0, 1, 4, 2, 5, 3)
        .reshape(B, 3, my * 8, mx * 8)
    )
    rgb = rgb[:, :, : geom.height, : geom.width]
    if risky is None:
        return rgb, None
    risky = (
        risky.reshape(B, 8, 8, my, mx)
        .permute(0, 3, 1, 4, 2)
        .reshape(B, my * 8, mx * 8)
    )
    return rgb, pack_mask(risky[:, : geom.height, : geom.width])


def rgb_444_plain(geom, coeffs, lanes: LaneTable, quant, dc=None,
                  extents=None, exact: bool = False):
    """Plain PyTorch version of the pixel kernel (same contract): gather
    each run's MCUs into [B, n_blocks, 64], `soa_planes`, the IDCT of
    `rgb_soa_fused_plain`, `color_core` or `color_exact`, raster."""
    dev = coeffs.device
    B = quant.shape[0]
    n = geom.mcus_y * geom.mcus_x
    tab = lanes.table.to(device=dev, dtype=torch.int64)
    tab = tab[(tab[:, 0] >= 0) & (tab[:, 2] > 0)]
    img, m0, cnt, src = tab.unbind(1)
    run = torch.repeat_interleave(torch.arange(len(cnt), device=dev), cnt)
    slot = torch.arange(run.numel(), device=dev) \
        - (torch.cumsum(cnt, 0) - cnt)[run]
    img, mcu, src = img[run], m0[run] + slot, src[run]
    zero = (src < 0)[:, None]
    src = src.clamp(min=0)
    r = torch.arange(192, device=dev)
    if coeffs.dim() == 2:      # lane matrix: lane src, block 3*slot + c
        idx = src[:, None] + (slot[:, None] * 192 + r) * coeffs.shape[1]
        dc_at = src * (0 if dc is None else dc.shape[1]) + slot * 3
    else:                      # [B, n_blocks, 64]: block src + 3*slot + c
        idx = (src[:, None] + slot[:, None] * 3) * 64 + r
        dc_at = src + slot * 3
    idx = torch.where(zero, 0, idx)
    zz = torch.where(zero, 0, coeffs.reshape(-1)[idx].to(torch.int32))
    if dc is None:
        d = zz[:, ::64]
    else:
        dc_at = torch.where(zero[:, 0], 0, dc_at)
        d = dc.reshape(-1)[dc_at[:, None] + torch.arange(3, device=dev)]
        d = torch.where(zero, 0, d.to(torch.int32))
    if extents is not None:
        ext = extents.to(device=dev, dtype=torch.int64)
        real = (mcu // geom.mcus_x < ext[img, 0]) \
            & (mcu % geom.mcus_x < ext[img, 1])
        d = torch.where(real[:, None], d, 0)
    blocks = torch.zeros((B, n, 192), dtype=torch.int32, device=dev)
    blocks[img, mcu] = zz
    dcs = torch.zeros((B, n, 3), dtype=torch.int32, device=dev)
    dcs[img, mcu] = d
    zp, q, dcp = soa_planes(blocks.reshape(B, n * 3, 64), quant,
                            dcs.reshape(B, n * 3))
    pix = [p[..., :n] for p in _idct_soa(zp, q, dcp)]
    if exact:
        return raster_from_blocks(geom, color_exact(*pix), None)
    return raster_from_blocks(geom, *color_channels(*pix))


def rgb_444(geom, coeffs: torch.Tensor, lanes: LaneTable,
            quant: torch.Tensor, dc: torch.Tensor | None = None,
            extents: torch.Tensor | None = None, exact: bool = False):
    """4:4:4 coefficients -> (rgb uint8 [B, 3, H, W], packed riskbits
    uint8 [B, H, ceil(W/8)], None when exact).

    geom:    the geometry (height, width, mcus_y, mcus_x) of the output.
    coeffs:  int16 lane matrix [max_blk*64, L], or [B', n_blocks, 64].
    lanes:   the runs (LaneTable); every MCU of [H, W] in exactly one.
    quant:   int32 [B, 3, 64] zigzag quant tables (B output images).
    dc:      resolved DC, int32 [L, max_blk] (lane matrix) or [B',
             n_blocks]; None takes coefficient row 0.
    extents: int32 [B, 2] true (mcus_y, mcus_x): DC is zeroed outside.
    exact:   the reference's exact colour and no risk bits.

    CUDA tensors run kernel 3; CPU tensors run the plain version.
    """
    if not coeffs.is_cuda:
        return rgb_444_plain(geom, coeffs, lanes, quant, dc, extents, exact)
    from ..runtime import kernels

    lane_layout = coeffs.dim() == 2
    B = quant.shape[0]
    if lane_layout:
        M, L = coeffs.shape
        if M % 64 or (dc is not None and dc.shape[0] != L):
            raise ValueError(f"rgb_444: bad lane matrix {tuple(coeffs.shape)}"
                             f" or dc {None if dc is None else tuple(dc.shape)}")
    else:
        if coeffs.dim() != 3 or coeffs.shape[2] != 64 or \
                coeffs.shape[1] % 3:
            raise ValueError(f"rgb_444: bad blocks {tuple(coeffs.shape)}")
        if dc is not None and tuple(dc.shape) != tuple(coeffs.shape[:2]):
            raise ValueError(f"rgb_444: bad dc {tuple(dc.shape)}")
        if coeffs.data_ptr() % 16:
            raise ValueError("rgb_444: blocks must be 16-byte aligned")
        L = 0
    if tuple(quant.shape) != (B, 3, 64):
        raise ValueError(f"rgb_444: bad quant {tuple(quant.shape)}")
    if extents is not None and tuple(extents.shape) != (B, 2):
        raise ValueError(f"rgb_444: bad extents {tuple(extents.shape)}")
    table = lanes.table
    if table.dim() != 2 or table.shape[1] != 4:
        raise ValueError(f"rgb_444: bad lane table {tuple(table.shape)}")
    kernels.check_cuda_tensor("coeffs", coeffs, torch.int16)
    kernels.check_cuda_tensor("quant", quant, torch.int32)
    kernels.check_cuda_tensor("lanes", table, torch.int32)
    if dc is not None:
        dc = dc.contiguous()
        kernels.check_cuda_tensor("dc", dc, torch.int32)
    if extents is not None:
        kernels.check_cuda_tensor("extents", extents, torch.int32)
    H, W = geom.height, geom.width
    rgb = torch.empty((B, 3, H, W), dtype=torch.uint8, device=coeffs.device)
    risk = None if exact else torch.empty(
        (B, H, (W + 7) // 8), dtype=torch.uint8, device=coeffs.device)
    kernels.launch(
        "pixels", coeffs.device,
        coeffs.data_ptr(), quant.data_ptr(),
        None if dc is None else dc.data_ptr(), table.data_ptr(),
        None if extents is None else extents.data_ptr(),
        rgb.data_ptr(), None if risk is None else risk.data_ptr(),
        table.shape[0], lanes.max_n, L,
        0 if dc is None or not lane_layout else dc.shape[1],
        H, W, geom.mcus_x, int(lane_layout), int(exact),
        KERNEL_CONSTS.ctypes.data, EXACT_CONSTS.ctypes.data,
    )
    return rgb, risk


def exact_colour_mismatches(device) -> tuple[int, int]:
    """Triples of [-256, 255]^3 whose exact colour on `device` differs
    from the oracle's ycbcr_to_rgb_exact: (pixel kernel, color_exact).

    Per Y slab, one 512 x 512-MCU image of DC-only blocks with quant 8:
    DC v gives the constant sample v (row pass 8v, column pass (8v + 4)
    >> 3), so MCU (cb, cr) holds the triple and its pixel (0, 0) is read
    back.  Sized for a card: a slab is a 4096 x 4096 image."""
    from ..oracle.decoder import ycbcr_to_rgb_exact
    from ..pipeline import Geometry

    axis = np.arange(-256, 256, dtype=np.int32)
    cb, cr = (a.ravel() for a in np.meshgrid(axis, axis, indexing="ij"))
    n = cb.size
    geom = Geometry((4096, 4096, 512, 512, ((1, 1, 0), (1, 1, 1),
                                             (1, 1, 2))))
    coeffs = torch.zeros((1, 3 * n, 64), dtype=torch.int16, device=device)
    quant = torch.full((1, 3, 64), 8, dtype=torch.int32, device=device)
    lanes = block_lanes(1, 512, 512, device)
    dc = torch.empty((n, 3), dtype=torch.int32, device=device)
    dc[:, 1] = torch.as_tensor(cb).to(device)
    dc[:, 2] = torch.as_tensor(cr).to(device)
    bad_kernel = bad_torch = 0
    for y in range(-256, 256):
        dc[:, 0] = y
        rgb, _ = rgb_444(geom, coeffs, lanes, quant, dc=dc.reshape(1, 3 * n),
                         exact=True)
        got = rgb[0, :, ::8, ::8].reshape(3, n).T.cpu().numpy()
        plane = torch.stack(color_exact(dc[:, 0], dc[:, 1], dc[:, 2]),
                            dim=1).cpu().numpy()
        want = ycbcr_to_rgb_exact(np.full(n, y, np.int32), cb, cr)
        bad_kernel += int((got != want).any(axis=1).sum())
        bad_torch += int((plane != want).any(axis=1).sum())
    return bad_kernel, bad_torch
