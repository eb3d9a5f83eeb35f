"""Subsampled pixel stage: zigzag coefficients of one geometry -> raster
RGB (kernel "planes" of the port, csrc/planes.cu).

The plane path of pipeline.device_decode_fn (counterpart of the JAX
package's XLA plane path in tpujpeg/pipeline.py, which has no Pallas
kernel): dequant, inverse zigzag and the integer IDCT of every block,
each component's plane upsampled to full resolution (box, or libjpeg's
fancy triangle filter at factors up to 2), the colour of both modes, and
the crop to the geometry's size.

`planes_rgb` launches the CUDA kernel for CUDA tensors and runs the plain
plane path (`planes_rgb_plain`: pipeline.decode_subsampled_planes,
upsample_planes, planes_to_rgb, plain PyTorch) for CPU tensors; there is
no fallback between the two.  The plain path is the contract.
"""

from __future__ import annotations

import numpy as np
import torch

from .color import EXACT_CONSTS, KERNEL_CONSTS


def planes_rgb_plain(geom, coeffs, quant, fancy: bool = False, dc=None,
                     extents=None, exact: bool = False):
    """The plane path in plain PyTorch (the kernel's contract)."""
    from ..pipeline import (decode_subsampled_planes, planes_to_rgb,
                            upsample_planes)

    planes = decode_subsampled_planes(geom, coeffs, quant, dc)
    return planes_to_rgb(geom, upsample_planes(geom, planes, fancy, extents),
                         exact)


def _components(geom) -> tuple[np.ndarray, int]:
    """The kernel's per-component table int64 [n_comp, 8] (h, v, fh, fv,
    plane width, plane height, first block in an MCU, plane offset) and
    the samples of one image's planes.  Raises ValueError where an
    upsampled plane would not cover the raster (the plain path fails
    there too)."""
    rows, base, off = [], 0, 0
    max_h, max_v = geom.max_h, geom.max_v
    for h, v, _ in geom.comps:
        if h < 1 or v < 1:
            raise ValueError(f"planes_rgb: sampling factors {h}x{v}")
        wc, hc = geom.mcus_x * h * 8, geom.mcus_y * v * 8
        fh, fv = max_h // h, max_v // v
        if wc * fh < geom.width or hc * fv < geom.height:
            raise ValueError(
                f"planes_rgb: a {h}x{v} component of a {max_h}x{max_v} "
                f"geometry does not cover {geom.width}x{geom.height}")
        rows.append((h, v, fh, fv, wc, hc, base, off))
        base += h * v
        off += wc * hc
    return np.asarray(rows, np.int64), off


def _check(geom, coeffs, quant, dc, extents) -> None:
    """What the kernel takes: one or three components; coefficients int16
    or int32 [B, n_blocks, 64]; quant int32 [B, n_comp, 64]; dc int32 [B,
    n_blocks] and extents int32 [B, 2] or None; all contiguous CUDA
    tensors on one device.  Raises TypeError or ValueError otherwise."""
    from ..runtime import kernels

    B, n_comp = quant.shape[0], len(geom.comps)
    if n_comp not in (1, 3):
        raise ValueError(f"planes_rgb: {n_comp} components")
    if coeffs.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"planes_rgb: coefficients {coeffs.dtype}")
    if tuple(coeffs.shape) != (B, geom.n_blocks, 64):
        raise ValueError(f"planes_rgb: bad coefficients "
                         f"{tuple(coeffs.shape)} for {B} images of "
                         f"{geom.n_blocks} blocks")
    if tuple(quant.shape) != (B, n_comp, 64):
        raise ValueError(f"planes_rgb: bad quant {tuple(quant.shape)}")
    if dc is not None and tuple(dc.shape) != (B, geom.n_blocks):
        raise ValueError(f"planes_rgb: bad dc {tuple(dc.shape)}")
    if extents is not None and tuple(extents.shape) != (B, 2):
        raise ValueError(f"planes_rgb: bad extents {tuple(extents.shape)}")
    for t in (quant, dc, extents):
        if t is not None and t.device != coeffs.device:
            raise ValueError(f"planes_rgb: tensors on {coeffs.device} and "
                             f"{t.device}")
    kernels.check_cuda_tensor("coeffs", coeffs, coeffs.dtype)
    kernels.check_cuda_tensor("quant", quant, torch.int32)
    for name, t in (("dc", dc), ("extents", extents)):
        if t is not None:
            kernels.check_cuda_tensor(name, t, torch.int32)


def planes_rgb(geom, coeffs: torch.Tensor, quant: torch.Tensor,
               fancy: bool = False, dc: torch.Tensor | None = None,
               extents: torch.Tensor | None = None, exact: bool = False):
    """Coefficients -> (rgb uint8 [B, 3, H, W], packed riskbits uint8
    [B, H, ceil(W/8)], None when exact).

    geom:    the geometry (its size, MCU grid and components).
    coeffs:  int16 or int32 [B, n_blocks, 64], zigzag, scan order.
    quant:   int32 [B, n_comp, 64] zigzag quant tables.
    fancy:   libjpeg's triangle upsampling (factors up to 2; box above).
    dc:      int32 [B, n_blocks] resolved DC overriding coefficient 0.
    extents: int32 [B, 2] true (mcus_y, mcus_x) inside a size-class
             bucket: the fancy filter's edges.
    exact:   the reference's exact colour and no risk bits.

    CUDA tensors run csrc/planes.cu (one launch: its IDCT and colour
    kernels, int16 planes between them); CPU tensors run the plain path.
    """
    if not coeffs.is_cuda:
        return planes_rgb_plain(geom, coeffs, quant, fancy, dc, extents,
                                exact)
    from ..runtime import kernels

    _check(geom, coeffs, quant, dc, extents)
    B, n_comp = quant.shape[0], len(geom.comps)
    comps, per_image = _components(geom)
    H, W = geom.height, geom.width
    dev = coeffs.device
    # the IDCT kernel stores 16-byte rows: the caching allocator's blocks
    # are aligned far beyond that
    planes = torch.empty((B, per_image), dtype=torch.int16, device=dev)
    rgb = torch.empty((B, 3, H, W), dtype=torch.uint8, device=dev)
    risk = None if exact else torch.empty(
        (B, H, (W + 7) // 8), dtype=torch.uint8, device=dev)
    kernels.launch(
        "planes", dev,
        coeffs.data_ptr(), quant.data_ptr(),
        None if dc is None else dc.data_ptr(),
        None if extents is None else extents.data_ptr(),
        planes.data_ptr(), rgb.data_ptr(),
        None if risk is None else risk.data_ptr(),
        coeffs.element_size(), B, n_comp, geom.n_blocks,
        geom.blocks_per_mcu, geom.mcus_x, H, W, int(fancy), int(exact),
        per_image, comps.ctypes.data, KERNEL_CONSTS.ctypes.data,
        EXACT_CONSTS.ctypes.data,
    )
    return rgb, risk
