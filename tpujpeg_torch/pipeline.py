"""Pixel pipeline: coefficients -> RGB, and the single-image decode.

Counterpart of tpujpeg/pipeline.py.  The batch axis that the JAX package
adds with vmap is written out: every device function here takes a
leading batch dimension B.

  * `device_decode_fn(geom, coeffs, quant, fancy, dc, extents)`:
    [B, n_blocks, 64] zigzag coefficients -> (rgb uint8 [B, 3, H, W],
    riskbits uint8 [B, H, W/8]).  Three full-resolution components
    (4:4:4) go through the fused pixel kernel (ops/pixels.py); every
    other geometry (4:2:0, 4:2:2, 4:4:0, 4:1:1, grayscale) takes the
    plane path: `_idct_planar`, `_plane_from_soa`, `upsample_planes` (box
    or fancy, ops/upsample.py), `planes_to_rgb`.  The JAX package has no
    Pallas kernel on the plane path, and it is plain PyTorch here;
  * `decode(img, device, strict, fancy)`: host entropy (the native C++
    decoder of runtime/native) + the pixel stage + strict repair;
  * `bucket_geometry(geom)`: the size-class bucket of a geometry, with
    `pad_coeffs_to_bucket` / `unpad_coeffs_from_bucket` for the host side
    of mixed-size chunks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import ZIGZAG_TO_NATURAL
from .io.parser import JpegImage
from .oracle import decoder as oracle

from .ops.color import color_channels, pack_mask, unpack_mask
from .ops.idct import idct_planes
from .ops.pixels import KMAJOR_OF_NATURAL, TILE, rgb_soa_fused, unpack_pixels

# zigzag index of each k-major row: the prologue's single row permute
_KMAJOR_ZZ = np.asarray(ZIGZAG_TO_NATURAL)[KMAJOR_OF_NATURAL]


class Geometry(tuple):
    """Hashable decode geometry: (width, height, mcus_x, mcus_y, comps),
    comps a tuple of (h, v, quant_slot) per component."""

    __slots__ = ()

    @staticmethod
    def of(img: JpegImage) -> "Geometry":
        comps = tuple((c.h, c.v, i) for i, c in enumerate(img.components))
        return Geometry(
            (img.width, img.height, img.mcus_x, img.mcus_y, comps)
        )

    width = property(lambda s: s[0])
    height = property(lambda s: s[1])
    mcus_x = property(lambda s: s[2])
    mcus_y = property(lambda s: s[3])
    comps = property(lambda s: s[4])

    @property
    def max_h(self) -> int:
        return max(c[0] for c in self.comps)

    @property
    def max_v(self) -> int:
        return max(c[1] for c in self.comps)

    @property
    def blocks_per_mcu(self) -> int:
        return sum(h * v for h, v, _ in self.comps)

    @property
    def n_mcus(self) -> int:
        return self.mcus_x * self.mcus_y

    @property
    def n_blocks(self) -> int:
        return self.n_mcus * self.blocks_per_mcu


# ---------------------------------------------------------------------------
# Size-class buckets (mixed-size chunks)
# ---------------------------------------------------------------------------
#
# A chunk is one set of tensors of one shape, so images of different sizes
# share a chunk by snapping each MCU grid UP to a geometric ladder of
# bucket sizes: coefficients sit in the bucket's MCU raster, zero padded;
# the pixel stage runs at the bucket's size, and the host crops each image
# back to its true height and width.  Everything but the fancy
# upsampler's edge handling is pointwise per block or per pixel, so the
# true MCU extents reach the pixel stage only there (`extents`).


@functools.lru_cache(maxsize=None)
def bucket_up(n: int) -> int:
    """Smallest ladder value >= n (geometric ladder, base 4, ratio 1.3)."""
    b = 4
    while b < n:
        b = -(-b * 13 // 10)  # ceil(b * 1.3), exact in ints
    return b


def bucket_geometry(geom: Geometry) -> Geometry:
    """Snap a geometry's MCU grid up to its size-class bucket.

    Width and height are the bucket's full padded raster; callers crop
    fetched pixels to each image's true (height, width)."""
    bx = bucket_up(geom.mcus_x)
    by = bucket_up(geom.mcus_y)
    return Geometry(
        (bx * 8 * geom.max_h, by * 8 * geom.max_v, bx, by, geom.comps)
    )


def pad_coeffs_to_bucket(geom: Geometry, bucket: Geometry,
                         coeffs: np.ndarray, out: np.ndarray) -> None:
    """Scatter real-layout coefficients into a bucket-layout row (host).

    Block order is MCU-raster, so each real MCU row lands at the same row
    of the bucket grid, followed by zero padding MCUs.  `out` must be a
    zeroed [bucket.n_blocks, 64] view."""
    bpm = geom.blocks_per_mcu
    view = out.reshape(bucket.mcus_y, bucket.mcus_x, bpm, 64)
    view[: geom.mcus_y, : geom.mcus_x] = coeffs.reshape(
        geom.mcus_y, geom.mcus_x, bpm, 64
    )


def unpad_coeffs_from_bucket(geom: Geometry, bucket: Geometry,
                             out: np.ndarray) -> np.ndarray:
    """Real-layout [n_blocks, 64] copy of a bucket-layout row (host)."""
    bpm = geom.blocks_per_mcu
    view = out.reshape(bucket.mcus_y, bucket.mcus_x, bpm, 64)
    return np.ascontiguousarray(
        view[: geom.mcus_y, : geom.mcus_x]
    ).reshape(geom.n_blocks, 64)


def soa_planes(geom: Geometry, coeffs: torch.Tensor, quant: torch.Tensor,
               dc: torch.Tensor | None):
    """The pixel kernel's inputs (its prologue): one zigzag -> k-major row
    permute and SoA transpose, the DC plane, TILE padding.

    coeffs [B, n_blocks, 64] (zigzag), quant [B, 3, 64] (zigzag), dc
    [B, n_blocks] resolved DC or None.  Returns (zp int16 [B, 3, 64, P],
    quant_km int32 [B, 3, 64, 1], dc_planes int32 [B, 3, 1, P])."""
    B = coeffs.shape[0]
    n = geom.n_mcus
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


def _raster_from_blocks(geom: Geometry, chans, risky):
    """Block-domain colour planes ([B, 64, n_mcus] each, full resolution)
    -> (rgb uint8 [B, 3, H, W], packed riskbits): one uint8 raster
    transpose and the crop."""
    B = risky.shape[0]
    my, mx = geom.mcus_y, geom.mcus_x
    rgb = torch.stack(chans, dim=1)                       # [B, 3, 64, n]
    rgb = (
        rgb.reshape(B, 3, 8, 8, my, mx)
        .permute(0, 1, 4, 2, 5, 3)
        .reshape(B, 3, my * 8, mx * 8)
    )
    risky = (
        risky.reshape(B, 8, 8, my, mx)
        .permute(0, 3, 1, 4, 2)
        .reshape(B, my * 8, mx * 8)
    )
    rgb = rgb[:, :, : geom.height, : geom.width]
    return rgb, pack_mask(risky[:, : geom.height, : geom.width])


def _idct_planar(geom: Geometry, coeffs: torch.Tensor, quant: torch.Tensor,
                 dc: torch.Tensor | None = None) -> torch.Tensor:
    """Dequant + inverse zigzag + IDCT in coefficient-major (SoA) layout.

    Returns int32 [B, 64, n_blocks]: row p = raster position p of every
    block, blocks ordered component-planar (all of component 0, then 1,
    ...), MCU-major within a component.  The dequant runs in the zigzag
    domain and the inverse zigzag is a static reorder of the 64-row axis.

    dc (optional): int32 [B, n_blocks] of resolved DC coefficients that
    override coeffs[..., 0] (the fused chunks leave DPCM differences in
    the dense tensor).  Products are taken in int64 and reduced to int32
    by `idct_planes`, which gives the bits of the JAX package's wrapping
    int32 multiply."""
    B = coeffs.shape[0]
    n, bpm = geom.n_mcus, geom.blocks_per_mcu
    per_mcu = coeffs.reshape(B, n, bpm, 64)
    dc_mcu = None if dc is None else dc.reshape(B, n, bpm)
    z2n = torch.as_tensor(np.asarray(ZIGZAG_TO_NATURAL), dtype=torch.long,
                          device=coeffs.device)
    q = quant.to(torch.int64)
    soa = []
    base = 0
    for ci, (h, v, _) in enumerate(geom.comps):
        nb = h * v
        zp = per_mcu[:, :, base : base + nb, :].reshape(B, n * nb, 64)
        deq = zp.transpose(1, 2).to(torch.int64) * q[:, ci, :, None]
        if dc_mcu is not None:
            dcc = dc_mcu[:, :, base : base + nb].reshape(B, 1, n * nb)
            deq = torch.cat(
                [dcc.to(torch.int64) * q[:, ci, 0:1, None], deq[:, 1:]],
                dim=1)
        soa.append(deq.index_select(1, z2n))
        base += nb
    return idct_planes(torch.cat(soa, dim=2))


def _plane_from_soa(geom: Geometry, pix_c: torch.Tensor, h: int,
                    v: int) -> torch.Tensor:
    """[B, 64, n_mcus*h*v] SoA pixels of one component -> raster planes
    [B, mcus_y*v*8, mcus_x*h*8]."""
    B = pix_c.shape[0]
    grid = pix_c.reshape(B, 8, 8, geom.mcus_y, geom.mcus_x, v, h)
    return grid.permute(0, 3, 5, 1, 4, 6, 2).reshape(
        B, geom.mcus_y * v * 8, geom.mcus_x * h * 8
    )


def decode_subsampled_planes(geom: Geometry, coeffs: torch.Tensor,
                             quant: torch.Tensor,
                             dc: torch.Tensor | None = None):
    """Coefficients -> per-component centred planes [B, Hc, Wc] at each
    component's native resolution (dequant, inverse zigzag, integer IDCT,
    block -> raster; no upsampling yet)."""
    pix = _idct_planar(geom, coeffs, quant, dc)
    planes = []
    base = 0
    for h, v, _ in geom.comps:
        n = geom.n_mcus * h * v
        planes.append(_plane_from_soa(geom, pix[:, :, base : base + n], h, v))
        base += n
    return planes


def upsample_planes(geom: Geometry, planes, fancy: bool, extents=None):
    """Native-resolution planes -> full-resolution planes (box or fancy).

    extents: optional int tensor [B, 2] of true (mcus_y, mcus_x) for a
    bucket-padded chunk: moves the fancy filter's bottom and right
    replication edges to each image's real sample extent (box
    replication is pointwise and needs nothing)."""
    from .ops.upsample import upsample_plane

    return [
        upsample_plane(
            p, geom.max_h // h, geom.max_v // v, fancy,
            true_hw=(
                None if extents is None
                else (extents[:, 0] * (v * 8), extents[:, 1] * (h * 8))
            ),
        )
        for p, (h, v, _) in zip(planes, geom.comps)
    ]


def planes_to_rgb(geom: Geometry, planes):
    """Full-resolution planes [B, Hp, Wp] -> (rgb uint8 planar [B, 3, H,
    W], packed riskbits); one plane is grayscale (zero chroma)."""
    planes = [p[:, : geom.height, : geom.width] for p in planes]
    if len(planes) == 1:
        zeros = torch.zeros_like(planes[0])
        planes = [planes[0], zeros, zeros]
    chans, risky = color_channels(*planes)
    return torch.stack(chans, dim=1), pack_mask(risky)


def device_decode_fn(geom: Geometry, coeffs: torch.Tensor,
                     quant: torch.Tensor, fancy: bool = False,
                     dc: torch.Tensor | None = None, extents=None):
    """Coefficients -> (rgb uint8 planar [B, 3, H, W], packed riskbits
    uint8 [B, H, ceil(W/8)]).

    coeffs:  int16/int32 [B, n_blocks, 64], zigzag order, scan order.
    quant:   int32 [B, n_comp, 64], zigzag order.
    fancy:   libjpeg's triangle chroma upsampling (subsampled streams
             only; box replication otherwise).
    dc:      optional int32 [B, n_blocks] resolved DC that overrides
             coeffs[..., 0] (the fused FSM chunk leaves DPCM differences
             there).
    extents: optional int tensor [B, 2], true (mcus_y, mcus_x) per image
             when `geom` is a size-class bucket that the images only
             partly fill: the fancy upsampler's edges are the only place
             where the true size matters.

    Routing as in the JAX package: three full-resolution components take
    the block-domain pixel kernel (prologue, `rgb_soa_fused`, unpack, one
    uint8 raster transpose); grayscale takes the same block-domain order
    through `_idct_planar`; subsampled geometries take the plane path.
    """
    if geom.max_h == 1 and geom.max_v == 1:
        n = geom.n_mcus
        if len(geom.comps) == 3:
            rg, bk = rgb_soa_fused(*soa_planes(geom, coeffs, quant, dc))
            chans, risky = unpack_pixels(rg[..., :n], bk[..., :n])
        else:
            pix = _idct_planar(geom, coeffs, quant, dc)    # [B, 64, n]
            zeros = torch.zeros_like(pix)
            chans, risky = color_channels(pix, zeros, zeros)
        return _raster_from_blocks(geom, chans, risky)
    planes = decode_subsampled_planes(geom, coeffs, quant, dc)
    return planes_to_rgb(geom, upsample_planes(geom, planes, fancy, extents))


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


def build_plan(img: JpegImage) -> tuple[Geometry, np.ndarray, np.ndarray]:
    """Host side: entropy-decode the scan and pack device inputs."""
    from .runtime.host import entropy_decode

    coeffs = entropy_decode(img)
    quant = np.stack(
        [img.quant_tables[c.quant_id].astype(np.int32) for c in img.components]
    )
    return Geometry.of(img), coeffs, quant


def decode(img: JpegImage, device, strict: bool = True,
           fancy: bool = False) -> np.ndarray:
    """Decode one image on `device`.  Returns int32 [H, W, 3] RGB.

    strict=True repairs flagged colour-boundary pixels with the oracle's
    exact math, so the output is bit-exact with the reference decoder
    (and, for fancy=True, with the numpy fancy-upsampling oracle).
    """
    geom, coeffs, quant = build_plan(img)
    rgb_dev, riskbits = device_decode_fn(
        geom,
        torch.as_tensor(coeffs).to(device)[None],
        torch.as_tensor(quant).to(device)[None],
        fancy=fancy,
    )
    rgb = np.ascontiguousarray(
        np.moveaxis(rgb_dev[0].cpu().numpy(), 0, -1)
    ).astype(np.int32)
    if strict:
        mask = unpack_mask(riskbits[0].cpu().numpy(), img.width)
        if mask.any():
            _repair(img, coeffs, rgb, mask, fancy=fancy)
    return rgb


def _comp_samples(img, coeffs, quant_ci, comp_base_ci, c, cy, cx) -> np.ndarray:
    """Oracle IDCT sample values of one component at plane coords (cy, cx).

    Vectorized over pixel lists; cost is a few 8x8 IDCTs on the unique
    touched blocks.  Coordinates are in the component's own (subsampled)
    padded plane.
    """
    by, bx = cy // 8, cx // 8
    mcu = (by // c.v) * img.mcus_x + (bx // c.h)
    block_idx = (
        mcu * img.blocks_per_mcu + comp_base_ci + (by % c.v) * c.h + (bx % c.h)
    )
    uniq, inv = np.unique(block_idx, return_inverse=True)
    zz = coeffs[uniq].astype(np.int64) * quant_ci[None, :]
    natural = zz[:, ZIGZAG_TO_NATURAL].reshape(-1, 8, 8).astype(np.int32)
    pix = oracle.idct_blocks(natural)
    return pix[inv, cy % 8, cx % 8]


def _repair(img: JpegImage, coeffs: np.ndarray, rgb: np.ndarray,
            mask: np.ndarray, fancy: bool = False) -> None:
    """Recompute flagged pixels with the exact oracle math, in place
    (O(flagged pixels)).  With fancy=True the chroma samples that feed
    the exact colour math are rebuilt through the same triangle filter as
    the device (ops/upsample.py), from clamped samples, with replication
    at the image's true padded edge; factors above 2 take the nearest
    sample, as the device's box fallback does."""
    py, px = np.nonzero(mask)
    comps = img.components
    max_h, max_v = img.max_h, img.max_v
    comp_base = np.cumsum([0] + [c.h * c.v for c in comps])
    samples = []
    for ci, c in enumerate(comps):
        fy, fx = max_v // c.v, max_h // c.h
        quant = img.quant_tables[c.quant_id].astype(np.int64)
        val = functools.partial(
            _comp_samples, img, coeffs, quant, comp_base[ci], c
        )
        if (fy == 1 and fx == 1) or not fancy or fy > 2 or fx > 2:
            # box path (or a full-resolution component): nearest sample
            samples.append(val(py // fy, px // fx))
            continue
        # fancy: rebuild the triangle filter from clamped samples
        hc = img.mcus_y * c.v * 8
        wc = img.mcus_x * c.h * 8
        r, col = py // fy, px // fx
        rn = np.clip(r + np.where(py % 2 == 1, 1, -1), 0, hc - 1) \
            if fy == 2 else r
        cn = np.clip(col + np.where(px % 2 == 1, 1, -1), 0, wc - 1) \
            if fx == 2 else col

        def s(rr, cc):
            return np.clip(val(rr, cc) + 128, 0, 255).astype(np.int64)

        if fy == 2 and fx == 2:
            v = (
                9 * s(r, col) + 3 * s(r, cn) + 3 * s(rn, col) + s(rn, cn)
                + np.where(px % 2 == 1, 7, 8)
            ) >> 4
        elif fx == 2:
            v = (3 * s(r, col) + s(r, cn) + np.where(px % 2 == 1, 2, 1)) >> 2
        else:  # fy == 2
            v = (3 * s(r, col) + s(rn, col) + np.where(py % 2 == 1, 2, 1)) >> 2
        samples.append(v - 128)
    if len(comps) == 1:
        y = samples[0]
        cb = cr = np.zeros_like(y)
    else:
        y, cb, cr = samples
    rgb[py, px] = oracle.ycbcr_to_rgb_exact(y, cb, cr)
