"""Pixel pipeline: coefficients -> RGB, and the single-image decode.

Counterpart of tpujpeg/pipeline.py.  The batch axis that the JAX package
adds with vmap is written out: every device function here takes a
leading batch dimension B.

  * `device_decode_fn(geom, coeffs, quant, fancy, dc, extents, exact)`:
    [B, n_blocks, 64] zigzag coefficients -> (rgb uint8 [B, 3, H, W],
    riskbits uint8 [B, H, W/8], None when exact).  Three full-resolution
    components (4:4:4) go through the fused pixel kernel
    (ops/pixels.rgb_444), which writes the cropped raster itself; every
    subsampled geometry (4:2:0, 4:2:2, 4:4:0, 4:1:1) takes the plane
    path, ops/planes.planes_rgb: on CUDA tensors one launch of the planes
    kernel (csrc/planes.cu), on CPU tensors the plain plane path
    (`decode_subsampled_planes`: `_idct_planar`, `_plane_from_soa`; then
    `upsample_planes`, box or fancy, ops/upsample.py; `planes_to_rgb`),
    its contract.  The JAX package has no Pallas kernel on the plane
    path.  Grayscale stays plain PyTorch (`_idct_planar` in the block
    domain, `raster_from_blocks`).
    exact=True computes colour with the reference's exact mixed
    precision (ops/color.color_exact; the kernel's exact mode), so the
    output is the reference decoder's and needs no repair;
  * `decode(img, device, strict, fancy)`: host entropy (the native C++
    decoder of runtime/native) + the pixel stage, exact when strict;
    `decode_file(path, device, strict)` on a file;
  * `bucket_geometry(geom)`: the size-class bucket of a geometry, with
    `pad_coeffs_to_bucket` for the host side of mixed-size chunks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import ZIGZAG_TO_NATURAL
from .io.parser import JpegImage

from .ops.color import color_channels, color_exact, pack_mask
from .ops.idct import idct_planes
from .ops.pixels import block_lanes, raster_from_blocks, rgb_444
from .ops.planes import planes_rgb


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

    @property
    def is_444(self) -> bool:
        """Three full-resolution components: the pixel kernel's case."""
        return len(self.comps) == 3 and self.max_h == 1 and self.max_v == 1


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


def planes_to_rgb(geom: Geometry, planes, exact: bool = False):
    """Full-resolution planes [B, Hp, Wp] -> (rgb uint8 planar [B, 3, H,
    W], packed riskbits, None when exact); one plane is grayscale (zero
    chroma)."""
    planes = [p[:, : geom.height, : geom.width] for p in planes]
    if len(planes) == 1:
        zeros = torch.zeros_like(planes[0])
        planes = [planes[0], zeros, zeros]
    if exact:
        return torch.stack(color_exact(*planes), dim=1), None
    chans, risky = color_channels(*planes)
    return torch.stack(chans, dim=1), pack_mask(risky)


def device_decode_fn(geom: Geometry, coeffs: torch.Tensor,
                     quant: torch.Tensor, fancy: bool = False,
                     dc: torch.Tensor | None = None, extents=None,
                     exact: bool = False):
    """Coefficients -> (rgb uint8 planar [B, 3, H, W], packed riskbits
    uint8 [B, H, ceil(W/8)], or None when exact).

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
    exact:   the reference's exact colour, no risk bits (strict decodes);
             False is the f32 colour with risk flags of the JAX package.

    Routing as in the JAX package: three full-resolution components take
    the pixel kernel (`rgb_444`, one MCU-row run per image row); grayscale
    takes the block-domain order through `_idct_planar`; subsampled
    geometries take the plane path (`planes_rgb`: the planes kernel on
    the card, the plain plane path on the CPU).
    """
    if geom.is_444:
        B = coeffs.shape[0]
        return rgb_444(geom, coeffs.to(torch.int16).contiguous(),
                       block_lanes(B, geom.mcus_y, geom.mcus_x,
                                   coeffs.device),
                       quant.to(torch.int32).contiguous(),
                       dc=None if dc is None else dc.to(torch.int32),
                       exact=exact)
    if geom.max_h == 1 and geom.max_v == 1:
        pix = _idct_planar(geom, coeffs, quant, dc)    # [B, 64, n]
        zeros = torch.zeros_like(pix)
        if exact:
            return raster_from_blocks(geom, color_exact(pix, zeros, zeros),
                                      None)
        return raster_from_blocks(geom, *color_channels(pix, zeros, zeros))
    if dc is not None:
        dc = dc.to(torch.int32).contiguous()
    if extents is not None:
        extents = extents.to(torch.int32).contiguous()
    return planes_rgb(geom, coeffs.contiguous(),
                      quant.to(torch.int32).contiguous(), fancy=fancy, dc=dc,
                      extents=extents, exact=exact)


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

    strict=True computes colour with the reference's exact math on the
    device, so the output is bit-exact with the reference decoder (and,
    for fancy=True, with the numpy fancy-upsampling oracle); strict=False
    is the f32 colour of the JAX package's strict=False.
    """
    geom, coeffs, quant = build_plan(img)
    rgb_dev, _ = device_decode_fn(
        geom,
        torch.as_tensor(coeffs).to(device)[None],
        torch.as_tensor(quant).to(device)[None],
        fancy=fancy, exact=strict,
    )
    return np.ascontiguousarray(
        np.moveaxis(rgb_dev[0].cpu().numpy(), 0, -1)
    ).astype(np.int32)


def decode_file(path: str, device="cuda", strict: bool = True) -> np.ndarray:
    """Decode the JPEG file at `path` on `device` (`decode`)."""
    from .io.parser import parse_file

    return decode(parse_file(path), device=device, strict=strict)
