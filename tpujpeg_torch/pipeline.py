"""Pixel pipeline: coefficients -> RGB, and the single-image decode.

Counterpart of the 4:4:4 branch of tpujpeg/pipeline.py.  The batch axis
that the JAX package adds with vmap is written out: every device
function here takes a leading batch dimension B.

  * `device_decode_fn(geom, coeffs, quant, dc)`: [B, n_blocks, 64] zigzag
    coefficients -> (rgb uint8 [B, 3, H, W], riskbits uint8 [B, H, W/8]);
  * `decode(img, device)`: host entropy (the native C++ decoder of
    runtime/native) + the pixel stage + strict repair.

  * `bucket_geometry(geom)`: the size-class bucket of a geometry, with
    `pad_coeffs_to_bucket` / `unpad_coeffs_from_bucket` for the host side
    of mixed-size chunks.

Only three full-resolution components are ported.  Any other geometry
raises NotImplementedError naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import ZIGZAG_TO_NATURAL
from .io.parser import JpegImage
from .oracle import decoder as oracle

from .ops.color import pack_mask, unpack_mask
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
# back to its true height and width.  4:4:4 pixels are pointwise in the
# block domain, so the true extents never reach the pixel stage.


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


def check_supported(geom: Geometry) -> None:
    """Raise NotImplementedError for geometries the port lacks."""
    if len(geom.comps) != 3 or geom.max_h != 1 or geom.max_v != 1:
        raise NotImplementedError(
            "tpujpeg_torch decodes 3-component full-resolution (4:4:4) "
            "streams only; subsampled and grayscale streams are ROADMAP "
            "queue 1 item 12"
        )


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


def device_decode_fn(geom: Geometry, coeffs: torch.Tensor,
                     quant: torch.Tensor, dc: torch.Tensor | None = None):
    """Coefficients -> (rgb uint8 planar [B, 3, H, W], packed riskbits
    uint8 [B, H, ceil(W/8)]).

    4:4:4 pixels in the block domain (prologue, pixel kernel, unpack),
    then one uint8 raster transpose.

    coeffs: int16/int32 [B, n_blocks, 64], zigzag order, scan order.
    quant:  int32 [B, n_comp, 64], zigzag order.
    dc:     optional int32 [B, n_blocks] resolved DC that overrides
            coeffs[..., 0] (the fused FSM chunk leaves DPCM differences
            there).
    """
    check_supported(geom)
    n = geom.n_mcus
    rg, bk = rgb_soa_fused(*soa_planes(geom, coeffs, quant, dc))
    chans, risky = unpack_pixels(rg[..., :n], bk[..., :n])
    B = coeffs.shape[0]
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


def decode(img: JpegImage, device, strict: bool = True) -> np.ndarray:
    """Decode one image on `device`.  Returns int32 [H, W, 3] RGB.

    strict=True repairs flagged colour-boundary pixels with the oracle's
    exact math, so the output is bit-exact with the reference decoder.
    """
    geom, coeffs, quant = build_plan(img)
    check_supported(geom)
    rgb_dev, riskbits = device_decode_fn(
        geom,
        torch.as_tensor(coeffs).to(device)[None],
        torch.as_tensor(quant).to(device)[None],
    )
    rgb = np.ascontiguousarray(
        np.moveaxis(rgb_dev[0].cpu().numpy(), 0, -1)
    ).astype(np.int32)
    if strict:
        mask = unpack_mask(riskbits[0].cpu().numpy(), img.width)
        if mask.any():
            _repair(img, coeffs, rgb, mask)
    return rgb


def _comp_samples(img, coeffs, quant_ci, comp_base_ci, c, cy, cx) -> np.ndarray:
    """Oracle IDCT sample values of one component at plane coords (cy, cx).

    Vectorized over pixel lists; cost is a few 8x8 IDCTs on the unique
    touched blocks.
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
            mask: np.ndarray) -> None:
    """Recompute flagged pixels of a full-resolution image with the exact
    oracle math, in place (O(flagged pixels)).  The subsampled repair
    (fancy upsampling) comes with ROADMAP queue 1 item 12."""
    py, px = np.nonzero(mask)
    comps = img.components
    comp_base = np.cumsum([0] + [c.h * c.v for c in comps])
    samples = []
    for ci, c in enumerate(comps):
        quant = img.quant_tables[c.quant_id].astype(np.int64)
        samples.append(
            _comp_samples(img, coeffs, quant, comp_base[ci], c, py, px)
        )
    y, cb, cr = samples
    rgb[py, px] = oracle.ycbcr_to_rgb_exact(y, cb, cr)
