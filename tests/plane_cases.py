"""Inputs of the subsampled pixel stage shared by its tests: the planes
kernel against the plain plane path on the card
(tests/test_torch_kernels.py) and the plain plane path against the JAX
package's device_decode_fn on the CPU (tests/test_torch_planes.py).

Imports nothing of JAX.  `plane_case(name)` -> (geom tuple, coeffs,
quant, dc or None, extents or None), numpy arrays:

  * rst420-*, photo420-*: the committed 4:2:0 streams of
    tests/fixtures/rst640_420 and photo640_420 (640 x 640), the host
    decoder's coefficients as int32, or as int16 with a resolved DC that
    overrides a coefficient 0 of junk;
  * mixed420-bucket: three streams of tests/fixtures/mixed_rst_420 padded
    into their size-class bucket's MCU rows with their true extents, a row
    of seeded coefficients whose extent is one MCU, and a padding row of
    zeros with the bucket's own extents (as the host-bucketed route pads);
  * 411: tests/fixtures/sampling_small/411_rst.jpg (fancy falls back to
    box at 4x);
  * 422-*, 440-*: seeded coefficients at a size that is no multiple of
    the MCU, with seeded extents.
"""

import os

import numpy as np

from tpujpeg_torch.io.parser import parse_file
from tpujpeg_torch.pipeline import (Geometry, bucket_geometry,
                                    pad_coeffs_to_bucket)
from tpujpeg_torch.runtime.host import entropy_decode

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

PLANE_CASES = ["rst420-int32-b3", "rst420-int16-dc-b1", "photo420-int32-b3",
               "mixed420-bucket-b5", "411-int32-b1", "422-int16-dc-ext-b33",
               "440-int32-ext-b3"]

_SAMPLING = {"422": ((2, 1, 0), (1, 1, 1), (1, 1, 2)),
             "440": ((1, 2, 0), (1, 1, 1), (1, 1, 2))}


def _images(folder, n):
    d = os.path.join(FIXTURES, folder)
    return [parse_file(os.path.join(d, f)) for f in sorted(os.listdir(d))[:n]]


def _quant(imgs, B):
    q = np.zeros((B, len(imgs[0].components), 64), np.int32)
    for i, im in enumerate(imgs):
        q[i] = np.stack([im.quant_tables[c.quant_id] for c in im.components])
    q[len(imgs):] = q[0]
    return q


def _streams(imgs, int16_dc, rng):
    coeffs = np.stack([entropy_decode(im) for im in imgs])
    dc = None
    if int16_dc:
        dc = coeffs[..., 0].astype(np.int32)
        coeffs = coeffs.astype(np.int16)
        coeffs[..., 0] = rng.integers(-2048, 2048, coeffs.shape[:2])
    return tuple(Geometry.of(imgs[0])), coeffs, _quant(imgs, len(imgs)), \
        dc, None


def _bucket(rng):
    d = os.path.join(FIXTURES, "mixed_rst_420")
    imgs = [parse_file(os.path.join(d, f)) for f in sorted(os.listdir(d))]
    bucket = bucket_geometry(Geometry.of(imgs[0]))
    imgs = [im for im in imgs if bucket_geometry(Geometry.of(im)) == bucket]
    imgs = imgs[:3]
    B = len(imgs) + 2
    coeffs = np.zeros((B, bucket.n_blocks, 64), np.int32)
    for i, im in enumerate(imgs):
        pad_coeffs_to_bucket(Geometry.of(im), bucket, entropy_decode(im),
                             coeffs[i])
    coeffs[len(imgs)] = rng.integers(-40, 41, coeffs.shape[1:])
    ext = np.tile(np.asarray([bucket.mcus_y, bucket.mcus_x], np.int32),
                  (B, 1))
    ext[: len(imgs)] = [(im.mcus_y, im.mcus_x) for im in imgs]
    ext[len(imgs)] = (1, 1)
    return tuple(bucket), coeffs, _quant(imgs, B), None, ext


def _seeded(sampling, B, width, height, dtype, with_dc, rng):
    comps = _SAMPLING[sampling]
    mh = max(c[0] for c in comps)
    mv = max(c[1] for c in comps)
    mx, my = -(-width // (8 * mh)), -(-height // (8 * mv))
    geom = Geometry((width, height, mx, my, comps))
    coeffs = rng.integers(-60, 61, (B, geom.n_blocks, 64)).astype(dtype)
    coeffs[..., 0] = rng.integers(-1000, 1001, (B, geom.n_blocks))
    quant = rng.integers(1, 31, (B, 3, 64)).astype(np.int32)
    dc = rng.integers(-1000, 1001, (B, geom.n_blocks)).astype(np.int32) \
        if with_dc else None
    ext = np.stack([rng.integers(1, my + 1, B), rng.integers(1, mx + 1, B)],
                   axis=1).astype(np.int32)
    ext[0] = (1, 1)
    return tuple(geom), coeffs, quant, dc, ext


def plane_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "rst420-int32-b3":
        return _streams(_images("rst640_420", 3), False, rng)
    if name == "rst420-int16-dc-b1":
        return _streams(_images("rst640_420", 1), True, rng)
    if name == "photo420-int32-b3":
        return _streams(_images("photo640_420", 3), False, rng)
    if name == "mixed420-bucket-b5":
        return _bucket(rng)
    if name == "411-int32-b1":
        img = parse_file(os.path.join(FIXTURES, "sampling_small",
                                      "411_rst.jpg"))
        return _streams([img], False, rng)
    if name == "422-int16-dc-ext-b33":
        return _seeded("422", 33, 61, 45, np.int16, True, rng)
    if name == "440-int32-ext-b3":
        return _seeded("440", 3, 70, 37, np.int32, False, rng)
    raise KeyError(name)
