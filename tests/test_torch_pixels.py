"""tpujpeg_torch pixel stage == the JAX package's Pallas pixel path.

The port's `device_decode_fn` (plain PyTorch on CPU tensors) against the
JAX `_decode_rgb_planar_fused` with the
Pallas kernel forced on (interpret mode), on the cases of
tests/test_pixels_pallas.py.  Tolerance, the JAX package's own rule
(tests/test_pixels_pallas.py::_assert_paths_agree): the risk masks are
identical, and rgb is identical outside the risk mask — f32 rounding may
differ only inside the flagged EPS band, which strict decodes repair
with the reference's exact math.  Then the port's single-image decode on
the 6 goldens must equal the reference's .array outputs exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpujpeg_torch
from tpujpeg import pipeline as jpipe
from tpujpeg.io.arrayio import read_array
from tpujpeg.io.parser import parse
from tpujpeg.ops import color as jcolor
from tpujpeg.ops import idct as jidct
from tpujpeg_torch import pipeline as tpipe
from tpujpeg_torch.ops import color as tcolor
from tpujpeg_torch.ops import idct as tidct

from conftest import GOLDEN, fixture_path, make_jpeg


def _agree(geom, want, got):
    rgb_w, risk_w = np.asarray(want[0]), np.asarray(want[1])
    rgb_g, risk_g = got[0][0].numpy(), got[1][0].numpy()
    assert rgb_g.dtype == np.uint8 and rgb_g.shape == rgb_w.shape
    np.testing.assert_array_equal(risk_g, risk_w)
    safe = ~jcolor.unpack_mask(risk_w, geom.width)
    np.testing.assert_array_equal(rgb_g[:, safe], rgb_w[:, safe])


def _both(monkeypatch, geom, coeffs, quant, dc=None):
    monkeypatch.setattr(jpipe, "_pixel_pallas_mode", lambda g: True)
    want = jpipe._decode_rgb_planar_fused(
        geom, jnp.asarray(coeffs), jnp.asarray(quant),
        None if dc is None else jnp.asarray(dc),
    )
    got = tpipe.device_decode_fn(
        tpipe.Geometry(geom), torch.as_tensor(coeffs)[None],
        torch.as_tensor(quant)[None],
        dc=None if dc is None else torch.as_tensor(dc)[None],
    )
    return want, got


@pytest.mark.parametrize("shape", [(48, 64), (64, 128), (225, 168)])
def test_pixels_match_jax_on_streams(monkeypatch, shape):
    img = parse(make_jpeg(shape=shape, quality=85, seed=3))
    geom, coeffs, quant = jpipe.build_plan(img)
    _agree(geom, *_both(monkeypatch, geom, coeffs, quant))


def test_pixels_match_jax_with_dc_side_channel(monkeypatch):
    img = parse(make_jpeg(shape=(64, 80), quality=90, seed=7))
    geom, coeffs, quant = jpipe.build_plan(img)
    rng = np.random.default_rng(1)
    dc = rng.integers(-1024, 1024, coeffs.shape[0]).astype(np.int32)
    garbled = coeffs.copy()
    garbled[:, 0] = rng.integers(-2048, 2047, coeffs.shape[0])
    _agree(geom, *_both(monkeypatch, geom, garbled, quant, dc))


def test_pixels_match_jax_extreme_coefficients(monkeypatch):
    # int ranges at their limits: the int32 wraparound must match
    img = parse(make_jpeg(shape=(40, 48), quality=10, seed=5))
    geom, coeffs, quant = jpipe.build_plan(img)
    rng = np.random.default_rng(2)
    coeffs = rng.integers(-1023, 1024, coeffs.shape).astype(np.int16)
    coeffs[:, 0] = rng.integers(-2047, 2048, coeffs.shape[0])
    _agree(geom, *_both(monkeypatch, geom, coeffs, quant))


@pytest.mark.parametrize("extreme", [False, True])
def test_rgb_soa_fused_plain_matches_the_jax_kernel(extreme):
    # the plain mirror of _pixel_kernel on the same k-major SoA planes as
    # the Pallas kernel in interpret mode: risk bits equal, r, g, b equal
    # where neither flags
    from tpujpeg.ops import pixels_pallas as jpix
    from tpujpeg_torch.ops import pixels as tpix

    rng = np.random.default_rng(8 + extreme)
    hi = 1024 if extreme else 60
    zp = rng.integers(-hi, hi, (3, 64, 512)).astype(np.int16)
    q = rng.integers(1, 256 if extreme else 30, (3, 64, 1)).astype(np.int32)
    dcp = rng.integers(-2047, 2048, (3, 1, 512)).astype(np.int32)
    want = jpix.rgb_soa_fused(*map(jnp.asarray, (zp, q, dcp)),
                              interpret=True)
    got = tpix.rgb_soa_fused_plain(*(torch.as_tensor(a)[None]
                                     for a in (zp, q, dcp)))
    (wrg, wbk), (grg, gbk) = [[np.asarray(x).astype(np.int32) & 0xFFFF
                               for x in pair] for pair in (want, got)]
    grg, gbk = grg[0], gbk[0]
    np.testing.assert_array_equal(gbk >> 8, wbk >> 8)
    safe = (wbk >> 8) == 0
    np.testing.assert_array_equal(grg[safe], wrg[safe])
    np.testing.assert_array_equal(gbk[safe], wbk[safe])


def test_idct_planes_matches_jax():
    rng = np.random.default_rng(4)
    planes = rng.integers(-(1 << 20), 1 << 20, (64, 256)).astype(np.int32)
    want = np.asarray(jidct.idct_planes(jnp.asarray(planes)))
    got = tidct.idct_planes(torch.as_tensor(planes))
    np.testing.assert_array_equal(got.numpy(), want)


def test_color_and_pack_mask_match_jax():
    rng = np.random.default_rng(6)
    y, cb, cr = rng.integers(-256, 256, (3, 4096)).astype(np.int32)
    (wr, wg, wb), wrisk = jcolor.color_core(*map(jnp.asarray, (y, cb, cr)))
    (gr, gg, gb), grisk = tcolor.color_core(*map(torch.as_tensor, (y, cb, cr)))
    for w, g in ((wr, gr), (wg, gg), (wb, gb), (wrisk, grisk)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    (wr, wg, wb), _ = jcolor.color_channels(*map(jnp.asarray, (y, cb, cr)))
    (gr, gg, gb), _ = tcolor.color_channels(*map(torch.as_tensor, (y, cb, cr)))
    for w, g in ((wr, gr), (wg, gg), (wb, gb)):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mask = rng.random((5, 37)) < 0.3
    np.testing.assert_array_equal(
        tcolor.pack_mask(torch.as_tensor(mask)).numpy(),
        np.asarray(jcolor.pack_mask(jnp.asarray(mask))),
    )


@pytest.mark.parametrize("name", GOLDEN)
def test_port_decode_matches_golden(name):
    got = tpujpeg_torch.decode(fixture_path(name), device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, read_array(fixture_path(name, ".array")))


def test_unsupported_geometry_raises():
    # The name is from when the port refused every geometry but 4:4:4.  It
    # decodes them now: 4:2:0 and grayscale through the plane path equal
    # the oracle, with box and with fancy upsampling
    from tpujpeg.oracle import decoder as oracle

    for kw in (dict(subsampling=2), dict(gray=True)):
        data = make_jpeg(shape=(32, 48), seed=1, **kw)
        for fancy in (False, True):
            got = tpujpeg_torch.decode(data, device="cpu", fancy=fancy)
            np.testing.assert_array_equal(
                got, oracle.decode(parse(data), fancy=fancy))
    assert not hasattr(tpipe, "check_supported")
