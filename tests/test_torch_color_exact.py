"""tpujpeg_torch exact colour and the 4:4:4 pixel stage in both colour
modes and both coefficient layouts, on the CPU.

  * `color.color_exact` `==` the port's oracle `ycbcr_to_rgb_exact` and
    the JAX package's, on every 8th Y slab of [-256, 255]^3 (one case per
    slab: 262,144 triples each, 16.8 M in all), on the Cb = 0 and Cr = 0
    planes and on grayscale (zero chroma), every Y;
  * `pixels.rgb_444` (its plain version on CPU tensors) from the dense
    lane matrix [max_blk*64, L] of a restart plan and from [B, n_blocks,
    64]: the f32 mode against the JAX `_decode_rgb_planar_fused` with the
    Pallas kernel in interpret mode (the rule of
    tests/test_torch_pixels.py: risk masks equal, rgb equal outside
    them), the exact mode `==` the oracle's decode;
  * the lane tables cover every MCU of every image once;
  * the engine's strict outputs on restart and bucketed streams, on
    both routes, `==` the JAX strict engine's and the oracle's, the
    goldens `==` the reference's, with repaired_pixels 0 (the
    speculative, 4:2:0 and grayscale engine cases hold it through
    tests/test_torch_buckets.py::_stats_equal and
    tests/test_torch_spec.py).

Inputs are seeded numpy data and streams the cv2 and PIL encoders make
from a seed.  Tolerance 0 everywhere but the stated f32 risk rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujpeg import pipeline as jpipe
from tpujpeg.io.arrayio import read_array
from tpujpeg.io.parser import parse
from tpujpeg.ops import color as jcolor
from tpujpeg.oracle import decoder as joracle
from tpujpeg.runtime.batch import BatchDecoder as JaxBatchDecoder
from tpujpeg_torch import convert
from tpujpeg_torch.ops import color as tcolor
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.ops import pixels as tpixels
from tpujpeg_torch.oracle import decoder as toracle
from tpujpeg_torch.pipeline import Geometry
from tpujpeg_torch.runtime import fused as tfused
from tpujpeg_torch.runtime.batch import BatchDecoder

from conftest import GOLDEN, fixture_path, make_jpeg, make_jpeg_rst
from test_torch_buckets import MIXED, _mesh1, _rst_rows

_AXIS = np.arange(-256, 256, dtype=np.int32)


def _exact(y, cb, cr):
    got = tcolor.color_exact(*map(torch.as_tensor, (y, cb, cr)))
    return torch.stack(got, dim=-1).numpy()


def _both_oracles_equal(y, cb, cr):
    got = _exact(y, cb, cr)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, toracle.ycbcr_to_rgb_exact(y, cb, cr))
    np.testing.assert_array_equal(got, joracle.ycbcr_to_rgb_exact(y, cb, cr))


@pytest.mark.parametrize("y", range(-256, 256, 8))
def test_color_exact_equals_both_oracles_on_a_y_slab(y):
    cb, cr = np.meshgrid(_AXIS, _AXIS, indexing="ij")
    _both_oracles_equal(np.full(cb.size, y, np.int32), cb.ravel(),
                        cr.ravel())


@pytest.mark.parametrize("plane", ["cb0", "cr0", "gray"])
def test_color_exact_on_zero_chroma(plane):
    # the f32 colour flags every such pixel (its value is an integer);
    # the exact colour needs no flag
    y, c = (a.ravel() for a in np.meshgrid(_AXIS, _AXIS, indexing="ij"))
    zeros = np.zeros_like(y)
    if plane == "gray":
        y, c, zeros = _AXIS, np.zeros_like(_AXIS), np.zeros_like(_AXIS)
        _both_oracles_equal(y, c, zeros)
        _, risky = tcolor.color_core(*map(torch.as_tensor, (y, c, zeros)))
        assert bool(risky.all())
    elif plane == "cb0":
        _both_oracles_equal(y, zeros, c)
    else:
        _both_oracles_equal(y, c, zeros)


def _agree(width, want_rgb, want_risk, rgb, risk):
    """The f32 rule: risk masks equal, rgb equal outside them."""
    want_rgb, want_risk = np.asarray(want_rgb), np.asarray(want_risk)
    rgb, risk = rgb.numpy(), risk.numpy()
    assert rgb.dtype == np.uint8 and rgb.shape == want_rgb.shape
    np.testing.assert_array_equal(risk, want_risk)
    safe = ~jcolor.unpack_mask(want_risk, width)
    np.testing.assert_array_equal(rgb[:, safe], want_rgb[:, safe])


def _jax_f32(monkeypatch, img, coeffs, quant):
    monkeypatch.setattr(jpipe, "_pixel_pallas_mode", lambda g: True)
    geom = jpipe.Geometry.of(img)
    return jpipe._decode_rgb_planar_fused(geom, jnp.asarray(coeffs),
                                          jnp.asarray(quant), None)


def _port_img(img):
    """The port's parsed image of a JAX-parsed stream."""
    return convert.image_from_jax(img)


def _streams(shapes, rst_interval, seed):
    return [parse(make_jpeg_rst(shape=s, rst_interval=rst_interval,
                                seed=seed + i))
            for i, s in enumerate(shapes)]


def _lane_matrix(plan, coeffs, dc_in_row0, rng):
    """The plan's dense lane matrix int16 [max_blk*64, L] and DC plane
    [L, max_blk] from per-image coefficients [B, n_blocks, 64] (DC
    resolved); row 0 holds DC itself, or garbage that the plane
    overrides."""
    L = plan.xs.shape[0]
    dense = np.zeros((L, plan.max_blk, 64), np.int16)
    dc = np.zeros((L, plan.max_blk), np.int32)
    for b, (first, n_lanes, rib, last) in enumerate(plan.layout):
        for j in range(n_lanes):
            n = rib if j < n_lanes - 1 else last
            dense[first + j, :n] = coeffs[b, j * rib : j * rib + n]
            dc[first + j, :n] = coeffs[b, j * rib : j * rib + n, 0]
    if not dc_in_row0:
        dense[:, :, 0] = rng.integers(-2048, 2047, dense.shape[:2])
    lane = torch.as_tensor(dense.reshape(L, -1).T.copy())
    return lane, None if dc_in_row0 else torch.as_tensor(dc)


@pytest.mark.parametrize("dc_plane", [False, True], ids=["dc_row0", "dc_plane"])
@pytest.mark.parametrize("rst", [1, 3])
def test_rgb_444_from_the_lane_matrix(monkeypatch, rst, dc_plane):
    # restart segments of 1 or 3 MCUs (3 wraps MCU rows: 56 px = 7 MCUs),
    # two images and one padding image beyond them
    imgs = _streams([(40, 56), (40, 56)], rst, seed=11)
    coeffs = np.stack([joracle.entropy_decode(im) for im in imgs])
    quant = np.stack([np.stack([im.quant_tables[c.quant_id]
                                for c in im.components]) for im in imgs])
    quant = np.concatenate([quant, quant[:1]]).astype(np.int32)
    plan = tfsm.build_plan([_port_img(im) for im in imgs], split=False)
    lane, dc = _lane_matrix(plan, coeffs, not dc_plane,
                            np.random.default_rng(rst))
    geom = Geometry.of(_port_img(imgs[0]))
    lanes = tfused.restart_lanes(plan.layout, lane.shape[1], 3, geom.mcus_y,
                                 geom.mcus_x, torch.device("cpu"))
    rgb, risk = tpixels.rgb_444(geom, lane, lanes, torch.as_tensor(quant),
                                dc=dc)
    rgb_x, risk_x = tpixels.rgb_444(geom, lane, lanes,
                                    torch.as_tensor(quant), dc=dc,
                                    exact=True)
    assert risk_x is None and tuple(rgb_x.shape) == (3, 3, 40, 56)
    zero = np.zeros_like(coeffs[0])
    for b, im in enumerate(imgs + [None]):
        src = coeffs[b] if im is not None else zero
        _agree(56, *_jax_f32(monkeypatch, imgs[0], src, quant[b]),
               rgb[b], risk[b])
        if im is not None:
            np.testing.assert_array_equal(
                np.moveaxis(rgb_x[b].numpy(), 0, -1), joracle.decode(im))


@pytest.mark.parametrize("shape", [(48, 64), (45, 61)])
def test_rgb_444_from_blocks(monkeypatch, shape):
    # [B, n_blocks, 64]: DC in row 0 and from a DC plane; a width that is
    # not a multiple of 8
    imgs = [parse(make_jpeg(shape=shape, quality=85, seed=s)) for s in (3, 4)]
    geom = Geometry.of(_port_img(imgs[0]))
    coeffs = np.stack([joracle.entropy_decode(im) for im in imgs])
    quant = np.stack([np.stack([im.quant_tables[c.quant_id]
                                for c in im.components])
                      for im in imgs]).astype(np.int32)
    lanes = tpixels.block_lanes(2, geom.mcus_y, geom.mcus_x,
                                torch.device("cpu"))
    garbled = coeffs.astype(np.int16)
    garbled[:, :, 0] = np.random.default_rng(5).integers(
        -2048, 2047, garbled.shape[:2])
    for src, dc in ((coeffs.astype(np.int16), None),
                    (garbled, torch.as_tensor(coeffs[:, :, 0]))):
        args = (geom, torch.as_tensor(src), lanes, torch.as_tensor(quant))
        rgb, risk = tpixels.rgb_444(*args, dc=dc)
        rgb_x, _ = tpixels.rgb_444(*args, dc=dc, exact=True)
        for b, im in enumerate(imgs):
            _agree(shape[1], *_jax_f32(monkeypatch, im, coeffs[b], quant[b]),
                   rgb[b], risk[b])
            np.testing.assert_array_equal(
                np.moveaxis(rgb_x[b].numpy(), 0, -1), joracle.decode(im))


def test_lane_tables_cover_every_mcu_once():
    imgs = [_port_img(im) for im in _streams([(40, 56)] * 3, 3, seed=2)]
    plan = tfsm.build_plan(imgs, split=False)
    geom = Geometry.of(imgs[0])
    L = plan.xs.shape[0]
    cpu = torch.device("cpu")
    for lanes, B in (
            (tfused.restart_lanes(plan.layout, L, 5, geom.mcus_y,
                                  geom.mcus_x, cpu), 5),
            (tfused.bucket_lanes(8, 5, 3, 2, geom.mcus_y, geom.mcus_x, cpu),
             5),
            (tpixels.block_lanes(4, geom.mcus_y, geom.mcus_x, cpu), 4)):
        seen = np.zeros((B, geom.n_mcus), np.int32)
        for b, m0, n, _ in lanes.table.numpy():
            if b >= 0:
                seen[b, m0 : m0 + n] += 1
        assert (seen == 1).all()
        assert lanes.max_n == max(n for b, _, n, _ in lanes.table.numpy()
                                  if b >= 0)


def _engines_agree(datas, **kw):
    dec = BatchDecoder(device="cpu", **kw)
    got = dec.decode(datas)
    jdec = JaxBatchDecoder(mesh=_mesh1(), **kw)
    jgot = jdec.decode(datas)
    assert dec.stats.backend == jdec.stats.backend, dec.stats.as_dict()
    assert dec.stats.repaired_pixels == 0
    for g, j, d in zip(got, jgot, datas):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(
            g, joracle.decode(parse(d), fancy=kw.get("fancy", False)))
    return dec.stats


@pytest.mark.parametrize("backend", ["fsm", "host"])
def test_engine_strict_restart_matches_jax_and_oracle(backend):
    datas = [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s)
             for s in (1, 2, 3)]
    st = _engines_agree(datas, backend=backend, chunk_size=4)
    assert st.backend == backend


def test_engine_strict_bucketed_matches_jax_and_oracle():
    datas = [_rst_rows(s, seed=i) for i, s in enumerate(MIXED[:3])]
    st = _engines_agree(datas, backend="fsm", chunk_size=4,
                        size_buckets=True)
    assert st.backend == "fsm-bucketed"


@pytest.mark.parametrize("backend", ["fsm", "host"])
def test_engine_strict_goldens(backend):
    # one lane per golden on "fsm" (the plain scan is slow: the smallest
    # golden), the reference's outputs on both routes
    names = GOLDEN[2:3] if backend == "fsm" else GOLDEN[:3]
    datas = [open(fixture_path(n), "rb").read() for n in names]
    dec = BatchDecoder(backend=backend, device="cpu")
    got = dec.decode(datas)
    assert dec.stats.backend == backend and dec.stats.repaired_pixels == 0
    for n, g in zip(names, got):
        np.testing.assert_array_equal(
            g, read_array(fixture_path(n, ".array")))


def test_decode_strict_false_is_the_f32_colour():
    # the f32 colour differs from the exact one only where it flags
    img = parse(make_jpeg(shape=(40, 48), seed=7))
    geom, coeffs, quant = jpipe.build_plan(img)
    tgeom = Geometry(geom)
    args = (tgeom, torch.as_tensor(coeffs)[None], torch.as_tensor(quant)[None])
    from tpujpeg_torch import pipeline as tpipe

    rgb, risk = tpipe.device_decode_fn(*args)
    rgb_x, none = tpipe.device_decode_fn(*args, exact=True)
    assert none is None
    risky = jcolor.unpack_mask(risk[0].numpy(), 48)
    assert risky.any()
    np.testing.assert_array_equal(rgb[0].numpy()[:, ~risky],
                                  rgb_x[0].numpy()[:, ~risky])
    np.testing.assert_array_equal(np.moveaxis(rgb_x[0].numpy(), 0, -1),
                                  joracle.decode(img))
    got = tpipe.decode(_port_img(img), "cpu", strict=False)
    np.testing.assert_array_equal(got, np.moveaxis(rgb[0].numpy(), 0, -1))
