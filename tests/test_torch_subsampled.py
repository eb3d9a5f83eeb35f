"""tpujpeg_torch subsampled and grayscale decode == the JAX package's ==
the oracle's.

4:2:0, 4:2:2, 4:4:0, 4:1:1 and grayscale streams, box and fancy chroma
upsampling, with and without restart markers, at exact geometry and in
size-class buckets.  Small images (48x64 to 96x112, chunks of 2-4), made
from a numpy seed through the cv2 and PIL encoders; the same parsed
stream goes to both packages.  Every comparison is `==` (integers,
tolerance 0); the one stated exception is the risk flag of a borderline
pixel, by the rule of tests/test_torch_buckets.py::_stats_equal: the flag
is float32 arithmetic that XLA:CPU and PyTorch contract differently, so
the two risk masks may differ in at most 2 pixels or 1%; pixels are
equal wherever neither side flags one, and every strict output (exact
colour in the port, repaired in the JAX package) is equal everywhere.

  * device_decode_fn against tpujpeg.pipeline._compiled(geom, fancy),
    with the resolved-DC override;
  * decode against both oracles;
  * decode_chunk_fused, decode_chunk_bucketed (extents, fancy) and
    decode_spec_sync_fused against the JAX fused programs, all outputs.

The engine's cases are in tests/test_torch_subsampled_engine.py.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpujpeg_torch
from tpujpeg import pipeline as jpipe
from tpujpeg.io.parser import parse
from tpujpeg.ops import fsm as jfsm
from tpujpeg.ops.color import unpack_mask
from tpujpeg.oracle import decoder as joracle
from tpujpeg.runtime import fused as jfused
from tpujpeg_torch import convert
from tpujpeg_torch import pipeline as tpipe
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.oracle import decoder as toracle
from tpujpeg_torch.runtime import fused as tfused

SAMPLINGS = ["420", "422", "440", "411", "gray"]
MCU_PX = {"420": (16, 16), "422": (16, 8), "440": (8, 16), "411": (32, 8),
          "gray": (8, 8)}   # (width, height) of one MCU
CB = 256   # chunk bytes of the speculative unit tests


def _content(shape, seed, smooth=True, calm=False):
    """Seeded RGB content: waves plus noise; `calm` is slow waves with
    little noise (short streams whose speculative lanes resynchronise
    inside the stitch window); smooth=False is white noise."""
    h, w = shape
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    px, py, sigma = (17, 23, 2) if calm else (7, 5, 10)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 128 + 90 * np.sin(xx / px + seed) + 60 * np.cos(yy / py - seed)
    arr = np.stack([base, np.roll(base, 7, 0), np.roll(base, 13, 1)], -1)
    return np.clip(arr + rng.normal(0, sigma, arr.shape), 0, 255) \
        .astype(np.uint8)


def _encode(shape, sampling, seed, rst_rows=0, rst_interval=None,
            quality=90, smooth=True):
    """A seeded stream with chroma `sampling`; rst_rows puts a restart
    marker every rst_rows MCU rows (row-aligned), rst_interval an
    arbitrary interval in MCUs, neither none."""
    import cv2

    arr = _content(shape, seed, smooth)
    if rst_interval is None:
        rst_interval = rst_rows * -(-shape[1] // MCU_PX[sampling][0])
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality,
             cv2.IMWRITE_JPEG_RST_INTERVAL, rst_interval]
    if sampling == "gray":
        src = arr[:, :, 0]
    else:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)]
        src = arr[:, :, ::-1]
    ok, enc = cv2.imencode(".jpg", src, flags)
    assert ok
    return enc.tobytes()


def _encode_pil(shape, seed, subsampling=2, quality=90, calm=False):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_content(shape, seed, calm=calm)).save(
        buf, "JPEG", quality=quality, subsampling=subsampling)
    return buf.getvalue()


def _np(t):
    return t.cpu().numpy()


def _quant(imgs, pad_to):
    quant = np.zeros((pad_to, len(imgs[0].components), 64), np.int32)
    for i, im in enumerate(imgs):
        quant[i] = np.stack(
            [im.quant_tables[c.quant_id] for c in im.components])
    return quant


def _oracle(datas, fancy=False):
    return [joracle.decode(parse(d), fancy=fancy).astype(np.uint8)
            for d in datas]


def _pixels_agree(rgb, risk, j_rgb, j_risk, width):
    """Device pixels [B, 3, H, W] and packed risk bits of both packages:
    the stated rule of the module docstring."""
    rgb, risk = _np(rgb), _np(risk)
    j_rgb, j_risk = np.asarray(j_rgb), np.asarray(j_risk)
    assert rgb.dtype == np.uint8 and rgb.shape == j_rgb.shape
    assert risk.dtype == np.uint8 and risk.shape == j_risk.shape
    for b in range(rgb.shape[0]):
        mine = unpack_mask(risk[b], width)
        theirs = unpack_mask(j_risk[b], width)
        assert int((mine != theirs).sum()) <= max(2, int(theirs.sum()) // 100)
        safe = ~(mine | theirs)
        np.testing.assert_array_equal(rgb[b][:, safe], j_rgb[b][:, safe])


# ---------------------------------------------------------------------------
# the pixel stage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fancy", [False, True], ids=["box", "fancy"])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_device_decode_fn_matches_jax(sampling, fancy):
    img = parse(_encode((56, 72), sampling, seed=3, rst_rows=1))
    assert img.sampling == ("gray" if sampling == "gray" else
                            ":".join(sampling))
    geom, coeffs, quant = jpipe.build_plan(img)
    tgeom = tpipe.Geometry.of(convert.image_from_jax(img))
    assert tuple(tgeom) == tuple(geom)
    rng = np.random.default_rng(1)
    for dc in (None, rng.integers(-1024, 1024, coeffs.shape[0])
               .astype(np.int32)):
        src = coeffs
        if dc is not None:
            # the override wins over whatever the dense DC row holds
            src = coeffs.copy()
            src[:, 0] = rng.integers(-2048, 2047, coeffs.shape[0])
        kw = {} if dc is None else {"dc": jnp.asarray(dc)}
        want_rgb, want_risk = jpipe._compiled(geom, fancy)(
            jnp.asarray(src), jnp.asarray(quant), **kw)
        rgb, risk = tpipe.device_decode_fn(
            tgeom, torch.as_tensor(src)[None], torch.as_tensor(quant)[None],
            fancy=fancy, dc=None if dc is None else torch.as_tensor(dc)[None])
        assert tuple(rgb.shape) == (1, 3, img.height, img.width)
        _pixels_agree(rgb, risk, np.asarray(want_rgb)[None],
                      np.asarray(want_risk)[None], img.width)


def test_plane_path_never_reaches_the_pixel_kernel(monkeypatch):
    # only three full-resolution components go through the pixel kernel
    def boom(*a, **k):
        raise AssertionError("pixel kernel reached")

    monkeypatch.setattr(tpipe, "rgb_444", boom)
    for sampling in ("420", "gray"):
        data = _encode((32, 48), sampling, seed=1)
        got = tpujpeg_torch.decode(data, device="cpu")
        np.testing.assert_array_equal(got, joracle.decode(parse(data)))
    with pytest.raises(AssertionError, match="pixel kernel reached"):
        tpujpeg_torch.decode(_encode_pil((32, 48), 1, subsampling=0),
                             device="cpu")


@pytest.mark.parametrize("fancy", [False, True], ids=["box", "fancy"])
@pytest.mark.parametrize("rst", [0, 1], ids=["norst", "rst"])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_decode_matches_both_oracles(sampling, rst, fancy):
    data = _encode((50, 70), sampling, seed=5, rst_rows=rst)
    got = tpujpeg_torch.decode(data, device="cpu", fancy=fancy)
    assert got.dtype == np.int32 and got.shape == (50, 70, 3)
    np.testing.assert_array_equal(
        got, joracle.decode(parse(data), fancy=fancy))
    np.testing.assert_array_equal(
        got, tpujpeg_torch.decode(data, backend="oracle", fancy=fancy))
    # the JAX package's own decode agrees
    np.testing.assert_array_equal(
        got, jpipe.decode(parse(data), fancy=fancy))


# ---------------------------------------------------------------------------
# tables and plans reach both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_tables_and_plans_field_equal(sampling):
    imgs = [parse(_encode((48, 64), sampling, seed=s, rst_rows=1))
            for s in (1, 2)]
    timgs = [convert.image_from_jax(im) for im in imgs]
    jt = jfsm.build_tables(imgs[0])
    tt = tfsm.build_tables(timgs[0])
    assert tt == convert.tables_from_jax(jt)
    bpm = imgs[0].blocks_per_mcu
    assert len(tt.tsel) == len(tt.comp) == bpm
    assert tt.n_comp == len(imgs[0].components)
    assert bpm == {"420": 6, "422": 4, "440": 4, "411": 6, "gray": 1}[sampling]
    if sampling == "gray":
        # one table set: the second set's LUT planes are never selected
        assert set(tt.tsel) == {0}
        assert tfsm.symbol_lut(tt).shape == (4, 65536)
    plan = tfsm.build_plan(timgs, split=False)
    jplan = jfsm.build_plan(imgs, split=False)
    cplan = convert.plan_from_jax(jplan)
    for a in (plan, cplan):
        np.testing.assert_array_equal(a.xs, jplan.groups[0][0])
        np.testing.assert_array_equal(a.seg_n_blocks, jplan.groups[0][1])
        assert a.max_blk == jplan.max_blk and a.layout == jplan.layout
        assert a.tables == tt
    assert int(plan.seg_n_blocks.max()) == imgs[0].mcus_x * bpm


# ---------------------------------------------------------------------------
# the fused chunks
# ---------------------------------------------------------------------------


def _chunk_equal(got, want, pad_to, width):
    rgb, risk, coeffs, dc = got[:4]
    j_rgb, j_risk, j_coeffs, j_dc = want[:4]
    assert coeffs.dtype == torch.int16 and dc.dtype == torch.int32
    np.testing.assert_array_equal(_np(coeffs), np.asarray(j_coeffs))
    np.testing.assert_array_equal(_np(dc), np.asarray(j_dc))
    for g, w in zip(got[4:], want[4:]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
        assert not bool(g.any())
    _pixels_agree(rgb, risk, j_rgb, j_risk, width)
    assert rgb.shape[0] == pad_to


@pytest.mark.parametrize("case", [("420", True), ("422", False),
                                  ("gray", False)],
                         ids=lambda c: f"{c[0]}-{'fancy' if c[1] else 'box'}")
def test_decode_chunk_fused_matches_jax(case):
    sampling, fancy = case
    imgs = [parse(_encode((48, 64), sampling, seed=s, rst_rows=1))
            for s in (5, 6)]
    quant = _quant(imgs, 2)
    jgeom = jpipe.Geometry.of(imgs[0])
    want = jfused.decode_chunk_fused(
        jfsm.build_plan(imgs, split=False), jnp.asarray(quant), jgeom, 2,
        fancy, slots=False)
    got = tfused.decode_chunk_fused(
        tfsm.build_plan(imgs, split=False), torch.as_tensor(quant),
        tpipe.Geometry.of(imgs[0]), 2, fancy=fancy)
    _chunk_equal(got, want[:7], 2, jgeom.width)
    for b, im in enumerate(imgs):
        # strict repair aside, the device pixels are the oracle's outside
        # the risk mask; the coefficients are the host decoder's
        np.testing.assert_array_equal(
            _np(got[3])[b], toracle.entropy_decode(im)[:, 0])


@pytest.mark.parametrize("case", [("420", True, 1), ("420", False, 2),
                                  ("440", True, 1)],
                         ids=lambda c: f"{c[0]}-{'fancy' if c[1] else 'box'}"
                                       f"-k{c[2]}")
def test_decode_chunk_bucketed_matches_jax(case):
    sampling, fancy, k = case
    # sizes that are no multiples of the MCU, narrower and shorter than
    # the bucket: the fancy filter's true edges lie inside the padding
    shapes = [(96, 112), (70, 100), (85, 90)]
    imgs = [parse(_encode(s, sampling, seed=20 + i, rst_rows=k))
            for i, s in enumerate(shapes)]
    comps = tpipe.Geometry.of(imgs[0]).comps
    bx = tpipe.bucket_up(max(im.mcus_x for im in imgs))
    by = tpipe.bucket_up(max(im.mcus_y for im in imgs))
    mw, mh = MCU_PX[sampling]
    bucket = tpipe.Geometry((bx * mw, by * mh, bx, by, comps))
    assert any(im.mcus_x < bx for im in imgs)
    jbucket = jpipe.Geometry(tuple(bucket))
    pad_to = 4
    quant = _quant(imgs, pad_to)
    want = jfused.decode_chunk_bucketed(
        jfsm.build_plan_bucketed(imgs, jbucket), jnp.asarray(quant), jbucket,
        pad_to, fancy, slots=False)
    plan = tfsm.build_plan_bucketed(imgs, bucket)
    assert plan.max_blk == k * bx * bucket.blocks_per_mcu
    got = tfused.decode_chunk_bucketed(
        plan, torch.as_tensor(quant), bucket, pad_to, fancy=fancy)
    _chunk_equal(got, want[:7], pad_to, bucket.width)
    assert tuple(got[0].shape) == (pad_to, 3, bucket.height, bucket.width)
    # cropped to its true size, each image is the exact-geometry decode
    for b, im in enumerate(imgs):
        exact, _ = tpipe.device_decode_fn(
            tpipe.Geometry.of(im),
            torch.as_tensor(toracle.entropy_decode(im))[None],
            torch.as_tensor(quant[b : b + 1]), fancy=fancy)
        assert torch.equal(got[0][b, :, : im.height, : im.width], exact[0])


@pytest.mark.parametrize("fancy", [False, True], ids=["box", "fancy"])
def test_decode_spec_sync_fused_matches_jax(fancy):
    # 6 blocks per MCU: the anchors' 3-bit phase field is full.  Calm
    # content: a 4:2:0 lane must find the bit position AND the MCU phase
    # again inside the stitch window, and on busy content some lanes of
    # most streams do not (both packages then raise SpecSyncMiss)
    imgs = [parse(_encode_pil((96, 112), seed=s, quality=50, calm=True))
            for s in (3, 4)]
    assert imgs[0].blocks_per_mcu == 6 and imgs[0].restart_interval == 0
    quant = _quant(imgs, 3)
    jgeom = jpipe.Geometry.of(imgs[0])
    jp = jfsm.spec_sync_start(imgs, CB)
    want = jfused.decode_spec_sync_fused(jp, jgeom, jnp.asarray(quant), 3, 2,
                                         fancy, slots=False)
    tp = tfsm.spec_sync_start(imgs, CB, device="cpu")
    assert tp.plan.n_lanes > 2 * len(imgs)
    got = tfused.decode_spec_sync_fused(
        tp, tpipe.Geometry.of(imgs[0]), torch.as_tensor(quant), 3, 2,
        fancy=fancy)
    _chunk_equal(got, want, 3, jgeom.width)
    # the slot route gives the same tensors
    slotted = tfused.decode_spec_sync_fused(
        tfsm.spec_sync_start(imgs, CB, device="cpu"),
        tpipe.Geometry.of(imgs[0]),
        torch.as_tensor(quant), 3, 2, fancy=fancy, slots=256)
    for g, s in zip(got, slotted):
        assert torch.equal(g, s)


def test_jacobi_matches_jax_at_6_blocks_per_mcu():
    imgs = [parse(_encode_pil((96, 112), seed=7))]
    jc, (jm, je) = jfsm.decode_speculative_batch(imgs, CB, device_out=True,
                                                 pad_to=2)
    tc, (tm, te) = tfsm.decode_speculative_batch(imgs, CB, device_out=True,
                                                 pad_to=2, device="cpu")
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    np.testing.assert_array_equal(_np(te), np.asarray(je))
    np.testing.assert_array_equal(_np(tc)[0], toracle.entropy_decode(imgs[0]))
