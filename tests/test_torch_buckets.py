"""tpujpeg_torch mixed-size (size-bucketed) decode == the JAX package's.

Small images (24-120 px, at most 256 lanes), inputs from a numpy seed
through cv2/PIL encoders, every comparison `==` (integers, tolerance 0):

  * bucket ladder, bucket geometry, the host pad/unpad, the shape ladder;
  * build_plan_bucketed field-equal to the JAX plan;
  * fsm_scan(pad_info=) against fsm._fsm_scan (events and both latches)
    on aligned, ragged-edge and truncated streams;
  * decode_chunk_bucketed against fused.decode_chunk_bucketed on every
    output;
  * the engine with size_buckets=True against the JAX engine and the
    oracle on the cases of tests/test_buckets.py (mixed sizes, unaligned
    restarts fall back to the host-bucketed route, mixed k splits
    chunks), BatchStats counters equal;
  * past the JAX engine's int16 gate: a bucket the JAX engine hands to
    the host decodes on the device, the port's scatter having no gate.

The JAX scan runs under jit with its carry surfaced (XLA:CPU hangs on a
scan whose carry outputs are dead).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujpeg import pipeline as jpipe
from tpujpeg.io.parser import parse
from tpujpeg.ops import fsm as jfsm
from tpujpeg.ops.color import unpack_mask
from tpujpeg.oracle import decoder as oracle
from tpujpeg.runtime import fused as jfused
from tpujpeg.runtime import ladder as jladder
from tpujpeg.runtime.batch import BatchDecoder as JaxBatchDecoder
from tpujpeg_torch import JpegError, convert
from tpujpeg_torch import pipeline as tpipe
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.runtime import fused as tfused
from tpujpeg_torch.runtime import ladder as tladder
from tpujpeg_torch.runtime.batch import BatchDecoder

from conftest import make_jpeg, make_jpeg_rst

MIXED = [(64, 80), (60, 88), (57, 41), (120, 56), (48, 64), (64, 80)]


def _rst_rows(shape, seed, k=1, quality=90):
    """4:4:4 restart JPEG with ri == k * mcus_x (row-aligned)."""
    return make_jpeg_rst(shape=shape, quality=quality,
                         rst_interval=k * -(-shape[1] // 8), seed=seed)


def _smooth_rst(shape, seed, k, quality=50):
    """Smooth content (short segments, so the plain scan stays quick) with
    a restart marker every k MCU rows."""
    import cv2

    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 128 + 90 * np.sin(xx / 17 + seed) + 60 * np.cos(yy / 23 - seed)
    arr = np.stack([base, np.roll(base, 7, 0), np.roll(base, 13, 1)], -1)
    ok, enc = cv2.imencode(
        ".jpg", np.clip(arr, 0, 255).astype(np.uint8),
        [cv2.IMWRITE_JPEG_QUALITY, quality,
         cv2.IMWRITE_JPEG_RST_INTERVAL, k * -(-w // 8),
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    assert ok
    return enc.tobytes()


def _oracle(datas):
    return [oracle.decode(parse(d)).astype(np.uint8) for d in datas]


def _mesh1():
    from tpujpeg.parallel import sharding

    return sharding.make_mesh(n_batch=1, n_stripe=1)


def _np(t):
    return t.cpu().numpy()


def _common_bucket(imgs):
    """The smallest size-class bucket that holds every image."""
    comps = tpipe.Geometry.of(imgs[0]).comps
    bx = tpipe.bucket_up(max(im.mcus_x for im in imgs))
    by = tpipe.bucket_up(max(im.mcus_y for im in imgs))
    return tpipe.Geometry((bx * 8, by * 8, bx, by, comps))


# ---------------------------------------------------------------------------
# ladder, geometry, host padding
# ---------------------------------------------------------------------------


def test_bucket_ladder_and_geometry_equal():
    for n in range(1, 400):
        assert tpipe.bucket_up(n) == jpipe.bucket_up(n)
    for shape in MIXED + [(24, 24), (640, 800), (401, 363)]:
        img = parse(make_jpeg(shape=shape, seed=1))
        jb = jpipe.bucket_geometry(jpipe.Geometry.of(img))
        tb = tpipe.bucket_geometry(tpipe.Geometry.of(img))
        assert tuple(tb) == tuple(jb)
        assert tb.n_blocks == jb.n_blocks and tb.width == tb.mcus_x * 8


def test_pad_and_unpad_coeffs_equal():
    rng = np.random.default_rng(3)
    img = parse(make_jpeg(shape=(57, 41), seed=2))
    geom = tpipe.Geometry.of(img)
    bucket = tpipe.bucket_geometry(geom)
    jgeom = jpipe.Geometry.of(img)
    coeffs = rng.integers(-900, 900, (geom.n_blocks, 64)).astype(np.int32)
    out = np.zeros((bucket.n_blocks, 64), np.int32)
    jout = np.zeros_like(out)
    tpipe.pad_coeffs_to_bucket(geom, bucket, coeffs, out)
    jpipe.pad_coeffs_to_bucket(jgeom, jpipe.bucket_geometry(jgeom), coeffs,
                               jout)
    np.testing.assert_array_equal(out, jout)
    assert out.any() and (out != 0).sum() == (coeffs != 0).sum()
    view = out.reshape(bucket.mcus_y, bucket.mcus_x, geom.blocks_per_mcu, 64)
    np.testing.assert_array_equal(
        view[: geom.mcus_y, : geom.mcus_x].reshape(geom.n_blocks, 64), coeffs)


def test_shape_ladder_equal():
    for bound in (50, 1024, 1025, 4096, 5000):
        assert tladder.stride_ladder(bound) == jladder.stride_ladder(bound)
    for m in (3, 101, 250):
        assert tladder.mcu_bucket_ladder(m) == jladder.mcu_bucket_ladder(m)
    keys = tladder.bucketed_keys(2000, 4096, k_values=(1, 2))
    assert keys == jladder.bucketed_jit_keys(2000, 4096, k_values=(1, 2))
    # the port's scatter has no int16 gate: its ladder keeps the buckets
    # the JAX engine's gate hands to the host
    wide = tladder.bucketed_keys(2000, 4096, k_values=(1, 2),
                                 max_blk_cap=None)
    assert set(keys) < set(wide)
    assert (224, 4, 1, 64) in wide and (224, 4, 1, 64) not in keys
    # real plans stay inside the enumeration; a padded partial chunk has
    # the full chunk's shapes
    img = parse(_rst_rows((64, 80), seed=0))
    bucket = tpipe.bucket_geometry(tpipe.Geometry.of(img))
    p_full = tfsm.build_plan_bucketed([img] * 6, bucket, pad_imgs=6)
    p_part = tfsm.build_plan_bucketed([img], bucket, pad_imgs=6)
    assert p_full.xs.shape == p_part.xs.shape
    key = tladder.observed_key(p_part, bucket)
    assert key in set(keys)
    jplan = jfsm.build_plan_bucketed([img], bucket, pad_imgs=6)
    assert key == jladder.observed_key(jplan, bucket)


# ---------------------------------------------------------------------------
# the bucket plan
# ---------------------------------------------------------------------------


def _fields_equal(t, j):
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "tables":
            assert a == convert.tables_from_jax(b)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


PLAN_CASES = {
    "mixed_k1": ([(64, 80), (60, 88), (57, 41), (48, 64)], 1, None),
    "mixed_k2": ([(64, 80), (60, 88), (50, 70)], 2, None),
    "padded": ([(64, 80), (57, 41)], 1, 6),
    "tall": ([(120, 56), (110, 50)], 1, None),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_build_plan_bucketed_field_equal(case):
    shapes, k, pad_imgs = PLAN_CASES[case]
    imgs = [parse(_rst_rows(s, seed=i, k=k)) for i, s in enumerate(shapes)]
    bucket = _common_bucket(imgs)
    jplan = jfsm.build_plan_bucketed(imgs, bucket, pad_imgs=pad_imgs)
    plan = tfsm.build_plan_bucketed(imgs, bucket, pad_imgs=pad_imgs)
    _fields_equal(plan, jplan)
    _fields_equal(convert.bucket_plan_from_jax(jplan), jplan)
    assert plan.k == k and plan.xs.shape[0] % 128 == 0
    n_real = len(imgs) * plan.lanes_per_img
    assert (plan.seg_n[n_real:] == 0).all()
    assert (plan.wrap_at[n_real:] == 1).all()
    assert int(plan.seg_n.sum()) == sum(
        im.n_mcus * im.blocks_per_mcu for im in imgs)


def test_build_plan_bucketed_refusals_equal():
    aligned = parse(_rst_rows((64, 80), seed=1))
    bucket = tpipe.bucket_geometry(tpipe.Geometry.of(aligned))
    cases = {
        "unaligned": [parse(make_jpeg_rst(shape=(64, 80), rst_interval=3,
                                          seed=1))],
        "no restarts": [parse(make_jpeg(shape=(64, 80), seed=1))],
        "mixed k": [aligned, parse(_rst_rows((64, 80), seed=2, k=2))],
        "too large": [aligned, parse(_rst_rows((120, 160), seed=3))],
    }
    for name, imgs in cases.items():
        with pytest.raises(JpegError) as te:
            tfsm.build_plan_bucketed(imgs, bucket)
        with pytest.raises(jfsm.JpegError) as je:
            jfsm.build_plan_bucketed(imgs, bucket)
        assert str(te.value) == str(je.value), name
    assert tfsm.bucket_lane_k(aligned) == jfsm.bucket_lane_k(aligned) == 1
    for img in cases["unaligned"] + cases["no restarts"]:
        assert tfsm.bucket_lane_k(img) is None
        assert jfsm.bucket_lane_k(img) is None


# ---------------------------------------------------------------------------
# the scan's bucket-raster emission
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("tables", "steps"))
def _jax_scan_pad(xs, seg_n, wrap_at, skip, tables, steps):
    events, (err_mal, err_env), state = jfsm._fsm_scan(
        xs.T, seg_n, tables, steps=steps, pad_info=(wrap_at, skip))
    return events, err_mal, err_env, state


def _truncated():
    # the tail of the stream cut off: the last lanes run on zero padding
    img = parse(_rst_rows((40, 56), seed=6))
    img.scan_data = img.scan_data[: img.scan_data.size * 2 // 3].copy()
    return img


def _malformed():
    # an 0xFF tail: invalid codes latch lanes in the middle of a row
    img = parse(_rst_rows((48, 50), seed=7, quality=95))
    img.scan_data = img.scan_data.copy()
    img.scan_data[-img.scan_data.size // 3:] = 0xFF
    return img


SCAN_CORPORA = {
    # every image narrower than its bucket: skips after every row
    "aligned": lambda: [parse(_rst_rows(s, seed=i))
                        for i, s in enumerate([(64, 80), (60, 88)])],
    # widths and heights that are no multiples of 8, one image filling the
    # bucket's width (skip 0), two rows per lane
    "ragged_k2": lambda: [parse(_rst_rows(s, seed=10 + i, k=2))
                          for i, s in enumerate([(57, 41), (33, 47),
                                                 (50, 59)])],
    "noisy_q95": lambda: [parse(_rst_rows((48, 64), seed=11, quality=95))],
    "truncated": lambda: [parse(_rst_rows((40, 56), seed=5)), _truncated(),
                          _malformed()],
}


@pytest.mark.parametrize("steps", [(1, 2), 3])
@pytest.mark.parametrize("name", list(SCAN_CORPORA))
def test_plain_pad_scan_matches_jax(name, steps):
    imgs = SCAN_CORPORA[name]()
    bucket = _common_bucket(imgs)
    plan = tfsm.build_plan_bucketed(imgs, bucket)
    want_ev, want_mal, want_env, _ = _jax_scan_pad(
        jnp.asarray(plan.xs), jnp.asarray(plan.seg_n),
        jnp.asarray(plan.wrap_at), jnp.asarray(plan.skip),
        jfsm.build_tables(imgs[0]), steps)
    ev, mal, env = tfsm.fsm_scan(
        torch.as_tensor(plan.xs), torch.as_tensor(plan.seg_n), plan.tables,
        steps, pad_info=(torch.as_tensor(plan.wrap_at),
                         torch.as_tensor(plan.skip)))
    np.testing.assert_array_equal(_np(ev), np.asarray(want_ev))
    np.testing.assert_array_equal(_np(mal), np.asarray(want_mal))
    np.testing.assert_array_equal(_np(env), np.asarray(want_env))
    if name == "truncated":
        assert bool(mal.any()) and not bool(mal.all())
    else:
        assert not bool(mal.any())
    if name != "truncated" and not bool(env.any()):
        # the block fields are bucket-raster positions: the blocks that
        # hold an event are real slots of their lane's padded rows
        blk = (_np(ev).reshape(-1, ev.shape[-1]) >> 18) & 0x1FFF
        valid = _np(ev).reshape(-1, ev.shape[-1]) >= 0
        row_w = bucket.mcus_x * 3
        for lane in range(len(imgs) * plan.lanes_per_img):
            b = blk[valid[:, lane], lane]
            if b.size:
                assert (b % row_w < plan.wrap_at[lane]).all()
                assert (np.diff(b) >= 0).all()


def test_pad_scan_without_padding_equals_the_restart_scan():
    # an image that fills its bucket's width has skip 0: the pad scan is
    # the restart scan
    imgs = [parse(_rst_rows((48, 88), seed=2))]
    bucket = tpipe.bucket_geometry(tpipe.Geometry.of(imgs[0]))
    assert bucket.mcus_x == imgs[0].mcus_x
    plan = tfsm.build_plan_bucketed(imgs, bucket)
    assert not plan.skip.any()
    xs, sn = torch.as_tensor(plan.xs), torch.as_tensor(plan.seg_n)
    a = tfsm.fsm_scan(xs, sn, plan.tables)
    b = tfsm.fsm_scan(xs, sn, plan.tables, pad_info=(
        torch.as_tensor(plan.wrap_at), torch.as_tensor(plan.skip)))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the fused bucketed chunk
# ---------------------------------------------------------------------------


def _quant(imgs, pad_to):
    quant = np.zeros((pad_to, 3, 64), np.int32)
    for i, im in enumerate(imgs):
        quant[i] = np.stack(
            [im.quant_tables[c.quant_id] for c in im.components])
    return quant


@pytest.mark.parametrize("case", ["k1", "k2_padded"])
def test_decode_chunk_bucketed_matches_jax(case):
    if case == "k1":
        shapes, k, pad_to = [(64, 80), (57, 41), (48, 64)], 1, 3
    else:
        # more images asked for than lanes exist: lanes are padded first
        shapes, k, pad_to = [(60, 88), (40, 70)], 2, 40
    imgs = [parse(_rst_rows(s, seed=20 + i, k=k))
            for i, s in enumerate(shapes)]
    bucket = _common_bucket(imgs)
    jbucket = jpipe.Geometry(tuple(bucket))
    quant = _quant(imgs, pad_to)
    jplan = jfsm.build_plan_bucketed(imgs, jbucket)
    j_rgb, j_risk, j_coeffs, j_dc, j_mal, j_env, j_slot, _ = (
        jfused.decode_chunk_bucketed(jplan, jnp.asarray(quant), jbucket,
                                     pad_to, slots=False))
    plan = tfsm.build_plan_bucketed(imgs, bucket)
    if case == "k2_padded":
        assert pad_to * plan.lanes_per_img > plan.xs.shape[0]
    rgb, risk, coeffs, dc, mal, env, slot = tfused.decode_chunk_bucketed(
        plan, torch.as_tensor(quant), bucket, pad_to)
    assert coeffs.dtype == torch.int16 and dc.dtype == torch.int32
    assert tuple(rgb.shape) == (pad_to, 3, bucket.height, bucket.width)
    np.testing.assert_array_equal(_np(coeffs), np.asarray(j_coeffs))
    np.testing.assert_array_equal(_np(dc), np.asarray(j_dc))
    for g, w in ((mal, j_mal), (env, j_env), (slot, j_slot)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert not bool(mal.any() | env.any())
    np.testing.assert_array_equal(_np(risk), np.asarray(j_risk))
    for b in range(pad_to):
        safe = ~unpack_mask(np.asarray(j_risk)[b], bucket.width)
        np.testing.assert_array_equal(
            _np(rgb)[b][:, safe], np.asarray(j_rgb)[b][:, safe])
    # DC is masked outside each image's true extent, and equals the host
    # decoder's inside it
    dcb = _np(dc).reshape(pad_to, bucket.mcus_y, bucket.mcus_x, 3)
    for i, im in enumerate(imgs):
        assert not dcb[i, im.mcus_y:].any() and not dcb[i, :, im.mcus_x:].any()
        want = oracle.entropy_decode(im)[:, 0].reshape(
            im.mcus_y, im.mcus_x, 3)
        np.testing.assert_array_equal(dcb[i, : im.mcus_y, : im.mcus_x], want)
    assert not dcb[len(imgs):].any()
    # want_coeffs=False drops them and keeps the pixels
    r2 = tfused.decode_chunk_bucketed(plan, torch.as_tensor(quant), bucket,
                                      pad_to, want_coeffs=False)
    assert torch.equal(r2[0], rgb) and torch.equal(r2[1], risk)
    assert r2[2] is None and r2[3] is None


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

COUNTERS = ("n_images", "compressed_bytes", "pixels", "backend", "chunks",
            "failures", "fsm_envelope_fallbacks", "fsm_k_retries",
            "fsm_malformed_fallbacks", "spec_sync_misses",
            "fsm_slot_retries")


def _stats_equal(t, j):
    for name in COUNTERS:
        assert getattr(t, name) == getattr(j, name), name
    # the port's strict decodes compute colour exactly on the device, so
    # it repairs nothing; the JAX engine repairs its risk-flagged pixels
    # on the host (a TPU has no f64) and counts them
    assert t.repaired_pixels == 0, "repaired_pixels"


@pytest.fixture(scope="module")
def mixed():
    datas = [_rst_rows(s, seed=i) for i, s in enumerate(MIXED)]
    jdec = JaxBatchDecoder(backend="fsm", size_buckets=True, chunk_size=4,
                           mesh=_mesh1())
    jout = jdec.decode(datas)
    return datas, jout, jdec.stats, _oracle(datas)


def test_engine_mixed_sizes_match_jax_and_oracle(mixed):
    datas, jout, jstats, want = mixed
    dec = BatchDecoder(backend="fsm", size_buckets=True, chunk_size=4,
                       device="cpu")
    out = dec.decode(datas)
    dec.close()
    assert dec.stats.backend == "fsm-bucketed", dec.stats.as_dict()
    _stats_equal(dec.stats, jstats)
    for g, j, w in zip(out, jout, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)


def test_engine_non_aligned_restarts_fall_back():
    # restart interval not a multiple of mcus_x: outside the bucket-FSM
    # envelope -> the host-bucketed route, still exact, nothing raised
    datas = [make_jpeg_rst(shape=(64, 80), rst_interval=3, seed=1),
             make_jpeg_rst(shape=(60, 88), rst_interval=3, seed=2),
             make_jpeg(shape=(57, 70), seed=3)]
    dec = BatchDecoder(backend="fsm", size_buckets=True, chunk_size=4,
                       device="cpu")
    out = dec.decode(datas)
    dec.close()
    jdec = JaxBatchDecoder(backend="fsm", size_buckets=True, chunk_size=4,
                           mesh=_mesh1())
    jout = jdec.decode(datas)
    assert dec.stats.backend == "host-bucketed"
    _stats_equal(dec.stats, jdec.stats)
    for g, j, w in zip(out, jout, _oracle(datas)):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)


def test_engine_mixed_k_splits_chunks():
    # k=1 and k=2 images of one bucket class land in separate chunks, a
    # stream without aligned restarts in a third, and all decode exactly
    datas = [_rst_rows((64, 80), seed=1), _rst_rows((60, 88), seed=2, k=2),
             make_jpeg_rst(shape=(64, 84), rst_interval=3, seed=3)]
    dec = BatchDecoder(backend="fsm", size_buckets=True, chunk_size=4,
                       device="cpu")
    out = dec.decode(datas)
    dec.close()
    jdec = JaxBatchDecoder(backend="fsm", size_buckets=True, chunk_size=4,
                           mesh=_mesh1())
    jout = jdec.decode(datas)
    assert dec.stats.chunks == 3
    assert dec.stats.backend == "fsm-bucketed+host-bucketed"
    _stats_equal(dec.stats, jdec.stats)
    for g, j, w in zip(out, jout, _oracle(datas)):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)


def test_engine_host_backend_buckets():
    datas = [make_jpeg(shape=s, quality=88, seed=i)
             for i, s in enumerate(MIXED[:4])]
    dec = BatchDecoder(backend="host", size_buckets=True, chunk_size=4,
                       device="cpu")
    out = dec.decode(datas)
    dec.close()
    jdec = JaxBatchDecoder(backend="host", size_buckets=True, chunk_size=4)
    jout = jdec.decode(datas)
    assert dec.stats.backend == "host-bucketed"
    _stats_equal(dec.stats, jdec.stats)
    for g, j, w in zip(out, jout, _oracle(datas)):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)


def test_engine_bucketed_k_retry(monkeypatch):
    # below the symbol-step envelope a bucketed chunk is decoded again on
    # the device at STEPS_SAFE through its own route, counted, exact
    datas = [_rst_rows(s, seed=i) for i, s in enumerate(MIXED[:2])]
    monkeypatch.setattr(tfsm, "STEPS_PRODUCTION", 1)
    dec = BatchDecoder(backend="fsm", size_buckets=True, chunk_size=2,
                       device="cpu")
    out = dec.decode(datas)
    dec.close()
    assert dec.stats.fsm_k_retries == 1, dec.stats.as_dict()
    assert dec.stats.fsm_envelope_fallbacks == 0
    assert dec.stats.backend == "fsm-bucketed"
    for g, w in zip(out, _oracle(datas)):
        np.testing.assert_array_equal(g, w)


def test_engine_bucketed_malformed_goes_to_host_bucketed():
    good = _rst_rows((64, 80), seed=1)
    bad = parse(_rst_rows((60, 88), seed=2, quality=95))
    bad.scan_data = bad.scan_data.copy()
    bad.scan_data[-bad.scan_data.size // 3:] = 0xFF
    dec = BatchDecoder(backend="fsm", size_buckets=True, chunk_size=4,
                       device="cpu")
    with pytest.raises(JpegError):
        dec.decode_parsed([parse(good), bad])
    out = dec.decode_parsed([parse(good), bad], on_error="skip")
    dec.close()
    assert dec.stats.backend == "host-bucketed"
    assert dec.stats.fsm_malformed_fallbacks == 1
    assert out[1] is None and set(dec.stats.failures) == {1}
    np.testing.assert_array_equal(out[0], _oracle([good])[0])


def test_engine_int16_gate_holds_on_the_int16_routes_only():
    # 37 MCUs wide -> bucket 45; four rows per lane: 45 * 4 * 3 = 540
    # blocks, 34,560 dense rows, past the int16 offsets.  The JAX engine
    # refuses such chunks on the device (a TPU gate); the port's scatter
    # has no such gate and decodes them there
    datas = [_smooth_rst((64, 296), seed=1, k=4),
             _smooth_rst((60, 290), seed=2, k=4)]
    dec = BatchDecoder(backend="fsm", size_buckets=True, chunk_size=2,
                       device="cpu")
    out = dec.decode(datas)
    dec.close()
    assert dec.stats.backend == "fsm-bucketed"
    assert dec.stats.fsm_malformed_fallbacks == 0
    assert dec.stats.fsm_envelope_fallbacks == 0
    for g, w in zip(out, _oracle(datas)):
        np.testing.assert_array_equal(g, w)
    jdec = JaxBatchDecoder(backend="fsm", size_buckets=True, chunk_size=2,
                           mesh=_mesh1())
    jdec.decode(datas)
    assert jdec.stats.backend == "host-bucketed"
