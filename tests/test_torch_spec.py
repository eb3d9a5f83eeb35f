"""tpujpeg_torch speculative decode == the JAX package's, and the engine's
routing of streams without restart markers.

Same numpy-made inputs on both sides; every comparison is exact (`==`):
  * the scan's speculative modes (cold with anchor logs, count with a
    start state, stitch) against JAX _fsm_scan under jit with its carry
    returned (XLA:CPU hangs on a scan whose carry is dead): events,
    anchors, anchor block counts, recovery markers, the error flags and
    the final state, on a smooth, a noise, a 4:2:0 and a truncated
    stream;
  * build_spec_plan_batch and convert.spec_plan_from_jax field-equal;
  * spec_sync_start's outputs and spec_sync_resolve_host's quotas,
    cap_w or exception type;
  * the spec tail (coeffs16, dc, err) on the classic materialize, and at
    slots=C against JAX's classic tail;
  * the Jacobi decode_speculative_batch(device_out=True);
  * the engine: routing and counters equal the JAX engine's, outputs
    equal the oracle, on restart, one-lane and speculative chunks, a
    forced resolve miss and the steps (1, 1) envelope retry.
Stitch windows are cut with chunk_bytes=256 where the engine is not in
the loop: the plain scan costs one Python step per byte column.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujpeg.errors import JpegError as JaxJpegError
from tpujpeg.io.arrayio import read_array
from tpujpeg.io.parser import parse
from tpujpeg.oracle import decoder as oracle
from tpujpeg.ops import fsm as jfsm
from tpujpeg.runtime import host
from tpujpeg.runtime.batch import BatchDecoder as JaxBatchDecoder
from tpujpeg_torch import JpegError, convert
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.runtime.batch import BatchDecoder

from conftest import fixture_path, make_jpeg, make_jpeg_rst

CB = 256   # chunk bytes of the unit tests (stride 640)


def _truncated():
    img = parse(make_jpeg(shape=(64, 96), seed=8))
    img.scan_data = img.scan_data[: img.scan_data.size * 2 // 3].copy()
    return img


CORPORA = {
    "smooth": lambda: [parse(make_jpeg(shape=(96, 128), seed=s))
                       for s in (3, 4)],
    "noise": lambda: [parse(make_jpeg(shape=(64, 96), seed=5, smooth=False,
                                      quality=92))],
    "sub420": lambda: [parse(make_jpeg(shape=(96, 128), seed=6,
                                       subsampling=2))],
    "truncated": lambda: [_truncated()],
}


@pytest.fixture(scope="module")
def corpora():
    return {name: make() for name, make in CORPORA.items()}


def _eq(got, want, what=""):
    np.testing.assert_array_equal(
        np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), err_msg=what,
    )


@functools.partial(jax.jit, static_argnames=("tables", "steps", "mode"))
def _jax_scan(xs, seg_n, sb, sm, cb, tables, steps, mode):
    ys, (em, ee), st = jfsm._fsm_scan(
        xs.T, seg_n, tables,
        start_bits=sb if mode in ("count", "entry") else None,
        start_bim=sm if mode in ("count", "entry") else None,
        chunk_bits=cb if mode in ("cold", "count") else None,
        steps=steps, log_anchors=mode == "cold",
    )
    return ys, em, ee, st


@pytest.mark.parametrize("chunk_bytes", [CB, 2048])
def test_spec_plan_field_equal(corpora, chunk_bytes):
    imgs = corpora["smooth"] + corpora["smooth"][:1]
    jp = jfsm.build_spec_plan_batch(imgs, chunk_bytes)
    tp = tfsm.build_spec_plan_batch(imgs, chunk_bytes)
    cp = convert.spec_plan_from_jax(jp)
    for f in dataclasses.fields(tfsm.SpecBatchPlan):
        for got in (getattr(tp, f.name), getattr(cp, f.name)):
            want = getattr(jp, f.name)
            if f.name == "tables":
                assert got == convert.tables_from_jax(want)
            elif isinstance(want, np.ndarray):
                assert got.dtype == want.dtype, f.name
                _eq(got, want, f.name)
            else:
                assert got == want, f.name


@pytest.mark.parametrize("mode", ["cold", "count", "entry"])
@pytest.mark.parametrize("name", list(CORPORA))
def test_scan_modes_match_jax(corpora, name, mode):
    imgs = corpora[name]
    plan = tfsm.build_spec_plan_batch(imgs, CB)
    L = plan.xs.shape[0]
    rng = np.random.default_rng(len(name))
    caps = np.full(L, plan.blk_cap, np.int32)
    sb = rng.integers(0, (CB + 64) * 8, L).astype(np.int32)
    sm = rng.integers(0, plan.bpm, L).astype(np.int32)
    kw = {"cold": dict(chunk_bits=plan.chunk_bits, log_anchors=True),
          "count": dict(start_bits=sb, start_bim=sm,
                        chunk_bits=plan.chunk_bits),
          "entry": dict(start_bits=sb, start_bim=sm)}[mode]
    kw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    got = tfsm.fsm_scan_spec(torch.as_tensor(plan.xs), torch.as_tensor(caps),
                             plan.tables, (1, 2), **kw)
    ys, em, ee, st = _jax_scan(
        jnp.asarray(plan.xs), jnp.asarray(caps), jnp.asarray(sb),
        jnp.asarray(sm), jnp.asarray(plan.chunk_bits),
        jfsm.build_tables(imgs[0]), (1, 2), mode,
    )
    if mode == "cold":
        for g, w, n in zip((got.events, got.anchors, got.ablk, got.recm),
                           ys, ("events", "anchors", "ablk", "recm")):
            _eq(g, w, n)
        _eq(got.rec_last, st[11], "rec_last")
        assert bool((got.anchors >= 0).any())
    else:
        _eq(got.events, ys, "events")
        assert got.anchors is None and bool((got.rec_last == -1).all())
    for g, i, n in ((got.blk, 4, "blk"), (got.end_bits, 9, "end_bits"),
                    (got.end_bim, 10, "end_bim")):
        _eq(g, st[i], n)
    _eq(got.err_mal, em, "err_mal")
    _eq(got.err_env, ee, "err_env")
    if name == "truncated" and mode == "entry":
        assert bool(got.err_mal.any())
    # emit=False drops only the events
    quiet = tfsm.fsm_scan_spec(torch.as_tensor(plan.xs),
                               torch.as_tensor(caps), plan.tables, (1, 2),
                               emit=False, **kw)
    assert quiet.events is None
    _eq(quiet.end_bits, got.end_bits)


def _resolve(fsm_mod, pending):
    try:
        return fsm_mod.spec_sync_resolve_host(pending)
    except (JaxJpegError, JpegError) as e:
        return type(e).__name__


@pytest.mark.parametrize("name", ["smooth", "noise", "truncated"])
def test_sync_start_and_resolve_match_jax(corpora, name):
    imgs = corpora[name]
    jp = jfsm.spec_sync_start(imgs, CB)
    tp = tfsm.spec_sync_start(imgs, CB, device="cpu")
    L = tp.plan.xs.shape[0]
    for f in ("ev1", "anchors", "ablk", "recm", "ev2", "end2", "b1", "blk2"):
        _eq(getattr(tp, f), getattr(jp, f), f)
    # the JAX packed carries one more int, an XLA:CPU liveness probe
    _eq(tp.packed, np.asarray(jp.packed)[: 3 * L + 2], "packed")
    got, want = _resolve(tfsm, tp), _resolve(jfsm, jp)
    if isinstance(want, str):
        assert got == want
    else:
        _eq(got[0], want[0], "quotas")
        assert got[1] == want[1]
    if name == "smooth":
        assert not isinstance(got, str)   # the case resolves


def test_sync_refuses_more_than_8_blocks_per_mcu(corpora):
    imgs = corpora["smooth"]
    plan9 = dataclasses.replace(tfsm.build_spec_plan_batch(imgs, CB), bpm=9)
    with pytest.raises(tfsm.SpecSyncMiss):
        tfsm.spec_sync_start(imgs, plan=plan9, device="cpu")
    jplan9 = dataclasses.replace(jfsm.build_spec_plan_batch(imgs, CB), bpm=9)
    with pytest.raises(jfsm.SpecSyncMiss):
        jfsm.spec_sync_start(imgs, plan=jplan9)


@pytest.fixture(scope="module")
def smooth_pending(corpora):
    imgs = corpora["smooth"]
    jp = jfsm.spec_sync_start(imgs, CB)
    tp = tfsm.spec_sync_start(imgs, CB, device="cpu")
    quotas, cap_w = tfsm.spec_sync_resolve_host(tp)
    return imgs, jp, tp, quotas, cap_w


def _tail_args(p):
    return (p.ev1, p.anchors, p.ablk, p.recm, p.ev2, p.end2, p.b1, p.blk2)


def _host_coeffs(imgs):
    return np.stack([host.entropy_decode(im) for im in imgs])


@pytest.mark.parametrize("slots", [False, 128, 256])
def test_spec_tail_matches_jax(smooth_pending, slots):
    imgs, jp, tp, quotas, cap_w = smooth_pending
    nb = int(tp.plan.img_blocks[0])
    j16, jdc, jerr, _ = jfsm._spec_sync_assemble_jit(
        *(jnp.asarray(np.asarray(a)) for a in _tail_args(jp)),
        jnp.asarray(quotas), tables=jfsm.build_tables(imgs[0]), pad_to=3,
        nb=nb, n_imgs=2, cap_w=cap_w, slots=False,
    )
    c16, dc, err, err_slot = tfsm._spec_sync_assemble(
        *_tail_args(tp), torch.as_tensor(quotas), tp.plan.tables, 3, nb, 2,
        cap_w, slots=slots,
    )
    assert not bool(err_slot.any())
    _eq(c16, j16, "coeffs16")
    _eq(dc, jdc, "dc")
    _eq(err, jerr, "err")
    assert c16.dtype == torch.int16 and dc.dtype == torch.int32
    # and the truth: the host decoder's coefficients, DC resolved
    want = _host_coeffs(imgs)
    _eq(dc[:2], want[:, :, 0], "dc vs host")
    _eq(c16[:2, :, 1:], want[:, :, 1:], "ac vs host")


def test_decode_speculative_sync_matches_jax(corpora):
    imgs = corpora["smooth"]
    jc, (jerr, _) = jfsm.decode_speculative_sync(imgs, CB, pad_to=2)
    tc, (terr, tenv) = tfsm.decode_speculative_sync(imgs, CB, pad_to=2,
                                                    device="cpu")
    assert tc.dtype == torch.int32
    _eq(tc, jc, "coeffs")
    _eq(terr, jerr, "err")
    assert not bool(tenv.any())


def test_jacobi_matches_jax_and_host(corpora):
    imgs = corpora["smooth"]
    jc, (jm, je) = jfsm.decode_speculative_batch(imgs, CB, device_out=True,
                                                 pad_to=3)
    tc, (tm, te) = tfsm.decode_speculative_batch(imgs, CB, device_out=True,
                                                 pad_to=3, device="cpu")
    _eq(tc, jc, "coeffs")
    _eq(tm, jm, "err_mal")
    _eq(te, je, "err_env")
    _eq(tc[:2], _host_coeffs(imgs), "coeffs vs host")
    # and the host list of device_out=False, JAX's default
    tl = tfsm.decode_speculative_batch(imgs, CB, device="cpu")
    jl = jfsm.decode_speculative_batch(imgs, CB)
    assert len(tl) == len(jl) == 2
    for t, j, w in zip(tl, jl, _host_coeffs(imgs)):
        _eq(t, j, "host list")
        _eq(t, w, "host list vs host")


def test_rebased_zero_event_is_placed(smooth_pending):
    # a cold event at block b1, z 0, val -2048 rebases to block 0 and packs
    # to exactly 0: it is still an event (validity is ev >= 0), on the
    # classic and the slot route alike
    tables = smooth_pending[2].plan.tables
    L, n1, nb, b1 = 128, 24, 3, 5
    ev1 = np.full((n1, L), -1, np.int32)
    anchors = np.full((n1, L), -1, np.int32)
    ablk = np.zeros((n1, L), np.int32)
    ev1[0, 0] = b1 << 18                                # z 0, val -2048
    ev1[1, 0] = ((b1 + 1) << 18) | (3 << 12) | (2048 + 7)
    ev1[2, 0] = ((b1 + 2) << 18) | (2048 + 1)
    anchors[3, 0] = (900 << 3) | 0                      # end of the span
    ablk[3, 0] = b1 + nb
    recm = np.full((n1, L), -1, np.int32)
    ev2 = np.full((4, L), -1, np.int32)
    zeros = np.zeros(L, np.int32)
    b1v = zeros.copy()
    b1v[0] = b1
    quotas = zeros.copy()
    quotas[0] = nb
    want = np.zeros((nb, 64), np.int32)
    want[0, 0] = -2048
    want[1, 3] = 7
    want[2, 0] = 1
    for slots in (False, 64):
        c16, dc, err, err_slot = tfsm._spec_sync_assemble(
            *(torch.as_tensor(a) for a in (ev1, anchors, ablk, recm, ev2,
                                           zeros, b1v, zeros, quotas)),
            tables, 1, nb, 1, 16, slots=slots,
        )
        assert not bool(err.any()) and not bool(err_slot.any())
        _eq(c16[0, :, 1:], want[:, 1:], f"ac, slots={slots}")
        _eq(c16[0, :, 0], want[:, 0], f"dc diffs, slots={slots}")
        _eq(dc[0], [-2048, 0, 1], f"dc, slots={slots}")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _oracle(datas):
    return [oracle.decode(parse(d)).astype(np.uint8) for d in datas]


def _counters(stats):
    return {k: getattr(stats, k) for k in (
        "backend", "fsm_k_retries", "spec_sync_misses", "fsm_slot_retries",
        "fsm_envelope_fallbacks", "fsm_malformed_fallbacks",
    )}


@pytest.fixture(scope="module")
def big_smooth():
    # 54 x 54 MCUs x 3 = 8,748 blocks: past one lane, so the chunk is
    # speculative
    return make_jpeg(shape=(432, 432), seed=7)


def test_engine_routes_like_jax(big_smooth):
    small = make_jpeg(shape=(32, 48), seed=2)
    rst = make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=3)
    datas = [rst, small, big_smooth]
    dec = BatchDecoder(backend="fsm", chunk_size=4, device="cpu")
    got = dec.decode(datas)
    jdec = JaxBatchDecoder(backend="fsm", chunk_size=4)
    jgot = jdec.decode(datas)
    assert _counters(dec.stats) == _counters(jdec.stats)
    assert dec.stats.backend == "fsm+fsm-spec-sync"
    assert dec.stats.chunks == 3
    # strict colour is exact on the device: nothing to repair
    assert dec.stats.repaired_pixels == 0
    for g, j, o in zip(got, jgot, _oracle(datas)):
        _eq(g, o)
        _eq(g, j)


def test_engine_one_lane_golden_like_jax():
    with open(fixture_path("3_120x120"), "rb") as f:
        golden = f.read()
    datas = [golden, make_jpeg(shape=(40, 56), seed=9)]
    dec = BatchDecoder(backend="fsm", device="cpu")
    got = dec.decode(datas)
    jdec = JaxBatchDecoder(backend="fsm")
    jdec.decode(datas)
    assert dec.stats.backend == jdec.stats.backend == "fsm"
    assert _counters(dec.stats) == _counters(jdec.stats)
    _eq(got[0], read_array(fixture_path("3_120x120", ".array")))
    _eq(got[1], _oracle(datas[1:])[0])


def test_dense_golden_latches_envelope_like_jax():
    # 8_401x363 is denser than STEPS_SAFE symbols per byte near its end:
    # its one-lane scan latches err_env at both step counts in the JAX
    # package, so both engines send it through the K retry to the host
    # route.  The port's plain scan latches at the same block; the two are
    # compared on the lane's tail, entered at a block boundary that the
    # JAX anchor scan logs (the whole lane costs minutes of plain scan).
    with open(fixture_path("8_401x363"), "rb") as f:
        img = parse(f.read())
    plan = tfsm.build_plan([img], split=False)
    row, nb = plan.xs[:1], plan.seg_n_blocks[:1]
    jt = jfsm.build_tables(img)

    def one(v):
        return jnp.asarray(np.array([v], np.int32))

    for steps in (tfsm.STEPS_PRODUCTION, tfsm.STEPS_SAFE):
        _, em, ee, st = _jax_scan(jnp.asarray(row), jnp.asarray(nb), one(0),
                                  one(0), one(0), jt, steps, "restart")
        assert bool(ee[0]) and not bool(em[0]), steps
        latch_blk = int(st[4][0])
    assert latch_blk < int(nb[0])
    # a block boundary 200 columns before the anchor scan's first recovery
    ys, _, _, _ = _jax_scan(jnp.asarray(row), jnp.asarray(nb), one(0),
                            one(0), one(2 ** 30), jt, tfsm.STEPS_SAFE, "cold")
    _, anchors, ablk, recm = (np.asarray(y)[:, :, 0] for y in ys)
    rc = int(np.nonzero((recm >= 0).any(1))[0][0])
    cols, slots = np.nonzero(anchors[: rc - 200] >= 0)
    a = int(anchors[cols[-1], slots[-1]])
    done = int(ablk[cols[-1], slots[-1]])
    c0 = (a >> 3) // 8
    tail = np.ascontiguousarray(row[:, c0 : rc + 64])
    sb, sm = (a >> 3) - 8 * c0, a & 7
    ys, em, ee, st = _jax_scan(jnp.asarray(tail), jnp.asarray(nb - done),
                               one(sb), one(sm), one(0), jt,
                               tfsm.STEPS_SAFE, "entry")
    got = tfsm.fsm_scan_spec(
        torch.as_tensor(tail), torch.as_tensor(nb - done), plan.tables,
        tfsm.STEPS_SAFE, start_bits=torch.tensor([sb], dtype=torch.int32),
        start_bim=torch.tensor([sm], dtype=torch.int32))
    _eq(got.events, ys, "events")
    _eq(got.err_mal, em, "err_mal")
    _eq(got.err_env, ee, "err_env")
    _eq(got.blk, st[4], "blk")
    assert bool(got.err_env[0]) and done + int(got.blk[0]) == latch_blk


def test_engine_forced_miss_takes_jacobi(big_smooth, monkeypatch):
    def miss(pending):
        raise tfsm.SpecSyncMiss("forced")

    monkeypatch.setattr(tfsm, "spec_sync_resolve_host", miss)
    # the Jacobi plan's own stride is the only knob: keep the CPU scan short
    monkeypatch.setattr(
        tfsm, "decode_speculative_batch",
        functools.partial(tfsm.decode_speculative_batch, chunk_bytes=1024),
    )
    dec = BatchDecoder(backend="fsm", device="cpu")
    got = dec.decode([big_smooth])
    assert dec.stats.backend == "fsm-spec", dec.stats.as_dict()
    assert dec.stats.spec_sync_misses == 1
    assert dec.stats.fsm_envelope_fallbacks == 0
    assert dec.stats.fsm_malformed_fallbacks == 0
    _eq(got[0], _oracle([big_smooth])[0])


def test_engine_steps_1_1_envelope_retry(big_smooth, monkeypatch):
    monkeypatch.setattr(tfsm, "STEPS_PRODUCTION", (1, 1))
    dec = BatchDecoder(backend="fsm", device="cpu")
    got = dec.decode([big_smooth])
    with pytest.raises(tfsm.SpecEnvelopeError):
        tfsm.spec_sync_resolve_host(tfsm.spec_sync_start(
            [parse(big_smooth)], steps=(1, 1), device="cpu"))
    assert dec.stats.backend == "fsm-spec-sync", dec.stats.as_dict()
    assert dec.stats.fsm_k_retries == 1
    assert dec.stats.spec_sync_misses == 0
    assert dec.stats.fsm_envelope_fallbacks == 0
    _eq(got[0], _oracle([big_smooth])[0])


def test_engine_outside_every_envelope(monkeypatch):
    # a chunk neither route takes raises JpegError, or goes to the host
    # route under on_error="skip"
    def refuse(*args, **kwargs):
        raise JpegError("forced")

    monkeypatch.setattr(tfsm, "build_plan", refuse)
    monkeypatch.setattr(tfsm, "build_spec_plan_batch", refuse)
    data = make_jpeg(shape=(32, 48), seed=4)
    dec = BatchDecoder(backend="fsm", device="cpu")
    with pytest.raises(JpegError, match="envelope"):
        dec.decode([data])
    got = dec.decode([data], on_error="skip")
    assert dec.stats.backend == "host"
    _eq(got[0], _oracle([data])[0])
