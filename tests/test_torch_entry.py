"""tpujpeg_torch's staged restart chain, host-returning speculative entry
points and package root == the JAX package's.

Same numpy-made inputs on both sides; every comparison is exact (`==`):
  * fsm.decode_plan, assemble and assemble_batched on a plan of one
    stride group and on one of two (build_plan's split: 288 restart
    segments of two length classes), against JAX's decode_plan,
    assemble, assemble_batched and the oracle;
  * entropy_decode_fsm, its STEPS_SAFE rung, its malformed raise and its
    envelope raise, messages included;
  * build_spec_plan field-equal, decode_speculative,
    decode_speculative_batch(device_out=False) on a batch of mixed
    geometry, decode_speculative_sync(device_out=False);
  * the root's exports and decode with every backend, against JAX's
    decode and the golden .array; its defaults stay on the card.
Everything of the port runs on the CPU (device="cpu"): each kernel
wrapper takes its plain PyTorch version.  Speculative cases use
chunk_bytes=256 and test_torch_spec.py's smooth images, whose JAX
programs that file compiles too.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import tpujpeg
import tpujpeg_torch
from tpujpeg.errors import JpegError as JaxJpegError
from tpujpeg.io.arrayio import read_array
from tpujpeg.io.parser import parse
from tpujpeg.oracle import decoder as oracle
from tpujpeg.ops import fsm as jfsm
from tpujpeg_torch import JpegError, convert
from tpujpeg_torch.ops import fsm as tfsm

from conftest import GOLDEN, fixture_path, make_jpeg, make_jpeg_rst

CB = 256


def _rst1(arr) -> bytes:
    import cv2

    ok, enc = cv2.imencode(
        ".jpg", arr,
        [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_RST_INTERVAL, 1,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    )
    assert ok
    return enc.tobytes()


def split_corpus() -> list[bytes]:
    """Three noise and three flat 48x64 images, a restart marker every
    MCU: 288 segments in two length classes, so build_plan splits."""
    rng = np.random.default_rng(3)
    noisy = [_rst1(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
             for _ in range(3)]
    flat = [_rst1(np.full((48, 64, 3), 128 + i, dtype=np.uint8))
            for i in range(3)]
    return noisy + flat


@pytest.fixture(scope="module")
def split_imgs():
    return [parse(d) for d in split_corpus()]


def _eq(got, want, what=""):
    np.testing.assert_array_equal(
        np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), err_msg=what,
    )


def _oracle_coeffs(imgs):
    return np.concatenate([oracle.entropy_decode(im) for im in imgs])


# ---------------------------------------------------------------------------
# the staged restart chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", [False, True])
def test_decode_plan_and_assemble_match_jax(split_imgs, split):
    jp = jfsm.build_plan(split_imgs, split=split)
    tp = tfsm.build_plan(split_imgs, split=split)
    assert len(tp.groups) == len(jp.groups) == (2 if split else 1)
    jpl, (jmal, jenv) = jfsm.decode_plan(jp)
    up = tfsm.upload_plan(tp, "cpu")
    pl, (mal, env) = tfsm.decode_plan(tp, uploaded=up)
    assert pl.dtype == torch.int32
    _eq(pl, jpl, "per_lane")
    _eq(mal, jmal, "err_mal")
    _eq(env, jenv, "err_env")
    assert not bool(mal.any() | env.any())
    # the same rows without an upload of the caller's own
    _eq(tfsm.decode_plan(tp, device="cpu")[0], jpl, "per_lane, own upload")
    host = tfsm.assemble(pl.numpy(), tp.layout)
    _eq(host, jfsm.assemble(np.asarray(jpl), jp.layout), "assemble")
    _eq(host, _oracle_coeffs(split_imgs), "assemble vs oracle")
    batched = tfsm.assemble_batched(pl, layout=tp.layout, pad_to=8)
    _eq(batched, jfsm.assemble_batched(jpl, layout=jp.layout, pad_to=8),
        "assemble_batched")
    assert batched.shape == (8, 6 * 8 * 3, 64)
    _eq(batched[:6].reshape(-1, 64), host, "assemble_batched vs assemble")
    assert not bool(batched[6:].any())


def test_upload_plan_carries_every_group(split_imgs):
    tp = tfsm.build_plan(split_imgs)
    groups, perm = tfsm.upload_plan(tp, "cpu")
    assert len(groups) == 2
    for (xs, sn), (hx, hs) in zip(groups, tp.groups):
        _eq(xs, hx)
        _eq(sn, hs)
    _eq(perm, tp.perm)


def test_entropy_decode_fsm_matches_jax_and_oracle(split_imgs):
    got = tfsm.entropy_decode_fsm(split_imgs, device="cpu")
    assert got.dtype == np.int32
    _eq(got, jfsm.entropy_decode_fsm(split_imgs), "vs JAX")
    _eq(got, _oracle_coeffs(split_imgs), "vs oracle")


def _noisy_q95():
    import cv2

    rng = np.random.default_rng(11)
    arr = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    ok, enc = cv2.imencode(
        ".jpg", arr,
        [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    )
    assert ok
    return parse(enc.tobytes())


def test_entropy_decode_fsm_takes_the_safe_rung(monkeypatch):
    # one symbol step per byte latches the envelope on this stream; the
    # second rung (STEPS_SAFE) decodes it, in both packages
    img = _noisy_q95()
    plan = tfsm.build_plan([img])
    _, (_, env) = tfsm.decode_plan(plan, steps=1, device="cpu")
    assert bool(env.any())
    monkeypatch.setattr(tfsm, "STEPS_PRODUCTION", 1)
    monkeypatch.setattr(jfsm, "STEPS_PRODUCTION", 1)
    got = tfsm.entropy_decode_fsm([img], device="cpu")
    _eq(got, jfsm.entropy_decode_fsm([img]), "vs JAX")
    _eq(got, oracle.entropy_decode(img), "vs oracle")


def test_entropy_decode_fsm_raises_like_jax(monkeypatch):
    img = parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=21,
                              quality=95))
    img.scan_data = img.scan_data.copy()
    img.scan_data[-img.scan_data.size // 3 :] = 0xFF
    with pytest.raises(JpegError) as got:
        tfsm.entropy_decode_fsm([img], device="cpu")
    with pytest.raises(JaxJpegError) as want:
        jfsm.entropy_decode_fsm([img])
    assert str(got.value) == str(want.value)
    assert "malformed" in str(got.value)
    # both rungs at one step per byte: outside the envelope
    noisy = _noisy_q95()
    for mod in (tfsm, jfsm):
        monkeypatch.setattr(mod, "STEPS_PRODUCTION", 1)
        monkeypatch.setattr(mod, "STEPS_SAFE", 1)
    with pytest.raises(JpegError) as got:
        tfsm.entropy_decode_fsm([noisy], device="cpu")
    with pytest.raises(JaxJpegError) as want:
        jfsm.entropy_decode_fsm([noisy])
    assert str(got.value) == str(want.value)
    assert "envelope" in str(got.value)


# ---------------------------------------------------------------------------
# the speculative entry points
# ---------------------------------------------------------------------------


def _smooth(shape=(96, 128), seeds=(3, 4)):
    return [parse(make_jpeg(shape=shape, seed=s)) for s in seeds]


@pytest.mark.parametrize("chunk_bytes", [CB, 2048])
def test_build_spec_plan_field_equal(chunk_bytes):
    img = _smooth()[0]
    jp = jfsm.build_spec_plan(img, chunk_bytes)
    tp = tfsm.build_spec_plan(img, chunk_bytes)
    assert [f.name for f in dataclasses.fields(tp)] == \
        [f.name for f in dataclasses.fields(jp)]
    for f in dataclasses.fields(tfsm.SpecPlan):
        got, want = getattr(tp, f.name), getattr(jp, f.name)
        if f.name == "tables":
            assert got == convert.tables_from_jax(want)
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, f.name
            _eq(got, want, f.name)
        else:
            assert got == want, f.name


def test_decode_speculative_matches_jax_and_oracle():
    img = _smooth()[0]
    got = tfsm.decode_speculative(img, chunk_bytes=CB, device="cpu")
    assert got.dtype == np.int32
    _eq(got, jfsm.decode_speculative(img, chunk_bytes=CB), "vs JAX")
    _eq(got, oracle.entropy_decode(img), "vs oracle")


def test_decode_speculative_retries_at_safe(monkeypatch):
    # a production budget of one step per byte latches the count pass's
    # envelope on this stream; the single-image entry retries at SAFE
    img = _smooth()[0]
    monkeypatch.setattr(tfsm, "STEPS_PRODUCTION", 1)
    with pytest.raises(tfsm.SpecEnvelopeError):
        tfsm.decode_speculative_batch([img], CB, steps=1, device="cpu")
    got = tfsm.decode_speculative(img, chunk_bytes=CB, device="cpu")
    _eq(got, oracle.entropy_decode(img), "vs oracle")


def test_decode_speculative_batch_host_list_mixed_geometry():
    imgs = _smooth() + _smooth(shape=(64, 96), seeds=(5,))
    want = jfsm.decode_speculative_batch(imgs, CB)
    got = tfsm.decode_speculative_batch(imgs, CB, device="cpu")
    assert len(got) == len(want) == 3
    for g, w, im in zip(got, want, imgs):
        assert g.dtype == np.int32
        _eq(g, w, "vs JAX")
        _eq(g, oracle.entropy_decode(im), "vs oracle")
    with pytest.raises(JpegError):
        tfsm.decode_speculative_batch(imgs, CB, device_out=True,
                                      device="cpu")


def test_decode_speculative_sync_host_list():
    imgs = _smooth()
    want = jfsm.decode_speculative_sync(imgs, CB, device_out=False)
    got = tfsm.decode_speculative_sync(imgs, CB, device_out=False,
                                       device="cpu")
    assert len(got) == len(want) == 2
    for g, w, im in zip(got, want, imgs):
        _eq(g, w, "vs JAX")
        _eq(g, oracle.entropy_decode(im), "vs oracle")
    # the port refuses a batch of mixed block counts either way; the JAX
    # package gathers it at the first image's count
    with pytest.raises(JpegError):
        tfsm.decode_speculative_sync(
            imgs + _smooth(shape=(64, 96), seeds=(5,)), CB,
            device_out=False, device="cpu")


def test_speculative_defaults_follow_jax():
    for name in ("decode_speculative_batch", "decode_speculative_sync"):
        tdef = inspect.signature(getattr(tfsm, name)).parameters
        jdef = inspect.signature(getattr(jfsm, name)).parameters
        assert tdef["device_out"].default == jdef["device_out"].default, name
        assert list(tdef)[:3] == list(jdef)[:3], name


# ---------------------------------------------------------------------------
# the package root
# ---------------------------------------------------------------------------


def test_root_exports_match_jax():
    assert tpujpeg_torch.__all__ == tpujpeg.__all__
    assert tpujpeg_torch.__version__ == tpujpeg.__version__
    from tpujpeg_torch.io import parser

    assert tpujpeg_torch.JpegImage is parser.JpegImage
    path = fixture_path(GOLDEN[2])
    with open(path, "rb") as f:
        data = f.read()
    a, b = tpujpeg_torch.parse(data), tpujpeg_torch.parse_file(path)
    assert isinstance(a, parser.JpegImage)
    assert (a.width, a.height) == (b.width, b.height) == (120, 120)
    _eq(a.scan_data, tpujpeg.parse(data).scan_data)


@pytest.mark.parametrize("backend", ["cuda", "auto", "cpu", "oracle"])
@pytest.mark.parametrize("name", [GOLDEN[2], GOLDEN[4]])
def test_root_decode_every_backend(name, backend):
    path = fixture_path(name)
    kw = {"device": "cpu"} if backend == "cuda" else {}
    got = tpujpeg_torch.decode(path, backend=backend, **kw)
    jax_backend = "tpu" if backend == "cuda" else backend
    want = tpujpeg.decode(path, backend=jax_backend)
    assert got.dtype == np.int32 == want.dtype
    _eq(got, want, "vs JAX")
    _eq(got, read_array(fixture_path(name, ".array")), "vs golden")


def test_root_decode_auto_follows_the_native_library(monkeypatch):
    from tpujpeg_torch import pipeline
    from tpujpeg_torch.runtime import host

    taken = []
    real = pipeline.decode
    monkeypatch.setattr(pipeline, "decode",
                        lambda *a, **k: taken.append(k) or real(*a, **k))
    path = fixture_path(GOLDEN[2])
    want = read_array(fixture_path(GOLDEN[2], ".array"))
    _eq(tpujpeg_torch.decode(path, backend="auto"), want)
    assert not taken or host._load_native() is None
    monkeypatch.setattr(host, "_load_native", lambda: None)
    _eq(tpujpeg_torch.decode(path, backend="auto", device="cpu"), want)
    assert taken and taken[-1]["device"] == "cpu"
    with pytest.raises(ValueError):
        tpujpeg_torch.decode(path, backend="tpu")


def test_root_defaults_stay_on_the_card():
    from tpujpeg_torch.runtime.batch import BatchDecoder

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters
                .items() if p.default is not inspect.Parameter.empty}

    assert defaults(tpujpeg_torch.decode)["backend"] == "cuda"
    assert defaults(tpujpeg_torch.decode)["device"] == "cuda"
    assert defaults(tpujpeg_torch.decode_batch)["backend"] == "fsm"
    assert defaults(BatchDecoder)["backend"] == "fsm"
    assert defaults(BatchDecoder)["device"] == "cuda"
    # the JAX package's defaults would route one image to the CPU
    assert defaults(tpujpeg.decode)["backend"] == "auto"


def test_decode_batch_takes_every_backend():
    datas = [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s)
             for s in (1, 2)]
    want = [oracle.decode(parse(d)).astype(np.uint8) for d in datas]
    for backend in ("fsm", "host", "oracle", "cpu", "auto"):
        got = tpujpeg_torch.decode_batch(datas, backend=backend,
                                         device="cpu")
        for g, w in zip(got, want):
            _eq(g, w, backend)
