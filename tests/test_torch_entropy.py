"""tpujpeg_torch lockstep-lane segment decoder and the `gather` backend ==
the JAX package's.

Same numpy inputs on both sides; every comparison is exact (`==`):
  * build_segment_plan field-equal to the JAX one, and
    convert.segment_plan_from_jax too;
  * decode_segments_plain (CPU) == the JAX decode_segments, coefficients
    and err, on every case of tests/test_entropy_device.py (restart
    intervals 1, 3, 5, a single segment, a mixed batch, the first three
    goldens, 4:2:2 and 4:2:0, grayscale, a truncated stream, the lane
    padding), on a stream with an invalid code, and with a step cap
    that leaves lanes undone;
  * the engine's backend "gather" == the JAX engine's, outputs and
    counters, with on_error="skip" on a bad stream, and decode_batch.
  * the kernel's compact tables (segment_tables) == luts on every 16-bit
    peek of every Huffman table of every stream in tests/fixtures, and of
    random tables, through segment_table_lookup (the kernel's lookup);
    device_luts keeps them beside its tensor, once per table set
    (device_segment_tables).
The CUDA kernel is held against decode_segments_plain by
tests/test_torch_kernels.py on a card.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujpeg.errors import JpegError as JaxJpegError
from tpujpeg.io.parser import parse, parse_file
from tpujpeg.ops import entropy as jent
from tpujpeg.oracle import decoder as oracle
from tpujpeg.runtime.batch import BatchDecoder as JaxBatchDecoder
from tpujpeg_torch import JpegError, convert, decode_batch
from tpujpeg_torch.ops import entropy as tent
from tpujpeg_torch.runtime.batch import BatchDecoder

from conftest import GOLDEN, fixture_path, make_jpeg, make_jpeg_rst
from test_torch_buckets import _stats_equal


def _truncated():
    img = parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=11))
    img.scan_data = img.scan_data[: img.scan_data.size // 4].copy()
    img.segment_offsets = img.segment_offsets[
        img.segment_offsets < img.scan_data.size
    ]
    return [img]


def _invalid_code():
    # a 0xFF tail: no AC code of these tables matches sixteen one bits
    img = parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=21,
                              quality=95))
    img.scan_data = img.scan_data.copy()
    img.scan_data[-img.scan_data.size // 3 :] = 0xFF
    return [img]


CASES = {
    **{f"rst{r}": (lambda r=r: [parse(make_jpeg_rst(
        shape=(48, 64), rst_interval=r, seed=r))]) for r in (1, 3, 5)},
    "single_segment": lambda: [parse(make_jpeg(shape=(40, 56), quality=85,
                                               seed=2))],
    "mixed_batch": lambda: [
        parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=7)),
        parse(make_jpeg(shape=(48, 64), quality=70, seed=8)),
        parse(make_jpeg_rst(shape=(48, 64), rst_interval=4, seed=9)),
    ],
    **{f"golden_{g}": (lambda g=g: [parse_file(fixture_path(g))])
       for g in GOLDEN[:3]},
    **{f"subsampling{s}": (lambda s=s: [parse(make_jpeg(
        shape=(48, 64), subsampling=s, seed=4))]) for s in (1, 2)},
    "grayscale": lambda: [parse(make_jpeg(shape=(40, 48), gray=True,
                                          seed=5))],
    "truncated": _truncated,
    "invalid_code": _invalid_code,
}
FAILING = ("truncated", "invalid_code")
ARRAYS = ("scan", "seg_start_bits", "seg_block_base", "seg_n_blocks",
          "rows", "luts", "pattern")


def _port_imgs(imgs):
    return [convert.image_from_jax(im) for im in imgs]


def _jax_decode(plan, cap=None):
    coeffs, err = jent.decode_segments(
        *(jnp.asarray(getattr(plan, f)) for f in ARRAYS),
        cap=plan.cap if cap is None else cap,
        n_blocks_total=plan.n_blocks_total,
    )
    return np.asarray(coeffs), np.asarray(err)


def _plain_decode(plan, cap=None):
    coeffs, err = tent.decode_segments_plain(
        *(torch.as_tensor(np.asarray(getattr(plan, f))) for f in ARRAYS),
        cap=plan.cap if cap is None else cap,
        n_blocks_total=plan.n_blocks_total,
    )
    return coeffs.numpy(), err.numpy()


def _fields_equal(got, want):
    for f in dataclasses.fields(jent.SegmentPlan):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert np.asarray(g).dtype == np.asarray(w).dtype, f.name
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f.name)


@pytest.mark.parametrize("name", list(CASES))
def test_segment_plan_field_equal(name):
    imgs = CASES[name]()
    want = jent.build_segment_plan(imgs)
    got = tent.build_segment_plan(_port_imgs(imgs))
    _fields_equal(got, want)
    _fields_equal(convert.segment_plan_from_jax(want), want)
    # lane padding: pad lanes have 0 blocks, sizes are bucketed
    assert got.seg_start_bits.shape[0] % 64 == 0
    assert got.cap % 256 == 0 and got.scan.size % (1 << 16) == 0
    n_lanes = sum(im.n_segments() for im in imgs)
    assert not got.seg_n_blocks[n_lanes:].any()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_decode_matches_jax(name):
    imgs = CASES[name]()
    jplan = jent.build_segment_plan(imgs)
    want_c, want_e = _jax_decode(jplan)
    got_c, got_e = _plain_decode(convert.segment_plan_from_jax(jplan))
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_e, want_e)
    if name in FAILING:
        assert got_e.any()
    else:
        assert not got_e.any()
        np.testing.assert_array_equal(
            got_c, np.concatenate([oracle.entropy_decode(im) for im in imgs]))


@pytest.mark.parametrize("name", ["mixed_batch", "subsampling2"])
def test_plain_decode_matches_jax_at_a_short_cap(name):
    # a cap of 300 steps (one JAX chunk of 256 rounded up: 512) leaves the
    # deep lanes undone: they latch err with what they wrote so far
    jplan = jent.build_segment_plan(CASES[name]())
    want_c, want_e = _jax_decode(jplan, cap=300)
    got_c, got_e = _plain_decode(convert.segment_plan_from_jax(jplan),
                                 cap=300)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_e, want_e)
    assert got_e.any() and not got_e.all()


def test_entropy_decode_device_raises_like_jax():
    imgs = _truncated()
    with pytest.raises(JaxJpegError):
        jent.entropy_decode_device(imgs)
    with pytest.raises(JpegError):
        tent.entropy_decode_device(_port_imgs(imgs), device="cpu")
    good = CASES["mixed_batch"]()
    np.testing.assert_array_equal(
        tent.entropy_decode_device(_port_imgs(good), device="cpu"),
        jent.entropy_decode_device(good))


def test_device_luts_cached_per_table_set():
    plan = tent.build_segment_plan(_port_imgs(CASES["rst3"]()))
    again = tent.build_segment_plan(_port_imgs(CASES["rst5"]()))
    first = tent.device_luts(plan.luts, "cpu")
    assert tent.device_luts(again.luts, "cpu") is first
    np.testing.assert_array_equal(first.numpy(), plan.luts)


def _gather_datas():
    return [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s)
            for s in (1, 2, 3)] + [make_jpeg(shape=(48, 64), seed=4)]


def test_gather_backend_matches_jax_engine():
    datas = _gather_datas()
    dec = BatchDecoder(backend="gather", chunk_size=2, device="cpu")
    got = dec.decode(datas)
    jdec = JaxBatchDecoder(backend="gather", chunk_size=2)
    jgot = jdec.decode(datas)
    _stats_equal(dec.stats, jdec.stats)
    assert dec.stats.backend == "gather" and dec.stats.chunks == 2
    for g, j, d in zip(got, jgot, datas):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(
            g, oracle.decode(parse(d)).astype(np.uint8))
    # decode_parsed and fetch=False through the same route
    assert dec.decode_parsed([parse(d) for d in datas], fetch=False) is None
    assert dec.stats.backend == "gather"
    dec.close()
    for g, j in zip(decode_batch(datas, backend="gather", device="cpu"),
                    jgot):
        np.testing.assert_array_equal(g, j)


def test_gather_backend_skip_sends_a_bad_chunk_to_the_host_like_jax():
    imgs = [parse(d) for d in _gather_datas()[:3]] + _invalid_code()
    dec = BatchDecoder(backend="gather", chunk_size=4, device="cpu")
    got = dec.decode_parsed(imgs, on_error="skip")
    jdec = JaxBatchDecoder(backend="gather", chunk_size=4)
    jgot = jdec.decode_parsed(imgs, on_error="skip")
    # the failure messages come from each package's own host decoder
    # (their texts differ); which images failed is compared
    assert set(dec.stats.failures) == set(jdec.stats.failures) == {3}
    dec.stats.failures = jdec.stats.failures = {}
    _stats_equal(dec.stats, jdec.stats)
    assert dec.stats.backend == "host"
    assert got[3] is None and jgot[3] is None
    for g, j in zip(got[:3], jgot[:3]):
        np.testing.assert_array_equal(g, j)
    with pytest.raises(JpegError, match="device entropy decode failed"):
        dec.decode_parsed(imgs)
    dec.close()


FIXTURES = os.path.dirname(fixture_path(GOLDEN[0]))
TABLE_SETS = ["goldens", "rst640", "photo640", "rst640_420", "photo640_420",
              "mixed_rst", "mixed_rst_420", "sampling_small", "rst640_opt"]


def _assert_tables_exact(luts: np.ndarray):
    lt = torch.as_tensor(luts)
    ctab, roff = tent.segment_tables(lt)
    n = luts.shape[0]
    assert roff.dtype == torch.int32 and roff.shape == (n + 1,)
    assert int(roff[-1]) == ctab.numel() and not bool((roff % 64).any())
    row = torch.arange(n).repeat_interleave(tent.LUT_SIZE)
    peek = torch.arange(tent.LUT_SIZE).repeat(n)
    got = tent.segment_table_lookup(ctab, roff, row, peek)
    want = lt.reshape(-1).to(torch.int64)
    assert torch.equal(got & 0x1FFF, want)
    assert torch.equal((got >> 13) & 31, (want >> 8) + (want & 15))
    assert not bool((got >> 18).any())


@pytest.mark.parametrize("folder", TABLE_SETS)
def test_segment_tables_equal_luts_on_every_peek(folder):
    # every distinct table of the folder's scans (the JAX plans' luts), as
    # the rows of one luts array
    where = FIXTURES if folder == "goldens" else os.path.join(FIXTURES, folder)
    rows = {}
    for name in sorted(os.listdir(where)):
        if name.endswith(".jpg"):
            luts = jent.build_segment_plan(
                [parse_file(os.path.join(where, name))]).luts
            rows.update((r.tobytes(), r) for r in luts)
    assert rows
    _assert_tables_exact(np.stack(list(rows.values())))


def test_segment_tables_exact_on_random_luts():
    # entries of random lengths (0..16) and symbols: most 10-bit prefixes
    # are mixed, some rows are uniform stretches
    rng = np.random.default_rng(15)
    length = rng.integers(0, 17, (3, 1024, 1)).repeat(64, 2)
    length[0, :, 32:] = rng.integers(0, 17, (1024, 32))
    sym = rng.integers(0, 256, (3, 1024, 64))
    sym[2] = sym[2, :, :1]
    _assert_tables_exact(((length << 8) | sym).reshape(3, -1).astype(np.int32))


def test_device_segment_tables_cached_per_tensor():
    # device_luts keeps the kernel's tables beside its tensor, once per
    # table set; a luts tensor from elsewhere gets them derived anew
    plan = tent.build_segment_plan(_port_imgs(CASES["rst3"]()))
    tent._lut_cache.clear()
    luts = tent.device_luts(plan.luts, "cpu")
    first = tent.device_segment_tables(luts)
    assert tent.device_segment_tables(luts) is first
    assert all(torch.equal(a, b)
               for a, b in zip(first, tent.segment_tables(luts)))
    again = tent.build_segment_plan(_port_imgs(CASES["rst3"]()))
    assert tent.device_segment_tables(
        tent.device_luts(again.luts, "cpu")) is first
    other = luts.clone()
    fresh = tent.device_segment_tables(other)
    assert fresh is not first and tent.device_segment_tables(other) \
        is not fresh
    assert all(torch.equal(a, b) for a, b in zip(fresh, first))
