"""tpujpeg_torch FSM host half and plain scan == the JAX package's.

Same numpy inputs on both sides; every comparison is exact (`==`):
  * build_tables / build_plan, and convert.tables_from_jax /
    plan_from_jax, field-equal to the JAX objects, one stride group and
    build_plan's split into two (groups and perm: the committed rst640 x
    8 chunk and a small synthetic corpus);
  * the scan LUT == the JAX piece select tree (_bst_tree) on every peek;
  * fsm_scan (plain, CPU) == JAX _fsm_scan: events, err_mal, err_env at
    steps (1, 2), 1 and 3, on restart streams, on a noisy q95 stream that
    leaves the envelope at steps 1, and on a 0xFF-tailed malformed stream;
    at the multi-byte columns (2, 3), (2, 4) and (4, 7) on the same
    streams (rows of whole columns and one byte short of them) and with
    pad_info on bucket-raster plans; the steps specs both refuse;
  * _dc_cumsum == JAX.
The JAX scan runs under jit with its carry returned (XLA:CPU hangs on a
scan whose carry is dead).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujpeg.io.parser import parse, parse_file
from tpujpeg.ops import fsm as jfsm
from tpujpeg_torch import convert
from tpujpeg_torch.ops import fsm as tfsm

from conftest import GOLDEN, fixture_path, make_jpeg_rst


@functools.partial(jax.jit, static_argnames=("tables", "steps"))
def _jax_scan(xs, seg_n, tables, steps):
    events, (err_mal, err_env), state = jfsm._fsm_scan(
        xs.T, seg_n, tables, steps=steps
    )
    return events, err_mal, err_env, state


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


def _malformed():
    img = parse(
        make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=21, quality=95)
    )
    img.scan_data = img.scan_data.copy()
    img.scan_data[-img.scan_data.size // 3 :] = 0xFF
    return img


CORPORA = {
    "rst": lambda: [
        parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s))
        for s in (1, 2)
    ],
    "rst3_q30": lambda: [
        parse(make_jpeg_rst(shape=(40, 56), rst_interval=3, seed=4,
                            quality=30))
    ],
    "noisy_q95": lambda: [_noisy_q95()],
    "malformed": lambda: [_malformed()],
}


@pytest.fixture(scope="module")
def corpora():
    return {name: make() for name, make in CORPORA.items()}


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "groups":
            assert len(va) == len(vb), f.name
            for (xa, sa), (xb, sb) in zip(va, vb):
                np.testing.assert_array_equal(xa, xb, err_msg="xs")
                np.testing.assert_array_equal(sa, sb, err_msg="seg_n")
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("name", GOLDEN[:3] + list(CORPORA))
def test_tables_and_plan_field_equal(corpora, name):
    imgs = corpora.get(name) or [parse_file(fixture_path(name))]
    jt = jfsm.build_tables(imgs[0])
    tt = tfsm.build_tables(imgs[0])
    for f in dataclasses.fields(tfsm.FsmTables):
        assert getattr(tt, f.name) == getattr(jt, f.name), f.name
    assert convert.tables_from_jax(jt) == tt
    jp = jfsm.build_plan(imgs, split=False)
    tp = tfsm.build_plan(imgs, split=False)
    _fields_equal(tp, convert.plan_from_jax(jp))
    (jxs, jsn), = jp.groups
    np.testing.assert_array_equal(tp.xs, jxs)
    np.testing.assert_array_equal(tp.seg_n_blocks, jsn)
    assert (tp.max_blk, tp.layout, tp.n_blocks_total) == (
        jp.max_blk, jp.layout, jp.n_blocks_total
    )


def _rst640_x8():
    import os

    from conftest import FIXTURES

    folder = os.path.join(FIXTURES, "rst640")
    names = sorted(n for n in os.listdir(folder) if n.endswith(".jpg"))
    return [parse_file(os.path.join(folder, n)) for n in names] * 8


def _split_corpus():
    from test_torch_entry import split_corpus

    return [parse(d) for d in split_corpus()]


@pytest.mark.parametrize("corpus", ["rst640_x8", "synthetic"])
def test_split_plan_field_equal(corpus):
    imgs = _rst640_x8() if corpus == "rst640_x8" else _split_corpus()
    jp = jfsm.build_plan(imgs)
    tp = tfsm.build_plan(imgs)
    assert len(tp.groups) == len(jp.groups) == 2
    _fields_equal(tp, convert.plan_from_jax(jp))
    np.testing.assert_array_equal(tp.perm, jp.perm)
    for (tx, ts), (jx, js) in zip(tp.groups, jp.groups):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ts, js)
    assert tp.perm.dtype == np.int32
    # every lane appears once in the group-concatenated rows
    rows = sum(g[0].shape[0] for g in tp.groups)
    assert len(set(tp.perm.tolist())) == tp.perm.size and tp.perm.max() < rows
    if corpus == "rst640_x8":
        assert [g[0].shape for g in tp.groups] == [(4608, 2560),
                                                   (5760, 1536)]
    one = tfsm.build_plan(imgs, split=False)
    _fields_equal(one, convert.plan_from_jax(
        jfsm.build_plan(imgs, split=False)))
    assert len(one.groups) == 1
    np.testing.assert_array_equal(one.perm, np.arange(one.perm.size))


def test_single_group_views_raise_on_a_split_plan():
    imgs = _split_corpus()
    tp = tfsm.build_plan(imgs)
    for view in ("xs", "seg_n_blocks"):
        with pytest.raises(ValueError, match="multi-group"):
            getattr(tp, view)
        with pytest.raises(AssertionError, match="multi-group"):
            getattr(jfsm.build_plan(imgs), view)
    one = tfsm.build_plan(imgs, split=False)
    np.testing.assert_array_equal(one.xs, one.groups[0][0])
    np.testing.assert_array_equal(one.seg_n_blocks, one.groups[0][1])


@pytest.mark.parametrize("name", ["rst", "noisy_q95"])
def test_lut_matches_piece_tree_on_every_peek(corpora, name):
    tables = tfsm.build_tables(corpora[name][0])
    key = jnp.arange(tfsm.N_TABLES << 16, dtype=jnp.int32)
    packed = np.asarray(
        jfsm._bst_tree(key, tables.piece_keys, tables.piece_vals)
    ).astype(np.int64)
    length = packed >> 17
    base = (packed & 0x1FFFF) - 0x10000
    peek = np.arange(tfsm.N_TABLES << 16) & 0xFFFF
    sym = (base + (peek >> np.clip(16 - length, 0, 16))) & 0xFF
    lut = tfsm.symbol_lut(tables).reshape(-1).astype(np.int64)
    np.testing.assert_array_equal(lut >> 8, length)
    valid = length <= 16
    assert valid.any() and (~valid).any()
    np.testing.assert_array_equal((lut & 0xFF)[valid], sym[valid])


@pytest.mark.parametrize("steps", [(1, 2), 1, 3])
@pytest.mark.parametrize("name", list(CORPORA))
def test_plain_scan_matches_jax(corpora, name, steps):
    plan = tfsm.build_plan(corpora[name], split=False)
    # the JAX side runs its own tables (two-level symbol map and all)
    want_ev, want_mal, want_env, _ = _jax_scan(
        jnp.asarray(plan.xs), jnp.asarray(plan.seg_n_blocks),
        jfsm.build_tables(corpora[name][0]), steps,
    )
    ev, mal, env = tfsm.fsm_scan(
        torch.as_tensor(plan.xs), torch.as_tensor(plan.seg_n_blocks),
        plan.tables, steps,
    )
    np.testing.assert_array_equal(ev.numpy(), np.asarray(want_ev))
    np.testing.assert_array_equal(mal.numpy(), np.asarray(want_mal))
    np.testing.assert_array_equal(env.numpy(), np.asarray(want_env))
    if name == "noisy_q95" and steps == 1:
        assert env.any()  # the case exercises the envelope latch
    if name == "malformed":
        assert mal.any()


MULTI_BYTE = [(2, 3), (2, 4), (4, 7)]


@pytest.mark.parametrize("steps", MULTI_BYTE)
@pytest.mark.parametrize("name", list(CORPORA))
def test_plain_scan_matches_jax_multi_byte(corpora, name, steps):
    # columns of 2 and 4 bytes, each refilled on its own with its share of
    # the column's steps; on the full rows and on a column prefix one byte
    # short of whole columns (its pad bytes are refilled as data)
    plan = tfsm.build_plan(corpora[name], split=False)
    stride = plan.xs.shape[1]
    for n in (stride, stride - 1):
        xs = np.ascontiguousarray(plan.xs[:, :n])
        want_ev, want_mal, want_env, _ = _jax_scan(
            jnp.asarray(xs), jnp.asarray(plan.seg_n_blocks),
            jfsm.build_tables(corpora[name][0]), steps,
        )
        ev, mal, env = tfsm.fsm_scan(
            torch.as_tensor(xs), torch.as_tensor(plan.seg_n_blocks),
            plan.tables, steps,
        )
        assert ev.shape == (-(-n // steps[0]) + tfsm.FLUSH_COLS, steps[1],
                            xs.shape[0])
        np.testing.assert_array_equal(ev.numpy(), np.asarray(want_ev))
        np.testing.assert_array_equal(mal.numpy(), np.asarray(want_mal))
        np.testing.assert_array_equal(env.numpy(), np.asarray(want_env))
    if name == "malformed":
        assert mal.any()


@pytest.mark.parametrize("steps", MULTI_BYTE)
@pytest.mark.parametrize("name", ["ragged_k2", "truncated"])
def test_plain_pad_scan_matches_jax_multi_byte(name, steps):
    from test_torch_buckets import SCAN_CORPORA, _common_bucket, _jax_scan_pad

    imgs = SCAN_CORPORA[name]()
    plan = tfsm.build_plan_bucketed(imgs, _common_bucket(imgs))
    want = _jax_scan_pad(
        jnp.asarray(plan.xs), jnp.asarray(plan.seg_n),
        jnp.asarray(plan.wrap_at), jnp.asarray(plan.skip),
        jfsm.build_tables(imgs[0]), steps)
    got = tfsm.fsm_scan(
        torch.as_tensor(plan.xs), torch.as_tensor(plan.seg_n), plan.tables,
        steps, pad_info=(torch.as_tensor(plan.wrap_at),
                         torch.as_tensor(plan.skip)))
    for g, w in zip(got, want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scan_rejects_unported_specs(corpora):
    # the steps specs the JAX scan asserts against: more than 4 bytes a
    # column, fewer steps than bytes, and multi-byte columns in the
    # speculative modes (a partial first byte is per byte)
    plan = tfsm.build_plan(corpora["rst"], split=False)
    xs = torch.as_tensor(plan.xs)
    sn = torch.as_tensor(plan.seg_n_blocks)
    for bad in ((5, 5), (2, 1), (0, 2)):
        with pytest.raises(ValueError):
            tfsm.fsm_scan(xs, sn, plan.tables, bad)
    starts = torch.zeros_like(sn)
    for kw in (dict(start_bits=starts), dict(log_anchors=True)):
        with pytest.raises(ValueError, match="restart mode"):
            tfsm.fsm_scan_spec(xs, sn, plan.tables, (2, 4), **kw)
    with pytest.raises(ValueError, match="restart mode"):
        tfsm.fsm_scan_spec_plain(xs, sn, plan.tables, (2, 4),
                                 start_bits=starts)
    with pytest.raises(AssertionError):
        jfsm._fsm_scan(jnp.asarray(plan.xs).T, jnp.asarray(plan.seg_n_blocks),
                       jfsm.build_tables(corpora["rst"][0]), steps=(2, 4),
                       start_bits=jnp.asarray(starts.numpy()))


def test_dc_cumsum_matches_jax(corpora):
    tables = tfsm.build_tables(corpora["rst"][0])
    rng = np.random.default_rng(3)
    max_blk = 40  # not a multiple of the 3 blocks per MCU: exercises the pad
    dc = rng.integers(-2047, 2048, (128, max_blk)).astype(np.int32)
    want = jfsm._dc_cumsum(
        jnp.asarray(dc), jfsm.build_tables(corpora["rst"][0]), max_blk
    )
    got = tfsm._dc_cumsum(torch.as_tensor(dc), tables, max_blk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
