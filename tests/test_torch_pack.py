"""Lane matrices described by the plan builders and packed where they are
read (ops/fsm.py ScanLanes, pack_lanes_plain; the engine's _Upload), on
the CPU.

Every builder's host matrix (`xs`, FsmPlan's `groups`), made from its
lane tables by the plain pack, equals byte for byte what the row loop
the builders ran before made (kept here: `_rows_*`): restart 4:4:4 and
4:2:0, build_plan's split into two stride groups, the speculative plan
at 1,024 and 2,048 bytes a lane (a last lane shorter than the stride, a
one-lane image, padding lanes) and a bucket plan with zero-quota lanes.
The matrix packed on the device (`ScanLanes.to`, `upload_plan`,
`_upload_spec`, the fused chain's own upload) equals it too.
pack_lanes_plain on odd source offsets, lengths 0 and the full stride,
a lane that ends at the source's last byte, and an empty source.  The
engine counts
`lane_pack_chunks` for every restart and speculative chunk (the Jacobi
fallback once) and for no host-bucketed chunk.  The kernel itself
(csrc/pack.cu) is held to pack_lanes_plain on the card in
tests/test_torch_kernels.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpujpeg_torch import JpegError
from tpujpeg_torch.io.parser import parse, parse_file
from tpujpeg_torch.ops import fsm
from tpujpeg_torch.pipeline import Geometry, bucket_up
from tpujpeg_torch.runtime import fused
from tpujpeg_torch.runtime.batch import BatchDecoder

from conftest import FIXTURES, make_jpeg, make_jpeg_rst


def _folder(name, count=None):
    folder = os.path.join(FIXTURES, name)
    names = sorted(n for n in os.listdir(folder) if n.endswith(".jpg"))
    return [parse_file(os.path.join(folder, n)) for n in names[:count]]


# ---------------------------------------------------------------------------
# the row loops the builders ran before their lanes were described
# ---------------------------------------------------------------------------


def _segments(img):
    ri = img.restart_interval or img.n_mcus
    need = -(-img.n_mcus // ri)
    offs = img.segment_offsets
    ends = np.append(offs[1:need], img.scan_data.size)
    return [img.scan_data[int(offs[s]) : int(ends[s])] for s in range(need)]


def _rows(parts, L, stride):
    xs = np.zeros((L, stride), np.uint8)
    for row, b in enumerate(parts):
        xs[row, : b.size] = b
    return xs


def _rows_plan(imgs, plan):
    """Each stride group's matrix: group g holds, in row order, the
    segments that `perm` puts there."""
    segs = [b for img in imgs for b in _segments(img)]
    out = []
    base = 0
    for xs, _ in plan.groups:
        Lg, stride = xs.shape
        at = {row - base: segs[i] for i, row in enumerate(plan.perm.tolist())
              if base <= row < base + Lg}
        out.append(_rows([at[r] for r in range(len(at))], Lg, stride))
        base += Lg
    return out


def _rows_spec(imgs, chunk_bytes, L):
    stride = chunk_bytes + fsm.SPEC_OVERLAP
    parts = []
    for img in imgs:
        scan = img.scan_data
        for i in range(max(1, -(-scan.size // chunk_bytes))):
            parts.append(scan[i * chunk_bytes : i * chunk_bytes + stride])
    return _rows(parts, L, stride)


def _rows_bucket(imgs, plan):
    parts = []
    for img in imgs:
        segs = _segments(img)
        parts += segs + [np.zeros(0, np.uint8)] * (plan.lanes_per_img
                                                    - len(segs))
    return _rows(parts, *plan.xs.shape)


def _split_imgs():
    """Six 48 x 64 noise streams, a restart marker every MCU, three at q95
    and three at q20: 288 segments in two length classes."""
    return [parse(make_jpeg_rst(shape=(48, 64), rst_interval=1, seed=i,
                                quality=95 if i < 3 else 20))
            for i in range(6)]


RESTART = {
    "444": lambda: _folder("rst640", 3),
    "420": lambda: _folder("rst640_420", 3),
    "synthetic": lambda: [parse(make_jpeg_rst(shape=(40, 56),
                                              rst_interval=3, seed=s))
                          for s in (1, 2, 3)],
}


@pytest.mark.parametrize("corpus", list(RESTART))
def test_restart_plan_matrix_equals_the_row_loop(corpus):
    imgs = RESTART[corpus]()
    plan = fsm.build_plan(imgs, split=False)
    want, = _rows_plan(imgs, plan)
    assert plan.xs.dtype == np.uint8 and plan.xs.shape == want.shape
    np.testing.assert_array_equal(plan.xs, want)
    assert plan.groups[0][0] is plan.xs      # made once, kept
    np.testing.assert_array_equal(plan.xs_lanes.host(), want)


def test_split_plan_matrices_equal_the_row_loop():
    imgs = _split_imgs()
    plan = fsm.build_plan(imgs)
    assert len(plan.groups) == 2 and len(plan.lanes) == 2
    assert plan.groups[0][0].shape[1] != plan.groups[1][0].shape[1]
    for (xs, sn), want, (lanes, sn2) in zip(plan.groups,
                                             _rows_plan(imgs, plan),
                                             plan.lanes):
        np.testing.assert_array_equal(xs, want)
        assert sn is sn2
    # one source for both groups, uploaded once
    assert plan.lanes[0][0].scans is plan.lanes[1][0].scans
    (g0, g1), perm = fsm.upload_plan(plan, "cpu")
    for (xs, sn), (dxs, dsn) in zip(plan.groups, (g0, g1)):
        np.testing.assert_array_equal(dxs.numpy(), xs)
        np.testing.assert_array_equal(dsn.numpy(), sn)
    np.testing.assert_array_equal(perm.numpy(), plan.perm)
    with pytest.raises(ValueError, match="multi-group"):
        plan.xs_lanes


def _tiny_photo():
    """A 16 x 16 stream without restart markers: one lane of 1,024 bytes."""
    return parse(make_jpeg(shape=(16, 16), seed=5))


@pytest.mark.parametrize("chunk_bytes", [1024, 2048])
def test_spec_plan_matrix_equals_the_row_loop(chunk_bytes):
    imgs = _folder("photo640", 2) + [_tiny_photo()]
    plan = fsm.build_spec_plan_batch(imgs, chunk_bytes)
    L, stride = plan.xs.shape
    assert stride == chunk_bytes + fsm.SPEC_OVERLAP and L % 128 == 0
    assert plan.n_lanes < L                          # padding lanes
    assert plan.img_lanes[-1] == 1                   # a one-lane image
    last = plan.img_first[0] + plan.img_lanes[0] - 1
    assert 0 < plan.lanes.lane_len[last] < stride    # a short last lane
    np.testing.assert_array_equal(plan.xs,
                                  _rows_spec(imgs, chunk_bytes, L))
    assert (plan.lanes.lane_len[plan.n_lanes:] == 0).all()
    np.testing.assert_array_equal(
        fsm._upload_spec(plan, None, "cpu").numpy(), plan.xs)


def test_bucket_plan_matrix_equals_the_row_loop():
    shapes = [(64, 80), (57, 41), (120, 56)]
    imgs = [parse(make_jpeg_rst(shape=s, rst_interval=-(-s[1] // 8), seed=i))
            for i, s in enumerate(shapes)]
    comps = Geometry.of(imgs[0]).comps
    bx = bucket_up(max(im.mcus_x for im in imgs))
    by = bucket_up(max(im.mcus_y for im in imgs))
    bucket = Geometry((bx * 8, by * 8, bx, by, comps))
    plan = fsm.build_plan_bucketed(imgs, bucket, pad_imgs=6)
    n_real = len(imgs) * plan.lanes_per_img
    assert (plan.seg_n[:n_real] == 0).any()          # zero-quota lanes
    assert (plan.lanes.lane_len[plan.seg_n == 0] == 0).all()
    np.testing.assert_array_equal(plan.xs, _rows_bucket(imgs, plan))
    assert plan.lanes.stride == plan.xs.shape[1]


def test_plans_made_from_arrays_keep_them_and_pack_them():
    imgs = RESTART["synthetic"]()
    plan = fsm.build_plan(imgs, split=False)
    again = fsm.FsmPlan(groups=plan.groups, perm=plan.perm,
                        tables=plan.tables, max_blk=plan.max_blk,
                        layout=plan.layout,
                        n_blocks_total=plan.n_blocks_total)
    assert again.xs is plan.xs
    np.testing.assert_array_equal(again.xs_lanes.to("cpu").numpy(), plan.xs)
    spec = fsm.build_spec_plan_batch([_tiny_photo()] * 2, 1024)
    copy = dataclasses.replace(spec, bpm=9)
    assert copy.xs is spec.xs and copy.bpm == 9
    np.testing.assert_array_equal(copy.lanes.host(), spec.xs)


def test_superchunk_packs_each_plan_at_the_widest_stride():
    plans = [fsm.build_plan(RESTART["synthetic"](), split=False),
             fsm.build_plan(_folder("rst640", 1), split=False)]
    xs, sn, sub = fused.pack_superchunk(plans)
    stride = max(p.xs.shape[1] for p in plans)
    want = np.concatenate([
        np.pad(p.xs, ((0, 0), (0, stride - p.xs.shape[1]))) for p in plans])
    np.testing.assert_array_equal(xs, want)
    np.testing.assert_array_equal(
        sn, np.concatenate([p.seg_n_blocks for p in plans]))
    assert sub == tuple(p.xs.shape[0] for p in plans)


# ---------------------------------------------------------------------------
# pack_lanes_plain and the tables' checks
# ---------------------------------------------------------------------------


def _plain_rows(src, off, ln, L, stride):
    xs = np.zeros((L, stride), np.uint8)
    for i, (o, n) in enumerate(zip(off, ln)):
        xs[i, :n] = src[o : o + n]
    return xs


@pytest.mark.parametrize("L", [1, 7, 300, 513])
def test_pack_lanes_plain_on_odd_offsets_and_edge_lengths(L):
    rng = np.random.default_rng(L)
    stride = 48
    src = rng.integers(0, 256, 5000, dtype=np.uint8)
    off = rng.integers(0, 5000 - stride, L).astype(np.int64) | 1   # odd
    ln = rng.integers(0, stride + 1, L).astype(np.int32)
    ln[::3] = 0
    ln[1::3] = stride
    off[-1], ln[-1] = 5000 - stride, stride          # the source's last byte
    got = fsm.pack_lanes(torch.from_numpy(src), torch.from_numpy(off),
                         torch.from_numpy(ln), L, stride)
    np.testing.assert_array_equal(got.numpy(),
                                  _plain_rows(src, off, ln, L, stride))
    out = torch.full((L, stride), 7, dtype=torch.uint8)
    fsm.pack_lanes_plain(torch.from_numpy(src), torch.from_numpy(off),
                         torch.from_numpy(ln), L, stride, out=out)
    np.testing.assert_array_equal(out.numpy(), got.numpy())


def test_pack_lanes_plain_of_an_empty_source_is_zeros():
    got = fsm.pack_lanes_plain(torch.zeros(0, dtype=torch.uint8),
                               torch.zeros(3, dtype=torch.int64),
                               torch.zeros(3, dtype=torch.int32), 3, 16)
    assert got.shape == (3, 16) and not got.any()


@pytest.mark.parametrize("bad", ["past_source", "past_row", "negative"])
def test_scan_lanes_refuse_a_lane_outside_its_bytes(bad):
    src = np.arange(100, dtype=np.uint8)
    off = np.array([0, 10], np.int64)
    ln = np.array([16, 16], np.int32)
    if bad == "past_source":
        off[1] = 90
    elif bad == "past_row":
        ln[0] = 17
    else:
        ln[1] = -1
    with pytest.raises(ValueError, match="outside"):
        fsm.ScanLanes((src,), np.array([0, 100], np.int64), off, ln, 16)


# ---------------------------------------------------------------------------
# the engine: one pack per restart and speculative chunk
# ---------------------------------------------------------------------------


def _refuse_plan(monkeypatch):
    def refuse(imgs, split=True):
        raise JpegError("no lane plan")

    monkeypatch.setattr(fsm, "build_plan", refuse)


def _force_miss(monkeypatch):
    def miss(pending):
        raise fsm.SpecSyncMiss("forced")

    monkeypatch.setattr(fsm, "spec_sync_resolve_host", miss)


def _photos():
    return [make_jpeg(shape=(64, 96), seed=s) for s in range(3)]


# case -> (streams, decoder options, set-up, route, packed chunks)
ENGINE = {
    "restart": (lambda: [make_jpeg_rst(shape=(48, 64), seed=s)
                         for s in range(4)], {}, None, "fsm", 2),
    "spec": (_photos, {}, [_refuse_plan], "fsm-spec-sync", 2),
    "jacobi": (_photos, {}, [_refuse_plan, _force_miss], "fsm-spec", 2),
    "host_bucketed": (lambda: [make_jpeg(shape=(40 + 8 * i, 56),
                                         subsampling=2, seed=i)
                               for i in range(3)],
                      {"size_buckets": True}, None, "host-bucketed", 0),
}


@pytest.mark.parametrize("case", list(ENGINE))
def test_engine_counts_each_chunk_whose_lanes_it_packed(case, monkeypatch):
    make, opts, setups, route, packed = ENGINE[case]
    for setup in setups or ():
        setup(monkeypatch)
    datas = make()
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu", **opts)
    try:
        got = dec.decode(datas)
    finally:
        dec.close()
    st = dec.stats
    assert set(st.route_chunks) == {route}, st.route_chunks
    assert st.lane_pack_chunks == packed
    assert st.as_dict()["lane_pack_chunks"] == packed
    assert len(got) == len(datas)
