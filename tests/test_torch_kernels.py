"""tpujpeg_torch CUDA kernels == their plain PyTorch versions, bit for bit.

Each kernel runs only on a CUDA card (there is no interpret mode), so
these tests carry the `gpu` marker and skip without one.  They import
nothing of JAX, so they also run on a machine without it:

    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu

Inputs are the committed restart corpus (tests/fixtures/rst640), the
no-restart corpus (tests/fixtures/photo640) split into speculative
lanes, the mixed-size corpus (tests/fixtures/mixed_rst) in bucket-raster
lanes, a 0xFF-tailed malformed copy, the 4:2:0 and grayscale restart
streams (tests/fixtures/rst640_420, tests/fixtures/sampling_small) for
the scan at 6 and at 1 blocks per MCU, and seeded numpy data.  The scan
is also held on warps that finish early or hold one long lane, on column
views read in place, and in anchor mode where a recovery marker falls in
the slot that ends a lane; the scatter on ragged, misaligned and empty
event matrices; the slot kernels on the edges of their tiles (groups
across a warp slice and a row chunk, groups of C and C + 1, lanes full to
the last row, rows after a hole, no rows, 1 to 33 lanes, misaligned
views, targets past M); the two rank-in-kernel compactions (`compact`,
`compact_full`: one body) on full and empty lanes, an event only at the
last row, every negative value, the event that packs to 0, row counts
around the 16-row slice and the 128-row chunk, lane counts around the
32-lane tile, no rows or no lanes (no launch), and an unaligned input;
`compact_offsets` (the same walk, reading (p, o)) and `spread_full` (the
body of `place_events`, validity from the event or from o) on the same
cases, the walk also on `compact_fine`'s residual offsets, `spread_full` past 65,535 event rows and on rows whose offset is
negative; compact.cuh's masked walk (`compact_offsets` with mask W - 1)
on lane counts that are no multiple of 32 or 4, a lane far behind the
lead and one that jumps ahead of the window, Np at the int16 span and
the event that packs to 0; `chain` on tables that are no power of two,
T = 1 and walks of no steps; the two gathers on odd row lengths, more rows than the grid,
tables on both sides of the warp-per-row limit, index views that start
4, 8 and 12 bytes into their storage, and empty inputs.  The scan's
multi-byte columns ((2, 3), (2, 4), (4, 7)) on malformed lanes, on a
column prefix of no whole number of columns and in pad mode; the segment
decoder (`decode_segments`) on restart lanes, malformed, truncated and
step-capped lanes, a lane count that is no multiple of 32, one lane a
stream without restart markers, 17,920 lanes (32 a block), 128 table
rows in one block, lanes of three table sets in a shuffled order, a scan
3 bytes into its storage, and scans cut 4 bytes past a lane's bytes or
40 bytes inside them (the peek's clamp at n_bytes - 4), at 41 lanes and
at 4,160 lanes with the cut lane inside a block of 32, and one malformed
lane inside a block of 32; and the gather route end to end.  The
batch-sharded pixel stage (parallel/sharding.compiled_batch_decoder) and
the engine on a two-shard mesh, each against one device: on one card
named twice, and on cuda:0 and cuda:1 (skipped below two cards: the
wrappers make each tensor's device current around its launch, which
only distinct cards can show).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpujpeg_torch.io.parser import parse_file
from tpujpeg_torch.ops import fsm, materialize, pixels, probes
from tpujpeg_torch.pipeline import Geometry, bucket_geometry

pytestmark = pytest.mark.gpu

CORPUS = os.path.join(os.path.dirname(__file__), "fixtures", "rst640")
PHOTO = os.path.join(os.path.dirname(__file__), "fixtures", "photo640")
MIXED = os.path.join(os.path.dirname(__file__), "fixtures", "mixed_rst")
RST420 = os.path.join(os.path.dirname(__file__), "fixtures", "rst640_420")
SMALL = os.path.join(os.path.dirname(__file__), "fixtures", "sampling_small")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def imgs():
    return [parse_file(os.path.join(CORPUS, f"{i:02d}.jpg")) for i in (0, 1)]


def _malformed(img):
    img.scan_data = img.scan_data.copy()
    img.scan_data[-img.scan_data.size // 3 :] = 0xFF
    return img


@pytest.mark.parametrize("malformed", [False, True])
@pytest.mark.parametrize("steps", [(1, 2), 1, 3])
def test_fsm_scan_kernel_equals_plain(cuda, imgs, steps, malformed):
    use = [imgs[0], _malformed(parse_file(os.path.join(CORPUS, "02.jpg")))] \
        if malformed else imgs
    plan = fsm.build_plan(use, split=False)
    xs = torch.as_tensor(plan.xs).to(cuda)
    sn = torch.as_tensor(plan.seg_n_blocks).to(cuda)
    got = fsm.fsm_scan(xs, sn, plan.tables, steps)
    want = fsm.fsm_scan_plain(xs, sn, plan.tables, fsm._scan_steps(steps))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    if malformed:
        assert bool(got[1].any())


def _random_events(rng, N, max_blk, L):
    """Per lane, distinct targets at ascending rows, a quarter of the
    slots filled; lane 1 holds only the event that packs to 0, lane 2
    only an event whose target is past M."""
    M = max_blk * 64
    ev = np.full((N, L), -1, np.int32)
    for lane in range(L):
        k = int(rng.binomial(N, 0.25))
        rows = np.sort(rng.choice(N, size=k, replace=False))
        targets = np.sort(rng.choice(M, size=k, replace=False))
        vals = rng.integers(-2048, 2048, k)
        blk, z = np.divmod(targets, 64)
        ev[rows, lane] = (blk << 18) | (z << 12) | (vals + 2048)
    ev[:, 1:3] = -1
    ev[0, 1] = 0                       # blk 0, z 0, val -2048 packs to 0
    ev[-1, 2] = (max_blk << 18) | 2048  # target past M: latches the lane
    return ev


@pytest.mark.parametrize("case", ["aligned", "ragged", "misaligned", "empty"])
def test_place_events_kernel_equals_plain(cuda, case):
    # aligned: four lanes per thread; ragged: a lane count that is no
    # multiple of 4 and a row count that is no multiple of the row tile
    # (one lane per thread); misaligned: a view 4 bytes off a 16-byte
    # boundary; empty: no event at all
    rng = np.random.default_rng(5)
    N, max_blk, L = {"aligned": (704, 47, 256), "ragged": (701, 47, 130),
                     "misaligned": (701, 47, 256),
                     "empty": (701, 47, 256)}[case]
    M = max_blk * 64
    ev = _random_events(rng, N, max_blk, L)
    if case == "empty":
        ev[:] = -1
    ev_d = torch.as_tensor(ev).to(cuda)
    if case == "misaligned":
        flat = torch.empty(N * L + 1, dtype=torch.int32, device=cuda)
        flat[1:] = ev_d.reshape(-1)
        ev_d = flat[1:].reshape(N, L)
        assert ev_d.data_ptr() % 16 == 4 and ev_d.is_contiguous()
    err_k = torch.zeros(L, dtype=torch.bool, device=cuda)
    err_p = torch.zeros(L, dtype=torch.bool, device=cuda)
    got = materialize.place_events(ev_d, M, err_k)
    want = materialize.place_events_plain(ev_d, M, err_p)
    torch.cuda.synchronize()
    assert got.dtype == torch.int16 and torch.equal(got, want)
    assert torch.equal(err_k, err_p)
    if case == "empty":
        assert not bool(got.any()) and not bool(err_k.any())
    else:
        assert int(got[0, 1]) == -2048 and bool(err_k[2])
        assert int(err_k.sum()) == 1
    # without a latch tensor the same rows come out
    assert torch.equal(materialize.place_events(ev_d, M), want)


def _pixels_equal(geom, coeffs, lanes, quant, dc=None, extents=None):
    """The pixel kernel == its plain version in both colour modes."""
    for exact in (False, True):
        args = (geom, coeffs, lanes, quant, dc, extents, exact)
        got = pixels.rgb_444(*args)
        want = pixels.rgb_444_plain(*args)
        torch.cuda.synchronize()
        assert got[0].dtype == torch.uint8 and torch.equal(got[0], want[0])
        assert (got[1] is None) == exact == (want[1] is None)
        if not exact:
            assert torch.equal(got[1], want[1])


def _quant(images, pad_to=None):
    q = np.stack([np.stack([im.quant_tables[c.quant_id]
                            for c in im.components]) for im in images])
    if pad_to:
        q = np.concatenate([q, np.repeat(q[:1], pad_to - len(q), 0)])
    return q.astype(np.int32)


@pytest.mark.parametrize("extreme", [False, True])
def test_pixels_kernel_equals_plain(cuda, imgs, extreme):
    # [B, n_blocks, 64]: the host decoder's coefficients with DC in row
    # 0, or random ones at the int limits (the int32 wraparound) with a DC
    # plane; both colour modes
    from tpujpeg_torch.runtime.host import entropy_decode

    geom = Geometry.of(imgs[0])
    coeffs = np.stack([entropy_decode(im) for im in imgs]).astype(np.int16)
    quant = _quant(imgs)
    dc = None
    if extreme:
        rng = np.random.default_rng(2)
        coeffs = rng.integers(-1023, 1024, coeffs.shape).astype(np.int16)
        coeffs[..., 0] = rng.integers(-2047, 2048, coeffs.shape[:2])
        quant = rng.integers(1, 256, quant.shape).astype(np.int32)
        dc = torch.as_tensor(
            rng.integers(-2047, 2048, coeffs.shape[:2]).astype(np.int32)
        ).to(cuda)
    lanes = pixels.block_lanes(len(imgs), geom.mcus_y, geom.mcus_x, cuda)
    _pixels_equal(geom, torch.as_tensor(coeffs).to(cuda), lanes,
                  torch.as_tensor(quant).to(cuda), dc)


@pytest.mark.parametrize("width", [61, 64, 200])
def test_pixels_kernel_equals_plain_on_ragged_rasters(cuda, width):
    # a width that is no multiple of 8 takes byte stores; a height that
    # crops the last MCU row; three images of random coefficients
    rng = np.random.default_rng(width)
    height = 45
    mx, my = -(-width // 8), -(-height // 8)
    geom = Geometry((width, height, mx, my, ((1, 1, 0), (1, 1, 1),
                                             (1, 1, 2))))
    coeffs = rng.integers(-300, 300, (3, mx * my * 3, 64)).astype(np.int16)
    quant = rng.integers(1, 40, (3, 3, 64)).astype(np.int32)
    lanes = pixels.block_lanes(3, my, mx, cuda)
    _pixels_equal(geom, torch.as_tensor(coeffs).to(cuda), lanes,
                  torch.as_tensor(quant).to(cuda))


def _lane_chunk(cuda, plan_imgs, bucket=None):
    """Scan, place and DC-resolve a chunk: (plan, dense lane matrix
    [max_blk*64, L], dc_lane [L, max_blk])."""
    plan = (fsm.build_plan(plan_imgs, split=False) if bucket is None
            else fsm.build_plan_bucketed(plan_imgs, bucket))
    xs = torch.as_tensor(plan.xs).to(cuda)
    if bucket is None:
        sn = torch.as_tensor(plan.seg_n_blocks).to(cuda)
        ev, _, _ = fsm.fsm_scan(xs, sn, plan.tables)
    else:
        sn, wrap, skip = (torch.as_tensor(a).to(cuda)
                          for a in (plan.seg_n, plan.wrap_at, plan.skip))
        ev, _, _ = fsm.fsm_scan(xs, sn, plan.tables, pad_info=(wrap, skip))
    L = xs.shape[0]
    dense = materialize.place_events(ev.reshape(-1, L), plan.max_blk * 64)
    per_lane = dense.T.reshape(L, plan.max_blk, 64)
    return plan, dense, fsm._dc_cumsum(per_lane[:, :, 0], plan.tables,
                                       plan.max_blk)


def test_pixels_kernel_equals_plain_on_the_lane_matrix(cuda, imgs):
    # the restart chunk's dense lane matrix read in place, two images and
    # one padding image; and the dense rows with DC in row 0 (raw DPCM
    # differences: the kernel and its plain version must agree anyway)
    from tpujpeg_torch.runtime import fused

    plan, dense, dc_lane = _lane_chunk(cuda, imgs)
    geom = Geometry.of(imgs[0])
    lanes = fused.restart_lanes(plan.layout, dense.shape[1], 3, geom.mcus_y,
                                geom.mcus_x, cuda)
    quant = torch.as_tensor(_quant(imgs, 3)).to(cuda)
    _pixels_equal(geom, dense, lanes, quant, dc_lane)
    _pixels_equal(geom, dense, lanes, quant)


def test_pixels_kernel_equals_plain_on_a_bucket_chunk(cuda):
    # bucket-raster lanes of mixed sizes, DC masked outside each image's
    # true extent, one padding image past the lanes
    from tpujpeg_torch.runtime import fused

    names = sorted(os.listdir(MIXED))
    mimgs = [parse_file(os.path.join(MIXED, names[i])) for i in (0, 5)]
    bucket = bucket_geometry(Geometry.of(mimgs[0]))
    assert bucket == bucket_geometry(Geometry.of(mimgs[1]))
    plan, dense, dc_lane = _lane_chunk(cuda, mimgs, bucket)
    ext = np.zeros((3, 2), np.int32)
    ext[:2] = plan.extents
    lanes = fused.bucket_lanes(dense.shape[1], 3, plan.lanes_per_img, plan.k,
                               bucket.mcus_y, bucket.mcus_x, cuda)
    _pixels_equal(bucket, dense, lanes,
                  torch.as_tensor(_quant(mimgs, 3)).to(cuda), dc_lane,
                  torch.as_tensor(ext).to(cuda))


def test_pixels_kernel_exact_colour_is_exhaustively_the_oracles(cuda):
    # chip_smoke.py's phase 7b: the kernel's exact mode and color_exact
    # (float64) on every triple of [-256, 255]^3 against the oracle
    assert pixels.exact_colour_mismatches(cuda) == (0, 0)


@pytest.fixture(scope="module")
def spec_plan():
    img = parse_file(os.path.join(PHOTO, "03.jpg"))
    return fsm.build_spec_plan_batch([img], 1024)


@pytest.mark.parametrize("mode", ["cold", "count", "entry", "stitch"])
def test_fsm_scan_spec_kernel_equals_plain(cuda, spec_plan, mode):
    plan = spec_plan
    L = plan.xs.shape[0]
    rng = np.random.default_rng(7)
    xs = torch.as_tensor(plan.xs).to(cuda)
    caps = torch.full((L,), plan.blk_cap, dtype=torch.int32, device=cuda)
    cb = torch.as_tensor(plan.chunk_bits).to(cuda)
    sb = torch.as_tensor(rng.integers(0, 3000, L).astype(np.int32)).to(cuda)
    sm = torch.as_tensor(rng.integers(0, 3, L).astype(np.int32)).to(cuda)
    kw = {"cold": dict(chunk_bits=cb, log_anchors=True),
          "count": dict(start_bits=sb, start_bim=sm, chunk_bits=cb,
                        emit=False),
          "entry": dict(start_bits=sb, start_bim=sm),
          "stitch": dict(start_bits=sb % 2048, start_bim=sm,
                         chunk_bits=torch.clamp(cb, max=2048))}[mode]
    if mode == "stitch":
        xs = xs[:, :640]   # a column prefix, read in place
    got = fsm.fsm_scan_spec(xs, caps, plan.tables, (1, 2), **kw)
    want = fsm.fsm_scan_spec_plain(xs, caps, plan.tables, 2, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(fsm.ScanOut._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w), name
    if mode == "cold":
        assert bool((got.anchors >= 0).any())


def _slot_events(rng, N, max_blk, L, mean_ev, heavy=()):
    """Per lane, blocks with ascending distinct zigzag positions at
    ascending rows (the scan's emission contract); `heavy` lanes stuff
    their first 8 blocks full."""
    ev = np.full((N, L), -1, np.int32)
    for lane in range(L):
        rows = []
        for b in range(max_blk):
            n = 64 if (lane in heavy and b < 8) else \
                min(64, int(rng.poisson(mean_ev)))
            for z in np.sort(rng.choice(64, n, replace=False)):
                rows.append((b << 18) | (int(z) << 12)
                            | int(rng.integers(0, 4096)))
        pos = np.sort(rng.choice(N, len(rows), replace=False))
        ev[pos, lane] = rows
    ev[0, 1] = 0   # blk 0, z 0, val -2048 packs to 0
    return ev


def _group_events(rng, g, n):
    """n packed events of slot group g (blocks 8g .. 8g+7, G = 8) at
    distinct ascending (blk, z), so every lane's targets are distinct."""
    idx = np.sort(rng.choice(512, n, replace=False))
    blk, z = 8 * g + idx // 64, idx % 64
    return (blk << 18) | (z << 12) | rng.integers(0, 4096, n)


def _slot_rows(rng, counts, Np):
    """Compacted rows (p int32, o int16) [Np, L] from counts[lane] = the
    event counts of the lane's consecutive groups 0, 1, ..."""
    L = len(counts)
    p = np.zeros((Np, L), np.int32)
    o = np.full((Np, L), -1, np.int16)
    for lane, cs in enumerate(counts):
        ev = np.concatenate([_group_events(rng, g, n)
                             for g, n in enumerate(cs)] + [np.zeros(0, int)])
        ev = ev[:Np]
        p[:len(ev), lane] = ev
        o[:len(ev), lane] = 0
    return p, o


def _prefix_counts(start, per_group=30):
    """Groups of per_group events that end at row `start`."""
    return [per_group] * (start // per_group) + \
        ([start % per_group] if start % per_group else [])


def _slot_case(case):
    """Edge inputs of slot_unpack / slot_expand: (p, o, C, M) on the CPU.
    The row-parallel unpack walks 32-lane tiles in chunks of 128 rows, a
    warp taking a slice of 16; the expand takes one row of 8 lanes a
    thread, in 16-row tiles of a 128-lane strip, and one lane a thread
    when L % 8 or a pointer is not 16-byte aligned."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "long_groups":
        # group 1 starts anywhere in rows 0-139 and holds 17 to 257
        # events: longer than a slice, than a chunk, C and C + 1
        counts = [_prefix_counts((lane * 5) % 140)
                  + [[17, 100, 129, 200, 255, 256, 257][lane % 7], 9]
                  for lane in range(70)]
        p, o = _slot_rows(rng, counts, 700)
        return p, o, 256, 8 * 512
    if case == "exact_C":
        # a group of exactly C (even lanes) or C + 1 (odd) events that
        # starts at rows 100-139, across the first chunk's end
        counts = [_prefix_counts(100 + lane) + [64 + (lane & 1), 5]
                  for lane in range(40)]
        p, o = _slot_rows(rng, counts, 400)
        return p, o, 64, 10 * 512
    if case == "fill_every_row":
        # every row holds an event: no hole ends the lanes
        counts = [[lane % 97 + 1] + [100] * 3 for lane in range(33)]
        Np = min(sum(c) for c in counts)
        p, o = _slot_rows(rng, counts, Np)
        return p, o, 128, 4 * 512
    if case == "hole":
        # o >= 0 rows after a hole stay -1, overflow after it is not set
        counts = [[40, 60, 300 if lane % 5 == 0 else 80, 70]
                  for lane in range(40)]
        p, o = _slot_rows(rng, counts, 600)
        holes = [0, 1, 15, 16, 17, 127, 128, 200] * 5
        holes[35] = 400                # after its group 2 overflowed
        for lane, h in enumerate(holes):
            o[h, lane] = -1
        return p, o, 256, 4 * 512
    if case == "empty_rows":
        return np.zeros((0, 33), np.int32), np.zeros((0, 33), np.int16), \
            64, 512
    if case == "empty_lanes":
        return np.zeros((50, 31), np.int32), np.full((50, 31), -1, np.int16), \
            64, 512
    if case.startswith("lanes"):
        L = int(case[5:])
        counts = [list(rng.integers(0, 70, 6)) for _ in range(L)]
        p, o = _slot_rows(rng, counts, 420)
        return p, o, 64, 6 * 512
    if case == "misaligned":
        counts = [list(rng.integers(0, 60, 5)) for _ in range(64)]
        p, o = _slot_rows(rng, counts, 300)
        return p, o, 64, 5 * 512
    if case == "targets_past_M":
        # M cuts the second group's rows: those targets are dropped
        counts = [[int(rng.integers(1, 100)), 150, 40] for _ in range(48)]
        p, o = _slot_rows(rng, counts, 300)
        return p, o, 256, 512 + 130
    if case == "overflow_in_prefix":
        # overflowed rows (-1) inside the live prefix, live rows after
        counts = [[30, 90 if lane % 3 else 20, 40] for lane in range(48)]
        p, o = _slot_rows(rng, counts, 200)
        return p, o, 64, 3 * 512
    if case == "zero_event":
        counts = [[5, 7] for _ in range(16)]
        p, o = _slot_rows(rng, counts, 20)
        p[0, 1] = 0                    # blk 0, z 0, val -2048 packs to 0
        return p, o, 64, 2 * 512
    raise ValueError(case)


SLOT_CASES = [64, 256, "long_groups", "exact_C", "fill_every_row", "hole",
              "empty_rows", "empty_lanes", "lanes1", "lanes7", "lanes8",
              "lanes9", "lanes31", "lanes33", "misaligned", "targets_past_M",
              "overflow_in_prefix", "zero_event"]


def _unaligned(t):
    """A contiguous copy of t whose data starts one element past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    view = flat[1:].reshape(t.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("case", SLOT_CASES)
def test_slot_kernels_equal_plain(cuda, case):
    if isinstance(case, int):
        C = case
        rng = np.random.default_rng(C)
        N, max_blk, L = 1500, 60, 160
        M = max_blk * 64
        ev = torch.as_tensor(_slot_events(rng, N, max_blk, L, 6,
                                          heavy=(5,))).to(cuda)
        p, o = materialize.compact_to_rank(ev)
        pw, ow = materialize.compact_to_rank_plain(ev)
        assert torch.equal(p, pw) and torch.equal(o, ow)
    else:
        p_h, o_h, C, M = _slot_case(case)
        p, o = torch.as_tensor(p_h).to(cuda), torch.as_tensor(o_h).to(cuda)
    o2, ovf = materialize.slot_unpack(p, o, C, 8)
    o2w, ovfw = materialize.slot_unpack_plain(p, o, C, 8)
    o2x, px = (_unaligned(o2), _unaligned(p)) if case == "misaligned" \
        else (o2, p)
    dense = materialize.slot_expand(o2x, px, M, C, 8)
    densew = materialize.slot_expand_plain(o2, p, M, C, 8)
    torch.cuda.synchronize()
    assert torch.equal(o2, o2w) and torch.equal(ovf, ovfw)
    assert dense.dtype == torch.int16 and torch.equal(dense, densew)
    lanes = torch.arange(o2.shape[1], device=cuda)
    if isinstance(case, int):
        assert bool(ovf[5])
        classic = materialize.place_events(ev, M)
        ok = ~ovf
        assert torch.equal(dense[:, ok], classic[:, ok])
        assert int(dense[0, 1]) == -2048
    elif case == "long_groups":
        assert torch.equal(ovf, lanes % 7 == 6)
    elif case == "exact_C":
        assert torch.equal(ovf, lanes % 2 == 1)
    elif case == "fill_every_row":
        assert bool((o >= 0).all()) and bool((o2[-1] >= 0).any())
    elif case == "hole":
        # lane 0's hole is row 0 (nothing is live), lane 5's row 127:
        # their 300-event groups do not overflow; lane 35's does, before
        # its hole
        assert torch.equal(ovf, lanes == 35)
        assert bool((o2[:, 0] == -1).all())
        assert bool((o[2:250, 1] >= 0).all()) and \
            bool((o2[1:, 1] == -1).all())
    elif case in ("empty_rows", "empty_lanes"):
        assert not bool(dense.any()) and not bool(ovf.any())
    elif case == "targets_past_M":
        row = torch.arange(o2.shape[0], device=cuda)[:, None]
        slot = row + o2.to(torch.int64)
        assert bool(((o2 >= 0) & (slot >= 2 * C)).any())   # group 2 rows
    elif case == "overflow_in_prefix":
        # lane 1: group 1 holds rows 30-119, so rows 94-119 overflow
        assert torch.equal(ovf, lanes % 3 != 0)
        assert bool((o2[94:120, 1] == -1).all())
        assert bool((o2[120:160, 1] >= 0).all())
    elif case == "zero_event":
        assert int(dense[0, 1]) == -2048


@pytest.mark.parametrize("malformed", [False, True])
@pytest.mark.parametrize("steps", [(1, 2), 3])
def test_fsm_scan_pad_kernel_equals_plain(cuda, steps, malformed):
    names = sorted(os.listdir(MIXED))[:3]
    use = [parse_file(os.path.join(MIXED, n)) for n in names]
    if malformed:
        use[1] = _malformed(use[1])
    bucket = bucket_geometry(Geometry.of(use[0]))
    plan = fsm.build_plan_bucketed(use, bucket)
    assert plan.skip.any() and len(set(plan.wrap_at[:303].tolist())) == 3
    xs = torch.as_tensor(plan.xs).to(cuda)
    sn = torch.as_tensor(plan.seg_n).to(cuda)
    # the plan's own counters (one MCU row per lane: a lane ends where its
    # row wraps), then rows cut in four with 7 padding slots after each,
    # so the counters wrap and skip inside every lane
    for wrap_at, skip in ((plan.wrap_at, plan.skip),
                          (np.maximum(plan.wrap_at // 4, 1),
                           np.full_like(plan.skip, 7))):
        pad = (torch.as_tensor(wrap_at).to(cuda),
               torch.as_tensor(skip).to(cuda))
        got = fsm.fsm_scan(xs, sn, plan.tables, steps, pad_info=pad)
        want = fsm.fsm_scan_plain(xs, sn, plan.tables,
                                  fsm._scan_steps(steps), pad_info=pad)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)
        assert bool(got[1].any()) == malformed
    # the second emission differs from the restart scan's in its block
    # fields only: quotas and latches count real blocks
    restart = fsm.fsm_scan(xs, sn, plan.tables, steps)
    assert not torch.equal(restart[0], got[0])
    assert torch.equal(restart[0] & 0x3FFFF, got[0] & 0x3FFFF)
    assert torch.equal(restart[1], got[1]) and torch.equal(restart[2], got[2])


@pytest.mark.parametrize("shape", [(1500, 60, 160), (300, 120, 130),
                                   (2100, 20, 33)])
def test_route_kernels_equal_plain(cuda, shape):
    # N > M, N < M, and a lane count that fills no warp or block evenly
    N, max_blk, L = shape
    rng = np.random.default_rng(N)
    M = max_blk * 64
    mean = min(6.0, 0.5 * N / max_blk)
    ev_h = _slot_events(rng, N, max_blk, L, mean)
    ev_h[:, 1:3] = -1
    ev_h[0, 1] = 0                         # blk 0, z 0, val -2048 packs to 0
    ev_h[-1, 2] = (max_blk << 18) | 2048   # target past M: latches lane 2
    ev = torch.as_tensor(ev_h).to(cuda)
    p0, o0 = materialize.compact_to_rank(ev, rank_kernel=False,
                                         stop_after="init")
    p, o = materialize.compact_offsets(p0, o0)
    pw, ow = materialize.compact_offsets_plain(p0, o0)
    cp = materialize.compact_full(ev)
    cpw = materialize.compact_full_plain(ev)
    errs = [torch.zeros(L, dtype=torch.bool, device=cuda) for _ in range(4)]
    d_o = materialize.spread_full(p, M, o=o, err_mal=errs[0])
    d_ow = materialize.spread_full_plain(p, M, o=o, err_mal=errs[1])
    d_c = materialize.spread_full(cp, M, err_mal=errs[2])
    d_cw = materialize.spread_full_plain(cp, M, err_mal=errs[3])
    torch.cuda.synchronize()
    assert torch.equal(p, pw) and torch.equal(o, ow)
    pk, ok = materialize.compact_to_rank(ev)
    assert torch.equal(p, pk) and torch.equal(o, ok)
    assert cp.dtype == torch.int32 and torch.equal(cp, cpw)
    assert torch.equal(d_o, d_ow) and torch.equal(d_c, d_cw)
    assert torch.equal(d_o, d_c)
    for e in errs[1:]:
        assert torch.equal(errs[0], e)
    assert bool(errs[0][2]) and int(errs[0].sum()) == 1
    classic = materialize.place_events(ev, M)
    assert torch.equal(d_c, classic)
    assert int(d_c[0, 1]) == -2048     # the event that packs to 0
    for route in ("ranked", "full"):
        assert torch.equal(fsm.materialize_events(ev, M, route), classic)


def _compact_case(case):
    """Edge inputs of the two rank-in-kernel compactions (one body: a
    32-lane tile walked by 8 warps in 128-row chunks of 16-row slices,
    the rows after each lane's events written by the kernel): ev int32
    [N, L] on the CPU."""
    rng = np.random.default_rng(sum(map(ord, case)))
    N, L = 700, 96
    if case.startswith("rows"):
        N, L = int(case[4:]), 64
    elif case.startswith("lanes"):
        N, L = 300, int(case[5:])
    elif case == "no_rows":
        N, L = 0, 33
    elif case == "no_lanes":
        N, L = 50, 0
    ev = rng.integers(0, 2 ** 31 - 1, (N, L), dtype=np.int32)
    ev[rng.random((N, L)) < 0.6] = -1
    if case == "full_lane":
        ev[:, 5] = rng.integers(0, 2 ** 31 - 1, N)     # no row after
        ev[:, 40:72] = rng.integers(0, 2 ** 31 - 1, (N, 32))
    elif case == "empty_lane":
        ev[:, 5] = -1                                  # all rows after
        ev[:, 64:96] = -1
    elif case == "last_row":
        ev[:] = -1
        ev[N - 1, ::3] = rng.integers(0, 2 ** 31 - 1, len(ev[0, ::3]))
    elif case == "negatives":
        neg = ev < 0
        ev[neg] = rng.integers(-2 ** 31, 0, int(neg.sum()), dtype=np.int32)
        ev[0, :4] = [-2, -2048, -(2 ** 31), -1]
    elif case == "zero_event":
        ev[0, 1] = 0                   # blk 0, z 0, val -2048 packs to 0
        ev[N - 1, 2] = 0
        ev[:, 3] = 0
    return ev


COMPACT_CASES = ["full_lane", "empty_lane", "last_row", "negatives",
                 "zero_event", "rows1", "rows15", "rows127", "rows128",
                 "rows129", "rows1500", "lanes1", "lanes31", "lanes33",
                 "lanes160", "no_rows", "no_lanes", "unaligned"]


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_compact_kernels_equal_plain(cuda, case):
    from tpujpeg_torch.runtime import kernels

    ev = torch.as_tensor(_compact_case(case)).to(cuda)
    if case == "unaligned":
        ev = _unaligned(ev)            # 4 bytes past a 16-byte boundary
        assert ev.data_ptr() % 16 == 4
    before = {k: kernels.LAUNCHES[k] for k in ("compact", "compact_full")}
    p, o = materialize.compact_to_rank(ev)
    cp = materialize.compact_full(ev)
    torch.cuda.synchronize()
    pw, ow = materialize.compact_to_rank_plain(ev)
    cpw = materialize.compact_full_plain(ev)
    assert p.dtype == torch.int32 and o.dtype == torch.int16
    assert p.shape == o.shape == cp.shape == ev.shape
    assert torch.equal(p, pw) and torch.equal(o, ow)
    assert torch.equal(cp, cpw)
    launched = 0 if ev.numel() == 0 else 1
    for k in before:
        assert kernels.LAUNCHES[k] - before[k] == launched
    n = (ev >= 0).sum(0)
    assert torch.equal((o >= 0).sum(0), n) and torch.equal((cp >= 0).sum(0), n)
    if case == "full_lane":
        assert bool((o[:, 5] == 0).all()) and bool((cp[:, 5] >= 0).all())
    elif case == "empty_lane":
        assert bool((o[:, 5] == -1).all()) and bool((cp[:, 5] == -1).all())
    elif case == "last_row":
        assert torch.equal(cp[0, ::3], ev[-1, ::3])
    elif case == "zero_event":
        assert int(cp[0, 1]) == 0 and int(o[0, 1]) == 0
        assert bool((o[:, 3] == 0).all())


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_compact_offsets_walk_equals_plain_and_compact(cuda, case):
    # mask -1 runs the walk of compact.cuh on (p, o) from the column cumsum
    from tpujpeg_torch.runtime import kernels

    ev = torch.as_tensor(_compact_case(case)).to(cuda)
    p0, o0 = materialize.compact_to_rank(ev, rank_kernel=False,
                                         stop_after="init")
    if case == "unaligned":
        p0, o0 = _unaligned(p0), _unaligned(o0)
        assert o0.data_ptr() % 8 != 0
    before = kernels.LAUNCHES["compact_offsets"]
    p, o = materialize.compact_offsets(p0, o0)
    torch.cuda.synchronize()
    launched = 0 if ev.numel() == 0 else 1
    assert kernels.LAUNCHES["compact_offsets"] - before == launched
    pw, ow = materialize.compact_offsets_plain(p0, o0)
    assert p.dtype == torch.int32 and o.dtype == torch.int16
    assert torch.equal(p, pw) and torch.equal(o, ow)
    pk, ok = materialize.compact_to_rank(ev)
    assert torch.equal(p, pk) and torch.equal(o, ok)
    # and through the ranked route's own call
    pr, orr = materialize.compact_to_rank(ev, rank_kernel=False)
    assert torch.equal(pr, pw) and torch.equal(orr, ow)


def _spread_case(case):
    """_compact_case's events with distinct targets per lane (target =
    row: blk = row >> 6, z = row & 63, the value kept), so a scatter's
    result does not depend on its store order; M = 512 rows, so the
    taller cases latch lanes."""
    ev = _compact_case(case)
    rows = np.arange(ev.shape[0], dtype=np.int32)[:, None]
    return np.where(ev >= 0, (rows << 12) | (ev & 0xFFF), ev), 512


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_spread_full_kernel_equals_plain(cuda, case):
    # with and without offsets, on compacted and uncompacted events; the
    # lane counts that are no multiple of 4 and the unaligned views take
    # one lane per thread
    ev_h, M = _spread_case(case)
    ev = torch.as_tensor(ev_h).to(cuda)
    N, L = ev.shape
    cp = materialize.compact_full(ev)
    p, o = materialize.compact_to_rank(ev, rank_kernel=False)
    if case == "unaligned":
        cp, p, o = _unaligned(cp), _unaligned(p), _unaligned(o)
        assert cp.data_ptr() % 16 != 0 and o.data_ptr() % 8 != 0
    want = materialize.place_events_plain(ev, M)
    err_want = torch.zeros(L, dtype=torch.bool, device=cuda)
    materialize.place_events_plain(ev, M, err_want)
    for x, off in ((cp, None), (p, o), (ev, None)):
        errs = [torch.zeros(L, dtype=torch.bool, device=cuda)
                for _ in range(2)]
        got = materialize.spread_full(x, M, o=off, err_mal=errs[0])
        plain = materialize.spread_full_plain(x, M, o=off, err_mal=errs[1])
        torch.cuda.synchronize()
        assert got.dtype == torch.int16 and tuple(got.shape) == (M, L)
        assert torch.equal(got, plain) and torch.equal(errs[0], errs[1])
        assert torch.equal(got, want) and torch.equal(errs[0], err_want)
        assert torch.equal(materialize.spread_full(x, M, o=off), want)
    if N > M and L:
        assert bool(err_want.any())


def test_spread_full_takes_more_event_rows_than_a_grid_column(cuda):
    # rows sit on gridDim.x: 70,000 event rows, one lane a thread (33
    # lanes) and four (36 lanes), with and without offsets
    rng = np.random.default_rng(70000)
    N, M = 70000, 64 * 1100
    for L in (33, 36):
        ev_h = np.full((N, L), -1, np.int32)
        keep = rng.random((N, L)) < 0.3
        rows = np.broadcast_to(np.arange(N, dtype=np.int32)[:, None], (N, L))
        vals = rng.integers(0, 4096, (N, L), dtype=np.int32)
        ev_h[keep] = ((rows << 12) | vals)[keep]
        ev_h[N - 1, :] = (1099 << 18) | (63 << 12) | 5   # the last row
        ev = torch.as_tensor(ev_h).to(cuda)
        o = torch.where(ev >= 0, 0, -1).to(torch.int16)
        want = materialize.place_events_plain(ev, M)
        for off in (None, o):
            got = materialize.spread_full(ev, M, o=off)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert torch.equal(got,
                               materialize.spread_full_plain(ev, M, o=off))
        assert bool((want[1099 * 64 + 63] == 5 - 2048).all())


def test_spread_full_with_offsets_skips_rows_whose_offset_is_negative(cuda):
    # on the ranked route p is 0 on empty rows and o decides: a row with
    # o < 0 neither stores (p = 0 would decode to target 0) nor latches
    # (a p whose target is past M); four lanes a thread, then one
    L, N, M = 8, 12, 4 * 64
    p = torch.zeros((N, L), dtype=torch.int32)
    o = torch.full((N, L), -1, dtype=torch.int16)
    p[0, 3] = (2 << 18) | (5 << 12) | (2048 + 7)   # valid: row 133 gets 7
    o[0, 3] = 0
    p[1, 3] = 4 << 18                              # o < 0, target past M
    p[2, 5] = 4 << 18                              # valid, target past M
    o[2, 5] = 0
    for lanes in (L, L - 1):
        pc = p[:, :lanes].contiguous().to(cuda)
        oc = o[:, :lanes].contiguous().to(cuda)
        errs = [torch.zeros(lanes, dtype=torch.bool, device=cuda)
                for _ in range(2)]
        got = materialize.spread_full(pc, M, o=oc, err_mal=errs[0])
        plain = materialize.spread_full_plain(pc, M, o=oc, err_mal=errs[1])
        torch.cuda.synchronize()
        assert torch.equal(got, plain) and torch.equal(errs[0], errs[1])
        assert int(got[2 * 64 + 5, 3]) == 7 and int(got.abs().sum()) == 7
        assert int(got[0].abs().sum()) == 0
        assert errs[0].nonzero().flatten().tolist() == [5]


@pytest.mark.parametrize("steps", [(1, 2), 3])
@pytest.mark.parametrize("corpus", ["420", "gray", "411"])
def test_fsm_scan_kernel_equals_plain_by_blocks_per_mcu(cuda, corpus, steps):
    # 6 blocks per MCU on two table sets, 1 block on one set (the second
    # set's LUT planes are never selected), 6 blocks with a 4-wide luma
    path = {"420": os.path.join(RST420, "03.jpg"),
            "gray": os.path.join(SMALL, "gray_rst.jpg"),
            "411": os.path.join(SMALL, "411_rst.jpg")}[corpus]
    img = parse_file(path)
    assert img.blocks_per_mcu == {"420": 6, "gray": 1, "411": 6}[corpus]
    plan = fsm.build_plan([img], split=False)
    xs = torch.as_tensor(plan.xs).to(cuda)
    sn = torch.as_tensor(plan.seg_n_blocks).to(cuda)
    got = fsm.fsm_scan(xs, sn, plan.tables, steps)
    want = fsm.fsm_scan_plain(xs, sn, plan.tables, fsm._scan_steps(steps))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    assert not bool(got[1].any())
    # and through materialize and the DC resolve: the host decoder's
    # coefficients
    from tpujpeg_torch.runtime import fused
    from tpujpeg_torch.runtime.host import entropy_decode

    if not bool(got[2].any()):
        L = xs.shape[0]
        dense = materialize.place_events(got[0].reshape(-1, L),
                                         plan.max_blk * 64)
        per_lane = dense.T.reshape(L, plan.max_blk, 64)
        dc = fsm._dc_cumsum(per_lane[:, :, 0], plan.tables, plan.max_blk)
        coeffs = fused._assemble_rows(per_lane, plan.layout, 1)[0] \
            .to(torch.int32)
        coeffs[:, 0] = fused._assemble_rows(dc, plan.layout, 1)[0]
        assert np.array_equal(coeffs.cpu().numpy(), entropy_decode(img))


def _at_offset(a, offset: int, device):
    """int32 tensor on `device` equal to numpy array a whose data starts
    `offset` bytes past a 16-byte boundary of its storage."""
    e = offset // 4
    flat = torch.empty(a.size + e, dtype=torch.int32, device=device)
    view = flat[e:].view(a.shape)
    view.copy_(torch.as_tensor(a))
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    return view


# ("rows", R, T, K, index offset in bytes) / ("table", T, N, offset): K
# around the 4-lookup vector, more rows than the grid holds (16,384 rows
# a warp each, 1,057 rows a block each), T on both sides of the
# warp-per-row limit (1,536) and at the shared-memory limit, N around the
# vector and past L2, index views 4, 8 and 12 bytes into their storage,
# nothing to do, and the refusal of a table past shared memory
GATHER_CASES = (
    [("rows", 133, 256, K, 0) for K in (1, 3, 4, 5, 1023, 1025)]
    + [("rows", R, 256, 1024, 0) for R in (1, 133, 1057, 16384)]
    + [("rows", 133, T, 1025, 0) for T in (1, 256, 1536, 1537, 12288)]
    + [("rows", 133, 256, 1023, off) for off in (4, 8, 12)]
    + [("rows", 133, 1537, 1023, 4), ("rows", 1057, 1537, 100, 0),
       ("rows", 0, 256, 4, 0), ("rows", 133, 256, 0, 0)]
    + [("table", 256, N, 0) for N in (1, 3, 5, 1 << 18, 1 << 25)]
    + [("table", T, 400_000, 0) for T in (1, 12288)]
    + [("table", 256, 262147, off) for off in (4, 8, 12)]
    + [("table", 256, 0, 0), ("too_big",)]
)


@pytest.mark.parametrize("case", GATHER_CASES, ids=str)
def test_gather_kernels_equal_plain(cuda, case):
    from tpujpeg_torch.runtime import kernels

    rng = np.random.default_rng(11)
    if case[0] == "too_big":
        big = torch.zeros((2, 12289), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="shared memory"):
            probes.gather_rows(big, torch.zeros((2, 4), dtype=torch.int32,
                                                device=cuda))
        with pytest.raises(ValueError, match="shared memory"):
            probes.gather_table(big[0].contiguous(),
                                torch.zeros(4, dtype=torch.int32,
                                            device=cuda))
        return
    if case[0] == "rows":
        _, R, T, K, off = case
        t = torch.as_tensor(rng.integers(-9, 255, (R, T)).astype(np.int32)) \
            .to(cuda)
        i = _at_offset(rng.integers(0, T, (R, K)).astype(np.int32), off,
                       cuda)
        kernel, plain = probes.gather_rows, probes.gather_rows_plain
    else:
        _, T, N, off = case
        t = torch.as_tensor(rng.integers(-9, 255, T).astype(np.int32)) \
            .to(cuda)
        i = _at_offset(rng.integers(0, T, N).astype(np.int32), off, cuda)
        kernel, plain = probes.gather_table, probes.gather_table_plain
    name = "gather_" + case[0]
    before = kernels.LAUNCHES[name]
    got = kernel(t, i)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == i.shape
    assert torch.equal(got, plain(t, i))
    # one launch, none on an empty input
    assert kernels.LAUNCHES[name] - before == (1 if got.numel() else 0)


@pytest.mark.parametrize("source", ["l2", "shared", "readonly"])
def test_chain_kernel_equals_plain(cuda, source):
    rng = np.random.default_rng(12)
    tbl = torch.as_tensor(
        rng.integers(0, 4096, (4096, 1)).astype(np.int32)).to(cuda)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    for steps in (0, 1, 4096, 20000):
        got = probes.chain(tbl, seed, steps, source)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32
        assert torch.equal(got, probes.chain_plain(tbl, seed, steps))


@pytest.mark.parametrize("W", [128, 1024])
def test_compact_offsets_mask_and_probe_stages_equal_plain(cuda, W):
    rng = np.random.default_rng(W)
    N, max_blk, L = 2100, 40, 160
    M = max_blk * 64
    ev = torch.as_tensor(_slot_events(rng, N, max_blk, L, 6)).to(cuda)
    p0, o0 = probes.offsets_init(ev)
    assert int(o0.max()) > W
    fine = probes.compact_fine(p0, o0, W)
    staged = probes.compact_staged(p0, o0, W)
    whole = materialize.compact_offsets(p0, o0)
    coarse = materialize.compact_offsets(*fine, mask=~(W - 1))
    # the walk (mask -1) on compact_fine's residual offsets: o = row - rank
    # still holds on the rows the fine stage moved to
    rest = materialize.compact_offsets(*fine)
    dense = probes.spread_ranked(*staged, M)
    torch.cuda.synchronize()
    for got, want in ((fine, probes.compact_fine_plain(p0, o0, W)),
                      (staged, probes.compact_staged_plain(p0, o0, W)),
                      (staged, whole), (coarse, whole), (rest, whole),
                      (rest, materialize.compact_offsets_plain(*fine)),
                      (whole, materialize.compact_offsets_plain(p0, o0))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(fine[0], whole[0])
    assert torch.equal(dense, probes.spread_ranked_plain(*staged, M))
    assert torch.equal(dense, materialize.place_events(ev, M))
    assert int(dense[0, 1]) == -2048     # the event that packs to 0


def _masked_case(case):
    """(events int32 [N, L], W) for compact.cuh's masked walk: lane counts
    that are no multiple of 32 or 4; a lane that leads (every row an
    event), one far behind it (10 events, then rows from 5,000 with an
    offset of 4,990: its destinations lag the lead by 4,990 rows), one
    that jumps ahead by ~7,000 rows after a long gap, and a lone event
    far down; Np at and just below the int16 span; the event that packs
    to 0."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("lanes"):
        L = int(case[5:])
        ev = rng.integers(0, 2 ** 31 - 1, (2600, L), dtype=np.int32)
        ev[rng.random((2600, L)) < rng.random(L) ** 2] = -1
        return ev, 1024
    if case.startswith("far"):
        N, L = 9000, 40
        ev = np.full((N, L), -1, np.int32)
        ev[:, 0] = 7
        ev[:10, 1] = 3
        ev[5000:, 1] = 9
        ev[::3, 2] = 5
        ev[8000, 3] = 11
        ev[2, 4] = 1
        ev[7000:7100, 4] = 2
        ev[:, 8:] = np.where(rng.random((N, L - 8)) < 0.3, 13, -1)
        return ev, int(case[3:])
    if case.startswith("rows"):
        N, L = int(case[4:]), 36
        ev = rng.integers(0, 2 ** 31 - 1, (N, L), dtype=np.int32)
        ev[rng.random((N, L)) < 0.7] = -1
        ev[:, 5] = -1
        ev[N - 1, 5] = 17                  # offset N - 1 = 32,767 at most
        return ev, 1024
    assert case == "zero_event"
    ev = rng.integers(0, 2 ** 31 - 1, (700, 70), dtype=np.int32)
    ev[rng.random((700, 70)) < 0.6] = -1
    ev[0, 1] = 0
    ev[699, 2] = 0
    ev[:, 3] = 0
    ev[300, 4] = 0
    return ev, 128


MASKED_CASES = ["lanes1", "lanes7", "lanes33", "lanes61", "far1024",
                "far8192", "rows32765", "rows32768", "zero_event"]


@pytest.mark.parametrize("case", MASKED_CASES)
def test_masked_walk_equals_plain(cuda, case):
    # compact_offsets with a low-bit mask: compact.cuh's walk whose window
    # follows the destinations it reads; every element written by the
    # kernel (the outputs start as garbage), direct stores only past a
    # window of min(W + 127, 576) rows, and the coarse call on its output
    # is the ranked walk
    from tpujpeg_torch.runtime import kernels

    ev_h, W = _masked_case(case)
    ev = torch.as_tensor(ev_h).to(cuda)
    p0, o0 = probes.offsets_init(ev)
    direct = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = kernels.LAUNCHES["compact_offsets"]
    torch.cuda.empty_cache()
    junk = torch.full((p0.numel() * 6,), 0x5A, dtype=torch.uint8,
                      device=cuda)
    del junk                           # the next allocations reuse it
    fine = materialize.compact_offsets(p0, o0, mask=W - 1, direct=direct)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["compact_offsets"] - before == 1
    want = materialize.compact_offsets_plain(p0, o0, mask=W - 1)
    assert torch.equal(fine[0], want[0]) and torch.equal(fine[1], want[1])
    assert torch.equal(probes.compact_fine(p0, o0, W)[1], want[1])
    n_direct = int(direct[0])
    if W + 127 <= 576:                 # the window holds every lag
        assert n_direct == 0
    elif case.startswith("far"):
        assert n_direct > 0            # lane 1 lags by more than the ring
    whole = materialize.compact_offsets(p0, o0)
    coarse = materialize.compact_offsets(*fine, mask=~(W - 1))
    torch.cuda.synchronize()
    assert torch.equal(coarse[0], whole[0]) and torch.equal(coarse[1], whole[1])
    assert torch.equal(whole[0], materialize.compact_offsets_plain(p0, o0)[0])
    if case == "zero_event":
        assert int(fine[0][0, 1]) == 0 and int(fine[1][0, 1]) == 0
        assert bool((whole[1][:, 3] == 0).all())
    if case.startswith("rows"):
        assert int(o0.max()) == ev.shape[0] - 1


@pytest.mark.parametrize("mask", [-1, 0, 1, 1023, ~1023, 2 ** 31 - 1,
                                  -2 ** 31])
def test_compact_offsets_takes_every_mask_it_has_a_walk_for_on_the_card(
        cuda, mask):
    # each mask the wrapper takes, on offsets that meet its precondition,
    # equals the plain version; a complement mask on offsets that are no
    # multiple of W is not checked by the kernel: the plain version
    # refuses it, and the kernel returns mask -1's result (documented in
    # compact_offsets)
    ev = torch.as_tensor(_masked_case("lanes33")[0]).to(cuda)
    p0, o0 = probes.offsets_init(ev)
    whole = materialize.compact_offsets(p0, o0)
    if mask >= -1:
        pairs = [(materialize.compact_offsets(p0, o0, mask=mask),
                  materialize.compact_offsets_plain(p0, o0, mask=mask))]
    else:
        fine = materialize.compact_offsets(p0, o0, mask=~mask)
        pairs = [(materialize.compact_offsets(*fine, mask=mask),
                  materialize.compact_offsets_plain(*fine, mask=mask)),
                 (materialize.compact_offsets(p0, o0, mask=mask), whole)]
        with pytest.raises(ValueError, match="no multiple of"):
            materialize.compact_offsets_plain(p0, o0, mask=mask)
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_compact_offsets_rejects_a_mask_it_has_no_walk_for_on_the_card(
        cuda):
    ev = torch.as_tensor(_masked_case("lanes7")[0]).to(cuda)
    p0, o0 = probes.offsets_init(ev)
    for mask in (2, 5, ~2):
        with pytest.raises(ValueError, match="mask"):
            materialize.compact_offsets(p0, o0, mask=mask)


@pytest.mark.parametrize("source", ["l2", "shared", "readonly"])
def test_chain_kernel_on_odd_tables_and_no_steps(cuda, source):
    # the step by its reciprocal (T no power of two), T = 1 (the mask of
    # 0) and a walk of no steps
    rng = np.random.default_rng(13)
    seed = torch.tensor([0], dtype=torch.int32, device=cuda)
    for T in (1, 3, 4093, 12287, 100003):
        if source == "shared" and T > probes.MAX_SHARED_TABLE:
            continue
        tbl = torch.as_tensor(
            rng.integers(0, 2 ** 28, T).astype(np.int32)).to(cuda)
        for steps in (0, 1, 5000):
            got = probes.chain(tbl, seed, steps, source)
            torch.cuda.synchronize()
            assert torch.equal(got, probes.chain_plain(tbl, seed, steps)), \
                (T, steps)


def _scan_equal(got, want):
    for name, g, w in zip(fsm.ScanOut._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(g, w), name


@pytest.mark.parametrize("steps", [(1, 2), 3])
def test_fsm_scan_warps_that_finish_early_or_hold_one_lane(cuda, imgs, steps):
    plan = fsm.build_plan(imgs[:1], split=False)
    L, stride = plan.xs.shape
    assert L == 128 and 32 < int((plan.seg_n_blocks > 0).sum()) <= 96
    # twice the stride: every lane is done long before the last column,
    # and the last warp holds quota-0 lanes only
    xs = torch.zeros((L, 2 * stride), dtype=torch.uint8, device=cuda)
    xs[:, :stride] = torch.as_tensor(plan.xs).to(cuda)
    sn = torch.as_tensor(plan.seg_n_blocks).to(cuda)
    k = fsm._scan_steps(steps)
    got = fsm.fsm_scan(xs, sn, plan.tables, steps)
    want = fsm.fsm_scan_plain(xs, sn, plan.tables, k)
    torch.cuda.synchronize()
    _scan_equal(got, want)
    assert not bool(got[1].any() | got[2].any())
    # one long lane among empty ones: the warp walks on for it alone
    one = torch.zeros_like(sn)
    one[5] = sn[5]
    one[70] = sn[38]
    xs1 = xs.clone()
    xs1[70] = xs[38]
    got = fsm.fsm_scan(xs1, one, plan.tables, steps)
    want = fsm.fsm_scan_plain(xs1, one, plan.tables, k)
    torch.cuda.synchronize()
    _scan_equal(got, want)
    assert int((got[0] >= 0).any(dim=0).any(dim=0).sum()) == 2


@pytest.mark.parametrize("view", ["prefix", "prefix_ragged", "offset4"])
def test_fsm_scan_reads_column_views_in_place(cuda, imgs, view):
    # pitch > n_data; a width that is no multiple of 4; a row start that
    # is 4-byte but not 16-byte aligned (the staging's 4-byte copies)
    plan = fsm.build_plan(imgs, split=False)
    full = torch.as_tensor(plan.xs).to(cuda)
    sn = torch.as_tensor(plan.seg_n_blocks).to(cuda)
    xs = {"prefix": full[:, :1280], "prefix_ragged": full[:, :1107],
          "offset4": full[:, 4:1284]}[view]
    assert xs.stride(0) > xs.shape[1]
    assert (xs.data_ptr() % 16 == 4) == (view == "offset4")
    got = fsm.fsm_scan(xs, sn, plan.tables, (1, 2))
    want = fsm.fsm_scan_plain(xs, sn, plan.tables, 2)
    torch.cuda.synchronize()
    _scan_equal(got, want)
    # the cut rows are truncated streams: they latch, as in the plain scan
    assert bool(got[1].any())
    cb = torch.full_like(sn, 8 * 900)
    spec = fsm.fsm_scan_spec(xs, sn, plan.tables, (1, 2), chunk_bits=cb,
                             emit=False)
    torch.cuda.synchronize()
    _scan_equal(spec, fsm.fsm_scan_spec_plain(xs, sn, plan.tables, 2,
                                              chunk_bits=cb, emit=False))
    assert spec.events is None and bool((spec.end_bits >= 8 * 900).any())


@pytest.mark.parametrize("quota", [4, 12])
def test_fsm_scan_anchor_mode_recovery_marker_where_the_lane_finishes(
        cuda, spec_plan, quota):
    # one step per byte on a dense stream: the buffer overflows at the
    # refill again and again, each recovery's marker waits for the next
    # step slot, and some lanes end their quota in just that slot
    plan = spec_plan
    L = plan.xs.shape[0]
    xs = torch.as_tensor(plan.xs).to(cuda)[:, :256]
    sn = torch.full((L,), quota, dtype=torch.int32, device=cuda)
    got = fsm.fsm_scan_spec(xs, sn, plan.tables, 1, log_anchors=True)
    want = fsm.fsm_scan_spec_plain(xs, sn, plan.tables, 1, log_anchors=True)
    torch.cuda.synchronize()
    _scan_equal(got, want)
    anc, rm = got.anchors.reshape(-1, L), got.recm.reshape(-1, L)
    slot = torch.arange(anc.shape[0], device=cuda)[:, None]
    last = torch.where(anc >= 0, slot, -1).amax(dim=0)
    at_finish = ((rm >= 0) & (slot == last[None, :])).any(dim=0)
    assert bool((at_finish & (got.blk == quota)).any())
    # every slot after a lane's last anchor or marker keeps the fill
    assert bool((got.ablk.reshape(-1, L)[anc < 0] == 0).all())


def _long_code_tables():
    """Two table sets whose 176 AC codes all have 11 bits (88 second-level
    tables apiece), the DC codes 4 bits; the second set lists its AC
    symbols in reverse."""
    from tpujpeg_torch.io.huffman import HuffmanTable
    from tpujpeg_torch.io.parser import Component, JpegImage

    ac = [r << 4 | s for r in range(16) for s in range(11)]
    counts = np.zeros(16, np.int64)
    counts[10] = len(ac)
    dc_counts = np.zeros(16, np.int64)
    dc_counts[3] = 12
    huffman, symbols = {}, []
    for tid in (0, 1):
        syms = ac[::-1] if tid else ac
        huffman[tid] = HuffmanTable(dc_counts, np.arange(12, dtype=np.uint8))
        huffman[0x10 | tid] = HuffmanTable(counts, np.asarray(syms, np.uint8))
        symbols.append(syms)
    img = JpegImage(
        width=16, height=16, precision=8,
        components=[Component(1, 1, 1, 0, 0, 0), Component(2, 1, 1, 1, 1, 1),
                    Component(3, 1, 1, 1, 1, 1)],
        quant_tables={}, huffman=huffman, restart_interval=0,
        scan_data=np.zeros(0, np.uint8), segment_offsets=np.zeros(1, np.int64))
    return fsm.build_tables(img), symbols


def _encode_lane(rng, tables, symbols, n_blocks: int, n_bytes: int):
    """A valid stream of n_blocks blocks under `_long_code_tables`: per
    block a DC code, a few AC codes with short runs, and an EOB."""
    fields = []   # (value, bits), most significant first
    for b in range(n_blocks):
        ac = symbols[tables.tsel[b % len(tables.tsel)]]
        size = int(rng.integers(0, 12))
        fields += [(size, 4), (int(rng.integers(0, 1 << size)), size)]
        k = 1
        for _ in range(int(rng.integers(0, 10))):
            run, size = int(rng.integers(0, 3)), int(rng.integers(1, 11))
            if k + run > 63:
                break
            fields += [(ac.index(run << 4 | size), 11),
                       (int(rng.integers(0, 1 << size)), size)]
            k += run + 1
        fields.append((ac.index(0), 11))
    bits = "".join(format(v, f"0{n}b") for v, n in fields if n)
    assert len(bits) <= 8 * n_bytes
    bits += "1" * (8 * n_bytes - len(bits))
    return np.frombuffer(int(bits, 2).to_bytes(n_bytes, "big"), np.uint8)


def test_fsm_scan_with_tables_past_48_kb_of_shared_memory(cuda):
    # the packed tables outgrow the 48 KB a kernel gets without asking
    tables, symbols = _long_code_tables()
    assert fsm.scan_table(tables).nbytes > 48 * 1024
    rng = np.random.default_rng(21)
    L, n_blocks, n = 160, 9, 256
    xs = torch.as_tensor(np.stack([
        _encode_lane(rng, tables, symbols, n_blocks, n) for _ in range(L)
    ])).to(cuda)
    sn = torch.full((L,), n_blocks, dtype=torch.int32, device=cuda)
    got = fsm.fsm_scan(xs, sn, tables, (1, 2))
    want = fsm.fsm_scan_plain(xs, sn, tables, 2)
    torch.cuda.synchronize()
    _scan_equal(got, want)
    assert not bool(got[1].any() | got[2].any())
    assert int((got[0] >= 0).sum()) > 4000
    cold = fsm.fsm_scan_spec(xs, sn, tables, (1, 2), log_anchors=True)
    torch.cuda.synchronize()
    _scan_equal(cold, fsm.fsm_scan_spec_plain(xs, sn, tables, 2,
                                              log_anchors=True))


# ---------------------------------------------------------------------------
# multi-byte scan columns; the segment decoder and the gather route
# ---------------------------------------------------------------------------

MULTI_BYTE = [(2, 3), (2, 4), (4, 7)]


@pytest.mark.parametrize("view", ["full", "prefix_ragged"])
@pytest.mark.parametrize("steps", MULTI_BYTE)
def test_fsm_scan_multi_byte_kernel_equals_plain(cuda, imgs, steps, view):
    # a malformed lane among good ones; the ragged prefix (1,107 bytes, no
    # whole number of 2- or 4-byte columns) refills its pad bytes as zeros
    use = [imgs[0], _malformed(parse_file(os.path.join(CORPUS, "02.jpg")))]
    plan = fsm.build_plan(use, split=False)
    full = torch.as_tensor(plan.xs).to(cuda)
    sn = torch.as_tensor(plan.seg_n_blocks).to(cuda)
    xs = full if view == "full" else full[:, :1107]
    got = fsm.fsm_scan(xs, sn, plan.tables, steps)
    want = fsm.fsm_scan_plain(xs.cpu(), sn.cpu(), plan.tables, steps)
    torch.cuda.synchronize()
    assert got[0].shape == (-(-xs.shape[1] // steps[0]) + fsm.FLUSH_COLS,
                            steps[1], xs.shape[0])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert bool(got[1].any())


@pytest.mark.parametrize("steps", MULTI_BYTE)
def test_fsm_scan_pad_multi_byte_kernel_equals_plain(cuda, steps):
    names = sorted(os.listdir(MIXED))[:2]
    use = [parse_file(os.path.join(MIXED, n)) for n in names]
    plan = fsm.build_plan_bucketed(use, bucket_geometry(Geometry.of(use[0])))
    # rows cut in four with 7 padding slots after each: the counters wrap
    # and skip inside every lane
    pad = (torch.as_tensor(np.maximum(plan.wrap_at // 4, 1)).to(cuda),
           torch.full((plan.xs.shape[0],), 7, dtype=torch.int32,
                      device=cuda))
    xs = torch.as_tensor(plan.xs).to(cuda)
    sn = torch.as_tensor(plan.seg_n).to(cuda)
    got = fsm.fsm_scan(xs, sn, plan.tables, steps, pad_info=pad)
    want = fsm.fsm_scan_plain(xs.cpu(), sn.cpu(), plan.tables, steps,
                              pad_info=tuple(t.cpu() for t in pad))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_fsm_scan_refuses_multi_byte_speculative_on_the_card(cuda, imgs):
    plan = fsm.build_plan(imgs[:1], split=False)
    xs = torch.as_tensor(plan.xs).to(cuda)
    sn = torch.as_tensor(plan.seg_n_blocks).to(cuda)
    with pytest.raises(ValueError):
        fsm.fsm_scan_spec(xs, sn, plan.tables, (2, 4), log_anchors=True)


def _segment_case(case):
    """(plan, arrays, cap) of a SEGMENT_CASES case: `arrays` are
    plan_arrays(plan), cut or rewritten for the case (the plan's luts may
    be rewritten too)."""
    from tpujpeg_torch.ops import entropy

    if case in ("restart", "malformed", "short_cap", "lanes_37",
                "misaligned") or case.startswith("cut_"):
        names = ["00.jpg", "02.jpg"]
        use = [parse_file(os.path.join(CORPUS, n)) for n in names]
        if case == "malformed":
            use[1] = _malformed(use[1])
    elif case in ("wide", "many_rows", "mixed_tables") \
            or case.startswith("wide_"):
        # 17,920 lanes: enough that the kernel puts 32 lanes in a block
        use = [parse_file(os.path.join(CORPUS, f"{i:02d}.jpg"))
               for i in range(16)] * 14
    elif case == "truncated":
        img = parse_file(os.path.join(CORPUS, "03.jpg"))
        img.scan_data = img.scan_data[: img.scan_data.size // 4].copy()
        img.segment_offsets = img.segment_offsets[
            img.segment_offsets < img.scan_data.size]
        use = [img]
    else:   # one lane a stream without restart markers, and a 4:1:1 one
        use = [parse_file(os.path.join(SMALL, case))]
    plan = entropy.build_segment_plan(use)
    arrays = list(entropy.plan_arrays(plan))
    n_rows = plan.luts.shape[0]
    if case == "lanes_37":
        # a lane count that is no multiple of the 32-thread block
        arrays[1:5] = [a[:37] for a in arrays[1:5]]
    elif case.startswith("cut_"):
        # lanes 0..40, the scan cut 4 bytes past lane 40's own bytes (its
        # last peeks come within 17 bits of the clamp at n_bytes - 4), or
        # 40 bytes inside them (it walks past the clamp)
        arrays[1:5] = [a[:41] for a in arrays[1:5]]
        end = int(plan.seg_start_bits[41]) // 8
        arrays[0] = arrays[0][: end + 4 if case == "cut_plus_4" else end - 40]
    elif case.startswith("wide_cut_"):
        # lanes 0..4159 (4,160 on the H100's 132 SMs: still 32 lanes a
        # block), the scan cut 4 bytes past lane 4159's own bytes or 40
        # inside them, and lane 4159 moved to slot 16 of block 64: its
        # tail walks to the clamp between lanes that decode as usual
        n = WIDE_CUT_LANES
        end = int(plan.seg_start_bits[n]) // 8
        arrays[0] = arrays[0][: end + 4 if case == "wide_cut_plus_4"
                              else end - 40]
        order = np.arange(n)
        order[[WIDE_MID, n - 1]] = order[[n - 1, WIDE_MID]]
        arrays[1:5] = [a[:n][order] for a in arrays[1:5]]
    elif case == "wide_malformed":
        # every byte of lane 8,016 (slot 16 of block 250) 0xFF: no
        # Huffman code matches, that lane alone latches err
        lane = 250 * 32 + WIDE_MID % 32
        lo = int(plan.seg_start_bits[lane]) // 8
        hi = int(plan.seg_start_bits[lane + 1]) // 8
        arrays[0] = arrays[0].copy()
        arrays[0][lo:hi] = 0xFF
    elif case == "many_rows":
        # lane i reads copy i % 64 of the tables: 128 rows in one block,
        # most of them past what the block stages
        plan = dataclasses.replace(plan, luts=np.tile(plan.luts, (64, 1)))
        arrays[4] = arrays[4] + (np.arange(arrays[4].shape[0]) % 64
                                 * n_rows)[:, None, None].astype(np.int32)
    elif case == "mixed_tables":
        # the lanes in a shuffled order, each on one of three copies of
        # the tables at random: every warp mixes table sets
        rng = np.random.default_rng(15)
        perm = rng.permutation(arrays[1].shape[0])
        arrays[1:5] = [a[perm] for a in arrays[1:5]]
        plan = dataclasses.replace(plan, luts=np.tile(plan.luts, (3, 1)))
        copy = rng.integers(0, 3, arrays[4].shape[0])
        arrays[4] = arrays[4] + (copy * n_rows)[:, None, None].astype(
            np.int32)
    cap = 300 if case == "short_cap" else plan.cap
    return plan, arrays, cap


def _segment_inputs(case, device):
    """The case's tensors on `device` (the scan of "misaligned" 3 bytes
    into its storage), its plan and cap."""
    from tpujpeg_torch.ops import entropy

    plan, arrays, cap = _segment_case(case)
    t = [torch.as_tensor(np.ascontiguousarray(a)).to(device) for a in arrays]
    if case == "misaligned":
        buf = torch.zeros(t[0].numel() + 3, dtype=torch.uint8, device=device)
        buf[3:] = t[0]
        t[0] = buf[3:]
    return plan, t, entropy.device_luts(plan.luts, device), cap


WIDE_CUT_LANES, WIDE_MID = 4160, 64 * 32 + 16
SEGMENT_CASES = ["restart", "malformed", "truncated", "short_cap", "lanes_37",
                 "gray.jpg", "411_rst.jpg", "wide", "many_rows",
                 "mixed_tables", "misaligned", "cut_plus_4", "cut_inside",
                 "wide_cut_plus_4", "wide_cut_inside", "wide_malformed"]
# cases whose coefficients equal another case's
SAME_AS = {"many_rows": "wide", "mixed_tables": "wide",
           "misaligned": "restart"}


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_decode_segments_kernel_equals_plain(cuda, case):
    from tpujpeg_torch.ops import entropy

    plan, dev_in, luts, cap = _segment_inputs(case, cuda)
    got = entropy.decode_segments(*dev_in[:5], luts, dev_in[5], cap=cap,
                                  n_blocks_total=plan.n_blocks_total)
    host = [t.cpu() for t in dev_in]
    want = entropy.decode_segments_plain(
        *host[:5], torch.as_tensor(plan.luts), host[5], cap=cap,
        n_blocks_total=plan.n_blocks_total)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w)
    fails = case in ("malformed", "truncated", "short_cap",
                     "wide_malformed")
    assert bool(got[1].any()) == fails
    if case in SAME_AS:
        rplan, r_in, rluts, rcap = _segment_inputs(SAME_AS[case], cuda)
        ref = entropy.decode_segments(*r_in[:5], rluts, r_in[5], cap=rcap,
                                      n_blocks_total=rplan.n_blocks_total)
        assert torch.equal(got[0], ref[0]) and not bool(ref[1].any())


def test_gather_backend_on_the_card(cuda):
    from tpujpeg_torch.runtime import host, kernels
    from tpujpeg_torch.runtime.batch import BatchDecoder

    paths = [os.path.join(CORPUS, f"{i:02d}.jpg") for i in range(4)] \
        + [os.path.join(SMALL, n) for n in ("gray.jpg", "gray_rst.jpg")]
    datas = [open(p, "rb").read() for p in paths]
    dec = BatchDecoder(backend="gather", chunk_size=4, device="cuda")
    kernels.reset_launches()
    got = dec.decode(datas)
    torch.cuda.synchronize()
    assert dec.stats.backend == "gather" and dec.stats.chunks == 2
    assert kernels.LAUNCHES["decode_segments"] == 2
    assert kernels.LAUNCHES["fsm_scan"] == 0
    for g, p in zip(got, paths):
        assert np.array_equal(g, host.decode_cpu(parse_file(p)))
    dec.close()


MESHES = {"one_card": ["cuda:0", "cuda:0"], "two_cards": ["cuda:0", "cuda:1"]}


def _mesh_devices(name):
    """The two shards' devices; the distinct-card case needs two cards."""
    if torch.cuda.device_count() < len(set(MESHES[name])):
        pytest.skip("needs two CUDA cards: the shards on distinct cards")
    return MESHES[name]


@pytest.mark.parametrize("name", MESHES)
def test_batch_sharded_pixels_equal_one_device(cuda, name):
    from tpujpeg_torch import pipeline
    from tpujpeg_torch.parallel import sharding
    from tpujpeg_torch.runtime import host, kernels

    devices = _mesh_devices(name)
    imgs = [parse_file(os.path.join(CORPUS, f"{i:02d}.jpg"))
            for i in range(4)]
    geom = Geometry.of(imgs[0])
    coeffs = torch.as_tensor(np.stack(
        [host.entropy_decode(im) for im in imgs])).to(cuda)
    quant = torch.as_tensor(np.stack([np.stack(
        [im.quant_tables[c.quant_id] for c in im.components])
        for im in imgs]).astype(np.int32)).to(cuda)
    want, _ = pipeline.device_decode_fn(geom, coeffs, quant, exact=True)
    fn = sharding.compiled_batch_decoder(
        geom, sharding.make_mesh(2, devices=devices), exact=True)
    sharding.reset_transfers()
    kernels.reset_launches()
    rgb, risk, total = fn(coeffs, quant)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pixels"] == 2           # once a shard
    assert sharding.TRANSFERS == {"halo": 0, "gather": 0}
    assert risk is None and total == 4 * geom.width * geom.height
    for i, (shard, d) in enumerate(zip(rgb, devices)):
        assert shard.device == torch.device(d)
        assert torch.equal(shard.to(cuda), want[2 * i:2 * i + 2])


@pytest.mark.parametrize("name", MESHES)
def test_engine_on_a_two_shard_mesh(cuda, name):
    from tpujpeg_torch.parallel import sharding
    from tpujpeg_torch.runtime import host, kernels
    from tpujpeg_torch.runtime.batch import BatchDecoder

    devices = _mesh_devices(name)
    paths = [os.path.join(CORPUS, f"{i:02d}.jpg") for i in range(3)]
    datas = [open(p, "rb").read() for p in paths]
    dec = BatchDecoder(backend="fsm", chunk_size=4,
                       mesh=sharding.make_mesh(2, devices=devices))
    kernels.reset_launches()
    got = dec.decode(datas)
    dec.close()
    # the staged restart chain, then the pixel stage once a shard (three
    # images padded to four)
    assert dec.stats.backend == "fsm" and dec.device == torch.device(
        devices[0])
    assert kernels.LAUNCHES["fsm_scan"] >= 1
    assert kernels.LAUNCHES["place_events"] >= 1
    assert kernels.LAUNCHES["pixels"] == 2
    for g, p in zip(got, paths):
        assert np.array_equal(g, host.decode_cpu(parse_file(p)))
