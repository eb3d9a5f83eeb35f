"""tpujpeg_torch slot materialize == the JAX package's place_events_slots,
and the engine's slot-overflow rung.

Exact comparisons (`==`) on decode-realistic event matrices
(tests/test_materialize.py's generator) against the JAX package's
place_events_slots in interpret mode, at its three cuts (compact, unpack,
final) and C in {64, 128, 256}, with overflow lanes (their dense rows are
undefined there, so dense is compared on the other lanes and the flags on
all).  The faults the port does not copy are held against the truth:
an event that packs to 0 is placed; suggest_slot_c bounds every lane
start with DC counted; a retry that produces nothing goes to the host; an
overflow without a host sample still moves later chunks.  The engine
takes the slot route on speculative chunks only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujpeg.io.parser import parse
from tpujpeg.oracle import decoder as oracle
from tpujpeg.ops import materialize as jmat
from tpujpeg_torch import JpegError
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.ops import materialize as tmat
from tpujpeg_torch.runtime import host
from tpujpeg_torch.runtime.batch import BatchDecoder

from conftest import make_jpeg, make_jpeg_rst
from test_materialize import _block_events

G = 8
CS = [64, 128, 256]


def _ovf_truth(want: np.ndarray, C: int) -> np.ndarray:
    """Lanes with a G-block group of more than C events."""
    L = want.shape[1]
    cnt = (want != 0).reshape(-1, 64, L).sum(1)
    pad = (-len(cnt)) % G
    cnt = np.concatenate([cnt, np.zeros((pad, L), cnt.dtype)])
    return (cnt.reshape(-1, G, L).sum(1) > C).any(0)


@pytest.fixture(scope="module")
def events():
    # one TPU window of rows, two heavy lanes that overflow every C
    rng = np.random.default_rng(5)
    n_rows, max_blk, L = 1000, 40, 128
    ev, want, _ = _block_events(rng, n_rows, max_blk, L, 6, heavy=(3, 77))
    return ev, want, max_blk * 64


@pytest.fixture(scope="module")
def jax_compact(events):
    ev, _, M = events
    p, o = jmat.place_events_slots(jnp.asarray(ev), M=M, interpret=True,
                                   stop_after="compact")
    return np.asarray(p), np.asarray(o)


def _np(t):
    return t.cpu().numpy()


def test_compact_matches_jax(events, jax_compact):
    ev, _, M = events
    N = ev.shape[0]
    p, o = tmat.place_events_slots(torch.as_tensor(ev), M, stop_after="compact")
    jp, jo = jax_compact
    assert p.dtype == torch.int32 and o.dtype == torch.int16
    np.testing.assert_array_equal(_np(p), jp[:N])
    np.testing.assert_array_equal(_np(o), jo[:N])
    # the TPU pads the rank rows to its window; the padding is empty
    assert (jo[N:] == -1).all() and (jp[N:] == 0).all()


@pytest.mark.parametrize("C", CS)
def test_unpack_matches_jax(events, C):
    ev, want, M = events
    N = ev.shape[0]
    o2, pay, ovf = tmat.place_events_slots(torch.as_tensor(ev), M, C=C,
                                           stop_after="unpack")
    jo2, jpay, jovf = (np.asarray(a) for a in jmat.place_events_slots(
        jnp.asarray(ev), M=M, C=C, interpret=True, stop_after="unpack"))
    assert o2.dtype == torch.int16
    np.testing.assert_array_equal(_np(o2), jo2[:N])
    np.testing.assert_array_equal(_np(pay), jpay[:N])
    np.testing.assert_array_equal(_np(ovf), jovf)
    np.testing.assert_array_equal(_np(ovf), _ovf_truth(want, C))
    assert bool(ovf[3]) and bool(ovf[77])


@pytest.mark.parametrize("C", CS)
def test_slots_match_jax_and_truth(events, C):
    ev, want, M = events
    dense, ovf = tmat.place_events_slots(torch.as_tensor(ev), M, C=C)
    jdense, jovf = (np.asarray(a) for a in jmat.place_events_slots(
        jnp.asarray(ev), M=M, C=C, interpret=True))
    assert dense.dtype == torch.int16 and tuple(dense.shape) == want.shape
    np.testing.assert_array_equal(_np(ovf), jovf)
    ok = ~jovf
    assert ok.sum() >= 10   # the comparison covers real lanes
    np.testing.assert_array_equal(_np(dense)[:, ok], jdense[:, ok])
    np.testing.assert_array_equal(_np(dense)[:, ok].astype(np.int32),
                                  want[:, ok])


def test_slot_space_taller_than_rank_space():
    # short scans with a tall block space: the slot rows exceed every rank
    # row (the TPU's fit() padding branch)
    rng = np.random.default_rng(21)
    n_rows, max_blk, L = 300, 120, 128
    M = max_blk * 64
    ev, want, _ = _block_events(rng, n_rows, max_blk, L, 2)
    dense, ovf = tmat.place_events_slots(torch.as_tensor(ev), M)
    jdense, jovf = jmat.place_events_slots(jnp.asarray(ev), M=M,
                                           interpret=True)
    assert not bool(ovf.any()) and not np.asarray(jovf).any()
    np.testing.assert_array_equal(_np(dense), np.asarray(jdense))
    np.testing.assert_array_equal(_np(dense).astype(np.int32), want)


@pytest.mark.parametrize("C", [64, 256])
def test_zero_packed_event_is_placed(C):
    # blk 0, z 0, val -2048 packs to exactly 0: validity is o >= 0, not
    # p != 0, so it lands in row 0 (the truth)
    L, M = 128, 16 * 64
    ev = np.full((6, L), -1, np.int32)
    truth = np.zeros((M, L), np.int32)
    ev[0, 5] = 0
    truth[0, 5] = -2048
    ev[3, 5] = (9 << 18) | (2 << 12) | (2048 - 3)     # blk 9, z 2, val -3
    truth[9 * 64 + 2, 5] = -3
    p, o = tmat.compact_to_rank(torch.as_tensor(ev))
    assert int(o[0, 5]) == 0 and int(p[0, 5]) == 0
    o2, ovf = tmat.slot_unpack(p, o, C, G)
    assert int(o2[0, 5]) == 0 and not bool(ovf.any())
    dense, ovf = tmat.place_events_slots(torch.as_tensor(ev), M, C=C)
    np.testing.assert_array_equal(_np(dense).astype(np.int32), truth)


# ---------------------------------------------------------------------------
# Edge inputs of the row-parallel unpack (32-lane tiles walked in chunks
# of 128 rows, 16-row warp slices): a hole, groups longer than a slice
# ---------------------------------------------------------------------------


def _truth(ev: np.ndarray, M: int) -> np.ndarray:
    """Dense int32 [M, L] of events [N, L] (-1 = empty)."""
    want = np.zeros((M, ev.shape[1]), np.int32)
    rows, lanes = np.nonzero(ev >= 0)
    e = ev[rows, lanes]
    want[(e >> 18) * 64 + ((e >> 12) & 63), lanes] = (e & 0xFFF) - 2048
    return want


@pytest.mark.parametrize("C", [64, 256])
def test_unpack_after_a_hole_equals_jax_before_it(events, jax_compact, C):
    # a row with o >= 0 after the lane's first o < 0 is dead: the plain
    # versions on compacted rows with a hole == the JAX package on the
    # lane's events before it.  Heavy lane 3 holes at rank 0 (nothing
    # live, no overflow), heavy lane 77 after its overflow.
    ev, _, M = events
    N = ev.shape[0]
    jp, jo = jax_compact
    holes = {3: 0, 5: 1, 77: C + 10}
    holes.update({lane: h for lane, h in zip(range(10, 40, 3),
                                             [15, 16, 17, 127, 128, 129,
                                              130, 143, 144, 200])})
    cut = ev.copy()
    p = torch.as_tensor(jp[:N].copy())
    o = torch.as_tensor(jo[:N].copy())
    for lane, h in holes.items():
        cut[np.nonzero(ev[:, lane] >= 0)[0][h:], lane] = -1
        o[h, lane] = -1
        assert int(o[h + 1, lane]) == 0       # live rows after the hole
    o2, ovf = tmat.slot_unpack_plain(p, o, C, G)
    jo2, _, jovf = (np.asarray(a) for a in jmat.place_events_slots(
        jnp.asarray(cut), M=M, C=C, interpret=True, stop_after="unpack"))
    np.testing.assert_array_equal(_np(o2), jo2[:N])
    np.testing.assert_array_equal(_np(ovf), jovf)
    assert not bool(ovf[3]) and bool(ovf[77])
    dense = tmat.slot_expand_plain(o2, p, M, C, G)
    jdense, _ = (np.asarray(a) for a in jmat.place_events_slots(
        jnp.asarray(cut), M=M, C=C, interpret=True))
    ok = ~jovf
    np.testing.assert_array_equal(_np(dense)[:, ok], jdense[:, ok])
    np.testing.assert_array_equal(_np(dense)[:, ok].astype(np.int32),
                                  _truth(cut, M)[:, ok])


@pytest.mark.parametrize("C", [128, 256, 512])
def test_groups_longer_than_a_slice_match_jax(C):
    # each lane's long group starts at a row in 0-139 (across the first
    # 128-row chunk) and holds 17 to 257 events: longer than a 16-row
    # slice, than a chunk, and C, C + 1 where C = 256; at C = 512 (the
    # restart chunk's capacity) no lane overflows
    rng = np.random.default_rng(C)
    N, L, M = 1000, 128, 64 * 64
    ev = np.full((N, L), -1, np.int32)
    for lane in range(L):
        start = (lane * 5) % 140
        counts = [30] * (start // 30) + [start % 30] \
            + [[17, 100, 129, 200, 255, 256, 257][lane % 7], 9]
        rows = []
        for g, n in enumerate(counts):
            idx = np.sort(rng.choice(512, n, replace=False))
            val = rng.integers(1, 4095, n)     # no value is 0
            rows += list(((8 * g + idx // 64) << 18) | ((idx % 64) << 12)
                         | (val + (val >= 2048)))
        ev[np.sort(rng.choice(N, len(rows), replace=False)), lane] = rows
    p, o = tmat.place_events_slots(torch.as_tensor(ev), M, stop_after="compact")
    o2, ovf = tmat.slot_unpack_plain(p, o, C, G)
    jo2, _, jovf = (np.asarray(a) for a in jmat.place_events_slots(
        jnp.asarray(ev), M=M, C=C, interpret=True, stop_after="unpack"))
    np.testing.assert_array_equal(_np(o2), jo2[:N])
    np.testing.assert_array_equal(_np(ovf), jovf)
    want = _truth(ev, M)
    np.testing.assert_array_equal(_np(ovf), _ovf_truth(want, C))
    dense = tmat.slot_expand_plain(o2, p, M, C, G)
    jdense, _ = (np.asarray(a) for a in jmat.place_events_slots(
        jnp.asarray(ev), M=M, C=C, interpret=True))
    ok = ~jovf
    assert ok.sum() >= 30
    np.testing.assert_array_equal(_np(dense)[:, ok], jdense[:, ok])
    np.testing.assert_array_equal(_np(dense)[:, ok].astype(np.int32),
                                  want[:, ok])


# ---------------------------------------------------------------------------
# Edge inputs of the rank-in-kernel compaction (one body for compact and
# compact_full: 32-lane tiles walked in 128-row chunks, the rows after a
# lane's events written by the kernel)
# ---------------------------------------------------------------------------

COMPACT_EDGES = ["full_lane", "empty_lane", "last_row", "lanes33"]


def _compact_edge(case):
    """events int32 [300, L] (-1 = empty, no event packs to 0) with whole
    lanes full (no row after the events), empty (every row after), an
    event only at row N - 1, or 33 lanes (a tile and one lane)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    N, L = 300, 33 if case == "lanes33" else 128
    ev = rng.integers(1, 2 ** 31 - 1, (N, L), dtype=np.int32)
    ev[rng.random((N, L)) < 0.6] = -1
    if case == "full_lane":
        ev[:, :32] = rng.integers(1, 2 ** 31 - 1, (N, 32))
    elif case == "empty_lane":
        ev[:, 32:64] = -1
    elif case == "last_row":
        ev[:] = -1
        ev[N - 1, ::2] = rng.integers(1, 2 ** 31 - 1, L // 2)
    else:
        ev[:, 0] = rng.integers(1, 2 ** 31 - 1, N)
        ev[:, 1] = -1
        ev[:, 2] = -1
        ev[N - 1, 2] = 7
    return ev


@pytest.mark.parametrize("case", COMPACT_EDGES)
def test_compact_plain_matches_jax_on_edge_lanes(case):
    ev = _compact_edge(case)
    N = ev.shape[0]
    p, o = tmat.compact_to_rank_plain(torch.as_tensor(ev))
    jp, jo = (np.asarray(a) for a in jmat.place_events_slots(
        jnp.asarray(ev), M=64 * 64, interpret=True, stop_after="compact"))
    np.testing.assert_array_equal(_np(p), jp[:N])
    np.testing.assert_array_equal(_np(o), jo[:N])
    assert (jo[N:] == -1).all() and (jp[N:] == 0).all()
    np.testing.assert_array_equal((_np(o) == 0).sum(0), (ev >= 0).sum(0))


def test_slot_gate():
    assert tmat.slot_gate(5132, 240 * 64, 256)
    assert tmat.slot_gate(4120, 512 * 64, 512)         # C = 64 G
    assert not tmat.slot_gate(4120, 512 * 64, 1024)    # C > 64 G
    assert not tmat.slot_gate(4120, 512 * 64, 96)      # not a power of two
    assert not tmat.slot_gate(32769, 64 * 64, 64)      # rank rows > int16
    assert not tmat.slot_gate(4120, 2048 * 64, 256)    # slot rows > int16
    assert tmat.slot_gate(4120, 1024 * 64, 256)        # 32768 slot rows


@pytest.mark.parametrize("selfcheck", ["0", "1"])
def test_materialize_checked_slot_route(events, monkeypatch, selfcheck):
    monkeypatch.setenv("TPUJPEG_SELFCHECK", selfcheck)
    ev, want, M = events
    C = 128
    L = ev.shape[1]
    err_in = torch.zeros(L, dtype=torch.bool)
    err_in[9] = True
    coeffs_t, err_mal, err_slot = tfsm.materialize_checked(
        torch.as_tensor(ev), M, err_in, slots=C)
    ovf = _ovf_truth(want, C)
    np.testing.assert_array_equal(_np(err_slot), ovf)
    np.testing.assert_array_equal(
        _np(coeffs_t)[:, ~ovf].astype(np.int32), want[:, ~ovf])
    # overflow lanes stay out of the checksum latch: they retry classic
    assert err_mal.nonzero().flatten().tolist() == [9]
    # slots=False is the classic scatter; a gated-out C falls back to it
    for slots in (False, 2048):
        _, _, slot = tfsm.materialize_checked(torch.as_tensor(ev), M, err_in,
                                              slots=slots)
        assert not bool(slot.any())


# ---------------------------------------------------------------------------
# suggest_slot_c: a bound for every lane start
# ---------------------------------------------------------------------------


def test_events_per_block_counts_dc_always():
    coeffs = np.zeros((3, 64), np.int32)
    coeffs[0, 0] = 5           # a resolved DC of any value, or 0
    coeffs[1, [0, 7, 9]] = 1
    np.testing.assert_array_equal(tmat.events_per_block(coeffs), [1, 3, 1])


def test_suggest_slot_c_keeps_the_tail_group():
    # the heavy blocks sit in the last, partial aligned group
    per_block = np.array([1] * 8 + [100, 100])
    assert tmat.suggest_slot_c(per_block) == 256
    assert tmat.suggest_slot_c([30] * 3) == 128        # shorter than G
    assert tmat.suggest_slot_c([40] * 9) == 0          # 320 > 256


def test_suggest_slot_c_bounds_every_lane_start():
    # lanes start at any block (restart segments need not start at a
    # multiple of G, speculative lanes start anywhere): every G-block
    # group from every start fits C
    rng = np.random.default_rng(4)
    for _ in range(20):
        per_block = rng.integers(1, 40, int(rng.integers(9, 60)))
        C = tmat.suggest_slot_c(per_block)
        if not C:
            continue
        for start in range(len(per_block)):
            lane = per_block[start:]
            for g in range(0, len(lane), G):
                assert lane[g : g + G].sum() <= C


# ---------------------------------------------------------------------------
# The engine's slot rung
# ---------------------------------------------------------------------------


def _noise_spec(monkeypatch, seeds):
    """Small no-restart q95 noise streams on the speculative path, the
    engine's slot route: build_plan refuses them, as it refuses an image
    over one lane (a real one costs tens of seconds of plain scan here)."""
    def refuse(imgs, split=True):
        raise JpegError("forced: no lane plan")

    monkeypatch.setattr(tfsm, "build_plan", refuse)
    return [make_jpeg(shape=(16, 24), seed=s, smooth=False, quality=95)
            for s in seeds]


def _oracle(datas):
    return [oracle.decode(parse(d)).astype(np.uint8) for d in datas]


def test_engine_small_capacity_retries_classic(monkeypatch):
    datas = _noise_spec(monkeypatch, (1, 2))
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    dec._slot_c = 64                 # a capacity the content overflows
    got = dec.decode(datas)
    assert dec.stats.fsm_slot_retries == 1, dec.stats.as_dict()
    assert dec.stats.backend == "fsm-spec-sync"
    assert dec.stats.fsm_malformed_fallbacks == 0
    assert dec.stats.fsm_envelope_fallbacks == 0
    assert dec._slot_c == 128        # later chunks: the next capacity up
    for g, o in zip(got, _oracle(datas)):
        np.testing.assert_array_equal(g, o)


def test_engine_retry_without_result_goes_to_host(monkeypatch):
    # the classic retry after an overflow produces nothing: the chunk is
    # decoded on the host, never served from the stale slot output
    datas = _noise_spec(monkeypatch, (3,))
    dec = BatchDecoder(backend="fsm", chunk_size=1, device="cpu")
    dec._slot_c = 64
    first = dec._process_chunk_fsm

    def once(chunk, steps=None):
        if chunk.slots_off:
            return False
        return first(chunk, steps)

    monkeypatch.setattr(dec, "_process_chunk_fsm", once)
    dec._redecode = lambda chunk, steps: once(chunk, steps)
    got = dec.decode(datas)
    assert dec.stats.fsm_slot_retries == 1
    assert dec.stats.backend == "host", dec.stats.as_dict()
    np.testing.assert_array_equal(got[0], _oracle(datas)[0])


def test_engine_overflow_without_host_sample_moves_on(monkeypatch):
    # no native decoder to sample with: the default capacity serves, and
    # an overflow still moves the later calls' chunks up; this q95 noise
    # overflows 64, 128 and 256, then decodes classic with no retry
    monkeypatch.setattr(host, "_load_native", lambda: None)
    monkeypatch.setattr(tmat, "SLOT_C", 64)
    data = _noise_spec(monkeypatch, (4,))
    want = _oracle(data)[0]
    dec = BatchDecoder(backend="fsm", chunk_size=1, device="cpu")
    for retries, after in ((1, 128), (1, 256), (1, 0), (0, 0)):
        got = dec.decode(data)
        assert dec.stats.fsm_slot_retries == retries, dec.stats.as_dict()
        assert dec._slot_c == after
        assert dec.stats.backend == "fsm-spec-sync"
        np.testing.assert_array_equal(got[0], want)


def test_engine_packed_lanes_take_the_classic_route():
    # restart chunks (one lane per segment) never take the slot route, so
    # a capacity the content would overflow costs them no retry
    datas = [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s,
                           quality=95) for s in (1, 2)]
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    dec._slot_c = 64
    got = dec.decode(datas)
    assert dec.stats.backend == "fsm"
    assert dec.stats.fsm_slot_retries == 0, dec.stats.as_dict()
    assert dec._slot_c == 64
    for g, o in zip(got, _oracle(datas)):
        np.testing.assert_array_equal(g, o)


def test_bump_slot_capacity():
    dec = BatchDecoder(backend="fsm", device="cpu")
    seen = []
    for c in (64, 128, 256, 0):
        dec._slot_c = c
        dec._bump_slot_capacity()
        seen.append(dec._slot_c)
    assert seen == [128, 256, 0, 0]
