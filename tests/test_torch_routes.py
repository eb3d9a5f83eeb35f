"""The three placements of tpujpeg_torch's classic materialize == the
JAX package's, and each other.

  place_events         one kernel (tests/test_torch_materialize.py); the
                       one every decode path takes;
  place_events_ranked  column cumsum + compact_offsets + spread_full,
                       held against the JAX package's _compact_to_rank
                       with its rank kernel off (materialize._RANK_KERNEL
                       False, the TPUJPEG_RANK_KERNEL=0 switch) at the
                       cuts 'init' and 'compact', interpret mode; also
                       the identity compact_offsets' kernel (the walk of
                       csrc/compact.cuh) relies on: under o = row - rank,
                       moving each valid row up by o is ranking the rows
                       with o >= 0;
  place_events_full    compact_full + spread_full, held against
                       place_events_pallas(interpret=True) and its two
                       kernels.

Every comparison is `==` on integers (tolerance 0), inputs from a numpy
seed (tests/test_materialize.py's generators).  The JAX compact kernel
writes 0 in its empty rows and its spread kernel takes `cp > 0` for
validity, so the real event that packs to 0 (blk 0, z 0, val -2048) is
dropped there; the port marks empty rows with -1 and keeps validity a
sign, so that event is held against the truth in all three placements,
and the compacted payloads are compared as where(cp < 0, 0, cp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujpeg.ops import materialize as jmat
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.ops import materialize as tmat

from test_materialize import _block_events, _random_events
from test_torch_slots import COMPACT_EDGES, _compact_edge

PLACEMENTS = {"scatter": tmat.place_events,
              "ranked": tmat.place_events_ranked,
              "full": tmat.place_events_full}


def _np(t):
    return t.cpu().numpy()


def _pallas(kernel, x, out_rows, dtype):
    """One of the JAX package's full-height kernels on the CPU, in
    interpret mode, over 128-lane tiles (place_events_pallas's calls)."""
    from jax.experimental import pallas as pl

    N, L = x.shape
    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((out_rows, L), dtype),
        grid=(L // 128,),
        in_specs=[pl.BlockSpec((N, 128), lambda i: (0, i))],
        out_specs=pl.BlockSpec((out_rows, 128), lambda i: (0, i)),
        interpret=True,
    )(jnp.asarray(x)))


@pytest.fixture(scope="module")
def events():
    # decode-realistic events, one TPU window of rows
    rng = np.random.default_rng(5)
    ev, want, _ = _block_events(rng, 1000, 40, 128, 6)
    return ev, want, 40 * 64


@pytest.mark.parametrize("cut", ["init", "compact"])
def test_compact_to_rank_offsets_match_jax(events, cut, monkeypatch):
    ev, _, _ = events
    N = ev.shape[0]
    monkeypatch.setattr(jmat, "_RANK_KERNEL", False)
    jp, jo = (np.asarray(a) for a in jmat._compact_to_rank(
        jnp.asarray(ev), interpret=True, stop_after=cut))
    p, o = tmat.compact_to_rank(torch.as_tensor(ev), rank_kernel=False,
                                stop_after=cut)
    assert p.dtype == torch.int32 and o.dtype == torch.int16
    np.testing.assert_array_equal(_np(p), jp[:N])
    np.testing.assert_array_equal(_np(o), jo[:N])
    # the TPU pads the rows to its window; the padding is empty
    assert (jo[N:] == -1).all() and (jp[N:] == 0).all()
    if cut == "init":
        valid = ev >= 0
        rank = np.cumsum(valid, 0) - valid
        np.testing.assert_array_equal(
            _np(o)[valid], (np.arange(N)[:, None] - rank)[valid])
    else:
        # the same rows as the rank kernel's route
        pk, ok = tmat.compact_to_rank(torch.as_tensor(ev))
        assert torch.equal(p, pk) and torch.equal(o, ok)


def test_compact_offsets_three_windows_match_jax(monkeypatch):
    # taller than two TPU windows: the JAX side runs its fine kernel and a
    # coarse stage; the port's kernel contract is the same at any height
    rng = np.random.default_rng(9)
    ev, _, _ = _block_events(rng, 2100, 60, 128, 8)
    monkeypatch.setattr(jmat, "_RANK_KERNEL", False)
    jp, jo = (np.asarray(a) for a in jmat._compact_to_rank(
        jnp.asarray(ev), interpret=True))
    p0, o0 = tmat.compact_to_rank(torch.as_tensor(ev), rank_kernel=False,
                                  stop_after="init")
    p, o = tmat.compact_offsets(p0, o0)
    np.testing.assert_array_equal(_np(p), jp[:2100])
    np.testing.assert_array_equal(_np(o), jo[:2100])


OFFSET_CASES = ["events", "full_lane", "empty_lane", "last_row",
                "zero_event", "rows1", "rows127", "rows128", "rows129",
                "fine128", "fine1024"]


@pytest.fixture(scope="module")
def tall():
    # taller than a 1024-row window, so compact_fine leaves offsets
    return _block_events(np.random.default_rng(9), 2100, 60, 128, 8)[0]


def _offsets_case(case, events, tall):
    """(ev, p, o): events int32 [N, 128] and the (p, o) handed to
    compact_offsets: the 'init' cut of ev, or compact_fine's output on it
    (window W, low offset bits moved)."""
    if case == "events":
        ev = events[0]
    elif case.startswith("fine"):
        ev = tall
    else:
        rng = np.random.default_rng(sum(map(ord, case)))
        N = int(case[4:]) if case.startswith("rows") else 300
        ev = rng.integers(0, 2 ** 31 - 1, (N, 128), dtype=np.int32)
        ev[rng.random((N, 128)) < 0.6] = -1
        if case == "full_lane":
            ev[:, :32] = rng.integers(0, 2 ** 31 - 1, (N, 32))
        elif case == "empty_lane":
            ev[:, 32:64] = -1
        elif case == "last_row":
            ev[:] = -1
            ev[N - 1, ::3] = rng.integers(0, 2 ** 31 - 1, len(ev[0, ::3]))
        elif case == "zero_event":
            ev[0, 1] = 0               # blk 0, z 0, val -2048 packs to 0
            ev[N - 1, 2] = 0
            ev[:, 3] = 0
    p, o = tmat.compact_to_rank(torch.as_tensor(ev), rank_kernel=False,
                                stop_after="init")
    if case.startswith("fine"):
        W = int(case[4:])
        p, o = tmat.compact_offsets_plain(p, o, mask=W - 1)
        assert int(o.max()) >= W       # the coarse stages have work left
    return ev, p, o


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_compact_offsets_is_the_rank_compaction_of_its_valid_rows(
        events, tall, case, monkeypatch):
    # the identity the kernel's walk relies on (csrc/compact.cuh): where
    # o = row - rank on the valid rows, moving each row up by o is
    # compacting the rows with o >= 0 to their ranks; held on the 'init'
    # cut and on compact_fine's output, with the JAX package's
    # _compact_to_rank (rank kernel off, interpret mode) as the third
    ev, p, o = _offsets_case(case, events, tall)
    N = ev.shape[0]
    got = tmat.compact_offsets_plain(p, o)
    walk = tmat.compact_to_rank_plain(torch.where(o >= 0, p, -1))
    assert torch.equal(got[0], walk[0]) and torch.equal(got[1], walk[1])
    monkeypatch.setattr(jmat, "_RANK_KERNEL", False)
    jp, jo = (np.asarray(a) for a in jmat._compact_to_rank(
        jnp.asarray(ev), interpret=True))
    np.testing.assert_array_equal(_np(got[0]), jp[:N])
    np.testing.assert_array_equal(_np(got[1]), jo[:N])


def test_compact_to_rank_rejects_what_it_cannot_do():
    ev = torch.full((4, 2), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="init"):
        tmat.compact_to_rank(ev, stop_after="init")
    with pytest.raises(ValueError, match="stop_after"):
        tmat.compact_to_rank(ev, stop_after="unpack")
    tall = torch.full((tmat.INT16_SPAN + 1, 1), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int16"):
        tmat.compact_to_rank(tall, rank_kernel=False)


CASES = {
    # name: (rows N, blocks, density): M = 64 * blocks
    "N<M": (96, 2, 0.15),
    "N>M": (192, 2, 0.3),
    "empty": (96, 2, 0.0),
    "dense": (96, 2, 0.6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_place_events_full_matches_pallas_and_truth(case):
    n_rows, max_blk, density = CASES[case]
    rng = np.random.default_rng(n_rows + int(density * 100))
    M = max_blk * 64
    ev, want = _random_events(rng, n_rows, max_blk, 128, density)
    j = np.asarray(jmat.place_events_pallas(jnp.asarray(ev), M=M,
                                            interpret=True))
    err = torch.zeros(128, dtype=torch.bool)
    got = tmat.place_events_full(torch.as_tensor(ev), M, err)
    assert got.dtype == torch.int16 and tuple(got.shape) == (M, 128)
    np.testing.assert_array_equal(_np(got), j)
    np.testing.assert_array_equal(_np(got).astype(np.int32), want)
    assert not bool(err.any())


@pytest.mark.parametrize("case", ["N<M", "N>M"])
def test_full_route_kernels_match_jax_kernels(case):
    n_rows, max_blk, density = CASES[case]
    rng = np.random.default_rng(17)
    M = max_blk * 64
    ev, want = _random_events(rng, n_rows, max_blk, 128, density)
    assert not (ev == 0).any()   # no zero-packed event: JAX would drop it
    jcp = _pallas(jmat._compact_kernel, ev, n_rows, jnp.int32)
    cp = tmat.compact_full(torch.as_tensor(ev))
    assert cp.dtype == torch.int32
    # empty rows: 0 in the JAX kernel, -1 here (validity stays a sign)
    np.testing.assert_array_equal(np.where(_np(cp) < 0, 0, _np(cp)), jcp)
    n_valid = (ev >= 0).sum(0)
    np.testing.assert_array_equal((_np(cp) >= 0).sum(0), n_valid)
    jdense = _pallas(jmat._spread_kernel, jcp, M, jnp.int16)
    dense = tmat.spread_full(cp, M)
    np.testing.assert_array_equal(_np(dense), jdense)
    np.testing.assert_array_equal(_np(dense).astype(np.int32), want)


@pytest.mark.parametrize("case", COMPACT_EDGES)
def test_compact_full_plain_matches_jax_kernel_on_edge_lanes(case):
    # full, empty and last-row lanes, and 33 lanes (padded to the JAX
    # kernel's 128-lane tile with empty lanes)
    ev = _compact_edge(case)
    N, L = ev.shape
    pad = np.full((N, -L % 128), -1, np.int32)
    jcp = _pallas(jmat._compact_kernel, np.concatenate([ev, pad], 1), N,
                  jnp.int32)[:, :L]
    cp = _np(tmat.compact_full_plain(torch.as_tensor(ev)))
    # empty rows: 0 in the JAX kernel, -1 here (validity stays a sign)
    np.testing.assert_array_equal(np.where(cp < 0, 0, cp), jcp)
    np.testing.assert_array_equal((cp >= 0).sum(0), (ev >= 0).sum(0))


# the four shapes of the full placement's test on the other two, and
# the decode-realistic events on all three
MATCH_CASES = [(name, "events") for name in PLACEMENTS] + [
    (name, case) for name in ("scatter", "ranked") for case in CASES]


@pytest.mark.parametrize("name, case", MATCH_CASES,
                         ids=[f"{n}-{c}" for n, c in MATCH_CASES])
def test_routes_match_each_other_and_truth(events, name, case):
    if case == "events":
        ev, want, M = events
    else:
        n_rows, max_blk, density = CASES[case]
        rng = np.random.default_rng(n_rows + int(density * 100))
        M = max_blk * 64
        ev, want = _random_events(rng, n_rows, max_blk, 128, density)
    err = torch.zeros(ev.shape[1], dtype=torch.bool)
    got = PLACEMENTS[name](torch.as_tensor(ev), M, err)
    assert got.dtype == torch.int16 and tuple(got.shape) == (M, 128)
    np.testing.assert_array_equal(_np(got).astype(np.int32), want)
    assert not bool(err.any())
    if name != "scatter":
        assert torch.equal(got, tmat.place_events(torch.as_tensor(ev), M))


@pytest.mark.parametrize("route", list(PLACEMENTS))
def test_zero_packed_event_is_placed_on_every_route(route):
    # blk 0, z 0, val -2048 packs to exactly 0; held against the truth,
    # not against the JAX kernels, which drop it
    L, M = 128, 16 * 64
    ev = np.full((6, L), -1, np.int32)
    truth = np.zeros((M, L), np.int32)
    ev[0, 5] = 0
    truth[0, 5] = -2048
    ev[3, 5] = (9 << 18) | (2 << 12) | (2048 - 3)     # blk 9, z 2, val -3
    truth[9 * 64 + 2, 5] = -3
    got = PLACEMENTS[route](torch.as_tensor(ev), M)
    np.testing.assert_array_equal(_np(got).astype(np.int32), truth)
    if route == "full":
        cp = tmat.compact_full(torch.as_tensor(ev))
        assert int(cp[0, 5]) == 0 and int(cp[2, 5]) == -1
        j = np.asarray(jmat.place_events_pallas(jnp.asarray(ev), M=M,
                                                interpret=True))
        assert j[0, 5] == 0   # the fault this port does not copy


@pytest.mark.parametrize("route", list(PLACEMENTS))
def test_out_of_range_target_latches_lane_on_every_route(route):
    L, M = 8, 4 * 64
    ev = np.full((5, L), -1, np.int32)
    ev[1, 2] = (1 << 18) | (7 << 12) | (2048 + 9)
    ev[2, 2] = (4 << 18) | 2048            # block 4: target 256 == M
    ev[4, 6] = (63 << 18) | (63 << 12) | 4095
    err = torch.zeros(L, dtype=torch.bool)
    got = PLACEMENTS[route](torch.as_tensor(ev), M, err)
    want = np.zeros((M, L), np.int16)
    want[64 + 7, 2] = 9
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(err), np.arange(L) % 4 == 2)


@pytest.mark.parametrize("route", list(PLACEMENTS))
def test_int16_gate_and_the_scatter_past_it(route):
    # the ranked and full placements carry int16 offsets: heights of
    # 32768 rows or more raise, on the events and on the dense side; the
    # scatter has no such limit and places the event (600 blocks of
    # dense rows, one lane)
    place = PLACEMENTS[route]
    small = torch.full((64, 1), -1, dtype=torch.int32)
    assert int(place(small, 32767).abs().sum()) == 0
    M = 600 * 64
    ev = np.full((40, 1), -1, np.int32)
    ev[7, 0] = (599 << 18) | (63 << 12) | (2048 + 5)
    tall = torch.full((tmat.INT16_SPAN, 1), -1, dtype=torch.int32)
    if route == "scatter":
        got = place(torch.as_tensor(ev), M)
        assert int(got[599 * 64 + 63, 0]) == 5 and int(got.abs().sum()) == 5
        assert int(place(tall, 64).abs().sum()) == 0
        return
    for events, rows in ((torch.as_tensor(ev), M), (tall, 64)):
        with pytest.raises(ValueError, match="int16"):
            place(events, rows)


@pytest.mark.parametrize("slots", [False, 64])
def test_materialize_checked_carries_the_route(events, slots, monkeypatch):
    # the classic materialize is the scatter; the slot route compacts
    # through the rank kernel
    ev, want, M = events
    calls = []
    for name in ("place_events", "compact_offsets", "compact_full",
                 "spread_full", "compact_to_rank_plain"):
        def spy(*a, _f=getattr(tmat, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(tmat, name, spy)
    err = torch.zeros(ev.shape[1], dtype=torch.bool)
    got, mal, ovf = tfsm.materialize_checked(torch.as_tensor(ev), M, err,
                                             slots=slots)
    ok = ~_np(ovf)
    assert ok.all() or slots
    np.testing.assert_array_equal(_np(got).astype(np.int32)[:, ok],
                                  want[:, ok])
    assert not bool(mal.any())
    assert calls == (["compact_to_rank_plain"] if slots
                     else ["place_events"])
