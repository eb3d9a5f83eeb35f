"""tpujpeg_torch place_events / materialize_checked == the JAX package's.

Exact comparisons (`==`) on seeded event matrices that honour the scan's
emission contract (per lane, valid events in row order with strictly
increasing targets): the plain PyTorch place_events against the Pallas
classic path (place_events_v3, interpret mode) and against the JAX
package's fsm._materialize_events, at a multi-window shape of
tests/test_materialize.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujpeg.ops import fsm as jfsm
from tpujpeg.ops import materialize as jmat
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.ops import materialize as tmat

from test_materialize import _random_events


@pytest.fixture(scope="module")
def events():
    # N > M / 64 windows on both sides, padding of N and M, an empty lane
    n_rows, max_blk, L = 2500, 35, 128
    rng = np.random.default_rng(n_rows)
    ev, want = _random_events(rng, n_rows, max_blk, L, 0.25)
    ev[:, 0] = -1
    want[:, 0] = 0
    return ev, want, max_blk * 64


def test_place_events_matches_v3_interpret(events):
    ev, want, M = events
    got = tmat.place_events(torch.as_tensor(ev), M)
    assert got.dtype == torch.int16 and tuple(got.shape) == (M, ev.shape[1])
    v3 = np.asarray(jmat.place_events_v3(jnp.asarray(ev), M=M, interpret=True))
    np.testing.assert_array_equal(got.numpy(), v3)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


def test_place_events_matches_materialize_events(events):
    ev, _, M = events
    got = tmat.place_events(torch.as_tensor(ev), M)
    xla = np.asarray(jfsm._materialize_events(jnp.asarray(ev), M))
    np.testing.assert_array_equal(got.numpy().astype(np.int32), xla)


def test_zero_packed_event_is_placed():
    # blk 0, z 0, val -2048 packs to exactly 0: still a valid event (the
    # scan's validity test is ev >= 0), so it must land in row 0
    L, M = 128, 128
    ev = np.full((8, L), -1, np.int32)
    truth = np.zeros((M, L), np.int32)
    ev[0, 3] = 0
    truth[0, 3] = -2048
    ev[2, 3] = (1 << 18) | (5 << 12) | (7 + 2048)   # blk 1, z 5, val 7
    truth[64 + 5, 3] = 7
    got = tmat.place_events(torch.as_tensor(ev), M)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), truth)


def test_out_of_range_target_latches_lane():
    L, M = 128, 128
    ev = np.full((4, L), -1, np.int32)
    ev[1, 9] = (2 << 18) | 2048                      # target 128 == M
    err = torch.zeros(L, dtype=torch.bool)
    got = tmat.place_events(torch.as_tensor(ev), M, err)
    assert not got.any()
    assert err.nonzero().flatten().tolist() == [9]


@pytest.mark.parametrize("selfcheck", ["0", "1"])
def test_materialize_checked(events, monkeypatch, selfcheck):
    # classic path: err_slot all-False; the TPUJPEG_SELFCHECK=1 checksum
    # agrees with a correct placement and leaves err_mal alone
    monkeypatch.setenv("TPUJPEG_SELFCHECK", selfcheck)
    ev, want, M = events
    L = ev.shape[1]
    err_in = torch.zeros(L, dtype=torch.bool)
    err_in[5] = True
    coeffs_t, err_mal, err_slot = tfsm.materialize_checked(
        torch.as_tensor(ev), M, err_in
    )
    np.testing.assert_array_equal(coeffs_t.numpy().astype(np.int32), want)
    assert err_mal.nonzero().flatten().tolist() == [5]
    assert not err_slot.any()
    assert err_mal is not err_in  # the caller's mask is not written


def test_selfcheck_catches_a_lost_event(events, monkeypatch):
    # the checksum compares the event stream with the dense tensor: a
    # placement that loses one value latches exactly that lane
    monkeypatch.setenv("TPUJPEG_SELFCHECK", "1")
    ev, want, M = events
    lane = 7
    row = int(np.flatnonzero(want[:, lane])[0])

    def lossy(ev_t, M_, err=None):
        out = tmat.place_events_plain(ev_t, M_, err)
        out[row, lane] = 0
        return out

    monkeypatch.setattr(tmat, "place_events", lossy)
    _, err_mal, _ = tfsm.materialize_checked(
        torch.as_tensor(ev), M, torch.zeros(ev.shape[1], dtype=torch.bool)
    )
    assert err_mal.nonzero().flatten().tolist() == [lane]
