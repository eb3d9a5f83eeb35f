"""tpujpeg_torch probe kernels' plain versions == what the JAX tools'
Pallas kernels compute.

ops/probes.py on CPU tensors (every wrapper takes its plain version
there) against: jnp.take_along_axis and jnp.take (vkernel2 and vkernel
of tools/bench_gather.py), a numpy walk of the dependent chain (skernel),
and the JAX package's _fine_compact_kernel in interpret mode at kc = 1
and a small window (compact_fine_only / compact_only of
tools/bench_materialize2.py; the tool's own partial no longer passes the
kernel's required `kc`, so the kernel is driven directly, as
tests/test_torch_routes.py drives the full-height kernels).  Every
comparison is `==` (integers, tolerance 0).  Also the two gathers' grids
(`gather_rows_geometry`, `gather_table_blocks`; hypothesis), and their
constants held equal to csrc/probes.cu's (the kernels themselves run
only on the card: tests/test_torch_kernels.py); the precondition of
csrc/compact.cuh's masked walk (destinations that rise strictly down each
lane; hypothesis) and the masks `compact_offsets` takes and refuses; and
the chain step's reciprocal `==` `%` at the edges and under hypothesis.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpujpeg.ops import materialize as jmat
from tpujpeg_torch.ops import materialize as tmat
from tpujpeg_torch.ops import probes

from test_materialize import _block_events


def _np(t):
    return t.cpu().numpy()


def test_gather_rows_matches_take_along_axis():
    rng = np.random.default_rng(0)
    t = rng.integers(0, 255, (16, 256)).astype(np.int32)
    i = rng.integers(0, 256, (16, 96)).astype(np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(t), jnp.asarray(i),
                                          axis=1))
    got = probes.gather_rows(torch.as_tensor(t), torch.as_tensor(i))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(probes.gather_rows_plain(torch.as_tensor(t), torch.as_tensor(i))),
        want)


def test_gather_table_matches_take():
    rng = np.random.default_rng(1)
    t = rng.integers(0, 255, 256).astype(np.int32)
    i = rng.integers(0, 256, 5000).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(t), jnp.asarray(i)))
    got = probes.gather_table(torch.as_tensor(t), torch.as_tensor(i))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)


@settings(max_examples=200, deadline=None)
@given(R=st.integers(0, 20_000), T=st.integers(1, 12288),
       K=st.integers(0, 2048), sms=st.integers(1, 200))
def test_gather_rows_geometry(R, T, K, sms):
    # a row a warp where eight warps' tables fit the 48 KB a launch takes
    # without opting in, else a row a block; the grid at most
    # BLOCKS_PER_SM blocks an SM, none without a row, none when empty
    blocks, group = probes.gather_rows_geometry(R, T, K, sms)
    assert group == (32 if T <= 1536 else 256)
    assert (probes.THREADS // group) * T * 4 <= 49152
    groups = probes.THREADS // group
    if R * K == 0:
        assert blocks == 0
    else:
        assert 1 <= blocks <= sms * probes.BLOCKS_PER_SM
        assert (blocks - 1) * groups < R
        assert blocks == sms * probes.BLOCKS_PER_SM or blocks * groups >= R


@settings(max_examples=200, deadline=None)
@given(N=st.integers(0, 1 << 26), sms=st.integers(1, 200))
def test_gather_table_blocks(N, sms):
    # at most BLOCKS_PER_SM blocks an SM; no block without a whole pass
    # of TABLE_PASS index vectors a thread, except the one a small N takes
    blocks = probes.gather_table_blocks(N, sms)
    if N == 0:
        assert blocks == 0
        return
    per_block = probes.THREADS * probes.TABLE_PASS
    assert 1 <= blocks <= sms * probes.BLOCKS_PER_SM
    assert blocks == 1 or (blocks - 1) * per_block < N // 4
    assert blocks == sms * probes.BLOCKS_PER_SM or blocks * per_block >= N // 4


def test_gather_grid_constants_match_the_kernel_source():
    # ops/probes.py sizes the grids with copies of csrc/probes.cu's
    # constants: block size, blocks an SM of both kernels'
    # __launch_bounds__, gather_table's pass and the warp-per-row limit
    src = (Path(probes.__file__).parents[1] / "csrc" / "probes.cu") \
        .read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kThreads")) == probes.THREADS
    assert int(const("kMaxTable")) == probes.MAX_SHARED_TABLE
    assert int(const("kTablePass")) == probes.TABLE_PASS
    assert const("kWarpRowsMaxTable") == "kMaxTable / (kThreads / 32)"
    assert probes.WARP_ROWS_MAX_TABLE == \
        probes.MAX_SHARED_TABLE // (probes.THREADS // 32)
    bounds = re.findall(r"__launch_bounds__\((\w+), (\d+)\)\s*\n"
                        r"(gather_\w+_kernel)", src)
    assert sorted(k for _, _, k in bounds) == ["gather_rows_kernel",
                                                "gather_table_kernel"]
    for threads, per_sm, _ in bounds:
        assert threads == "kThreads" and int(per_sm) == probes.BLOCKS_PER_SM


@pytest.mark.parametrize("steps", [0, 1, 4096])
def test_chain_matches_a_numpy_walk(steps):
    rng = np.random.default_rng(2)
    tbl = rng.integers(0, 4096, (4096, 1)).astype(np.int32)
    idx = 3
    for _ in range(steps):
        idx = (int(tbl[idx, 0]) * 7 + 1) % 4096
    for source in probes.CHAIN_SOURCES:
        got = probes.chain(torch.as_tensor(tbl),
                           torch.tensor([3], dtype=torch.int32), steps,
                           source)
        assert got.dtype == torch.int32 and got.tolist() == [idx]
    with pytest.raises(ValueError, match="unknown source"):
        probes.chain(torch.as_tensor(tbl),
                     torch.tensor([3], dtype=torch.int32), 1, "l1")


def test_chain_matches_the_pallas_chain_in_interpret_mode():
    # skernel of tools/bench_gather.py, with its chain length a parameter
    from jax.experimental import pallas as pl

    steps = 64

    def skernel(t_ref, s_ref, o_ref):
        def body(k, idx):
            return (t_ref[idx, 0] * 7 + 1) % 4096

        o_ref[0] = jax.lax.fori_loop(0, steps, body, s_ref[0])

    rng = np.random.default_rng(4)
    tbl = rng.integers(0, 4096, (4096, 1)).astype(np.int32)
    want = pl.pallas_call(
        skernel, out_shape=jax.ShapeDtypeStruct((1,), jnp.int32),
        interpret=True,
    )(jnp.asarray(tbl), jnp.asarray([3], jnp.int32))
    got = probes.chain(torch.as_tensor(tbl),
                       torch.tensor([3], dtype=torch.int32), steps)
    assert got.tolist() == np.asarray(want).tolist()


def _jax_fine_compact(p, o, W):
    """_fine_compact_kernel at kc = 1 over windows of W rows (the call of
    compact_fine_only in tools/bench_materialize2.py, plus `kc`)."""
    from jax.experimental import pallas as pl

    Np, L = p.shape
    n_win = Np // W
    cur = pl.BlockSpec((W, 128), lambda q, i: (q, i))
    succ = pl.BlockSpec((W, 128),
                        lambda q, i: (jnp.minimum(q + 1, n_win - 1), i))
    jp, jo = pl.pallas_call(
        functools.partial(jmat._fine_compact_kernel, n_win=n_win, kc=1),
        out_shape=(jax.ShapeDtypeStruct((Np, L), jnp.int32),
                   jax.ShapeDtypeStruct((Np, L), jnp.int16)),
        grid=(n_win, L // 128),
        in_specs=[cur, succ, cur, succ],
        out_specs=(cur, cur),
        interpret=True,
    )(jnp.asarray(p), jnp.asarray(p), jnp.asarray(o), jnp.asarray(o))
    return np.asarray(jp), np.asarray(jo)


@pytest.fixture(scope="module")
def offsets():
    # decode-realistic events over several windows of rows: offsets grow
    # past every window size tried below
    rng = np.random.default_rng(5)
    ev, _, _ = _block_events(rng, 1024, 40, 128, 6)
    ev[0, 1] = 0   # blk 0, z 0, val -2048 packs to 0 and is an event
    p0, o0 = probes.offsets_init(torch.as_tensor(ev))
    assert int(o0.max()) > 512
    return ev, p0, o0


@pytest.mark.parametrize("W", [128, 256, 512])
def test_compact_fine_matches_the_pallas_fine_kernel(offsets, W):
    ev, p0, o0 = offsets
    jp, jo = _jax_fine_compact(_np(p0), _np(o0), W)
    p, o = probes.compact_fine(p0, o0, W)
    assert p.dtype == torch.int32 and o.dtype == torch.int16
    np.testing.assert_array_equal(_np(p), jp)
    np.testing.assert_array_equal(_np(o), jo)
    # every residual offset is a multiple of W; the stage moved something
    # and left something for the coarse stages
    res = _np(o)[_np(o) >= 0]
    assert (res % W == 0).all() and (res > 0).any()
    assert not torch.equal(p, p0)
    # the event that packs to 0 is kept: validity is o >= 0
    assert int(o[0, 1]) == 0 and int(p[0, 1]) == 0


@pytest.mark.parametrize("W", [128, 1024])
def test_compact_staged_equals_one_full_compact(offsets, W):
    ev, p0, o0 = offsets
    whole = tmat.compact_offsets(p0, o0)
    staged = probes.compact_staged(p0, o0, W)
    ranked = tmat.compact_to_rank_plain(torch.as_tensor(ev))
    for a, b, c in zip(staged, whole, ranked):
        assert torch.equal(a, b) and torch.equal(a, c)
    plain = probes.compact_staged_plain(p0, o0, W)
    assert all(torch.equal(a, b) for a, b in zip(plain, staged))
    # the coarse stages alone, on offsets whose low bits are already spent
    fine = probes.compact_fine(p0, o0, W)
    coarse = tmat.compact_offsets(*fine, mask=~(W - 1))
    assert torch.equal(coarse[0], whole[0]) and torch.equal(coarse[1], whole[1])
    with pytest.raises(ValueError, match="power of two"):
        probes.compact_fine(p0, o0, 100)


def test_spread_ranked_equals_the_scatter(offsets):
    ev, p0, o0 = offsets
    M = 40 * 64
    cp, co = probes.compact_staged(p0, o0, 256)
    dense = probes.spread_ranked(cp, co, M)
    assert dense.dtype == torch.int16 and tuple(dense.shape) == (M, 128)
    assert torch.equal(dense, tmat.place_events(torch.as_tensor(ev), M))
    assert torch.equal(dense, probes.spread_ranked_plain(cp, co, M))
    want = np.asarray(jmat.place_events_v3(jnp.asarray(ev), M=M,
                                           interpret=True))
    np.testing.assert_array_equal(_np(dense), want[:M])
    assert int(dense[0, 1]) == -2048


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 400), st.integers(1, 9), st.integers(0, 2 ** 32 - 1),
       st.sampled_from([2, 128, 1024]))
def test_masked_destinations_rise_strictly_down_each_lane(N, L, seed, W):
    # the precondition of compact.cuh's masked walk: on offsets_init's
    # (p, o), the destinations row - (o & (W - 1)) rise strictly down each
    # lane and never fall below the lane's count of events so far; on the
    # fine stage's output (offsets multiples of W) the complement mask
    # ~(W - 1) moves every event to its rank, as mask -1 does
    rng = np.random.default_rng(seed)
    dens = rng.random(L) ** 2                  # sparse to full lanes
    ev = np.where(rng.random((N, L)) < dens, rng.integers(0, 2 ** 31 - 1,
                                                          (N, L)), -1)
    ev[rng.random((N, L)) < 0.1] = -1
    ev = ev.astype(np.int32)
    gap = rng.integers(0, N + 1)               # a run of empty rows
    ev[gap : gap + rng.integers(0, N + 1), rng.random(L) < 0.5] = -1
    p0, o0 = probes.offsets_init(torch.as_tensor(ev))
    fine = probes.compact_fine(p0, o0, W)
    rows = np.arange(N)[:, None]
    for (p, o), mask in (((p0, o0), W - 1), (fine, ~(W - 1))):
        o = _np(o).astype(np.int64)
        valid = o >= 0
        dst = rows - (o & mask)
        for lane in range(L):
            d = dst[valid[:, lane], lane]
            assert (np.diff(d) >= 1).all()
            assert (d >= np.arange(len(d))).all()
            if mask < 0:
                assert (o[valid[:, lane], lane] % W == 0).all()
                np.testing.assert_array_equal(d, np.arange(len(d)))
    whole = tmat.compact_offsets(p0, o0)
    coarse = tmat.compact_offsets(*fine, mask=~(W - 1))
    assert all(torch.equal(a, b) for a, b in zip(coarse, whole))


@pytest.mark.parametrize("mask", [2, 5, -3, 6, 1022, ~1022, 2 ** 31,
                                  -2 ** 31 - 1])
def test_compact_offsets_rejects_a_mask_it_has_no_walk_for(offsets, mask):
    # -1, 2^j - 1 and ~(2^j - 1) only, on CPU tensors as on CUDA ones: no
    # quiet fallback to the plain scatter
    _, p0, o0 = offsets
    with pytest.raises(ValueError, match="mask"):
        tmat.compact_offsets(p0, o0, mask=mask)
    with pytest.raises(ValueError, match="mask"):
        tmat.compact_offsets_plain(p0, o0, mask=mask)


@pytest.mark.parametrize("mask", [-1, 0, 1, 1023, ~1023, 2 ** 31 - 1,
                                  -2 ** 31])
def test_compact_offsets_takes_every_mask_it_has_a_walk_for(mask):
    # acceptance alone: what these masks compute is held on the card
    # (tests/test_torch_kernels.py), where the kernel runs
    tmat.check_offsets_mask(mask)


@pytest.mark.parametrize("W", [2, 128, 1024])
def test_compact_offsets_plain_refuses_a_complement_mask_off_its_multiples(
        offsets, W):
    # ~(W - 1) is valid only on offsets that are multiples of W (the fine
    # stage's output); the kernel does not check, so the plain version
    # refuses the rest rather than compute a function the kernel does not
    _, p0, o0 = offsets
    o = _np(o0)
    assert (o[o >= 0] % W != 0).any()
    with pytest.raises(ValueError, match="no multiple of"):
        tmat.compact_offsets_plain(p0, o0, mask=~(W - 1))
    with pytest.raises(ValueError, match="no multiple of"):
        tmat.compact_offsets(p0, o0, mask=~(W - 1))
    fine = probes.compact_fine(p0, o0, W)
    whole = tmat.compact_offsets_plain(p0, o0)
    got = tmat.compact_offsets_plain(*fine, mask=~(W - 1))
    assert all(torch.equal(a, b) for a, b in zip(got, whole))


_NEAR = (2 ** 31 - 2) // 7     # v with v * 7 + 1 just below 2^31


@pytest.mark.parametrize("T", [1, 2, 3, 7, 4093, 4096, 12289, 65536,
                               2 ** 30, 2 ** 30 + 1, 2 ** 31 - 1])
def test_chain_reciprocal_step_is_the_modulo_at_the_edges(T):
    # csrc/probes.cu's step: a % T by one multiply-high with the magic
    # chain_reciprocal gives (the wrapper passes it for T that are no
    # power of two, and the kernel masks the others)
    magic, l = probes.chain_reciprocal(T)
    assert 0 < magic < 2 ** 32 and 0 <= l <= 31
    q = (2 ** 31 - 1) // T
    edges = {0, 1, T - 1, T, T + 1, 2 * T - 1, 2 * T, q * T, q * T - 1,
             2 ** 31 - 1, 2 ** 31 - 2, 2 ** 31 - T, _NEAR * 7 + 1,
             (_NEAR - 1) * 7 + 1, (2 ** 28 - 1) * 7 + 1}
    for a in sorted(e for e in edges if 0 <= e < 2 ** 31):
        assert probes.mod_reciprocal(a, T, magic, l) == a % T, a
    if T & (T - 1) == 0:
        assert all(((v * 7 + 1) & (T - 1)) == (v * 7 + 1) % T
                   for v in (0, 1, _NEAR, 2 ** 28 - 1))
    with pytest.raises(ValueError):
        probes.chain_reciprocal(0)


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 2 ** 31 - 1))
def test_chain_reciprocal_step_is_the_modulo(a, T):
    assert probes.mod_reciprocal(a, T, *probes.chain_reciprocal(T)) == a % T
