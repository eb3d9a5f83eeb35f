"""tpujpeg_torch BatchDecoder on subsampled and grayscale streams == the
JAX engine == the oracle.

BatchDecoder(fancy=) on "fsm" and "host", at exact geometry and in
size-class buckets, against the JAX engine's outputs, routes and
counters: a batch that mixes every sampling, mixed sizes of 4:2:0, the
speculative path at 6 blocks per MCU (resolved, and missed into the
Jacobi path), a plan row capacity past the JAX engine's int16 gate
decoded on the device, and the slot capacity on a 240-block row.
Streams and the comparison rule are those of
tests/test_torch_subsampled.py: outputs `==`, counters `==` by
tests/test_torch_buckets.py::_stats_equal (the port's repaired_pixels
is 0).
"""

import numpy as np
import pytest
import torch

from tpujpeg.io.parser import parse
from tpujpeg.runtime.batch import BatchDecoder as JaxBatchDecoder
from tpujpeg_torch import pipeline as tpipe
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.ops import materialize as tmat
from tpujpeg_torch.oracle import decoder as toracle
from tpujpeg_torch.runtime.batch import BatchDecoder

from test_torch_buckets import _mesh1, _stats_equal
from test_torch_subsampled import SAMPLINGS, _encode, _encode_pil, _oracle


@pytest.mark.parametrize("fancy", [False, True], ids=["box", "fancy"])
@pytest.mark.parametrize("backend", ["fsm", "host"])
def test_engine_mixed_samplings_match_jax_and_oracle(backend, fancy):
    # one batch of every sampling, with and without restart markers:
    # chunks key on geometry, so it splits by itself
    datas = [_encode((48, 64), s, seed=i, rst_rows=1)
             for i, s in enumerate(SAMPLINGS)]
    datas += [_encode_pil((48, 64), seed=8),
              _encode((48, 64), "gray", seed=9),
              _encode((48, 64), "420", seed=10, rst_rows=1)]
    dec = BatchDecoder(backend=backend, chunk_size=4, device="cpu",
                       fancy=fancy)
    out = dec.decode(datas)
    dec.close()
    jdec = JaxBatchDecoder(backend=backend, chunk_size=4, fancy=fancy)
    jout = jdec.decode(datas)
    assert dec.stats.backend == backend, dec.stats.as_dict()
    assert dec.stats.chunks == 5
    _stats_equal(dec.stats, jdec.stats)
    for g, j, w in zip(out, jout, _oracle(datas, fancy)):
        assert g.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)
    if fancy:
        assert not np.array_equal(out[0], _oracle(datas[:1])[0])


@pytest.mark.parametrize("fancy", [False, True], ids=["box", "fancy"])
@pytest.mark.parametrize("backend", ["fsm", "host"])
def test_engine_buckets_420_match_jax_and_oracle(backend, fancy):
    # mixed sizes of one size class; the last one carries no restart
    # markers, so on "fsm" it takes the host-bucketed route
    shapes = [(96, 112), (70, 100), (85, 90), (90, 105)]
    datas = [_encode(s, "420", seed=30 + i, rst_rows=1)
             for i, s in enumerate(shapes[:3])]
    datas.append(_encode_pil(shapes[3], seed=33))
    dec = BatchDecoder(backend=backend, chunk_size=4, device="cpu",
                       fancy=fancy, size_buckets=True)
    out = dec.decode(datas)
    dec.close()
    jdec = JaxBatchDecoder(backend=backend, chunk_size=4, fancy=fancy,
                           size_buckets=True,
                           mesh=_mesh1() if backend == "fsm" else None)
    jout = jdec.decode(datas)
    assert dec.stats.backend == (
        "fsm-bucketed+host-bucketed" if backend == "fsm"
        else "host-bucketed"), dec.stats.as_dict()
    _stats_equal(dec.stats, jdec.stats)
    for g, j, w in zip(out, jout, _oracle(datas, fancy)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("calm", [True, False], ids=["calm", "busy"])
def test_engine_spec_420_routes_like_jax(calm):
    # no restart markers, more than 8191 blocks: the speculative path at
    # 6 blocks per MCU.  Calm content resolves in the single pass and is
    # materialized through the slot route; on busy content some lanes do
    # not find the MCU phase again inside the stitch window, and both
    # engines count a resolve miss and take the Jacobi path
    datas = [_encode_pil((608, 608), seed=s, quality=50, calm=calm)
             for s in (3, 4)]
    assert parse(datas[0]).n_mcus * 6 > tfsm.MAX_BLOCKS_PER_LANE
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu", fancy=True)
    out = dec.decode(datas)
    dec.close()
    jdec = JaxBatchDecoder(backend="fsm", chunk_size=2, fancy=True)
    jout = jdec.decode(datas)
    assert dec.stats.backend == ("fsm-spec-sync" if calm else "fsm-spec"), \
        dec.stats.as_dict()
    assert dec.stats.spec_sync_misses == (0 if calm else 1)
    _stats_equal(dec.stats, jdec.stats)
    for g, j, w in zip(out, jout, _oracle(datas, True)):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)


def test_engine_gate_reads_the_plan_row_capacity_at_bpm_6():
    # 37 MCUs of 16 px -> bucket 45; at 6 blocks per MCU a two-row lane
    # holds 540 blocks: past the 512 blocks (32,768 dense rows) of the
    # JAX engine's int16 gate, which hands the chunk to the host; the
    # port's scatter has no such gate.  (The shape ladder's enumerator
    # counts 3 blocks per MCU and is not the JAX engine's gate.)
    k = 2
    datas = [_encode((64, 592), "420", seed=1, rst_rows=k, quality=50),
             _encode((60, 580), "420", seed=2, rst_rows=k, quality=50)]
    imgs = [parse(d) for d in datas]
    bucket = tpipe.bucket_geometry(tpipe.Geometry.of(imgs[0]))
    plan = tfsm.build_plan_bucketed(imgs, bucket)
    assert plan.max_blk == k * 45 * 6 > 512
    dec = BatchDecoder(backend="fsm", size_buckets=True, chunk_size=2,
                       device="cpu")
    out = dec.decode(datas)
    dec.close()
    assert dec.stats.backend == "fsm-bucketed", dec.stats.as_dict()
    assert dec.stats.fsm_malformed_fallbacks == 0
    assert dec.stats.fsm_envelope_fallbacks == 0
    for g, w in zip(out, _oracle(datas)):
        np.testing.assert_array_equal(g, w)
    jdec = JaxBatchDecoder(backend="fsm", size_buckets=True, chunk_size=2,
                           mesh=_mesh1())
    jdec.decode(datas)
    assert jdec.stats.backend == "host-bucketed"


def test_slot_capacity_bounds_sliding_windows_of_a_240_block_row():
    # one MCU row of a 640 px wide 4:2:0 image: 40 MCUs of 6 blocks, a
    # 240-block restart lane.  Slot groups are 8 consecutive blocks of
    # the lane, which straddle the six-block MCUs: the suggested capacity
    # covers every sliding window, so the slot route does not overflow
    # and equals the scatter
    data = _encode((16, 640), "420", seed=4, rst_rows=1)
    img = parse(data)
    assert img.mcus_x * img.blocks_per_mcu == 240
    per_block = tmat.events_per_block(toracle.entropy_decode(img))
    G = tmat.SLOT_G
    cs = np.concatenate([[0], np.cumsum(per_block)])
    sliding = int((cs[G:] - cs[:-G]).max())
    aligned = int(per_block.reshape(-1, G).sum(1).max())
    assert sliding >= aligned
    C = tmat.suggest_slot_c(per_block)
    assert C == 0 or C >= sliding
    plan = tfsm.build_plan([img], split=False)
    assert plan.max_blk == 240
    events, err_mal, err_env = tfsm.fsm_scan(
        torch.as_tensor(plan.xs), torch.as_tensor(plan.seg_n_blocks),
        plan.tables)
    assert not bool(err_mal.any() | err_env.any())
    ev = events.reshape(-1, events.shape[-1])
    M = plan.max_blk * 64
    classic = tmat.place_events(ev, M)
    dense, overflow = tmat.place_events_slots(ev, M, C or 512)
    assert not bool(overflow.any())
    assert torch.equal(dense, classic)
    # a capacity below the densest window does overflow, and says so
    small = 64
    while small * 2 < sliding:
        small *= 2
    if small < sliding:
        assert bool(tmat.place_events_slots(ev, M, small)[1].any())
