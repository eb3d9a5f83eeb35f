"""tpujpeg_torch fused chunk decode == the JAX package's fused program.

runtime.fused.decode_chunk_fused (plain kernels on the CPU) against
tpujpeg.runtime.fused.decode_chunk_fused with the classic materialize
(slots=False), on the same restart plan: the raw-DC coefficients, the
resolved DC plane and the error masks are equal exactly; rgb follows the
pixel stage's rule (risk masks identical, rgb identical outside them —
see tests/test_torch_pixels.py).  The same for the wide-scan superchunk
(pack_superchunk field-equal, decode_superchunk against the JAX
program and against one decode_chunk_fused a sub-chunk) on three
sub-chunks of different strides, and for the three stop_after cuts
(checksums and masks against the JAX program's).
"""

import pytest

import jax.numpy as jnp
import numpy as np
import torch

from tpujpeg.io.parser import parse
from tpujpeg.ops import fsm as jfsm
from tpujpeg.ops.color import unpack_mask
from tpujpeg.pipeline import Geometry as JaxGeometry
from tpujpeg.runtime import fused as jfused
from tpujpeg_torch import convert
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.pipeline import Geometry
from tpujpeg_torch.runtime import fused as tfused

from conftest import make_jpeg_rst


def test_assemble_rows_matches_jax_on_mixed_layouts():
    # images of one chunk may carry different restart intervals
    layout = ((0, 3, 12, 5), (3, 2, 12, 17), (5, 1, 40, 29))
    rng = np.random.default_rng(0)
    per_lane = rng.integers(-100, 100, (8, 40, 4)).astype(np.int16)
    want = np.asarray(jfused._assemble_rows(jnp.asarray(per_lane), layout, 5))
    got = tfused._assemble_rows(torch.as_tensor(per_lane), layout, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_chunk_matches_jax_fused_program():
    imgs = [
        parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s))
        for s in (5, 6)
    ]
    quant = np.stack([
        np.stack([im.quant_tables[c.quant_id] for c in im.components])
        for im in imgs
    ]).astype(np.int32)
    jplan = jfsm.build_plan(imgs, split=False)
    jgeom = JaxGeometry.of(imgs[0])
    j_rgb, j_risk, j_coeffs, j_dc, j_mal, j_env, j_slot, _ = (
        jfused.decode_chunk_fused(jplan, jnp.asarray(quant), jgeom, 2,
                                  slots=False)
    )
    plan = tfsm.build_plan(imgs, split=False)
    rgb, risk, coeffs, dc, mal, env, slot = tfused.decode_chunk_fused(
        plan, torch.as_tensor(quant), Geometry.of(imgs[0]), 2
    )
    np.testing.assert_array_equal(coeffs.numpy(), np.asarray(j_coeffs))
    np.testing.assert_array_equal(dc.numpy(), np.asarray(j_dc))
    for g, w in ((mal, j_mal), (env, j_env), (slot, j_slot)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(risk.numpy(), np.asarray(j_risk))
    for b in range(2):
        safe = ~unpack_mask(np.asarray(j_risk)[b], jgeom.width)
        np.testing.assert_array_equal(
            rgb.numpy()[b][:, safe], np.asarray(j_rgb)[b][:, safe]
        )


def _quant(imgs):
    return np.stack([
        np.stack([im.quant_tables[c.quant_id] for c in im.components])
        for im in imgs
    ]).astype(np.int32)


def _sub_chunks():
    # three sub-chunks of one geometry whose restart intervals give three
    # strides (the widest sets the superchunk's)
    return [[parse(make_jpeg_rst(shape=(48, 64), rst_interval=r, seed=s))
             for s in seeds] for r, seeds in ((2, (1, 2)), (3, (3, 4)),
                                              (1, (5, 6)))]


def test_pack_superchunk_field_equal():
    jplans = [jfsm.build_plan(ims, split=False) for ims in _sub_chunks()]
    assert len({p.groups[0][0].shape[1] for p in jplans}) == 3
    want = jfused.pack_superchunk(jplans)
    got = tfused.pack_superchunk([convert.plan_from_jax(p) for p in jplans])
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[2] == want[2]


def test_superchunk_matches_jax_and_per_chunk_decodes():
    subs = _sub_chunks()
    jplans = [jfsm.build_plan(ims, split=False) for ims in subs]
    plans = [convert.plan_from_jax(p) for p in jplans]
    quants = np.stack([_quant(ims) for ims in subs])
    jgeom = JaxGeometry.of(subs[0][0])
    want = jfused.decode_superchunk(jplans, jnp.asarray(quants), jgeom, 2,
                                    slots=False)
    geom = Geometry.of(subs[0][0])
    got = tfused.decode_superchunk(plans, torch.as_tensor(quants), geom, 2)
    # coefficients, DC, risk and the three masks exactly; rgb outside risk
    for i in (1, 2, 3, 4, 5, 6):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for b in range(6):
        safe = ~unpack_mask(np.asarray(want[1])[b], jgeom.width)
        np.testing.assert_array_equal(got[0].numpy()[b][:, safe],
                                      np.asarray(want[0])[b][:, safe])
    # and each sub-chunk as decode_chunk_fused decodes it alone, exactly
    base = 0
    for si, (plan, ims) in enumerate(zip(plans, subs)):
        one = tfused.decode_chunk_fused(plan, torch.as_tensor(_quant(ims)),
                                        geom, 2)
        L = plan.xs.shape[0]
        for i in range(4):
            assert torch.equal(one[i], got[i][2 * si : 2 * si + 2]), i
        for i in (4, 6):
            assert torch.equal(one[i], got[i][base : base + L]), i
        base += L
    # with the upload given, in exact colour (no risk bits)
    xs, sn, _ = tfused.pack_superchunk(plans)
    exact = tfused.decode_superchunk(
        plans, torch.as_tensor(quants), geom, 2, want_coeffs=False,
        uploaded=(torch.as_tensor(xs), torch.as_tensor(sn)), exact=True)
    assert exact[1] is None and exact[2] is None and exact[3] is None
    assert exact[0].shape == got[0].shape


@pytest.mark.parametrize("stop_after", ["scan", "materialize", "assemble"])
def test_stop_after_checksums_match_jax(stop_after):
    imgs = [parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s))
            for s in (5, 6)]
    quant = _quant(imgs)
    jplan = jfsm.build_plan(imgs, split=False)
    jgeom = JaxGeometry.of(imgs[0])
    fn = jfused.compiled_fused_decoder(
        jgeom, jplan.tables, jplan.max_blk, jplan.layout, 3,
        stop_after=stop_after, slots=False)
    xs, sn = jplan.groups[0]
    want = fn(jnp.asarray(xs), jnp.asarray(sn), jnp.asarray(quant))[:-1]
    got = tfused.decode_chunk_fused(
        convert.plan_from_jax(jplan), torch.as_tensor(quant),
        Geometry.of(imgs[0]), 3, stop_after=stop_after)
    assert len(got) == len(want)   # JAX's tuple without its scan state
    assert got[0].dtype == torch.int32 and got[0].dim() == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        tfused.decode_chunk_fused(
            convert.plan_from_jax(jplan), torch.as_tensor(quant),
            Geometry.of(imgs[0]), 3, stop_after="pixels")
