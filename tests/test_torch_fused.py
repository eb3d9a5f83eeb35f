"""tpujpeg_torch fused chunk decode == the JAX package's fused program.

runtime.fused.decode_chunk_fused (plain kernels on the CPU) against
tpujpeg.runtime.fused.decode_chunk_fused with the classic materialize
(slots=False), on the same restart plan: the raw-DC coefficients, the
resolved DC plane and the error masks are equal exactly; rgb follows the
pixel stage's rule (risk masks identical, rgb identical outside them —
see tests/test_torch_pixels.py).
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpujpeg.io.parser import parse
from tpujpeg.ops import fsm as jfsm
from tpujpeg.ops.color import unpack_mask
from tpujpeg.pipeline import Geometry as JaxGeometry
from tpujpeg.runtime import fused as jfused
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
