"""tpujpeg_torch chroma upsampling == the JAX package's == the oracle's.

ops/upsample.py (plain PyTorch, a leading batch axis, per-image true
extents as int tensors [B]) against tpujpeg/ops/upsample.py (one plane,
traced scalars) and against the numpy copy in the port's oracle, on
seeded int planes.  Every comparison is `==` (integers, tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujpeg.ops import upsample as jup
from tpujpeg_torch.ops import upsample as tup
from tpujpeg_torch.oracle import decoder as toracle

FACTORS = [(2, 2), (2, 1), (1, 2), (4, 1)]   # (fh, fv)
H, W = 24, 40


def _planes(seed, B=3):
    """Centred IDCT-range planes [-256, 255], saturated values included
    (the clamp to samples matters there)."""
    rng = np.random.default_rng(seed)
    p = rng.integers(-256, 256, (B, H, W)).astype(np.int32)
    p[:, :2, :3] = -256
    p[:, -2:, -3:] = 255
    return p


@pytest.mark.parametrize("bounded", [False, True],
                         ids=["padded_edge", "true_hw"])
@pytest.mark.parametrize("fancy", [False, True], ids=["box", "fancy"])
@pytest.mark.parametrize("factors", FACTORS, ids=lambda f: f"h{f[0]}v{f[1]}")
def test_upsample_plane_matches_jax(factors, fancy, bounded):
    fh, fv = factors
    planes = _planes(fh * 10 + fv)
    # per-image true sample extents: full, interior, and a single sample
    th = np.asarray([H, 17, 1], np.int32)
    tw = np.asarray([W, 23, 1], np.int32)
    got = tup.upsample_plane(
        torch.as_tensor(planes), fh, fv, fancy,
        true_hw=(torch.as_tensor(th), torch.as_tensor(tw)) if bounded
        else None)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (3, H * fv, W * fh)
    for b in range(3):
        want = jup.upsample_plane(
            jnp.asarray(planes[b]), fh, fv, fancy,
            true_hw=(jnp.int32(th[b]), jnp.int32(tw[b])) if bounded else None)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
        if not bounded:
            # the oracle's numpy copy of the same filter
            np.testing.assert_array_equal(
                got[b].numpy(),
                toracle.upsample_plane(planes[b], fh, fv, fancy))


@pytest.mark.parametrize("factors", FACTORS[:3],
                         ids=lambda f: f"h{f[0]}v{f[1]}")
def test_true_extents_equal_the_exact_geometry_decode(factors):
    # a bucket-padded plane holds padding past each image's real samples:
    # with the true extents, the kept pixels equal the upsampling of the
    # cropped plane, whose edge is the real one
    fh, fv = factors
    planes = _planes(7)
    th, tw = [16, 24, 8], [32, 16, 40]
    got = tup.upsample_plane(
        torch.as_tensor(planes), fh, fv, True,
        true_hw=(torch.as_tensor(th, dtype=torch.int32),
                 torch.as_tensor(tw, dtype=torch.int32)))
    unbounded = tup.upsample_plane(torch.as_tensor(planes), fh, fv, True)
    differs = False
    for b in range(3):
        crop = torch.as_tensor(planes[b : b + 1, : th[b], : tw[b]].copy())
        want = tup.upsample_plane(crop, fh, fv, True)[0]
        kept = got[b, : th[b] * fv, : tw[b] * fh]
        assert torch.equal(kept, want)
        differs |= not torch.equal(
            unbounded[b, : th[b] * fv, : tw[b] * fh], want)
    assert differs   # the padded edge reads a padding sample


def test_fancy_and_box_functions_match_jax():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 256, (2, 16, 24)).astype(np.int32)
    for fh, fv in [(2, 2), (2, 1), (1, 2), (1, 1)]:
        got = tup.fancy_upsample(torch.as_tensor(s), fh, fv)
        for b in range(2):
            np.testing.assert_array_equal(
                got[b].numpy(),
                np.asarray(jup.fancy_upsample(jnp.asarray(s[b]), fh, fv)))
            np.testing.assert_array_equal(
                got[b].numpy(), toracle.fancy_upsample(s[b], fh, fv))
    for fh, fv in [(4, 1), (2, 2), (1, 2), (1, 1), (3, 2)]:
        got = tup.box_upsample(torch.as_tensor(s), fh, fv)
        for b in range(2):
            np.testing.assert_array_equal(
                got[b].numpy(),
                np.asarray(jup.box_upsample(jnp.asarray(s[b]), fh, fv)))
    with pytest.raises(ValueError, match="factors 1-2"):
        tup.fancy_upsample(torch.as_tensor(s), 4, 1)
    with pytest.raises(ValueError, match="factors 1-2"):
        jup.fancy_upsample(jnp.asarray(s[0]), 4, 1)


def test_h2v2_keeps_the_column_sums_unrounded():
    # libjpeg's h2v2 rounds once (biases 8/7, >> 4); two rounded passes
    # would differ on these samples
    s = torch.tensor([[[0, 255], [255, 2]]], dtype=torch.int32)
    once = tup.fancy_upsample(s, 2, 2)
    twice = tup.fancy_upsample(tup.fancy_upsample(s, 1, 2), 2, 1)
    assert not torch.equal(once, twice)
    np.testing.assert_array_equal(
        once[0].numpy(), toracle.fancy_upsample(s[0].numpy(), 2, 2))
