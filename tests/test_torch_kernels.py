"""tpujpeg_torch CUDA kernels == their plain PyTorch versions, bit for bit.

Each kernel runs only on a CUDA card (there is no interpret mode), so
these tests carry the `gpu` marker and skip without one.  They import
nothing of JAX, so they also run on a machine without it:

    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu

Inputs are the committed restart corpus (tests/fixtures/rst640), a
0xFF-tailed malformed copy of it, and seeded numpy data.
"""

import os

import numpy as np
import pytest
import torch

from tpujpeg.io.parser import parse_file
from tpujpeg_torch.ops import fsm, materialize, pixels
from tpujpeg_torch.pipeline import Geometry, soa_planes

pytestmark = pytest.mark.gpu

CORPUS = os.path.join(os.path.dirname(__file__), "fixtures", "rst640")


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
    plan = fsm.build_plan(use)
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


def test_place_events_kernel_equals_plain(cuda):
    rng = np.random.default_rng(5)
    N, max_blk, L = 700, 47, 256
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
    ev_d = torch.as_tensor(ev).to(cuda)
    err_k = torch.zeros(L, dtype=torch.bool, device=cuda)
    err_p = torch.zeros(L, dtype=torch.bool, device=cuda)
    got = materialize.place_events(ev_d, M, err_k)
    want = materialize.place_events_plain(ev_d, M, err_p)
    torch.cuda.synchronize()
    assert got.dtype == torch.int16 and torch.equal(got, want)
    assert torch.equal(err_k, err_p)
    assert int(got[0, 1]) == -2048 and bool(err_k[2]) and not bool(err_k[1])


@pytest.mark.parametrize("extreme", [False, True])
def test_pixels_kernel_equals_plain(cuda, imgs, extreme):
    from tpujpeg.runtime.host import entropy_decode

    geom = Geometry.of(imgs[0])
    coeffs = np.stack([entropy_decode(im) for im in imgs])
    quant = np.stack([
        np.stack([im.quant_tables[c.quant_id] for c in im.components])
        for im in imgs
    ]).astype(np.int32)
    dc = None
    if extreme:
        # int ranges at their limits: the int32 wraparound must match
        rng = np.random.default_rng(2)
        coeffs = rng.integers(-1023, 1024, coeffs.shape).astype(np.int16)
        coeffs[..., 0] = rng.integers(-2047, 2048, coeffs.shape[:2])
        quant = rng.integers(1, 256, quant.shape).astype(np.int32)
        dc = torch.as_tensor(
            rng.integers(-2047, 2048, coeffs.shape[:2]).astype(np.int32)
        ).to(cuda)
    zp, q, dcp = soa_planes(
        geom, torch.as_tensor(coeffs).to(cuda), torch.as_tensor(quant).to(cuda),
        dc,
    )
    got = pixels.rgb_soa_fused(zp, q, dcp)
    want = pixels.rgb_soa_fused_plain(zp, q, dcp)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.int16 and torch.equal(g, w)
