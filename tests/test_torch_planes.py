"""The port's subsampled pixel stage on the CPU (ops/planes.py): the plain
plane path that the planes kernel (csrc/planes.cu) is held to on the card
(tests/test_torch_kernels.py, same cases: tests/plane_cases.py) against
the JAX package's device_decode_fn, the wrapper's routing and refusals,
and the engine's count of chunks that launched the kernel.

Against JAX: the f32 colour's pixels and risk bits are compared whole,
by the rule of tests/test_torch_subsampled.py::_pixels_agree (the risk
flag is float32 arithmetic that XLA:CPU and PyTorch may contract
differently: the masks may differ in at most 2 pixels or 1%, pixels are
equal wherever neither side flags one); the exact colour equals JAX's
pixels wherever JAX flags none (the JAX package repairs the flagged ones
on the host).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujpeg import pipeline as jpipe
from tpujpeg.ops.color import unpack_mask
from tpujpeg_torch import pipeline as tpipe
from tpujpeg_torch.io.parser import parse
from tpujpeg_torch.ops import planes
from tpujpeg_torch.pipeline import Geometry
from tpujpeg_torch.runtime.batch import BatchDecoder

from plane_cases import PLANE_CASES, plane_case


def _jax(geom, coeffs, quant, dc, ext, fancy):
    jgeom = jpipe.Geometry(tuple(geom))

    def one(c, q, d, e):
        return jpipe.device_decode_fn(jgeom, c, q, fancy=fancy, dc=d,
                                      extents=e)

    axes = (0, 0, None if dc is None else 0, None if ext is None else 0)
    rgb, risk = jax.jit(jax.vmap(one, in_axes=axes))(
        jnp.asarray(coeffs), jnp.asarray(quant),
        None if dc is None else jnp.asarray(dc),
        None if ext is None else jnp.asarray(ext))
    return np.asarray(rgb), np.asarray(risk)


def _torch(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("fancy", [False, True], ids=["box", "fancy"])
@pytest.mark.parametrize("case", PLANE_CASES)
def test_plane_path_matches_jax(case, fancy):
    geom, coeffs, quant, dc, ext = plane_case(case)
    geom = Geometry(geom)
    j_rgb, j_risk = _jax(geom, coeffs, quant, dc, ext, fancy)
    args = (geom, _torch(coeffs), _torch(quant), fancy, _torch(dc),
            _torch(ext))
    rgb, risk = planes.planes_rgb(*args)
    exact, none = planes.planes_rgb(*args, exact=True)
    rgb, risk, exact = rgb.numpy(), risk.numpy(), exact.numpy()
    assert none is None
    assert rgb.dtype == exact.dtype == np.uint8
    assert rgb.shape == exact.shape == j_rgb.shape == (
        coeffs.shape[0], 3, geom.height, geom.width)
    assert risk.dtype == np.uint8 and risk.shape == j_risk.shape
    for b in range(rgb.shape[0]):
        mine = unpack_mask(risk[b], geom.width)
        theirs = unpack_mask(j_risk[b], geom.width)
        assert int((mine != theirs).sum()) <= max(2, int(theirs.sum()) // 100)
        np.testing.assert_array_equal(rgb[b][:, ~(mine | theirs)],
                                      j_rgb[b][:, ~(mine | theirs)])
        np.testing.assert_array_equal(exact[b][:, ~theirs],
                                      j_rgb[b][:, ~theirs])


@pytest.mark.parametrize("exact", [False, True], ids=["f32", "exact"])
@pytest.mark.parametrize("case", ["rst420-int16-dc-b1", "mixed420-bucket-b5",
                                  "422-int16-dc-ext-b33"])
def test_planes_rgb_on_the_cpu_is_the_plain_plane_path(case, exact):
    # CPU tensors take the plain path as the pipeline composes it, and
    # device_decode_fn routes a subsampled geometry there
    geom, coeffs, quant, dc, ext = plane_case(case)
    geom = Geometry(geom)
    c, q, d, e = (_torch(a) for a in (coeffs, quant, dc, ext))
    want = tpipe.planes_to_rgb(geom, tpipe.upsample_planes(
        geom, tpipe.decode_subsampled_planes(geom, c, q, d), True, e), exact)
    for got in (planes.planes_rgb(geom, c, q, True, d, e, exact),
                tpipe.device_decode_fn(geom, c, q, fancy=True, dc=d,
                                       extents=e, exact=exact)):
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == exact
        if not exact:
            assert torch.equal(got[1], want[1])


def test_planes_rgb_refuses_what_the_kernel_does_not_take():
    # the CUDA branch's checks, on CPU tensors: dtype, shapes, devices,
    # component count, and planes that do not cover the raster
    geom, coeffs, quant, dc, ext = plane_case("422-int16-dc-ext-b33")
    geom = Geometry(geom)
    c, q, d, e = (torch.as_tensor(a) for a in (coeffs, quant, dc, ext))
    with pytest.raises(TypeError, match="coefficients torch.int64"):
        planes._check(geom, c.to(torch.int64), q, d, e)
    for bad in ((c[:, 1:], q, d, e), (c, q[:, :2], d, e),
                (c, q, d[:, 1:], e), (c, q, d, e[:, :1]),
                (c, q[:-1], d, e)):
        with pytest.raises(ValueError, match="planes_rgb: bad"):
            planes._check(geom, *bad)
    with pytest.raises(ValueError, match="tensors on cpu and meta"):
        planes._check(geom, c, q, d, e.to("meta"))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        planes._check(geom, c, q, d, e)
    two = Geometry(tuple(geom)[:4] + (geom.comps[:2],))
    with pytest.raises(ValueError, match="2 components"):
        planes._check(two, c, q[:, :2], d, e)
    wide = Geometry((geom.width + 64,) + tuple(geom)[1:])
    with pytest.raises(ValueError, match="does not cover"):
        planes._components(wide)
    assert planes._components(geom)[1] == sum(
        geom.mcus_x * h * 8 * geom.mcus_y * v * 8 for h, v, _ in geom.comps)


def _pil420(shape, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, shape + (3,), dtype=np.uint8)).save(
        buf, "JPEG", quality=90, subsampling=2)
    return buf.getvalue()


@pytest.mark.parametrize("backend", ["host", "fsm"])
def test_batch_stats_count_no_plane_kernel_chunk_on_the_cpu(backend):
    datas = [_pil420((40, 56), s) for s in (1, 2, 3)]
    dec = BatchDecoder(backend=backend, chunk_size=2, device="cpu",
                       fancy=True)
    got = dec.decode(datas)
    dec.close()
    assert dec.stats.chunks == 2 and dec.stats.plane_kernel_chunks == 0
    assert "plane_kernel_chunks" in dec.stats.as_dict()
    for g, d in zip(got, datas):
        np.testing.assert_array_equal(
            g, tpipe.decode(parse(d), device="cpu", fancy=True))
