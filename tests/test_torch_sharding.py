"""tpujpeg_torch several devices == the JAX package's sharded decode.

The JAX package runs on its 8 virtual CPU devices (tests/conftest.py),
the port on meshes of the CPU named n times (torch has no virtual CPU
devices; a mesh may repeat a device).  Inputs from conftest.make_jpeg /
make_jpeg_rst with fixed seeds, 24 x 32 to 432 x 432 px.  Every
comparison is `==` (integers, tolerance 0) but one, stated: outputs of
the f32 colour (exact=False) agree by
tests/test_torch_subsampled.py::_pixels_agree, the risk masks within 2
pixels or 1% and the pixels equal wherever neither side flags one,
because the risk flag is float32 arithmetic that XLA:CPU and PyTorch
contract differently.

  * make_mesh and stripe_geometry field-equal to JAX's;
  * compiled_batch_decoder (plain and bucketed with extents) against
    JAX's on make_mesh(n_batch=8), exact against the oracle, the
    divisibility error, no transfer between shards;
  * decode_striped on 4:4:4, 4:2:0 box on a (2, 4) mesh, 4:2:0 fancy
    (the halo), 4:2:2 fancy against JAX's decode_striped and the oracle,
    with the halo and gather counts;
  * BatchDecoder(mesh=) on a four-device mesh against JAX's engine on
    make_mesh(n_batch=4): a restart chunk on backends "fsm" and
    "gather", a no-restart (speculative), a bucketed and a host chunk,
    outputs and counters equal;
  * the committed 8192 x 8192 4:2:0 stream's header: 512 MCU rows, so
    8 stripes of 64.
"""

import numpy as np
import pytest
import torch

from tpujpeg import pipeline as jpipe
from tpujpeg.io.parser import parse as jparse
from tpujpeg.oracle import decoder as joracle
from tpujpeg.parallel import sharding as jshard
from tpujpeg.runtime.batch import BatchDecoder as JaxBatchDecoder
from tpujpeg_torch import pipeline as tpipe
from tpujpeg_torch.io.parser import parse
from tpujpeg_torch.parallel import sharding
from tpujpeg_torch.runtime.batch import BatchDecoder

from conftest import make_jpeg, make_jpeg_rst
from test_torch_buckets import _stats_equal
from test_torch_subsampled import _pixels_agree


def _cpu_mesh(n_batch, n_stripe=1):
    return sharding.make_mesh(n_batch, n_stripe,
                              devices=["cpu"] * (n_batch * n_stripe))


# ---------------------------------------------------------------------------
# meshes and geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_batch,n_stripe",
                         [(8, 1), (2, 4), (None, 2), (1, 8), (3, 1)])
def test_make_mesh_field_equal(n_batch, n_stripe):
    # device i of the port's list in the place of JAX's device id i
    # (torch names a card without needing one)
    mesh = sharding.make_mesh(n_batch, n_stripe,
                              devices=[f"cuda:{i}" for i in range(8)])
    jmesh = jshard.make_mesh(n_batch, n_stripe)
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.devices.shape == jmesh.devices.shape
    assert mesh.devices.size == jmesh.devices.size
    assert [d.index for d in mesh.devices.flat] == \
        [d.id for d in jmesh.devices.flat]


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sharding.make_mesh()


def test_make_mesh_repeats_devices_and_refuses_too_few():
    mesh = _cpu_mesh(2, 4)
    assert mesh.shape == {"batch": 2, "stripe": 4}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh == _cpu_mesh(2, 4) and hash(mesh) == hash(_cpu_mesh(2, 4))
    assert mesh != _cpu_mesh(4, 2)
    with pytest.raises(ValueError, match="need 8 devices"):
        sharding.make_mesh(4, 2, devices=["cpu"] * 7)


@pytest.mark.parametrize("subsampling,n", [(0, 4), (2, 2), (1, 4)])
def test_stripe_geometry_field_equal(subsampling, n):
    img = parse(make_jpeg(shape=(64, 48), subsampling=subsampling, seed=1))
    geom = tpipe.Geometry.of(img)
    jgeom = jpipe.Geometry.of(jparse(make_jpeg(
        shape=(64, 48), subsampling=subsampling, seed=1)))
    assert tuple(sharding.stripe_geometry(geom, n)) == \
        tuple(jshard.stripe_geometry(jgeom, n))
    with pytest.raises(ValueError, match="not divisible"):
        sharding.stripe_geometry(geom, 3)


# ---------------------------------------------------------------------------
# batch-sharded decode
# ---------------------------------------------------------------------------


def _batch(shape=(24, 32), subsampling=0, n=8, seed=100):
    datas = [make_jpeg(shape=shape, quality=88, subsampling=subsampling,
                       seed=seed + i) for i in range(n)]
    plans = [jpipe.build_plan(jparse(d)) for d in datas]
    geom = plans[0][0]
    assert all(p[0] == geom for p in plans)
    return (datas, geom, np.stack([p[1] for p in plans]),
            np.stack([p[2] for p in plans]))


def test_batch_decoder_matches_jax():
    datas, geom, coeffs, quant = _batch()
    jrgb, jrisk, jtotal = jshard.compiled_batch_decoder(
        geom, jshard.make_mesh(n_batch=8))(coeffs, quant)
    sharding.reset_transfers()
    fn = sharding.compiled_batch_decoder(tpipe.Geometry(geom), _cpu_mesh(8))
    rgb, risk, total = fn(torch.as_tensor(coeffs), torch.as_tensor(quant))
    assert total == int(jtotal) == 8 * 24 * 32
    assert len(rgb) == len(risk) == 8
    assert all(r.shape == (1, 3, 24, 32) for r in rgb)
    _pixels_agree(torch.cat(rgb), torch.cat(risk), jrgb, jrisk, geom.width)
    # strict: the exact colour, equal to the oracle everywhere
    rgb, risk, _ = sharding.compiled_batch_decoder(
        tpipe.Geometry(geom), _cpu_mesh(4), exact=True)(
            torch.as_tensor(coeffs), torch.as_tensor(quant))
    assert risk is None and len(rgb) == 4
    got = torch.cat(rgb).permute(0, 2, 3, 1).numpy()
    for g, d in zip(got, datas):
        np.testing.assert_array_equal(g, joracle.decode(jparse(d)))
    assert sharding.TRANSFERS == {"halo": 0, "gather": 0}


def test_bucketed_batch_decoder_matches_jax():
    # four sizes of one 4:2:0 bucket, fancy upsampling: the extents move
    # the filter's bottom and right edges to each image's real size
    shapes = [(40, 48), (33, 57), (48, 40), (35, 41)] * 2
    datas = [make_jpeg(shape=s, quality=88, subsampling=2, seed=200 + i)
             for i, s in enumerate(shapes)]
    imgs = [jparse(d) for d in datas]
    bucket = jpipe.bucket_geometry(jpipe.Geometry.of(imgs[0]))
    coeffs = np.zeros((len(imgs), bucket.n_blocks, 64), np.int32)
    for i, im in enumerate(imgs):
        geom, c, _ = jpipe.build_plan(im)
        assert jpipe.bucket_geometry(geom) == bucket
        jpipe.pad_coeffs_to_bucket(geom, bucket, c, coeffs[i])
    quant = np.stack([jpipe.build_plan(im)[2] for im in imgs])
    ext = np.asarray([(im.mcus_y, im.mcus_x) for im in imgs], np.int32)
    jrgb, jrisk, jtotal = jshard.compiled_batch_decoder(
        bucket, jshard.make_mesh(n_batch=8), fancy=True, bucketed=True)(
            coeffs, quant, ext)
    fn = sharding.compiled_batch_decoder(
        tpipe.Geometry(bucket), _cpu_mesh(4), fancy=True, bucketed=True)
    rgb, risk, total = fn(torch.as_tensor(coeffs), torch.as_tensor(quant),
                          torch.as_tensor(ext))
    assert total == int(jtotal)
    _pixels_agree(torch.cat(rgb), torch.cat(risk), jrgb, jrisk, bucket.width)
    with pytest.raises(ValueError, match="extents"):
        fn(torch.as_tensor(coeffs), torch.as_tensor(quant))


def test_batch_decoder_requires_divisibility():
    _, geom, coeffs, quant = _batch(n=6)
    fn = sharding.compiled_batch_decoder(tpipe.Geometry(geom), _cpu_mesh(4))
    with pytest.raises(ValueError, match="not divisible"):
        fn(torch.as_tensor(coeffs), torch.as_tensor(quant))


# ---------------------------------------------------------------------------
# stripe-sharded decode
# ---------------------------------------------------------------------------

# (case, shape, PIL subsampling, fancy, mesh (n_batch, n_stripe), halo
# copies: 2 * (n - 1) per chroma plane filtered vertically)
STRIPES = [
    ("444", (64, 48), 0, False, (1, 8), 0),
    ("420_box", (128, 32), 2, False, (2, 4), 0),
    ("420_fancy", (128, 48), 2, True, (1, 8), 2 * 2 * 7),
    ("422_fancy", (64, 48), 1, True, (1, 4), 0),
]


@pytest.mark.parametrize("case,shape,subsampling,fancy,mesh,halo", STRIPES,
                         ids=[c[0] for c in STRIPES])
def test_decode_striped_matches_jax_and_oracle(case, shape, subsampling,
                                               fancy, mesh, halo):
    data = make_jpeg(shape=shape, quality=90, subsampling=subsampling,
                     seed=42)
    sharding.reset_transfers()
    got = sharding.decode_striped(parse(data), mesh=_cpu_mesh(*mesh),
                                  fancy=fancy)
    assert sharding.TRANSFERS == {"halo": halo, "gather": mesh[1]}
    want = jshard.decode_striped(jparse(data), mesh=jshard.make_mesh(*mesh),
                                 fancy=fancy)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, joracle.decode(jparse(data),
                                                      fancy=fancy))


def test_decode_striped_f32_gathers_risk_too():
    # strict=False: the f32 colour, its risk bits gathered beside rgb
    data = make_jpeg(shape=(128, 48), quality=90, subsampling=2, seed=43)
    sharding.reset_transfers()
    got = sharding.decode_striped(parse(data), mesh=_cpu_mesh(1, 4),
                                  strict=False, fancy=True)
    assert sharding.TRANSFERS == {"halo": 2 * 2 * 3, "gather": 2 * 4}
    want = sharding.decode_striped(parse(data), mesh=_cpu_mesh(1, 1),
                                   strict=False, fancy=True)
    np.testing.assert_array_equal(got, want)


def test_stripe_requires_divisibility():
    data = make_jpeg(shape=(24, 32), quality=88, seed=44)  # 3 MCU rows
    with pytest.raises(ValueError, match="not divisible"):
        sharding.decode_striped(parse(data), mesh=_cpu_mesh(4, 2))


# ---------------------------------------------------------------------------
# the engine on a mesh
# ---------------------------------------------------------------------------


def _rst_rows(shape, seed):
    return make_jpeg_rst(shape=shape, rst_interval=-(-shape[1] // 8),
                         seed=seed)


# (case, engine arguments, streams, backend of both engines)
ENGINE = [
    ("restart", dict(backend="fsm", chunk_size=4),
     lambda: [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s)
              for s in range(5)], "fsm"),
    ("gather", dict(backend="gather", chunk_size=4),
     lambda: [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s)
              for s in range(5)], "gather"),
    # 54 x 54 MCUs x 3 = 8,748 blocks: past one lane, so speculative
    ("spec", dict(backend="fsm", chunk_size=4),
     lambda: [make_jpeg(shape=(432, 432), seed=s) for s in (7, 8)],
     "fsm-spec-sync"),
    ("bucketed", dict(backend="fsm", chunk_size=4, size_buckets=True),
     lambda: [_rst_rows(s, i) for i, s in
              enumerate([(64, 80), (60, 88), (57, 41)])], "host-bucketed"),
    ("host", dict(backend="host", chunk_size=3),
     lambda: [make_jpeg(shape=(48, 64), subsampling=2, seed=s)
              for s in range(5)], "host"),
]


@pytest.mark.parametrize("case,kwargs,make,backend", ENGINE,
                         ids=[c[0] for c in ENGINE])
def test_engine_on_a_mesh_matches_jax(case, kwargs, make, backend):
    datas = make()
    dec = BatchDecoder(mesh=_cpu_mesh(4), **kwargs)
    out = dec.decode(datas)
    dec.close()
    jdec = JaxBatchDecoder(mesh=jshard.make_mesh(n_batch=4), **kwargs)
    jout = jdec.decode(datas)
    assert dec.stats.backend == backend, dec.stats.as_dict()
    _stats_equal(dec.stats, jdec.stats)
    for g, j in zip(out, jout):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, j)


def test_engine_mesh_sets_the_device():
    mesh = _cpu_mesh(2)
    dec = BatchDecoder(mesh=mesh, device="cpu")
    assert dec.device == torch.device("cpu") and dec.mesh == mesh
    dec.close()
    with pytest.raises(ValueError, match="first device"):
        BatchDecoder(mesh=sharding.make_mesh(2, devices=["cuda:1"] * 2),
                     device="cuda:0")
    # without a mesh: a one-device mesh of `device`
    dec = BatchDecoder(device="cpu")
    assert dec.mesh.devices.size == 1
    dec.close()


def test_committed_huge_stream_splits_into_eight_stripes():
    import os

    from conftest import FIXTURES

    img = parse(open(os.path.join(FIXTURES, "huge8192_420.jpg"),
                     "rb").read())
    assert (img.width, img.height, img.mcus_y, img.restart_interval) == \
        (8192, 8192, 512, 0)
    assert tpipe.Geometry.of(img).comps == ((2, 2, 0), (1, 1, 1), (1, 1, 2))
    assert sharding.stripe_geometry(tpipe.Geometry.of(img), 8).mcus_y == 64
