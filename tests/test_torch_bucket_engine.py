"""The bucket chain of tpujpeg_torch's engine ("fsm-bucketed") against the
benchmark's plain reference, on the CPU, and the benchmark's readers of
its counters.

A seeded 4:2:0 corpus with a restart marker every MCU row, made by the
benchmark's own encoder (jpegbench/encoder.py, content from
jpegbench/corpus.py as the `ilsvrc420_rst` configuration draws it, at
small sizes that are no multiples of 16, in two size-class buckets),
decoded by BatchDecoder(backend="fsm", size_buckets=True, fancy=True,
strict=True, device="cpu"); every picture must equal (`==`)
jpegbench/reference/pixels.py's decode of the encoder's own quantised
coefficients, which reads no stream.  Cases: the bucket chain, the same
pictures without restart markers (the host-bucketed route), and the
retry at STEPS_SAFE after a forced envelope latch; the bucket counters
in each.  The configuration's own sizes fit the chain, shown from their
headers alone.  Then each reader of the bucket counters and of the two
rooflines on a hand-made context, and the cell's harness run at tiny
sizes.
"""

import copy
import importlib.util
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jpegbench import corpus, encoder, harness
from jpegbench.devtrace import Trace
from jpegbench.reference import pixels
from tpujpeg_torch.io.parser import parse
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.pipeline import Geometry, bucket_geometry, bucket_up
from tpujpeg_torch.runtime.batch import BatchDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "ilsvrc420_rst.loader128"
CONFIG = os.path.join(ROOT, "jpegbench", "configs", "ilsvrc420_rst.json")
SEED = 2626000007          # past 32 signed bits, as the benchmark's seeds
# (width, height): MCUs (3, 2), (3, 3), (4, 2) fall in the 4 x 4 bucket,
# (5, 3) and (6, 3) in the 6 x 4 one
SIZES = [(40, 30), (33, 47), (56, 20), (70, 44), (90, 40)]
BUCKETS = {(4, 4): 3, (6, 4): 2}


@pytest.fixture(scope="module")
def config():
    with open(CONFIG) as f:
        return json.load(f)


def _pictures(config, restart):
    """(stream, reference RGB) of each of SIZES."""
    out = []
    for i, (w, h) in enumerate(SIZES):
        rgb = corpus.picture(SEED, i, w, h, config["content"])
        data, _ = encoder.encode(rgb, config["sampling"], config["quality"],
                                 restart)
        zz = encoder.coefficients(rgb, config["sampling"], config["quality"])
        quant = encoder.quant_tables(config["quality"])[:, encoder.ZIGZAG]
        out.append((data, pixels.decode(zz, quant, w, h, config["sampling"],
                                        config["decoder"]["fancy"])))
    return out


@pytest.fixture(scope="module")
def marked(config):
    return _pictures(config, config["restart"])


@pytest.fixture(scope="module")
def unmarked(config):
    return _pictures(config, "none")


def _decode(config, pictures):
    dec = BatchDecoder(device="cpu", **config["decoder"])
    try:
        got = dec.decode([d for d, _ in pictures], on_error="skip")
    finally:
        dec.close()
    return got, dec.stats


def _bucket_arithmetic():
    """The four counters a call over SIZES should read on the chain."""
    blocks = real = 0
    for w, h in SIZES:
        g = encoder.Geometry(w, h, "4:2:0")
        real += g.n_blocks
        blocks += bucket_up(g.mcus_x) * bucket_up(g.mcus_y) * 6
    return {"bucket_chunks": len(BUCKETS), "bucket_images": len(SIZES),
            "bucket_blocks": blocks, "bucket_real_blocks": real}


def _counters(stats):
    return {k: getattr(stats, k) for k in (
        "bucket_chunks", "bucket_images", "bucket_blocks",
        "bucket_real_blocks")}


def _force_envelope(monkeypatch):
    monkeypatch.setattr(tfsm, "STEPS_PRODUCTION", (1, 1))


# case -> (pictures' fixture, set-up, route, K retries)
CASES = {
    "bucket_chain": ("marked", None, "fsm-bucketed", 0),
    "no_restarts": ("unmarked", None, "host-bucketed", 0),
    "steps_safe": ("marked", _force_envelope, "fsm-bucketed", len(BUCKETS)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bucket_route_equals_the_plain_reference(case, config, request,
                                                 monkeypatch):
    fixture, setup, route, k_retries = CASES[case]
    pictures = request.getfixturevalue(fixture)
    if setup is not None:
        setup(monkeypatch)
    got, st = _decode(config, pictures)
    assert st.route_chunks == {route: len(BUCKETS)}, st.as_dict()
    assert st.chunks == len(BUCKETS)
    assert st.fsm_k_retries == k_retries
    assert st.fsm_envelope_fallbacks == st.fsm_malformed_fallbacks == 0
    assert st.failures == {} and st.repaired_pixels == 0
    for out, (_, ref) in zip(got, pictures):
        assert out.dtype == np.uint8 and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)
    # counted once a chunk launched on the chain, a retry or not, and
    # never where the chunk leaves for host-bucketed
    want = _bucket_arithmetic()
    if route == "host-bucketed":
        want = dict.fromkeys(want, 0)
    assert _counters(st) == want


def test_bucketed_launch_span_names_its_bucket(config, marked, monkeypatch):
    # the spans log as under a profiler, without the profiler's own
    # recording of every CPU op (the plain scans make many)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    got, st = _decode(config, marked)
    launches = [dict(s.attrs) for s in st.spans if s.name == "launch"]
    assert sorted((a["bucket"], a["images"]) for a in launches) == \
        sorted(BUCKETS.items())


def _size_classes(config):
    """Every (width, height) the configuration's sizes can draw, as far
    as the MCU grid tells them apart: the fixed sizes, and each range's
    ends and every multiple of 16 between them on both sides."""
    out = set()
    for e in config["sizes"]:
        if "uniform" in e:
            lo, hi = e["uniform"]
            sides = sorted({lo, hi, *range(-(-lo // 16) * 16, hi + 1, 16)})
            out |= {(w, h) for w in sides for h in sides}
        else:
            out.add((e["width"], e["height"]))
    return sorted(out)


def test_every_size_of_the_configuration_fits_the_chain(config):
    # from headers alone: each size's DRI is one MCU row (k = 1), and a
    # lane of its bucket holds at most the packed event's block field
    for w, h in _size_classes(config):
        geom = encoder.Geometry(w, h, config["sampling"])
        ri = encoder.restart_interval_of(geom, config["restart"])
        # one restart segment a row, 4 bytes of scan each
        scan = b"".join(bytes(4) + bytes([0xFF, 0xD0 + r % 8])
                        for r in range(geom.mcus_y - 1)) + bytes(4)
        img = parse(encoder.headers(geom, config["quality"], ri) + scan
                    + b"\xff\xd9")
        assert tfsm.bucket_lane_k(img) == 1, (w, h)
        bucket = bucket_geometry(Geometry.of(img))
        max_blk = bucket.mcus_x * img.blocks_per_mcu
        assert max_blk <= tfsm.MAX_BLOCKS_PER_LANE, (w, h)


# -- the benchmark's readers -------------------------------------------------

def _reader(name):
    path = os.path.join(ROOT, "jpegbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CALLS = [
    {"chunks": 13, "bucket_chunks": 13, "bucket_images": 128,
     "bucket_blocks": 1000, "bucket_real_blocks": 830},
    {"chunks": 12, "bucket_chunks": 12, "bucket_images": 128,
     "bucket_blocks": 1000, "bucket_real_blocks": 840},
]

COUNTER_WANT = {"bucket_pad_share": 100.0 * (1 - 1670 / 2000),
                "bucket_chunk_images": 256 / 25}


@pytest.mark.parametrize("name", list(COUNTER_WANT))
def test_bucket_counter_reader(name):
    read = _reader(name).read

    def ctx(stats):
        return SimpleNamespace(window=SimpleNamespace(stats=stats))

    assert read(ctx(CALLS)) == pytest.approx(COUNTER_WANT[name])
    # the parent's stats (no bucket counters), the host-bucketed route's
    # (all 0), or no call: nothing to read
    assert read(ctx([{"chunks": 12}, {"chunks": 13}])) is None
    assert read(ctx([dict(c, **dict.fromkeys(
        ("bucket_chunks", "bucket_images", "bucket_blocks",
         "bucket_real_blocks"), 0)) for c in CALLS])) is None
    assert read(ctx([])) is None


def _trace_ctx(op_seconds):
    streams = [SimpleNamespace(scan_bytes=40_000, n_blocks=5_952,
                               width=500, height=375),
               SimpleNamespace(scan_bytes=60_000, n_blocks=6_144,
                               width=333, height=500)]
    trace = Trace(window_s=2.0, busy_s=1.0, op_seconds=op_seconds)
    win = SimpleNamespace(trace=trace, stats=CALLS, calls=[[0, 1], [1, 0]])
    return SimpleNamespace(streams=streams, window=win,
                           device_kind="NVIDIA H100 80GB HBM3",
                           peaks={"cards": {"NVIDIA H100 80GB HBM3":
                                            {"hbm_bytes_per_s": 1e12}}})


OPS = {"void fsm_scan_kernel<1, true, false>": 0.004,
       "void place::scatter_kernel<4>": 0.002,
       "void planes_idct_kernel<short>": 0.001,
       "void planes_colour_kernel<true>": 0.003,
       "void pack_lanes_kernel": 0.5,
       "Memcpy DtoH (Device -> Pinned)": 1.0}

# two calls of both pictures: scan bytes + their own int16 coefficients;
# their own int16 coefficients + RGB at their true size
ROOF_WANT = {
    "bucket_scan_roofline": (2 * (100_000 + 12_096 * 128), 0.006),
    "planes_roofline": (2 * (12_096 * 128 + (500 * 375 + 333 * 500) * 3),
                        0.004),
}


@pytest.mark.parametrize("name", list(ROOF_WANT))
def test_roofline_reader_on_a_hand_made_trace(name):
    read = _reader(name).read
    need, seconds = ROOF_WANT[name]
    assert read(_trace_ctx(OPS)) == pytest.approx(
        100.0 * need / 1e12 / seconds)
    # an unknown card, no trace, none of the kernels: nothing to read
    ctx = _trace_ctx(OPS)
    ctx.device_kind = "cpu"
    assert read(ctx) is None
    ctx = _trace_ctx(OPS)
    ctx.window.trace = None
    assert read(ctx) is None
    assert read(_trace_ctx({"Memcpy DtoH (Device -> Pinned)": 1.0})) is None


def test_cell_runs_on_the_bucket_chain_at_tiny_sizes():
    """The harness's traced run of the cell, cut to tiny pictures in two
    buckets on the CPU: correct, every chunk on the chain, the counter
    readers read and the rooflines (no card) do not."""
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(spec, CELL)
    config = copy.deepcopy(harness.load_json(CONFIG))
    traffic = harness.load_json(os.path.join(
        ROOT, "jpegbench", "traffic", f"{cell['traffic']}.json"))
    config["sizes"] = [{"count": 4, "width": 40, "height": 30},
                       {"count": 4, "width": 90, "height": 40}]
    config["images"] = 8
    traffic.update(images_per_call=8, check_images=8)
    res = harness.run_cell(cell, config, traffic, spec, SEED, 0.5, True,
                           "cpu", time.perf_counter(), workers=1)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    # 4 x (3 x 2 MCUs) in 4 x 4, 4 x (6 x 3) in 6 x 4, 6 blocks an MCU
    assert m["bucket_pad_share"]["value"] == pytest.approx(
        100.0 * (1 - (4 * 6 + 4 * 18) / (4 * 16 + 4 * 24)))
    assert m["bucket_chunk_images"]["value"] == 4.0
    assert "bucket_scan_roofline" not in m and "planes_roofline" not in m
