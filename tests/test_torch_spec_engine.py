"""The speculative route of tpujpeg_torch's engine against the benchmark's
plain reference, on the CPU.

A seeded 4:4:4 corpus without restart markers, made by the benchmark's
own encoder (jpegbench/encoder.py, content from jpegbench/corpus.py as
the `photo444_640` configuration draws it, at small sizes), decoded by
BatchDecoder(backend="fsm", device="cpu", strict=True); every picture
must equal (`==`) jpegbench/reference/pixels.py's decode of the
encoder's own quantised coefficients, which reads no stream.  Cases: the
single pass ("fsm-spec-sync"), the Jacobi fallback after a forced
SpecSyncMiss ("fsm-spec"), and the retry at STEPS_SAFE after a forced
envelope latch.  Small pictures reach the route by refusing the lane
plan; `photo444_640`'s own geometry is past the lane plan's block field,
shown from its parsed headers alone.
"""

import json
import os

import numpy as np
import pytest

from jpegbench import corpus, encoder
from jpegbench.reference import pixels
from tpujpeg_torch import JpegError
from tpujpeg_torch.io.parser import parse
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.runtime.batch import BatchDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "jpegbench", "configs", "photo444_640.json")
SEED = 3222000007          # past 32 signed bits, as the benchmark's seeds


@pytest.fixture(scope="module")
def config():
    with open(CONFIG) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def photos(config):
    """Three pictures of the configuration's sampling, quality, restart
    policy and content at small sizes: (stream, reference RGB) each."""
    out = []
    for i, (w, h) in enumerate([(64, 48), (64, 48), (64, 48)]):
        rgb = corpus.picture(SEED, i, w, h, config["content"])
        data, _ = encoder.encode(rgb, config["sampling"], config["quality"],
                                 config["restart"])
        zz = encoder.coefficients(rgb, config["sampling"], config["quality"])
        quant = encoder.quant_tables(config["quality"])[:, encoder.ZIGZAG]
        out.append((data, pixels.decode(zz, quant, w, h, config["sampling"],
                                        config["decoder"]["fancy"])))
    return out


def _refuse_plan(monkeypatch):
    def refuse(imgs, split=True):
        raise JpegError("no lane plan")

    monkeypatch.setattr(tfsm, "build_plan", refuse)


def _force_miss(monkeypatch):
    def miss(pending):
        raise tfsm.SpecSyncMiss("forced")

    monkeypatch.setattr(tfsm, "spec_sync_resolve_host", miss)


def _force_envelope(monkeypatch):
    monkeypatch.setattr(tfsm, "STEPS_PRODUCTION", (1, 1))


# case -> (set-up, the route that returns the chunk, misses, K retries)
CASES = {
    "single_pass": (None, "fsm-spec-sync", 0, 0),
    "jacobi": (_force_miss, "fsm-spec", 1, 0),
    "steps_safe": (_force_envelope, "fsm-spec-sync", 0, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_route_equals_the_plain_reference(case, photos, config,
                                               monkeypatch):
    setup, route, misses, k_retries = CASES[case]
    _refuse_plan(monkeypatch)
    if setup is not None:
        setup(monkeypatch)
    args = dict(config["decoder"], chunk_size=len(photos))
    dec = BatchDecoder(device="cpu", **args)
    try:
        got = dec.decode([d for d, _ in photos], on_error="skip")
    finally:
        dec.close()
    st = dec.stats
    assert st.route_chunks == {route: 1}, st.as_dict()
    assert st.spec_sync_misses == misses
    assert st.fsm_k_retries == k_retries
    assert st.fsm_envelope_fallbacks == st.fsm_malformed_fallbacks == 0
    assert st.failures == {} and st.repaired_pixels == 0
    # a slot capacity is taken on the single pass only (Jacobi and the
    # classic materialize have none)
    assert st.spec_slot_chunks == (route == "fsm-spec-sync"
                                   and bool(dec._slot_c))
    for out, (_, ref) in zip(got, photos):
        assert out.dtype == np.uint8 and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)


def test_photo444_640_is_past_the_lane_plan(config):
    # the configuration's own geometry, from parsed headers alone: one
    # lane an image would need 19,200 blocks, past the packed event's
    # block field, so every chunk of the cell takes the speculative route
    (size,) = config["sizes"]
    geom = encoder.Geometry(size["width"], size["height"],
                            config["sampling"])
    ri = encoder.restart_interval_of(geom, config["restart"])
    img = parse(encoder.headers(geom, config["quality"], ri)
                + bytes(64) + b"\xff\xd9")
    assert (img.width, img.height, img.restart_interval) == (640, 640, 0)
    assert img.n_mcus * img.blocks_per_mcu == geom.n_blocks == 19_200
    assert geom.n_blocks > tfsm.MAX_BLOCKS_PER_LANE
    with pytest.raises(JpegError, match="packed events"):
        tfsm.build_plan([img], split=False)
