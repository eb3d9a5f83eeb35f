"""The plain reference equals the program's strict decode on the CPU.

At tiny sizes, the reference's RGB (from the encoder's quantised
coefficients) equals the program's CPU route with each configuration's
decoder settings (`strict=True`), and the program's numpy oracle.  The
benchmark's runs themselves refuse the CPU.
"""

import numpy as np
import pytest

from jpegbench import check, corpus, encoder
from jpegbench.reference import pixels
from tpujpeg_torch.constants import ZIGZAG_TO_NATURAL
from tpujpeg_torch.io.parser import parse
from tpujpeg_torch.oracle import decoder as oracle
from tpujpeg_torch.runtime.batch import BatchDecoder

from conftest import tiny

SEED = 2**33 + 5


def test_zigzag_is_the_programs():
    assert np.array_equal(np.argsort(ZIGZAG_TO_NATURAL), pixels.ZIGZAG)
    assert np.array_equal(encoder.ZIGZAG, pixels.ZIGZAG)


@pytest.mark.parametrize("name", ["rst444", "ilsvrc420"])
def test_reference_equals_the_cpu_route(name):
    cell, config, traffic, _ = tiny(f"{name}.loader128", per_call=None,
                                    sizes=[{"count": 3, "width": 45,
                                            "height": 29},
                                           {"count": 1, "width": 16,
                                            "height": 16}])
    streams = corpus.build(config, SEED)
    dec = BatchDecoder(device="cpu", **config["decoder"])
    try:
        outs = dec.decode([s.data for s in streams], fetch=True,
                          on_error="raise")
    finally:
        dec.close()
    for s, out in zip(streams, outs):
        ref = check.reference_rgb(config, SEED, s.index)
        assert ref.shape == (s.height, s.width, 3)
        assert np.array_equal(out, ref), s.index
        orc = oracle.decode(parse(s.data), fancy=config["decoder"]["fancy"])
        assert np.array_equal(orc, ref), s.index


@pytest.mark.parametrize("fancy", [False, True])
@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4"])
def test_reference_equals_the_oracle(sampling, fancy):
    content = {"alpha": 1.0, "sigma": 70.0, "chroma": 0.6, "noise": 3.0}
    for w, h in ((33, 47), (80, 8)):
        rgb = corpus.picture(5, w, w, h, content)
        data, _ = encoder.encode(rgb, sampling, 95, "none")
        zz = encoder.coefficients(rgb, sampling, 95)
        quant = encoder.quant_tables(95)[:, encoder.ZIGZAG]
        ref = pixels.decode(zz, quant, w, h, sampling, fancy)
        assert np.array_equal(ref, oracle.decode(parse(data), fancy=fancy))
