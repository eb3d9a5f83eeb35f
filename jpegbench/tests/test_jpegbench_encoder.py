"""The benchmark's encoder makes streams that decoders read as it meant.

Every stream (4:2:0 and 4:4:4, odd sizes, with and without restart
markers after every MCU row) parses with the program's parser, Huffman
decodes there to exactly the encoder's quantised coefficients, decodes
with PIL close to its source picture, and carries libjpeg's own Annex K
tables at its quality.
"""

import io

import numpy as np
import pytest

from jpegbench import corpus, encoder
from tpujpeg_torch.io.parser import parse
from tpujpeg_torch.oracle import decoder as oracle

CONTENT = {"alpha": 1.2, "sigma": 50.0, "chroma": 0.35, "noise": 1.0}
CASES = [(w, h, s, r) for w, h in ((37, 23), (41, 17), (64, 48), (9, 70))
         for s in ("4:2:0", "4:4:4") for r in ("none", "mcu_row")]


@pytest.mark.parametrize("w,h,sampling,restart", CASES)
def test_stream_parses_to_the_encoders_coefficients(w, h, sampling, restart):
    rgb = corpus.picture(11, 3, w, h, CONTENT)
    data, n_scan = encoder.encode(rgb, sampling, 90, restart)
    img = parse(data)
    geom = encoder.Geometry(w, h, sampling)
    assert (img.width, img.height, img.sampling) == (w, h, sampling)
    assert img.scan_data.size == n_scan
    if restart == "mcu_row":
        assert img.restart_interval == geom.mcus_x
        assert img.n_segments() == geom.mcus_y
    else:
        assert img.restart_interval == 0
    zz = encoder.coefficients(rgb, sampling, 90)
    assert zz.shape == (geom.n_blocks, 64)
    assert np.array_equal(oracle.entropy_decode(img), zz)


@pytest.mark.parametrize("w,h,sampling,restart", CASES)
def test_stream_decodes_with_pil(w, h, sampling, restart):
    Image = pytest.importorskip("PIL.Image")
    rgb = corpus.picture(12, 5, w, h, CONTENT)
    data, _ = encoder.encode(rgb, sampling, 90, restart)
    out = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert out.shape == rgb.shape
    err = np.abs(out.astype(int) - rgb.astype(int))
    assert err.mean() < 12


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4"])
def test_tables_are_libjpegs_at_the_quality(sampling):
    """DQT and DHT payloads equal what libjpeg (through PIL, without
    optimised tables) writes at quality 90."""
    Image = pytest.importorskip("PIL.Image")
    rgb = corpus.picture(13, 1, 48, 32, CONTENT)
    ours, _ = encoder.encode(rgb, sampling, 90, "none")
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=90, optimize=False,
                              subsampling=2 if sampling == "4:2:0" else 0)
    theirs = buf.getvalue()

    def payloads(data, marker):
        out, pos = [], 2
        while data[pos + 1] != 0xDA:
            n = int.from_bytes(data[pos + 2:pos + 4], "big")
            if data[pos + 1] == marker:
                out.append(data[pos + 4:pos + 2 + n])
            pos += 2 + n
        return b"".join(out)

    assert payloads(ours, 0xDB) == payloads(theirs, 0xDB)
    assert payloads(ours, 0xC4) == payloads(theirs, 0xC4)


def test_corpus_sizes_follow_the_seed():
    """Every seed's corpus has the configuration's counts of each fixed
    size; the sizes drawn from a range follow the seed."""
    from jpegbench import harness

    config = harness.load_json(harness.BENCH / "configs" / "ilsvrc420.json")
    a = corpus.picture_sizes(config, 1)
    b = corpus.picture_sizes(config, 2**33 + 1)
    assert len(a) == len(b) == config["images"] == 256
    assert a == corpus.picture_sizes(config, 1)
    assert a[:192] == b[:192]
    assert a[192:] != b[192:]
    assert a.count((500, 500)) >= 64
    for dims in (a, b):
        assert max(max(d) for d in dims) == 500
        assert min(min(d) for d in dims) >= 200


def test_corpus_follows_the_seed():
    """The same seed makes the same streams, another seed other ones."""
    config = {"name": "t", "images": 3, "sampling": "4:4:4", "quality": 90,
              "restart": "mcu_row", "content": CONTENT,
              "sizes": [{"count": 2, "width": 24, "height": 16},
                        {"count": 1, "uniform": [8, 40]}]}
    a = corpus.build(config, 7)
    assert [s.data for s in a] == [s.data for s in corpus.build(config, 7)]
    b = corpus.build(config, 2**33 + 7)
    assert all(x.data != y.data for x, y in zip(a, b))
    rgb = corpus.regenerate(config, 7, 1)
    assert encoder.encode(rgb, "4:4:4", 90, "mcu_row")[0] == a[1].data


def test_pictures_follow_the_seed():
    a = corpus.picture(1, 0, 40, 30, CONTENT)
    assert np.array_equal(a, corpus.picture(1, 0, 40, 30, CONTENT))
    assert not np.array_equal(a, corpus.picture(2, 0, 40, 30, CONTENT))
    assert not np.array_equal(a, corpus.picture(1, 1, 40, 30, CONTENT))
    big = 2**33 + 123
    assert corpus.picture(big, 0, 8, 8, CONTENT).shape == (8, 8, 3)
