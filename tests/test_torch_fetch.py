"""The fetch of a chunk's RGB to the host (tpujpeg_torch/runtime/batch._fetch)
and its counters, fetch_chunks and fetch_pinned_hits, with the benchmark's
reader of them (jpegbench/metrics/fetch_pinned_hit_share.py).

On the CPU: `_fetch` equals the plain interleave for one tensor and for
batch shards; every device chunk is counted and none is a pinned hit;
results a caller holds survive its next call; the reader.  On the card
(marker gpu; no JAX is imported here), from the committed 640 x 640
restart streams: the results view a page-locked block, a second call of
the same shape takes its block from the allocator's pool, and the held
results of a call survive the next call:
`TPUJPEG_TEST_TPU=1 python -m pytest tests/test_torch_fetch.py -m gpu`.
"""

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpujpeg_torch.runtime.batch import BatchDecoder, _fetch
from tpujpeg_torch.utils import profiling

from conftest import FIXTURES, make_jpeg_rst

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(rgb, n):
    return rgb[:n].permute(0, 2, 3, 1).contiguous().numpy()


@pytest.mark.parametrize("shards,n", [(1, 5), (1, 3), (2, 5), (3, 5),
                                      (3, 4)])
def test_fetch_equals_the_plain_interleave(shards, n):
    # one tensor, or batch shards of ceil(B / shards) rows, the last one
    # short or not reached (n below B)
    g = torch.Generator().manual_seed(shards * 10 + n)
    B = 6
    rgb = torch.randint(0, 256, (B, 3, 7, 9), dtype=torch.uint8, generator=g)
    per = -(-B // shards)
    src = rgb if shards == 1 else list(rgb.split(per))
    with profiling.call() as rec:
        got = _fetch(src, n)
    assert got.dtype == np.uint8 and got.shape == (n, 7, 9, 3)
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got, _plain(rgb, n))
    assert rec.counts == {"fetch_chunks": 1}


def _rst(seeds, shape=(48, 64)):
    return [make_jpeg_rst(shape=shape, rst_interval=2, seed=s)
            for s in seeds]


def test_fetch_counts_each_device_chunk_and_no_pinned_hit_on_the_cpu():
    datas = _rst(range(1, 6))
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    got = dec.decode(datas)
    stats = dec.stats.as_dict()
    assert stats["chunks"] == 3 and stats["backend"] == "fsm", stats
    assert stats["fetch_chunks"] == 3
    assert stats["fetch_pinned_hits"] == 0
    assert all(g is not None for g in got)
    assert dec.decode(datas, fetch=False) is None
    assert dec.stats.fetch_chunks == 0
    # backend "cpu" decodes on the host: no device chunk to fetch
    cdec = BatchDecoder(backend="cpu", chunk_size=2)
    cdec.decode(datas)
    assert cdec.stats.as_dict()["fetch_chunks"] == 0


def _held_survive(dec, first, second):
    """Call 1's results, held, against call 2 of the same shape: call 1's
    are unchanged and differ from call 2's."""
    held = dec.decode(first)
    kept = [h.copy() for h in held]
    again = dec.decode(second)
    for h, k, a in zip(held, kept, again):
        np.testing.assert_array_equal(h, k)
        assert not np.array_equal(h, a)
    return held, again


def test_held_results_survive_the_next_call_on_the_cpu():
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    _held_survive(dec, _rst((1, 2)), _rst((3, 4)))


def _reader():
    path = os.path.join(ROOT, "jpegbench", "metrics",
                        "fetch_pinned_hit_share.py")
    spec = importlib.util.spec_from_file_location("_reader_fetch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(stats):
    return SimpleNamespace(window=SimpleNamespace(stats=stats))


def test_fetch_pinned_hit_share_reader():
    read = _reader().read
    # a program without the counter, or a window that fetched nothing
    assert read(_ctx([{"chunks": 1}, {"chunks": 2}])) is None
    assert read(_ctx([{"chunks": 1, "fetch_chunks": 0,
                       "fetch_pinned_hits": 0}])) is None
    assert read(_ctx([{"chunks": 1, "fetch_chunks": 1,
                       "fetch_pinned_hits": 0},
                      {"chunks": 3, "fetch_chunks": 3,
                       "fetch_pinned_hits": 3}])) == 75.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locked memory and the "
                    "kernels have no CPU mode")
    return torch.device("cuda")


def _rst640(lo, hi):
    folder = os.path.join(FIXTURES, "rst640")
    names = sorted(f for f in os.listdir(folder) if f.endswith(".jpg"))
    out = []
    for name in names[lo:hi]:
        with open(os.path.join(folder, name), "rb") as f:
            out.append(f.read())
    return out


def _block(a):
    """The torch tensor whose memory a fetched result views."""
    while not isinstance(a, torch.Tensor):
        a = a.base
    return a


@pytest.mark.gpu
def test_fetched_results_view_a_pinned_block(cuda):
    dec = BatchDecoder(backend="fsm", chunk_size=4, device=cuda)
    got = dec.decode(_rst640(0, 4))
    assert dec.stats.fetch_chunks == 1, dec.stats.as_dict()
    for g in got:
        assert g.shape == (640, 640, 3)
        assert _block(g).is_pinned()
    dec.close()


@pytest.mark.gpu
def test_second_call_takes_its_block_from_the_pool(cuda):
    dec = BatchDecoder(backend="fsm", chunk_size=4, device=cuda)
    datas = _rst640(0, 8)
    dec.decode(datas)                # results dropped: blocks back in pool
    dec.decode(datas)
    stats = dec.stats.as_dict()
    assert stats["fetch_chunks"] == 2, stats
    assert stats["fetch_pinned_hits"] == stats["fetch_chunks"], stats
    dec.close()


@pytest.mark.gpu
def test_held_results_survive_the_next_call_on_the_card(cuda):
    dec = BatchDecoder(backend="fsm", chunk_size=4, device=cuda)
    dec.decode(_rst640(8, 12))       # a pooled block the first call reuses
    held, again = _held_survive(dec, _rst640(0, 4), _rst640(4, 8))
    # the held block stayed out of the pool: the second call took another
    assert _block(held[0]).data_ptr() != _block(again[0]).data_ptr()
    dec.close()
