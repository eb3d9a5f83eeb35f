"""The corpus of one run: a configuration's pictures, made from the seed.

A configuration (jpegbench/configs/<name>.json) fixes the deployment's
pictures: how many, the distribution of their sizes (fixed sizes with
their counts, and counts drawn uniformly from a range), sampling,
quality, restart policy and the content field's parameters.  The run's
`--seed` draws the sizes taken from a range and every picture's content,
so each seed decodes other streams at the same counts of each kind.

Content: a natural-image field.  Three independent Gaussian fields with
a 1/f amplitude spectrum (`alpha`) are mixed into R, G and B with a
strong shared part (`chroma` sets how far the channels depart from it),
scaled to `sigma` grey levels about mid-grey, plus white sensor noise of
`noise` grey levels, then rounded to uint8.

Every picture is encoded (jpegbench/encoder.py) on a pool of worker
processes; `regenerate` makes one picture's pixels again in this process,
for the reference.
"""

from __future__ import annotations

import multiprocessing
import os
from dataclasses import dataclass

import numpy as np

from . import encoder


@dataclass
class Stream:
    """One encoded picture: what the program gets, and what the harness
    counts of it."""

    index: int
    data: bytes
    width: int
    height: int
    scan_bytes: int          # entropy-coded bytes, unstuffed, no markers
    n_blocks: int


def picture_sizes(config: dict, seed: int) -> list[tuple[int, int]]:
    """(width, height) of every picture of the corpus: the configuration's
    fixed sizes, then the draws from its ranges, made from the seed."""
    rng = np.random.default_rng([seed, 0x512E])
    out: list[tuple[int, int]] = []
    for entry in config["sizes"]:
        if "uniform" in entry:
            lo, hi = entry["uniform"]
            wh = rng.integers(lo, hi + 1, size=(entry["count"], 2))
            out += [(int(w), int(h)) for w, h in wh]
        else:
            out += [(entry["width"], entry["height"])] * entry["count"]
    if len(out) != config["images"]:
        raise ValueError(f"{config['name']}: {len(out)} pictures, the "
                         f"configuration says {config['images']}")
    return out


def _field(rng: np.random.Generator, h: int, w: int,
           alpha: float) -> np.ndarray:
    """A zero-mean, unit-variance Gaussian field with amplitude ~ 1/f^alpha."""
    spec = np.fft.rfft2(rng.standard_normal((h, w)))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0 / max(h, w)
    out = np.fft.irfft2(spec * f ** -alpha, s=(h, w))
    out -= out.mean()
    return out / out.std()


def picture(seed: int, index: int, width: int, height: int,
            content: dict) -> np.ndarray:
    """The uint8 [height, width, 3] content of picture `index` of a seed."""
    rng = np.random.default_rng([seed, index])
    shared, a, b = (_field(rng, height, width, content["alpha"])
                    for _ in range(3))
    c = content["chroma"]
    rgb = np.stack([shared + c * a, shared - 0.5 * c * (a - b),
                    shared + c * b], axis=-1)
    rgb = 128.0 + content["sigma"] * rgb
    rgb += content["noise"] * rng.standard_normal(rgb.shape)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def _encode_one(args) -> tuple[bytes, int]:
    seed, index, (w, h), config = args
    rgb = picture(seed, index, w, h, config["content"])
    return encoder.encode(rgb, config["sampling"], config["quality"],
                          config["restart"])


def regenerate(config: dict, seed: int, index: int) -> np.ndarray:
    """Picture `index`'s pixels, as the corpus of `seed` encoded them."""
    w, h = picture_sizes(config, seed)[index]
    return picture(seed, index, w, h, config["content"])


# the workers' numpy runs one BLAS thread each: eight workers of eight
# threads each would take three times as long
_ONE_THREAD = {"OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "1",
               "MKL_NUM_THREADS": "1"}


def worker_count() -> int:
    """The cores this process may use, at most 8, less one for the
    process that loads torch and CUDA meanwhile."""
    return max(1, min(8, len(os.sched_getaffinity(0))) - 1)


class Pending:
    """A corpus being encoded on a pool of spawned worker processes.
    `result` waits for it and stops the pool; `close` stops the pool
    whatever its state (always call one of them)."""

    def __init__(self, config: dict, seed: int, workers: int):
        self.dims = picture_sizes(config, seed)
        self.sampling = config["sampling"]
        jobs = [(seed, i, wh, config) for i, wh in enumerate(self.dims)]
        self.pool = None
        if workers == 1:
            self.encoded = list(map(_encode_one, jobs))
        else:
            saved = {k: os.environ.get(k) for k in _ONE_THREAD}
            os.environ.update(_ONE_THREAD)
            try:
                # the workers copy the environment as they start, here
                self.pool = multiprocessing.get_context("spawn").Pool(
                    workers)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            self.async_result = self.pool.map_async(_encode_one, jobs,
                                                    chunksize=4)

    def result(self) -> list[Stream]:
        if self.pool is not None:
            # a worker that dies leaves the pool waiting: give up instead
            self.encoded = self.async_result.get(timeout=600)
            self.pool.close()
            self.pool.join()
            self.pool = None
        out = []
        for i, ((w, h), (data, n_scan)) in enumerate(zip(self.dims,
                                                         self.encoded)):
            geom = encoder.Geometry(w, h, self.sampling)
            out.append(Stream(i, data, w, h, n_scan, geom.n_blocks))
        return out

    def close(self) -> None:
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None


def start(config: dict, seed: int, workers: int) -> Pending:
    """Start encoding every picture of the seed's corpus on `workers`
    processes (in this process where workers is 1)."""
    return Pending(config, seed, workers)


def build(config: dict, seed: int, workers: int = 1) -> list[Stream]:
    """Every picture of the seed's corpus, encoded."""
    pending = start(config, seed, workers)
    try:
        return pending.result()
    finally:
        pending.close()
