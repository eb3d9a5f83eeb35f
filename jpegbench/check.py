"""How `correct` is decided.

Every answer of the window is checked for its size and type as it comes
(`size_ok`), and every image the program failed or left out counts.
A sample of the window's answers, drawn from the seed (`Sample`, a
reservoir over all of them), is kept and, once the window has closed,
compared value for value with the plain reference (reference/pixels.py),
which starts from the encoder's own quantised coefficients of the same
picture.  A strict decode is exact, so every number compared has the
limit 0.
"""

from __future__ import annotations

import numpy as np

from . import corpus, encoder
from .reference import pixels

LIMITS = {"failed": 0, "wrong_size": 0, "mismatched_values": 0,
          "max_abs_diff": 0}


def size_ok(out, width: int, height: int) -> bool:
    return (isinstance(out, np.ndarray) and out.dtype == np.uint8
            and out.shape == (height, width, 3))


class Sample:
    """A uniform sample of `size` answers from all the window's answers
    (reservoir sampling), drawn from the seed.  Kept answers are copied,
    so they hold no call's output buffer alive."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng([seed, 0x5A3])
        self.size = size
        self.seen = 0
        self.kept: list[tuple[int, np.ndarray | None]] = []

    def offer(self, indices, outputs) -> None:
        n = len(indices)
        t = self.seen + 1 + np.arange(n)
        slot = self.rng.integers(0, t)
        for j in range(n):
            if len(self.kept) < self.size:
                self.kept.append(None)
                k = len(self.kept) - 1
            elif slot[j] < self.size:
                k = int(slot[j])
            else:
                continue
            out = outputs[j]
            self.kept[k] = (indices[j], None if out is None else out.copy())
        self.seen += n


def reference_rgb(config: dict, seed: int, index: int) -> np.ndarray:
    """The plain reference's decode of picture `index` of the seed's
    corpus: its pixels made again, quantised by the encoder, decoded by
    reference/pixels.py."""
    rgb = corpus.regenerate(config, seed, index)
    zz = encoder.coefficients(rgb, config["sampling"], config["quality"])
    quant = encoder.quant_tables(config["quality"])[:, encoder.ZIGZAG]
    h, w = rgb.shape[:2]
    return pixels.decode(zz, quant, w, h, config["sampling"],
                         config["decoder"]["fancy"])


def compare(config: dict, seed: int, sample: Sample, failed: int,
            wrong_size: int) -> dict:
    """Each number compared, with its limit:
    {name: {"value": v, "limit": lim}}."""
    refs: dict[int, np.ndarray] = {}
    mismatched, worst = 0, 0
    for index, out in sample.kept:
        if out is None:
            continue               # counted under `failed`
        if index not in refs:
            refs[index] = reference_rgb(config, seed, index)
        ref = refs[index]
        if out.shape != ref.shape:
            mismatched += ref.size
            worst = max(worst, 255)
            continue
        diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
        mismatched += int(np.count_nonzero(diff))
        worst = max(worst, int(diff.max()))
    values = {"failed": failed, "wrong_size": wrong_size,
              "mismatched_values": mismatched, "max_abs_diff": worst}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
