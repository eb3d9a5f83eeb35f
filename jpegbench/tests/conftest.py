"""Shared helpers of the benchmark's CPU tests.

Run from the checkout's root: `python -m pytest jpegbench/tests -q`.
The cells are cut to a size the CPU holds (tiny pictures, a few a call,
windows of about a second); nothing here needs a card.
"""

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from jpegbench import harness  # noqa: E402

TINY_SIZES = {
    "rst444": [{"count": 8, "width": 32, "height": 24}],
    "ilsvrc420": [{"count": 4, "width": 40, "height": 30},
                  {"count": 4, "uniform": [20, 50]}],
}


def tiny(cell_name: str, per_call: int = 4, sizes=None):
    """(cell, config, traffic, spec) of a cell cut to tiny pictures."""
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(spec, cell_name)
    config = harness.load_json(
        harness.BENCH / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(
        harness.BENCH / "traffic" / f"{cell['traffic']}.json")
    config = copy.deepcopy(config)
    config["sizes"] = sizes or TINY_SIZES[config["name"]]
    config["images"] = sum(e["count"] for e in config["sizes"])
    traffic["images_per_call"] = (config["images"] if per_call is None
                                  else per_call)
    traffic["check_images"] = 8
    return cell, config, traffic, spec


def run_tiny(cell_name: str, seed: int = 2**33 + 7, seconds: float = 1.0,
             trace: bool = False, config_edit=None, **kw) -> dict:
    cell, config, traffic, spec = tiny(cell_name, sizes=kw.pop("sizes", None),
                                       per_call=kw.pop("per_call", 4))
    if config_edit is not None:
        config_edit(config)
    return harness.run_cell(cell, config, traffic, spec, seed, seconds,
                            trace, "cpu", time.perf_counter(), workers=1,
                            **kw)


@pytest.fixture
def tiny_run():
    return run_tiny
