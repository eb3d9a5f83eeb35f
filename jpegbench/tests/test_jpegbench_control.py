"""`correct` comes out false where it should.

The control: the program's lower-precision colour (`strict=False`, float32
where the contract computes in float64) put in the strict decode's place.
The faults: the run driven with the timed path broken underneath, once
for each fault a decode call can have (the exchange between chips does
not exist on one card):

- a call that returns its state unchanged: the previous call's answers;
- half of the batch left out;
- an answer altered where it is produced.

All on the CPU at tiny sizes, with the harness's look for a card skipped.
"""

import numpy as np
import pytest

from conftest import run_tiny, tiny

SEEDS = [2**33 + 1, 2**33 + 2, 3]
CONTROL_SIZES = [{"count": 8, "width": 160, "height": 120}]


def lax(config):
    config["decoder"]["strict"] = False


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["rst444.loader128", "ilsvrc420.loader128"])
def test_control_is_not_correct(cell, seed):
    res = run_tiny(cell, seed=seed, seconds=0.5, config_edit=lax,
                   sizes=CONTROL_SIZES)
    assert not res["correct"]
    assert res["checks"]["mismatched_values"]["value"] > 0
    assert res["failed"] == 0


@pytest.mark.parametrize("cell", ["rst444.loader128", "ilsvrc420.loader128"])
def test_sound_run_is_correct(cell):
    res = run_tiny(cell, seconds=0.5, sizes=CONTROL_SIZES)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    want = {"images_per_s", "setup_s"}
    if cell.startswith("ilsvrc"):
        want.add("device_peak_MB")
    assert set(res["metrics"]) == want


def test_tagged_metric_reads_its_reading():
    """An end-to-end metric `<reading>.<tag>` reports `<reading>`."""
    import copy

    from jpegbench import harness

    cell, config, traffic, spec = tiny("rst444.loader128")
    spec = copy.deepcopy(spec)
    spec["end_to_end"].append({"name": "setup_s.later", "unit": "s",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": [cell["name"]]})
    res = harness.run_cell(cell, config, traffic, spec, 5, 0.3, False, "cpu",
                           0.0, workers=1)
    m = res["metrics"]
    assert m["setup_s.later"] == m["setup_s"]


class _Wrapped:
    """A BatchDecoder with its decode broken by `fault`."""

    def __init__(self, dec, fault):
        self.dec, self.fault, self.last = dec, fault, None

    def __getattr__(self, name):
        return getattr(self.dec, name)

    def decode(self, datas, **kw):
        out = self.dec.decode(datas, **kw)
        if self.fault == "stale":
            prev, self.last = self.last, out
            return out if prev is None else prev
        if self.fault == "half":
            return out[: len(out) // 2] + [None] * (len(out) - len(out) // 2)
        if self.fault == "altered":
            out = [o.copy() for o in out]
            for o in out:
                o[0, 0, 0] ^= 1
            return out
        raise ValueError(self.fault)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", ["rst444.loader128", "ilsvrc420.loader128"])
def test_fault_is_not_correct(cell, fault):
    res = run_tiny(cell, seconds=0.5,
                   wrap_decoder=lambda dec: _Wrapped(dec, fault))
    assert not res["correct"], res["checks"]


def test_traced_run_reads_the_layer_shares():
    res = run_tiny("ilsvrc420.loader128", trace=True, seconds=0.5)
    shares = [res["metrics"][k]["value"] for k in (
        "parse_wait_share", "dispatch_share", "device_wait_share",
        "fetch_crop_share")]
    assert np.isclose(sum(shares), 100.0)
    # no card, so nothing to read for the device's metrics
    assert "device_idle_share" not in res["metrics"]
    assert "scan_roofline" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "safe_retry_share" not in res["metrics"]


def test_traced_restart_run_reads_the_retry_share():
    res = run_tiny("rst444.loader128", trace=True, seconds=0.5)
    assert res["correct"], res["checks"]
    assert res["metrics"]["safe_retry_share"]["value"] == 0.0


def test_calls_draw_epochs_as_a_shuffling_loader():
    """Each epoch (the warm calls are epoch -1) decodes the corpus once,
    in a fresh order drawn from the seed."""
    from jpegbench import harness

    traffic = {"images_per_call": 4}
    calls = [harness.call_order(traffic, 8, 2**33 + 5, c)
             for c in range(-2, 4)]
    for e in range(3):
        assert sorted(calls[2 * e] + calls[2 * e + 1]) == list(range(8))
    assert calls[2:4] != calls[4:6]
    assert calls != [harness.call_order(traffic, 8, 6, c)
                     for c in range(-2, 4)]
