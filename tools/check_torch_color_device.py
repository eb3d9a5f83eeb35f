"""Prove both colour modes of tpujpeg_torch on the card over the whole
reachable input domain: the counterpart of tools/check_color_device.py.

The IDCT clips its output to [-256, 255], so every pixel's colour is a
function of one triple (y, cb, cr) of [-256, 255]^3: 134,217,728 triples.
Y slab by Y slab (ops/pixels.colour_proof), each triple goes through

  * the f32 colour (the port's strict=False): the pixel kernel's f32 mode
    (csrc/pixels.cu, DC-only blocks whose samples are the triple) and
    color.ycbcr_to_rgb (color_core, the plane path's), against the
    oracle's ycbcr_to_rgb_exact in numpy.  The claim, the JAX tool's:
    every pixel equals the exact colour or is flagged risky.  Counted:
    checked, flagged, unflagged mismatches; the first unflagged triple is
    printed;
  * the exact colour (the strict default): the kernel's exact mode and
    color.color_exact (float64), which must equal the oracle everywhere.

--stride checks every stride-th Y slab, as in the JAX tool;
--chroma-stride every such Cb and Cr value (1, the default, is all 512:
the proof; larger values are for quick runs, as on the CPU).  The result
goes to --out (benchmark_results/torch/color_device_proof.json by
default).  Exit 0 iff no unflagged f32 mismatch and no exact mismatch.

    python tools/check_torch_color_device.py             # all 512^3
    python tools/check_torch_color_device.py --stride 8  # every 8th slab
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_common as tc  # noqa: E402

OUT = os.path.join(tc.ROOT, "benchmark_results", "torch",
                   "color_device_proof.json")


def prove(dev, stride: int = 1, chroma_stride: int = 1, log=print) -> dict:
    """Run the proof; returns the record written to --out."""
    from tpujpeg_torch.ops import pixels

    def on_slab(i, y, c):
        if log and i % 64 == 0:
            log(f"  slab y={y:+4d}: kernel flagged so far "
                f"{c['f32_kernel_flagged']}/{c['checked']} "
                f"({100 * c['f32_kernel_flagged'] / c['checked']:.3f}%)")

    t0 = time.perf_counter()
    ys = range(-256, 256, stride)
    c = pixels.colour_proof(dev, ys, chroma_stride, on_slab=on_slab)
    rec = {"tool": "check_torch_color_device", "device": tc.card(dev),
           "domain": f"y in [-256,255] stride {stride}, cb/cr stride "
                     f"{chroma_stride}", **c}
    for src in ("kernel", "torch"):
        rec[f"f32_{src}_flagged_pct"] = round(
            100 * c[f"f32_{src}_flagged"] / c["checked"], 4)
    bad = sum(v for k, v in c.items() if k.endswith("mismatches"))
    rec["verdict"] = ("PROOF HOLDS: every f32 deviation is risk-flagged "
                      "and the exact colour equals the oracle"
                      if bad == 0 else f"PROOF FAILS: {bad} mismatches")
    rec["runtime_s"] = round(time.perf_counter() - t0, 1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stride", type=int, default=1,
                    help="check every stride-th Y slab (1 = exhaustive)")
    ap.add_argument("--chroma-stride", type=int, default=1,
                    help="check every such Cb and Cr value (1 = all)")
    ap.add_argument("--out", default=OUT)
    tc.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = tc.device(args.device)

    rec = prove(dev, args.stride, args.chroma_stride)
    print(json.dumps(rec))
    if rec["first_unflagged"] is not None:
        print("FIRST unflagged mismatch (source, y, cb, cr, device, "
              "oracle):", rec["first_unflagged"])
    print(rec["verdict"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(rec) + "\n")
    return 0 if rec["verdict"].startswith("PROOF HOLDS") else 1


if __name__ == "__main__":
    sys.exit(main())
