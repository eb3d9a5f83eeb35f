"""Golden-output validation of tpujpeg_torch: decode every fixture that
has a reference output and compare: the counterpart of
tools/golden_check.py, with its output lines.

Every tests/fixtures/*.jpg beside a .array (the reference decoder's
output) is decoded by --backend:

  cuda    the root tpujpeg_torch.decode (host entropy decode, the pixel
          stage on --device with exact colour);
  oracle  tpujpeg_torch.decode(backend="oracle"), the numpy decoder;
  batch   tpujpeg_torch.decode_batch (the fsm engine on --device).

Prints "NAME: MATCH" or "NAME: MISMATCH (max diff d)" a fixture, then
"k/n matched"; exit 1 on any mismatch beyond --tolerance, 2 when no pair
is found.

    python tools/check_torch_goldens.py [--backend cuda|oracle|batch]
        [--images DIR] [--tolerance 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_common as tc  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "oracle", "batch"])
    ap.add_argument("--images", default=tc.FIXTURES)
    ap.add_argument("--tolerance", type=int, default=0)
    tc.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = tc.device(args.device) if args.backend != "oracle" else None

    import numpy as np

    import tpujpeg_torch
    from tpujpeg_torch.io.arrayio import read_array

    names = sorted(
        f[:-4]
        for f in os.listdir(args.images)
        if f.endswith(".jpg")
        and os.path.exists(os.path.join(args.images, f[:-4] + ".array"))
    )
    if not names:
        print("no fixture pairs found", file=sys.stderr)
        return 2

    failures = 0
    for name in names:
        jpg = os.path.join(args.images, name + ".jpg")
        golden = read_array(os.path.join(args.images, name + ".array"))
        if args.backend == "batch":
            with open(jpg, "rb") as f:
                rgb = tpujpeg_torch.decode_batch(
                    [f.read()], device=dev)[0].astype(np.int32)
        elif args.backend == "oracle":
            rgb = tpujpeg_torch.decode(jpg, backend="oracle")
        else:
            rgb = tpujpeg_torch.decode(jpg, device=dev)
        rgb = np.asarray(rgb)
        diff = int(np.abs(rgb - golden).max()) if rgb.shape == golden.shape \
            else 256
        ok = rgb.shape == golden.shape and diff <= args.tolerance
        print(f"{name}: {'MATCH' if ok else f'MISMATCH (max diff {diff})'}")
        failures += 0 if ok else 1
    print(f"{len(names) - failures}/{len(names)} matched")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
