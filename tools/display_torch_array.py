"""Render a `.array` decode output as an image file.

Parity with the reference's testing/display_image.py:5-31 (which shows the
array via OpenCV); headless environments get a PNG instead of a window.
tools/display_array.py on tpujpeg_torch's io/arrayio; it needs PIL.

  python tools/display_torch_array.py OUT.array [-o OUT.png]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("array_path")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)

    import numpy as np

    from tpujpeg_torch.io.arrayio import read_array

    rgb = read_array(args.array_path).astype(np.uint8)
    out = args.output or args.array_path.rsplit(".", 1)[0] + ".png"
    from PIL import Image

    Image.fromarray(rgb).save(out)
    print(f"{args.array_path}: {rgb.shape[1]}x{rgb.shape[0]} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
