"""Organize JPEGs into size-bucketed benchmark datasets.

Parity with the reference's data_preprocessing/{filter_images,
build_image_dataset}.py: scans a directory tree, groups images by WxH
(optionally requiring multiple-of-8 dimensions), and materializes buckets
with at least --min-count members as OUT/WxH/ symlink/copies.
tools/build_dataset.py on tpujpeg_torch's own parser, so that it runs
where JAX is not installed.

  python tools/build_torch_dataset.py IN_DIR OUT_DIR --min-count 50 --mod8
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from collections import defaultdict


def scan(src_dir: str, mod8: bool):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tpujpeg_torch.errors import JpegError
    from tpujpeg_torch.io.parser import parse_file

    buckets: dict[tuple[int, int], list[str]] = defaultdict(list)
    for root, _, files in os.walk(src_dir):
        for name in files:
            if not name.lower().endswith((".jpg", ".jpeg")):
                continue
            path = os.path.join(root, name)
            try:
                img = parse_file(path)
            except (JpegError, OSError):
                continue
            if mod8 and (img.width % 8 or img.height % 8):
                continue
            buckets[(img.width, img.height)].append(path)
    return buckets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src_dir")
    ap.add_argument("dst_dir")
    ap.add_argument("--min-count", type=int, default=50)
    ap.add_argument("--mod8", action="store_true",
                    help="keep only multiple-of-8 dimensions")
    ap.add_argument("--copy", action="store_true",
                    help="copy files instead of symlinking")
    args = ap.parse_args(argv)

    buckets = scan(args.src_dir, args.mod8)
    kept = 0
    for (w, h), paths in sorted(buckets.items()):
        if len(paths) < args.min_count:
            continue
        out = os.path.join(args.dst_dir, f"{w}x{h}")
        os.makedirs(out, exist_ok=True)
        for i, p in enumerate(paths):
            dst = os.path.join(out, f"{i}.jpg")
            if args.copy:
                shutil.copyfile(p, dst)
            elif not os.path.lexists(dst):
                os.symlink(os.path.abspath(p), dst)
        kept += 1
        print(f"{w}x{h}: {len(paths)} images")
    print(f"{kept} size buckets -> {args.dst_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
