"""Command-line interface (counterpart of tpujpeg/cli.py).

  python -m tpujpeg_torch.cli decode IMG.jpg -o OUT.array
      [--backend cuda|auto|cpu|oracle] [--device cuda] [--fast]
      [--fancy-upsampling] [-q]
  python -m tpujpeg_torch.cli info IMG.jpg
  python -m tpujpeg_torch.cli compare OUT.array GOLDEN.array [--tolerance N]

`--backend cuda` (the default) takes the JAX CLI's `tpu`: host entropy
decode, then the pixel stage on `--device`; `auto` routes as
tpujpeg_torch.decode does (the native library where it loads, else
cuda).  The defaults stay on the card, as tpujpeg_torch.decode's do; the
JAX CLI's default `auto` would decode on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_decode(args) -> int:
    import numpy as np

    from .io.arrayio import write_array
    from .io.parser import parse_file

    img = parse_file(args.input)
    t0 = time.perf_counter()
    backend = args.backend
    if backend == "auto":
        # one image cannot amortize a device dispatch (tpujpeg_torch.decode)
        from .runtime import host

        backend = "cpu" if host._load_native() is not None else "cuda"
    if backend == "oracle":
        from .oracle import decoder as oracle

        rgb = oracle.decode(img, fancy=args.fancy_upsampling)
    elif backend == "cpu":
        from .runtime import host

        rgb = host.decode_cpu(img, fancy=args.fancy_upsampling)
    else:
        from . import pipeline

        rgb = pipeline.decode(img, device=args.device, strict=not args.fast,
                              fancy=args.fancy_upsampling)
    dt = time.perf_counter() - t0

    out = args.output
    if out is None:
        out = args.input.rsplit(".", 1)[0] + ".array"
    if out.endswith(".array"):
        write_array(out, rgb)
    elif out.endswith((".png", ".bmp", ".ppm")):
        from PIL import Image

        Image.fromarray(np.asarray(rgb, dtype=np.uint8)).save(out)
    else:
        raise SystemExit(f"unsupported output format: {out}")
    if not args.quiet:
        print(
            f"{args.input}: {img.width}x{img.height} {img.sampling} "
            f"-> {out} in {dt*1e3:.1f} ms"
        )
    return 0


def _cmd_info(args) -> int:
    from .io.parser import parse_file

    img = parse_file(args.input)
    info = {
        "path": args.input,
        "width": img.width,
        "height": img.height,
        "sampling": img.sampling,
        "precision": img.precision,
        "components": len(img.components),
        "restart_interval": img.restart_interval,
        "entropy_segments": img.n_segments(),
        "mcus": [img.mcus_x, img.mcus_y],
        "blocks_per_mcu": img.blocks_per_mcu,
        "scan_bytes": int(img.scan_data.size),
        "quant_tables": sorted(img.quant_tables),
        "huffman_tables": [hex(h) for h in sorted(img.huffman)],
    }
    print(json.dumps(info, indent=2))
    return 0


def _cmd_compare(args) -> int:
    """Golden comparator: MATCH when every sample is within --tolerance."""
    import numpy as np

    from .io.arrayio import read_array

    a = read_array(args.a)
    b = read_array(args.b)
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}")
        return 1
    diff = np.abs(a - b)
    if diff.max() <= args.tolerance:
        print(f"MATCH (max diff {int(diff.max())}, tolerance {args.tolerance})")
        return 0
    print(
        f"MISMATCH: max diff {int(diff.max())}, "
        f"{int((diff > args.tolerance).sum())} px over tolerance"
    )
    return 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpujpeg_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode a JPEG to .array/.png")
    d.add_argument("input")
    d.add_argument("-o", "--output", default=None)
    d.add_argument(
        "--backend", choices=["cuda", "auto", "cpu", "oracle"],
        default="cuda",
        help="cuda (default) = host entropy decode, pixels on --device; "
             "auto = the native C++ decoder where it loads, else cuda (one "
             "image cannot amortize a device dispatch; every backend is "
             "bit-exact); cpu = the native C++ decoder (entropy + pixels); "
             "oracle = the NumPy reference",
    )
    d.add_argument("--device", default="cuda",
                   help="the device of --backend cuda (default: cuda)")
    d.add_argument(
        "--fast",
        action="store_true",
        help="f32 colour on the device instead of the reference's exact "
             "colour (strict=False)",
    )
    d.add_argument(
        "--fancy-upsampling",
        action="store_true",
        help="libjpeg-style triangle chroma upsampling for subsampled "
        "streams (default: box replication)",
    )
    d.add_argument("-q", "--quiet", action="store_true")
    d.set_defaults(fn=_cmd_decode)

    i = sub.add_parser("info", help="print stream metadata as JSON")
    i.add_argument("input")
    i.set_defaults(fn=_cmd_info)

    c = sub.add_parser("compare", help="compare two .array files")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--tolerance", type=int, default=0)
    c.set_defaults(fn=_cmd_compare)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
