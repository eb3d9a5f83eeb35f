"""Manifest-driven bulk decode with resume for tpujpeg_torch: the
counterpart of tools/batch_decode.py.

Every .jpg / .jpeg of IN_DIR is decoded by BatchDecoder in --chunk
sized calls (decode(on_error="skip")), and each image gets one JSON line
in the manifest (OUT_DIR/manifest.jsonl unless --manifest): status "ok"
with its output file and ms a image, or status "error" with the
decoder's message for a stream that does not decode (not fatal).
--resume skips the names whose line says "ok", so an interrupted run
goes on where it stopped.

--format array writes OUT_DIR/NAME.array through io/arrayio (the
reference's format); --format png needs PIL, which is imported only
then (the card's machine has none: pass --format array there).
--backend: the port's backends (fsm, gather, host, oracle, cpu, auto);
--size-buckets groups by size-class bucket (auto, host, oracle, fsm).

    python tools/batch_torch_decode.py IN_DIR OUT_DIR [--backend host]
        [--format png|array] [--chunk 16] [--resume] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_common as tc  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src_dir")
    ap.add_argument("dst_dir")
    ap.add_argument("--backend", default="host",
                    choices=["auto", "host", "fsm", "gather", "oracle",
                             "cpu"])
    ap.add_argument("--format", default="png", choices=["png", "array"])
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--size-buckets", action="store_true",
                    help="group images by size-class bucket instead of "
                         "exact geometry (mixed-size corpora)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--manifest", default=None)
    tc.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = tc.device(args.device)

    if args.format == "png":
        try:
            from PIL import Image
        except ImportError as e:
            raise SystemExit(f"--format png needs PIL, which is not "
                             f"installed here ({e}); use --format array")

    from tpujpeg_torch.io.arrayio import write_array
    from tpujpeg_torch.runtime.batch import BatchDecoder

    os.makedirs(args.dst_dir, exist_ok=True)
    manifest_path = args.manifest or os.path.join(args.dst_dir,
                                                  "manifest.jsonl")
    done: set[str] = set()
    if args.resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("status") == "ok":
                    done.add(rec["name"])

    names = [
        n for n in sorted(os.listdir(args.src_dir))
        if n.lower().endswith((".jpg", ".jpeg")) and n not in done
    ]
    if done:
        print(f"resume: {len(done)} already done, {len(names)} remaining")

    dec = BatchDecoder(backend=args.backend, chunk_size=args.chunk,
                       size_buckets=args.size_buckets, device=dev)
    n_ok = n_fail = 0
    try:
        with open(manifest_path, "a") as manifest:
            for j in range(0, len(names), args.chunk):
                part = names[j : j + args.chunk]
                datas = []
                for n in part:
                    with open(os.path.join(args.src_dir, n), "rb") as f:
                        datas.append(f.read())
                t0 = time.perf_counter()
                results = dec.decode(datas, on_error="skip")
                dt = time.perf_counter() - t0
                for i, (name, rgb) in enumerate(zip(part, results)):
                    if rgb is None:
                        rec = {"name": name, "status": "error",
                               "error": dec.stats.failures.get(
                                   i, "decode failed")}
                        n_fail += 1
                    else:
                        stem = os.path.splitext(name)[0]
                        if args.format == "png":
                            out = os.path.join(args.dst_dir, stem + ".png")
                            Image.fromarray(rgb).save(out)
                        else:
                            out = os.path.join(args.dst_dir, stem + ".array")
                            write_array(out, rgb)
                        rec = {"name": name, "status": "ok", "out": out,
                               "ms": round(dt / len(part) * 1e3, 2)}
                        n_ok += 1
                    manifest.write(json.dumps(rec) + "\n")
                manifest.flush()
                print(f"[{j + len(part)}/{len(names)}] chunk in "
                      f"{dt * 1e3:.0f} ms ({dec.stats.backend})", flush=True)
    finally:
        dec.close()
    print(f"done: {n_ok} ok, {n_fail} failed -> {manifest_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
