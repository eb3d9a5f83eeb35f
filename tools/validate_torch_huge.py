"""Stripe-sharded decode of one huge image on the card(s), checked exact.

The counterpart of tools/validate_huge.py for tpujpeg_torch.  Decodes
the committed 8192 x 8192 4:2:0 stream (tests/fixtures/huge8192_420.jpg,
written by tools/make_torch_corpus.py with validate_huge.py's recipe:
the card's machine has no JPEG encoder) through
parallel.sharding.decode_striped on a mesh of --stripes shards: every
card when there are that many, else the first card named --stripes times
(shards on one card run one after the other: a check of the logic, not
of scaling).  Box and fancy upsampling (the fancy run exchanges one-row
halos), each held `==` the native host decoder's decode_cpu with the
same `fancy`, which tests hold `==` the oracle (the numpy oracle itself
is too slow at this size).  Prints one JSON line: the card's name and
power limit, wall ms of the striped decode (host entropy decode and
fetch included; the first call cold, then warm ones), the host reference's
wall ms, peak device memory and the transfer counts.  Exits 1 when an
output differs; needs a card.

  python tools/validate_torch_huge.py [--stripes 8] [--repeats 2] [--path JPG]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HUGE = os.path.join(ROOT, "tests", "fixtures", "huge8192_420.jpg")


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def stripe_mesh(n: int):
    """n stripes on n cards, or on cuda:0 n times where there are fewer."""
    import torch

    from tpujpeg_torch.parallel import sharding

    cards = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n)] if cards >= n \
        else ["cuda:0"] * n
    return sharding.make_mesh(1, n, devices=devices), cards >= n


def validate(path: str = HUGE, stripes: int = 8, repeats: int = 2) -> dict:
    """Decode `path` striped, box and fancy, `repeats` times each (the
    first call cold); the record (see module)."""
    import numpy as np
    import torch

    from tpujpeg_torch.io.parser import parse_file
    from tpujpeg_torch.parallel import sharding
    from tpujpeg_torch.runtime import host

    img = parse_file(path)
    mesh, distinct = stripe_mesh(stripes)
    rec = {"tool": "validate_torch_huge", "card": card_line(),
           "path": os.path.relpath(path, ROOT),
           "size": f"{img.width}x{img.height}", "mcus_y": img.mcus_y,
           "stripes": stripes, "mesh_devices": [str(d) for d in
                                                mesh.devices.flat],
           "distinct_cards": distinct, "host_reference": host.backend_name()}
    exact = True
    for fancy in (False, True):
        key = "fancy" if fancy else "box"
        t0 = time.perf_counter()
        want = host.decode_cpu(img, fancy=fancy)
        rec[f"{key}_host_reference_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        walls, ok = [], True
        for _ in range(repeats):
            sharding.reset_transfers()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = sharding.decode_striped(img, mesh=mesh, fancy=fancy)
            walls.append((time.perf_counter() - t0) * 1e3)
            ok &= bool(np.array_equal(got, want))
            del got
        rec[f"{key}_striped_ms"] = walls
        rec[f"{key}_exact_vs_host"] = ok
        exact &= ok
        rec[f"{key}_transfers"] = dict(sharding.TRANSFERS)
        rec[f"{key}_peak_device_mb"] = \
            torch.cuda.max_memory_allocated() / 1e6
        del want
    rec["exact"] = exact
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stripes", type=int, default=8)
    ap.add_argument("--path", default=HUGE)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("validate_torch_huge: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    rec = validate(args.path, args.stripes, args.repeats)
    print(json.dumps(rec))
    return 0 if rec["exact"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
