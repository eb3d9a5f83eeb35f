"""Where one 128-image chunk's device time goes in tpujpeg_torch (CUDA).

Runs the fused chunk chain (runtime/fused.decode_chunk_fused) on the
committed restart corpus (tests/fixtures/rst640, 16 streams x 8) with the
plan already on the card, and reports:

  * per stage, the median of 5 warm runs timed with CUDA events, each
    stage synchronised on its own (scan, materialize, lane transpose +
    DC cumsum, assemble, pixel prologue, pixel kernel, unpack + raster
    + pack_mask);
  * the whole chain, unsynchronised, the same way;
  * torch.profiler's CUDA-time table over 3 chain runs (also written to
    OUT_FILE when one is given).

Needs a CUDA card.  Run from the repo root:
    python tools/profile_torch_chunk.py [OUT_FILE]
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CHUNK = 128


def _ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from tpujpeg.io.parser import parse_file
    from tpujpeg_torch.ops import fsm, pixels
    from tpujpeg_torch.pipeline import Geometry, device_decode_fn, soa_planes
    from tpujpeg_torch.runtime import fused

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    corpus = os.path.join(ROOT, "tests", "fixtures", "rst640")
    names = sorted(os.listdir(corpus))
    imgs = [parse_file(os.path.join(corpus, n)) for n in names] * (CHUNK // 16)
    dev = torch.device("cuda")
    plan = fsm.build_plan(imgs)
    xs = torch.as_tensor(plan.xs).to(dev)
    sn = torch.as_tensor(plan.seg_n_blocks).to(dev)
    quant = torch.as_tensor(np.stack([
        np.stack([im.quant_tables[c.quant_id] for c in im.components])
        for im in imgs
    ]).astype(np.int32)).to(dev)
    geom = Geometry.of(imgs[0])
    L = xs.shape[0]
    M = plan.max_blk * 64

    st = {}
    st["scan"] = fsm.fsm_scan(xs, sn, plan.tables)
    ev = st["scan"][0].reshape(-1, L)
    st["mat"] = fsm.materialize_checked(ev, M, st["scan"][1])[0]
    per_lane = st["mat"].T.reshape(L, plan.max_blk, 64)
    dc_lane = fsm._dc_cumsum(per_lane[:, :, 0], plan.tables, plan.max_blk)
    coeffs = fused._assemble_rows(per_lane, plan.layout, CHUNK)
    dc = fused._assemble_rows(dc_lane, plan.layout, CHUNK)
    planes = soa_planes(geom, coeffs, quant, dc)

    def transpose_dc():
        pl = st["mat"].T.reshape(L, plan.max_blk, 64)
        fsm._dc_cumsum(pl[:, :, 0], plan.tables, plan.max_blk)

    stages = [
        ("scan (kernel 1)", lambda: fsm.fsm_scan(xs, sn, plan.tables)),
        ("materialize (kernel 2)",
         lambda: fsm.materialize_checked(ev, M, st["scan"][1])),
        ("lane transpose + DC cumsum", transpose_dc),
        ("assemble (coeffs + dc)", lambda: (
            fused._assemble_rows(per_lane, plan.layout, CHUNK),
            fused._assemble_rows(dc_lane, plan.layout, CHUNK))),
        ("pixel prologue (soa_planes)",
         lambda: soa_planes(geom, coeffs, quant, dc)),
        ("pixel kernel (kernel 3)", lambda: pixels.rgb_soa_fused(*planes)),
        ("pixels end to end (device_decode_fn)",
         lambda: device_decode_fn(geom, coeffs, quant, dc=dc)),
    ]
    print(f"card: {smi}")
    print(f"lane matrix {list(xs.shape)}, events {list(ev.shape)}, "
          f"dense [{M}, {L}]")
    for name, fn in stages:
        print(f"stage {name}: {_ms(fn):.3f} ms")
    chain = lambda: fused.decode_chunk_fused(  # noqa: E731
        plan, quant, geom, CHUNK, uploaded=(xs, sn))
    print(f"chain decode_chunk_fused: {_ms(chain):.3f} ms")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            chain()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=30)
    print(table)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(f"card: {smi}\n{table}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
