"""Times of `fsm_scan` in each of its uses and of `place_events` beside
its zero fill, one PyTorch call and its bounds, on a CUDA card
(tpujpeg_torch).

    python tools/bench_torch_scan.py [--iters 5] [--repeat 8] [OUT.json]

Runs both kernels on the real inputs of 128-image chunks of the committed
corpora (CUDA events, median of `--iters` warm runs):

  fsm_scan      restart chunk (rst640), 4:2:0 restart chunk (rst640_420),
                pad_info on the mixed-size chunk (mixed_rst), and on the
                chunk without restart markers (photo640) the cold pass
                with anchors, the stitch pass on its column prefix and
                the count pass (emit=False); also the scan on lanes of
                quota 0 (what a warp of idle lanes costs);
  place_events  on the events of the two restart chunks: the zero fill
                alone (a launch on no event rows), the kernel with its
                fill, one PyTorch index_put_ call (held equal to the
                kernel), and the two bounds (bytes; sectors: valid events
                x 32 bytes read and written, plus the fill) over 3.35
                TB/s; and how many blocks apart the 64 lanes of a group
                are at one event row (what a band staged in shared memory
                would have to span).

Prints one line per reading, each with the card's name and power limit.
Needs a CUDA card and nvcc.  Run from the repo root.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate

def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over `reps` warm runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _corpus(name: str, repeat: int):
    from tpujpeg_torch.io.parser import parse_file

    folder = os.path.join(ROOT, "tests", "fixtures", name)
    names = sorted(n for n in os.listdir(folder) if n.endswith(".jpg"))
    return [parse_file(os.path.join(folder, n)) for n in names] * repeat


def scan_cases(repeat: int, dev) -> dict:
    """name -> (callable running one scan, its lane matrix shape)."""
    import torch

    from tpujpeg_torch.ops import fsm
    from tpujpeg_torch.pipeline import Geometry, bucket_geometry

    def up(*arrays):
        return tuple(torch.as_tensor(a).to(dev) for a in arrays)

    cases = {}
    for label, corpus in (("restart", "rst640"),
                          ("4:2:0 restart", "rst640_420")):
        plan = fsm.build_plan(_corpus(corpus, repeat), split=False)
        xs, sn = up(plan.xs, plan.seg_n_blocks)
        cases[label] = (
            lambda xs=xs, sn=sn, t=plan.tables: fsm.fsm_scan(xs, sn, t),
            plan)
    zero = torch.zeros_like(sn)
    cases["quota 0 on every lane (4:2:0 shape)"] = (
        lambda xs=xs, t=plan.tables: fsm.fsm_scan(xs, zero, t), plan)

    mimgs = _corpus("mixed_rst", repeat)
    buckets = {bucket_geometry(Geometry.of(im)) for im in mimgs}
    bplan = fsm.build_plan_bucketed(mimgs, buckets.pop())
    bxs, bsn, bwrap, bskip = up(bplan.xs, bplan.seg_n, bplan.wrap_at,
                                bplan.skip)
    cases["pad_info"] = (
        lambda: fsm.fsm_scan(bxs, bsn, bplan.tables,
                             pad_info=(bwrap, bskip)), bplan)

    splan = fsm.build_spec_plan_batch(_corpus("photo640", repeat), 1024)
    sxs, cbits = up(splan.xs, splan.chunk_bits)
    SL = splan.xs.shape[0]
    caps = torch.full((SL,), splan.blk_cap, dtype=torch.int32, device=dev)
    inherit = torch.as_tensor(fsm._lane_masks(splan)[0]).to(dev)

    def cold():
        return fsm.fsm_scan_spec(sxs, caps, splan.tables, chunk_bits=cbits,
                                 log_anchors=True)

    first = cold()
    P, bim_t = fsm._handoff(first.end_bits, first.end_bim, inherit,
                            splan.chunk_bytes)
    del first
    xs2 = sxs[:, :fsm.SPEC_STITCH_BYTES + fsm.SPEC_OVERLAP]
    cb2 = torch.clamp(cbits, max=fsm.SPEC_STITCH_BYTES * 8)
    cases["cold (anchors)"] = (cold, splan)
    cases["stitch (column prefix)"] = (
        lambda: fsm.fsm_scan_spec(xs2, caps, splan.tables, start_bits=P,
                                  start_bim=bim_t, chunk_bits=cb2), splan)
    cases["count (emit=False)"] = (
        lambda: fsm.fsm_scan_spec(sxs, caps, splan.tables, start_bits=P,
                                  start_bim=bim_t, chunk_bits=cbits,
                                  emit=False), splan)
    return cases


def index_put_call(ev, M: int):
    """One PyTorch call for events -> dense: a zero fill and one
    index_put_, its indices and values prepared outside."""
    import torch

    valid = ev >= 0
    e = ev[valid].to(torch.int64)
    tgt = ((e >> 18) & 0x1FFF) * 64 + ((e >> 12) & 63)
    lanes = torch.arange(ev.shape[1], device=ev.device) \
        .expand(ev.shape)[valid]
    vals = ((e & 0xFFF) - 2048).to(torch.int16)
    out = torch.empty((M, ev.shape[1]), dtype=torch.int16, device=ev.device)

    def call():
        out.zero_()
        return out.index_put_((tgt, lanes), vals)

    return call


def block_spread(ev, group: int = 64):
    """How far apart the lanes of a `group`-lane group are at one event
    row: (median, 90th percentile, maximum) over rows and groups of the
    spread of the block index the lanes are in (lanes past their last
    event left out).  A scatter that builds a band of blocks in shared
    memory while it walks the event rows would need a band this wide."""
    import torch

    N, L = ev.shape
    blk = torch.where(ev >= 0, (ev >> 18) & 0x1FFF, -1)
    cur = torch.cummax(blk, dim=0).values
    rows = torch.arange(N, device=ev.device)[:, None]
    last = torch.where(ev >= 0, rows, -1).amax(dim=0)
    live = (rows <= last[None, :]) & (cur >= 0)
    G = L // group
    cur = cur[:, : G * group].reshape(N, G, group)
    live = live[:, : G * group].reshape(N, G, group)
    hi = torch.where(live, cur, -1).amax(dim=2)
    lo = torch.where(live, cur, 1 << 20).amin(dim=2)
    spread = (hi - lo)[hi >= 0].to(torch.float32)
    q = torch.quantile(spread[:: max(1, spread.numel() // 1_000_000)],
                       torch.tensor([0.5, 0.9], device=ev.device))
    return int(q[0]), int(q[1]), int(spread.max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--repeat", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from tpujpeg_torch.ops import materialize
    from tpujpeg_torch.runtime import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    kernels.library()
    report = {"card": smi, "scan": {}, "place_events": {}}

    # ---- the scan in each use
    cases = scan_cases(args.repeat, dev)
    for case, (fn, plan) in cases.items():
        shape = list(plan.xs.shape)
        ms = cuda_ms(fn, args.iters)
        print(f"scan {case} {shape}: {ms:.4f} ms [{smi}]")
        report["scan"][case] = {"shape": shape, "ms": ms}

    # ---- place_events on the two restart chunks' events
    for case in ("restart", "4:2:0 restart"):
        fn, plan = cases[case]
        L = plan.xs.shape[0]
        ev = fn()[0].reshape(-1, L)
        M = plan.max_blk * 64
        n_valid = int((ev >= 0).sum())
        want = materialize.place_events(ev, M)
        lib = index_put_call(ev, M)
        if not torch.equal(lib(), want):
            print("index_put_ != place_events", file=sys.stderr)
            return 1

        def place():
            return materialize.place_events(ev, M)

        fill_bytes = 2 * M * L
        row = {
            "events": list(ev.shape), "dense": [M, L], "valid": n_valid,
            "fill_ms": cuda_ms(lambda: materialize.place_events(ev[:0], M),
                               args.iters),
            "kernel_ms": cuda_ms(place, args.iters),
            "index_put_ms": cuda_ms(lib, args.iters),
            "byte_bound_ms": (4 * ev.numel() + fill_bytes)
            / HBM_BYTES_PER_S * 1e3,
            "sector_bound_ms": (4 * ev.numel() + fill_bytes
                                + 64 * n_valid) / HBM_BYTES_PER_S * 1e3,
        }
        print(f"place_events {case} {row['events']} -> {row['dense']}, "
              f"{n_valid} valid events: fill alone {row['fill_ms']:.4f} ms; "
              f"the kernel with its fill {row['kernel_ms']:.4f} ms; "
              f"index_put_ {row['index_put_ms']:.4f} ms; byte bound "
              f"{row['byte_bound_ms']:.4f}, sector bound "
              f"{row['sector_bound_ms']:.4f} ms [{smi}]")
        row["block_spread_64_lanes"] = block_spread(ev)
        print(f"place_events {case}: at one event row the 64 lanes of a "
              f"group are spread over (median, p90, max) "
              f"{row['block_spread_64_lanes']} blocks of {plan.max_blk}")
        report["place_events"][case] = row
        del ev, want, lib
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"all times on: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
