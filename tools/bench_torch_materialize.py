"""Time the stages of the events -> dense materialization on a CUDA card
(tpujpeg_torch).

The port of tools/bench_materialize2.py.  The events come from a
committed corpus (16 streams x 8 = one 128-image chunk):

    python tools/bench_torch_materialize.py \
        [--corpus rst640|rst640_420|mixed_rst] [--repeat 8] [--window 1024]

Prints the card's name and power limit, then milliseconds for:

  scan -> events                    kernel "fsm_scan" (pad_info mode for
                                    the mixed-size corpus);
  place_events (full)               the production scatter, with one
                                    PyTorch index_put_ beside it;
  offsets init                      the column cumsum (torch ops);
  compact (fine + coarse)           `probes.compact_staged`: kernel
                                    "compact_offsets" with mask W - 1, then
                                    with mask ~(W - 1);
  compact fine stage only           `probes.compact_fine` (the masked
                                    walk), with the share of its events
                                    stored directly (behind the window)
                                    and one PyTorch call beside it;
  compact, one launch               `materialize.compact_offsets`, with
                                    one PyTorch call beside it;
  spread                            `probes.spread_ranked`: kernel
                                    "spread_full" on the compact's output,
                                    with index_put_ beside it;
  transpose + reshape + DC cumsum   torch ops.

Each kernel is checked against its plain version first, and the staged
compact against the one-launch compact.  The PyTorch call of a compact
(`compact_index_put_call`) is a zero fill of p, a -1 fill of o and two
index_put_, its indices and values prepared outside; it is checked equal
to the kernel.  Times are CUDA events, the
median of `--iters` warm runs.  Needs a CUDA card.  Run from the repo
root.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CORPORA = ("rst640", "rst640_420", "mixed_rst")


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


def compact_index_put_call(p, o, mask: int = -1):
    """One PyTorch call for `materialize.compact_offsets(p, o, mask)`: a
    zero fill of p_out, a -1 fill of o_out and the two index_put_, with
    the destinations row - (o & mask), lanes and values prepared
    outside."""
    import torch

    Np, L = p.shape
    row = torch.arange(Np, dtype=torch.int64, device=p.device)[:, None]
    off = o.to(torch.int64)
    dst = row - (off & mask)
    valid = (o >= 0) & (dst >= 0)
    idx = (dst[valid],
           torch.arange(L, device=p.device).expand(Np, L)[valid])
    pv = p[valid]
    ov = (off - (off & mask))[valid].to(o.dtype)
    p_out = torch.empty_like(p)
    o_out = torch.empty_like(o)

    def call():
        p_out.zero_()
        o_out.fill_(-1)
        p_out.index_put_(idx, pv)
        o_out.index_put_(idx, ov)
        return p_out, o_out

    return call


def scan_events(corpus: str, repeat: int, dev):
    """(events int32 [N, L], the lane plan, the scan as a callable) of
    one chunk of `corpus` on `dev`."""
    import torch

    from tpujpeg_torch.io.parser import parse_file
    from tpujpeg_torch.ops import fsm
    from tpujpeg_torch.pipeline import Geometry, bucket_geometry

    folder = os.path.join(ROOT, "tests", "fixtures", corpus)
    names = sorted(n for n in os.listdir(folder) if n.endswith(".jpg"))
    imgs = [parse_file(os.path.join(folder, n)) for n in names] * repeat
    if corpus.startswith("mixed"):
        buckets = {bucket_geometry(Geometry.of(im)) for im in imgs}
        if len(buckets) != 1:
            raise SystemExit(f"{corpus}: {len(buckets)} size-class buckets; "
                             "this tool times one chunk")
        plan = fsm.build_plan_bucketed(imgs, buckets.pop())
        xs, sn, wrap_at, skip = (
            torch.as_tensor(a).to(dev)
            for a in (plan.xs, plan.seg_n, plan.wrap_at, plan.skip))

        def scan():
            return fsm.fsm_scan(xs, sn, plan.tables,
                                pad_info=(wrap_at, skip))
    else:
        plan = fsm.build_plan(imgs, split=False)
        xs = torch.as_tensor(plan.xs).to(dev)
        sn = torch.as_tensor(plan.seg_n_blocks).to(dev)

        def scan():
            return fsm.fsm_scan(xs, sn, plan.tables)

    events, err_mal, err_env = scan()
    if bool(err_mal.any() | err_env.any()):
        raise SystemExit(f"{corpus}: the scan latched lanes")
    L = xs.shape[0]
    return events.reshape(-1, L), plan, scan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", choices=CORPORA, default="rst640")
    ap.add_argument("--repeat", type=int, default=8)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from tpujpeg_torch.ops import fsm, materialize, probes

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    W = args.window or probes.FINE_W
    ev, plan, scan = scan_events(args.corpus, args.repeat, dev)
    N, L = ev.shape
    M = plan.max_blk * 64
    fill = float((ev >= 0).float().mean())
    print(f"corpus {args.corpus} x {args.repeat}: events N={N} L={L} "
          f"fill={fill:.2f} M={M} window W={W}")

    def timed(label, fn, beside=""):
        print(f"{label:<52s} {cuda_ms(fn, args.iters):9.4f} ms{beside}")

    def index_put_call(events_t, valid):
        """One PyTorch call for events -> dense: a zero fill and one
        index_put_, its indices and values prepared outside."""
        e = events_t[valid].to(torch.int64)
        tgt = ((e >> 18) & 0x1FFF) * 64 + ((e >> 12) & 63)
        lanes = torch.arange(L, device=dev).expand(events_t.shape)[valid]
        vals = ((e & 0xFFF) - 2048).to(torch.int16)
        out = torch.empty((M, L), dtype=torch.int16, device=dev)

        def call():
            out.zero_()
            return out.index_put_((tgt, lanes), vals)

        return call

    timed("scan -> events (fsm_scan)", scan)
    dense = materialize.place_events(ev, M)
    assert torch.equal(dense, materialize.place_events_plain(ev, M))
    lib = index_put_call(ev, ev >= 0)
    assert torch.equal(lib(), dense)
    timed("place_events (full)", lambda: materialize.place_events(ev, M),
          f"  (index_put_ {cuda_ms(lib, args.iters):.4f} ms)")
    del lib

    p0, o0 = probes.offsets_init(ev)
    timed("  offsets init (column cumsum, torch)",
          lambda: probes.offsets_init(ev))
    fine = probes.compact_fine(p0, o0, W)
    staged = probes.compact_staged(p0, o0, W)
    whole = materialize.compact_offsets(p0, o0)
    torch.cuda.synchronize()
    for got, want in ((fine, probes.compact_fine_plain(p0, o0, W)),
                      (staged, probes.compact_staged_plain(p0, o0, W)),
                      (staged, whole)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    moved = int(((o0 >= 0) & ((o0.to(torch.int32) & (W - 1)) > 0)).sum())
    n_valid = int((o0 >= 0).sum())
    direct = torch.zeros(1, dtype=torch.int32, device=dev)
    materialize.compact_offsets(p0, o0, mask=W - 1, direct=direct)
    n_direct = int(direct[0])
    print(f"  fine stage moves {moved} of {n_valid} events; largest offset "
          f"{int(o0.max())}; the masked walk stores {n_direct} directly "
          f"(behind its window), a share of {n_direct / max(n_valid, 1):.4f}")
    lib_fine = compact_index_put_call(p0, o0, W - 1)
    lib_whole = compact_index_put_call(p0, o0)
    for call, want in ((lib_fine, fine), (lib_whole, staged)):
        got = call()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    timed("  compact (fine + coarse, compact_offsets x2)",
          lambda: probes.compact_staged(p0, o0, W))
    timed("  compact fine stage only (compact_offsets, mask)",
          lambda: probes.compact_fine(p0, o0, W),
          f"  (fills + index_put_ {cuda_ms(lib_fine, args.iters):.4f} ms)")
    timed("  compact, one launch (compact_offsets)",
          lambda: materialize.compact_offsets(p0, o0),
          f"  (fills + index_put_ {cuda_ms(lib_whole, args.iters):.4f} ms)")
    del fine, whole, lib_fine, lib_whole

    cp, co = staged
    out16 = probes.spread_ranked(cp, co, M)
    assert torch.equal(out16, probes.spread_ranked_plain(cp, co, M))
    assert torch.equal(out16, dense)
    lib = index_put_call(cp, co >= 0)
    assert torch.equal(lib(), out16)
    timed("  spread (spread_full with offsets)",
          lambda: probes.spread_ranked(cp, co, M),
          f"  (index_put_ {cuda_ms(lib, args.iters):.4f} ms)")
    del lib, dense

    def dc_and_layout():
        per_lane = out16.T.reshape(L, plan.max_blk, 64)
        return fsm._dc_cumsum(per_lane[:, :, 0], plan.tables, plan.max_blk)

    timed("  transpose + reshape + DC cumsum (torch)", dc_and_layout)
    print(f"all times on: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
