"""Time table-lookup strategies on a CUDA card (tpujpeg_torch).

The port of tools/bench_gather.py.  Prints the card's name and power
limit, then milliseconds and nanoseconds per lookup for:

  1. torch index_select: 1M random indices into a 64Ki-entry table (the
     16-bit peek decode shape);
  2. the same into a 256-entry table (the symbol-map shape);
  3. a one-hot matrix product "gather" for the 256-entry table
     (torch.matmul; the arithmetic alternative to a lookup);
  4. whole-row gathers: 2,560 rows of 64 KiB (a lane permutation) and 1M
     rows of 256 B (the speculative assemble shape);
  5. torch.gather over [1024, 256] per-row tables, 1M lookups;
  6. kernel "gather_rows" on the same inputs (the row staged in shared
     memory), with torch.gather's time beside it;
  7. kernel "gather_table": a 256-entry table in shared memory, 256K
     indices, with index_select's time beside it;
  8. kernel "chain": 4,096 DEPENDENT lookups idx = (t[idx] * 7 + 1) %
     4096, one thread, the table read from L2, from shared memory and
     through the read-only cache path (the load the scan kernel uses).
     The time per dependent step is taken from the difference between a
     65,536-step and a 4,096-step walk, so the launch and the staging of
     the table cancel.

Each kernel is checked against its plain version first.  Times are CUDA
events, the median of 5 warm runs.  Needs a CUDA card.  Run from the repo
root:
    python tools/bench_torch_gather.py
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHAIN = 4096
CHAIN_LONG = 65536


def cuda_ms(fn, reps: int = 5) -> float:
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


def report(label: str, ms: float, n_lookups: int, beside: str = "") -> None:
    print(f"{label:<56s} {ms:9.4f} ms  {ms / n_lookups * 1e6:9.3f} ns/lookup"
          f"{beside}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from tpujpeg_torch.ops import probes

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    N = 1 << 20

    def on_card(a):
        return torch.as_tensor(a).to(dev)

    lut64k = on_card(rng.integers(0, 255, 1 << 16, np.int32))
    lut256 = on_card(rng.integers(0, 255, 256, np.int32))
    idx64k = on_card(rng.integers(0, 1 << 16, N).astype(np.int32))
    idx256 = on_card(rng.integers(0, 256, N).astype(np.int32))
    idx64k_l, idx256_l = idx64k.long(), idx256.long()

    report("torch index_select, 64Ki table, 1M independent",
           cuda_ms(lambda: lut64k.index_select(0, idx64k_l)), N)
    report("torch index_select, 256 table, 1M independent",
           cuda_ms(lambda: lut256.index_select(0, idx256_l)), N)

    arange = torch.arange(256, device=dev)
    lut256_f = lut256.to(torch.float32)

    def onehot_gather():
        oh = (idx256[:, None] == arange[None, :]).to(torch.float32)
        return torch.matmul(oh, lut256_f).to(torch.int32)

    check = onehot_gather()
    assert torch.equal(check, probes.gather_table_plain(lut256, idx256))
    report("one-hot torch.matmul, 256 table, 1M independent",
           cuda_ms(onehot_gather), N)

    rows = on_card(rng.integers(-1000, 1000, (2560, 256 * 64), np.int32))
    perm = on_card(rng.permutation(2560)).long()
    report("torch index_select, 2560 rows x 64 KiB (lane permutation)",
           cuda_ms(lambda: rows.index_select(0, perm)), 2560)
    del rows
    rows64 = on_card(rng.integers(-1000, 1000, (N, 64), np.int32))
    perm64 = on_card(rng.permutation(N)).long()
    report("torch index_select, 1M rows x 256 B (spec assemble)",
           cuda_ms(lambda: rows64.index_select(0, perm64)), N)
    del rows64, perm64

    R, K = 1024, 1024
    tbl2d = on_card(np.broadcast_to(
        rng.integers(0, 255, 256, np.int32), (R, 256)).copy())
    idx2d = on_card(rng.integers(0, 256, (R, K)).astype(np.int32))
    idx2d_l = idx2d.long()
    lib_ms = cuda_ms(lambda: torch.gather(tbl2d, 1, idx2d_l))
    report("torch.gather, [1024, 256] tables, 1M", lib_ms, R * K)

    got = probes.gather_rows(tbl2d, idx2d)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.gather_rows_plain(tbl2d, idx2d))
    report("kernel gather_rows (shared memory), [1024, 256], 1M",
           cuda_ms(lambda: probes.gather_rows(tbl2d, idx2d)), R * K,
           f"  (torch.gather {lib_ms:.4f} ms)")

    Nv = 1 << 18
    iv = idx256[:Nv].contiguous()
    iv_l = iv.long()
    got = probes.gather_table(lut256, iv)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.gather_table_plain(lut256, iv))
    lib_ms = cuda_ms(lambda: lut256.index_select(0, iv_l))
    report("kernel gather_table (shared memory), 256 table, 256K",
           cuda_ms(lambda: probes.gather_table(lut256, iv)), Nv,
           f"  (index_select {lib_ms:.4f} ms)")

    tbl = on_card(rng.integers(0, CHAIN, (CHAIN, 1), np.int32))
    seed = on_card(np.asarray([3], np.int32))
    want = {n: probes.chain_plain(tbl, seed, n) for n in (CHAIN, CHAIN_LONG)}
    for source in probes.CHAIN_SOURCES:
        for n in (CHAIN, CHAIN_LONG):
            got = probes.chain(tbl, seed, n, source)
            torch.cuda.synchronize()
            assert torch.equal(got, want[n]), (source, n)
        short = cuda_ms(lambda: probes.chain(tbl, seed, CHAIN, source))
        long = cuda_ms(lambda: probes.chain(tbl, seed, CHAIN_LONG, source))
        step_ns = (long - short) / (CHAIN_LONG - CHAIN) * 1e6
        report(f"kernel chain, table from {source}, {CHAIN} dependent",
               short, CHAIN,
               f"  ({CHAIN_LONG} steps {long:.4f} ms; {step_ns:.2f} ns per "
               f"dependent step net of launch)")
    print(f"all times on: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
