"""Lookup and materialize-stage probes: the kernels that the measurement
tools time (tools/bench_torch_gather.py, tools/bench_torch_materialize.py).

Counterparts of the six Pallas kernels of tools/bench_gather.py and
tools/bench_materialize2.py:

  gather_rows     vkernel2: out[r, j] = t[r, i[r, j]], the per-row gather
                  `take_along_axis(t, i, axis=1)` with the tables resident
                  in fast memory (kernel "gather_rows", csrc/probes.cu);
  gather_table    vkernel: out[j] = t[i[j]] from one small table resident
                  in fast memory (kernel "gather_table");
  chain           skernel: `steps` dependent lookups
                  idx = (t[idx] * 7 + 1) % T from a seed, one scalar walk
                  (kernel "chain"; the table read from L2, from shared
                  memory or through the read-only cache path);
  compact_fine    compact_fine_only: the fine compact stage alone, every
                  valid (p, o) entry moved up by o & (W - 1) with the
                  residual offset o & ~(W - 1) kept
                  (`materialize.compact_offsets(mask=W - 1)`: the masked
                  walk of csrc/compact.cuh);
  compact_staged  compact_only: the fine stage then the coarse stages
                  (`compact_offsets(mask=~(W - 1))`, on the multiples of W
                  the fine stage leaves: the ranked walk), equal to one
                  full `compact_offsets`;
  spread_ranked   spread_only: compacted (p, o) -> dense int16 [M, L],
                  validity from o >= 0 (`materialize.spread_full`).

The last three reuse the kernels of csrc/routes.cu; `offsets_init` is the
column cumsum both tools start from.  Every wrapper launches its CUDA
kernel for CUDA tensors and runs its plain PyTorch version (`*_plain`)
for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import functools

import torch

from . import materialize

CHAIN_SOURCES = {"l2": 0, "shared": 1, "readonly": 2}
MAX_SHARED_TABLE = 12288   # int32 entries in 48 KB of shared memory
FINE_W = 1024              # the JAX package's fine window (materialize._W)

# The gathers' grids (csrc/probes.cu, whose constants these copy):
# blocks of THREADS threads, BLOCKS_PER_SM of them an SM (the kernels'
# __launch_bounds__), TABLE_PASS 4-lookup index vectors a thread of
# gather_table loads before its first lookup (kTablePass), and a row a
# warp where eight warps' tables fit 48 KB (kWarpRowsMaxTable).
THREADS = 256
BLOCKS_PER_SM = 4
TABLE_PASS = 4
WARP_ROWS_MAX_TABLE = MAX_SHARED_TABLE // (THREADS // 32)   # 1536


def gather_rows_geometry(R: int, T: int, K: int,
                         sms: int) -> tuple[int, int]:
    """(blocks, group) of `gather_rows` on a card of `sms` SMs: `group`
    threads share a row's table (32, a row a warp, where T <= 1536, else
    256, a row a block); the grid is at most BLOCKS_PER_SM blocks an SM
    and strides over the rows.  blocks == 0: nothing to launch (R == 0 or
    K == 0)."""
    group = 32 if T <= WARP_ROWS_MAX_TABLE else THREADS
    blocks = 0 if R == 0 or K == 0 else min(
        -(-R // (THREADS // group)), sms * BLOCKS_PER_SM)
    return blocks, group


def gather_table_blocks(N: int, sms: int) -> int:
    """Blocks of `gather_table` on a card of `sms` SMs: at most
    BLOCKS_PER_SM an SM and no more than gives every thread one whole pass
    of TABLE_PASS index vectors.  0: nothing to launch (N == 0)."""
    if N == 0:
        return 0
    return min(max(1, -(-(N // 4) // (THREADS * TABLE_PASS))),
               sms * BLOCKS_PER_SM)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SM count of CUDA device `device_index`."""
    return torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


def gather_rows_plain(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `gather_rows` (same contract)."""
    return torch.gather(t, 1, idx.to(torch.int64))


def gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t int32 [R, T], idx int32 [R, K] in [0, T) -> int32 [R, K] with
    out[r, j] = t[r, idx[r, j]].  CUDA tensors run kernel "gather_rows"
    (a row's table staged in shared memory, a row a warp or a block,
    16-byte index loads and stores; `gather_rows_geometry`; no launch
    when R or K is 0); CPU tensors the plain version."""
    if not t.is_cuda:
        return gather_rows_plain(t, idx)
    from ..runtime import kernels

    kernels.check_cuda_tensor("t", t, torch.int32, 2)
    kernels.check_cuda_tensor("idx", idx, torch.int32, 2)
    R, T = t.shape
    K = idx.shape[1]
    if idx.shape[0] != R:
        raise ValueError("gather_rows: t and idx must have one row count")
    if T > MAX_SHARED_TABLE:
        raise ValueError(f"gather_rows: {T} entries exceed shared memory")
    blocks, group = gather_rows_geometry(R, T, K, sm_count(t.device.index))
    out = torch.empty_like(idx)
    if blocks:
        kernels.launch("gather_rows", t.data_ptr(), idx.data_ptr(),
                       out.data_ptr(), R, T, K, blocks, group,
                       kernels.current_stream(t.device))
    return out


def gather_table_plain(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `gather_table` (same contract)."""
    return t[idx.to(torch.int64)]


def gather_table(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t int32 [T], idx int32 [N] in [0, T) -> int32 [N], out[j] =
    t[idx[j]].  CUDA tensors run kernel "gather_table" (the table staged
    in shared memory by every block of a grid sized to the card, a
    grid-stride walk of 16-byte index vectors; `gather_table_blocks`;
    no launch when N is 0); CPU tensors the plain version."""
    if not t.is_cuda:
        return gather_table_plain(t, idx)
    from ..runtime import kernels

    kernels.check_cuda_tensor("t", t, torch.int32, 1)
    kernels.check_cuda_tensor("idx", idx, torch.int32, 1)
    T, N = t.shape[0], idx.shape[0]
    if T > MAX_SHARED_TABLE:
        raise ValueError(f"gather_table: {T} entries exceed shared memory")
    blocks = gather_table_blocks(N, sm_count(t.device.index))
    out = torch.empty_like(idx)
    if blocks:
        kernels.launch("gather_table", t.data_ptr(), idx.data_ptr(),
                       out.data_ptr(), T, N, blocks,
                       kernels.current_stream(t.device))
    return out


def chain_plain(t: torch.Tensor, seed: torch.Tensor,
                steps: int) -> torch.Tensor:
    """Plain version of `chain`: the walk on the host over the table's
    values (a dependent chain has no tensor form)."""
    tab = t.reshape(-1).tolist()
    T = len(tab)
    idx = int(seed[0])
    for _ in range(steps):
        idx = (tab[idx] * 7 + 1) % T
    return torch.tensor([idx], dtype=torch.int32, device=t.device)


def chain_reciprocal(T: int) -> tuple[int, int]:
    """(magic, l) of kernel "chain"'s step for a table of T entries, 1 <=
    T < 2^31: l = ceil(log2 T), magic = ceil(2^(31 + l) / T) < 2^32, so
    that a % T = `mod_reciprocal(a, T, magic, l)` for every 0 <= a <
    2^31 (csrc/probes.cu::mod_reciprocal)."""
    if not 1 <= T < 2 ** 31:
        raise ValueError(f"chain: {T} entries")
    l = (T - 1).bit_length()
    return -(-(1 << (31 + l)) // T), l


def mod_reciprocal(a: int, T: int, magic: int, l: int) -> int:
    """a % T as the kernel computes it: one 32-bit multiply-high of 2a by
    magic, a shift by l, a multiply-subtract."""
    q = ((2 * a * magic) >> 32) >> l
    return a - q * T


def chain(t: torch.Tensor, seed: torch.Tensor, steps: int,
          source: str = "l2") -> torch.Tensor:
    """`steps` dependent lookups idx = (t[idx] * 7 + 1) % T.

    t int32 [T] or [T, 1] with values in [0, 2^28), seed int32 [1] in
    [0, T) -> int32 [1], the last index.  source names where the CUDA
    kernel reads the table: "l2" (ld.global.cg), "shared" (staged first,
    T <= 12288) or "readonly" (ld.global.nc, the scan kernel's table
    load); all three give the same result.  The kernel reduces by a mask
    where T is a power of two and by `chain_reciprocal(T)` elsewhere.
    CPU tensors run the plain version."""
    if source not in CHAIN_SOURCES:
        raise ValueError(f"chain: unknown source {source!r}")
    if not t.is_cuda:
        return chain_plain(t, seed, steps)
    from ..runtime import kernels

    flat = t.reshape(-1)
    kernels.check_cuda_tensor("t", flat, torch.int32, 1)
    kernels.check_cuda_tensor("seed", seed, torch.int32, 1)
    T = flat.shape[0]
    if source == "shared" and T > MAX_SHARED_TABLE:
        raise ValueError(f"chain: {T} entries exceed shared memory")
    magic, l = (0, 0) if T & (T - 1) == 0 else chain_reciprocal(T)
    out = torch.empty(1, dtype=torch.int32, device=t.device)
    kernels.launch("chain", flat.data_ptr(), seed.data_ptr(), out.data_ptr(),
                   T, steps, CHAIN_SOURCES[source], magic, l,
                   kernels.current_stream(t.device))
    return out


def offsets_init(ev: torch.Tensor):
    """Packed events int32 [N, L] -> (p int32, o int16) [N, L]: o = row -
    rank on valid rows (-1 elsewhere), p the event (0 elsewhere).  The
    column cumsum both materialize probes start from (torch ops, as it is
    XLA in the JAX tool)."""
    return materialize.compact_to_rank(ev, rank_kernel=False,
                                       stop_after="init")


def _fine_mask(W: int) -> int:
    if W < 1 or W & (W - 1):
        raise ValueError(f"fine window {W} is not a power of two")
    return W - 1


def compact_fine_plain(p: torch.Tensor, o: torch.Tensor, W: int = FINE_W):
    """Plain PyTorch version of `compact_fine` (same contract)."""
    return materialize.compact_offsets_plain(p, o, mask=_fine_mask(W))


def compact_fine(p: torch.Tensor, o: torch.Tensor, W: int = FINE_W):
    """The fine compact stage alone: each valid entry of (p int32, o
    int16) [Np, L] moves up by o & (W - 1) and keeps the residual offset
    o & ~(W - 1); empty rows hold p == 0, o == -1.  Contract of the JAX
    package's _fine_compact_kernel at kc = 1 with window W.  The kernel
    of `compact_offsets` with mask W - 1, counted as "compact_fine"."""
    return materialize.compact_offsets(p, o, mask=_fine_mask(W),
                                       counted_as="compact_fine")


def compact_staged_plain(p: torch.Tensor, o: torch.Tensor, W: int = FINE_W):
    """Plain PyTorch version of `compact_staged` (same contract)."""
    m = _fine_mask(W)
    return materialize.compact_offsets_plain(
        *materialize.compact_offsets_plain(p, o, mask=m), mask=~m)


def compact_staged(p: torch.Tensor, o: torch.Tensor, W: int = FINE_W):
    """The whole compact from (p, o) in the two groups of stages of the
    JAX package's network: the fine stage (offset bits below W), then the
    coarse stages (the bits from W up).  Equal to one full
    `materialize.compact_offsets`.  Two launches of its kernel, counted
    as "compact_staged"."""
    m = _fine_mask(W)
    fine = materialize.compact_offsets(p, o, mask=m,
                                       counted_as="compact_staged")
    return materialize.compact_offsets(*fine, mask=~m,
                                       counted_as="compact_staged")


def spread_ranked_plain(p: torch.Tensor, o: torch.Tensor,
                        M: int) -> torch.Tensor:
    """Plain PyTorch version of `spread_ranked` (same contract)."""
    return materialize.spread_full_plain(p, M, o=o)


def spread_ranked(p: torch.Tensor, o: torch.Tensor, M: int) -> torch.Tensor:
    """Compacted (p int32, o int16) [Np, L] -> dense int16 [M, L]: every
    row with o >= 0 is unpacked and stored at row 64 * blk + z of its
    lane.  The kernel of `spread_full` with validity from the offsets,
    counted as "spread_ranked"."""
    return materialize.spread_full(p, M, o=o, counted_as="spread_ranked")
