"""Lockstep-lane Huffman decode of restart segments: the `gather` backend's
entropy stage.

Counterpart of tpujpeg/ops/entropy.py.  Every restart segment of a batch
is one lane (each starts byte-aligned with its DC predictors reset, so
the lanes are independent with no speculation); a lane walks its segment
one Huffman symbol at a time with a direct-indexed 16-bit-peek table per
Huffman table (`luts`: (length << 8) | symbol for every 16-bit window),
resolves DC DPCM per component, and writes each coefficient into a
zero-filled int32 [n_blocks_total, 64] tensor in zigzag order.

The host half (LUT_BITS, SegmentPlan, build_segment_plan) is a numpy copy
of the JAX package's and field-equal to it.  `decode_segments` runs
kernel csrc/segments.cu on CUDA tensors (one thread a lane, the bits in a
register, `luts` in two levels in shared memory: `segment_tables`,
derived on the host once per table set by `device_luts`) and
`decode_segments_plain`, the JAX step function as vector ops over lanes,
on CPU tensors.  The TPU design's step-major emit buffers and final
scatter are a TPU workaround and are not carried over: both versions
write in place.

Contract, bit for bit with the JAX decode_segments (its error edges
included): the 16-bit peek clamps its byte index at n_bytes - 4; a code
of length 0 (no Huffman code matches the window) latches the lane's err;
a lane still undone after `cap` steps (rounded up to a multiple of 256,
the JAX scan's chunk) latches err; an AC run past z = 63 ends the block
without an error and without a write; pad lanes (seg_n_blocks == 0) are
born done.  A write whose flat index lies outside [0, n_blocks_total *
64) is dropped (the JAX scatter's mode="drop").
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..errors import JpegError
from ..io.parser import JpegImage

LUT_BITS = 16
LUT_SIZE = 1 << LUT_BITS
_STEP_CHUNK = 256   # the JAX scan's chunk of steps (its `K`)
SEG_L1_BITS = 10    # the kernel's first level: the top bits of the peek
SEG_SUB = 1 << (LUT_BITS - SEG_L1_BITS)


# ---------------------------------------------------------------------------
# Host-side plan packing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SegmentPlan:
    """Device-ready flattened segment table for a batch of scans."""

    scan: np.ndarray            # uint8 [n_bytes] concatenated, padded
    seg_start_bits: np.ndarray  # int32 [L] absolute bit offset of segment
    seg_block_base: np.ndarray  # int32 [L] first global block index
    seg_n_blocks: np.ndarray    # int32 [L] blocks in segment (0 = pad lane)
    rows: np.ndarray            # int32 [L, n_comp, 2] LUT row per (comp, dc/ac)
    luts: np.ndarray            # int32 [n_rows, 65536] packed (len << 8) | sym
    pattern: np.ndarray         # int32 [bpm] component index per block in MCU
    cap: int                    # max decode steps (symbols) per lane
    n_blocks_total: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=64)
def _packed_lut_cached(key: bytes, counts: bytes, symbols: bytes) -> np.ndarray:
    from ..io.huffman import HuffmanTable

    table = HuffmanTable(
        counts=np.frombuffer(counts, np.uint8),
        symbols=np.frombuffer(symbols, np.uint8),
    )
    sym, length = table.build_lut(LUT_BITS)
    return (length.astype(np.int32) << 8) | sym.astype(np.int32)


def build_segment_plan(imgs: list[JpegImage]) -> SegmentPlan:
    """Flatten the restart segments of a batch into one lane axis.

    All images must share an MCU block pattern (the batch engine chunks by
    geometry).  Images without restart markers contribute a single
    whole-scan segment: still correct, just one lane of depth.
    """
    bpm = imgs[0].blocks_per_mcu
    pattern = np.asarray(imgs[0].mcu_block_pattern(), np.int32)
    n_comp = len(imgs[0].components)

    lut_rows: dict[bytes, int] = {}
    luts: list[np.ndarray] = []

    def row_of(table) -> int:
        key = table.counts.tobytes() + table.symbols.tobytes()
        if key not in lut_rows:
            lut_rows[key] = len(luts)
            luts.append(
                _packed_lut_cached(key, table.counts.tobytes(),
                                   table.symbols.tobytes())
            )
        return lut_rows[key]

    scans: list[np.ndarray] = []
    starts: list[np.ndarray] = []
    bases: list[np.ndarray] = []
    nblocks: list[np.ndarray] = []
    rows: list[np.ndarray] = []
    cap = 1
    byte_base = 0
    block_base = 0

    for img in imgs:
        if img.blocks_per_mcu != bpm or img.mcu_block_pattern() != list(pattern):
            raise JpegError("segment plan requires a uniform MCU block pattern")
        offs = img.segment_offsets.astype(np.int64)
        n_seg = offs.size
        ri = img.restart_interval or img.n_mcus
        seg_mcus = np.full(n_seg, ri, np.int64)
        seg_mcus[-1] = img.n_mcus - ri * (n_seg - 1)
        if np.any(seg_mcus <= 0):
            raise JpegError("inconsistent restart segmentation")
        seg_blocks = seg_mcus * bpm

        # every symbol consumes >= 1 bit and a block holds at most 65
        # symbols (DC, 63 AC, EOB): cap is the largest lane's tighter bound
        seg_end = np.append(offs[1:], img.scan_data.size)
        seg_bits = (seg_end - offs) * 8
        cap = max(cap, int(np.minimum(65 * seg_blocks, seg_bits + 65).max()))

        img_rows = np.empty((n_comp, 2), np.int32)
        for ci, c in enumerate(img.components):
            dc = img.huffman.get(c.dc_table_id)
            ac = img.huffman.get(0x10 | c.ac_table_id)
            if dc is None or ac is None:
                raise JpegError("scan references missing DHT table")
            img_rows[ci, 0] = row_of(dc)
            img_rows[ci, 1] = row_of(ac)

        scans.append(img.scan_data)
        starts.append((byte_base + offs) * 8)
        bases.append(block_base + np.cumsum(np.append(0, seg_blocks[:-1])))
        nblocks.append(seg_blocks)
        rows.append(np.broadcast_to(img_rows, (n_seg, n_comp, 2)))
        byte_base += img.scan_data.size
        block_base += img.n_mcus * bpm

    # lanes and the scan buffer padded to bucketed sizes, as in the JAX
    # package (its compile cache); pad lanes have 0 blocks
    L = int(sum(s.size for s in starts))
    L_pad = max(8, _round_up(L, 64))
    scan_len = _round_up(byte_base + 8, 1 << 16)
    scan = np.zeros(scan_len, np.uint8)
    scan[:byte_base] = np.concatenate(scans)

    def cat_pad(parts, fill):
        flat = np.concatenate(parts)
        out = np.full((L_pad,) + flat.shape[1:], fill, np.int32)
        out[:L] = flat
        return out

    return SegmentPlan(
        scan=scan,
        seg_start_bits=cat_pad(starts, 0),
        seg_block_base=cat_pad(bases, 0),
        seg_n_blocks=cat_pad(nblocks, 0),
        rows=cat_pad(rows, 0),
        luts=np.stack(luts),
        pattern=pattern,
        cap=_round_up(cap, 256),
        n_blocks_total=block_base,
    )


# ---------------------------------------------------------------------------
# Device decode
# ---------------------------------------------------------------------------


def _n_steps(cap: int) -> int:
    """Steps a lane may take: the JAX scan runs whole chunks of 256."""
    return _round_up(max(int(cap), 1), _STEP_CHUNK)


def decode_segments(scan: torch.Tensor, seg_start_bits: torch.Tensor,
                    seg_block_base: torch.Tensor, seg_n_blocks: torch.Tensor,
                    rows: torch.Tensor, luts: torch.Tensor,
                    pattern: torch.Tensor, *, cap: int,
                    n_blocks_total: int):
    """Lockstep-lane Huffman decode of all segments.

    scan uint8 [n_bytes] (n_bytes >= 4), seg_start_bits / seg_block_base
    / seg_n_blocks int32 [L], rows int32 [L, n_comp, 2] (n_comp <= 4),
    luts int32 [n_rows, 65536], pattern int32 [bpm] (bpm <= 16).

    Returns (coeffs int32 [n_blocks_total, 64] in zigzag order with DC
    DPCM resolved, err bool [L]: lanes that hit an invalid code or ran out
    of steps).  CUDA tensors run kernel "decode_segments"
    (csrc/segments.cu, on `device_segment_tables(luts)`: the tables
    `device_luts` keeps, else derived on the card for this call); CPU
    tensors run `decode_segments_plain`.
    """
    if not scan.is_cuda:
        return decode_segments_plain(
            scan, seg_start_bits, seg_block_base, seg_n_blocks, rows, luts,
            pattern, cap=cap, n_blocks_total=n_blocks_total)
    from ..runtime import kernels

    kernels.check_cuda_tensor("scan", scan, torch.uint8, 1)
    L = seg_start_bits.shape[0]
    for name, t in (("seg_start_bits", seg_start_bits),
                    ("seg_block_base", seg_block_base),
                    ("seg_n_blocks", seg_n_blocks)):
        kernels.check_cuda_tensor(name, t, torch.int32, 1)
        if t.shape[0] != L:
            raise ValueError(f"decode_segments: {name} must be [L={L}]")
    kernels.check_cuda_tensor("rows", rows, torch.int32, 3)
    kernels.check_cuda_tensor("luts", luts, torch.int32, 2)
    kernels.check_cuda_tensor("pattern", pattern, torch.int32, 1)
    n_comp, bpm = rows.shape[1], pattern.shape[0]
    if rows.shape[0] != L or rows.shape[2] != 2 or not 1 <= n_comp <= 4:
        raise ValueError("decode_segments: rows must be [L, n_comp <= 4, 2]")
    if luts.shape[1] != LUT_SIZE or not 1 <= bpm <= 16 or scan.numel() < 4:
        raise ValueError("decode_segments: bad luts, pattern or scan shape")
    dev = scan.device
    coeffs = torch.zeros((n_blocks_total, 64), dtype=torch.int32, device=dev)
    err = torch.empty(L, dtype=torch.bool, device=dev)
    if L == 0:
        return coeffs, err
    ctab, roff = device_segment_tables(luts)
    kernels.launch(
        "decode_segments",
        scan.data_ptr(), scan.numel(), seg_start_bits.data_ptr(),
        seg_block_base.data_ptr(), seg_n_blocks.data_ptr(), rows.data_ptr(),
        n_comp, ctab.data_ptr(), roff.data_ptr(), luts.shape[0],
        pattern.data_ptr(), bpm, _n_steps(cap), coeffs.data_ptr(),
        coeffs.numel(), err.data_ptr(), L, kernels.current_stream(dev),
    )
    return coeffs, err


def decode_segments_plain(scan: torch.Tensor, seg_start_bits: torch.Tensor,
                          seg_block_base: torch.Tensor,
                          seg_n_blocks: torch.Tensor, rows: torch.Tensor,
                          luts: torch.Tensor, pattern: torch.Tensor, *,
                          cap: int, n_blocks_total: int):
    """Plain PyTorch version of `decode_segments` (same contract): the JAX
    step function as vector ops over lanes, one symbol a step, the writes
    of a step scattered in place.  It stops at the first chunk of 256
    steps that starts with every lane done (the JAX scan skips those)."""
    dev = scan.device
    i64 = torch.int64
    L = seg_start_bits.shape[0]
    n_comp = rows.shape[1]
    bpm = pattern.shape[0]
    s = scan.to(i64)
    # big-endian 4-byte windows; a uint32 shift keeps the same bits 16-31
    windows = (s[:-3] << 24) | (s[1:-2] << 16) | (s[2:-1] << 8) | s[3:]
    n_words = windows.shape[0]
    luts_flat = luts.reshape(-1).to(i64)
    rows_flat = rows.reshape(-1).to(i64)
    pattern = pattern.to(i64)
    lane_row_base = torch.arange(L, dtype=i64, device=dev) * (n_comp * 2)
    comps = torch.arange(n_comp, dtype=i64, device=dev)[None, :]
    base = seg_block_base.to(i64)
    quota = seg_n_blocks.to(i64)
    n_out = n_blocks_total * 64
    coeffs = torch.zeros(n_out, dtype=torch.int32, device=dev)

    def peek16(p):
        w = windows[torch.clamp(p >> 3, max=n_words - 1)]
        return ((w << (p & 7)) >> 16) & 0xFFFF

    zero = torch.zeros(L, dtype=i64, device=dev)
    p, blk, k = seg_start_bits.to(i64), zero, zero
    dc = torch.zeros((L, n_comp), dtype=i64, device=dev)
    done = quota == 0
    err = torch.zeros(L, dtype=torch.bool, device=dev)
    for step in range(_n_steps(cap)):
        if step % _STEP_CHUNK == 0 and bool(done.all()):
            break
        comp = pattern[blk % bpm]
        is_dc = k == 0
        row = rows_flat[lane_row_base + comp * 2 + (~is_dc).to(i64)]
        code = luts_flat[row * LUT_SIZE + peek16(p)]
        clen = code >> 8
        sym = code & 0xFF
        bad = (clen == 0) & ~done
        p2 = p + clen
        size = torch.where(is_dc, sym, sym & 0x0F)
        run = torch.where(is_dc, 0, sym >> 4)
        # EXTEND; size in [0, 15]
        sz1 = torch.clamp(size, min=1)
        raw = peek16(p2) >> (16 - sz1)
        half = 1 << (sz1 - 1)
        val = torch.where(size == 0, 0,
                          torch.where(raw >= half, raw, raw - 2 * half + 1))
        p3 = p2 + size
        is_eob = ~is_dc & (sym == 0)
        z = torch.where(is_dc, 0, k + run)
        live = ~done & ~bad
        writes = live & ~is_eob & (z < 64)
        # DC DPCM is lane-local: restart segments reset the predictors
        dc = dc + torch.where(is_dc & live, val, 0)[:, None] * (
            comp[:, None] == comps)
        dc_here = dc.gather(1, comp[:, None])[:, 0]
        emit_val = torch.where(is_dc, dc_here, val)
        idx = (base + blk) * 64 + z
        keep = writes & (idx >= 0) & (idx < n_out)
        coeffs[idx[keep]] = emit_val[keep].to(torch.int32)
        k_after = torch.where(
            is_dc, 1, torch.where(is_eob | (z >= 64), 64, z + 1))
        block_done = k_after >= 64
        blk_next = blk + block_done.to(i64)
        k_next = torch.where(block_done, 0, k_after)
        p = torch.where(done, p, p3)
        blk = torch.where(done, blk, blk_next)
        k = torch.where(done, k, k_next)
        err = err | bad
        done = done | bad | (blk_next >= quota)
    return coeffs.reshape(n_blocks_total, 64), err | ~done


# ---------------------------------------------------------------------------
# The kernel's tables
# ---------------------------------------------------------------------------


def _packed(e: torch.Tensor) -> torch.Tensor:
    """luts entries (length << 8) | symbol with length + (symbol & 15), the
    bits the entry consumes with its magnitude bits, at bit 13."""
    return e | (((e >> 8) + (e & 15)) << 13)


def segment_tables(luts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`luts` in two levels, as csrc/segments.cu reads them, on luts' device.

    Returns (ctab int32 [words], roff int32 [n_rows + 1]): row r is
    ctab[roff[r]:roff[r + 1]], a first level of 1,024 words keyed on the
    top SEG_L1_BITS bits of the 16-bit peek, then one second level of 64
    words for each such prefix whose 64 peeks do not all share one luts
    entry (in prefix order), keyed on the low 6 bits.  An entry is
    `_packed` luts; a first level word of a mixed prefix is bit 31 | its
    second level's offset from the row.  Exact by construction for any
    luts whose entries have length <= 16 (`segment_table_lookup`).

    `device_luts` runs it on the host once per table set.  On a CUDA
    tensor it reads the table size and the mixed prefixes back to the
    host (two waits on the stream)."""
    dev = luts.device
    n = luts.shape[0]
    e = luts.reshape(n, 1 << SEG_L1_BITS, SEG_SUB)
    mixed = (e != e[:, :, :1]).any(dim=2)
    count = mixed.to(torch.int32)
    rank = torch.cumsum(count, dim=1, dtype=torch.int32) - count
    words = (1 << SEG_L1_BITS) + SEG_SUB * count.sum(dim=1)
    roff = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    roff[1:] = torch.cumsum(words, dim=0)
    sub_off = (1 << SEG_L1_BITS) + SEG_SUB * rank
    l1 = torch.where(mixed, sub_off | torch.iinfo(torch.int32).min,
                     _packed(e[:, :, 0]))
    ctab = torch.empty(int(roff[-1]), dtype=torch.int32, device=dev)
    q = torch.arange(1 << SEG_L1_BITS, device=dev)
    ctab[(roff[:-1, None] + q).reshape(-1)] = l1.reshape(-1)
    r, qm = mixed.nonzero(as_tuple=True)
    at = roff[r] + sub_off[r, qm]
    j = torch.arange(SEG_SUB, device=dev)
    ctab[(at[:, None] + j).reshape(-1)] = _packed(e[r, qm]).reshape(-1)
    return ctab, roff.to(torch.int32)


def segment_table_lookup(ctab: torch.Tensor, roff: torch.Tensor,
                         row: torch.Tensor,
                         peek: torch.Tensor) -> torch.Tensor:
    """Plain lookup in `segment_tables`, as the kernel does it: the entry of
    table `row` at the 16-bit `peek`, elementwise."""
    i64 = torch.int64
    base = roff.to(i64)[row.to(i64)]
    peek = peek.to(i64)
    e = ctab[base + (peek >> (LUT_BITS - SEG_L1_BITS))].to(i64)
    long = e < 0
    sub = ctab[torch.where(long, base + (e & 0x7FFFFFFF) + (peek & 63), 0)]
    return torch.where(long, sub.to(i64), e)


# ---------------------------------------------------------------------------
# Plans on a device
# ---------------------------------------------------------------------------

_lut_cache: dict = {}


def device_luts(luts: np.ndarray, device) -> torch.Tensor:
    """A plan's `luts` on `device`, cached per table set (keyed on the
    tables' bytes: a batch of one encoder's streams uploads them once).
    The entry keeps the kernel's `segment_tables` beside them, derived
    on the host and uploaded with them (`device_segment_tables`)."""
    key = (luts.tobytes(), luts.shape, str(device))
    hit = _lut_cache.get(key)
    if hit is None:
        host = torch.as_tensor(luts)
        hit = (host.to(device),
               tuple(t.to(device) for t in segment_tables(host)))
        if len(_lut_cache) >= 16:
            _lut_cache.clear()
        _lut_cache[key] = hit
    return hit[0]


def device_segment_tables(luts: torch.Tensor) -> tuple:
    """The kernel's tables for `luts`: those `device_luts` keeps beside it
    when `luts` came from there, else `segment_tables(luts)` anew."""
    for t, tables in _lut_cache.values():
        if t is luts:
            return tables
    return segment_tables(luts)


def plan_arrays(plan: SegmentPlan) -> tuple:
    """The per-chunk arrays a decode reads besides the cached luts, in
    the order `decode_plan` takes them uploaded."""
    return (plan.scan, plan.seg_start_bits, plan.seg_block_base,
            plan.seg_n_blocks, plan.rows, plan.pattern)


def decode_plan(plan: SegmentPlan, device="cuda", uploaded=None):
    """Decode a segment plan on `device` -> (coeffs int32
    [n_blocks_total, 64], err bool [L]), both on the device.  `uploaded`
    is `plan_arrays(plan)` already there."""
    if uploaded is None:
        uploaded = tuple(torch.as_tensor(a).to(device)
                         for a in plan_arrays(plan))
    scan, starts, bases, nblocks, rows, pattern = uploaded
    return decode_segments(
        scan, starts, bases, nblocks, rows,
        device_luts(plan.luts, scan.device), pattern,
        cap=plan.cap, n_blocks_total=plan.n_blocks_total)


def check_lanes(err: torch.Tensor) -> None:
    """Raise JpegError when any lane failed (one device read)."""
    if bool(err.any()):
        raise JpegError("device entropy decode failed (malformed scan)")


def entropy_decode_device(imgs: list[JpegImage], device="cuda") -> np.ndarray:
    """Decode a batch's scans on the device; returns int32 [total_blocks,
    64] on the host.

    Raises JpegError if any lane failed (malformed stream): callers fall
    back to the host runtime."""
    coeffs, err = decode_plan(build_segment_plan(imgs), device)
    check_lanes(err)
    return coeffs.cpu().numpy()
