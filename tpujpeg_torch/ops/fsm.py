"""Huffman symbol FSM: host tables and plans, the scan (kernel 1),
materialize and the DC resolve, for restart lanes and for the
speculative decode of streams without restart markers.

Counterpart of tpujpeg/ops/fsm.py.  In restart mode each lane is one
restart segment; the scan walks byte columns, refills each lane's 32-bit
bit buffer one byte per column and runs K symbol steps per column.  One
step decodes a Huffman code and its magnitude bits, and also absorbs a
trailing EOB and a trailing size-0 DC code when the next bits are exactly
those codes.  Decoded coefficients leave as packed events
`blk << 18 | z << 12 | (val + 2048)` (-1 = empty slot), DC as DPCM
differences (a size-0 DC emits nothing); `_dc_cumsum` resolves the
predictors per lane afterwards.

Two error classes latch per lane: malformed (invalid code, coefficient
index overrun, truncation) and outside-envelope (the bit buffer would
overflow: more than K symbols per byte sustained).  Callers retry an
envelope chunk at STEPS_SAFE and send the rest to the host decoder.

The host half (FsmTables, build_tables, FsmPlan, build_plan) is a numpy
copy of the JAX package's, without the TPU's two-level symbol map.  The
contract of the symbol lookup is a flat per-table map of all 65,536
16-bit peeks to (length, symbol) (`symbol_lut`), exact by construction;
it stays on the host, where the plain scan reads it.  The kernel reads
`scan_table`, the same map folded into two levels (a first level on the
top 10 bits of the peek, 64-entry second levels for the longer codes,
about 19 KB) so that every warp keeps it in shared memory.

On the card the scan is bound by latency: one thread per lane, a few
hundred warps, and the kernel takes as long as its slowest warp needs
for the longest lane.  csrc/fsm_scan.cu shortens what a byte column
costs a warp (a symbol step without branches, tables and scan bytes in
shared memory) and says what was measured and left out.

`build_plan` packs a chunk into one stride class or, with split=True
(its default, as in the JAX package), two; a plan of two decodes
through the staged chain (`decode_plan`: a scan per group, the rows put
back in lane order by `perm`; `assemble` on the host or
`assemble_batched` on the device; `entropy_decode_fsm` over both).

Mixed-size chunks pack into bucket-raster lanes (`build_plan_bucketed`):
every image of a size-class bucket gives the same number of lanes, and
the scan's `pad_info` mode emits each event at its position in the
bucket's padded MCU raster, so assembly is one static reshape.

Streams without restart markers that do not fit one lane per image take
the speculative decode at the end of this module (single pass with
anchor logs, Jacobi fixed point as its fallback; `decode_speculative`
for one image, host lists from device_out=False).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..errors import JpegError
from ..io.huffman import HuffmanTable
from ..io.parser import JpegImage

MAX_BLOCKS_PER_LANE = 8191  # blk field is 13 bits in the packed event
MAX_PIECES = 512
STEPS_PRODUCTION = (1, 2)   # (bytes per scan column, symbol steps per column)
STEPS_SAFE = 3              # retry spec: 1-byte columns, 3 steps per byte
FLUSH_COLS = 6              # trailing no-refill columns to drain buffers
INVALID_LEN = 31            # code length marking a table's invalid top gap
N_TABLES = 4                # tbl = set (DC) or set + 2 (AC), two sets


def _steps_spec(steps) -> tuple:
    """Normalize a steps spec -> (bytes_per_col, steps_per_col)."""
    if isinstance(steps, tuple):
        return steps
    return (1, steps)


def steps_below_safe(steps) -> bool:
    """True when retrying at STEPS_SAFE decodes strictly more symbols per
    byte (an err_env under `steps` is worth one on-device retry)."""
    if not steps:
        return False
    bpc, k = _steps_spec(steps)
    sb, ks = _steps_spec(STEPS_SAFE)
    return k * sb < ks * bpc


def _scan_steps(steps, spec: bool = False) -> tuple:
    """A steps spec normalized to (bytes per column, symbol steps per
    column), checked as the JAX scan asserts it: 1 <= bpc <= 4 and k >=
    bpc; the speculative modes (spec=True) take 1-byte columns only, whose
    partial first byte is per byte.  Raises ValueError otherwise."""
    bpc, k = _steps_spec(steps)
    if not 1 <= bpc <= 4 or k < bpc:
        raise ValueError(f"bad steps spec {steps!r}")
    if spec and bpc > 1:
        raise ValueError(
            f"steps spec {steps!r}: multi-byte columns require restart mode")
    return bpc, k


# ---------------------------------------------------------------------------
# Host-side table compilation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FsmTables:
    """Per-batch Huffman constants (hashable).

    piece_keys : sorted (tbl << 16 | leftcode16) piece boundaries; the
                 piece holding a 16-bit peek is the last with key <=
                 (tbl << 16 | peek16).
    piece_vals : packed (length << 17 | base + 0x10000); for a peek in the
                 piece, sym = base + (peek >> (16 - length)); length ==
                 INVALID_LEN marks the invalid gap above the last code.
    eob_len/code : per table set, the AC table's EOB code (length 0: none).
    dc0_len/code : per table set, the DC table's size-0 code.
    tsel[bim]  : table set (0/1) of MCU block bim.
    comp[bim]  : component index of MCU block bim.
    n_comp     : number of frame components.
    """

    piece_keys: tuple
    piece_vals: tuple
    eob_len: tuple
    eob_code: tuple
    dc0_len: tuple
    dc0_code: tuple
    tsel: tuple
    comp: tuple
    n_comp: int


def _table_pieces(table: HuffmanTable, tbl_id: int):
    """Pieces of one canonical table in left-aligned 16-bit peek space."""
    counts = np.asarray(table.counts, np.int64)
    symbols = np.asarray(table.symbols, np.int64)
    pieces = []  # (key, length, base)
    code = 0
    k = 0
    cover_end = 0
    for length in range(1, 17):
        n = int(counts[length - 1])
        if n:
            run_start = 0
            for i in range(1, n + 1):
                if i == n or symbols[k + i] != symbols[k + i - 1] + 1:
                    c0 = code + run_start
                    pieces.append(
                        ((c0 << (16 - length)), length,
                         int(symbols[k + run_start]) - c0)
                    )
                    run_start = i
            k += n
            code += n
            cover_end = code << (16 - length)
        code <<= 1
    if cover_end < (1 << 16):  # invalid top gap (all-ones region, T.81 C.2)
        pieces.append((cover_end, INVALID_LEN, 0))
    return [((tbl_id << 16) | key, (length << 17) | (base + 0x10000))
            for (key, length, base) in pieces]


_tables_cache: dict = {}
_tables_lock = threading.Lock()


def _tables_key(img: JpegImage) -> tuple:
    return (
        tuple(
            (h, t.counts.tobytes(), t.symbols.tobytes())
            for h, t in sorted(img.huffman.items())
        ),
        tuple((c.dc_table_id, c.ac_table_id, c.h, c.v) for c in img.components),
    )


def build_tables(img: JpegImage) -> FsmTables:
    """Compile the scan's Huffman tables into FSM constants (cached on the
    DHT/SOS content).  Raises JpegError outside the FSM's envelope."""
    key = _tables_key(img)
    with _tables_lock:
        hit = _tables_cache.get(key)
    if hit is not None:
        if isinstance(hit, JpegError):
            raise hit
        return hit
    try:
        tables = _build_tables_uncached(img)
    except JpegError as e:
        with _tables_lock:
            if len(_tables_cache) < 256:
                _tables_cache[key] = e
        raise
    with _tables_lock:
        if len(_tables_cache) < 256:
            _tables_cache[key] = tables
    return tables


def _build_tables_uncached(img: JpegImage) -> FsmTables:
    set_of: dict[int, int] = {}  # table id -> set index (0/1)
    for c in img.components:
        if c.dc_table_id != c.ac_table_id:
            raise JpegError("fsm: component uses mismatched dc/ac table ids")
        if c.dc_table_id not in set_of:
            if len(set_of) == 2:
                raise JpegError("fsm: more than two Huffman table sets")
            set_of[c.dc_table_id] = len(set_of)

    pieces: list[tuple[int, int]] = []
    eob_len = [0, 0]
    eob_code = [0, 0]
    dc0_len = [0, 0]
    dc0_code = [0, 0]
    for tid, s in set_of.items():
        dc = img.huffman.get(tid)
        ac = img.huffman.get(0x10 | tid)
        if dc is None or ac is None:
            raise JpegError("fsm: scan references missing DHT table")
        if dc.symbols.size and int(np.max(dc.symbols)) > 11:
            raise JpegError("fsm: DC size symbol > 11 overflows packed event")
        if ac.symbols.size and int(np.max(ac.symbols) & 0x0F) > 10:
            raise JpegError("fsm: AC size symbol > 10 overflows packed event")
        for is_ac, table in ((0, dc), (1, ac)):
            pieces.extend(_table_pieces(table, is_ac * 2 + s))
        eob_len[s] = int(ac.lengths[0])
        eob_code[s] = int(ac.codes[0])
        dc0_len[s] = int(dc.lengths[0])
        dc0_code[s] = int(dc.codes[0])
    pieces.sort()
    if len(pieces) > MAX_PIECES:
        raise JpegError("fsm: Huffman tables too irregular")

    tsel = []
    comp = []
    for ci, c in enumerate(img.components):
        for _ in range(c.h * c.v):
            tsel.append(set_of[c.dc_table_id])
            comp.append(ci)
    return FsmTables(
        piece_keys=tuple(k for k, _ in pieces),
        piece_vals=tuple(v for _, v in pieces),
        eob_len=tuple(eob_len),
        eob_code=tuple(eob_code),
        dc0_len=tuple(dc0_len),
        dc0_code=tuple(dc0_code),
        tsel=tuple(tsel),
        comp=tuple(comp),
        n_comp=len(img.components),
    )


@lru_cache(maxsize=16)
def symbol_lut(tables: FsmTables) -> np.ndarray:
    """int32 [N_TABLES, 65536]: (length << 8 | symbol) for every peek.

    Evaluates the piece map at every (tbl << 16 | peek) key: the value of
    the last piece whose key is <= it, which is what the JAX package's
    select tree returns, so the LUT is exact by construction.  An invalid
    peek (length INVALID_LEN) stores symbol 0; the scan never uses the
    symbol of an invalid code.
    """
    keys = np.asarray(tables.piece_keys, np.int64)
    vals = np.asarray(tables.piece_vals, np.int64)
    q = np.arange(N_TABLES << 16, dtype=np.int64)
    idx = np.searchsorted(keys, q, side="right") - 1
    packed = vals[np.maximum(idx, 0)]
    length = packed >> 17
    base = (packed & 0x1FFFF) - 0x10000
    peek = q & 0xFFFF
    code = peek >> np.clip(16 - length, 0, 16)
    sym = np.where(length <= 16, (base + code) & 0xFF, 0)
    return (
        (length << 8 | sym).astype(np.int32).reshape(N_TABLES, 1 << 16)
    )


SCAN_L1_BITS = 10       # the scan table's first level: top bits of the peek
SCAN_SUB_MAX = 576      # second-level tables it may hold (4 x 128 needed)
SCAN_LONG = -1 << 31    # first-level mark: the entry points to a second level


@lru_cache(maxsize=16)
def scan_table(tables: FsmTables) -> np.ndarray:
    """The scan kernel's tables: `symbol_lut` in two levels, int32
    [4096 + 64 * n_sub], small enough for shared memory.

    Entry: symbol | length << 8 | (length + size) << 13, with size =
    symbol & 15 and the last field 0 under an invalid length.  Word
    `tbl << 10 | peek >> 6` is the first level: the entry itself when all
    64 peeks under those 10 bits share one (every code of <= 10 bits, and
    whole invalid stretches), else SCAN_LONG | w, where words [w, w + 64)
    hold the entries of the 64 peeks, indexed by `peek & 63`.  Built from
    the flat map and so exact by construction (`scan_table_lookup`).
    Canonical tables need at most 128 second levels each (256 codes of
    >= 11 bits, 32 peeks or fewer apiece).  The flat map fills the plane
    of a table set that no block selects (a grayscale image has one set)
    with its neighbour's last piece; where that filler does not fold, the
    plane is marked invalid instead.
    """
    lut = symbol_lut(tables).astype(np.int64)
    length, sym = lut >> 8, lut & 0xFF
    need = np.where(length <= 16, length + (sym & 15), 0)
    entry = (sym | length << 8 | need << 13).reshape(
        N_TABLES, 1 << SCAN_L1_BITS, -1)
    mixed = (entry != entry[:, :, :1]).any(axis=2)
    if int(mixed.sum()) > SCAN_SUB_MAX:
        unused = [t for t in range(N_TABLES) if t % 2 not in tables.tsel]
        entry[unused] = INVALID_LEN << 8
        mixed[unused] = False
    l1 = entry[:, :, 0].copy()
    n_sub = int(mixed.sum())
    if n_sub > SCAN_SUB_MAX:
        raise JpegError("fsm: Huffman tables too irregular for the scan table")
    base = N_TABLES << SCAN_L1_BITS
    l1[mixed] = SCAN_LONG | (base + 64 * np.arange(n_sub))
    out = np.concatenate([l1.reshape(-1), entry[mixed].reshape(-1)])
    return out.astype(np.int32)


def scan_table_lookup(table: np.ndarray, tbl, peek) -> np.ndarray:
    """Plain lookup in a `scan_table`, as the kernel does it: the entry
    (symbol | length << 8 | (length + size) << 13) of table `tbl` at the
    16-bit `peek`, elementwise over arrays."""
    tbl, peek = np.asarray(tbl, np.int64), np.asarray(peek, np.int64)
    e = table[tbl << SCAN_L1_BITS | peek >> 6].astype(np.int64)
    long = e < 0
    sub = table[np.where(long, (e & 0xFFFF) + (peek & 63), 0)]
    return np.where(long, sub, e)


# ---------------------------------------------------------------------------
# Host-side segment packing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FsmPlan:
    """Lane matrices + metadata for one chunk, in up to two stride classes.

    `groups` holds per group (xs uint8 [Lg, stride_g], seg_n_blocks int32
    [Lg]): one restart segment per row (zero padded; Lg a multiple of
    128), its block quota (0 for padding lanes).  `perm[i]` is the row of
    original lane i in the group-concatenated per-lane output.  layout:
    per image, (first_lane, n_lanes, blocks_per_full_lane,
    blocks_in_last_lane).
    """

    groups: tuple              # ((xs, seg_n_blocks), ...)
    perm: np.ndarray           # int32 [n_segments]
    tables: FsmTables
    max_blk: int
    layout: tuple
    n_blocks_total: int

    # single-group views (the fused chain, the tools and the tests)
    @property
    def xs(self) -> np.ndarray:
        return self._single()[0]

    @property
    def seg_n_blocks(self) -> np.ndarray:
        return self._single()[1]

    def _single(self):
        if len(self.groups) != 1:
            raise ValueError("multi-group plan: use .groups")
        return self.groups[0]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _stride_bucket(longest: int) -> int:
    """Lane stride: pow2 up to 1 KiB, then 512-byte steps."""
    stride = 64
    while stride < min(longest, 1024):
        stride *= 2
    if longest > stride:
        stride = _round_up(longest, 512)
    return stride


def _pack_group(seg_bytes, nblocks, idxs):
    stride = _stride_bucket(max(seg_bytes[i].size for i in idxs))
    Lg = _round_up(max(len(idxs), 8), 128)
    xs = np.zeros((Lg, stride), np.uint8)
    for row, i in enumerate(idxs):
        b = seg_bytes[i]
        xs[row, : b.size] = b
    seg_n = np.zeros(Lg, np.int32)
    seg_n[: len(idxs)] = np.asarray(nblocks, np.int32)[idxs]
    return xs, seg_n


def build_plan(imgs: list[JpegImage], split: bool = True) -> FsmPlan:
    """Pack the restart segments of a chunk into grouped lane matrices.

    split=True allows two stride classes: the split threshold that
    minimizes the padded bytes, taken when it saves a tenth of them and
    both groups are substantial (at least 192 segments, 96 short and 8
    long).  A second group costs a second scan and the `perm` gather
    (`decode_plan`); split=False packs one group at the top stride, the
    single-group plan of the fused chain.  Raises JpegError when the
    chunk mixes geometries or tables, misses restart segments or
    overflows the packed event's block field.
    """
    tables = build_tables(imgs[0])
    pattern0 = imgs[0].mcu_block_pattern()
    bpm = len(pattern0)

    seg_bytes: list[np.ndarray] = []
    nblocks: list[int] = []
    layout = []
    n_blocks_total = 0
    for img in imgs:
        if img.mcu_block_pattern() != pattern0 or build_tables(img) != tables:
            raise JpegError("fsm: batch mixes geometries or Huffman tables")
        offs = img.segment_offsets
        n_seg = offs.size
        n_mcus = img.n_mcus
        ri = img.restart_interval or n_mcus
        need = -(-n_mcus // ri)
        if need > n_seg:
            raise JpegError("fsm: missing restart segments")
        ends = np.append(offs[1:need], img.scan_data.size)
        first = len(seg_bytes)
        scan = img.scan_data
        for s in range(need):
            seg_bytes.append(scan[int(offs[s]) : int(ends[s])])
            nblocks.append(min(ri, n_mcus - s * ri) * bpm)
        rib = ri * bpm
        last = n_mcus * bpm - (need - 1) * rib
        if max(rib, last) > MAX_BLOCKS_PER_LANE:
            raise JpegError("fsm: restart interval too long for packed events")
        layout.append((first, need, rib, last))
        n_blocks_total += n_mcus * bpm

    lens = np.array([b.size for b in seg_bytes], np.int64)
    top_stride = _stride_bucket(int(lens.max()))
    group_idxs: list[list[int]] = [list(range(len(seg_bytes)))]
    if split and len(seg_bytes) >= 192:
        buckets = np.array([_stride_bucket(int(x)) for x in lens])
        base_cost = len(seg_bytes) * top_stride
        best = (base_cost, None)
        for v in sorted(set(buckets.tolist()))[:-1]:
            n_short = int((buckets <= v).sum())
            if n_short < 96 or len(seg_bytes) - n_short < 8:
                continue
            cost = n_short * v + (len(seg_bytes) - n_short) * top_stride
            if cost < best[0]:
                best = (cost, v)
        if best[1] is not None and best[0] < 0.9 * base_cost:
            v = best[1]
            group_idxs = [np.flatnonzero(buckets > v).tolist(),
                          np.flatnonzero(buckets <= v).tolist()]

    groups = []
    perm = np.zeros(len(seg_bytes), np.int32)
    base = 0
    for idxs in group_idxs:
        groups.append(_pack_group(seg_bytes, nblocks, idxs))
        for row, i in enumerate(idxs):
            perm[i] = base + row
        base += groups[-1][1].shape[0]

    max_blk = max(16, _round_up(max(nblocks), 16))
    return FsmPlan(
        groups=tuple(groups),
        perm=perm,
        tables=tables,
        max_blk=max_blk,
        layout=tuple(layout),
        n_blocks_total=n_blocks_total,
    )


@dataclass(frozen=True)
class FsmBucketPlan:
    """Bucket-raster lane plan of a mixed-size chunk.

    Every image contributes exactly `lanes_per_img` lanes (zero-quota
    padding lanes after its real rows); each lane covers `k` MCU rows of
    its image and emits events at bucket-raster output positions (the
    scan's pad_info counters), so the per-lane rows are the bucket's padded
    layout and assembly is one static reshape.  Requires row-aligned
    restart intervals (ri == k * mcus_x); the batch engine keys chunks on
    (bucket, k) and sends anything else to the host-bucketed route.
    """

    xs: np.ndarray            # uint8 [L, stride]
    seg_n: np.ndarray         # int32 [L] real-block quotas
    wrap_at: np.ndarray       # int32 [L] blocks per real MCU row
    skip: np.ndarray          # int32 [L] padding slots after each row
    tables: FsmTables
    k: int                    # MCU rows per lane (uniform across the chunk)
    lanes_per_img: int        # uniform lane count per image
    max_blk: int              # k * bucket.mcus_x * bpm (lane capacity)
    extents: np.ndarray       # int32 [n_imgs, 2] true (mcus_y, mcus_x)
    n_imgs: int


def bucket_lane_k(img: JpegImage) -> int | None:
    """MCU rows per restart segment, or None when not row-aligned."""
    ri = img.restart_interval
    if not ri or ri % img.mcus_x:
        return None
    if img.segment_offsets.size < -(-img.n_mcus // ri):
        return None  # missing restart segments
    return ri // img.mcus_x


def build_plan_bucketed(imgs: list[JpegImage], bucket,
                        pad_imgs: int | None = None) -> FsmBucketPlan:
    """Pack a mixed-size chunk into bucket-raster lanes (FsmBucketPlan).

    `bucket` is the size-class Geometry (pipeline.bucket_geometry); every
    image must fit it, share tables and subsampling, and have the same
    row-aligned restart k.  Raises JpegError otherwise (callers take the
    host-bucketed route).  pad_imgs pads the lane count as if the chunk
    held that many images (padding lanes are inert: zero quota, done
    before the first scan column).
    """
    tables = build_tables(imgs[0])
    pattern0 = imgs[0].mcu_block_pattern()
    bpm = len(pattern0)
    k = bucket_lane_k(imgs[0])
    if k is None:
        raise JpegError("fsm-bucket: restart interval not row-aligned")
    lanes_per_img = -(-bucket.mcus_y // k)
    max_blk = k * bucket.mcus_x * bpm
    if max_blk > MAX_BLOCKS_PER_LANE:
        raise JpegError("fsm-bucket: bucket row capacity overflows events")

    seg_bytes: list[np.ndarray] = []
    quotas: list[int] = []
    wraps: list[int] = []
    skips: list[int] = []
    extents = np.zeros((len(imgs), 2), np.int32)
    for ii, img in enumerate(imgs):
        if img.mcu_block_pattern() != pattern0 or build_tables(img) != tables:
            raise JpegError("fsm: batch mixes subsampling or Huffman tables")
        if bucket_lane_k(img) != k:
            raise JpegError("fsm-bucket: mixed restart row counts")
        if img.mcus_x > bucket.mcus_x or img.mcus_y > bucket.mcus_y:
            raise JpegError("fsm-bucket: image exceeds its bucket")
        ri = k * img.mcus_x
        need = -(-img.n_mcus // ri)
        if need > lanes_per_img:
            raise JpegError("fsm-bucket: image exceeds bucket row count")
        offs = img.segment_offsets
        ends = np.append(offs[1:need], img.scan_data.size)
        scan = img.scan_data
        extents[ii] = (img.mcus_y, img.mcus_x)
        for s in range(lanes_per_img):
            if s < need:
                seg_bytes.append(scan[int(offs[s]) : int(ends[s])])
                quotas.append(min(ri, img.n_mcus - s * ri) * bpm)
            else:
                seg_bytes.append(np.zeros(0, np.uint8))
                quotas.append(0)
            wraps.append(max(img.mcus_x * bpm, 1))
            skips.append((bucket.mcus_x - img.mcus_x) * bpm)

    n_real = len(seg_bytes)
    stride = _stride_bucket(max(max(b.size for b in seg_bytes), 64))
    L = _round_up(max(n_real, (pad_imgs or 0) * lanes_per_img, 8), 128)
    xs = np.zeros((L, stride), np.uint8)
    for row, b in enumerate(seg_bytes):
        xs[row, : b.size] = b
    seg_n = np.zeros(L, np.int32)
    seg_n[:n_real] = quotas
    wrap_at = np.ones(L, np.int32)
    wrap_at[:n_real] = wraps
    skip = np.zeros(L, np.int32)
    skip[:n_real] = skips
    return FsmBucketPlan(
        xs=xs, seg_n=seg_n, wrap_at=wrap_at, skip=skip, tables=tables,
        k=k, lanes_per_img=lanes_per_img, max_blk=max_blk,
        extents=extents, n_imgs=len(imgs),
    )


# ---------------------------------------------------------------------------
# The scan (kernel 1)
# ---------------------------------------------------------------------------


def scan_meta(tables: FsmTables) -> np.ndarray:
    """int32 [25] small constants for the CUDA scan: bpm, tsel[16],
    eob_len[2], eob_code[2], dc0_len[2], dc0_code[2]."""
    bpm = len(tables.tsel)
    if bpm > 16:
        raise JpegError("fsm: more than 16 blocks per MCU")
    tsel = list(tables.tsel) + [0] * (16 - bpm)
    return np.asarray(
        [bpm, *tsel, *tables.eob_len, *tables.eob_code,
         *tables.dc0_len, *tables.dc0_code],
        np.int32,
    )


class ScanOut(NamedTuple):
    """Everything one scan returns (fsm_scan_spec).

    events/anchors/ablk/recm are int32 [n_cols, K, L]: the packed events
    (None when emit=False), and in anchor mode the per-step block-boundary
    anchor `(bitpos << 3) | bim` (-1 elsewhere), the block count at that
    anchor (0 elsewhere) and the recovery marker (-1 elsewhere); None
    outside anchor mode.  The final state is int32 [L]: blk (blocks
    decoded), end_bits / end_bim (bit position and MCU phase where the
    lane stopped), rec_last (last recovery bit position, -1 if none or
    outside anchor mode)."""

    events: torch.Tensor | None
    anchors: torch.Tensor | None
    ablk: torch.Tensor | None
    recm: torch.Tensor | None
    err_mal: torch.Tensor
    err_env: torch.Tensor
    blk: torch.Tensor
    end_bits: torch.Tensor
    end_bim: torch.Tensor
    rec_last: torch.Tensor


def fsm_scan(xs: torch.Tensor, seg_n_blocks: torch.Tensor,
             tables: FsmTables, steps=STEPS_PRODUCTION, pad_info=None):
    """Run the symbol FSM over the byte columns of a restart lane matrix.

    xs: uint8 [L, stride] (one restart segment per row), seg_n_blocks:
    int32 [L].  steps: (bytes per column bpc, symbol steps per column K),
    or an int K for 1-byte columns.  Returns (events int32 [n_cols, K,
    L], err_mal bool [L], err_env bool [L]) with n_cols = ceil(stride /
    bpc) + FLUSH_COLS.  A column of bpc bytes refills one byte at a time,
    each refill followed by its share of the K steps, front-loaded ((4,
    7) runs 2, 2, 2, 1, so the backlog drains before the later refills);
    rows are padded with zero bytes to a multiple of bpc, and those pad
    bytes are refilled as data, as in the JAX scan.

    pad_info: optional pair (wrap_at, skip) of int32 [L]: bucket-raster
    emission for a size-class bucket chunk (FsmBucketPlan).  The event's
    block field becomes the output position that skips `skip` slots after
    every `wrap_at` completed blocks (one padded MCU row of the bucket
    grid); quotas and latches still count real blocks.

    CUDA tensors run kernel 1 (csrc/fsm_scan.cu); CPU tensors run
    `fsm_scan_plain`.
    """
    steps = _scan_steps(steps)
    if not xs.is_cuda:
        return fsm_scan_plain(xs, seg_n_blocks, tables, steps, pad_info)
    out = _scan_cuda(xs, seg_n_blocks, tables, steps,
                     mode=0 if pad_info is None else 3, pad_info=pad_info)
    return out.events, out.err_mal, out.err_env


def fsm_scan_spec(xs: torch.Tensor, seg_n_blocks: torch.Tensor,
                  tables: FsmTables, steps=STEPS_PRODUCTION, *,
                  start_bits: torch.Tensor | None = None,
                  start_bim: torch.Tensor | None = None,
                  chunk_bits: torch.Tensor | None = None,
                  log_anchors: bool = False, emit: bool = True) -> ScanOut:
    """The scan's speculative modes (the JAX package's _fsm_scan with
    start_bits / start_bim / chunk_bits / log_anchors).

    xs: uint8 [L, n_data] (a column-prefix view of a wider row-major
    matrix is read in place).  start_bits/start_bim (int32 [L]): each
    lane's entry bit offset into its row and MCU phase; chunk_bits
    (int32 [L]): stop at the first block boundary at or past it;
    log_anchors: log block-boundary anchors and recover from errors
    instead of latching them (err masks stay all-False).  emit=False
    drops the events (count passes).  Returns a ScanOut.

    CUDA tensors run kernel 1's speculative variants; CPU tensors run
    `fsm_scan_spec_plain`.  Columns are one byte wide here (a multi-byte
    steps spec raises ValueError, as the JAX scan asserts).
    """
    steps = _scan_steps(steps, spec=True)
    spec = dict(start_bits=start_bits, start_bim=start_bim,
                chunk_bits=chunk_bits, log_anchors=log_anchors, emit=emit)
    if not xs.is_cuda:
        return fsm_scan_spec_plain(xs, seg_n_blocks, tables, steps, **spec)
    return _scan_cuda(xs, seg_n_blocks, tables, steps,
                      mode=2 if log_anchors else 1, **spec)


def _scan_cuda(xs, seg_n_blocks, tables, steps, mode, start_bits=None,
               start_bim=None, chunk_bits=None, log_anchors=False,
               emit=True, pad_info=None) -> ScanOut:
    """Launch kernel 1 in `mode` (0 restart, 1 speculative, 2 anchors,
    3 restart with bucket-raster emission) at the checked steps spec
    (bpc, K); multi-byte columns in modes 0 and 3 only."""
    from ..runtime import kernels

    bpc, k = steps
    if not xs.is_cuda or xs.dtype != torch.uint8 or xs.dim() != 2:
        raise ValueError("fsm_scan: xs must be a CUDA uint8 [L, n] tensor")
    L, n_data = xs.shape
    pitch = xs.stride(0)
    # each lane reads its row four bytes at a time, in place
    if xs.stride(1) != 1 or pitch % 4 or xs.data_ptr() % 4 or n_data > pitch:
        raise ValueError(
            f"fsm_scan: rows must be unit-stride and 4-byte aligned "
            f"(strides {xs.stride()})"
        )
    dev = xs.device
    wrap_at, skip = pad_info if pad_info is not None else (None, None)
    ints = {"seg_n_blocks": seg_n_blocks, "start_bits": start_bits,
            "start_bim": start_bim, "chunk_bits": chunk_bits,
            "wrap_at": wrap_at, "skip": skip}
    for name, t in ints.items():
        if t is not None:
            kernels.check_cuda_tensor(name, t, torch.int32, 1)
            if t.shape[0] != L:
                raise ValueError(f"fsm_scan: {name} must be [L={L}]")
    table = _device_table(tables, dev)
    meta = scan_meta(tables)
    n_cols = -(-n_data // bpc) + FLUSH_COLS

    def plane():
        return torch.empty((n_cols, k, L), dtype=torch.int32, device=dev)

    events = plane() if emit else None
    anchors, ablk, recm = (plane(), plane(), plane()) if mode == 2 \
        else (None, None, None)
    err_mal = torch.empty(L, dtype=torch.bool, device=dev)
    err_env = torch.empty(L, dtype=torch.bool, device=dev)
    # the restart variant keeps no final state
    spec = mode in (1, 2)
    state = torch.empty((4, L), dtype=torch.int32, device=dev) if spec \
        else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    kernels.launch(
        "fsm_scan", dev,
        xs.data_ptr(), seg_n_blocks.data_ptr(), table.data_ptr(),
        table.numel(), meta.ctypes.data, ptr(events), err_mal.data_ptr(),
        err_env.data_ptr(), L, pitch, n_data, k, bpc, mode,
        ptr(start_bits), ptr(start_bim), ptr(chunk_bits),
        ptr(anchors), ptr(ablk), ptr(recm), ptr(state),
        ptr(wrap_at), ptr(skip),
    )
    blk, end_bits, end_bim, rec_last = state if spec else (None,) * 4
    return ScanOut(events, anchors, ablk, recm, err_mal, err_env,
                   blk, end_bits, end_bim, rec_last)


_table_cache: dict = {}


def _device_table(tables: FsmTables, device) -> torch.Tensor:
    """`scan_table(tables)` on the card (cached)."""
    key = (tables, str(device))
    table = _table_cache.get(key)
    if table is None:
        table = torch.as_tensor(scan_table(tables)).to(device)
        if len(_table_cache) >= 16:
            _table_cache.clear()
        _table_cache[key] = table
    return table


def fsm_scan_plain(xs: torch.Tensor, seg_n_blocks: torch.Tensor,
                   tables: FsmTables, steps, pad_info=None):
    """Plain PyTorch version of `fsm_scan` (restart mode, same contract;
    steps a spec or an int K)."""
    out = _scan_plain(xs, seg_n_blocks, tables, _scan_steps(steps),
                      pad_info=pad_info)
    return out.events, out.err_mal, out.err_env


def fsm_scan_spec_plain(xs: torch.Tensor, seg_n_blocks: torch.Tensor,
                        tables: FsmTables, steps, *, start_bits=None,
                        start_bim=None, chunk_bits=None,
                        log_anchors: bool = False,
                        emit: bool = True) -> ScanOut:
    """Plain PyTorch version of `fsm_scan_spec` (same contract)."""
    out = _scan_plain(xs, seg_n_blocks, tables,
                      _scan_steps(steps, spec=True), start_bits, start_bim,
                      chunk_bits, log_anchors)
    return out if emit else out._replace(events=None)


def _scan_plain(xs, seg_n_blocks, tables: FsmTables, steps: tuple,
                start_bits=None, start_bim=None, chunk_bits=None,
                log_anchors: bool = False, pad_info=None) -> ScanOut:
    """Plain PyTorch scan: a Python loop over columns of `bpc` bytes, a
    refill of each byte followed by its steps of the schedule, each
    symbol step as vector ops over lanes (the JAX scan body), every mode.

    The bit buffer is int64 masked to 32 bits after every refill, which is
    the uint32 buffer of the kernel; every read of it is masked to bits
    below navail <= 32, so the JAX int32 buffer gives the same bits.
    """
    dev = xs.device
    bpc, k = steps
    base, extra = divmod(k, bpc)
    ks = [base + (1 if b < extra else 0) for b in range(bpc)]
    if xs.shape[1] % bpc:
        # pad bytes to whole columns: refilled as data, as in the JAX scan
        pad = torch.zeros((xs.shape[0], bpc - xs.shape[1] % bpc),
                          dtype=xs.dtype, device=dev)
        xs = torch.cat([xs, pad], dim=1)
    L, n_bytes = xs.shape
    n_data_cols = n_bytes // bpc
    n_cols = n_data_cols + FLUSH_COLS
    i64 = torch.int64
    spec = start_bits is not None or chunk_bits is not None or log_anchors
    lut = torch.as_tensor(symbol_lut(tables).reshape(-1)).to(dev).to(i64)
    bpm = len(tables.tsel)
    tsel_of = torch.as_tensor(tables.tsel, dtype=i64, device=dev)
    eob_len = torch.as_tensor(tables.eob_len, dtype=i64, device=dev)
    eob_code = torch.as_tensor(tables.eob_code, dtype=i64, device=dev)
    dc0_len = torch.as_tensor(tables.dc0_len, dtype=i64, device=dev)
    dc0_code = torch.as_tensor(tables.dc0_code, dtype=i64, device=dev)
    cols = xs.to(i64).T                        # [stride, L]
    seg_n = seg_n_blocks.to(i64)

    zero = torch.zeros(L, dtype=i64, device=dev)
    buf, navail, kk, blk = zero, zero, zero, zero
    sbits = zero if start_bits is None else start_bits.to(i64)
    bim = zero if start_bim is None else start_bim.to(i64)
    cbits = None if chunk_bits is None else chunk_bits.to(i64)
    bitpos, end_bits, end_bim = sbits, zero, bim
    rec = rec_pend = torch.full((L,), -1, dtype=i64, device=dev)
    done = seg_n == 0
    # bucket-raster output counters (pad_info): blocks done in the current
    # padded MCU row, and the output position of the block being decoded
    ocol = oblk = zero
    if pad_info is not None:
        wrap_at, skip = (t.to(i64) for t in pad_info)
    err_mal = torch.zeros(L, dtype=torch.bool, device=dev)
    err_env = torch.zeros(L, dtype=torch.bool, device=dev)

    def bits(buf, navail, n):
        """The n bits just below bit `navail` of the buffer."""
        return (buf >> torch.clamp(navail - n, 0, 31)) & ((1 << n) - 1)

    def plane():
        return torch.empty((n_cols, k, L), dtype=torch.int32, device=dev)

    events = plane()
    anchors, ablk, recm = (plane(), plane(), plane()) if log_anchors \
        else (None, None, None)
    # (column, byte, step slots): each byte of a column is refilled, then
    # its share of the column's K step slots runs
    starts = np.cumsum([0] + ks)
    schedule = [(col, col * bpc + b, range(starts[b], starts[b + 1]))
                for col in range(n_cols) for b in range(bpc)]
    for col, byte, slots in schedule:
        # ---- refill one byte (none in the FLUSH_COLS tail)
        active = ~done & ~err_mal & ~err_env
        if col < n_data_cols:
            take = torch.where(active, 8, 0)
            if spec:
                # speculative entry: skip the bits before start_bits; a
                # partial first byte contributes its low bits
                take = take - torch.where(
                    active, torch.clamp(sbits - byte * 8, 0, 8), 0)
            overflow = navail + take > 32
            if log_anchors:
                # recover: drop the backlog, resume at the refill frontier
                spill = active & overflow & (take > 0)
                bitpos = bitpos + torch.where(spill, navail, 0)
                navail = torch.where(spill, 0, navail)
                kk = torch.where(spill, 0, kk)
                rec = torch.maximum(rec, torch.where(spill, bitpos, -1))
                rec_pend = torch.maximum(
                    rec_pend, torch.where(spill, bitpos, -1))
            else:
                err_env = err_env | (active & overflow & (take > 0))
                take = torch.where(overflow, 0, take)
            buf = ((buf << take) | (cols[byte] & ((1 << take) - 1))) \
                & 0xFFFFFFFF
            navail = navail + take
        for s in slots:
            active = ~done & ~err_mal & ~err_env
            # peek 16 bits, padding past the end of the buffer with ones
            sa = torch.clamp(navail - 16, min=0)
            sb = torch.clamp(16 - navail, min=0)
            peek = torch.where(
                navail >= 16, buf >> sa, (buf << sb) | ((1 << sb) - 1)
            ) & 0xFFFF
            is_dc = kk == 0
            tsel = tsel_of[bim]
            tbl = torch.where(is_dc, tsel, tsel + 2)
            lv = lut[(tbl << 16) | peek]
            length = lv >> 8
            sym = lv & 0xFF
            size = sym & 15
            run = sym >> 4
            need = length + size
            complete = active & (length <= 16) & (navail >= need)
            bad_code = active & (length > 16) & (navail >= 16)
            # magnitude bits + EXTEND
            mag = (buf >> torch.clamp(navail - need, 0, 31)) \
                & ((1 << size) - 1)
            half = 1 << torch.clamp(size - 1, min=0)
            val = torch.where(mag >= half, mag, mag - 2 * half + 1)
            eob = complete & ~is_dc & (sym == 0)
            z = torch.where(is_dc, 0, kk + run)
            bad_z = complete & ~is_dc & (z > 63)
            emit = complete & (size > 0) & ~bad_z
            if not log_anchors:
                err_mal = err_mal | bad_code | (complete & (size > 0) & bad_z)
            eblk = blk if pad_info is None else oblk
            events[col, s] = torch.where(
                emit, (eblk << 18) | (z << 12) | (val + 2048), -1
            ).to(torch.int32)
            k2 = torch.where(
                complete,
                torch.where(is_dc, 1, torch.where(eob, 64, z + 1)),
                kk,
            )
            consumed = torch.where(complete, need, 0)
            # trailing EOB of this table set
            el = eob_len[tsel]
            eob_fire = (
                complete & (k2 < 64) & (el > 0) & (navail - consumed >= el)
                & (bits(buf, navail - consumed, el) == eob_code[tsel])
            )
            consumed = consumed + torch.where(eob_fire, el, 0)
            navail = navail - consumed
            block_end = (complete & (k2 >= 64)) | eob_fire
            blk = blk + block_end.to(i64)
            if pad_info is not None:
                # after wrap_at blocks of a row, jump the bucket's column
                # padding; oblk stays strictly increasing
                ocol = ocol + block_end.to(i64)
                wrapped = ocol >= wrap_at
                oblk = oblk + torch.where(
                    block_end, torch.where(wrapped, skip + 1, 1), 0)
                ocol = torch.where(wrapped, 0, ocol)
            bim = torch.where(
                block_end, torch.where(bim + 1 == bpm, 0, bim + 1), bim
            )
            k3 = torch.where(block_end, 0, k2)
            done_now = block_end & (blk >= seg_n)
            if spec:
                bitpos = bitpos + consumed
                if log_anchors:
                    anchors[col, s] = torch.where(
                        block_end, (bitpos << 3) | bim, -1).to(torch.int32)
                    ablk[col, s] = torch.where(block_end, blk, 0) \
                        .to(torch.int32)
                if cbits is not None:
                    # stop at the first block boundary at or past the
                    # lane's chunk end
                    done_now = done_now | (block_end & (bitpos >= cbits))
                newly = done_now & ~done
                end_bits = torch.where(newly, bitpos, end_bits)
                end_bim = torch.where(newly, bim, end_bim)
            done = done | done_now
            # trailing size-0 DC of the next block
            ts2 = tsel_of[bim]
            dl = dc0_len[ts2]
            dc0_fire = (
                block_end & ~done & (dl > 0) & (navail >= dl)
                & (bits(buf, navail, dl) == dc0_code[ts2])
            )
            navail = navail - torch.where(dc0_fire, dl, 0)
            kk = torch.where(dc0_fire, 1, k3)
            if spec:
                bitpos = bitpos + torch.where(dc0_fire, dl, 0)
            if log_anchors:
                # recover, don't latch: drop the backlog, realign to the
                # refill frontier; one marker per step slot (a refill
                # recovery waits for the next slot without one)
                rec_now = bad_code | bad_z
                bitpos = bitpos + torch.where(rec_now, navail, 0)
                navail = torch.where(rec_now, 0, navail)
                kk = torch.where(rec_now, 0, kk)
                rec = torch.maximum(rec, torch.where(rec_now, bitpos, -1))
                recm[col, s] = torch.where(rec_now, bitpos, rec_pend) \
                    .to(torch.int32)
                rec_pend = torch.where(rec_now, rec_pend, -1)
    # a lane undone at the end is truncated, or starved of steps with
    # whole bytes still buffered (an envelope condition); anchor mode
    # latches nothing
    if not log_anchors:
        undone = ~done
        starved = undone & (navail >= 8)
        err_mal = err_mal | (undone & ~starved)
        err_env = err_env | starved
    state = (blk, end_bits, end_bim, rec) if spec else (None,) * 4
    blk, end_bits, end_bim, rec = (
        None if t is None else t.to(torch.int32) for t in state
    )
    return ScanOut(events, anchors, ablk, recm, err_mal, err_env,
                   blk, end_bits, end_bim, rec)


# ---------------------------------------------------------------------------
# Materialize + DC resolve
# ---------------------------------------------------------------------------


def materialize_events(ev: torch.Tensor, M: int, route: str = "scatter",
                       err_mal: torch.Tensor | None = None) -> torch.Tensor:
    """Packed events [N, L] -> dense int16 [M, L] by the classic contract,
    through one of three routes (the JAX package's _materialize_events
    dispatch, with the route an argument and not an environment switch):

      "scatter"  one kernel, `materialize.place_events` (the default);
      "ranked"   column cumsum, `compact_offsets`, `spread_full` (the JAX
                 package with TPUJPEG_RANK_KERNEL=0);
      "full"     `compact_full`, `spread_full` (TPUJPEG_PALLAS=1).

    All three give the same tensor and latch `err_mal` (bool [L], in
    place) for an event whose target is outside [0, M).  "ranked" and
    "full" carry int16 offsets, so shapes outside `materialize.route_gate`
    take the scatter, as the JAX dispatch leaves its kernels for another
    implementation there."""
    from . import materialize

    N = ev.shape[0]
    if not materialize.route_gate(route, N, M):
        route = "scatter"
    if route == "ranked":
        p, o = materialize.compact_to_rank(ev, rank_kernel=False)
        return materialize.spread_full(p, M, o=o, err_mal=err_mal)
    if route == "full":
        return materialize.place_events_full(ev, M, err_mal)
    return materialize.place_events(ev, M, err_mal)


def materialize_checked(ev: torch.Tensor, M: int, err_mal: torch.Tensor,
                        slots: bool | int | None = False,
                        route: str = "scatter"):
    """Materialize events [N, L] -> dense int16 [M, L], checked.

    slots: False = the classic scatter (place_events); None / True = the
    slot route (materialize.place_events_slots) at the default capacity
    when `materialize.slot_gate` allows it; an int = the slot route at
    that capacity C.  Returns (coeffs_t int16 [M, L], err_mal, err_slot
    bool [L]): err_slot marks slot-overflow lanes (their dense rows are
    undefined; callers re-decode the chunk with slots=False), all-False
    on the classic route.  The classic route latches err_mal for an event
    whose target is outside [0, M).  route: how the classic route places
    the events (`materialize_events`); on the slot route "ranked" swaps
    the compact stage, which both families share, and "full" changes
    nothing.  Under TPUJPEG_SELFCHECK=1 a per-lane
    checksum sum(val * (target + 1)) of the event stream is compared with
    sum(value * (row + 1)) of the dense tensor, in int32 wraparound, and a
    mismatch latches err_mal outside the overflow lanes.
    """
    from . import materialize

    N, L = ev.shape
    err_mal = err_mal.clone()
    C = None
    if slots is not False:
        C = materialize.SLOT_C if slots is None or slots is True else slots
        if not materialize.slot_gate(N, M, C):
            C = None
    if C is None:
        coeffs_t = materialize_events(ev, M, route, err_mal)
        err_slot = torch.zeros(L, dtype=torch.bool, device=ev.device)
    else:
        materialize.route_gate(route, N, M)   # raises on an unknown route
        coeffs_t, err_slot = materialize.place_events_slots(
            ev, M, C, rank_kernel=route != "ranked")
    if os.environ.get("TPUJPEG_SELFCHECK", "auto") == "1":
        valid = ev >= 0
        e = ev.to(torch.int64)
        val = torch.where(valid, (e & 0xFFF) - 2048, 0)
        tgt = torch.where(valid, ((e >> 18) & 0x1FFF) * 64 + ((e >> 12) & 63), 0)
        chk_ev = (val * (tgt + 1)).sum(dim=0) & 0xFFFFFFFF
        w = torch.arange(1, M + 1, dtype=torch.int64, device=ev.device)
        chk_mat = (coeffs_t.to(torch.int64) * w[:, None]).sum(dim=0) \
            & 0xFFFFFFFF
        err_mal = err_mal | ((chk_ev != chk_mat) & ~err_slot)
    return coeffs_t, err_mal, err_slot


def _dc_cumsum(dc: torch.Tensor, tables: FsmTables, max_blk: int):
    """Per-component DC-difference cumsum down each lane: [L, max_blk].

    Every lane is a restart segment, so its DC chains start at 0; blocks
    whose difference was zero emitted nothing and hold 0, so the cumsum
    carries the predictor through them.
    """
    L = dc.shape[0]
    bpm = len(tables.comp)
    n_mcu = -(-max_blk // bpm)
    pad = n_mcu * bpm - max_blk
    dc = torch.nn.functional.pad(dc.to(torch.int32), (0, pad))
    dc3 = dc.reshape(L, n_mcu, bpm)
    cols = []
    base = 0
    for ci in range(tables.n_comp):
        nb = sum(1 for c in tables.comp if c == ci)
        sub = dc3[:, :, base : base + nb].reshape(L, n_mcu * nb)
        acc = torch.cumsum(sub, dim=1, dtype=torch.int32)
        cols.append(acc.reshape(L, n_mcu, nb))
        base += nb
    return torch.cat(cols, dim=2).reshape(L, n_mcu * bpm)[:, :max_blk]


# ---------------------------------------------------------------------------
# The staged restart chain (one scan per stride group)
# ---------------------------------------------------------------------------


def assemble(per_lane: np.ndarray, layout) -> np.ndarray:
    """Per-lane block rows -> scan-order [n_blocks_total, 64] (host)."""
    parts = []
    for first, n_lanes, rib, last in layout:
        if n_lanes > 1:
            parts.append(
                per_lane[first : first + n_lanes - 1, :rib].reshape(-1, 64)
            )
        parts.append(per_lane[first + n_lanes - 1, :last])
    return np.concatenate(parts) if len(parts) > 1 else np.asarray(parts[0])


def assemble_batched(per_lane: torch.Tensor, *, layout,
                     pad_to: int) -> torch.Tensor:
    """Device-side assemble for a chunk whose images share one block
    count: [L, max_blk, 64] -> [pad_to, blocks_img, 64], zero padded."""
    from ..runtime.fused import _assemble_rows

    return _assemble_rows(per_lane, layout, pad_to)


def upload_plan(plan: FsmPlan, device="cuda"):
    """A plan's lane matrices and permutation on `device`:
    (((xs, seg_n_blocks), ...), perm)."""
    return (
        tuple((torch.as_tensor(xs).to(device), torch.as_tensor(sn).to(device))
              for xs, sn in plan.groups),
        torch.as_tensor(plan.perm).to(device),
    )


def _decode_group(xs, seg_n, tables: FsmTables, max_blk: int, steps,
                  route: str):
    """One stride group: scan, classic materialize, DC resolved per lane.
    Returns (per_lane int32 [Lg, max_blk, 64], err_mal, err_env)."""
    events, err_mal, err_env = fsm_scan(xs, seg_n, tables, steps)
    n_cols, S, L = events.shape
    coeffs_t, err_mal, _ = materialize_checked(
        events.reshape(n_cols * S, L), max_blk * 64, err_mal, slots=False,
        route=route)
    per_lane = coeffs_t.T.reshape(L, max_blk, 64).to(torch.int32)
    per_lane[:, :, 0] = _dc_cumsum(per_lane[:, :, 0], tables, max_blk)
    return per_lane, err_mal, err_env


def decode_plan(plan: FsmPlan, uploaded=None, steps=STEPS_PRODUCTION,
                device="cuda", route: str = "scatter"):
    """Run the FSM decoder -> (per_lane int32 [n_lanes, max_blk, 64] DC
    resolved, (err_mal, err_env) bool [n_lanes]).

    Each stride group runs as its own scan; with two groups the rows are
    concatenated and put back in lane (scan) order by `plan.perm`, so
    there are n_segments rows; one group keeps its Lg rows, the padding
    lanes past n_segments included.  `uploaded` is upload_plan's result
    (on `device` otherwise); route: the classic materialize's route
    (`materialize_events`)."""
    groups, perm = uploaded if uploaded is not None \
        else upload_plan(plan, device)
    outs = [_decode_group(xs, sn, plan.tables, plan.max_blk, steps, route)
            for xs, sn in groups]
    if len(outs) == 1:
        per_lane, err_mal, err_env = outs[0]
        return per_lane, (err_mal, err_env)
    per_lane, err_mal, err_env = (
        torch.cat(parts).index_select(0, perm) for parts in zip(*outs))
    return per_lane, (err_mal, err_env)


def entropy_decode_fsm(imgs: list[JpegImage], device="cuda") -> np.ndarray:
    """Decode a batch's scans with the FSM; int32 [total_blocks, 64].

    Production steps first, then STEPS_SAFE.  Raises JpegError on
    malformed streams or plans outside the FSM envelope (callers fall
    back to the host runtime)."""
    plan = build_plan(imgs)
    uploaded = upload_plan(plan, device)
    for steps in (STEPS_PRODUCTION, STEPS_SAFE):
        per_lane, (err_mal, err_env) = decode_plan(plan, uploaded,
                                                   steps=steps)
        mal, env = (bool(e.any()) for e in (err_mal, err_env))
        if mal:
            raise JpegError("fsm decode failed (malformed or truncated scan)")
        if not env:
            return assemble(per_lane.cpu().numpy(), plan.layout)
    raise JpegError(
        "fsm: stream outside the decode envelope "
        f"(> {STEPS_SAFE} symbols/byte sustained)"
    )


# ---------------------------------------------------------------------------
# Speculative decode of streams without restart markers
# ---------------------------------------------------------------------------
#
# A stream without restart markers is split at equal byte boundaries into
# lanes of one matrix (all images of a chunk stacked).  Lane i's true
# entry state is lane i-1's end state; lane 0 of each image is exact.
#
# Single pass (spec_sync_start -> spec_sync_resolve_host -> the spec
# tail): every lane COLD-decodes its chunk from bit 0, logging block
# anchors `(bitpos << 3) | phase` with the running block count, and
# recovering (not latching) from the garbage a misaligned start decodes.
# A stitch pass re-decodes each lane from its true entry (the
# predecessor's cold end) for SPEC_STITCH_BYTES; where the stitch end
# state appears in the lane's anchor log, the cold events from that
# anchor on are the true decode and are adopted, rebased.  Correctness
# is inductive per image; the host resolve requires every lane to hit.
#
# Jacobi fallback (spec_start -> decode_speculative_batch), the target
# of a resolve miss: count passes iterate lane handoff states to a fixed
# point, then one write pass decodes every lane from its converged state.
#
# DC is emitted as differences everywhere; the tail resolves DPCM with
# one per-component cumsum per image.

SPEC_OVERLAP = 384  # bytes a block may straddle past its chunk (max ~213)

# Stitch window: pass 2 re-decodes each lane from its true entry for up
# to this many bytes (Huffman self-synchronization plus the entry
# offset <= SPEC_OVERLAP); its slice adds SPEC_OVERLAP for the straddle.
SPEC_STITCH_BYTES = 256


class SpecEnvelopeError(JpegError):
    """Speculative pass latched envelope lanes: the stream is denser than
    the current symbol-step budget (callers retry at STEPS_SAFE)."""


class SpecSyncMiss(JpegError):
    """The single-pass resolve could not adopt every lane (callers fall
    back to the Jacobi path)."""


@dataclass(frozen=True)
class SpecPlan:
    """Speculative plan of one image (the JAX package's SpecPlan)."""

    xs: np.ndarray           # uint8 [L, chunk + overlap]
    chunk_bits: np.ndarray   # int32 [L]
    blk_cap: int
    tables: FsmTables
    chunk_bytes: int
    n_lanes: int             # real lanes (before padding)
    n_blocks_total: int
    bpm: int


def build_spec_plan(img: JpegImage, chunk_bytes: int = 2048) -> SpecPlan:
    """Split one image's scan into chunk_bytes lanes (+ SPEC_OVERLAP bytes
    of the next chunk), lanes padded to a multiple of 128."""
    tables = build_tables(img)
    scan = img.scan_data
    S = max(1, -(-scan.size // chunk_bytes))
    n_blocks = img.n_mcus * img.blocks_per_mcu
    stride = chunk_bytes + SPEC_OVERLAP
    L = _round_up(S, 128)
    xs = np.zeros((L, stride), np.uint8)
    chunk_bits = np.zeros(L, np.int32)
    for i in range(S):
        part = scan[i * chunk_bytes : i * chunk_bytes + stride]
        xs[i, : part.size] = part
        chunk_bits[i] = min(chunk_bytes, scan.size - i * chunk_bytes) * 8
    cap = 8
    while cap < min(4 * (n_blocks // S + 1) + 64, MAX_BLOCKS_PER_LANE):
        cap *= 2
    return SpecPlan(
        xs=xs,
        chunk_bits=chunk_bits,
        blk_cap=cap,
        tables=tables,
        chunk_bytes=chunk_bytes,
        n_lanes=S,
        n_blocks_total=n_blocks,
        bpm=img.blocks_per_mcu,
    )


@dataclass(frozen=True)
class SpecBatchPlan:
    """Speculative plan of a chunk: every image's equal-split lanes
    stacked into one matrix (the JAX package's SpecBatchPlan)."""

    xs: np.ndarray            # uint8 [L, chunk + overlap]
    chunk_bits: np.ndarray    # int32 [L]
    img_first: np.ndarray     # int32 [n_imgs]
    img_lanes: np.ndarray     # int32 [n_imgs]
    img_blocks: np.ndarray    # int64 [n_imgs]
    blk_cap: int
    tables: FsmTables
    chunk_bytes: int
    n_lanes: int
    bpm: int


def build_spec_plan_batch(imgs: list[JpegImage],
                          chunk_bytes: int = 2048) -> SpecBatchPlan:
    """Split every image's scan into chunk_bytes lanes (+ SPEC_OVERLAP
    bytes of the next chunk), lanes padded to a multiple of 128.  Raises
    JpegError when the batch mixes geometries or tables."""
    tables = build_tables(imgs[0])
    pattern0 = imgs[0].mcu_block_pattern()
    stride = chunk_bytes + SPEC_OVERLAP
    firsts, lanes, blocks = [], [], []
    total = 0
    for img in imgs:
        if img.mcu_block_pattern() != pattern0 or build_tables(img) != tables:
            raise JpegError("fsm: batch mixes geometries or Huffman tables")
        S = max(1, -(-img.scan_data.size // chunk_bytes))
        firsts.append(total)
        lanes.append(S)
        blocks.append(img.n_mcus * img.blocks_per_mcu)
        total += S
    L = _round_up(total, 128)
    xs = np.zeros((L, stride), np.uint8)
    chunk_bits = np.zeros(L, np.int32)
    for img, first, S in zip(imgs, firsts, lanes):
        scan = img.scan_data
        for i in range(S):
            part = scan[i * chunk_bytes : i * chunk_bytes + stride]
            xs[first + i, : part.size] = part
            chunk_bits[first + i] = (
                min(chunk_bytes, scan.size - i * chunk_bytes) * 8
            )
    # counting cap: 4x the average blocks per lane, plus headroom
    cap = 8
    worst = max(4 * (nb // S + 1) + 64 for nb, S in zip(blocks, lanes))
    while cap < min(worst, MAX_BLOCKS_PER_LANE):
        cap *= 2
    return SpecBatchPlan(
        xs=xs,
        chunk_bits=chunk_bits,
        img_first=np.asarray(firsts, np.int32),
        img_lanes=np.asarray(lanes, np.int32),
        img_blocks=np.asarray(blocks, np.int64),
        blk_cap=cap,
        tables=tables,
        chunk_bytes=chunk_bytes,
        n_lanes=total,
        bpm=imgs[0].blocks_per_mcu,
    )


def _lane_masks(plan: SpecBatchPlan):
    """(inherit, body) bool [L]: lanes that take a predecessor's end
    state, and lanes with a successor in their image."""
    L = plan.chunk_bits.shape[0]
    inherit = np.ones(L, bool)
    inherit[plan.img_first] = False
    inherit[plan.n_lanes:] = False
    body = np.zeros(L, bool)
    body[: plan.n_lanes] = True
    body[plan.img_first + plan.img_lanes - 1] = False
    return inherit, body


def spec_lane_arrays(plan: SpecBatchPlan):
    """The host arrays spec_sync_start reads beside the byte matrix:
    (chunk_bits int32 [L], inherit bool [L], body bool [L])."""
    return (plan.chunk_bits, *_lane_masks(plan))


def _upload_spec(plan: SpecBatchPlan, xs_dev, device):
    """The plan's byte matrix on the device (xs_dev when given; `device`,
    default the card, otherwise)."""
    if xs_dev is not None:
        return xs_dev
    return torch.as_tensor(plan.xs).to(device or "cuda")


def _handoff(end_bits, end_bim, inherit, chunk_bytes: int, max_start=None):
    """Each lane's entry state from its predecessor's end state, rebased
    into the lane's row; non-inheriting lanes start at (0, 0)."""
    P = torch.roll(end_bits, 1) - chunk_bytes * 8
    P = torch.clamp(P, 0, max_start) if max_start is not None \
        else torch.clamp(P, min=0)
    zero = torch.zeros_like(P)
    return (torch.where(inherit, P, zero),
            torch.where(inherit, torch.roll(end_bim, 1), zero))


@dataclass
class SpecSyncPending:
    """A sync-spec chunk after its cold + stitch scans (device tensors);
    the resolve fetch is still to come."""

    plan: SpecBatchPlan
    ev1: torch.Tensor       # [N1, L] cold events (pass 1)
    anchors: torch.Tensor   # [N1, L] pass-1 block-boundary anchors
    ablk: torch.Tensor      # [N1, L] pass-1 block count per anchor
    recm: torch.Tensor      # [N1, L] pass-1 recovery markers (-1 = none)
    ev2: torch.Tensor       # [N2, L] stitch events (pass 2)
    end2: torch.Tensor      # [L] stitch-point bit position
    b1: torch.Tensor        # [L] pass-1 block count at the stitch point
    blk2: torch.Tensor      # [L] pass-2 decoded block count
    packed: torch.Tensor    # [3L + 2]: quotas, hits, blk2, mal, env
    steps: object


def _spec_sync_scan(xs, chunk_bits, inherit, body, tables: FsmTables,
                    blk_cap: int, steps, anchor_rows: int):
    """The two speculative passes and the on-device part of the resolve
    (the JAX package's _spec_sync_scan_jit, without its XLA:CPU probe
    term).  Returns (ev1, anchors, ablk, recm, ev2, end2, b1, blk2,
    packed [3L + 2])."""
    L = chunk_bits.shape[0]
    chunk_bytes = xs.shape[1] - SPEC_OVERLAP
    caps = torch.full((L,), blk_cap, dtype=torch.int32, device=xs.device)
    cold = fsm_scan_spec(xs, caps, tables, steps, chunk_bits=chunk_bits,
                         log_anchors=True)
    ev1, anchors, ablk, recm = (
        t.reshape(-1, L)
        for t in (cold.events, cold.anchors, cold.ablk, cold.recm)
    )
    # true entry per lane = the predecessor's cold end (exact iff the
    # predecessor hits, which the host resolve certifies chunk-wide)
    P, bim_t = _handoff(cold.end_bits, cold.end_bim, inherit, chunk_bytes)

    w2 = min(SPEC_STITCH_BYTES, chunk_bytes)
    wslice = min(w2 + SPEC_OVERLAP, xs.shape[1])
    st2 = fsm_scan_spec(
        xs[:, :wslice], caps, tables, steps, start_bits=P, start_bim=bim_t,
        chunk_bits=torch.clamp(chunk_bits, max=w2 * 8),
    )
    ev2 = st2.events.reshape(-1, L)
    em2, ee2, end2, blk2 = st2.err_mal, st2.err_env, st2.end_bits, st2.blk

    # membership: has the cold trajectory visited the stitch state?
    target = (end2 << 3) | st2.end_bim
    rows = min(anchor_rows, anchors.shape[0])
    match = anchors[:rows] == target[None, :]
    synced = match.any(dim=0)
    b1 = torch.where(match, ablk[:rows], 0).amax(dim=0)
    quota = blk2 + torch.clamp(cold.blk - b1, min=0)
    # envelope pressure: a pass-2 latch on a body lane, or a pass-1
    # recovery past the stitch point on a lane that synced (its cold
    # trajectory from there is the true stream)
    deep = synced & (cold.rec_last > end2) & body
    env = ((ee2 & body & ~em2) | deep).any()
    mal = (em2 & body).any()
    hit = synced & ~(em2 | ee2) & ~deep
    packed = torch.cat([
        quota, hit.to(torch.int32), blk2,
        torch.stack([mal, env]).to(torch.int32),
    ])
    return ev1, anchors, ablk, recm, ev2, end2, b1, blk2, packed


def spec_sync_start(imgs: list[JpegImage], chunk_bytes: int = 1024,
                    plan: SpecBatchPlan | None = None, xs_dev=None,
                    steps=STEPS_PRODUCTION, device=None,
                    lanes_dev=None) -> SpecSyncPending:
    """Run a chunk's cold + stitch scans on the device of `xs_dev` (or
    `device`, default the card).  lanes_dev: the plan's (chunk_bits,
    inherit, body) already on that device (`spec_lane_arrays`), uploaded
    here otherwise.  Raises SpecSyncMiss for more than 8 blocks per MCU
    (the anchor's phase field is 3 bits)."""
    if plan is None:
        plan = build_spec_plan_batch(imgs, chunk_bytes)
    if plan.bpm > 8:
        raise SpecSyncMiss("spec-sync: > 8 blocks per MCU")
    xs = _upload_spec(plan, xs_dev, device)
    dev = xs.device
    if lanes_dev is None:
        lanes_dev = tuple(torch.as_tensor(a).to(dev)
                          for a in spec_lane_arrays(plan))
    chunk_bits, inherit, body = lanes_dev
    bpc, spc = _steps_spec(steps)
    rows = (SPEC_STITCH_BYTES + SPEC_OVERLAP + 64) * 2 * spc // (bpc * 2)
    out = _spec_sync_scan(
        xs, chunk_bits, inherit, body, plan.tables, plan.blk_cap, steps,
        rows,
    )
    return SpecSyncPending(plan, *out, steps)


def _cap_w(quotas: np.ndarray, blk_cap: int) -> int:
    """Write width: the largest quota's pow2 bucket (>= 16, <= blk_cap)."""
    cap_w = 16
    while cap_w < int(quotas.max(initial=1)):
        cap_w *= 2
    return min(cap_w, blk_cap)


def spec_sync_resolve_host(pending: SpecSyncPending):
    """The one host read of the sync path: quotas and hits, each image's
    last-lane remainder, the per-image chain check.

    Returns (quotas int32 [L], cap_w) or raises SpecEnvelopeError /
    SpecSyncMiss for the caller's retry ladder."""
    plan = pending.plan
    T = plan.n_lanes
    L = plan.chunk_bits.shape[0]
    fetched = pending.packed.cpu().numpy()
    quotas = fetched[:L].astype(np.int32)
    hits = fetched[L : 2 * L].astype(bool)
    blk2 = fetched[2 * L : 3 * L].astype(np.int32)
    any_env = int(fetched[3 * L + 1])
    quotas[T:] = 0
    hits[T:] = True

    w2 = min(SPEC_STITCH_BYTES, plan.chunk_bytes)
    ok = True
    for first, S, nb in zip(plan.img_first, plan.img_lanes, plan.img_blocks):
        # a LAST lane counts past the stream end into padding: its quota
        # is the image remainder; when the remainder fits the stitch
        # window, pass 2's prefix is the whole decode and must cover it
        li = first + S - 1
        last = int(nb) - int(quotas[first:li].sum())
        quotas[li] = last
        if int(plan.chunk_bits[li]) <= w2 * 8:
            hits[li] = blk2[li] >= last
        span = quotas[first : first + S]
        if (last < 0 or int(span.max(initial=0)) > plan.blk_cap
                or int(span.min(initial=0)) < 0):
            ok = False
            break
    if not (ok and hits[:T].all()):
        if any_env:
            raise SpecEnvelopeError(
                "spec-sync cold pass latched envelope lanes"
            )
        raise SpecSyncMiss(
            "spec-sync: cold decode failed to resolve every lane"
        )
    return quotas, _cap_w(quotas, plan.blk_cap)


def _gather_index(quotas: torch.Tensor, cap: int, nb: int, n_imgs: int):
    """Flat (lane * cap + slot) source row of every block of every image,
    int64 [n_imgs * nb], built on the device from the [L] quotas: lanes
    are image-major and each image's quotas sum to nb, so block g sits in
    the last lane whose quota prefix is <= g.  Lane markers are scattered
    at the prefix sums and forward-filled with a running max; zero-quota
    lanes park their marker out of range."""
    L = quotas.shape[0]
    dev = quotas.device
    total = n_imgs * nb
    q = quotas.to(torch.int64)
    off = torch.cumsum(q, 0) - q
    lanes = torch.arange(L, dtype=torch.int64, device=dev)
    keep = (q > 0) & (off < total)
    lane_at = torch.zeros(total, dtype=torch.int64, device=dev)
    off_at = torch.zeros(total, dtype=torch.int64, device=dev)
    lane_at.scatter_reduce_(0, off[keep], lanes[keep], reduce="amax")
    off_at.scatter_reduce_(0, off[keep], off[keep], reduce="amax")
    lane_of = torch.cummax(lane_at, 0).values
    off_of = torch.cummax(off_at, 0).values
    g = torch.arange(total, dtype=torch.int64, device=dev)
    return lane_of * cap + (g - off_of)


def _pad_imgs(x: torch.Tensor, pad_to: int) -> torch.Tensor:
    if pad_to <= x.shape[0]:
        return x
    pad = torch.zeros((pad_to - x.shape[0],) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad])


def _spec_gather16(per_lane, quotas, tables: FsmTables, pad_to: int,
                   nb: int, n_imgs: int):
    """Lane rows [L, cap, 64] -> (coeffs int16 [pad_to, nb, 64] with raw
    DC differences, dc int32 [pad_to, nb] resolved)."""
    L, cap, _ = per_lane.shape
    idx = _gather_index(quotas, cap, nb, n_imgs)
    coeffs = per_lane.reshape(L * cap, 64).index_select(0, idx) \
        .reshape(n_imgs, nb, 64)
    dc = _dc_cumsum(coeffs[:, :, 0], tables, nb)
    return _pad_imgs(coeffs, pad_to), _pad_imgs(dc, pad_to)


def _spec_gather(per_lane, quotas, tables: FsmTables, pad_to: int, nb: int,
                 n_imgs: int):
    """Lane rows [L, cap, 64] -> int32 coeffs [pad_to, nb, 64], DC
    resolved."""
    coeffs, dc = _spec_gather16(per_lane, quotas, tables, pad_to, nb, n_imgs)
    coeffs = coeffs.to(torch.int32)
    coeffs[:, :, 0] = dc
    return coeffs


def _spec_sync_merge(ev1, anchors, ablk, recm, ev2, end2, b1, blk2, quotas):
    """Merge stitch events with the adopted, rebased cold events.

    Returns (events int32 [N2 + N1, L], err bool [L]).  A lane is valid
    (else latched in err) when the anchor that ends its adopted span
    exists and no pass-1 recovery marker lies between the stitch point
    and that anchor.  The merged stream is monotone per lane (stitch
    blocks [0, take2), then rebased cold blocks [blk2, quota)), so the
    slot route takes it."""
    take2 = torch.minimum(blk2, quotas)
    rest = torch.clamp(quotas - blk2, min=0)

    blk2ev = (ev2 >> 18) & 0x1FFF
    part2 = torch.where((ev2 >= 0) & (blk2ev < take2[None, :]), ev2, -1)
    blk1ev = (ev1 >> 18) & 0x1FFF
    keep1 = (ev1 >= 0) & (blk1ev >= b1[None, :]) \
        & (blk1ev < (b1 + rest)[None, :])
    # rebase: final block index = blk1 - b1 + blk2 (only bits >= 18 move;
    # applied to kept events only, whose rebased value is in range)
    shift = ((b1 - blk2) * (1 << 18))[None, :]
    part1 = torch.where(keep1, ev1 - torch.where(keep1, shift, 0), -1)
    ev = torch.cat([part2, part1], dim=0)

    # adopted-span validity
    big = 0x7FFFFFFF
    at_end = (anchors >= 0) & (ablk == (b1 + rest)[None, :])
    E = torch.where(at_end, anchors >> 3, big).amin(dim=0)
    found = (rest == 0) | (E < big)
    bad_span = (rest > 0) & ((recm > end2[None, :])
                             & (recm <= E[None, :])).any(dim=0)
    return ev, (quotas > 0) & (~found | bad_span)


def _spec_sync_assemble(ev1, anchors, ablk, recm, ev2, end2, b1, blk2,
                        quotas, tables: FsmTables, pad_to: int, nb: int,
                        n_imgs: int, cap_w: int, slots=None,
                        route: str = "scatter"):
    """The spec tail: merge (`_spec_sync_merge`), materialize (slots and
    route as in `materialize_checked`), gather into per-image rows,
    resolve DC.  Returns (coeffs int16 [pad_to, nb,
    64] raw DC, dc int32 [pad_to, nb], err [L], err_slot [L])."""
    L = ev1.shape[1]
    ev, err = _spec_sync_merge(ev1, anchors, ablk, recm, ev2, end2, b1,
                               blk2, quotas)
    coeffs_t, err, err_slot = materialize_checked(ev, cap_w * 64, err,
                                                  slots=slots, route=route)
    per_lane = coeffs_t.T.reshape(L, cap_w, 64)
    coeffs, dc = _spec_gather16(per_lane, quotas, tables, pad_to, nb, n_imgs)
    return coeffs, dc, err, err_slot


def _uniform_blocks(plan) -> int:
    nbs = {int(nb) for nb in plan.img_blocks}
    if len(nbs) != 1:
        raise JpegError("device_out requires a uniform-geometry batch")
    return nbs.pop()


def decode_speculative_sync(imgs: list[JpegImage], chunk_bytes: int = 1024,
                            device_out: bool = True,
                            pad_to: int | None = None,
                            plan: SpecBatchPlan | None = None, xs_dev=None,
                            steps=STEPS_PRODUCTION,
                            pending: SpecSyncPending | None = None,
                            device=None, route: str = "scatter"):
    """Single-pass speculative batch decode, staged: start, resolve, the
    tail on the classic materialize (by `route`, materialize_events).  Returns (coeffs int32 [pad_to, nb,
    64] DC resolved, (err, all-False)) on the device, like
    decode_speculative_batch(device_out=True); device_out=False returns
    per-image host int32 [n_blocks, 64] and raises SpecSyncMiss where a
    lane latched.  Raises SpecSyncMiss / SpecEnvelopeError.  The batch
    has one block count either way: the JAX package's device_out=False
    gathers a mixed batch at the first image's count, the port raises
    JpegError."""
    if pending is None:
        pending = spec_sync_start(imgs, chunk_bytes, plan, xs_dev, steps,
                                  device)
    plan = pending.plan
    nb = _uniform_blocks(plan)
    quotas, cap_w = spec_sync_resolve_host(pending)
    coeffs16, dc, err, _ = _spec_sync_assemble(
        pending.ev1, pending.anchors, pending.ablk, pending.recm,
        pending.ev2, pending.end2, pending.b1, pending.blk2,
        torch.as_tensor(quotas).to(pending.ev1.device), plan.tables,
        pad_to or len(imgs), nb, len(imgs), cap_w, slots=False, route=route,
    )
    coeffs = coeffs16.to(torch.int32)
    coeffs[:, :, 0] = dc
    if not device_out:
        got = coeffs.cpu().numpy()
        if bool(err.any()):
            raise SpecSyncMiss("spec-sync: materialization checksum failed")
        return [got[i, : int(nbi)] for i, nbi in enumerate(plan.img_blocks)]
    return coeffs, (err, torch.zeros_like(err))


# -- Jacobi fallback --------------------------------------------------------


@dataclass
class SpecPending:
    """A Jacobi chunk after convergence: start states on the device and
    the [L + 3] block counts and flags still to be read."""

    plan: SpecBatchPlan
    xs: torch.Tensor      # device scan bytes
    sb: torch.Tensor      # device start bits (converged)
    sm: torch.Tensor      # device start phases
    packed: torch.Tensor  # device [L + 3]: blocks, mal, env, changed
    steps: object


def _spec_converge(xs, chunk_bits, inherit, max_iters: int,
                   tables: FsmTables, blk_cap: int, steps=STEPS_PRODUCTION):
    """The Jacobi boundary fixed point: each iteration is one count-mode
    scan; lane i's next start is lane i-1's end (rebased) where `inherit`
    holds.  One device flag is read per iteration.  Returns (start_bits,
    start_bim, blk, err_mal, err_env, changed, iters): changed is True
    when max_iters ran out first.  chip_smoke.py phase 8 times a copy of
    this loop without the read (`unread`); change the two together."""
    L = chunk_bits.shape[0]
    stride = xs.shape[1]
    caps = torch.full((L,), blk_cap, dtype=torch.int32, device=xs.device)
    sb = torch.zeros(L, dtype=torch.int32, device=xs.device)
    sm = torch.zeros_like(sb)
    blk = sb
    err_mal = err_env = torch.zeros(L, dtype=torch.bool, device=xs.device)
    changed, it = True, 0
    while changed and it < max_iters:
        st = fsm_scan_spec(xs, caps, tables, steps, start_bits=sb,
                           start_bim=sm, chunk_bits=chunk_bits, emit=False)
        nb, nm = _handoff(st.end_bits, st.end_bim, inherit,
                          stride - SPEC_OVERLAP, max_start=stride * 8 - 1)
        changed = bool(((nb != sb) | (nm != sm)).any())
        sb, sm, blk, err_mal, err_env = nb, nm, st.blk, st.err_mal, st.err_env
        it += 1
    return sb, sm, blk, err_mal, err_env, changed, it


def spec_start(imgs: list[JpegImage], chunk_bytes: int = 2048,
               max_iters: int | None = None,
               plan: SpecBatchPlan | None = None, xs_dev=None,
               steps=STEPS_PRODUCTION, device=None) -> SpecPending:
    """Converge a chunk's lane handoff states on the device."""
    if plan is None:
        plan = build_spec_plan_batch(imgs, chunk_bytes)
    T = plan.n_lanes
    L = plan.chunk_bits.shape[0]
    xs = _upload_spec(plan, xs_dev, device)
    dev = xs.device
    inherit, _ = _lane_masks(plan)
    iters = max_iters or int(plan.img_lanes.max()) + 1
    sb, sm, blocks, err_mal, err_env, changed, _ = _spec_converge(
        xs, torch.as_tensor(plan.chunk_bits).to(dev),
        torch.as_tensor(inherit).to(dev), iters, plan.tables,
        plan.blk_cap, steps,
    )
    # count latches on an image's LAST lane are benign (it runs past the
    # true end into the padding after its last boundary): only body lanes
    # classify
    countable = np.ones(L, bool)
    countable[T:] = False
    countable[plan.img_first + plan.img_lanes - 1] = False
    packed = _spec_fetch_pack(blocks, err_mal, err_env, changed,
                              torch.as_tensor(countable).to(dev))
    return SpecPending(plan, xs, sb, sm, packed, steps)


def _spec_fetch_pack(blocks, err_mal, err_env, changed: bool, countable):
    """The chunk's single read: [L] block counts + 3 flag ints."""
    flags = torch.stack([
        (err_mal & countable).any(), (err_env & countable).any(),
        torch.tensor(changed, device=blocks.device),
    ]).to(torch.int32)
    return torch.cat([blocks, flags])


def decode_speculative_batch(imgs: list[JpegImage], chunk_bytes: int = 2048,
                             max_iters: int | None = None,
                             device_out: bool = False,
                             pad_to: int | None = None,
                             plan: SpecBatchPlan | None = None, xs_dev=None,
                             steps=STEPS_PRODUCTION,
                             pending: SpecPending | None = None,
                             device=None, route: str = "scatter"):
    """Jacobi speculative batch decode.

    One host read (block counts and flags) after convergence, then the
    write pass (scan from the converged states with per-lane quotas,
    classic materialize by `route`).  device_out=False returns per-image
    host int32 [n_blocks, 64] coefficients (geometries may mix; DPCM
    resolved per component on the host) and raises JpegError where the
    write pass latched; device_out=True (one block count per batch)
    returns (coeffs int32 [pad_to or B, nb, 64] DC resolved, (err_mal,
    err_env) [L]) on the device, gathered there.  Raises
    SpecEnvelopeError when the count pass latched envelope lanes under
    `steps`, JpegError on malformed streams or non-convergence."""
    if pending is None:
        pending = spec_start(imgs, chunk_bytes, max_iters, plan, xs_dev,
                             steps, device)
    plan, xs, sb, sm, steps = (pending.plan, pending.xs, pending.sb,
                               pending.sm, pending.steps)
    nb = _uniform_blocks(plan) if device_out else None
    T = plan.n_lanes
    L = plan.chunk_bits.shape[0]
    fetched = pending.packed.cpu().numpy()
    any_mal, any_env, changed = (int(v) for v in fetched[L : L + 3])
    if changed:
        raise JpegError("speculative split did not converge")
    if any_mal:
        raise JpegError("speculative count pass latched malformed lanes")
    if any_env:
        raise SpecEnvelopeError(
            "speculative count pass latched envelope lanes "
            f"(stream denser than steps={steps})"
        )
    quotas = fetched[:L].astype(np.int32)
    quotas[T:] = 0
    for first, S, nbi in zip(plan.img_first, plan.img_lanes,
                             plan.img_blocks):
        body = quotas[first : first + S - 1]
        last = int(nbi) - int(body.sum())
        # last == 0 is legitimate: a split boundary right after the final
        # block leaves the trailing lane only padding
        if last < 0 or last > plan.blk_cap or np.any(body >= plan.blk_cap):
            raise JpegError("speculative split found inconsistent block counts")
        quotas[first + S - 1] = last
    cap_w = _cap_w(quotas, plan.blk_cap)
    quotas_dev = torch.as_tensor(quotas).to(xs.device)
    # write pass: every lane from its converged state, DC left as diffs
    out = fsm_scan_spec(xs, quotas_dev, plan.tables, steps, start_bits=sb,
                        start_bim=sm)
    coeffs_t, err_mal, _ = materialize_checked(
        out.events.reshape(-1, L), cap_w * 64, out.err_mal, slots=False,
        route=route,
    )
    per_lane = coeffs_t.T.reshape(L, cap_w, 64)
    if device_out:
        coeffs = _spec_gather(per_lane, quotas_dev, plan.tables,
                              pad_to or len(imgs), nb, len(imgs))
        return coeffs, (err_mal, out.err_env)
    if bool((err_mal | out.err_env).any()):
        raise JpegError("speculative decode failed (malformed scan)")
    pl = per_lane.to(torch.int32).cpu().numpy()
    result = []
    pattern = np.asarray(plan.tables.comp, np.int32)
    for first, S, nbi in zip(plan.img_first, plan.img_lanes, plan.img_blocks):
        coeffs = np.concatenate(
            [pl[first + i, : quotas[first + i]] for i in range(S)])
        # DC left the scan as differences: one cumsum per component
        comp_seq = np.tile(pattern, int(nbi) // plan.bpm)
        for c in range(plan.tables.n_comp):
            m = comp_seq == c
            coeffs[m, 0] = np.cumsum(coeffs[m, 0])
        result.append(coeffs)
    return result


def decode_speculative(img: JpegImage, chunk_bytes: int = 2048,
                       max_iters: int | None = None,
                       device="cuda") -> np.ndarray:
    """Entropy-decode one stream without restart markers on `device` by
    the speculative split (decode_speculative_batch).  Returns int32
    [n_blocks, 64]; a stream denser than the production step budget is
    decoded once more at STEPS_SAFE."""
    try:
        return decode_speculative_batch([img], chunk_bytes, max_iters,
                                        device=device)[0]
    except SpecEnvelopeError:
        return decode_speculative_batch([img], chunk_bytes, max_iters,
                                        steps=STEPS_SAFE, device=device)[0]
