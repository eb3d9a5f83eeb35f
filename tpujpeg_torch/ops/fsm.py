"""Restart-lane Huffman symbol FSM: host tables and plan, the scan
(kernel 1), classic materialize and the DC resolve.

Counterpart of tpujpeg/ops/fsm.py, restart mode only.  Each lane is one
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
copy of the JAX package's, without the TPU's two-level symbol map: the
scan looks (length, symbol) up in a flat per-table LUT of all 65,536
16-bit peeks (`symbol_lut`), exact by construction.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from tpujpeg.errors import JpegError
from tpujpeg.io.huffman import HuffmanTable
from tpujpeg.io.parser import JpegImage

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


def _scan_steps(steps) -> int:
    """Symbol steps per 1-byte column; raises on specs the port lacks."""
    bpc, k = _steps_spec(steps)
    if bpc != 1 or k < 1:
        raise NotImplementedError(
            f"steps spec {steps!r}: the port scans 1-byte columns only "
            "(multi-byte columns are not ported)"
        )
    return k


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


# ---------------------------------------------------------------------------
# Host-side segment packing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FsmPlan:
    """Lane matrix + metadata for one chunk (one stride class).

    xs[L, stride] uint8 holds one restart segment per row (zero padded;
    L a multiple of 128); seg_n_blocks[L] its block quota (0 for padding
    lanes).  layout: per image, (first_lane, n_lanes,
    blocks_per_full_lane, blocks_in_last_lane).
    """

    xs: np.ndarray
    seg_n_blocks: np.ndarray
    tables: FsmTables
    max_blk: int
    layout: tuple
    n_blocks_total: int


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


def build_plan(imgs: list[JpegImage]) -> FsmPlan:
    """Pack the restart segments of a chunk into one lane matrix.

    The JAX package's build_plan(split=False): one stride class, the case
    of scan bytes resident on one card.  Raises JpegError when the chunk
    mixes geometries or tables, misses restart segments or overflows the
    packed event's block field.
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

    xs, seg_n = _pack_group(seg_bytes, nblocks, list(range(len(seg_bytes))))
    max_blk = max(16, _round_up(max(nblocks), 16))
    return FsmPlan(
        xs=xs,
        seg_n_blocks=seg_n,
        tables=tables,
        max_blk=max_blk,
        layout=tuple(layout),
        n_blocks_total=n_blocks_total,
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


def fsm_scan(xs: torch.Tensor, seg_n_blocks: torch.Tensor,
             tables: FsmTables, steps=STEPS_PRODUCTION):
    """Run the symbol FSM over the byte columns of a lane matrix.

    xs: uint8 [L, stride] (one restart segment per row), seg_n_blocks:
    int32 [L].  Returns (events int32 [stride + FLUSH_COLS, K, L],
    err_mal bool [L], err_env bool [L]), K symbol steps per column.

    CUDA tensors run kernel 1 (csrc/fsm_scan.cu); CPU tensors run
    `fsm_scan_plain`.
    """
    k = _scan_steps(steps)
    if not xs.is_cuda:
        return fsm_scan_plain(xs, seg_n_blocks, tables, k)
    from ..runtime import kernels

    kernels.check_cuda_tensor("xs", xs, torch.uint8, 2)
    kernels.check_cuda_tensor("seg_n_blocks", seg_n_blocks, torch.int32, 1)
    L, stride = xs.shape
    if seg_n_blocks.shape[0] != L or stride % 16:
        raise ValueError(
            f"fsm_scan: bad lane matrix {tuple(xs.shape)} / "
            f"{tuple(seg_n_blocks.shape)} (stride must be a multiple of 16)"
        )
    lut = _device_lut(tables, xs.device)
    meta = scan_meta(tables)
    n_cols = stride + FLUSH_COLS
    events = torch.empty((n_cols, k, L), dtype=torch.int32, device=xs.device)
    err_mal = torch.empty(L, dtype=torch.bool, device=xs.device)
    err_env = torch.empty(L, dtype=torch.bool, device=xs.device)
    kernels.launch(
        "fsm_scan",
        xs.data_ptr(), seg_n_blocks.data_ptr(), lut.data_ptr(),
        meta.ctypes.data, events.data_ptr(), err_mal.data_ptr(),
        err_env.data_ptr(), L, stride, k,
        kernels.current_stream(xs.device),
    )
    return events, err_mal, err_env


_lut_cache: dict = {}


def _device_lut(tables: FsmTables, device) -> torch.Tensor:
    key = (tables, str(device))
    lut = _lut_cache.get(key)
    if lut is None:
        lut = torch.as_tensor(symbol_lut(tables)).to(device)
        if len(_lut_cache) >= 16:
            _lut_cache.clear()
        _lut_cache[key] = lut
    return lut


def fsm_scan_plain(xs: torch.Tensor, seg_n_blocks: torch.Tensor,
                   tables: FsmTables, k: int):
    """Plain PyTorch version of the scan: a Python loop over byte columns,
    each symbol step as vector ops over lanes (the JAX scan body).

    The bit buffer is int64 masked to 32 bits after every refill, which is
    the uint32 buffer of the kernel; every read of it is masked to bits
    below navail <= 32, so the JAX int32 buffer gives the same bits.
    """
    dev = xs.device
    L, stride = xs.shape
    n_cols = stride + FLUSH_COLS
    i64 = torch.int64
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
    buf, navail, kk, blk, bim = zero, zero, zero, zero, zero
    done = seg_n == 0
    err_mal = torch.zeros(L, dtype=torch.bool, device=dev)
    err_env = torch.zeros(L, dtype=torch.bool, device=dev)

    def bits(buf, navail, n):
        """The n bits just below bit `navail` of the buffer."""
        return (buf >> torch.clamp(navail - n, 0, 31)) & ((1 << n) - 1)

    events = torch.empty((n_cols, k, L), dtype=torch.int32, device=dev)
    for col in range(n_cols):
        # ---- refill one byte (none in the FLUSH_COLS tail)
        active = ~done & ~err_mal & ~err_env
        if col < stride:
            take = torch.where(active, 8, 0)
            overflow = navail + take > 32
            err_env = err_env | (active & overflow)
            take = torch.where(overflow, 0, take)
            buf = ((buf << take) | (cols[col] & ((1 << take) - 1))) \
                & 0xFFFFFFFF
            navail = navail + take
        for s in range(k):
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
            err_mal = err_mal | (active & (length > 16) & (navail >= 16))
            # magnitude bits + EXTEND
            mag = (buf >> torch.clamp(navail - need, 0, 31)) \
                & ((1 << size) - 1)
            half = 1 << torch.clamp(size - 1, min=0)
            val = torch.where(mag >= half, mag, mag - 2 * half + 1)
            eob = complete & ~is_dc & (sym == 0)
            z = torch.where(is_dc, 0, kk + run)
            bad_z = complete & ~is_dc & (z > 63)
            emit = complete & (size > 0) & ~bad_z
            err_mal = err_mal | (complete & (size > 0) & bad_z)
            events[col, s] = torch.where(
                emit, (blk << 18) | (z << 12) | (val + 2048), -1
            ).to(torch.int32)
            k2 = torch.where(
                complete,
                torch.where(is_dc, 1, torch.where(eob, 64, z + 1)),
                kk,
            )
            navail = navail - torch.where(complete, need, 0)
            # trailing EOB of this table set
            el = eob_len[tsel]
            eob_fire = (
                complete & (k2 < 64) & (el > 0) & (navail >= el)
                & (bits(buf, navail, el) == eob_code[tsel])
            )
            navail = navail - torch.where(eob_fire, el, 0)
            block_end = (complete & (k2 >= 64)) | eob_fire
            blk = blk + block_end.to(i64)
            bim = torch.where(
                block_end, torch.where(bim + 1 == bpm, 0, bim + 1), bim
            )
            k3 = torch.where(block_end, 0, k2)
            done = done | (block_end & (blk >= seg_n))
            # trailing size-0 DC of the next block
            ts2 = tsel_of[bim]
            dl = dc0_len[ts2]
            dc0_fire = (
                block_end & ~done & (dl > 0) & (navail >= dl)
                & (bits(buf, navail, dl) == dc0_code[ts2])
            )
            navail = navail - torch.where(dc0_fire, dl, 0)
            kk = torch.where(dc0_fire, 1, k3)
    # a lane undone at the end is truncated, or starved of steps with
    # whole bytes still buffered (an envelope condition)
    undone = ~done
    starved = undone & (navail >= 8)
    return events, err_mal | (undone & ~starved), err_env | starved


# ---------------------------------------------------------------------------
# Materialize + DC resolve
# ---------------------------------------------------------------------------


def materialize_checked(ev: torch.Tensor, M: int, err_mal: torch.Tensor):
    """Classic materialize: events [N, L] -> dense int16 [M, L].

    Returns (coeffs_t int16 [M, L], err_mal, err_slot).  err_slot is
    all-False (the slot path is not ported).  An event whose target is
    outside [0, M) latches its lane's err_mal.  Under TPUJPEG_SELFCHECK=1
    a per-lane checksum sum(val * (target + 1)) of the event stream is
    compared with sum(value * (row + 1)) of the dense tensor, in int32
    wraparound, and a mismatch latches err_mal.
    """
    from .materialize import place_events

    L = ev.shape[1]
    err_mal = err_mal.clone()
    coeffs_t = place_events(ev, M, err_mal)
    err_slot = torch.zeros(L, dtype=torch.bool, device=ev.device)
    if os.environ.get("TPUJPEG_SELFCHECK", "auto") == "1":
        valid = ev >= 0
        e = ev.to(torch.int64)
        val = torch.where(valid, (e & 0xFFF) - 2048, 0)
        tgt = torch.where(valid, ((e >> 18) & 0x1FFF) * 64 + ((e >> 12) & 63), 0)
        chk_ev = (val * (tgt + 1)).sum(dim=0) & 0xFFFFFFFF
        w = torch.arange(1, M + 1, dtype=torch.int64, device=ev.device)
        chk_mat = (coeffs_t.to(torch.int64) * w[:, None]).sum(dim=0) \
            & 0xFFFFFFFF
        err_mal = err_mal | (chk_ev != chk_mat)
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
