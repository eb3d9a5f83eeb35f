"""Events -> dense coefficients: the classic scatter, its two other
placements, and the slot route.

Contract of tpujpeg/ops/materialize.py::place_events_v3 and of
fsm._materialize_events: packed events int32 [N, L]
(`blk << 18 | z << 12 | (val + 2048)`, valid when >= 0) go to row
64*blk + z of their lane in an int16 [M, L] tensor; every other row is 0.

Classic materialize (kernel "place_events", csrc/materialize.cu; its
body, csrc/place.cuh, is also spread_full's).  On the TPU
this takes a stable compaction and a monotone spread through butterfly
networks (the Pallas kernels _fine_compact_rank_kernel and
_fine_spread_kernel plus their XLA coarse stages), because XLA:TPU
scatters serially.  Hopper scatters natively, so the joint contract is
one kernel.  Every event carries its own target and per-lane targets are
distinct, so stores never collide and any thread may place any event:
the kernel is parallel over event rows as well as lanes (a thread takes
four lanes x four rows, loads first, then stores), which keeps enough
loads in flight to stream the event matrix at the memory rate.  What is
left is the scatter's own cost: the output is lane-minor, so each 2-byte
store moves its own 32-byte sector.

Slot route (`place_events_slots`, kernels "compact", "slot_unpack" and
"slot_expand", csrc/slots.cu): the JAX package's place_events_slots.
G consecutive blocks of a lane share C slots; an event's slot is
`group * C + rank_in_group` with group = blk >> log2(G).  The three
stages keep the TPU kernels' contracts:

  compact    events [N, L] -> (p int32, o int16) [N, L]: valid events
             stably at their per-lane rank rows, o == 0 there, p == 0
             and o == -1 elsewhere;
  unpack     (p, o) -> o2 int16 [N, L] = slot - row (-1 where empty or
             overflowed) + a per-lane overflow flag (a group holding more
             than C events);
  expand     (o2, p) -> dense int16 [M, L] at row
             (slot >> log2 C) * 64G + 64 * (blk mod G) + z = 64 * blk + z.

Validity comes from o >= 0 and o2 >= 0, never from p != 0: the blk 0 /
z 0 / val -2048 event packs to 0 and is placed like any other.  The
butterflies and VMEM windows of the TPU version are not contracts; on
Hopper the expand is a scatter from slot coordinates.  Overflow lanes
leave their dense rows undefined; callers re-decode with the classic
materialize.

Two more placements of the classic contract (kernels "compact_offsets",
"compact_full" and "spread_full", csrc/routes.cu), the counterparts of
the JAX package's other two classic routes.  No decode path takes them:
the scatter is as fast or faster on every chunk the card has timed.

  `place_events_ranked`  the JAX package's _compact_to_rank with the
             rank kernel off (TPUJPEG_RANK_KERNEL=0): offsets pos - rank
             from a column cumsum (`compact_to_rank(ev, rank_kernel=
             False)`, cut 'init'), then `compact_offsets` moves every
             event up by its offset (cut 'compact'), then `spread_full`
             places the rank rows;
  `place_events_full`    the JAX package's place_events_pallas
             (TPUJPEG_PALLAS=1): `compact_full` (ranks inside the
             kernel, payload only) then `spread_full`.

`compact_offsets` and `compact_full` run the walks of csrc/compact.cuh
(with a low-bit mask `compact_offsets` takes the one whose window
follows destinations read from o), `spread_full` the scatter of
`place_events` (csrc/place.cuh).

`compact_full` marks its empty rows with -1, not with the 0 of the JAX
kernel, whose spread then takes `cp > 0` for validity and drops the event
that packs to 0.  Offsets are int16 in both placements, so both take
event and dense heights below 32768 only, and raise ValueError past them
(`_check_int16`).

Every wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version (`*_plain`) for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

SLOT_C = 256   # default capacity: slots per group
SLOT_G = 8     # blocks per group
SLOT_W = 1024   # the JAX package's slot window: C must divide it
INT16_SPAN = 32768  # rank and slot rows are int16 offsets


def place_events_plain(ev: torch.Tensor, M: int,
                       err_mal: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of `place_events` (same contract)."""
    N, L = ev.shape
    e = ev.to(torch.int64)
    valid = e >= 0
    target = ((e >> 18) & 0x1FFF) * 64 + ((e >> 12) & 63)
    val = (e & 0xFFF) - 2048
    inside = valid & (target < M)
    if err_mal is not None:
        err_mal |= (valid & ~inside).any(dim=0)
    lane = torch.arange(L, device=ev.device).expand(N, L)
    out = torch.zeros((M, L), dtype=torch.int16, device=ev.device)
    out[target[inside], lane[inside]] = val[inside].to(torch.int16)
    return out


def place_events(ev: torch.Tensor, M: int,
                 err_mal: torch.Tensor | None = None) -> torch.Tensor:
    """events int32 [N, L] -> values int16 [M, L].

    An event whose target row is >= M is not stored; when `err_mal`
    (bool [L]) is given, its lane is latched in place.  CUDA tensors run
    kernel "place_events"; CPU tensors run the plain version.
    """
    if not ev.is_cuda:
        return place_events_plain(ev, M, err_mal)
    from ..runtime import kernels

    kernels.check_cuda_tensor("ev", ev, torch.int32, 2)
    N, L = ev.shape
    if err_mal is not None:
        kernels.check_cuda_tensor("err_mal", err_mal, torch.bool, 1)
        if err_mal.shape[0] != L:
            raise ValueError("place_events: err_mal must be [L]")
    out = torch.empty((M, L), dtype=torch.int16, device=ev.device)
    kernels.launch(
        "place_events", ev.device,
        ev.data_ptr(), out.data_ptr(),
        None if err_mal is None else err_mal.data_ptr(),
        N, M, L,
    )
    return out


# ---------------------------------------------------------------------------
# Slot route
# ---------------------------------------------------------------------------


def _log2(x: int) -> int:
    """log2 of a power of two; raises ValueError for anything else."""
    if x < 1 or x & (x - 1):
        raise ValueError(f"slot route: {x} is not a power of two")
    return x.bit_length() - 1


def slot_gate(N: int, M: int, C: int | None = None,
              G: int | None = None) -> bool:
    """Whether the slot route takes events [N, L] -> dense [M, L] at
    capacity C: C and G are powers of two with C dividing SLOT_W and
    C <= 64 G, and the rank rows N and the slot rows ceil(M / 64 / G) * C
    fit the int16 offsets."""
    C = SLOT_C if C is None else C
    G = SLOT_G if G is None else G
    if C < 1 or G < 1 or C & (C - 1) or G & (G - 1):
        return False
    if SLOT_W % C or C > 64 * G:
        return False
    Ms = -(-(M // 64) // G) * C
    return N <= INT16_SPAN and Ms <= INT16_SPAN


def events_per_block(coeffs: np.ndarray) -> np.ndarray:
    """Upper bound of the scan's events per block from host coefficients
    [n_blocks, 64]: the nonzero AC count plus one for DC, counted
    whatever its value (a resolved DC says nothing about its DPCM
    difference, which is what the scan emits)."""
    return (np.asarray(coeffs)[:, 1:] != 0).sum(1) + 1


def suggest_slot_c(per_block, G: int | None = None) -> int:
    """Smallest power-of-two C in [64, 256] covering every G-block window
    of an image's event counts (`events_per_block`), or 0 when even 256
    cannot (callers take the classic route).

    The bound is the maximum over ALL sliding G-block windows, the tail
    included: a lane's slot groups are G consecutive blocks counted from
    the lane's first block, which is any block of the image for
    speculative lanes and a restart-segment start (not necessarily a
    multiple of G) for restart lanes."""
    G = SLOT_G if G is None else G
    nz = np.asarray(per_block, np.int64)
    if len(nz) <= G:
        gmax = int(nz.sum())
    else:
        cs = np.concatenate([[0], np.cumsum(nz)])
        gmax = int((cs[G:] - cs[:-G]).max())
    c = 64
    while c < gmax:
        c *= 2
    return c if c <= 256 else 0


def compact_to_rank_plain(ev: torch.Tensor):
    """Plain PyTorch version of `compact_to_rank` (same contract)."""
    N, L = ev.shape
    valid = ev >= 0
    rank = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    lane = torch.arange(L, device=ev.device).expand(N, L)
    p = torch.zeros((N, L), dtype=torch.int32, device=ev.device)
    o = torch.full((N, L), -1, dtype=torch.int16, device=ev.device)
    p[rank[valid], lane[valid]] = ev[valid]
    o[rank[valid], lane[valid]] = 0
    return p, o


def compact_to_rank(ev: torch.Tensor, rank_kernel: bool = True,
                    stop_after: str | None = None):
    """events int32 [N, L] -> (p int32, o int16) [N, L].

    The valid events (>= 0) of each lane, in row order, at rows 0..n-1
    (their rank) with o == 0; p == 0 and o == -1 on the rows after.
    Contract of the JAX package's _compact_to_rank (stop_after="compact"
    of place_events_slots), without its padding of N to the TPU window.

    rank_kernel=True: kernel "compact" derives the ranks itself (the JAX
    package's rank-in-kernel default).  rank_kernel=False: the ranks come
    from a column cumsum outside, as with TPUJPEG_RANK_KERNEL=0:
    stop_after="init" returns (p, o) with o = row - rank on valid rows
    (-1 elsewhere) and p the event (0 elsewhere); kernel
    "compact_offsets" then moves every event up by its offset
    (stop_after="compact" or None).  CPU tensors run the plain versions.
    """
    if stop_after not in (None, "init", "compact"):
        raise ValueError(f"compact_to_rank: stop_after={stop_after!r}")
    if not rank_kernel:
        N = ev.shape[0]
        if N > INT16_SPAN:
            raise ValueError(
                f"compact_to_rank: {N} rows exceed the int16 offsets")
        valid = ev >= 0
        vi = valid.to(torch.int32)
        rank = torch.cumsum(vi, dim=0, dtype=torch.int32) - vi
        pos = torch.arange(N, dtype=torch.int32, device=ev.device)[:, None]
        o = torch.where(valid, pos - rank, -1).to(torch.int16)
        p = torch.where(valid, ev, 0)
        if stop_after == "init":
            return p, o
        return compact_offsets(p, o)
    if stop_after == "init":
        raise ValueError(
            "compact_to_rank: the 'init' cut exists with rank_kernel=False "
            "only (the rank kernel has no offsets outside it)")
    if not ev.is_cuda:
        return compact_to_rank_plain(ev)
    from ..runtime import kernels

    kernels.check_cuda_tensor("ev", ev, torch.int32, 2)
    N, L = ev.shape
    p = torch.empty((N, L), dtype=torch.int32, device=ev.device)
    o = torch.empty((N, L), dtype=torch.int16, device=ev.device)
    if p.numel():
        kernels.launch("compact", ev.device, ev.data_ptr(), p.data_ptr(),
                       o.data_ptr(), N, L)
    return p, o


def check_offsets_mask(mask: int) -> None:
    """Raise ValueError unless `mask` is one that `compact_offsets` takes:
    -1, a low-bit mask 2^j - 1, or its complement ~(2^j - 1), as a C int."""
    low = mask if mask >= 0 else ~mask
    if not -2 ** 31 <= mask < 2 ** 31 or low & (low + 1):
        raise ValueError(
            f"compact_offsets: mask {mask} is not -1, 2^j - 1 or ~(2^j - 1)")


def compact_offsets_plain(p: torch.Tensor, o: torch.Tensor, mask: int = -1):
    """Plain PyTorch version of `compact_offsets` (same contract).  It
    also refuses a complement mask ~(W - 1) on a valid offset that is no
    multiple of W, which the kernel does not check."""
    check_offsets_mask(mask)
    Np, L = p.shape
    row = torch.arange(Np, dtype=torch.int64, device=p.device)[:, None]
    off = o.to(torch.int64)
    if mask < -1 and bool(((o >= 0) & (off & ~mask != 0)).any()):
        raise ValueError(f"compact_offsets: mask {mask} on an offset that "
                         f"is no multiple of {~mask + 1}")
    move = off & mask
    dst = row - move
    valid = (o >= 0) & (dst >= 0)
    lane = torch.arange(L, device=p.device).expand(Np, L)
    p_out = torch.zeros_like(p)
    o_out = torch.full_like(o, -1)
    p_out[dst[valid], lane[valid]] = p[valid]
    o_out[dst[valid], lane[valid]] = (off - move)[valid].to(o.dtype)
    return p_out, o_out


def compact_offsets(p: torch.Tensor, o: torch.Tensor, mask: int = -1,
                    counted_as: str = "compact_offsets",
                    direct: torch.Tensor | None = None):
    """(p int32, o int16) [Np, L] -> (p, o) [Np, L], compacted.

    A valid row holds o = row - rank >= 0, its distance to its rank row;
    the output has each valid event at row - o with o == 0 there, and
    p == 0, o == -1 elsewhere: exactly `compact_to_rank`'s output.
    Contract of the JAX package's _fine_compact_kernel with the coarse
    stages after it (materialize._compact_to_rank with the rank kernel
    off).

    Precondition: o = row - rank on every valid row (o >= 0), and p >= 0
    there.  `compact_to_rank(rank_kernel=False, stop_after="init")` gives
    such (p, o), and a masked call keeps it on the rows it moves to, so
    every producer in the package meets it.  Under it o never falls down
    a lane, so each lane's destinations row - (o & mask) rise strictly.

    mask (default -1: all of the offset) selects one group of the
    compaction network's stages: every valid event moves up by
    `o & mask` and keeps the residual `o - (o & mask)`.  mask = W - 1
    (W = 2^j) is the fine stage alone (the contract of
    _fine_compact_kernel at kc = 1 with window W: stages d < W); mask =
    ~(W - 1) the coarse stages after it, and only on offsets that are
    multiples of W, which is what the fine stage leaves: there it moves
    every event to its rank, as mask -1 does.  The plain version raises
    ValueError on any other valid offset; the kernel does not check (it
    would cost a reduction and a host sync a call) and returns mask -1's
    result there.  The network runs its
    stages low bits first, so the masks compose in that order only:
    fine, then coarse, equals one full call.  Any other mask raises
    ValueError, on CPU and CUDA tensors alike.

    CUDA tensors run kernel "compact_offsets"; CPU tensors the plain
    version.  mask -1 and ~(W - 1) run the walk of csrc/compact.cuh (the
    body of `compact` and `compact_full`), which counts each lane's rows
    with o >= 0 and writes each at its counted rank, row - o under the
    precondition.  mask W - 1 runs compact.cuh's masked walk, which reads
    each destination and stages it in a window of W + 127 rows (at most
    576); a lane further behind stores directly, and `direct` (an
    int32 CUDA tensor [1], or None) adds the count of those stores.
    Either way every element is read once and written once, no memset.
    counted_as: the name the launch is counted under (the probes of
    ops/probes.py count their own)."""
    check_offsets_mask(mask)
    if not p.is_cuda:
        return compact_offsets_plain(p, o, mask)
    from ..runtime import kernels

    kernels.check_cuda_tensor("p", p, torch.int32, 2)
    kernels.check_cuda_tensor("o", o, torch.int16, 2)
    if p.shape != o.shape:
        raise ValueError("compact_offsets: p and o must have one shape")
    if direct is not None:
        kernels.check_cuda_tensor("direct", direct, torch.int32, 1)
    Np, L = p.shape
    if Np > INT16_SPAN:
        raise ValueError(
            f"compact_offsets: {Np} rows exceed the int16 offsets")
    p_out = torch.empty_like(p)
    o_out = torch.empty_like(o)
    if p_out.numel():
        kernels.launch(counted_as, p.device, p.data_ptr(), o.data_ptr(),
                       p_out.data_ptr(), o_out.data_ptr(), Np, L, mask,
                       None if direct is None else direct.data_ptr())
    return p_out, o_out


def compact_full_plain(ev: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `compact_full` (same contract)."""
    N, L = ev.shape
    valid = ev >= 0
    rank = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    lane = torch.arange(L, device=ev.device).expand(N, L)
    cp = torch.full_like(ev, -1)
    cp[rank[valid], lane[valid]] = ev[valid]
    return cp


def compact_full(ev: torch.Tensor) -> torch.Tensor:
    """events int32 [N, L] -> compacted payload int32 [N, L].

    The valid events (>= 0) of each lane, in row order, at rows 0..n-1;
    -1 on the rows after.  Contract of the JAX package's _compact_kernel
    (place_events_pallas), which writes 0 in the empty rows: here
    validity stays a sign, so the event that packs to 0 survives.  CUDA
    tensors run kernel "compact_full"; CPU tensors the plain version."""
    if not ev.is_cuda:
        return compact_full_plain(ev)
    from ..runtime import kernels

    kernels.check_cuda_tensor("ev", ev, torch.int32, 2)
    N, L = ev.shape
    cp = torch.empty_like(ev)
    if cp.numel():
        kernels.launch("compact_full", ev.device, ev.data_ptr(),
                       cp.data_ptr(), N, L)
    return cp


def spread_full_plain(cp: torch.Tensor, M: int,
                      o: torch.Tensor | None = None,
                      err_mal: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of `spread_full` (same contract)."""
    N, L = cp.shape
    e = cp.to(torch.int64)
    valid = (e >= 0) if o is None else (o >= 0)
    target = ((e >> 18) & 0x1FFF) * 64 + ((e >> 12) & 63)
    inside = valid & (target < M)
    if err_mal is not None:
        err_mal |= (valid & ~inside).any(dim=0)
    lane = torch.arange(L, device=cp.device).expand(N, L)
    out = torch.zeros((M, L), dtype=torch.int16, device=cp.device)
    out[target[inside], lane[inside]] = ((e & 0xFFF) - 2048)[inside] \
        .to(torch.int16)
    return out


def spread_full(cp: torch.Tensor, M: int, o: torch.Tensor | None = None,
                err_mal: torch.Tensor | None = None,
                counted_as: str = "spread_full") -> torch.Tensor:
    """compacted events int32 [N, L] -> dense int16 [M, L].

    Every valid row is unpacked (blk = (cp >> 18) & 0x1FFF, z = (cp >> 12)
    & 63, val = (cp & 0xFFF) - 2048) and stored at row 64 * blk + z of its
    lane; every other dense row is 0.  A row is valid when cp >= 0, or,
    when the caller passes the offsets `o` of `compact_to_rank`, when
    o >= 0 (its p is 0 on empty rows); never when cp > 0.  A valid event
    whose target is >= M is not stored; when `err_mal` (bool [L]) is
    given, its lane is latched in place.  M may be above or below N.
    Contract of the JAX package's _spread_kernel.  CUDA tensors run kernel
    "spread_full": the body of `place_events` (csrc/place.cuh: the dense
    output zeroed, then four lanes x four rows a thread, all loads before
    the first store), with validity from o when it is given (o read
    first, cp only on rows with a valid lane); any row count.  CPU
    tensors run the plain version.  counted_as: as in
    `compact_offsets`."""
    if not cp.is_cuda:
        return spread_full_plain(cp, M, o, err_mal)
    from ..runtime import kernels

    kernels.check_cuda_tensor("cp", cp, torch.int32, 2)
    N, L = cp.shape
    if o is not None:
        kernels.check_cuda_tensor("o", o, torch.int16, 2)
        if o.shape != cp.shape:
            raise ValueError("spread_full: o must have cp's shape")
    if err_mal is not None:
        kernels.check_cuda_tensor("err_mal", err_mal, torch.bool, 1)
        if err_mal.shape[0] != L:
            raise ValueError("spread_full: err_mal must be [L]")
    out = torch.empty((M, L), dtype=torch.int16, device=cp.device)
    kernels.launch(
        counted_as, cp.device, cp.data_ptr(),
        None if o is None else o.data_ptr(), out.data_ptr(),
        None if err_mal is None else err_mal.data_ptr(),
        N, M, L,
    )
    return out


def _check_int16(name: str, N: int, M: int) -> None:
    """Raise ValueError unless events [N, L] -> dense [M, L] fit the int16
    offsets of `place_events_ranked` and `place_events_full` (rank rows
    below N, spread rows below max(N, M)): the gate of the JAX package's
    kernels.  `place_events` has no such limit."""
    if N >= INT16_SPAN or M >= INT16_SPAN:
        raise ValueError(f"{name}: events [{N}, L] -> dense [{M}, L] pass "
                         f"the int16 offsets")


def place_events_ranked(ev: torch.Tensor, M: int,
                        err_mal: torch.Tensor | None = None) -> torch.Tensor:
    """events int32 [N, L] -> values int16 [M, L] through the column
    cumsum, `compact_offsets` and `spread_full` with offsets: the JAX
    package's classic route with its rank kernel off, equal to
    `place_events` on every input it takes."""
    _check_int16("place_events_ranked", ev.shape[0], M)
    p, o = compact_to_rank(ev, rank_kernel=False)
    return spread_full(p, M, o=o, err_mal=err_mal)


def place_events_full(ev: torch.Tensor, M: int,
                      err_mal: torch.Tensor | None = None) -> torch.Tensor:
    """events int32 [N, L] -> values int16 [M, L] through `compact_full`
    then `spread_full`: the contract of the JAX package's
    place_events_pallas, equal to `place_events` on every input it
    takes."""
    _check_int16("place_events_full", ev.shape[0], M)
    return spread_full(compact_full(ev), M, err_mal=err_mal)


def slot_unpack_plain(p: torch.Tensor, o: torch.Tensor, C: int, G: int):
    """Plain PyTorch version of `slot_unpack` (same contract)."""
    _log2(C)
    Np, L = p.shape
    dev = p.device
    live = torch.cumprod((o >= 0).to(torch.int32), dim=0).bool()
    grp = ((p >> 18) & 0x1FFF) >> _log2(G)
    row = torch.arange(Np, dtype=torch.int64, device=dev)[:, None]
    prev = torch.cat([torch.full((1, L), -1, dtype=grp.dtype, device=dev),
                      grp[:-1]])
    boundary = live & ((row == 0) | (grp != prev))
    start = torch.cummax(torch.where(boundary, row, -1), dim=0).values
    rib = row - start
    ovf = live & (rib >= C)
    o2 = torch.where(live & ~ovf, grp.to(torch.int64) * C + rib - row, -1)
    return o2.to(torch.int16), ovf.any(dim=0)


def slot_unpack(p: torch.Tensor, o: torch.Tensor, C: int, G: int):
    """Compacted rows (p int32, o int16) [Np, L] -> (o2 int16 [Np, L],
    overflow bool [L]).

    A lane's events are its rows before the first o < 0.  Each starts a
    new group when it is the lane's first or its group blk >> log2(G)
    differs from the row before; rank_in_group = row - group start.  A
    row with rank_in_group >= C overflows (o2 = -1, the lane's flag set);
    every other event gets o2 = group * C + rank_in_group - row, its
    offset to the slot row.  Empty rows get -1.  Contract of the JAX
    package's _slot_unpack_kernel, with validity from o >= 0.
    CUDA tensors run kernel "slot_unpack"; CPU tensors the plain one."""
    if not p.is_cuda:
        return slot_unpack_plain(p, o, C, G)
    from ..runtime import kernels

    kernels.check_cuda_tensor("p", p, torch.int32, 2)
    kernels.check_cuda_tensor("o", o, torch.int16, 2)
    if p.shape != o.shape:
        raise ValueError("slot_unpack: p and o must have one shape")
    _log2(C)
    Np, L = p.shape
    o2 = torch.empty((Np, L), dtype=torch.int16, device=p.device)
    ovf = torch.empty(L, dtype=torch.bool, device=p.device)
    kernels.launch("slot_unpack", p.device, p.data_ptr(), o.data_ptr(),
                   o2.data_ptr(), ovf.data_ptr(), Np, L, C, _log2(G))
    return o2, ovf


def slot_expand_plain(o2: torch.Tensor, p: torch.Tensor, M: int, C: int,
                      G: int) -> torch.Tensor:
    """Plain PyTorch version of `slot_expand` (same contract)."""
    Np, L = o2.shape
    dev = o2.device
    valid = o2 >= 0
    row = torch.arange(Np, dtype=torch.int64, device=dev)[:, None]
    slot = row + o2.to(torch.int64)
    e = p.to(torch.int64)
    target = (slot >> _log2(C)) * (64 * G) + ((e >> 18) & (G - 1)) * 64 \
        + ((e >> 12) & 63)
    keep = valid & (target < M)
    lane = torch.arange(L, device=dev).expand(Np, L)
    out = torch.zeros((M, L), dtype=torch.int16, device=dev)
    out[target[keep], lane[keep]] = ((e & 0xFFF) - 2048)[keep] \
        .to(torch.int16)
    return out


def slot_expand(o2: torch.Tensor, p: torch.Tensor, M: int, C: int,
                G: int) -> torch.Tensor:
    """(o2 int16, payload p int32) [Np, L] -> dense int16 [M, L].

    Every row with o2 >= 0 sits at slot row + o2 of group
    slot >> log2(C); its event goes to dense row group * 64G +
    64 * (blk mod G) + z of its lane (targets >= M are dropped); every
    other dense row is 0.  Contract of the JAX package's
    _fine_spread_expand_kernel with the coarse slot-spread stages before
    it.  CUDA tensors run kernel "slot_expand"; CPU tensors the plain
    version."""
    if not o2.is_cuda:
        return slot_expand_plain(o2, p, M, C, G)
    from ..runtime import kernels

    kernels.check_cuda_tensor("o2", o2, torch.int16, 2)
    kernels.check_cuda_tensor("p", p, torch.int32, 2)
    if p.shape != o2.shape:
        raise ValueError("slot_expand: o2 and p must have one shape")
    Np, L = o2.shape
    if Np > INT16_SPAN:
        raise ValueError(f"slot_expand: {Np} rows exceed the int16 offsets")
    out = torch.empty((M, L), dtype=torch.int16, device=o2.device)
    kernels.launch("slot_expand", o2.device, o2.data_ptr(), p.data_ptr(),
                   out.data_ptr(), Np, M, L, _log2(C), _log2(G))
    return out


def place_events_slots(ev: torch.Tensor, M: int, C: int | None = None,
                       G: int | None = None, stop_after: str | None = None):
    """events int32 [N, L] -> (dense int16 [M, L], overflow bool [L])
    through the slot route: compact, unpack, expand.

    Dense rows equal `place_events` on every lane whose overflow flag is
    clear.  stop_after="compact" returns (p, o); "unpack" returns
    (o2, p, overflow): the cuts of the JAX package's place_events_slots.
    """
    C = SLOT_C if C is None else C
    G = SLOT_G if G is None else G
    p, o = compact_to_rank(ev)
    if stop_after == "compact":
        return p, o
    o2, overflow = slot_unpack(p, o, C, G)
    if stop_after == "unpack":
        return o2, p, overflow
    return slot_expand(o2, p, M, C, G), overflow
