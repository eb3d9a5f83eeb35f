"""Batched decode engine on one CUDA device.

Counterpart of tpujpeg/runtime/batch.py:

  1. parse (host, io/parser.py), on the thread pool;
  2. chunking by geometry (`_chunk_key`; with size_buckets=True by
     size-class bucket and restart row count k, so images of different
     sizes share a chunk).  `decode` streams, as the JAX engine's does:
     a chunk is formed as soon as chunk_size images of one key have
     been parsed, in arrival order, and dispatched while later streams
     still parse.  `decode_parsed` sorts each key's images by stride
     (similar segment lengths share a chunk, so the scan's column count
     follows the longest segment of a tighter group);
  3. per chunk, backend 'fsm': when the chunk packs into lanes
     (fsm.build_plan: one lane per restart segment, and one lane per
     image for a stream without restart markers of at most 8191
     blocks), the lane plan (one stride group: build_plan(split=False))
     is uploaded and runtime.fused.decode_chunk_fused runs scan ->
     classic materialize (materialize.place_events) -> DC resolve ->
     pixels on the device.  Otherwise the chunk takes the speculative path: the single-pass
     sync decode through the slot
     materialize (backend 'fsm-spec-sync'), or after a resolve miss the
     Jacobi fixed point ('fsm-spec', counted in spec_sync_misses).  A chunk outside every
     device envelope raises JpegError, or under on_error='skip' goes to
     the host route.  Backend 'host': the native C++ entropy decoder on
     the host, then the pixel stage; 'oracle' the same with the numpy
     reference decoder; 'cpu' the whole decode in the native library on
     a pool of `workers` threads (no device is touched); 'auto' routes by
     a link probe (measured_link_mbps): the fsm route below
     _LINK_MBPS_FSM_THRESHOLD or without the native library, else host.
     Backend 'gather': the lockstep-lane segment decoder
     (ops/entropy.py, kernel csrc/segments.cu: one lane a restart
     segment, or an image without restart markers) on the device, then
     the pixel stage on its [B, n_blocks, 64] coefficients; the
     coefficients never leave the card.  A lane that fails raises
     JpegError at dispatch (one device read), as the JAX engine does, so
     under on_error='skip' the chunk goes to the host route;
  4. `_finish`: the retry ladder, behind one 4-flag device read per
     chunk.  A spec chunk whose slot materialize
     overflowed is decoded again with the classic materialize (counted
     in fsm_slot_retries; later chunks move to the next capacity); a
     chunk whose envelope latch is set is decoded again on the device at
     STEPS_SAFE (counted in fsm_k_retries, with the spec path's inline
     retries); a malformed latch, an envelope latch that survives the
     retry, or a retry that produced nothing sends the chunk to the host
     route (fsm_malformed_fallbacks / fsm_envelope_fallbacks), which
     raises or, with on_error='skip', records a precise error per image.
     Strict mode (the default) computes colour with the reference's exact
     math on the device (every route passes exact=True to the pixel
     stage), so nothing is repaired and BatchStats.repaired_pixels is 0;
     strict=False is the f32 colour of the JAX engine's strict=False.

A bucketed chunk (size_buckets=True) whose images carry row-aligned
restart intervals runs runtime.fused.decode_chunk_bucketed (backend
'fsm-bucketed': bucket-raster scan, materialize, static assemble, pixels
at the bucket's size); every other bucketed chunk takes the host-bucketed
route ('host-bucketed': host entropy, coefficients padded into the
bucket's MCU raster).  Both go through the same ladder in `_finish`,
which crops each image to its true height and width.

Every sampling the parser takes decodes on every route: 4:4:4 through
the fused pixel kernel, 4:2:0, 4:2:2, 4:4:0, 4:1:1 through the planes
kernel and grayscale through plain PyTorch (pipeline.device_decode_fn).
Chunks key on Geometry, so a batch that mixes samplings splits by
itself.  fancy=True selects
libjpeg's triangle chroma upsampling on every route (box replication
otherwise).

The prep pool (the JAX engine's, `_prepare_chunk_fsm`): where the
decoder routes to the device FSM or the gather decoder, a rolling window
(`_Window`) prepares
up to _PREP_AHEAD chunks ahead of the dispatch on a two-thread pool of
its own: the plan (`build_plan`, `build_plan_bucketed`, the speculative
`build_spec_plan_batch` for a chunk that does not pack, or the gather
route's `entropy.build_segment_plan`) and
every array the chunk's chain reads (the plan's, the quant tables, the
spec lane masks, the bucket extents), staged by `_Upload`: each pinned
and copied up on the decoder's copy stream, the compute stream ordered
after the copies by an event.  A plan's lane matrix goes up as the
chunk's scan bytes (one host copy, into a pooled page-locked block) and
its lane tables, and is packed on the card when the dispatch adopts the
chunk (fsm.pack_lanes, csrc/pack.cu).  Kernels launch only on the
dispatching thread, the speculative scans at dispatch; the K and slot
retries reuse the prepared plan.  A JpegError of a preparation
routes the chunk as the serial engine would; any other exception
reaches the caller.

decode_parsed(fetch=False) and decode(fetch=False) run every chunk
through the ladder and its one-read fence, synchronize the device and
return None: no RGB leaves the card.

Every stage of a call is a span (utils/profiling.span), on the thread
that runs it; BatchStats is made from the call's record:

  dispatching thread  decode (the root); parse_wait (a parse future);
                      dispatch (a chunk; attribute route) > prep_wait,
                      prepare, host_entropy > host_pad, upload, launch;
                      a speculative chunk's launch > spec_scan (the
                      cold and stitch scans' enqueue), spec_resolve
                      (the host's one read and its chain check), jacobi
                      (the fallback fixed point; attribute steps);
                      finish > fence, retry (kind steps_safe or slots),
                      host_fallback, sync; fetch and crop (a chunk)
  parse pool          parse (a stream); huffman (an image of a host
                      route chunk)
  prep pool           prep_queue (submit to start), then prepare
                      (attributes route, outcome ok or miss) > plan,
                      stage

parse_s, entropy_s and device_s are the sums of parse_wait, dispatch and
finish, total_s the root's; span_s holds every name's sum, route_chunks
the chunks by the route that returned them, prep_misses the
preparations thrown away, plane_kernel_chunks the chunks whose dispatch
launched the planes kernel (csrc/planes.cu: the subsampled pixel stage
on the card), spec_slot_chunks the speculative chunks dispatched with a
slot capacity, fetch_chunks the device chunks fetched to the host,
fetch_pinned_hits those of them whose page-locked host block came from
the caching host allocator's pool without growing it (`_fetch`),
lane_pack_chunks the chunks whose lane matrix was packed on their device
from its scan bytes (`_Upload.adopt`), bucket_chunks the chunks launched
on the bucket chain ('fsm-bucketed', counted once as each is adopted:
not on a retry, and not where it leaves for 'host-bucketed'),
bucket_images their images, bucket_blocks those images times their
bucket raster's blocks and bucket_real_blocks the images' own blocks
(the rest is the raster's padding), and spec_sync_misses and the retry
and fallback counters are the call's counters (utils/profiling.count).
A bucketed chunk's launch span carries the attributes bucket (its
raster's mcus_x, mcus_y) and images.

Several devices (mesh=, parallel/sharding.py): entropy decode and
staging run on the mesh's first device, and the pixel stage is sharded
over the mesh's batch axis (sharding.compiled_batch_decoder), each
shard's output left on its device until `_finish` fetches it.  On a mesh
of more than one device the routes change as in the JAX engine: a
restart chunk leaves the fused chain for the staged one (scan,
place_events, assemble, sharded pixels), a bucketed fsm chunk
takes the host-bucketed route, a speculative chunk runs the staged
single-pass decode (fsm.decode_speculative_sync, the classic
materialize) or the Jacobi path, then sharded pixels; the host, oracle
and gather routes shard their pixel stage.  B is padded to a multiple of
the batch axis (`_pad`).  mesh=None is a one-device mesh of `device`.
"""

from __future__ import annotations

import os
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..errors import JpegError
from ..io.parser import JpegImage, parse
from ..parallel import sharding
from ..pipeline import (Geometry, bucket_geometry, device_decode_fn,
                        pad_coeffs_to_bucket)
from ..utils import profiling
from ..utils.profiling import span
from . import kernels

# The link rate (MB/s) below which uploading a chunk's dense coefficients
# (the host route's int32 [B, n_blocks, 64]) costs more than uploading its
# scan bytes plus the fsm route's device entropy decode (scan, materialize,
# DC resolve): (coefficient bytes - scan bytes) / entropy ms.  Read by
# chip_smoke.py phase 6e on the 128-image restart chunk (rst640 x 8) on an
# NVIDIA H100 80GB HBM3 at 700.00 W: (629,145,600 - 26,255,360) bytes /
# 1.902 ms = 316,947.7 MB/s.  Every link reads far below it, so "auto"
# takes the fsm route wherever a card is attached by PCIe.
_LINK_MBPS_FSM_THRESHOLD = 316_947.7

# How many chunks may be prepared (plan built, its arrays staged on the
# device) ahead of the dispatch loop, as in the JAX engine: enough to keep
# the two prep threads busy without holding every chunk's lane matrix.
_PREP_AHEAD = 3

_link_mbps_cache: dict = {}


def measured_link_mbps(device="cuda") -> float:
    """Host -> device bandwidth probe (MB/s), cached per device.

    Two buffers (64 KiB and 4 MiB) go up and 8 bytes of each come back;
    the rate is taken from the difference of the two times, so the fixed
    cost of a copy does not count as bandwidth.  Each size goes up once
    untimed first: the first copy of a size also pays the caching
    allocator's device allocation (on an H100 that read 1,262 MB/s for
    a link that uploads a chunk's scan bytes at ~5,700).  Where the two
    times cannot be told apart, the big buffer's own rate (a lower
    bound)."""
    key = str(device)
    if key not in _link_mbps_cache:
        dev = torch.device(device)
        small = np.zeros(1 << 16, np.uint8)
        big = np.zeros(4 << 20, np.uint8)

        def roundtrip(buf):
            t0 = time.perf_counter()
            torch.from_numpy(buf).to(dev)[-8:].cpu()
            return time.perf_counter() - t0

        roundtrip(small)
        roundtrip(big)
        t_small = min(roundtrip(small) for _ in range(3))
        t_big = min(roundtrip(big) for _ in range(3))
        if t_big > t_small * 1.05:
            rate = (big.nbytes - small.nbytes) / (t_big - t_small) / 1e6
        else:
            rate = big.nbytes / t_big / 1e6
        _link_mbps_cache[key] = rate
    return _link_mbps_cache[key]


@dataclass
class BatchStats:
    """Counters and wall-clock seconds of the last decode() call, from
    its spans and counters (module docstring)."""

    n_images: int = 0
    compressed_bytes: int = 0
    pixels: int = 0
    parse_s: float = 0.0
    entropy_s: float = 0.0
    device_s: float = 0.0
    total_s: float = 0.0
    backend: str = ""
    chunks: int = 0
    repaired_pixels: int = 0          # 0: strict colour is exact on device
    failures: dict = field(default_factory=dict)  # index -> error message
    fsm_envelope_fallbacks: int = 0   # chunks redone on host: outside envelope
    fsm_k_retries: int = 0            # chunks re-decoded at STEPS_SAFE
    fsm_malformed_fallbacks: int = 0  # chunks redone on host: bad stream
    spec_sync_misses: int = 0         # spec chunks that fell back to Jacobi
    fsm_slot_retries: int = 0         # chunks re-decoded with slots=False
    span_s: dict = field(default_factory=dict)   # span name -> seconds
    route_chunks: dict = field(default_factory=dict)  # route -> chunks
    prep_misses: int = 0              # preparations thrown away
    plane_kernel_chunks: int = 0      # chunks whose pixel stage launched
    #                                   the planes kernel at dispatch
    spec_slot_chunks: int = 0         # spec chunks dispatched with a slot
    #                                   capacity (slot materialize)
    fetch_chunks: int = 0             # device chunks fetched to the host
    fetch_pinned_hits: int = 0        # of them, page-locked blocks served
    #                                   from the host allocator's pool
    lane_pack_chunks: int = 0         # chunks whose lane matrix was packed
    #                                   on their device (csrc/pack.cu)
    bucket_chunks: int = 0            # chunks launched on the bucket chain
    bucket_images: int = 0            # their images
    bucket_blocks: int = 0            # their images x the bucket's blocks
    bucket_real_blocks: int = 0       # their images' own blocks
    spans: list = field(default_factory=list)  # logged while profiled

    def as_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class _Chunk:
    geom: Geometry
    indices: list[int]
    imgs: list[JpegImage]
    plan_future: object = None         # the prep pool's _Prepared
    plan: object = None                # FsmPlan / FsmBucketPlan (retries)
    uploaded: object = None            # plan's arrays on the device
    spec_plan: object = None           # fsm.SpecBatchPlan of the sync path
    spec_dev: object = None            # its (xs, chunk_bits, inherit, body)
    quant: object = None               # int32 [B, n_comp, 64] on the device
    extents: object = None             # bucketed: int32 [B, 2] on the device
    staged: object = None              # _Upload: held until the fence read
    steps: object = None               # FSM steps spec of the last decode
    spec_k_retries: int = 0            # inline STEPS_SAFE retries (spec)
    slot_c: int = 0                    # slot capacity of its spec decode
    #                                    (0: classic materialize)
    slots_off: bool = False            # slot overflow: classic from now on
    err_mal: object = None
    err_env: object = None
    err_slot: object = None
    out: object = None                 # device (rgb, riskbits or None)
    rgb_host: list | None = None       # cpu backend: uint8 [H, W, 3] each
    backend: str = ""
    failed: dict | None = None         # local index -> message (skip mode)
    bucketed: bool = False             # geom is a size-class bucket: crop
    #                                    each output to its image's size
    id: int = -1                       # its place in the call's chunks


def _stride_key(img: JpegImage) -> int:
    """Longest restart-segment byte length (what sets the FSM scan stride)."""
    offs = img.segment_offsets
    if offs.size <= 1:
        return int(img.scan_data.size)
    ends = np.append(offs[1:], img.scan_data.size)
    return int((ends - offs).max())


def _parse_stream(data: bytes, isolate: bool):
    """One stream's parse on the pool; under isolate a JpegError comes
    back as its message."""
    with span("parse"):
        try:
            return parse(data)
        except JpegError as e:
            if not isolate:
                raise
            return str(e)


def _pack_fence(rgb, err_mal, err_env, err_slot=None) -> torch.Tensor:
    """A chunk's completion fence: one real output element and the three
    error bits, int32 [4], read in one transfer."""
    flags = [rgb[..., :1, :1, :1].sum().to(torch.int32)]
    for e in (err_mal, err_env, err_slot):
        flags.append(torch.zeros((), dtype=torch.int32, device=rgb.device)
                     if e is None else e.any().to(torch.int32))
    return torch.stack(flags)


def _fetch(rgb, n: int) -> np.ndarray:
    """A chunk's first n images as uint8 [n, H, W, 3] on the host.

    Device rgb is planar [B, 3, H, W], one tensor or a list of batch
    shards (a mesh); each shard is interleaved on its device and copied
    into its rows of one host block.  From a card that block is
    page-locked, drawn from PyTorch's caching host allocator: a block
    returns to its pool only when the last tensor or array viewing it
    is freed, so a block the caller still holds is never handed out
    again, and a pooled block needs neither a cudaHostAlloc nor first-
    touch page faults.  Counted: `fetch_chunks`, and `fetch_pinned_hits`
    where the allocator served the block without growing its pool (a
    pool that another thread grows meanwhile reads as a miss)."""
    shards = rgb if isinstance(rgb, list) else [rgb]
    per, _, H, W = shards[0].shape
    profiling.count("fetch_chunks")
    cards = {s.device for s in shards if s.is_cuda}
    if cards:
        grown = torch.cuda.host_memory_stats()["num_host_alloc"]
        out = torch.empty((n, H, W, 3), dtype=torch.uint8, pin_memory=True)
        if torch.cuda.host_memory_stats()["num_host_alloc"] == grown:
            profiling.count("fetch_pinned_hits")
    else:
        out = torch.empty((n, H, W, 3), dtype=torch.uint8)
    for i, shard in enumerate(shards):
        lo, hi = i * per, min((i + 1) * per, n)
        if hi > lo:
            # from a card, copy_ interleaves on the device, then one D2H
            out[lo:hi].copy_(shard[: hi - lo].permute(0, 2, 3, 1),
                             non_blocking=True)
    for d in cards:
        torch.cuda.current_stream(d).synchronize()
    return out.numpy()


class _Upload:
    """One prepared chunk's arrays on their way to the device.

    On a card each array is pinned (PyTorch's caching host allocator: a
    block is handed out again only once the copies recorded on it are
    done, so only a new size pays a cudaHostAlloc; a tensor already
    page-locked goes as it is) and copied up non-blocking on the
    decoder's copy stream, so a prepare on a pool thread neither blocks
    on the copy nor queues behind the kernels of the chunk before it;
    `done` records the event after the copies.  A lane matrix (`lanes`)
    goes up as the chunk's scan bytes with its lane tables, and is packed
    on the device by `adopt`.  `adopt`, on the dispatching thread, makes
    the current (compute) stream wait for that event before the chunk's
    first kernel, packs each lane matrix there (fsm.pack_lanes: on a card
    csrc/pack.cu; counted in lane_pack_chunks) and records each tensor on
    the stream for the caching allocator.  On the CPU the arrays are
    wrapped as tensors: no stream, no copy."""

    def __init__(self, device: torch.device, stream):
        self.device = device
        self.stream = stream
        self.pinned: list = []       # the page-locked sources
        self.tensors: list = []      # their device copies
        self.packs: list = []        # (xs, src, lane_off, lane_len)
        self.event = None            # torch.cuda.Event after the copies

    def __call__(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(a))
        if self.stream is None:
            return t
        src = t if t.is_pinned() else t.pin_memory()
        with torch.cuda.stream(self.stream):
            t = src.to(self.device, non_blocking=True)
        self.pinned.append(src)
        self.tensors.append(t)
        return t

    def lanes(self, lanes) -> torch.Tensor:
        """A lane matrix (fsm.ScanLanes) for the device: its scan bytes
        and lane tables staged, its uint8 [L, stride] tensor allocated
        and returned, written by `adopt`'s pack.  On a card the bytes are
        copied once on the host, into a pooled page-locked block."""
        if self.stream is None:
            src = torch.from_numpy(lanes.source())
        else:
            src = torch.empty(max(int(lanes.base[-1]), 1),
                              dtype=torch.uint8, pin_memory=True)
            host = src.numpy()
            for scan, b in zip(lanes.scans, lanes.base.tolist()):
                host[b : b + scan.size] = scan
        staged = (self(src), self(lanes.lane_off), self(lanes.lane_len))
        with torch.cuda.stream(self.stream):   # None: no stream, no-op
            xs = torch.empty(lanes.shape, dtype=torch.uint8,
                             device=self.device)
        if self.stream is not None:
            self.tensors.append(xs)
        self.packs.append((xs, *staged))
        return xs

    def done(self) -> "_Upload":
        if self.stream is not None:
            self.event = torch.cuda.Event()
            self.event.record(self.stream)
        return self

    def adopt(self) -> None:
        from ..ops import fsm

        if self.event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(compute)
        for xs, src, lane_off, lane_len in self.packs:
            fsm.pack_lanes(src, lane_off, lane_len, *xs.shape, out=xs)
        if self.packs:
            profiling.count("lane_pack_chunks")


@dataclass
class _Prepared:
    """What `_prepare_chunk` hands the dispatch: the route ("plan",
    "bucket", "spec" or "gather"), its plan and its arrays on the device.
    `arrays` is what the chain reads: for "plan" each stride group's (xs,
    seg_n_blocks) and perm, for "bucket" xs, seg_n, wrap_at and skip, for
    "spec" xs and fsm.spec_lane_arrays, for "gather"
    entropy.plan_arrays."""

    kind: str
    plan: object
    arrays: tuple
    quant: torch.Tensor              # int32 [B, n_comp, 64]
    upload: _Upload
    extents: torch.Tensor | None = None    # "bucket": int32 [B, 2]


class _Window:
    """The dispatch loop's rolling window (the JAX engine's `drain`).

    Chunks wait in `pending` in dispatch order.  Where the decoder routes
    to the device FSM or the gather decoder, the first _PREP_AHEAD of them
    are prepared on its prep pool (`_prepare_chunk`), so at most
    _PREP_AHEAD prepared
    chunks wait undispatched; `drain(block=False)` dispatches chunks
    while the first one's preparation is done, `drain(block=True)` all of
    them, each waiting for its own."""

    def __init__(self, dec: "BatchDecoder", isolate: bool):
        self.dec = dec
        self.isolate = isolate
        self.prep = dec.backend == "gather" or dec._prefers_fsm()
        if self.prep:
            # the copy stream, on this thread before any prepare reads it
            dec._upload()
        self.pending: list[_Chunk] = []

    def drain(self, block: bool) -> None:
        dec = self.dec
        while self.pending:
            if self.prep:
                for c in self.pending[:_PREP_AHEAD]:
                    if c.plan_future is None:
                        c.plan_future = dec.prep_pool.submit(
                            profiling.bind(dec._prepare_chunk,
                                           queue="prep_queue", chunk=c.id),
                            c)
            c = self.pending[0]
            if (not block and c.plan_future is not None
                    and not c.plan_future.done()):
                break
            self.pending.pop(0)
            dec._dispatch_chunk(c, self.isolate)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two device names can mean one device ("cuda" is cuda:i for
    every i)."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class BatchDecoder:
    """Reusable batched decoder on one explicit device or a mesh."""

    def __init__(self, backend: str = "fsm", workers: int | None = None,
                 chunk_size: int = 32, strict: bool = True, device="cuda",
                 size_buckets: bool = False, fancy: bool = False,
                 mesh: sharding.Mesh | None = None):
        """backend: "fsm" (the default: the card), "gather", "host",
        "oracle", "cpu" or "auto" (module docstring).  device: where
        entropy decode, staging and (without a mesh) the pixel stage run.
        mesh (parallel/sharding.make_mesh): the pixel stage sharded over
        its batch axis; `device` is then the mesh's first device, and a
        `device` other than the default "cuda" that names another
        raises.
        mesh=None is a one-device mesh of `device` (JAX's default takes
        every device: mesh=make_mesh() does that).  Backend "cpu" takes
        no mesh (one given is not used).  workers: the thread
        pool's size; backend "cpu" defaults to one single-threaded decode per
        core.  fancy=True upsamples subsampled chroma with libjpeg's
        triangle filter on every route (box replication otherwise; no
        effect on 4:4:4 and grayscale).  size_buckets=True decodes corpora
        of mixed sizes: images group by size-class bucket
        (pipeline.bucket_geometry) instead of exact geometry, every chunk
        has the bucket's shapes, and outputs are cropped to each image's
        true size on the host."""
        if backend not in ("auto", "host", "fsm", "gather", "oracle", "cpu"):
            raise ValueError(f"unknown backend {backend!r}")
        if size_buckets and backend not in ("auto", "host", "oracle", "fsm"):
            raise ValueError(
                "size_buckets requires backend auto/host/oracle/fsm")
        self.backend = backend
        self.size_buckets = size_buckets
        self.fancy = fancy
        self.chunk_size = chunk_size
        self.strict = strict
        if mesh is None:
            self.device = torch.device(device)
            mesh = sharding.make_mesh(1, devices=[self.device])
        else:
            self.device = mesh.devices.flat[0]
            if device != "cuda" and not _same_device(torch.device(device),
                                                     self.device):
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {self.device}")
        self.mesh = None if backend == "cpu" else mesh
        # more than one device: the JAX engine's routes for a mesh
        self._multi = self.mesh is not None and self.mesh.devices.size > 1
        if workers is None and backend == "cpu":
            # one single-threaded native decode per core
            workers = os.cpu_count() or 4
        self.pool = ThreadPoolExecutor(max_workers=workers)
        # chunk preparation (plan, pinned upload) on its own two threads:
        # on the parse pool it would queue behind every pending parse
        self.prep_pool = ThreadPoolExecutor(max_workers=2)
        self._copy_stream = None
        self.stats = BatchStats()
        # slot capacity for every later chunk: None until sampled, then
        # an int C (0 = classic materialize)
        self._slot_c: int | None = None

    def close(self) -> None:
        self.pool.shutdown()
        self.prep_pool.shutdown()

    def _upload(self) -> _Upload:
        """A chunk's upload on the decoder's copy stream, which is made on
        first use (backends that prepare nothing touch no stream)."""
        if self._copy_stream is None and self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
        return _Upload(self.device, self._copy_stream)

    # -- chunking -----------------------------------------------------------

    def _chunk_key(self, img: JpegImage) -> tuple:
        """Chunk grouping key; element [0] is the chunk's Geometry.

        size_buckets groups by size-class bucket; on the fsm backend the
        key also carries the restart row count k (or None), so each chunk
        is uniform for the bucket-raster lane plan."""
        geom = Geometry.of(img)
        if not self.size_buckets:
            return (geom,)
        bucket = bucket_geometry(geom)
        if self._prefers_fsm():
            from ..ops.fsm import bucket_lane_k

            return (bucket, bucket_lane_k(img))
        return (bucket,)

    def _make_chunks(self, imgs: list[JpegImage]) -> list[_Chunk]:
        buckets: dict[tuple, list[int]] = {}
        for i, img in enumerate(imgs):
            buckets.setdefault(self._chunk_key(img), []).append(i)
        chunks = []
        for (geom, *_), idxs in buckets.items():
            idxs = sorted(idxs, key=lambda i: _stride_key(imgs[i]))
            for j in range(0, len(idxs), self.chunk_size):
                part = idxs[j : j + self.chunk_size]
                chunks.append(_Chunk(geom, part, [imgs[i] for i in part],
                                     bucketed=self.size_buckets,
                                     id=len(chunks)))
        return chunks

    def _pad(self, n: int) -> int:
        """A chunk's batch of n images padded to a multiple of the mesh's
        batch axis (the JAX engine's _pad_batch pads chunk_size; the
        port pads the images the chunk has).  n on one device."""
        nb = 1 if self.mesh is None else self.mesh.shape["batch"]
        return -(-n // nb) * nb

    def _pixels(self, geom: Geometry, coeffs: torch.Tensor,
                quant: torch.Tensor, extents: torch.Tensor | None = None):
        """The pixel stage of a chunk of B = `_pad` images: on one device
        device_decode_fn on tensors already on self.device (rgb one
        tensor), on a mesh of several sharded over its batch axis (rgb a
        list of shards, each on its device).  On a mesh, host tensors go
        to each shard's device directly."""
        if not self._multi:
            return device_decode_fn(geom, coeffs, quant, fancy=self.fancy,
                                    exact=self.strict, extents=extents)
        fn = sharding.compiled_batch_decoder(
            geom, self.mesh, self.fancy, bucketed=extents is not None,
            exact=self.strict)
        rgb, risk, _ = fn(coeffs, quant, extents)
        return rgb, risk

    def _quant_host(self, chunk: _Chunk) -> np.ndarray:
        """int32 [B, n_comp, 64] quant tables, B = `_pad` of the chunk's
        images; padding rows are zero."""
        quant = np.zeros((self._pad(len(chunk.imgs)), len(chunk.geom.comps),
                          64), np.int32)
        quant[: len(chunk.imgs)] = [
            [img.quant_tables[comp.quant_id] for comp in img.components]
            for img in chunk.imgs]
        return quant

    # -- preparation (the prep pool) ----------------------------------------

    def _prepare_plan(self, chunk: _Chunk) -> _Prepared:
        """A restart chunk: the lane plan in one stride group and its
        arrays staged.  Raises JpegError when the chunk does not pack."""
        from ..ops import fsm

        with span("plan"):
            plan = fsm.build_plan(chunk.imgs, split=False)
        with span("stage"):
            up = self._upload()
            arrays = (tuple((up.lanes(lanes), up(sn))
                            for lanes, sn in plan.lanes),
                      up(plan.perm))
            quant = up(self._quant_host(chunk))
            return _Prepared("plan", plan, arrays, quant, up.done())

    def _prepare_bucket(self, chunk: _Chunk) -> _Prepared:
        """A bucketed chunk: the bucket-raster plan, its four arrays, the
        quant tables and the extents staged.  Raises JpegError outside the
        bucket-FSM envelope (the chunk takes the host-bucketed route)."""
        from ..ops import fsm
        from .fused import bucket_extents

        with span("plan"):
            plan = fsm.build_plan_bucketed(chunk.imgs, chunk.geom)
        with span("stage"):
            up = self._upload()
            arrays = (up.lanes(plan.lanes),
                      *map(up, (plan.seg_n, plan.wrap_at, plan.skip)))
            quant = up(self._quant_host(chunk))
            extents = up(bucket_extents(plan, len(chunk.imgs)))
            return _Prepared("bucket", plan, arrays, quant, up.done(),
                             extents)

    def _prepare_spec(self, chunk: _Chunk) -> _Prepared:
        """A chunk that does not pack: the speculative plan and what
        fsm.spec_sync_start reads, staged.  Its scans launch at dispatch,
        on the dispatching thread.  Raises JpegError for a chunk of mixed
        block counts or tables."""
        from ..ops import fsm

        if len({(im.n_mcus, im.blocks_per_mcu) for im in chunk.imgs}) != 1:
            raise JpegError("fsm-spec: chunk mixes block counts")
        with span("plan"):
            plan = fsm.build_spec_plan_batch(chunk.imgs, 1024)
        with span("stage"):
            up = self._upload()
            arrays = (up.lanes(plan.lanes),
                      *map(up, fsm.spec_lane_arrays(plan)))
            quant = up(self._quant_host(chunk))
            return _Prepared("spec", plan, arrays, quant, up.done())

    def _prepare_gather(self, chunk: _Chunk) -> _Prepared:
        """A gather chunk: the segment plan and its arrays staged (the
        tables go up once per table set, at dispatch: entropy.device_luts).
        Raises JpegError for a chunk the plan cannot take."""
        from ..ops import entropy

        with span("plan"):
            plan = entropy.build_segment_plan(chunk.imgs)
        with span("stage"):
            up = self._upload()
            arrays = tuple(map(up, entropy.plan_arrays(plan)))
            quant = up(self._quant_host(chunk))
            return _Prepared("gather", plan, arrays, quant, up.done())

    def _prepare_chunk(self, chunk: _Chunk):
        """The prep pool's task: the gather route's preparation on backend
        "gather", else the device FSM's.  Returns the _Prepared or the
        JpegError of a chunk outside the route, counted in prep_misses
        (the span keeps its route and outcome, never the error)."""
        with span("prepare") as sp:
            if self.backend == "gather":
                try:
                    res = self._prepare_gather(chunk)
                except JpegError as e:
                    res = e
            else:
                res = self._prepare_chunk_fsm(chunk)
            if isinstance(res, JpegError):
                profiling.count("prep_misses")
                sp.set(route="gather" if self.backend == "gather" else
                       "bucket" if chunk.bucketed else "spec",
                       outcome="miss")
            else:
                sp.set(route=res.kind, outcome="ok")
            return res

    def _prepare_chunk_fsm(self, chunk: _Chunk):
        """Build a chunk's plan and stage its arrays (on the prep pool, or
        on the dispatching thread for a chunk nobody prepared), routed as
        the JAX engine routes: a bucketed chunk's bucket plan, a restart
        chunk's lane plan, else the speculative preparation.  Returns the
        _Prepared, or the JpegError of a chunk outside them; any other
        exception propagates through the future to the caller."""
        try:
            if chunk.bucketed:
                if self._multi:
                    raise JpegError("fsm-bucketed: the fused bucket chain "
                                    "runs on one device")
                return self._prepare_bucket(chunk)
            try:
                return self._prepare_plan(chunk)
            except JpegError:
                return self._prepare_spec(chunk)
        except JpegError as e:
            return e

    def _take_prepared(self, chunk: _Chunk):
        """Adopt the chunk's preparation on the dispatching thread: the
        pool's result (or one made here), its copy ordered before the
        chunk's first kernel.  Returns the route or the JpegError."""
        if chunk.plan_future is not None:
            with span("prep_wait"):
                res = chunk.plan_future.result()
            chunk.plan_future = None
        else:
            res = self._prepare_chunk(chunk)
        if isinstance(res, JpegError):
            return res
        self._adopt(chunk, res)
        return res.kind

    def _adopt(self, chunk: _Chunk, prep: _Prepared) -> None:
        prep.upload.adopt()
        chunk.staged = prep.upload
        chunk.quant, chunk.extents = prep.quant, prep.extents
        if prep.kind == "spec":
            chunk.spec_plan, chunk.spec_dev = prep.plan, prep.arrays
        else:
            chunk.plan, chunk.uploaded = prep.plan, prep.arrays

    # -- chunk routes -------------------------------------------------------

    def _process_chunk_host(self, chunk: _Chunk, isolate: bool = False):
        """Native host entropy (the numpy oracle's on backend "oracle") ->
        coefficient upload -> pixel stage.

        isolate=True decodes failing images one by one: a bad one yields
        zero coefficients and lands in chunk.failed instead of raising.

        A bucketed chunk (the host-bucketed route) decodes each image into
        its real MCU layout and pads it into the bucket's MCU raster on
        the host (pipeline.pad_coeffs_to_bucket); the pixel stage runs at
        the bucket's size with each image's true MCU extents (the fancy
        upsampler's edges) and `_finish` crops."""
        from . import host

        geom = chunk.geom
        B = self._pad(len(chunk.imgs))
        oracle = self.backend == "oracle"
        if oracle:
            from ..oracle.decoder import entropy_decode
        else:
            def entropy_decode(img):
                return host.entropy_decode(img, threads=1)

        def one(img):
            with span("huffman"):
                try:
                    return entropy_decode(img)
                except JpegError as e:
                    if not isolate:
                        raise
                    return e

        with span("host_entropy"):
            coeffs = np.zeros((B, geom.n_blocks, 64), np.int32)
            for bi, res in enumerate(self.pool.map(profiling.bind(one),
                                                   chunk.imgs)):
                if isinstance(res, JpegError):
                    if chunk.failed is None:
                        chunk.failed = {}
                    chunk.failed[bi] = str(res)
                    continue
                with span("host_pad"):
                    if chunk.bucketed:
                        pad_coeffs_to_bucket(Geometry.of(chunk.imgs[bi]),
                                             geom, res, coeffs[bi])
                    else:
                        coeffs[bi] = res
        extents = None
        if chunk.bucketed:
            # padding images take the bucket's extents, as in the JAX engine
            ext = np.tile(np.asarray([geom.mcus_y, geom.mcus_x], np.int32),
                          (B, 1))
            ext[: len(chunk.imgs)] = [(im.mcus_y, im.mcus_x)
                                      for im in chunk.imgs]
            extents = torch.as_tensor(ext)
        coeffs = torch.as_tensor(coeffs)
        quant = torch.as_tensor(self._quant_host(chunk))
        if not self._multi:
            # a mesh's pixel stage sends each shard's rows to its device
            with span("upload"):
                coeffs, quant = coeffs.to(self.device), quant.to(self.device)
                if extents is not None:
                    extents = extents.to(self.device)
        with span("launch"):
            chunk.out = self._pixels(geom, coeffs, quant, extents)
        chunk.err_mal = chunk.err_env = chunk.err_slot = None
        chunk.backend = ("oracle" if oracle else "host") \
            + ("-bucketed" if chunk.bucketed else "")

    def _process_chunk_gather(self, chunk: _Chunk) -> None:
        """The lockstep-lane segment decoder (ops/entropy.py) as a backend,
        the JAX engine's `_process_chunk_gather`: the chunk's segment plan
        (prepared on the prep pool) decodes on the device into int32 [B,
        n_blocks, 64] with DC resolved, then the pixel stage runs on it as
        on the host route.  Raises JpegError when a lane fails (one device
        read): the caller raises it, or under on_error='skip' sends the
        chunk to the host route."""
        from ..ops import entropy

        if chunk.plan is None:
            res = self._take_prepared(chunk)
            if isinstance(res, JpegError):
                raise res
        geom = chunk.geom
        n = len(chunk.imgs)
        with span("launch"):
            coeffs, err = entropy.decode_plan(chunk.plan, self.device,
                                              uploaded=chunk.uploaded)
            entropy.check_lanes(err)
            coeffs = coeffs.reshape(n, geom.n_blocks, 64)
            B = self._pad(n)
            if B > n:
                coeffs = torch.nn.functional.pad(coeffs,
                                                 (0, 0, 0, 0, 0, B - n))
            chunk.out = self._pixels(geom, coeffs, chunk.quant)
        chunk.err_mal = chunk.err_env = chunk.err_slot = None
        chunk.backend = "gather"

    def _process_chunk_cpu(self, chunk: _Chunk, isolate: bool) -> None:
        """The whole decode per image in the native library (entropy and
        pixels; host.decode_cpu), one single-threaded decode per pool
        thread (the whole team for a one-image chunk).  No device is
        touched: no tensor, no kernel, no torch.cuda call."""
        from . import host

        nt = 1 if len(chunk.imgs) > 1 else 0

        def one(img):
            try:
                return host.decode_cpu(img, fancy=self.fancy, threads=nt)
            except JpegError as e:
                if not isolate:
                    raise
                return e

        chunk.rgb_host = list(self.pool.map(one, chunk.imgs))
        for bi, res in enumerate(chunk.rgb_host):
            if isinstance(res, JpegError):
                if chunk.failed is None:
                    chunk.failed = {}
                chunk.failed[bi] = str(res)
                chunk.rgb_host[bi] = None
        chunk.backend = "cpu"

    def _slot_capacity(self, chunk: _Chunk):
        """The materialize route for a speculative chunk: False (classic)
        for a chunk that overflowed once, else the decoder's slot capacity
        C (False when it is 0).  Chunks packed one lane per segment or
        image always take the classic route, which measured faster than
        the slot route on them on the H100 (PERF.md).

        C comes from a host sample of the first chunk's first image
        (materialize.suggest_slot_c over the native decoder's
        coefficients, DC counted always); without the native decoder it
        is the default materialize.SLOT_C.  A slot overflow moves it up
        one step for the chunks dispatched after it (_finish)."""
        from ..ops import materialize

        if chunk.slots_off:
            return False
        if self._slot_c is None:
            from . import host

            self._slot_c = materialize.SLOT_C
            if host._load_native() is not None:
                try:
                    coeffs = host.entropy_decode(chunk.imgs[0])
                except JpegError:
                    pass  # a bad stream says nothing about the load
                else:
                    self._slot_c = materialize.suggest_slot_c(
                        materialize.events_per_block(coeffs)
                    )
        return self._slot_c or False

    def _bump_slot_capacity(self) -> None:
        """After an overflow: the next capacity up, or classic past 256."""
        if self._slot_c:
            self._slot_c = self._slot_c * 2 if self._slot_c < 256 else 0

    def _process_chunk_fsm(self, chunk: _Chunk, steps=None) -> bool:
        """Pack the chunk into lanes and run the fused device chain
        (runtime/fused.py), or the staged chain on a mesh of several
        devices; a chunk that does not pack (fsm.build_plan raises
        JpegError) takes the speculative path.  Returns False when the
        chunk is outside every device envelope."""
        from ..ops import fsm
        from . import fused

        if chunk.bucketed:
            return self._process_chunk_fsm_bucketed(chunk, steps)
        if chunk.plan is None and (chunk.spec_plan is not None
                                   or self._take_prepared(chunk) != "plan"):
            # prepared for the speculative path, or not at all
            return self._process_chunk_spec(chunk, steps)
        chunk.steps = fsm.STEPS_PRODUCTION if steps is None else steps
        B = self._pad(len(chunk.imgs))
        quant = chunk.quant
        groups, _ = chunk.uploaded
        with span("launch"):
            if not self._multi:
                rgb, risk, _, _, err_mal, err_env, err_slot = (
                    fused.decode_chunk_fused(
                        chunk.plan, quant, chunk.geom, B, steps=chunk.steps,
                        want_coeffs=False, uploaded=groups[0], slots=False,
                        fancy=self.fancy, exact=self.strict,
                    )
                )
            else:
                # the staged chain of a mesh of several devices: the scan,
                # rows assembled per image, then the sharded pixel stage
                per_lane, (err_mal, err_env) = fsm.decode_plan(
                    chunk.plan, uploaded=chunk.uploaded, steps=chunk.steps)
                coeffs = fsm.assemble_batched(
                    per_lane, layout=chunk.plan.layout, pad_to=B)
                rgb, risk = self._pixels(chunk.geom, coeffs, quant)
                err_slot = None
        chunk.out = (rgb, risk)
        chunk.err_mal = err_mal
        chunk.err_env = err_env
        chunk.err_slot = err_slot
        chunk.backend = "fsm"
        return True

    def _process_chunk_fsm_bucketed(self, chunk: _Chunk, steps=None) -> bool:
        """Device decode of a size-class bucket chunk (mixed exact
        geometries): scan bytes up, bucket-raster scan, materialize,
        static assemble, pixels at the bucket's size
        (fused.decode_chunk_bucketed).  Returns False when the chunk is
        outside the bucket-FSM envelope (no or unaligned restarts, exotic
        tables), and the caller takes the host-bucketed route.  A kernel that fails to
        build or launch raises; it is never turned into a fallback."""
        from ..ops import fsm
        from . import fused

        B = len(chunk.imgs)
        if chunk.plan is None:
            if self._take_prepared(chunk) != "bucket":
                return False
            # counted once a chunk, as it is adopted: never on its retry
            profiling.count("bucket_chunks")
            profiling.count("bucket_images", B)
            profiling.count("bucket_blocks", B * chunk.geom.n_blocks)
            profiling.count("bucket_real_blocks", sum(
                im.n_mcus * im.blocks_per_mcu for im in chunk.imgs))
        chunk.steps = fsm.STEPS_PRODUCTION if steps is None else steps
        with span("launch", bucket=(chunk.geom.mcus_x, chunk.geom.mcus_y),
                  images=B):
            rgb, risk, _, _, err_mal, err_env, err_slot = (
                fused.decode_chunk_bucketed(
                    chunk.plan, chunk.quant, chunk.geom, B,
                    steps=chunk.steps, want_coeffs=False,
                    uploaded=chunk.uploaded, slots=False,
                    fancy=self.fancy, exact=self.strict,
                    extents=chunk.extents,
                )
            )
        chunk.out = (rgb, risk)
        chunk.err_mal = err_mal
        chunk.err_env = err_env
        chunk.err_slot = err_slot
        chunk.backend = "fsm-bucketed"
        return True

    def _process_chunk_spec(self, chunk: _Chunk, steps=None) -> bool:
        """Speculative device decode of a chunk of streams without restart
        markers that do not fit one lane per image.

        The single-pass sync path first (fused.decode_spec_sync_fused,
        backend 'fsm-spec-sync'); on a resolve miss the Jacobi fixed point
        (fsm.decode_speculative_batch, backend 'fsm-spec', counted in
        spec_sync_misses).  Streams denser than the production step budget
        retry on the device at STEPS_SAFE (counted in spec_k_retries).
        Returns False when the chunk is outside every speculative
        envelope."""
        from ..ops import fsm
        from . import fused

        geom = chunk.geom
        B = self._pad(len(chunk.imgs))
        # every spec route needs one block count per chunk; the check is
        # host-known, so a mixed chunk never reaches the device
        if len({(im.n_mcus, im.blocks_per_mcu) for im in chunk.imgs}) != 1:
            return False
        chunk.steps = fsm.STEPS_PRODUCTION if steps is None else steps
        try:
            try:
                if chunk.spec_plan is None:
                    # nobody prepared it (or the restart preparation ran)
                    with span("prepare", route="spec"):
                        self._adopt(chunk, self._prepare_spec(chunk))
                with span("launch"):
                    xs, *lanes = chunk.spec_dev
                    with span("spec_scan"):
                        pending = fsm.spec_sync_start(
                            chunk.imgs, plan=chunk.spec_plan, xs_dev=xs,
                            lanes_dev=lanes, steps=chunk.steps,
                        )
                    if self._multi:
                        # the JAX engine's staged single-pass decode
                        # (classic materialize), then the sharded pixel
                        # stage
                        coeffs_dev, (err_mal, err_env) = \
                            fsm.decode_speculative_sync(
                                chunk.imgs, pad_to=B, steps=chunk.steps,
                                pending=pending)
                        chunk.out = self._pixels(geom, coeffs_dev,
                                                 chunk.quant)
                        chunk.err_mal, chunk.err_env = err_mal, err_env
                        chunk.err_slot = None
                        chunk.backend = "fsm-spec-sync"
                        return True
                    slots = self._slot_capacity(chunk)
                    rgb, risk, _, _, err, err_slot = (
                        fused.decode_spec_sync_fused(
                            pending, geom, chunk.quant, B, len(chunk.imgs),
                            want_coeffs=False, slots=slots,
                            fancy=self.fancy, exact=self.strict,
                        )
                    )
                chunk.slot_c = slots or 0
                chunk.out = (rgb, risk)
                chunk.err_mal = err
                chunk.err_env = torch.zeros_like(err)
                chunk.err_slot = err_slot
                chunk.backend = "fsm-spec-sync"
                return True
            except fsm.SpecEnvelopeError:
                if fsm.steps_below_safe(chunk.steps):
                    raise  # the outer ladder retries the sync at SAFE
                # envelope at SAFE can be a broken-chain artifact of the
                # sync scheme: the Jacobi path gets its own try
                profiling.count("spec_sync_misses")
            except fsm.SpecSyncMiss:
                profiling.count("spec_sync_misses")
            with span("launch"), span("jacobi", steps=chunk.steps):
                coeffs_dev, (err_mal, err_env) = \
                    fsm.decode_speculative_batch(
                        chunk.imgs, device_out=True, pad_to=B,
                        steps=chunk.steps, device=self.device,
                    )
        except fsm.SpecEnvelopeError:
            if not fsm.steps_below_safe(chunk.steps):
                return False
            chunk.spec_k_retries += 1
            return self._process_chunk_spec(chunk, steps=fsm.STEPS_SAFE)
        except JpegError:
            return False
        with span("launch"):
            chunk.out = self._pixels(geom, coeffs_dev, chunk.quant)
        chunk.err_mal = err_mal
        chunk.err_env = err_env
        chunk.err_slot = None
        chunk.backend = "fsm-spec"
        return True

    def _redecode(self, chunk: _Chunk, steps) -> bool:
        """Decode a device chunk again through its own route."""
        if chunk.backend.startswith("fsm-spec"):
            return self._process_chunk_spec(chunk, steps)
        return self._process_chunk_fsm(chunk, steps)

    def _prefers_fsm(self) -> bool:
        """Whether this decoder routes chunks to the device FSM first:
        backend "fsm", or "auto" without the native library or on a link
        slower than _LINK_MBPS_FSM_THRESHOLD."""
        if self.backend == "fsm":
            return True
        if self.backend != "auto":
            return False
        from . import host

        return (host._load_native() is None
                or measured_link_mbps(self.device) < _LINK_MBPS_FSM_THRESHOLD)

    def _process_chunk(self, chunk: _Chunk, isolate: bool) -> None:
        if self.backend == "cpu":
            self._process_chunk_cpu(chunk, isolate)
            return
        if self.backend == "gather":
            self._process_chunk_gather(chunk)
            return
        if self._prefers_fsm():
            if self._process_chunk_fsm(chunk):
                return
            if self.backend == "fsm" and not chunk.bucketed:
                raise JpegError("fsm: chunk outside the FSM decode envelope")
            # a mixed-size chunk the bucket FSM cannot take (no or
            # unaligned restarts) takes host-bucketed, and "auto" takes
            # the host route: not an error
        self._process_chunk_host(chunk, isolate=isolate)

    def _dispatch_chunk(self, chunk: _Chunk, isolate: bool) -> None:
        # kernels launch on the dispatching thread alone
        planes0 = kernels.LAUNCHES["planes"]
        with span("dispatch", chunk=chunk.id) as sp:
            try:
                self._process_chunk(chunk, isolate)
            except JpegError:
                if not isolate:
                    raise
                # skip mode: a chunk the FSM cannot take goes to the host
                # route, which isolates the bad streams image by image
                self._process_chunk_host(chunk, isolate=True)
            sp.set(route=chunk.backend)
        if kernels.LAUNCHES["planes"] != planes0:
            profiling.count("plane_kernel_chunks")
        if chunk.slot_c:
            profiling.count("spec_slot_chunks")

    # -- decode -------------------------------------------------------------

    def decode_parsed(self, imgs: list[JpegImage], fetch: bool = True,
                      on_error: str = "raise"):
        """Decode parsed images -> list of uint8 [H, W, 3] (None for images
        that failed under on_error='skip', recorded in stats.failures).
        The stride-sorted chunks go through the rolling window (module
        docstring): later chunks prepare while earlier ones dispatch.

        fetch=False leaves the RGB on the card: every chunk still goes
        through the ladder and its fence, the device is synchronized and
        the stats are complete, and the call returns None.

        An image that fills its chunk's raster is a view of the chunk's
        one fetched buffer, so each result keeps that buffer (e.g. 157 MB
        for 128 images of 640x640) alive; copy an image to keep it alone.
        A copy per image doubled the end-to-end time of such chunks on an
        H100 host (PERF.md).  From a card the buffer is a page-locked
        block of PyTorch's caching host allocator, which rounds its size
        up to a power of two (a 157 MB chunk takes a 256 MB block):
        results the caller holds keep that block out of the pool, so a
        later call never overwrites them and allocates another."""
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error={on_error!r}")
        isolate = on_error == "skip"
        with profiling.call() as rec:
            chunks = self._make_chunks(imgs)
            window = _Window(self, isolate)
            window.pending.extend(chunks)
            window.drain(block=True)
            out = self._finish(chunks, len(imgs), fetch, isolate)
        self.stats = self._stats(rec, chunks, len(imgs))
        return out

    def _finish(self, chunks: list[_Chunk], n_images: int, fetch: bool,
                isolate: bool):
        """The retry ladder behind each chunk's fence, the device sync,
        then (fetch=True) each chunk's RGB fetched and cropped: the
        results in the chunks' index order, or None."""
        with span("finish"):
            for chunk in chunks:
                if chunk.err_mal is not None:
                    self._ladder(chunk, isolate)
            if any(c.out is not None for c in chunks):
                with span("sync"):
                    for d in self._cuda_devices():
                        torch.cuda.synchronize(d)
        if not fetch:
            return None
        results: list[np.ndarray | None] = [None] * n_images
        for chunk in chunks:
            if chunk.rgb_host is not None:
                # backend "cpu": uint8 [H, W, 3] on the host already
                for bi, i in enumerate(chunk.indices):
                    results[i] = chunk.rgb_host[bi]
                continue
            with span("fetch", chunk=chunk.id):
                rgb_h = _fetch(chunk.out[0], len(chunk.imgs))
            with span("crop", chunk=chunk.id):
                for bi, i in enumerate(chunk.indices):
                    if chunk.failed and bi in chunk.failed:
                        continue
                    img = chunk.imgs[bi]
                    # bucket rasters carry padding: crop to the true image
                    # (a view where the image fills the raster:
                    # decode_parsed)
                    results[i] = np.ascontiguousarray(
                        rgb_h[bi, : img.height, : img.width])
            # only the results may keep this block from the next fetch
            del rgb_h
        return results

    def _ladder(self, chunk: _Chunk, isolate: bool) -> None:
        """One device chunk's fence and retries (module docstring, 4),
        counted in the call's record."""
        from ..ops import fsm

        with span("fence", chunk=chunk.id):
            mal, env, slot = self._flags(chunk)
        failed = False
        if slot and not chunk.slots_off:
            # a slot group overflowed its capacity: decode the chunk
            # again through the classic materialize, and serve later
            # chunks at the next capacity up (or classic)
            with span("retry", chunk=chunk.id, kind="slots"):
                chunk.slots_off = True
                profiling.count("fsm_slot_retries")
                self._bump_slot_capacity()
                failed = not self._redecode(chunk, chunk.steps)
                if not failed:
                    with span("fence"):
                        mal, env, slot = self._flags(chunk)
        if (not failed and env and not mal
                and fsm.steps_below_safe(chunk.steps)):
            # denser than the fast symbol-step envelope: decode the
            # chunk again on the device at the safe step count
            with span("retry", chunk=chunk.id, kind="steps_safe"):
                profiling.count("fsm_k_retries")
                failed = not self._redecode(chunk, fsm.STEPS_SAFE)
                if not failed:
                    with span("fence"):
                        mal, env, slot = self._flags(chunk)
        if mal or env or failed:
            # bad stream, outside the envelope even at STEPS_SAFE, or
            # a retry that produced nothing (its chunk keeps no stale
            # output): the host route raises (or records) a precise
            # JpegError
            if mal and not failed:
                profiling.count("fsm_malformed_fallbacks")
            else:
                profiling.count("fsm_envelope_fallbacks")
            with span("host_fallback", chunk=chunk.id):
                self._process_chunk_host(chunk, isolate=isolate)
        chunk.staged = None   # its copy is done: the fence was read

    @staticmethod
    def _stats(rec: profiling.Call, chunks: list[_Chunk],
               n_images: int) -> BatchStats:
        """A call's BatchStats from its record and its chunks."""
        sec, cnt = rec.seconds, rec.counts
        routes = dict(Counter(c.backend for c in chunks))
        stats = BatchStats(
            n_images=n_images,
            compressed_bytes=sum(
                im.scan_data.size for c in chunks for im in c.imgs
            ),
            pixels=sum(im.width * im.height for c in chunks for im in c.imgs),
            parse_s=sec.get("parse_wait", 0.0),
            entropy_s=sec.get("dispatch", 0.0),
            device_s=sec.get("finish", 0.0),
            total_s=sec["decode"],
            backend="+".join(sorted(routes)),
            chunks=len(chunks),
            fsm_envelope_fallbacks=cnt.get("fsm_envelope_fallbacks", 0),
            fsm_malformed_fallbacks=cnt.get("fsm_malformed_fallbacks", 0),
            fsm_k_retries=cnt.get("fsm_k_retries", 0)
            + sum(c.spec_k_retries for c in chunks),
            spec_sync_misses=cnt.get("spec_sync_misses", 0),
            fsm_slot_retries=cnt.get("fsm_slot_retries", 0),
            span_s=dict(sec),
            route_chunks=routes,
            prep_misses=cnt.get("prep_misses", 0),
            plane_kernel_chunks=cnt.get("plane_kernel_chunks", 0),
            spec_slot_chunks=cnt.get("spec_slot_chunks", 0),
            fetch_chunks=cnt.get("fetch_chunks", 0),
            fetch_pinned_hits=cnt.get("fetch_pinned_hits", 0),
            lane_pack_chunks=cnt.get("lane_pack_chunks", 0),
            bucket_chunks=cnt.get("bucket_chunks", 0),
            bucket_images=cnt.get("bucket_images", 0),
            bucket_blocks=cnt.get("bucket_blocks", 0),
            bucket_real_blocks=cnt.get("bucket_real_blocks", 0),
            spans=rec.spans,
        )
        for chunk in chunks:
            if chunk.failed:
                for bi, msg in chunk.failed.items():
                    stats.failures[chunk.indices[bi]] = msg
        return stats

    def _cuda_devices(self) -> list:
        """The distinct cards this decoder's chunks run on."""
        devs = [self.device] if self.mesh is None else list(
            self.mesh.devices.flat)
        return list({str(d): d for d in devs if d.type == "cuda"}.values())

    @staticmethod
    def _flags(chunk: _Chunk) -> tuple[bool, bool, bool]:
        """(any malformed lane, any envelope lane, any slot-overflow lane):
        one device read, which also fences the chunk's pixels (on a mesh
        the first shard's; `_finish` synchronizes every device after)."""
        rgb = chunk.out[0]
        fence = _pack_fence(rgb[0] if isinstance(rgb, list) else rgb,
                            chunk.err_mal, chunk.err_env, chunk.err_slot)
        _, mal, env, slot = fence.cpu().tolist()
        return bool(mal), bool(env), bool(slot)

    def decode(self, datas: list[bytes], fetch: bool = True,
               on_error: str = "raise"):
        """Parse + decode a batch of JPEG byte strings, pipelined.

        Parses run on the pool; a chunk is formed as soon as chunk_size
        images of one key (`_chunk_key`) have arrived, in arrival order,
        and dispatched through the rolling window while later streams
        still parse and later chunks prepare (the JAX engine's decode).

        fetch=False returns None and leaves the RGB on the card
        (decode_parsed).  on_error='raise' propagates the first malformed
        stream; 'skip' isolates failures: bad entries yield None and are
        recorded in stats.failures (keyed by position in `datas`)."""
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error={on_error!r}")
        isolate = on_error == "skip"
        groups: dict[tuple, tuple[list, list]] = {}
        chunks: list[_Chunk] = []
        bad: dict[int, str] = {}
        pos_of: list[int] = []
        with profiling.call() as rec:
            futs = [self.pool.submit(profiling.bind(_parse_stream), d,
                                     isolate) for d in datas]
            window = _Window(self, isolate)

            def flush(key, idxs, ims):
                chunk = _Chunk(key[0], list(idxs), list(ims),
                               bucketed=self.size_buckets, id=len(chunks))
                idxs.clear()
                ims.clear()
                chunks.append(chunk)
                window.pending.append(chunk)
                window.drain(block=False)

            for i, f in enumerate(futs):
                with span("parse_wait"):
                    res = f.result()   # later parses keep running
                if isinstance(res, str):
                    bad[i] = res
                    continue
                key = self._chunk_key(res)
                idxs, ims = groups.setdefault(key, ([], []))
                idxs.append(len(pos_of))
                ims.append(res)
                pos_of.append(i)
                if len(idxs) == self.chunk_size:
                    flush(key, idxs, ims)
            for key, (idxs, ims) in groups.items():
                if idxs:
                    flush(key, idxs, ims)
            window.drain(block=True)
            out = self._finish(chunks, len(pos_of), fetch, isolate)
        self.stats = self._stats(rec, chunks, len(pos_of))
        failures = {pos_of[j]: msg for j, msg in self.stats.failures.items()}
        self.stats.failures = {**bad, **failures}
        if out is None:
            return None
        full: list = [None] * len(datas)
        for j, i in enumerate(pos_of):
            full[i] = out[j]
        return full
