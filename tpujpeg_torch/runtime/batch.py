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
     blocks), the lane plan is uploaded and runtime.fused.
     decode_chunk_fused runs scan -> classic materialize -> DC resolve ->
     pixels on the device.  A plan in two stride classes (build_plan's
     split, taken only below the link rate _LINK_MBPS_SPLIT) takes the
     staged chain instead: fsm.decode_plan (a scan per group, the `perm`
     gather), fsm.assemble_batched, pipeline.device_decode_fn.
     Otherwise the chunk takes the speculative path: the single-pass
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

materialize_route names how the classic materialize places events
(ops/fsm.materialize_events): "scatter" (default), "ranked" (the JAX
package's TPUJPEG_RANK_KERNEL=0) or "full" (TPUJPEG_PALLAS=1).

Every sampling the parser takes decodes on every route: 4:4:4 through
the fused pixel kernel, 4:2:0, 4:2:2, 4:4:0, 4:1:1 and grayscale through
the plane path (pipeline.device_decode_fn).  Chunks key on Geometry, so
a batch that mixes samplings splits by itself.  fancy=True selects
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
after the copies by an event.  Kernels launch only on the dispatching
thread, the speculative scans at dispatch; the K and slot retries reuse
the prepared plan.  A JpegError of a preparation
routes the chunk as the serial engine would; any other exception
reaches the caller.

decode_parsed(fetch=False) and decode(fetch=False) run every chunk
through the ladder and its one-read fence, synchronize the device and
return None: no RGB leaves the card.

Several devices (mesh=, parallel/sharding.py): entropy decode and
staging run on the mesh's first device, and the pixel stage is sharded
over the mesh's batch axis (sharding.compiled_batch_decoder), each
shard's output left on its device until `_finish` fetches it.  On a mesh
of more than one device the routes change as in the JAX engine: a
restart chunk leaves the fused chain for the staged one (scan and
place_events per group, assemble, sharded pixels), a bucketed fsm chunk
takes the host-bucketed route, a speculative chunk runs the staged
single-pass decode (fsm.decode_speculative_sync, the classic
materialize) or the Jacobi path, then sharded pixels; the host, oracle
and gather routes shard their pixel stage.  B is padded to a multiple of
the batch axis (`_pad`).  mesh=None is a one-device mesh of `device`.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..errors import JpegError
from ..io.parser import JpegImage, parse
from ..parallel import sharding
from ..pipeline import (Geometry, bucket_geometry, device_decode_fn,
                        pad_coeffs_to_bucket)

# The link rate (MB/s) below which uploading a chunk's dense coefficients
# (the host route's int32 [B, n_blocks, 64]) costs more than uploading its
# scan bytes plus the fsm route's device entropy decode (scan, materialize,
# DC resolve): (coefficient bytes - scan bytes) / entropy ms.  Read by
# chip_smoke.py phase 6e on the 128-image restart chunk (rst640 x 8) on an
# NVIDIA H100 80GB HBM3 at 700.00 W: (629,145,600 - 26,255,360) bytes /
# 1.902 ms = 316,947.7 MB/s.  Every link reads far below it, so "auto"
# takes the fsm route wherever a card is attached by PCIe.
_LINK_MBPS_FSM_THRESHOLD = 316_947.7

# The link rate below which build_plan's split (two stride groups, fewer
# padded upload bytes) pays for the staged chain's extra device time:
# (single-group bytes - split bytes) / (staged ms - fused ms), both chains
# with their bytes resident.  The same run: (26,255,360 - 20,726,272)
# bytes / (7.785 - 2.590) ms = 1,064.5 MB/s.  The split saves 5.5 MB of
# upload and costs a second scan, int32 lane rows, the perm gather and an
# assemble; above this rate the engine keeps one group and the fused chain.
_LINK_MBPS_SPLIT = 1_064.5

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
    """Counters and wall-clock seconds of the last decode() call."""

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
    spec_sync_misses: int = 0          # sync resolve misses -> Jacobi
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


def _stride_key(img: JpegImage) -> int:
    """Longest restart-segment byte length (what sets the FSM scan stride)."""
    offs = img.segment_offsets
    if offs.size <= 1:
        return int(img.scan_data.size)
    ends = np.append(offs[1:], img.scan_data.size)
    return int((ends - offs).max())


def _try_parse(data: bytes):
    try:
        return parse(data)
    except JpegError as e:
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
    shards (a mesh).  One tensor is interleaved on the device and fetched
    in one transfer; shards are each interleaved on their device and
    copied into their rows of one host buffer."""
    if not isinstance(rgb, list):
        return rgb[:n].permute(0, 2, 3, 1).contiguous().cpu().numpy()
    per, _, H, W = rgb[0].shape
    out = np.empty((n, H, W, 3), np.uint8)
    for i, shard in enumerate(rgb):
        lo, hi = i * per, min((i + 1) * per, n)
        if hi > lo:
            torch.from_numpy(out[lo:hi]).copy_(
                shard[: hi - lo].permute(0, 2, 3, 1))
    return out


class _Upload:
    """One prepared chunk's arrays on their way to the device.

    On a card each array is pinned (PyTorch's caching host allocator: a
    block is handed out again only once the copies recorded on it are
    done, so only a new size pays a cudaHostAlloc) and copied up
    non-blocking on the decoder's copy stream, so a prepare on a pool
    thread neither blocks on the copy nor queues behind the kernels of
    the chunk before it; `done` records the event after the copies.
    `adopt`, on the dispatching thread, makes the current (compute)
    stream wait for that event before the chunk's first kernel and
    records each tensor on it for the caching allocator.  On the CPU the
    arrays are wrapped as tensors: no stream, no copy."""

    def __init__(self, device: torch.device, stream):
        self.device = device
        self.stream = stream
        self.pinned: list = []       # the page-locked sources
        self.tensors: list = []      # their device copies
        self.event = None            # torch.cuda.Event after the copies

    def __call__(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.stream is None:
            return t
        src = t.pin_memory()
        with torch.cuda.stream(self.stream):
            t = src.to(self.device, non_blocking=True)
        self.pinned.append(src)
        self.tensors.append(t)
        return t

    def done(self) -> "_Upload":
        if self.stream is not None:
            self.event = torch.cuda.Event()
            self.event.record(self.stream)
        return self

    def adopt(self) -> None:
        if self.event is None:
            return
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(compute)


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
    them, each waiting for its own.  `t_ent` sums the dispatch time."""

    def __init__(self, dec: "BatchDecoder", isolate: bool):
        self.dec = dec
        self.isolate = isolate
        self.prep = dec.backend == "gather" or dec._prefers_fsm()
        if self.prep:
            # on this thread, before any prepare reads them: the probe
            # (the fsm plans' split) and the copy stream
            if dec.backend != "gather":
                measured_link_mbps(dec.device)
            dec._upload()
        self.pending: list[_Chunk] = []
        self.t_ent = 0.0

    def drain(self, block: bool) -> None:
        dec = self.dec
        while self.pending:
            if self.prep:
                for c in self.pending[:_PREP_AHEAD]:
                    if c.plan_future is None:
                        c.plan_future = dec.prep_pool.submit(
                            dec._prepare_chunk, c)
            c = self.pending[0]
            if (not block and c.plan_future is not None
                    and not c.plan_future.done()):
                break
            self.pending.pop(0)
            t0 = time.perf_counter()
            dec._dispatch_chunk(c, self.isolate)
            self.t_ent += time.perf_counter() - t0


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two device names can mean one device ("cuda" is cuda:i for
    every i)."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class BatchDecoder:
    """Reusable batched decoder on one explicit device or a mesh."""

    def __init__(self, backend: str = "fsm", workers: int | None = None,
                 chunk_size: int = 32, strict: bool = True, device="cuda",
                 size_buckets: bool = False,
                 materialize_route: str = "scatter", fancy: bool = False,
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
        true size on the host.  materialize_route is the classic
        materialize's route (module docstring)."""
        from ..ops import materialize

        if backend not in ("auto", "host", "fsm", "gather", "oracle", "cpu"):
            raise ValueError(f"unknown backend {backend!r}")
        if size_buckets and backend not in ("auto", "host", "oracle", "fsm"):
            raise ValueError(
                "size_buckets requires backend auto/host/oracle/fsm")
        if materialize_route not in materialize.ROUTES:
            raise ValueError(
                f"unknown materialize_route {materialize_route!r}")
        self.backend = backend
        self.size_buckets = size_buckets
        self.route = materialize_route
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
                                     bucketed=self.size_buckets))
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
        device_decode_fn on self.device (rgb one tensor), on a mesh of
        several sharded over its batch axis (rgb a list of shards, each
        on its device).  Host tensors go to each shard's device
        directly."""
        if not self._multi:
            return device_decode_fn(
                geom, coeffs.to(self.device), quant.to(self.device),
                fancy=self.fancy, exact=self.strict,
                extents=None if extents is None else extents.to(self.device))
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
        for bi, img in enumerate(chunk.imgs):
            quant[bi] = np.stack(
                [img.quant_tables[comp.quant_id] for comp in img.components]
            )
        return quant

    # -- preparation (the prep pool) ----------------------------------------

    def _prepare_plan(self, chunk: _Chunk) -> _Prepared:
        """A restart chunk: the lane plan (split only below the link rate
        _LINK_MBPS_SPLIT, read on the card) and its arrays staged.
        Raises JpegError when the chunk does not pack."""
        from ..ops import fsm

        plan = fsm.build_plan(
            chunk.imgs,
            split=measured_link_mbps(self.device) < _LINK_MBPS_SPLIT)
        up = self._upload()
        arrays = (tuple((up(xs), up(sn)) for xs, sn in plan.groups),
                  up(plan.perm))
        quant = up(self._quant_host(chunk))
        return _Prepared("plan", plan, arrays, quant, up.done())

    def _prepare_bucket(self, chunk: _Chunk) -> _Prepared:
        """A bucketed chunk: the bucket-raster plan, its four arrays, the
        quant tables and the extents staged.  Raises JpegError outside the
        bucket-FSM envelope (the chunk takes the host-bucketed route)."""
        from ..ops import fsm
        from .fused import bucket_extents

        plan = fsm.build_plan_bucketed(chunk.imgs, chunk.geom)
        up = self._upload()
        arrays = tuple(map(up, (plan.xs, plan.seg_n, plan.wrap_at,
                                plan.skip)))
        quant = up(self._quant_host(chunk))
        extents = up(bucket_extents(plan, len(chunk.imgs)))
        return _Prepared("bucket", plan, arrays, quant, up.done(), extents)

    def _prepare_spec(self, chunk: _Chunk) -> _Prepared:
        """A chunk that does not pack: the speculative plan and what
        fsm.spec_sync_start reads, staged.  Its scans launch at dispatch,
        on the dispatching thread.  Raises JpegError for a chunk of mixed
        block counts or tables."""
        from ..ops import fsm

        if len({(im.n_mcus, im.blocks_per_mcu) for im in chunk.imgs}) != 1:
            raise JpegError("fsm-spec: chunk mixes block counts")
        plan = fsm.build_spec_plan_batch(chunk.imgs, 1024)
        up = self._upload()
        arrays = tuple(map(up, (plan.xs, *fsm.spec_lane_arrays(plan))))
        quant = up(self._quant_host(chunk))
        return _Prepared("spec", plan, arrays, quant, up.done())

    def _prepare_gather(self, chunk: _Chunk) -> _Prepared:
        """A gather chunk: the segment plan and its arrays staged (the
        tables go up once per table set, at dispatch: entropy.device_luts).
        Raises JpegError for a chunk the plan cannot take."""
        from ..ops import entropy

        plan = entropy.build_segment_plan(chunk.imgs)
        up = self._upload()
        arrays = tuple(map(up, entropy.plan_arrays(plan)))
        quant = up(self._quant_host(chunk))
        return _Prepared("gather", plan, arrays, quant, up.done())

    def _prepare_chunk(self, chunk: _Chunk):
        """The prep pool's task: the gather route's preparation on backend
        "gather", else the device FSM's.  Returns the _Prepared or the
        JpegError of a chunk outside the route."""
        if self.backend == "gather":
            try:
                return self._prepare_gather(chunk)
            except JpegError as e:
                return e
        return self._prepare_chunk_fsm(chunk)

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
            try:
                return entropy_decode(img)
            except JpegError as e:
                if not isolate:
                    raise
                return e

        coeffs = np.zeros((B, geom.n_blocks, 64), np.int32)
        for bi, res in enumerate(self.pool.map(one, chunk.imgs)):
            if isinstance(res, JpegError):
                if chunk.failed is None:
                    chunk.failed = {}
                chunk.failed[bi] = str(res)
            elif chunk.bucketed:
                pad_coeffs_to_bucket(Geometry.of(chunk.imgs[bi]), geom, res,
                                     coeffs[bi])
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
        chunk.out = self._pixels(geom, torch.as_tensor(coeffs),
                                 torch.as_tensor(self._quant_host(chunk)),
                                 extents)
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
        coeffs, err = entropy.decode_plan(chunk.plan, self.device,
                                          uploaded=chunk.uploaded)
        entropy.check_lanes(err)
        coeffs = coeffs.reshape(n, geom.n_blocks, 64)
        B = self._pad(n)
        if B > n:
            coeffs = torch.nn.functional.pad(coeffs, (0, 0, 0, 0, 0, B - n))
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
        (runtime/fused.py), or the staged chain for a plan in two stride
        groups; a chunk that does not pack (fsm.build_plan raises
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
        if len(groups) == 1 and not self._multi:
            rgb, risk, _, _, err_mal, err_env, err_slot = (
                fused.decode_chunk_fused(
                    chunk.plan, quant, chunk.geom, B, steps=chunk.steps,
                    want_coeffs=False, uploaded=groups[0], slots=False,
                    route=self.route, fancy=self.fancy, exact=self.strict,
                )
            )
        else:
            # the staged chain (a split plan, or a mesh of several
            # devices): a scan per stride group, rows back in lane order,
            # assembled per image, then the pixel stage
            per_lane, (err_mal, err_env) = fsm.decode_plan(
                chunk.plan, uploaded=chunk.uploaded, steps=chunk.steps,
                route=self.route)
            coeffs = fsm.assemble_batched(per_lane, layout=chunk.plan.layout,
                                          pad_to=B)
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
        tables, a row capacity past the route's int16 gate), and the
        caller takes the host-bucketed route.  A kernel that fails to
        build or launch raises; it is never turned into a fallback."""
        from ..ops import fsm, materialize
        from . import fused

        if chunk.plan is None and self._take_prepared(chunk) != "bucket":
            return False
        plan = chunk.plan
        if (self.route != "scatter"
                and plan.max_blk * 64 > materialize.INT16_SPAN):
            # the dense rows pass the int16 offsets of the "ranked" and
            # "full" routes; the scatter has no such limit
            return False
        chunk.steps = fsm.STEPS_PRODUCTION if steps is None else steps
        B = len(chunk.imgs)
        rgb, risk, _, _, err_mal, err_env, err_slot = (
            fused.decode_chunk_bucketed(
                plan, chunk.quant, chunk.geom, B,
                steps=chunk.steps, want_coeffs=False,
                uploaded=chunk.uploaded, slots=False, route=self.route,
                fancy=self.fancy, exact=self.strict, extents=chunk.extents,
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
                    self._adopt(chunk, self._prepare_spec(chunk))
                xs, *lanes = chunk.spec_dev
                pending = fsm.spec_sync_start(
                    chunk.imgs, plan=chunk.spec_plan, xs_dev=xs,
                    lanes_dev=lanes, steps=chunk.steps,
                )
                if self._multi:
                    # the JAX engine's staged single-pass decode (classic
                    # materialize), then the sharded pixel stage
                    coeffs_dev, (err_mal, err_env) = \
                        fsm.decode_speculative_sync(
                            chunk.imgs, pad_to=B, steps=chunk.steps,
                            pending=pending, route=self.route)
                    chunk.out = self._pixels(geom, coeffs_dev, chunk.quant)
                    chunk.err_mal, chunk.err_env = err_mal, err_env
                    chunk.err_slot = None
                    chunk.backend = "fsm-spec-sync"
                    return True
                rgb, risk, _, _, err, err_slot = (
                    fused.decode_spec_sync_fused(
                        pending, geom, chunk.quant, B, len(chunk.imgs),
                        want_coeffs=False,
                        slots=self._slot_capacity(chunk), route=self.route,
                        fancy=self.fancy, exact=self.strict,
                    )
                )
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
                chunk.spec_sync_misses += 1
            except fsm.SpecSyncMiss:
                chunk.spec_sync_misses += 1
            coeffs_dev, (err_mal, err_env) = fsm.decode_speculative_batch(
                chunk.imgs, device_out=True, pad_to=B, steps=chunk.steps,
                device=self.device, route=self.route,
            )
        except fsm.SpecEnvelopeError:
            if not fsm.steps_below_safe(chunk.steps):
                return False
            chunk.spec_k_retries += 1
            return self._process_chunk_spec(chunk, steps=fsm.STEPS_SAFE)
        except JpegError:
            return False
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
        try:
            self._process_chunk(chunk, isolate)
        except JpegError:
            if not isolate:
                raise
            # skip mode: a chunk the FSM cannot take goes to the host
            # route, which isolates the bad streams image by image
            self._process_chunk_host(chunk, isolate=True)

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
        H100 host (PERF.md)."""
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error={on_error!r}")
        t_start = time.perf_counter()
        isolate = on_error == "skip"
        chunks = self._make_chunks(imgs)
        window = _Window(self, isolate)
        window.pending.extend(chunks)
        window.drain(block=True)
        return self._finish(chunks, len(imgs), t_start, window.t_ent, fetch,
                            isolate)

    def _finish(self, chunks: list[_Chunk], n_images: int, t_start: float,
                t_ent: float, fetch: bool, isolate: bool):
        from ..ops import fsm

        n_env = n_mal = n_k = n_slot = 0
        t0 = time.perf_counter()
        for chunk in chunks:
            if chunk.err_mal is None:
                continue
            mal, env, slot = self._flags(chunk)
            failed = False
            if slot and not chunk.slots_off:
                # a slot group overflowed its capacity: decode the chunk
                # again through the classic materialize, and serve later
                # chunks at the next capacity up (or classic)
                chunk.slots_off = True
                n_slot += 1
                self._bump_slot_capacity()
                failed = not self._redecode(chunk, chunk.steps)
                if not failed:
                    mal, env, slot = self._flags(chunk)
            if (not failed and env and not mal
                    and fsm.steps_below_safe(chunk.steps)):
                # denser than the fast symbol-step envelope: decode the
                # chunk again on the device at the safe step count
                n_k += 1
                failed = not self._redecode(chunk, fsm.STEPS_SAFE)
                if not failed:
                    mal, env, slot = self._flags(chunk)
            if mal or env or failed:
                # bad stream, outside the envelope even at STEPS_SAFE, or
                # a retry that produced nothing (its chunk keeps no stale
                # output): the host route raises (or records) a precise
                # JpegError
                n_mal += int(mal and not failed)
                n_env += int(failed or (env and not mal))
                self._process_chunk_host(chunk, isolate=isolate)
            chunk.staged = None   # its copy is done: the fence was read
        if any(c.out is not None for c in chunks):
            for d in self._cuda_devices():
                torch.cuda.synchronize(d)
        t_dev = time.perf_counter() - t0

        self.stats = BatchStats(
            n_images=n_images,
            compressed_bytes=sum(
                im.scan_data.size for c in chunks for im in c.imgs
            ),
            pixels=sum(im.width * im.height for c in chunks for im in c.imgs),
            entropy_s=t_ent,
            device_s=t_dev,
            backend="+".join(sorted({c.backend for c in chunks})),
            chunks=len(chunks),
            fsm_envelope_fallbacks=n_env,
            fsm_malformed_fallbacks=n_mal,
            fsm_k_retries=n_k + sum(c.spec_k_retries for c in chunks),
            spec_sync_misses=sum(c.spec_sync_misses for c in chunks),
            fsm_slot_retries=n_slot,
        )
        for chunk in chunks:
            if chunk.failed:
                for bi, msg in chunk.failed.items():
                    self.stats.failures[chunk.indices[bi]] = msg

        if not fetch:
            self.stats.total_s = time.perf_counter() - t_start
            return None
        results: list[np.ndarray | None] = [None] * n_images
        for chunk in chunks:
            if chunk.rgb_host is not None:
                # backend "cpu": uint8 [H, W, 3] on the host already
                for bi, i in enumerate(chunk.indices):
                    results[i] = chunk.rgb_host[bi]
                continue
            rgb_h = _fetch(chunk.out[0], len(chunk.imgs))
            for bi, i in enumerate(chunk.indices):
                if chunk.failed and bi in chunk.failed:
                    continue
                img = chunk.imgs[bi]
                # bucket rasters carry padding: crop to the true image (a
                # view where the image fills the raster: decode_parsed)
                results[i] = np.ascontiguousarray(
                    rgb_h[bi, : img.height, : img.width])
        self.stats.total_s = time.perf_counter() - t_start
        return results

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
        t_start = time.perf_counter()
        isolate = on_error == "skip"
        futs = [self.pool.submit(_try_parse if isolate else parse, d)
                for d in datas]
        window = _Window(self, isolate)
        groups: dict[tuple, tuple[list, list]] = {}
        chunks: list[_Chunk] = []
        bad: dict[int, str] = {}
        pos_of: list[int] = []
        t_parse = 0.0

        def flush(key, idxs, ims):
            chunk = _Chunk(key[0], list(idxs), list(ims),
                           bucketed=self.size_buckets)
            idxs.clear()
            ims.clear()
            chunks.append(chunk)
            window.pending.append(chunk)
            window.drain(block=False)

        for i, f in enumerate(futs):
            t0 = time.perf_counter()
            res = f.result()   # later parses keep running on the pool
            t_parse += time.perf_counter() - t0
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

        out = self._finish(chunks, len(pos_of), t_start, window.t_ent, fetch,
                           isolate)
        self.stats.parse_s = t_parse
        self.stats.total_s = time.perf_counter() - t_start
        failures = {pos_of[j]: msg for j, msg in self.stats.failures.items()}
        self.stats.failures = {**bad, **failures}
        if out is None:
            return None
        full: list = [None] * len(datas)
        for j, i in enumerate(pos_of):
            full[i] = out[j]
        return full
