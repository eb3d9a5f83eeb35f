"""Batched decode engine on one CUDA device.

Counterpart of tpujpeg/runtime/batch.py for the restart-marker path:

  1. parse (host, shared tpujpeg.io parser);
  2. chunking by geometry, stride-sorted (similar segment lengths share a
     chunk, so the scan's column count follows the longest segment of a
     tighter group);
  3. per chunk, backend 'fsm': the lane plan is uploaded and
     runtime.fused.decode_chunk_fused runs scan -> materialize -> DC
     resolve -> assemble -> pixels on the device; backend 'host': the
     native C++ entropy decoder on the host, then the pixel stage;
  4. `_finish`: the retry ladder and the strict repair.  A chunk whose
     envelope latch is set is decoded again on the device at STEPS_SAFE
     (counted in fsm_k_retries); a malformed latch, or an envelope latch
     that survives the retry, sends the chunk to the host route (counted
     in fsm_malformed_fallbacks / fsm_envelope_fallbacks), which raises
     or, with on_error='skip', records a precise error per image.  Strict
     mode recomputes risk-flagged pixels with the oracle's exact math.

Not ported yet (ROADMAP): streams without restart markers (queue 1 item
10), size buckets (11), subsampled and grayscale streams (12), several
devices (13), the prep-pool overlap of plan building with device work.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from tpujpeg.errors import JpegError
from tpujpeg.io.parser import JpegImage, parse

from ..ops.color import unpack_mask
from ..pipeline import Geometry, _repair, check_supported, device_decode_fn


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
    repaired_pixels: int = 0
    failures: dict = field(default_factory=dict)  # index -> error message
    fsm_envelope_fallbacks: int = 0   # chunks redone on host: outside envelope
    fsm_k_retries: int = 0            # chunks re-decoded at STEPS_SAFE
    fsm_malformed_fallbacks: int = 0  # chunks redone on host: bad stream

    def as_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class _Chunk:
    geom: Geometry
    indices: list[int]
    imgs: list[JpegImage]
    coeffs: np.ndarray | None = None   # host coefficients (host route)
    coeffs_dev: object = None          # device coeffs, raw DC diffs (fsm)
    dc_dev: object = None              # resolved DC [B, n_blocks] (fsm)
    plan: object = None                # FsmPlan, kept for the K retry
    uploaded: object = None            # plan's (xs, seg_n) on the device
    steps: object = None               # FSM steps spec of the last decode
    err_mal: object = None
    err_env: object = None
    out: object = None                 # device (rgb, riskbits)
    backend: str = ""
    failed: dict | None = None         # local index -> message (skip mode)


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


class BatchDecoder:
    """Reusable batched decoder on one explicit device."""

    def __init__(self, backend: str = "fsm", chunk_size: int = 32,
                 strict: bool = True, device="cuda"):
        if backend not in ("fsm", "host"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.chunk_size = chunk_size
        self.strict = strict
        self.device = torch.device(device)
        self.pool = ThreadPoolExecutor()
        self.stats = BatchStats()

    def close(self) -> None:
        self.pool.shutdown()

    # -- chunking -----------------------------------------------------------

    def _make_chunks(self, imgs: list[JpegImage]) -> list[_Chunk]:
        buckets: dict[Geometry, list[int]] = {}
        for i, img in enumerate(imgs):
            buckets.setdefault(Geometry.of(img), []).append(i)
        chunks = []
        for geom, idxs in buckets.items():
            idxs = sorted(idxs, key=lambda i: _stride_key(imgs[i]))
            for j in range(0, len(idxs), self.chunk_size):
                part = idxs[j : j + self.chunk_size]
                chunks.append(_Chunk(geom, part, [imgs[i] for i in part]))
        return chunks

    def _quant_block(self, chunk: _Chunk, B: int) -> torch.Tensor:
        quant = np.zeros((B, len(chunk.geom.comps), 64), np.int32)
        for bi, img in enumerate(chunk.imgs):
            quant[bi] = np.stack(
                [img.quant_tables[comp.quant_id] for comp in img.components]
            )
        return torch.as_tensor(quant).to(self.device)

    # -- chunk routes -------------------------------------------------------

    def _process_chunk_host(self, chunk: _Chunk, isolate: bool = False):
        """Native host entropy -> coefficient upload -> pixel stage.

        isolate=True decodes failing images one by one: a bad one yields
        zero coefficients and lands in chunk.failed instead of raising."""
        from tpujpeg.runtime import host

        geom = chunk.geom
        check_supported(geom)
        B = len(chunk.imgs)

        def one(img):
            try:
                return host.entropy_decode(img, threads=1)
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
            else:
                coeffs[bi] = res
        chunk.out = device_decode_fn(
            geom, torch.as_tensor(coeffs).to(self.device),
            self._quant_block(chunk, B),
        )
        chunk.coeffs = coeffs
        chunk.coeffs_dev = chunk.dc_dev = None
        chunk.err_mal = chunk.err_env = None
        chunk.backend = "host"

    def _process_chunk_fsm(self, chunk: _Chunk, steps=None) -> None:
        """Scan bytes up, then the fused device chain (runtime/fused.py).

        Raises NotImplementedError for streams without restart markers
        (the speculative paths are ROADMAP queue 1 item 10) and JpegError
        when the chunk cannot be packed into restart lanes."""
        from ..ops import fsm
        from . import fused

        check_supported(chunk.geom)
        if any(not img.restart_interval for img in chunk.imgs):
            raise NotImplementedError(
                "backend='fsm' decodes restart-marker streams only; streams "
                "without restart markers are ROADMAP queue 1 item 10 "
                "(use backend='host')"
            )
        if chunk.plan is None:
            try:
                chunk.plan = fsm.build_plan(chunk.imgs)
            except JpegError as e:
                raise JpegError(
                    f"fsm: chunk outside the FSM decode envelope ({e})"
                ) from e
            chunk.uploaded = (
                torch.as_tensor(chunk.plan.xs).to(self.device),
                torch.as_tensor(chunk.plan.seg_n_blocks).to(self.device),
            )
        chunk.steps = fsm.STEPS_PRODUCTION if steps is None else steps
        B = len(chunk.imgs)
        rgb, risk, coeffs, dc, err_mal, err_env, _ = fused.decode_chunk_fused(
            chunk.plan, self._quant_block(chunk, B), chunk.geom, B,
            steps=chunk.steps, want_coeffs=self.strict,
            uploaded=chunk.uploaded,
        )
        chunk.out = (rgb, risk)
        chunk.coeffs_dev = coeffs
        chunk.dc_dev = dc
        chunk.err_mal = err_mal
        chunk.err_env = err_env
        chunk.backend = "fsm"

    def _dispatch_chunk(self, chunk: _Chunk, isolate: bool) -> None:
        if self.backend == "host":
            self._process_chunk_host(chunk, isolate=isolate)
            return
        try:
            self._process_chunk_fsm(chunk)
        except JpegError:
            if not isolate:
                raise
            # skip mode: a chunk the FSM cannot take goes to the host
            # route, which isolates the bad streams image by image
            self._process_chunk_host(chunk, isolate=True)

    # -- decode -------------------------------------------------------------

    def decode_parsed(self, imgs: list[JpegImage], on_error: str = "raise"):
        """Decode parsed images -> list of uint8 [H, W, 3] (None for images
        that failed under on_error='skip', recorded in stats.failures)."""
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error={on_error!r}")
        t_start = time.perf_counter()
        isolate = on_error == "skip"
        chunks = self._make_chunks(imgs)
        t0 = time.perf_counter()
        for chunk in chunks:
            self._dispatch_chunk(chunk, isolate)
        t_ent = time.perf_counter() - t0
        return self._finish(chunks, len(imgs), t_start, t_ent, isolate)

    def _finish(self, chunks: list[_Chunk], n_images: int, t_start: float,
                t_ent: float, isolate: bool):
        from ..ops import fsm

        n_env = n_mal = n_k = 0
        t0 = time.perf_counter()
        for chunk in chunks:
            if chunk.err_mal is None:
                continue
            mal, env = self._flags(chunk)
            if env and not mal and fsm.steps_below_safe(chunk.steps):
                # denser than the fast symbol-step envelope: decode the
                # chunk again on the device at the safe step count
                n_k += 1
                self._process_chunk_fsm(chunk, steps=fsm.STEPS_SAFE)
                mal, env = self._flags(chunk)
            if mal or env:
                # bad stream, or outside the envelope even at STEPS_SAFE:
                # the host route raises (or records) a precise JpegError
                n_mal += int(mal)
                n_env += int(env and not mal)
                self._process_chunk_host(chunk, isolate=isolate)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
            fsm_k_retries=n_k,
        )
        for chunk in chunks:
            if chunk.failed:
                for bi, msg in chunk.failed.items():
                    self.stats.failures[chunk.indices[bi]] = msg

        results: list[np.ndarray | None] = [None] * n_images
        repaired = 0
        for chunk in chunks:
            rgb, risk = chunk.out
            n = len(chunk.imgs)
            # device rgb is planar [B, 3, H, W]; interleave on the host
            rgb_h = np.moveaxis(rgb[:n].cpu().numpy(), 1, -1).astype(np.int32)
            risk_h = risk[:n].cpu().numpy() if self.strict else None
            coeffs_h = chunk.coeffs
            for bi, i in enumerate(chunk.indices):
                if chunk.failed and bi in chunk.failed:
                    continue
                img = chunk.imgs[bi]
                out = rgb_h[bi]
                if self.strict:
                    mask = unpack_mask(risk_h[bi], img.width)[: img.height]
                    if mask.any():
                        if coeffs_h is None:
                            # fsm route: the dense DC rows are raw DPCM
                            # differences; the resolved plane rides apart
                            coeffs_h = chunk.coeffs_dev[:n].cpu().numpy()
                            coeffs_h = coeffs_h.astype(np.int32)
                            coeffs_h[:, :, 0] = chunk.dc_dev[:n].cpu().numpy()
                        _repair(img, coeffs_h[bi], out, mask)
                        repaired += int(mask.sum())
                results[i] = out.astype(np.uint8)
        self.stats.repaired_pixels = repaired
        self.stats.total_s = time.perf_counter() - t_start
        return results

    @staticmethod
    def _flags(chunk: _Chunk) -> tuple[bool, bool]:
        """(any malformed lane, any envelope lane): one device read."""
        flags = torch.stack([chunk.err_mal.any(), chunk.err_env.any()])
        mal, env = flags.cpu().tolist()
        return bool(mal), bool(env)

    def decode(self, datas: list[bytes], on_error: str = "raise"):
        """Parse + decode a batch of JPEG byte strings.

        on_error='raise' propagates the first malformed stream; 'skip'
        isolates failures: bad entries yield None and are recorded in
        stats.failures (keyed by position in `datas`)."""
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error={on_error!r}")
        t_start = time.perf_counter()
        isolate = on_error == "skip"
        parsed = list(self.pool.map(_try_parse if isolate else parse, datas))
        t_parse = time.perf_counter() - t_start
        bad = {i: r for i, r in enumerate(parsed) if isinstance(r, str)}
        pos_of = [i for i, r in enumerate(parsed) if not isinstance(r, str)]
        out = self.decode_parsed([parsed[i] for i in pos_of], on_error)
        self.stats.parse_s = t_parse
        self.stats.total_s = time.perf_counter() - t_start
        failures = {pos_of[j]: msg for j, msg in self.stats.failures.items()}
        self.stats.failures = {**bad, **failures}
        full: list = [None] * len(datas)
        for j, i in enumerate(pos_of):
            full[i] = out[j]
        return full
