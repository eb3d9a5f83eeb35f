"""tpujpeg_torch — the PyTorch/CUDA port of tpujpeg for NVIDIA Hopper.

Batch decode of baseline streams (4:4:4, 4:2:0, 4:2:2, 4:4:0, 4:1:1 and
grayscale), with or without restart markers, of one exact size or of
mixed sizes (size-class buckets), runs on the card through hand-written
CUDA kernels (csrc/): the Huffman symbol FSM scan (restart lanes,
bucket-raster emission, the speculative modes), the events -> dense
coefficient scatter and its two other placements (offset compaction,
full-height compaction and spread; no decode path takes them), the
slot route's compact, unpack and expand, and the fused dequant + IDCT + colour pixel stage of 4:4:4,
which reads the coefficients where the chain leaves them and writes
the cropped RGB raster, and its subsampled sibling (csrc/planes.cu:
IDCT into sample planes, box or fancy chroma upsampling, colour; one
launch a chunk), whose contract is the plain PyTorch plane path (plain
XLA in the JAX package).  Grayscale pixels stay plain PyTorch.  csrc/probes.cu holds the
lookup and materialize-stage probes that tools/bench_torch_gather.py and
tools/bench_torch_materialize.py time.

The package stands alone: it keeps its own copy of the host layer
(errors, constants, io/, oracle/, runtime/host.py, runtime/native/) and
imports neither jax nor the tpujpeg package.

The device is always explicit; the default is "cuda", and so is the
default backend of `decode` ("cuda") and of `decode_batch` ("fsm"): the
JAX package's default "auto" would decode a single image on the CPU.
"""

from .errors import JpegError
from .io.parser import JpegImage, parse, parse_file

__version__ = "0.1.0"

__all__ = [
    "JpegError",
    "JpegImage",
    "parse",
    "parse_file",
    "decode",
    "decode_batch",
    "__version__",
]


def decode(data, backend: str = "cuda", device="cuda", fancy: bool = False):
    """Decode a JPEG (path or bytes) to an int32 [H, W, 3] RGB array.

    backend='cuda' runs host entropy decode, then the port's pixel stage on
    `device` with the reference's exact colour computed there (bit-exact
    with the reference decoder, nothing repaired on the host);
    backend='cpu' the native library's whole decode on the host
    (runtime.host.decode_cpu); backend='auto' is 'cpu' where the native
    library loads and 'cuda' otherwise (one image cannot amortize a
    device dispatch); backend='oracle' runs the NumPy reference decoder.
    All four give the same bits.  fancy=True upsamples subsampled chroma
    with libjpeg's triangle filter (box replication otherwise).
    """
    img = parse_file(data) if isinstance(data, str) else parse(data)
    if backend == "auto":
        from .runtime import host

        backend = "cpu" if host._load_native() is not None else "cuda"
    if backend == "oracle":
        from .oracle import decoder as oracle

        return oracle.decode(img, fancy=fancy)
    if backend == "cpu":
        from .runtime import host

        return host.decode_cpu(img, fancy=fancy).astype("int32")
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r}")
    from . import pipeline

    return pipeline.decode(img, device=device, fancy=fancy)


def decode_batch(datas, backend: str = "fsm", **kwargs):
    """Decode a batch of JPEG byte strings -> list of uint8 [H, W, 3].

    Thin wrapper over runtime.batch.BatchDecoder (keyword arguments go to
    its constructor: workers, chunk_size, strict, device, size_buckets,
    fancy, mesh).  strict=True, the default, computes colour exactly on the device (bit-exact with the reference decoder);
    strict=False is the f32 colour of the JAX engine's strict=False.
    The images of one chunk may share one buffer
    (BatchDecoder.decode_parsed)."""
    from .runtime.batch import BatchDecoder

    dec = BatchDecoder(backend=backend, **kwargs)
    try:
        return dec.decode(list(datas))
    finally:
        dec.close()
