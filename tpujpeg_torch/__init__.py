"""tpujpeg_torch — the PyTorch/CUDA port of tpujpeg for NVIDIA Hopper.

Batch decode of baseline 4:4:4 streams, with or without restart
markers, of one exact size or of mixed sizes (size-class buckets), runs
on the card through hand-written CUDA kernels (csrc/): the Huffman
symbol FSM scan (restart lanes, bucket-raster emission, the speculative
modes), the events -> dense coefficient scatter and its two other
routes (offset compaction, full-height compaction and spread), the slot
route's compact, unpack and expand, and the fused dequant + IDCT +
colour pixel stage.

The package stands alone: it keeps its own copy of the host layer
(errors, constants, io/, oracle/, runtime/host.py, runtime/native/) and
imports neither jax nor the tpujpeg package.

The device is always explicit; the default is "cuda".
"""

from .errors import JpegError

__all__ = ["JpegError", "decode", "decode_batch"]


def decode(data, backend: str = "cuda", device="cuda"):
    """Decode a JPEG (path or bytes) to an int32 [H, W, 3] RGB array.

    backend='cuda' runs host entropy decode, then the port's pixel stage on
    `device` with strict repair (bit-exact with the reference decoder);
    backend='oracle' runs the NumPy reference decoder.
    """
    from .io.parser import parse, parse_file

    img = parse_file(data) if isinstance(data, str) else parse(data)
    if backend == "oracle":
        from .oracle import decoder as oracle

        return oracle.decode(img)
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r}")
    from . import pipeline

    return pipeline.decode(img, device=device)


def decode_batch(datas, **kwargs):
    """Decode a batch of JPEG byte strings -> list of uint8 [H, W, 3].

    Thin wrapper over runtime.batch.BatchDecoder (keyword arguments go to
    its constructor)."""
    from .runtime.batch import BatchDecoder

    dec = BatchDecoder(**kwargs)
    try:
        return dec.decode(list(datas))
    finally:
        dec.close()
