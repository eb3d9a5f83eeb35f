"""tpujpeg_torch — the PyTorch/CUDA port of tpujpeg for NVIDIA Hopper.

Batch decode of baseline 4:4:4 streams, with or without restart
markers, runs on the card through six hand-written CUDA kernels
(csrc/): the Huffman symbol FSM scan (restart lanes and the speculative
modes), the events -> dense coefficient scatter, the slot route's
compact, unpack and expand, and the fused dequant + IDCT + colour pixel
stage.
The JAX-free host layer of tpujpeg (parser, oracle, native C++ entropy
decoder) is shared, not copied.  This package never imports jax.

The device is always explicit; the default is "cuda".
"""

from tpujpeg.errors import JpegError

__all__ = ["JpegError", "decode", "decode_batch"]


def decode(data, backend: str = "cuda", device="cuda"):
    """Decode a JPEG (path or bytes) to an int32 [H, W, 3] RGB array.

    backend='cuda' runs host entropy decode, then the port's pixel stage on
    `device` with strict repair (bit-exact with the reference decoder);
    backend='oracle' runs the NumPy reference decoder.
    """
    from tpujpeg.io.parser import parse, parse_file

    img = parse_file(data) if isinstance(data, str) else parse(data)
    if backend == "oracle":
        from tpujpeg.oracle import decoder as oracle

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
