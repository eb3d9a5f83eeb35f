"""Structured error surface of tpujpeg_torch (own copy of tpujpeg/errors.py).

The reference's only error handling is a CUDA-status wrapper
(`cuda-decoder/src/parser.cu:317-321`); malformed streams hang or crash it.
We surface truncation/bad-marker/bad-table conditions as typed exceptions so
the batch engine can skip-and-report per image instead of dying.
"""


class JpegError(ValueError):
    """Raised for malformed, truncated, or unsupported JPEG streams."""
