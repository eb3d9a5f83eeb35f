"""Chroma upsampling: box (sample replication) and fancy (libjpeg's
triangle filter), on int32 planes with a leading batch axis (plain
PyTorch).

Counterpart of tpujpeg/ops/upsample.py; the batch axis that the JAX
package adds with vmap is written out, so planes are [B, H, W] and the
true sample extents of a bucket-padded chunk are per-image int tensors
[B].  The JAX package has no Pallas kernel here either: everything is
elementwise, static slicing and reshapes.

Semantics (integer-exact to libjpeg's jdsample.c):
  - inputs are clamped JPEG samples in [0, 255] (`upsample_plane` clamps
    the centred IDCT output with +128 first: libjpeg upsamples samples,
    and the clamp changes results near saturation);
  - factor-2 horizontal: out[2i]   = (3*s[i] + s[i-1] + 1) >> 2
                         out[2i+1] = (3*s[i] + s[i+1] + 2) >> 2
    with edge replication;
  - factor 2x2: vertical 3:1 column sums first (unrounded), then the
    horizontal pass with biases 8 (even) / 7 (odd) and >> 4, not two
    rounded passes;
  - other factors (4:1:1's 4x) fall back to box, as libjpeg does.

Shifts are arithmetic on int32 (`>>`, never `//`).  The numpy copy of
the same filter lives in oracle/decoder.py; tests hold the two `==`.
"""

from __future__ import annotations

import torch


def _axis(a: int) -> int:
    """Plane axis 0 (rows) / 1 (columns) of a [B, H, W] tensor."""
    return a + 1


def _edge_prev(s: torch.Tensor, axis: int) -> torch.Tensor:
    """Shift-right neighbour along a plane axis, first sample replicated."""
    d = _axis(axis)
    n = s.shape[d]
    return torch.cat([s.narrow(d, 0, 1), s.narrow(d, 0, n - 1)], dim=d)


def _edge_next(s: torch.Tensor, axis: int, true_n=None) -> torch.Tensor:
    """Shift-left neighbour along a plane axis, last sample replicated.

    true_n (optional int tensor [B]) moves the replication edge from the
    array's padded end to each image's true sample extent: in a
    bucket-padded chunk the plane continues past the real image with
    padding blocks, and the filter's last real output pair must read the
    clamped real neighbour, not a padding sample, to equal the
    exact-geometry decode.  Positions at and past true_n hold padding and
    are cropped by the caller."""
    d = _axis(axis)
    n = s.shape[d]
    nxt = torch.cat([s.narrow(d, 1, n - 1), s.narrow(d, n - 1, 1)], dim=d)
    if true_n is None:
        return nxt
    shape = [1, 1, 1]
    shape[d] = n
    idx = torch.arange(n, dtype=torch.int32, device=s.device).reshape(shape)
    last = (true_n.to(torch.int32) - 1).reshape(-1, 1, 1)
    return torch.where(idx == last, s, nxt)


def _interleave(even: torch.Tensor, odd: torch.Tensor, axis: int):
    d = _axis(axis)
    shape = list(even.shape)
    shape[d] *= 2
    return torch.stack([even, odd], dim=d + 1).reshape(shape)


def _fancy_axis(s, axis: int, bias_even: int, bias_odd: int, shift: int,
                true_n=None):
    """Triangle filter along one axis: 3:1 nearer:further, then >> shift."""
    prev = _edge_prev(s, axis)
    nxt = _edge_next(s, axis, true_n)
    even = (3 * s + prev + bias_even) >> shift
    odd = (3 * s + nxt + bias_odd) >> shift
    return _interleave(even, odd, axis)


def fancy_upsample(s: torch.Tensor, fh: int, fv: int, true_hw=None):
    """Triangle-upsample clamped samples int32 [B, H, W] by (fh, fv) in
    {1, 2}.

    h2v1 / h1v2 are a single rounded pass; h2v2 keeps the vertical 3:1
    column sums unrounded and rounds once in the horizontal pass (biases
    8/7, >> 4).  true_hw: optional (true_h, true_w) int tensors [B], each
    image's real sample extent inside a bucket-padded plane (see
    `_edge_next`)."""
    th, tw = true_hw if true_hw is not None else (None, None)
    if fh == 2 and fv == 2:
        cs_even = 3 * s + _edge_prev(s, 0)       # column sums, even rows
        cs_odd = 3 * s + _edge_next(s, 0, th)    # ... and odd output rows
        return _interleave(_fancy_axis(cs_even, 1, 8, 7, 4, tw),
                           _fancy_axis(cs_odd, 1, 8, 7, 4, tw), 0)
    if fh == 2 and fv == 1:
        return _fancy_axis(s, 1, 1, 2, 2, tw)
    if fh == 1 and fv == 2:
        return _fancy_axis(s, 0, 1, 2, 2, th)
    if fh == 1 and fv == 1:
        return s
    raise ValueError(
        f"fancy upsampling only supports factors 1-2, got {fh}x{fv}")


def box_upsample(s: torch.Tensor, fh: int, fv: int) -> torch.Tensor:
    """Sample replication of [B, H, W] by (fh, fv)."""
    if fh > 1:
        s = torch.repeat_interleave(s, fh, dim=2)
    if fv > 1:
        s = torch.repeat_interleave(s, fv, dim=1)
    return s


def upsample_plane(plane: torch.Tensor, fh: int, fv: int, fancy: bool,
                   true_hw=None) -> torch.Tensor:
    """Upsample centred int32 planes [B, H, W] ([-256, 255] IDCT output)
    by (fh, fv).

    fancy=True clamps to samples first (libjpeg's order: range limit,
    then triangle filter) and re-centres after; factors above 2 fall back
    to box either way.  true_hw: per-image real sample extents of
    bucket-padded planes (box replication is pointwise and needs
    none)."""
    if fh == 1 and fv == 1:
        return plane
    if fancy and fh <= 2 and fv <= 2:
        samples = torch.clamp(plane + 128, 0, 255)
        return fancy_upsample(samples, fh, fv, true_hw) - 128
    return box_upsample(plane, fh, fv)
