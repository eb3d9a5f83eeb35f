"""Events -> dense coefficients (kernel 2 of the port).

Contract of tpujpeg/ops/materialize.py::place_events_v3 and of
fsm._materialize_events: packed events int32 [N, L]
(`blk << 18 | z << 12 | (val + 2048)`, valid when >= 0) go to row
64*blk + z of their lane in an int16 [M, L] tensor; every other row is 0.

On the TPU this takes a stable compaction and a monotone spread through
butterfly networks (the Pallas kernels _fine_compact_rank_kernel and
_fine_spread_kernel plus their XLA coarse stages), because XLA:TPU
scatters serially.  Hopper scatters natively, so the joint contract is
one kernel: per lane, walk the event rows in order and store each event
at its target.  Per-lane targets are strictly increasing, so stores never
collide.

`place_events` launches the CUDA kernel (csrc/materialize.cu) for CUDA
tensors and runs `place_events_plain` for CPU tensors.
"""

from __future__ import annotations

import torch


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
    kernel 2; CPU tensors run the plain version.
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
        "place_events",
        ev.data_ptr(), out.data_ptr(),
        None if err_mal is None else err_mal.data_ptr(),
        N, M, L, kernels.current_stream(ev.device),
    )
    return out
