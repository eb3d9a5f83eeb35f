"""Shape-ladder accounting of mixed-size serving (own copy of
tpujpeg/runtime/ladder.py).

PyTorch runs eagerly and the CUDA kernels are compiled once for every
shape, so nothing here is compiled per key.  What the ladder bounds in
the port is the number of distinct tensor shapes a mixed-size corpus can
mint: with `size_buckets=True` a chunk's shapes depend only on (MCU-grid
bucket, restart row-class k, byte-stride class), never on the exact
geometries in it, which is what lets an allocator or a captured CUDA
graph be reused across chunks.  This module makes that bound explicit and
testable for a declared corpus envelope (tests/test_torch_buckets.py).
"""

from __future__ import annotations

from ..ops import fsm
from ..pipeline import bucket_up


def stride_ladder(max_seg_bytes: int) -> tuple:
    """All reachable scan-stride classes for segments up to the bound.

    Mirrors fsm._stride_bucket: powers of two to 1 KiB, then 512-byte
    steps.
    """
    out = []
    for s in (64, 128, 256, 512, 1024):
        out.append(s)
        if s >= max_seg_bytes:
            return tuple(out)
    s = 1536
    while s < max_seg_bytes + 512:
        out.append(s)
        s += 512
    return tuple(out)


def mcu_bucket_ladder(max_mcus: int) -> tuple:
    """All reachable bucket_up values (geometric ladder, ratio 1.3)."""
    out = [4]
    while out[-1] < max_mcus:
        out.append(bucket_up(out[-1] + 1))
    return tuple(out)


def bucketed_keys(
    max_px: int,
    max_seg_bytes: int,
    k_values: tuple = (1,),
    mcu_px: int = 8,
    max_blk_cap: int | None = 512,
) -> list:
    """Enumerate every (bucket_mcus_x, bucket_mcus_y, k, stride) key the
    bucketed device decode can mint for a corpus envelope of images up to
    max_px on a side with restart segments up to max_seg_bytes.

    max_blk_cap drops buckets whose row capacity max_blk = k * bx * 3
    (4:4:4) exceeds it.  The default 512 is the JAX engine's int16 gate
    (max_blk * 64 <= 32768 dense rows), past which it sends such chunks to
    the host-bucketed route; None is the port's engine, whose scatter has
    no such gate (only the packed event's 8191-block field bounds a lane).
    """
    if max_blk_cap is None:
        max_blk_cap = fsm.MAX_BLOCKS_PER_LANE
    max_mcus = -(-max_px // mcu_px)
    grid = mcu_bucket_ladder(max_mcus)
    strides = stride_ladder(max_seg_bytes)
    keys = []
    for k in k_values:
        for bx in grid:
            if k * bx * 3 > max_blk_cap:
                continue
            for by in grid:
                for s in strides:
                    keys.append((bx, by, k, s))
    return keys


def observed_key(plan: fsm.FsmBucketPlan, bucket) -> tuple:
    """The ladder key of a packed bucket plan."""
    return (bucket.mcus_x, bucket.mcus_y, plan.k, plan.lanes.stride)
