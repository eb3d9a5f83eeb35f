"""Carry the JAX package's parsed images, FSM tables and plans across to
the port.

`image_from_jax` turns a tpujpeg.io.parser.JpegImage into the port's own
JpegImage (field by field, numpy arrays shared); `tables_from_jax`,
`plan_from_jax`, `bucket_plan_from_jax` and `spec_plan_from_jax` turn
tpujpeg.ops.fsm's FsmTables, FsmPlan, FsmBucketPlan and SpecBatchPlan
(numpy arrays and tuples), and `segment_plan_from_jax`
tpujpeg.ops.entropy's SegmentPlan, into the port's dataclasses, so a
test can feed both packages identical inputs.  The JAX objects are read by
attribute only; this module imports nothing of JAX.  The two-level
symbol map the JAX tables may carry (len_keys, len_vals, symtab) is a
TPU device for the select tree and has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .io.huffman import HuffmanTable
from .io.parser import Component, JpegImage
from .ops import entropy, fsm


def image_from_jax(img) -> JpegImage:
    """tpujpeg.io.parser.JpegImage -> the port's JpegImage, field by
    field; numpy arrays (tables, scan bytes, segment offsets) are shared,
    not copied."""
    return JpegImage(
        width=img.width,
        height=img.height,
        precision=img.precision,
        components=[
            Component(**{f.name: getattr(c, f.name)
                         for f in dataclasses.fields(Component)})
            for c in img.components
        ],
        quant_tables=dict(img.quant_tables),
        huffman={h: HuffmanTable(t.counts, t.symbols)
                 for h, t in img.huffman.items()},
        restart_interval=img.restart_interval,
        scan_data=img.scan_data,
        segment_offsets=img.segment_offsets,
        path=img.path,
    )


def tables_from_jax(tables) -> fsm.FsmTables:
    """tpujpeg.ops.fsm.FsmTables -> tpujpeg_torch.ops.fsm.FsmTables."""
    return fsm.FsmTables(**{
        f.name: getattr(tables, f.name)
        for f in dataclasses.fields(fsm.FsmTables)
    })


def plan_from_jax(plan) -> fsm.FsmPlan:
    """tpujpeg.ops.fsm.FsmPlan -> the port's FsmPlan (its stride groups
    and lane permutation as they are)."""
    return fsm.FsmPlan(
        groups=tuple((np.asarray(xs), np.asarray(sn))
                     for xs, sn in plan.groups),
        perm=np.asarray(plan.perm),
        tables=tables_from_jax(plan.tables),
        max_blk=plan.max_blk,
        layout=plan.layout,
        n_blocks_total=plan.n_blocks_total,
    )


def bucket_plan_from_jax(plan) -> fsm.FsmBucketPlan:
    """tpujpeg.ops.fsm.FsmBucketPlan -> the port's FsmBucketPlan."""
    fields = {
        f.name: getattr(plan, f.name)
        for f in dataclasses.fields(fsm.FsmBucketPlan)
    }
    fields["tables"] = tables_from_jax(plan.tables)
    return fsm.FsmBucketPlan(**fields)


def spec_plan_from_jax(plan) -> fsm.SpecBatchPlan:
    """tpujpeg.ops.fsm.SpecBatchPlan -> the port's SpecBatchPlan."""
    fields = {
        f.name: getattr(plan, f.name)
        for f in dataclasses.fields(fsm.SpecBatchPlan)
    }
    fields["tables"] = tables_from_jax(plan.tables)
    return fsm.SpecBatchPlan(**fields)


def segment_plan_from_jax(plan) -> entropy.SegmentPlan:
    """tpujpeg.ops.entropy.SegmentPlan -> the port's SegmentPlan (numpy
    fields as numpy arrays, cap and n_blocks_total as ints)."""
    fields = {
        f.name: getattr(plan, f.name)
        for f in dataclasses.fields(entropy.SegmentPlan)
    }
    for name, v in fields.items():
        fields[name] = int(v) if name in ("cap", "n_blocks_total") \
            else np.asarray(v)
    return entropy.SegmentPlan(**fields)
