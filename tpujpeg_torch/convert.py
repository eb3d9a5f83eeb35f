"""Carry the JAX package's FSM tables and plans across to the port.

`tables_from_jax`, `plan_from_jax` and `spec_plan_from_jax` turn
tpujpeg.ops.fsm's FsmTables, FsmPlan and SpecBatchPlan (numpy arrays and
tuples) into the port's dataclasses, so a test can feed both packages
identical inputs.  The JAX objects are read by
attribute only; this module imports nothing of JAX.  The two-level
symbol map the JAX tables may carry (len_keys, len_vals, symtab) is a
TPU device for the select tree and has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ops import fsm


def tables_from_jax(tables) -> fsm.FsmTables:
    """tpujpeg.ops.fsm.FsmTables -> tpujpeg_torch.ops.fsm.FsmTables."""
    return fsm.FsmTables(**{
        f.name: getattr(tables, f.name)
        for f in dataclasses.fields(fsm.FsmTables)
    })


def plan_from_jax(plan) -> fsm.FsmPlan:
    """tpujpeg.ops.fsm.FsmPlan (one stride group) -> the port's FsmPlan."""
    if len(plan.groups) != 1:
        raise ValueError(
            "the port takes single-group plans (build_plan(split=False))"
        )
    xs, seg_n = plan.groups[0]
    if not np.array_equal(plan.perm, np.arange(len(plan.perm))):
        raise ValueError("single-group plan with a non-identity lane order")
    return fsm.FsmPlan(
        xs=np.asarray(xs),
        seg_n_blocks=np.asarray(seg_n),
        tables=tables_from_jax(plan.tables),
        max_blk=plan.max_blk,
        layout=plan.layout,
        n_blocks_total=plan.n_blocks_total,
    )


def spec_plan_from_jax(plan) -> fsm.SpecBatchPlan:
    """tpujpeg.ops.fsm.SpecBatchPlan -> the port's SpecBatchPlan."""
    fields = {
        f.name: getattr(plan, f.name)
        for f in dataclasses.fields(fsm.SpecBatchPlan)
    }
    fields["tables"] = tables_from_jax(plan.tables)
    return fsm.SpecBatchPlan(**fields)
