"""ShardingPlan: how a run's tensors map onto the axes of the mesh, and the
activation specs the model code reads from it.  Port of
``repro/sharding/plan.py``.

The HELR-mesh deployer (``repro_torch.core.deployer``) produces a plan;
the model code consumes it under a mesh (``repro_torch.sharding.mesh``),
and ``repro_torch.sharding.specs`` turns it into the parameter and cache
layouts.  A spec is a tuple with one entry a dimension: None (not
sharded), an axis name, or a tuple of axis names (sharded over their
product, row-major); ``()`` is replicated.  Sizes are read against
``current_mesh()`` (``axis_size`` and ``divisible`` of
``repro_torch.sharding.mesh``): an axis the mesh lacks, or no mesh at
all, has size 1, so a plan without a mesh runs unsharded, as in the
reference.

The reference's ``constrain`` has no counterpart: under GSPMD it states a
layout and XLA moves the data; here each rank holds its shard and the
model code moves it with explicit collectives
(``repro_torch.distributed.collectives``): the batch split and the logits'
gather in ``models.transformer``, the all-gather and reduce-scatter of
the sequence-parallel residual, the psum of a row-parallel product.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.sharding.mesh import axis_size


@dataclass(frozen=True)
class ShardingPlan:
    batch_axes: tuple[str, ...] = ()        # activation batch dims
    model_axis: Optional[str] = None        # tensor parallelism
    fsdp_axes: tuple[str, ...] = ()         # ZeRO-3 param sharding
    seq_axes: tuple[str, ...] = ()          # KV-cache sequence sharding (decode)
    ep_axis: Optional[str] = None           # expert parallelism
    seq_parallel: bool = False              # residuals sharded over model axis
    mla_absorbed: bool = True               # matmul-absorbed MLA decode
    # training-plan fields
    remat: bool = False
    microbatches: int = 1


def splits_batch(plan: Optional[ShardingPlan], rows: int) -> bool:
    """Whether ``rows`` rows are split over ``plan``'s batch axes: they
    have more than one shard and divide the rows.  A batch they do not
    divide runs whole on every rank, as the reference's GSPMD runs it under
    a batch-only plan (the paged engine's one-prompt prefills, or 3 slots
    over 4 shards); under a model or sequence axis it raises ValueError,
    as the port always has (its model-parallel paths take whole shards)."""
    if plan is None or not plan.batch_axes:
        return False
    n = axis_size(plan.batch_axes)
    if n == 1:
        return False
    if rows % n == 0:
        return True
    if plan.model_axis is not None or plan.seq_axes:
        raise ValueError(f"{rows} rows do not split over the batch axes "
                         f"{plan.batch_axes} ({n} shards) of a plan with a "
                         "model or sequence axis")
    return False


def batch_spec(plan: Optional[ShardingPlan], ndim: int,
               batch_dim: int = 0) -> tuple:
    if plan is None:
        return ()
    parts: list = [None] * ndim
    if plan.batch_axes:
        parts[batch_dim] = plan.batch_axes if len(plan.batch_axes) > 1 \
            else plan.batch_axes[0]
    return tuple(parts)


def resid_spec(plan: Optional[ShardingPlan], shape: tuple[int, ...]) -> tuple:
    """Residual-stream spec between blocks for the global ``shape``:
    batch-sharded, and with sequence parallelism seq-sharded over the model
    axis when the sequence divides it (Megatron sequence parallelism)."""
    spec = batch_spec(plan, len(shape))
    if (plan is not None and plan.seq_parallel and plan.model_axis
            and len(shape) >= 3 and axis_size(plan.model_axis) > 1
            and shape[1] % axis_size(plan.model_axis) == 0):
        parts = list(spec)
        parts[1] = plan.model_axis
        return tuple(parts)
    return spec
