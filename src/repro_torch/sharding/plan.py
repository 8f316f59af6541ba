"""ShardingPlan: how a run's tensors map onto the axes of the production
mesh.

Own copy of the dataclass of ``repro/sharding/plan.py``, fields only: the
HELR-mesh deployer (``repro_torch.core.deployer``) produces one as the
description of a candidate plan.  Nothing in the port consumes it yet;
the activation constraints and parameter specs that apply a plan come
with the multi-device slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
