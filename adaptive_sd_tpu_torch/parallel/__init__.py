"""Tensor parallelism on ``torch.distributed`` (counterpart of
``adaptive_sd_tpu/parallel``): meshes of ranks and their process groups,
the rank launcher, the replicated fallback, and the ring overlap of the
row-parallel sublayer ending."""

from .mesh import (
    AXIS_DCN,
    AXIS_DP,
    AXIS_TP,
    Mesh,
    TierPlacement,
    TPGroup,
    build_mesh,
    build_multihost_mesh,
    plan_tier_placements,
    spawn_ranks,
)

__all__ = [
    "AXIS_DCN", "AXIS_DP", "AXIS_TP", "Mesh", "TPGroup", "TierPlacement", "build_mesh",
    "build_multihost_mesh", "plan_tier_placements", "spawn_ranks",
]
