"""repro_torch.shard — ring-sharded ConvPlan execution (port of
``repro.shard``).

Extends the plan-once / execute-many stack across a 1-D device ring:
``select_shard_spec`` scores (schedule x partition) jointly — per-shard
MG3M closed-form cost plus a collective term (halo bytes for spatial-H,
reduction bytes for input-channel partitions) plus a fixed per-dispatch
launch cost — and ``ShardedConvPlan`` executes the winner once per ring
position, with ring rotations and an ordered sum as copies between the
ring's devices.  The selector falls back to ``n_shards == 1`` whenever
the collective term makes every partition a predicted loss, so opting a
scene into sharding is never a predicted regression.
"""
from repro_torch.shard.spec import (PARTITION_AXES, UNSHARDED_AXIS,
                                    HaloGeometry, ShardSpec,
                                    collective_bytes, collective_seconds,
                                    halo_geometry, select_shard_spec,
                                    shard_blocker, shard_sub_scene)
from repro_torch.shard.plan import (ShardedConvPlan, assemble_sharded_plan,
                                    make_sharded_plan, pinned_shard_spec)
from repro_torch.shard.autodiff import (ShardedTrainingPlans,
                                        make_sharded_training_plans,
                                        sharded_conv_with_plans)

__all__ = [
    "PARTITION_AXES", "UNSHARDED_AXIS", "HaloGeometry", "ShardSpec",
    "collective_bytes", "collective_seconds", "halo_geometry",
    "select_shard_spec", "shard_blocker", "shard_sub_scene",
    "ShardedConvPlan", "assemble_sharded_plan", "make_sharded_plan",
    "pinned_shard_spec",
    "ShardedTrainingPlans", "make_sharded_training_plans",
    "sharded_conv_with_plans",
]
