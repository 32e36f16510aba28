"""Host-side graph preprocessing and the multi-process paths. Counterpart of
``dgll_tpu/parallel``: community detection (COG) and node reordering for the
windowed SpMM layout (``community``, ``reorder``); the launch and process groups
(``launch``, ``mesh``), data parallelism (``dp``, and ``train.DeviceDPEpochRunner``),
graph partitioning and graph-partition-parallel full-graph training (``partition``,
``gp``, and ``halo``: the halo exchange, whose local sum may go through the windowed
kernel), and tensor parallelism (``tp``).

The names below load their module on first use, so that importing the host
preprocessing does not import the trainers."""
import importlib

_EXPORTS = {
    "PendingGrads": "dp", "ShardedDataLoader": "dp", "apply_grads": "dp",
    "make_async_dp_block_step": "dp", "make_dp_block_step": "dp",
    "stack_block_lists": "dp",
    "GraphShard": "gp", "make_gp_gcn_train_step": "gp", "make_sharded_spmm": "gp",
    "shard_partitioned_graph": "gp",
    "HaloPlan": "halo", "ShardWindowed": "halo", "allgather_volume_bytes": "halo",
    "build_halo_plan": "halo", "build_shard_windowed": "halo",
    "halo_volume_bytes": "halo", "make_halo_spmm": "halo",
    "make_halo_spmm_windowed": "halo", "make_partitioned_spmm": "halo",
    "initialize_distributed": "launch", "is_primary": "launch", "launch_local": "launch",
    "Mesh": "mesh", "make_mesh": "mesh", "replicated": "mesh", "sharded_dim0": "mesh",
    "PartitionedGraph": "partition", "partition_graph": "partition",
    "init_tp_gcn_params": "tp", "make_feature_sharded_spmm": "tp",
    "make_tp_gcn_apply": "tp", "replicate": "tp", "shard_features": "tp",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
