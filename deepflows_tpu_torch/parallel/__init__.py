"""Mesh parallelism on ``torch.distributed`` (counterpart of
``deepflows_tpu/parallel/``): one process per rank, a ``DeviceMesh``
with the JAX package's axis names, parameters and optimizer slots stored
as DTensor blocks placed by the JAX package's rules, data / tensor / FSDP /
ZeRO-1 / expert-parallel training steps whose results are the unsharded
step's, sequence constraints, ring attention, and pipeline parallelism
(``PipelineStack``, ``pipeline_apply`` and ``PipelinedTrainStep`` with the
GPipe, 1F1B and interleaved 1F1B schedules) on point-to-point messages
over the pipe axis."""

from .mesh import (P, PartitionSpec, auto_mesh, batch_sharding, init_process_group,
                   make_mesh, optimizer_state_shardings, replicated)
from .pipeline import PipelinedTrainStep, PipelineStack, pipeline_apply
from .ring import ring_attention
from .sequence import ShardConstraint, sequence_sharding
from .sharded import (ShardedEvalStep, ShardedTrainStep, expert_parallel_rules, fsdp_rules,
                      tensor_parallel_rules)

__all__ = [
    "make_mesh",
    "PipelineStack",
    "PipelinedTrainStep",
    "pipeline_apply",
    "auto_mesh",
    "replicated",
    "batch_sharding",
    "ShardedTrainStep",
    "ShardedEvalStep",
    "tensor_parallel_rules",
    "ShardConstraint",
    "ring_attention",
    "sequence_sharding",
    "expert_parallel_rules",
    "fsdp_rules",
    "P",
    "PartitionSpec",
    "init_process_group",
    "optimizer_state_shardings",
]
