"""paddle_tpu_torch.partition — the logical-axis-rules partitioner
(the port's counterpart of ``paddle_tpu/partition``).

A rules table maps logical tensor axes (``batch``, ``embed``,
``heads``, ``mlp``, ...) onto mesh axes (``dp``, ``tp``, ``ep``);
``PartitionConfig`` resolves the specs of parameters, optimizer state
(ZeRO through the structural accumulator tags) and feeds from it, and
``CompiledProgram.with_partitioning`` runs them::

    from paddle_tpu_torch import partition

    cfg = partition.PartitionConfig(mesh_axes={"dp": 2}, zero=1)
    compiled = fluid.CompiledProgram(main).with_partitioning(cfg)
    exe.run(compiled, feed=local_batch, fetch_list=[loss])

The step executes the ``dp`` axis with ZeRO and a ``tp`` axis (Megatron
tensor parallelism, ``runtime/tp_plan.py``).
"""

from .config import PartitionConfig, ResolvedPartition
from .rules import (DEFAULT_RULES, LogicalAxisRules, parse_mesh, parse_rules,
                    resolve_spec, rules_to_str)

__all__ = [
    "PartitionConfig", "ResolvedPartition", "DEFAULT_RULES",
    "LogicalAxisRules", "parse_mesh", "parse_rules", "resolve_spec",
    "rules_to_str",
]
