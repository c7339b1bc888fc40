"""Downpour-style distributed training config (pslib surface), the
port's counterpart of ``paddle_tpu/ps/downpour.py``.

Reference: framework/fleet/fleet_wrapper.h:84-121 (pull/push sparse by
table id), framework/device_worker.h:203 (DownpourWorker's per-table
slot maps), python/paddle/fluid/incubate/fleet/parameter_server/pslib/
optimizer_factory.py (DistributedAdam builds DownpourServer/
DownpourWorker descs from the program) and node.py (DownpourServer
add_sparse_table/add_dense_table).

The descs configure the same socket PS runtime (ps/server
applies per-shard update rules; sparse rows ride SelectedRows pushes) —
a table id groups params under one accessor (update rule + lr), the
reference's per-slot accessor config, without protobuf."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..core.framework import Variable


_SPARSE_ACCESSORS = {
    # accessor name -> server-side update rule (ps/server.py _ShardState)
    "DownpourSparseValueAccessor": "sgd",
    "sparse_sgd": "sgd",
    "sparse_adagrad": "adagrad",
    "DownpourCtrAccessor": "adagrad",
}


@dataclasses.dataclass
class TableConfig:
    table_id: int
    type: str  # "sparse" | "dense"
    accessor: str
    learning_rate: float
    param_names: List[str]
    grad_names: List[str]
    slot_key_names: List[str] = dataclasses.field(default_factory=list)
    fea_dim: int = 0


class DownpourServer:
    """Reference pslib/node.py DownpourServer."""

    def __init__(self):
        self.tables: Dict[int, TableConfig] = {}

    def add_sparse_table(self, table_id, learning_rate, slot_key_vars,
                         slot_value_vars, accessor="sparse_adagrad"):
        if accessor not in _SPARSE_ACCESSORS:
            raise ValueError(
                f"unknown sparse accessor {accessor!r}; "
                f"one of {sorted(_SPARSE_ACCESSORS)}"
            )
        self.tables[table_id] = TableConfig(
            table_id=table_id, type="sparse", accessor=accessor,
            learning_rate=float(learning_rate),
            param_names=[v.name if isinstance(v, Variable) else str(v)
                         for v in slot_value_vars],
            grad_names=[],
            slot_key_names=[v.name if isinstance(v, Variable) else str(v)
                            for v in slot_key_vars],
            fea_dim=int(slot_value_vars[0].shape[-1]) if slot_value_vars else 0,
        )

    def add_dense_table(self, table_id, learning_rate, param_vars, grad_vars,
                        accessor="DownpourDenseValueAccessor"):
        self.tables[table_id] = TableConfig(
            table_id=table_id, type="dense", accessor=accessor,
            learning_rate=float(learning_rate),
            param_names=[v.name if isinstance(v, Variable) else str(v)
                         for v in param_vars],
            grad_names=[v.name if isinstance(v, Variable) else str(v)
                        for v in grad_vars],
        )


class DownpourWorker:
    """Reference pslib/node.py DownpourWorker: the trainer-side mirror
    of the server tables (which vars to pull/push per table id)."""

    def __init__(self, window=1):
        self.window = window
        self.tables: Dict[int, TableConfig] = {}

    def add_table(self, cfg: TableConfig):
        self.tables[cfg.table_id] = cfg


class DownpourSGD:
    """Reference pslib/optimizer_factory.py DistributedAdam-style
    factory: walks the program, assigns each is_sparse embedding its
    own sparse table (server-side accessor update) and all dense params
    one dense table, then produces the PS artifacts with per-table
    optimizer specs."""

    def __init__(self, learning_rate=0.001, window=1,
                 sparse_accessor="sparse_adagrad", dense_rule="sgd"):
        self.learning_rate = float(learning_rate)
        self.window = window
        self.sparse_accessor = sparse_accessor
        self.dense_rule = dense_rule
        self.server = DownpourServer()
        self.worker = DownpourWorker(window)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..optimizer import SGDOptimizer

        # in-program update ops give build_ps_programs its spec source;
        # the server-side rules below override them per table
        inner = SGDOptimizer(self.learning_rate)
        opt_ops, params_grads = inner.minimize(
            loss, startup_program, parameter_list, no_grad_set
        )
        program = loss.block.program
        block = program.global_block()

        sparse_params = []
        for op in block.ops:
            if op.type in ("lookup_table", "lookup_table_v2") and op.attrs.get(
                    "is_sparse"):
                w = block.var(op.inputs["W"][0])
                ids = op.inputs["Ids"][0]
                sparse_params.append((w, ids))
        table_id = 0
        for w, ids in sparse_params:
            self.server.add_sparse_table(
                table_id, self.learning_rate, [block.var(ids)], [w],
                accessor=self.sparse_accessor,
            )
            self.worker.add_table(self.server.tables[table_id])
            table_id += 1
        sparse_names = {w.name for w, _ in sparse_params}
        dense = [(p, g) for p, g in params_grads if p.name not in sparse_names]
        if dense:
            self.server.add_dense_table(
                table_id, self.learning_rate,
                [p for p, _ in dense], [g for _, g in dense],
            )
            self.worker.add_table(self.server.tables[table_id])
        program._downpour_tables = self.server.tables
        return opt_ops, params_grads

    def apply_to_artifacts(self, artifacts):
        """Override the PS artifacts' per-param optimizer specs with
        the table accessors (reference: the server desc, not the
        trainer program, owns sparse update rules)."""
        for cfg in self.server.tables.values():
            rule = (
                _SPARSE_ACCESSORS[cfg.accessor]
                if cfg.type == "sparse" else self.dense_rule
            )
            for pname in cfg.param_names:
                artifacts.optimizer_specs[pname] = {
                    "type": rule, "lr": cfg.learning_rate,
                }
        return artifacts
