"""Program splitting for the parameter-server mode, the port's
counterpart of ``paddle_tpu/ps/transpile.py`` (reference
transpiler/distribute_transpiler.py:540: ``slice_var_up`` splits
params into row blocks across pservers, the trainer program sends and
receives around its gradients, each pserver holds its shards'
optimizer).

``build_ps_programs`` strips the optimizer ops from a copy of the main
Program (the trainer program: forward and backward, on the card) and
records each parameter's update rule, its row shards over the
endpoints and which embedding tables are sparse (an ``is_sparse``
lookup whose ids come straight from a feed). ``launch_pservers`` starts
the servers on threads from a scope's initial values. ``PSTrainer``
runs a step: it prefetches the rows of each sparse table the batch
touches into the scope's table on the card (an ``index_copy_``, no
vocabulary-sized host round trip), runs the trainer program fetching
the gradients, pushes each SelectedRows gradient's unique rows once
(merged where it was computed, ``SelectedRows.merge``: JAX sums them on
the host) and every dense gradient, waits on the barrier in sync mode
with several trainers, and pulls the dense parameters back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.executor import to_numpy
from ..core.framework import Program
from ..core.selected_rows import SelectedRows

_OPT_OPS = {
    "sgd", "momentum", "adam", "adamw", "adagrad", "adamax", "adadelta",
    "rmsprop", "ftrl", "lamb", "lars_momentum", "decayed_adagrad", "dpsgd",
}
# the one-pass fused updates ``optimizer_fuse`` emits (the default on a
# card): the same slots, the server's rule of the unfused op. JAX's list
# lacks them, so a Program minimized with fusion on kept its update ops
# in the trainer program there
_FUSED_OPT_OPS = {"fused_adam": "adam", "fused_momentum": "momentum"}


@dataclasses.dataclass
class PSArtifacts:
    trainer_program: Program
    grad_to_param: Dict[str, str]
    shard_map: Dict[str, List[Tuple[str, int, int]]]  # param -> [(ep, lo, hi)]
    optimizer_specs: Dict[str, Dict]
    endpoints: List[str]
    sync_mode: bool
    trainers: int
    # sparse embedding params (is_sparse lookup_table): param -> ids feed
    # name; their gradients travel as row pushes and only the batch's
    # rows are prefetched (reference distributed_lookup_table_op +
    # parameter_prefetch.cc)
    sparse_params: Dict[str, str] = dataclasses.field(default_factory=dict)
    # per endpoint: shard name -> (param, lo, hi) (get_pserver_program)
    pserver_programs: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    pserver_startups: Dict[str, Dict] = dataclasses.field(default_factory=dict)


def _slice_rows(n_rows: int, n_shards: int):
    """[0, n_rows) as at most n_shards contiguous row ranges."""
    n_shards = max(1, min(n_shards, n_rows))
    per = (n_rows + n_shards - 1) // n_shards
    out, lo = [], 0
    while lo < n_rows:
        hi = min(lo + per, n_rows)
        out.append((lo, hi))
        lo = hi
    return out


def build_ps_programs(main: Program, startup: Program, endpoints: List[str],
                      trainer_id: int, trainers: int, sync_mode: bool,
                      slice_var_up: bool = True) -> PSArtifacts:
    trainer = Program.from_dict(main.to_dict())
    block = trainer.global_block()
    kept = []
    grad_to_param: Dict[str, str] = {}
    optimizer_specs: Dict[str, Dict] = {}
    for op in block.ops:
        if op.type in _OPT_OPS or op.type in _FUSED_OPT_OPS:
            pname, gname = op.inputs["Param"][0], op.inputs["Grad"][0]
            grad_to_param[gname] = pname
            spec = {"type": _FUSED_OPT_OPS.get(op.type, op.type), "lr": 0.01}
            lr_inputs = op.inputs.get("LearningRate", [])
            if lr_inputs:
                spec["lr_var"] = lr_inputs[0]   # read from the scope at launch
            spec.update({k: v for k, v in op.attrs.items()
                         if k in ("beta1", "beta2", "epsilon", "mu",
                                  "use_nesterov")})
            optimizer_specs[pname] = spec
            continue
        kept.append(op)
    block.ops = kept
    trainer._bump()

    # sparse tables: is_sparse lookups whose ids are a feed (only then
    # can the trainer prefetch the batch's rows before the step; ids
    # computed in the Program take the dense pull)
    sparse_params: Dict[str, str] = {}
    for op in kept:
        if op.type in ("lookup_table", "lookup_table_v2") \
                and op.attrs.get("is_sparse"):
            pname, ids_name = op.inputs["W"][0], op.inputs["Ids"][0]
            ids_var = block.var(ids_name) if block.has_var(ids_name) else None
            if pname in grad_to_param.values() and ids_var is not None \
                    and ids_var.is_data:
                sparse_params[pname] = ids_name

    shard_map: Dict[str, List[Tuple[str, int, int]]] = {}
    for i, pname in enumerate(sorted(grad_to_param.values())):
        var = main.global_block().var(pname)
        n_rows = int(var.shape[0]) if var.shape else 1
        ranges = (_slice_rows(n_rows, len(endpoints))
                  if slice_var_up and len(endpoints) > 1 else [(0, n_rows)])
        shard_map[pname] = [(endpoints[(i + j) % len(endpoints)], lo, hi)
                            for j, (lo, hi) in enumerate(ranges)]

    pserver_programs: Dict[str, Dict] = {ep: {} for ep in endpoints}
    for pname, segs in shard_map.items():
        for ep, lo, hi in segs:
            pserver_programs[ep][f"{pname}@{lo}"] = (pname, lo, hi)

    return PSArtifacts(
        trainer_program=trainer, grad_to_param=grad_to_param,
        shard_map=shard_map, optimizer_specs=optimizer_specs,
        endpoints=list(endpoints), sync_mode=sync_mode, trainers=trainers,
        pserver_programs=pserver_programs,
        pserver_startups={ep: {} for ep in endpoints},
        sparse_params=sparse_params)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def server_shards(artifacts: PSArtifacts, scope, endpoint: str):
    """(shards, optimizer specs) one pserver serves, cut from the
    scope's values (the initial ones: run the startup Program first);
    each spec's ``lr_var`` resolved to its value."""
    shards, specs = {}, {}
    for shard_name, (pname, lo, hi) in \
            artifacts.pserver_programs[endpoint].items():
        val = scope.find_var(pname)
        if val is None:
            raise RuntimeError(f"run the startup Program before launching "
                               f"pservers ({pname} is not in the scope)")
        shards[shard_name] = _host(val[lo:hi])   # the server copies it
        spec = dict(artifacts.optimizer_specs.get(pname, {"type": "sgd"}))
        lr_var = spec.pop("lr_var", None)
        if lr_var is not None and scope.find_var(lr_var) is not None:
            spec["lr"] = float(_host(scope.find_var(lr_var)).reshape(-1)[0])
        specs[shard_name] = spec
    return shards, specs


def launch_pservers(artifacts: PSArtifacts, scope) -> List:
    """Start this artifact set's pservers on background threads (tests,
    one host); a deployment runs one ``ParameterServer`` a node
    (``fleet.run_server``, ``distributed.launch_ps``)."""
    from .server import ParameterServer

    servers = []
    for ep in artifacts.endpoints:
        shards, specs = server_shards(artifacts, scope, ep)
        ps = ParameterServer(ep, shards, specs, artifacts.trainers,
                             artifacts.sync_mode)
        ps.start_background()
        servers.append(ps)
    return servers


def put_param(scope, name: str, value: np.ndarray) -> None:
    """Set a pulled parameter into the scope on the device of the value
    it replaces (a new tensor: a step running on another thread keeps
    the one it read)."""
    cur = scope.find_var(name)
    dev = cur.device if isinstance(cur, torch.Tensor) else "cpu"
    scope.set_var(name, torch.from_numpy(np.ascontiguousarray(value)).to(dev))


class PSTrainer:
    """The trainer's side: the gradient step on the card, the pushes,
    the pulls (reference Communicator sync path + send/recv ops)."""

    def __init__(self, artifacts: PSArtifacts, executor, scope,
                 trainer_id: int = 0):
        from .client import PSClient

        self.art = artifacts
        self.exe = executor
        self.scope = scope
        self.client = PSClient(artifacts.endpoints, trainer_id)

    def _refresh_sparse_rows(self, feed):
        """Prefetch the rows of each sparse table this batch touches and
        write them into the scope's table where it lives."""
        for pname, ids_name in self.art.sparse_params.items():
            if ids_name not in feed:
                continue
            rows = np.unique(_host(feed[ids_name]).reshape(-1)).astype(
                np.int64)
            fresh = self.client.prefetch_rows(self.art.shard_map, pname, rows)
            if fresh is None:
                continue
            cur = self.scope.find_var(pname)
            cur.index_copy_(0, torch.from_numpy(rows).to(cur.device),
                            torch.from_numpy(fresh).to(cur.device, cur.dtype))

    def run_step(self, feed, fetch_list):
        self._refresh_sparse_rows(feed)
        grads = list(self.art.grad_to_param)
        outs = self.exe.run(self.art.trainer_program, feed=feed,
                            fetch_list=list(fetch_list) + grads,
                            scope=self.scope, return_numpy=False)
        n = len(fetch_list)
        for gname, gval in zip(grads, outs[n:]):
            pname = self.art.grad_to_param[gname]
            if isinstance(gval, SelectedRows):
                # each row once on the wire: distinct rows, ascending,
                # each the sum of its slices in their order
                merged = gval.merge()
                self.client.push_sparse(
                    self.art.shard_map, pname,
                    _host(merged.rows).astype(np.int64),
                    _host(merged.values))
            else:
                self.client.send_grad(self.art.shard_map, pname, _host(gval))
        if self.art.sync_mode and self.art.trainers > 1:
            # every trainer's gradients land before the update is read
            self.client.barrier()
        for pname in self.art.shard_map:
            if pname in self.art.sparse_params:
                continue   # rows-only, at the top of the next step
            put_param(self.scope, pname,
                      self.client.get_param(self.art.shard_map, pname))
        return [to_numpy(v) for v in outs[:n]]
