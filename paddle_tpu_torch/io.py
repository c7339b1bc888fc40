"""Save and load persistables and inference models (counterpart of
``paddle_tpu/io.py``: ``save_vars`` ... ``load_inference_model``,
:46-231, and the program-state helpers, :810-861).

The file format is the JAX package's, so a directory written by either
package loads in the other:

  * ``__params__.npz``: every persistable by name (``np.savez``);
  * ``__model__``: JSON ``{"program", "feed_names", "fetch_names"}``,
    the pruned inference Program's ``to_dict()``;
  * ``save(program, path)``: ``path.pdparams.npz`` and
    ``path.pdmodel.json``.

As in the reference, the scope is the current ``global_scope()``
(``scope_guard`` selects another). Loaded arrays become tensors on the
executor's device (CUDA when ``executor`` is None), in the dtype the
program declares for each variable. bfloat16 tensors are written as
float32 (numpy has no bfloat16); a JAX-written bfloat16 array (2-byte
void, or ``ml_dtypes.bfloat16``) is read back bit for bit.

Committed checkpoints (``paddle_tpu/io.py:200-808``):
``save_checkpoint`` / ``load_checkpoint`` / ``load_checkpoint_arrays``,
the commit marker ``_PT_COMMIT.json`` with its manifest
(``write_commit_marker``, ``read_commit_marker``,
``is_committed_checkpoint``), ``latest_checkpoint`` /
``committed_checkpoint_steps`` and the two-phase multi-process commit
(``write_shard_done``, ``done_shard_ranks``,
``finalize_two_phase_commit``, ``CheckpointCommitTimeout``). The port
always writes the JAX package's multi-host layout
(``__shards__.rank<k>.npz`` + ``__shards__.meta.json``), with a world of
1 in one process, so the JAX package's ``load_checkpoint`` reads it;
the world comes from ``_FORCE_DIST`` or an initialised
``torch.distributed``. The JAX single-process save writes orbax's OCDBT
layout, which needs orbax and tensorstore: the port refuses it with a
``ValueError`` that says how to rewrite it.

Besides the reference's API, the port's GPT serving path reads a saved
``build_lm_program`` directory with ``read_params_file`` /
``load_model_meta`` / ``gpt_config_from_model``, and
``load_scope_arrays`` carries a JAX scope's arrays into a port scope.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .core import framework
from .core.executor import global_scope, to_numpy, torch_dtype
from .core.framework import Parameter, Program, Variable
from .device import resolve_device
from .flags import flag
from .models.gpt import GPTConfig

__all__ = [
    "PARAMS_FILE", "MODEL_FILE",
    "get_program_parameter", "get_program_persistable_vars",
    "load_program_state", "set_program_state",
    "save_vars", "save_params", "save_persistables",
    "load_vars", "load_params", "load_persistables",
    "save", "load", "save_inference_model", "load_inference_model",
    "read_params_file", "load_model_meta", "gpt_config_from_model",
    "load_scope_arrays", "array_to_tensor",
    "save_checkpoint", "load_checkpoint", "load_checkpoint_arrays",
    "latest_checkpoint", "committed_checkpoint_steps",
    "write_commit_marker", "read_commit_marker", "is_committed_checkpoint",
    "write_shard_done", "done_shard_ranks", "finalize_two_phase_commit",
    "CheckpointCommitTimeout", "batch",
]

PARAMS_FILE = "__params__.npz"
MODEL_FILE = "__model__"


def _persistable_vars(program: Program) -> List[Variable]:
    return [v for v in program.global_block().vars.values()
            if v.persistable and not v.is_data]


def _device(executor) -> torch.device:
    return executor.device if executor is not None else resolve_device(None)


def array_to_tensor(arr, dtype=None, device="cpu") -> torch.Tensor:
    """A numpy array (a copy) as a tensor on ``device`` in ``dtype``
    (a Program dtype spec; the array's own when None). A bfloat16
    array as numpy holds it without ml_dtypes (2-byte void) or with
    it (``bfloat16``) is taken bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t.to(device)


def _save_arrays(path: str, names, scope) -> None:
    arrays = {}
    for name in names:
        val = scope.find_var(name)
        if val is None:
            continue
        arrays[name] = (to_numpy(val) if isinstance(val, torch.Tensor)
                        else np.asarray(val))
    np.savez(path, **arrays)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.global_block().vars.values()
                if predicate is None or predicate(v)]
    os.makedirs(dirname, exist_ok=True)
    _save_arrays(os.path.join(dirname, filename or PARAMS_FILE),
                 [v.name for v in vars], global_scope())


def save_params(executor, dirname, main_program=None, filename=None):
    main_program = main_program or framework.default_main_program()
    save_vars(executor, dirname, main_program,
              vars=list(main_program.all_parameters()), filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    main_program = main_program or framework.default_main_program()
    save_vars(executor, dirname, main_program,
              vars=_persistable_vars(main_program), filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.global_block().vars.values()
                if predicate is None or predicate(v)]
    device = _device(executor)
    scope = global_scope()
    with np.load(os.path.join(dirname, filename or PARAMS_FILE)) as data:
        for v in vars:
            if v.name in data:
                scope.set_var(v.name, array_to_tensor(data[v.name], v.dtype,
                                                      device))


def load_params(executor, dirname, main_program=None, filename=None):
    main_program = main_program or framework.default_main_program()
    load_vars(executor, dirname, main_program,
              vars=list(main_program.all_parameters()), filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    main_program = main_program or framework.default_main_program()
    load_vars(executor, dirname, main_program,
              vars=_persistable_vars(main_program), filename=filename)


def save(program: Program, model_path: str):
    """Whole-state save (reference io.py:1507): the program's JSON and
    every persistable."""
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    _save_arrays(model_path + ".pdparams.npz",
                 [v.name for v in _persistable_vars(program)], global_scope())
    with open(model_path + ".pdmodel.json", "w") as f:
        f.write(program.to_json())


def load(program: Program, model_path: str, executor=None):
    """Every array of ``save``'s params file into the scope, in the
    dtype ``program`` declares for it (the array's own for a name the
    program lacks)."""
    block = program.global_block()
    device = _device(executor)
    scope = global_scope()
    with np.load(model_path + ".pdparams.npz") as data:
        for name in data.files:
            dt = block.var(name).dtype if block.has_var(name) else None
            scope.set_var(name, array_to_tensor(data[name], dt, device))


def _prune_program(program: Program, feed_names, target_vars) -> Program:
    """Keep only the ops needed to compute the targets (reference
    Program._prune): a walk back from the targets over the ops'
    inputs."""
    pruned = Program.from_dict(program.to_dict())
    block = pruned.global_block()
    needed = {v.name if isinstance(v, Variable) else str(v)
              for v in target_vars}
    keep = []
    for op in reversed(block.ops):
        if set(op.output_arg_names) & needed:
            keep.append(op)
            needed |= set(op.input_arg_names)
    block.ops = list(reversed(keep))
    pruned._bump()
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    main_program = main_program or framework.default_main_program()
    os.makedirs(dirname, exist_ok=True)
    inference_program = _prune_program(main_program, feeded_var_names,
                                       target_vars)
    meta = {
        "program": inference_program.to_dict(),
        "feed_names": list(feeded_var_names),
        "fetch_names": [v.name if isinstance(v, Variable) else str(v)
                        for v in target_vars],
    }
    with open(os.path.join(dirname, model_filename or MODEL_FILE), "w") as f:
        json.dump(meta, f)
    if not program_only:
        save_persistables(executor, dirname, inference_program,
                          params_filename)
    return meta["fetch_names"]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """(program, feed names, fetch Variables), the persistables loaded
    into the current scope on the executor's device."""
    meta = load_model_meta(dirname, model_filename)
    program = Program.from_dict(meta["program"])
    load_persistables(executor, dirname, program, params_filename)
    block = program.global_block()
    fetch_vars = [block.var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def get_program_parameter(program):
    """Every Parameter of the program's global block."""
    return [v for v in program.global_block().vars.values()
            if isinstance(v, Parameter)]


def get_program_persistable_vars(program):
    return _persistable_vars(program)


def load_program_state(model_path, var_list=None) -> Dict[str, np.ndarray]:
    """A saved state as {name: numpy array}: from the file itself,
    ``path.npz``, ``save``'s ``path.pdparams.npz`` or ``path.pdparams``,
    or a directory of per-variable ``.npy`` files."""
    candidates = [model_path, model_path + ".npz",
                  model_path + ".pdparams.npz", model_path + ".pdparams"]
    archive = next((c for c in candidates if os.path.isfile(c)), None)
    if archive is not None:
        with np.load(archive) as z:
            state = {k: z[k] for k in z.files}
    else:
        state = {fn[:-4]: np.load(os.path.join(model_path, fn))
                 for fn in os.listdir(model_path) if fn.endswith(".npy")}
    if var_list is not None:
        names = {v.name if hasattr(v, "name") else str(v) for v in var_list}
        state = {k: v for k, v in state.items() if k in names}
    return state


def set_program_state(program, state_dict, device=None) -> int:
    """Write the state's values of the program's persistables into the
    current scope (on ``device``, CUDA when None); returns how many."""
    dev = resolve_device(device)
    scope = global_scope()
    n = 0
    for v in _persistable_vars(program):
        if v.name in state_dict:
            scope.set_var(v.name, array_to_tensor(state_dict[v.name], v.dtype,
                                                  dev))
            n += 1
    return n


# -- the GPT serving path's readers ----------------------------------------


def read_params_file(dirname: str,
                     filename: str = None) -> Dict[str, np.ndarray]:
    """Every array of the directory's params file, by name."""
    path = os.path.join(dirname, filename or PARAMS_FILE)
    with np.load(path) as data:
        return {name: np.asarray(data[name]) for name in data.files}


def load_model_meta(dirname: str, filename: str = None) -> Dict[str, Any]:
    """The ``__model__`` JSON: ``program``, ``feed_names``,
    ``fetch_names``."""
    with open(os.path.join(dirname, filename or MODEL_FILE)) as f:
        return json.load(f)


def _num_heads(meta: Dict[str, Any]) -> int:
    """Heads of the attention: the first 4-D ``reshape2`` target shape
    ``[0, 0, heads, head_dim]`` of the program (how
    ``nets.scaled_dot_product_attention`` splits heads)."""
    for block in meta["program"]["blocks"]:
        for op in block["ops"]:
            if op["type"] in ("reshape2", "reshape"):
                shape = op.get("attrs", {}).get("shape", [])
                if len(shape) == 4 and shape[2] > 0:
                    return int(shape[2])
            if "num_heads" in op.get("attrs", {}):
                return int(op["attrs"]["num_heads"])
    raise ValueError("no head split found in the saved program")


def gpt_config_from_model(params: Dict[str, Any],
                          meta: Dict[str, Any]) -> GPTConfig:
    """The GPTConfig a saved ``build_lm_program`` / ``build_gpt_lm``
    directory was built with: widths from the parameter shapes, heads
    from the program, ``use_flash_attention`` from its ops, the switch-MoE
    layers from their parameters (``dec<i>_moe.gate``, ``.w1``, ...) and
    the program's ``switch_moe`` ops. Dropouts are 0 (inference)."""
    ops = [op for b in meta["program"]["blocks"] for op in b["ops"]]
    moe = sorted(int(m.group(1)) for m in
                 (re.match(r"dec(\d+)_moe\.gate$", n) for n in params) if m)
    try:
        V, H = params["gpt_tok_emb"].shape
        max_pos = params["gpt_pos_emb"].shape[0]
        if moe:
            ffn = params[f"dec{moe[0]}_moe.w1"].shape[2]
        else:
            ffn = params["dec0_ffn1.w"].shape[1]
    except KeyError as e:
        raise ValueError(f"not a GPT LM directory: missing {e}") from None
    layers = 1 + max(int(m.group(1)) for m in
                     (re.match(r"dec(\d+)_", n) for n in params) if m)
    flash = any(op["type"] == "flash_attention" for op in ops)
    cfg = GPTConfig(vocab_size=int(V), hidden_size=int(H),
                    num_layers=layers, num_heads=_num_heads(meta),
                    ffn_size=int(ffn), max_position=int(max_pos),
                    hidden_dropout=0.0, attention_dropout=0.0,
                    use_flash_attention=flash)
    if moe:
        cfg.moe_every = moe[0] + 1
        cfg.moe_experts = int(params[f"dec{moe[0]}_moe.gate"].shape[1])
        cfg.moe_capacity = float(next(
            op["attrs"].get("capacity_factor", 1.25) for op in ops
            if op["type"] == "switch_moe"))
    return cfg


def load_scope_arrays(scope, arrays: Dict[str, np.ndarray], program,
                      device) -> None:
    """Put ``arrays`` ({name: numpy array}) into ``scope`` as tensors on
    ``device``, one for each persistable var of ``program`` (its
    parameters and optimizer state), in the var's declared dtype.
    Raises ValueError on a persistable the arrays lack, on an array the
    program has no persistable for, and on a shape that differs from
    the var's."""
    want = {v.name: v for v in program.list_vars()
            if v.persistable and not v.is_data}
    missing = sorted(set(want) - set(arrays))
    extra = sorted(set(arrays) - set(want))
    if missing or extra:
        raise ValueError(f"load_scope_arrays: missing {missing}, not "
                         f"persistable in the program {extra}")
    device = torch.device(device)
    for name, var in want.items():
        arr = np.asarray(arrays[name])
        if var.shape is not None and tuple(arr.shape) != tuple(var.shape):
            raise ValueError(f"load_scope_arrays: {name!r} has shape "
                             f"{tuple(arr.shape)}, the program declares "
                             f"{tuple(var.shape)}")
        scope.set_var(name, array_to_tensor(arr, var.dtype, device))


# -- committed checkpoints ---------------------------------------------------
#
# A checkpoint directory is COMMITTED only once it holds the marker,
# written after every array file has landed. The marker carries a
# manifest (relative path -> size) of the directory at commit time, so a
# later truncation is detected, and the caller's ``extra`` (the
# Supervisor's step, run counter and reader position). With several
# processes the commit is two-phase over a shared filesystem: every rank
# writes its shard file and then its shard-done file (phase 1); rank 0
# stamps the one marker only after every rank's done-file with this
# save's nonce is present (phase 2). A process that dies mid-save leaves
# its done-file missing, so the marker is never written.
_COMMIT_MARKER = "_PT_COMMIT.json"
_SHARD_DONE_PREFIX = "_PT_SHARD_DONE."
_STAGE_READY = "_PT_STAGE_READY"
_SHARD_FILE = "__shards__.rank{rank}.npz"
_SHARD_META = "__shards__.meta.json"
# files orbax's single-process (OCDBT) layout writes
_ORBAX_FILES = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")

# (rank, world) override, so the two-phase protocol is testable without
# a torch.distributed world
_FORCE_DIST = None

# per-process save sequence number, part of the save nonce: every rank
# runs the same sequence of saves, so the counter stays aligned across
# ranks while each save attempt's nonce is unique
_SAVE_SEQ = [0]


class CheckpointCommitTimeout(RuntimeError):
    """Phase 2 of a multi-process checkpoint commit timed out: some
    rank's shard-done file (or rank 0's commit marker) never arrived.
    The save failed; no marker was or will be written for it."""


def _dist_info():
    """(rank, world): ``_FORCE_DIST``, else an initialised
    ``torch.distributed`` group, else a lone writer (0, 1)."""
    if _FORCE_DIST is not None:
        return _FORCE_DIST
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _checkpoint_manifest(path):
    out = {}
    for root, _, files in os.walk(path):
        for fn in files:
            if fn == _COMMIT_MARKER:
                continue
            full = os.path.join(root, fn)
            out[os.path.relpath(full, path)] = os.path.getsize(full)
    return out


def write_commit_marker(path, extra=None):
    """Mark a checkpoint directory committed. Written atomically (temp
    file, fsync, rename): a crash mid-write leaves no marker, never a
    truncated JSON."""
    marker = {"manifest": _checkpoint_manifest(path),
              "commit_time": time.time(), "extra": dict(extra or {})}
    tmp = os.path.join(path, _COMMIT_MARKER + ".tmp")
    with open(tmp, "w") as f:
        json.dump(marker, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, _COMMIT_MARKER))
    return marker


def read_commit_marker(path):
    """The commit marker dict, or None when the directory is uncommitted
    (no marker, or one that does not parse)."""
    try:
        with open(os.path.join(path, _COMMIT_MARKER)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_committed_checkpoint(path):
    """True when ``path`` holds a complete, committed checkpoint: its
    marker's manifest files all exist at their committed sizes. Without
    a marker, only a directory orbax itself finalized counts (the JAX
    package's rule for checkpoints older than the marker)."""
    if not os.path.isdir(path):
        return False
    marker = read_commit_marker(path)
    if marker is not None:
        for rel, size in marker.get("manifest", {}).items():
            try:
                if os.path.getsize(os.path.join(path, rel)) != size:
                    return False
            except OSError:
                return False
        return True
    return os.path.isfile(os.path.join(path, "_CHECKPOINT_METADATA"))


def _atomic_json(path, payload):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_shard_done(path, rank, nonce):
    """Phase 1, per rank: this rank's shards are durable for the save
    attempt ``nonce``. Atomic: a crash mid-write leaves no done-file."""
    _atomic_json(os.path.join(path, f"{_SHARD_DONE_PREFIX}{rank}"),
                 {"rank": int(rank), "nonce": str(nonce)})


def done_shard_ranks(path, world, nonce):
    """Ranks whose done-file for this save attempt is present; those of
    a crashed earlier attempt carry another nonce and never count."""
    done = []
    for rank in range(int(world)):
        try:
            with open(os.path.join(path, f"{_SHARD_DONE_PREFIX}{rank}")) as f:
                if str(json.load(f).get("nonce")) == str(nonce):
                    done.append(rank)
        except (OSError, ValueError):
            continue
    return done


def finalize_two_phase_commit(path, world, extra=None, nonce=None,
                              timeout_s=None, poll_s=0.05):
    """Phase 2, rank 0 only: wait until every rank's done-file for this
    attempt is present, then stamp the commit marker (its manifest
    covers every rank's files). Raises ``CheckpointCommitTimeout``
    naming the missing ranks; the directory then stays uncommitted."""
    world = int(world)
    timeout_s = (float(flag("dist_commit_timeout_s"))
                 if timeout_s is None else float(timeout_s))
    deadline = time.time() + timeout_s
    while True:
        done = done_shard_ranks(path, world, nonce)
        if len(done) >= world:
            break
        if time.time() >= deadline:
            missing = sorted(set(range(world)) - set(done))
            raise CheckpointCommitTimeout(
                f"two-phase commit of {path!r}: rank(s) {missing} never "
                f"wrote their shard-done file within {timeout_s:.0f}s "
                f"(save nonce {nonce!r}) — a process likely died mid-save; "
                "the checkpoint stays UNCOMMITTED and resume will use "
                "the previous committed one")
        time.sleep(poll_s)
    marker_extra = dict(extra or {})
    marker_extra.setdefault("world", world)
    marker_extra["commit_nonce"] = str(nonce)
    return write_commit_marker(path, marker_extra)


def _wait_for_marker(paths, nonce, timeout_s, poll_s=0.05):
    """The other ranks' phase-2 wait: until rank 0's marker for this
    attempt appears at any of ``paths`` (the staging directory or where
    it is published: the rename can land between polls)."""
    deadline = time.time() + timeout_s
    while True:
        for p in paths:
            marker = read_commit_marker(p)
            if marker is not None and str(
                    marker.get("extra", {}).get("commit_nonce")) == str(nonce):
                return p
        if time.time() >= deadline:
            raise CheckpointCommitTimeout(
                f"two-phase commit of {paths[0]!r}: rank 0 never stamped "
                f"the commit marker within {timeout_s:.0f}s (save nonce "
                f"{nonce!r}) — rank 0 likely died mid-commit; the save "
                "FAILED on this rank too")
        time.sleep(poll_s)


def _parse_index_key(key):
    """``name@start-stop;...`` (a shard of a sharded array, as the JAX
    package writes it) -> (name, [(start, stop), ...]); a whole value's
    key -> (key, None)."""
    name, _, idx = key.rpartition("@")
    if name and all(p.count("-") == 1
                    and all(x.isdigit() for x in p.split("-"))
                    for p in idx.split(";")):
        return name, [tuple(int(x) for x in p.split("-"))
                      for p in idx.split(";")]
    return key, None


def _save_checkpoint_multihost(path, arrays, extra, rank, world,
                               publish_path=None, timeout_s=None, nonce=None):
    """Every rank writes the values it owns (whole values, round-robin
    by position over the ranks: every array is whole until ROADMAP A10)
    into its own ``__shards__.rank<k>.npz``, then the two-phase commit
    publishes the marker (``paddle_tpu/io.py:543-643``). ``arrays``
    maps names to tensors or numpy arrays. ``path`` must be on a
    filesystem every rank shares."""
    from .resilience.faults import check_save_kill

    timeout_s = (float(flag("dist_commit_timeout_s"))
                 if timeout_s is None else float(timeout_s))
    if nonce is None:
        # unique per save attempt yet equal across ranks; the restart
        # generation keeps a resumed world's nonces apart from the
        # crashed one's
        _SAVE_SEQ[0] += 1
        nonce = (f"{extra.get('step', '')}:{extra.get('run_counter', '')}:"
                 f"g{os.environ.get('PADDLE_RESTART_COUNT', '0')}:"
                 f"s{_SAVE_SEQ[0]}")
    # stage-ready handshake: rank 0 clears what a crashed attempt left
    # here, then posts this attempt's token; the others write nothing
    # until they see it
    ready = os.path.join(path, _STAGE_READY)
    if rank == 0:
        os.makedirs(path, exist_ok=True)
        for entry in os.listdir(path):
            if entry.startswith((_SHARD_DONE_PREFIX, "__shards__.",
                                 _COMMIT_MARKER, _STAGE_READY)):
                try:
                    os.remove(os.path.join(path, entry))
                except OSError:
                    pass
        _atomic_json(ready, {"nonce": nonce, "world": world})
    else:
        deadline = time.time() + timeout_s
        while True:
            try:
                with open(ready) as f:
                    if str(json.load(f).get("nonce")) == nonce:
                        break
            except (OSError, ValueError):
                pass
            if time.time() >= deadline:
                raise CheckpointCommitTimeout(
                    f"two-phase commit of {path!r}: rank 0 never posted "
                    f"the stage-ready token within {timeout_s:.0f}s "
                    f"(nonce {nonce!r})")
            time.sleep(0.05)

    mine, meta_vars = {}, {}
    for i, name in enumerate(sorted(arrays)):
        if i % world == rank:
            val = arrays[name]
            mine[name] = (to_numpy(val) if isinstance(val, torch.Tensor)
                          else np.asarray(val))
        meta_vars[name] = {"sharded": False, "owner": i % world}
    shard_path = os.path.join(path, _SHARD_FILE.format(rank=rank))
    tmp = f"{shard_path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **mine)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, shard_path)
    if rank == 0:
        _atomic_json(os.path.join(path, _SHARD_META),
                     {"format": 1, "world": world, "nonce": nonce,
                      "vars": meta_vars})
    # a `killsave@N` fault dies here: shards durable, done-file missing
    check_save_kill("before_shard_done")
    write_shard_done(path, rank, nonce)
    if rank == 0:
        finalize_two_phase_commit(path, world, extra=extra, nonce=nonce,
                                  timeout_s=timeout_s)
    else:
        _wait_for_marker([path] + ([publish_path] if publish_path else []),
                         nonce, timeout_s)


def load_checkpoint_arrays(path):
    """A committed checkpoint directory as {var name: numpy array},
    touching no scope: the ``__shards__`` layout of either package
    (sharded values of a JAX save assembled from every rank's
    offset-keyed entries; missing coverage raises). An orbax directory
    of the JAX package's single-process save raises ``ValueError``."""
    if not os.path.isfile(os.path.join(path, _SHARD_META)):
        if any(os.path.exists(os.path.join(path, f)) for f in _ORBAX_FILES):
            raise ValueError(
                f"checkpoint {path!r} is in orbax's OCDBT layout (the JAX "
                "package's single-process save_checkpoint), which needs "
                "orbax and tensorstore; paddle_tpu_torch reads the "
                "__shards__.rank<k>.npz + __shards__.meta.json layout. "
                "Rewrite it in the JAX package: arrays = paddle_tpu.io."
                "load_checkpoint_arrays(path), then paddle_tpu.io."
                "_save_checkpoint_multihost(new_path, arrays, extra, 0, 1)")
        raise ValueError(f"{path!r} holds no {_SHARD_META}: not a "
                         "checkpoint directory")
    with open(os.path.join(path, _SHARD_META)) as f:
        meta = json.load(f)
    state, filled = {}, {}
    for entry in sorted(os.listdir(path)):
        if not (entry.startswith("__shards__.rank") and entry.endswith(".npz")):
            continue
        with np.load(os.path.join(path, entry)) as z:
            for key in z.files:
                name, idx = _parse_index_key(key)
                info = meta["vars"].get(name)
                if idx is None or info is None or not info.get("sharded"):
                    state[name] = z[key]
                    continue
                if name not in state:
                    state[name] = np.zeros(tuple(info["shape"]),
                                           dtype=np.dtype(info["dtype"]))
                    filled[name] = 0
                state[name][tuple(slice(a, b) for a, b in idx)] = z[key]
                filled[name] += int(np.prod([b - a for a, b in idx]))
    short = {n: (filled[n], int(np.prod(meta["vars"][n]["shape"])))
             for n in filled if filled[n] < np.prod(meta["vars"][n]["shape"])}
    if short:
        raise ValueError(
            f"multi-host checkpoint {path!r} is missing shard coverage for "
            f"{sorted(short)} (filled/total elements {short}) — a rank's "
            "shard file is absent or truncated")
    missing = sorted(set(meta["vars"]) - set(state))
    if missing:
        raise ValueError(
            f"multi-host checkpoint {path!r} is missing vars "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''} — an owning "
            "rank's shard file never landed")
    return state


class _AsyncSaveHandle:
    """One async save: ``wait_until_finished`` returns once the data and
    its commit marker are on disk, and re-raises a failure of either."""

    def __init__(self, thread, errors):
        self._thread = thread
        self._errors = errors

    def wait_until_finished(self):
        self._thread.join()
        if self._errors:
            raise self._errors[0]


def save_checkpoint(dirname, main_program=None, scope=None, step=None,
                    async_save=False, extra=None, publish_path=None):
    """Every persistable of ``main_program`` the scope holds, written to
    ``dirname`` (``dirname/<step>`` with ``step``) in the ``__shards__``
    layout and stamped with a commit marker carrying ``extra``;
    ``latest_checkpoint`` only ever selects committed directories.

    ``async_save``: the values are copied to the host on the caller's
    thread; the files and the marker are written on a non-daemon thread
    (interpreter exit waits for it), and the returned handle's
    ``wait_until_finished`` covers both. With several processes the
    save is the two-phase commit and always synchronous (the commit is
    the sync point); ``publish_path`` names where the directory will be
    renamed after commit, so the other ranks find the marker there too.
    Returns None for a synchronous save."""
    main_program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    arrays = {}
    for v in _persistable_vars(main_program):
        val = scope.find_var(v.name)
        if val is not None:
            arrays[v.name] = (to_numpy(val) if isinstance(val, torch.Tensor)
                              else np.array(val, copy=True))
    path = os.path.abspath(dirname)
    if step is not None:
        path = os.path.join(path, str(int(step)))
    rank, world = _dist_info()
    extra = dict(extra or {})
    if not async_save or world > 1:
        _save_checkpoint_multihost(path, arrays, extra, rank, world,
                                   publish_path=publish_path)
        return None
    errors: list = []

    def commit():
        try:
            _save_checkpoint_multihost(path, arrays, extra, rank, world)
        except BaseException as e:  # noqa: BLE001 — re-raised at the wait
            errors.append(e)

    thread = threading.Thread(target=commit, name="pt-checkpoint-commit")
    thread.start()
    return _AsyncSaveHandle(thread, errors)


def _mesh_shape(mesh) -> Dict[str, int]:
    shape = mesh.shape if hasattr(mesh, "shape") else mesh
    return {str(k): int(v) for k, v in dict(shape).items()}


def load_checkpoint(dirname, main_program=None, scope=None, step=None,
                    mesh=None, device=None):
    """Restore the values a committed checkpoint holds into ``scope``,
    each in the dtype ``main_program`` declares for it, on the device of
    the scope's current value of that var, else ``device`` (CUDA when
    None). Returns the names, sorted.

    ``mesh`` (a mapping of axis to size, or an object with ``.shape``)
    asks for the strict topology check: when the marker records the
    mesh that produced the trajectory and it differs, the load refuses
    naming both shapes. Without ``mesh`` the load is elastic."""
    main_program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    path = os.path.abspath(dirname)
    if step is not None:
        path = os.path.join(path, str(int(step)))
    if not is_committed_checkpoint(path):
        raise ValueError(
            f"checkpoint {path!r} is uncommitted or corrupt (missing/"
            "invalid commit marker, or manifest files truncated) — it "
            "was likely interrupted mid-save; resume from "
            "latest_checkpoint(), which skips such directories")
    extra = (read_commit_marker(path) or {}).get("extra", {})
    if mesh is not None and extra.get("mesh"):
        want, have = _mesh_shape(mesh), _mesh_shape(extra["mesh"])
        if want != have:
            raise ValueError(
                f"checkpoint {path!r} was committed on mesh {have} but "
                f"the current mesh is {want} — refusing the strict "
                "(mesh=...) restore. Resume on the matching topology, or "
                "load without mesh= for an elastic restore")
    state = load_checkpoint_arrays(path)
    block = main_program.global_block()
    fallback = None
    for name, val in state.items():
        cur = scope.find_var(name)
        if isinstance(cur, torch.Tensor):
            dev = cur.device
        else:
            fallback = fallback or resolve_device(device)
            dev = fallback
        dt = block.var(name).dtype if block.has_var(name) else None
        scope.set_var(name, array_to_tensor(val, dt, dev))
    return sorted(state)


def _committed_steps(dirname):
    if not os.path.isdir(dirname):
        return []
    return sorted(int(d) for d in os.listdir(dirname) if d.isdigit()
                  and is_committed_checkpoint(os.path.join(dirname, d)))


def latest_checkpoint(dirname):
    """The highest committed numeric step directory under ``dirname``
    (None when there is none). Directories a crash left without a
    marker, or with truncated manifest files, are skipped."""
    steps = _committed_steps(dirname)
    return steps[-1] if steps else None


def committed_checkpoint_steps(dirname):
    """Every committed step directory under ``dirname``, ascending."""
    return _committed_steps(dirname)


def batch(reader, batch_size, drop_last=False):
    """Reference fluid.io.batch (paddle.batch), ``paddle_tpu/io.py:863``:
    group a sample reader into lists of ``batch_size`` samples."""

    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched
