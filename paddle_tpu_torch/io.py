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
void, or ``ml_dtypes.bfloat16``) is read back bit for bit. Sharded and
committed checkpoints (``save_checkpoint``, ``load_checkpoint``) are
ROADMAP A13b.

Besides the reference's API, the port's GPT serving path reads a saved
``build_lm_program`` directory with ``read_params_file`` /
``load_model_meta`` / ``gpt_config_from_model``, and
``load_scope_arrays`` carries a JAX scope's arrays into a port scope.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .core import framework
from .core.executor import global_scope, to_numpy, torch_dtype
from .core.framework import Parameter, Program, Variable
from .device import resolve_device
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
    """The GPTConfig a saved ``build_lm_program`` directory was built
    with: widths from the parameter shapes, heads from the program,
    ``use_flash_attention`` from its ops. Dropouts are 0 (inference)."""
    try:
        V, H = params["gpt_tok_emb"].shape
        max_pos = params["gpt_pos_emb"].shape[0]
        ffn = params["dec0_ffn1.w"].shape[1]
    except KeyError as e:
        raise ValueError(f"not a GPT LM directory: missing {e}") from None
    layers = 1 + max(int(m.group(1)) for m in
                     (re.match(r"dec(\d+)_", n) for n in params) if m)
    flash = any(op["type"] == "flash_attention"
                for b in meta["program"]["blocks"] for op in b["ops"])
    return GPTConfig(vocab_size=int(V), hidden_size=int(H),
                     num_layers=layers, num_heads=_num_heads(meta),
                     ffn_size=int(ffn), max_position=int(max_pos),
                     hidden_dropout=0.0, attention_dropout=0.0,
                     use_flash_attention=flash)


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
