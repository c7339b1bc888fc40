"""Read an inference-model directory saved by the JAX package, and
carry a JAX scope's arrays into a port scope.

``paddle_tpu.io.save_inference_model`` writes two files (``io.py:42,
158-183`` there): ``__params__.npz``, every persistable by name, and
``__model__``, JSON with the pruned Program and the feed/fetch names.
This module reads both with numpy and json alone.

``load_scope_arrays`` takes the persistable arrays of a training
program (parameters, Adam moments, beta pows, learning rate) as numpy,
whoever made them, into the port's scope under the same names.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict

import numpy as np
import torch

from .core.executor import torch_dtype
from .models.gpt import GPTConfig

__all__ = ["PARAMS_FILE", "MODEL_FILE", "load_params", "load_model_meta",
           "gpt_config_from_model", "load_scope_arrays"]

PARAMS_FILE = "__params__.npz"
MODEL_FILE = "__model__"


def load_params(dirname: str, filename: str = None) -> Dict[str, np.ndarray]:
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
    with: widths from the parameter shapes, heads from the program.
    Dropouts are 0 (inference)."""
    try:
        V, H = params["gpt_tok_emb"].shape
        max_pos = params["gpt_pos_emb"].shape[0]
        ffn = params["dec0_ffn1.w"].shape[1]
    except KeyError as e:
        raise ValueError(f"not a GPT LM directory: missing {e}") from None
    layers = 1 + max(int(m.group(1)) for m in
                     (re.match(r"dec(\d+)_", n) for n in params) if m)
    return GPTConfig(vocab_size=int(V), hidden_size=int(H),
                     num_layers=layers, num_heads=_num_heads(meta),
                     ffn_size=int(ffn), max_position=int(max_pos),
                     hidden_dropout=0.0, attention_dropout=0.0)


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
        t = torch.tensor(arr)       # a copy: the arrays stay the caller's
        scope.set_var(name, t.to(device=device, dtype=torch_dtype(var.dtype)))
