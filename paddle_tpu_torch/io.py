"""Read an inference-model directory saved by the JAX package.

``paddle_tpu.io.save_inference_model`` writes two files (``io.py:42,
158-183`` there): ``__params__.npz``, every persistable by name, and
``__model__``, JSON with the pruned Program and the feed/fetch names.
This module reads both with numpy and json alone.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict

import numpy as np

from .models.gpt import GPTConfig

__all__ = ["PARAMS_FILE", "MODEL_FILE", "load_params", "load_model_meta",
           "gpt_config_from_model"]

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
