"""Dygraph checkpoint save / load: the port's copy of
``paddle_tpu/dygraph/checkpoint.py`` (reference
fluid/dygraph/checkpoint.py). The file is ``<path>.pdparams.npz``, the
JAX package's layout, so that each package reads the other's files."""

from __future__ import annotations

import os

import numpy as np

__all__ = ["save_dygraph", "load_dygraph"]


def save_dygraph(state_dict, model_path: str):
    arrays = {}
    for k, v in state_dict.items():
        arrays[k] = v.numpy() if hasattr(v, "numpy") else np.asarray(v)
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    np.savez(model_path + ".pdparams.npz", **arrays)


def load_dygraph(model_path: str):
    """(param_dict, optimizer_dict): numpy arrays by key, and None."""
    with np.load(model_path + ".pdparams.npz") as data:
        state = {k: data[k] for k in data.files}
    return state, None
