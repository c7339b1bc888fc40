"""In-program checkpoint ops: ``save`` / ``load`` / ``save_combine`` /
``load_combine``, the torch lowerings of ``paddle_tpu/ops/persist.py``
(operators/save_op.cc, load_op.cc, save_combine_op.cc,
load_combine_op.cc). The Executor runs them like any op: a value goes to
the host and into ``<file_path>.npy`` (one var) or ``<file_path>.npz``
(by var name), the file format the JAX package's ops write and read, and
a load reads it back to the run's device at the shape and dtype its
attrs declare."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.executor import to_numpy, torch_dtype
from ..core.registry import register_op


def _npy(path):
    return path if path.endswith(".npy") else path + ".npy"


def _npz(path):
    return path if path.endswith(".npz") else path + ".npz"


def _decl(op, i=0):
    """(shape, dtype) of output ``i`` from the ``shape`` / ``dtype``
    attrs (a list of them for ``load_combine``)."""
    shapes = op.attrs.get("shape", None)
    dtypes = op.attrs.get("dtype", "float32")
    if shapes and isinstance(shapes[0], (list, tuple)):
        return tuple(int(d) for d in shapes[i]), (
            dtypes[i] if isinstance(dtypes, (list, tuple)) else dtypes)
    return tuple(int(d) for d in (shapes or [1])), (
        dtypes if isinstance(dtypes, str) else dtypes[0])


def _read(arr, shape, dtype, device):
    return torch.as_tensor(np.asarray(arr).astype(dtype).reshape(shape)).to(
        device=device, dtype=torch_dtype(dtype))


@register_op("save", inputs=("X",), outputs=(), stop_gradient=True)
def _save(ctx, op, ins):
    """:30: X (float16 with ``save_as_fp16``) to ``file_path``.npy."""
    path = str(op.attrs.get("file_path", "param"))
    x = to_numpy(ins["X"][0])
    if bool(op.attrs.get("save_as_fp16", False)):
        x = x.astype(np.float16)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(_npy(path), x)
    return {}


@register_op("save_combine", inputs=("X",), outputs=(), stop_gradient=True)
def _save_combine(ctx, op, ins):
    """:43: every X into ``file_path``.npz under its var name."""
    path = str(op.attrs.get("file_path", "params"))
    names = list(op.inputs.get("X", []))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(_npz(path), **{n: to_numpy(a) for n, a in zip(names,
                                                            ins["X"])})
    return {}


@register_op("load", inputs=(), outputs=("Out",), stop_gradient=True)
def _load(ctx, op, ins):
    """:71: ``file_path``.npy at the declared shape and dtype."""
    shape, dtype = _decl(op)
    if ctx.device.type == "meta":
        return {"Out": [torch.empty(shape, dtype=torch_dtype(dtype),
                                    device="meta")]}
    arr = np.load(_npy(str(op.attrs.get("file_path", "param"))))
    return {"Out": [_read(arr, shape, dtype, ctx.device)]}


@register_op("load_combine", inputs=(), outputs=("Out",), stop_gradient=True)
def _load_combine(ctx, op, ins):
    """:90: each Out by its var name from ``file_path``.npz."""
    names = list(op.outputs.get("Out", []))
    with np.load(_npz(str(op.attrs.get("file_path", "params")))) as z:
        return {"Out": [_read(z[n], *_decl(op, i), ctx.device)
                        for i, n in enumerate(names)]}
