"""Dygraph core: ``VarBase``, the eager tracer and autograd.

The port's counterpart of ``paddle_tpu/dygraph/base.py`` (reference
imperative/tracer.cc:87 TraceOp, imperative/layer.h:61 VarBase,
imperative/engine.cc BasicEngine). ``_trace`` runs an op's registered
lowering (``core/registry.py``) at once on the VarBases' tensors, on
the eager device, with a pseudo-op that carries its own ``op_ident``:
each traced dropout draws its own mask from ``op_generator``.

Gradients come from ``torch.autograd`` through the lowering (the
counterpart of JAX's ``jax.vjp`` of the forward lowering, :285-300):
the tracer runs a lowering with autograd on unless its outputs stop
gradients, and ``backward()`` seeds the root with ones. JAX's rules:

* an op's outputs get ``stop_gradient`` under ``no_grad``, when every
  input has it, or when the op is ``stop_gradient``; inputs of
  ``no_grad_slots`` (and inputs that stop gradients) enter detached;
* every VarBase on the path keeps its gradient, intermediates included
  (``retain_grad``), and gradients accumulate across ``backward()``
  calls until ``clear_gradient`` / ``Layer.clear_gradients``;
* the graph is kept (``retain_graph``), so a second ``backward()`` over
  it works, as JAX's kept tape does;
* ``backward()`` on a leaf with ``stop_gradient=True`` raises.

An op with an explicit ``<type>_grad`` lowering (``lookup_table_grad``)
takes the dense autograd gradient here, as JAX's dygraph does. A
VarBase's value is replaced, never written in place, when it changes
(``set_value``, the optimizers, BatchNorm's running statistics), so a
tensor autograd saved keeps its version.

``to_variable`` keeps int64 as int64 (JAX narrows it to int32 when x64
is off).
"""

from __future__ import annotations

import builtins
import contextlib
import itertools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import dygraph as _mode
from ..core.registry import LoweringContext, get_op_def

__all__ = ["guard", "enabled", "enable_dygraph", "disable_dygraph",
           "to_variable", "VarBase", "no_grad"]

guard = _mode.dygraph_guard
in_dygraph_mode = _mode.in_dygraph_mode


def enabled():
    return _mode.in_dygraph_mode()


def enable_dygraph(place=None):
    _mode.enable(place)


def disable_dygraph():
    _mode.disable()


_no_grad = False


@contextlib.contextmanager
def no_grad():
    global _no_grad
    prev = _no_grad
    _no_grad = True
    try:
        yield
    finally:
        _no_grad = prev


def _as_tensor(value, device=None) -> torch.Tensor:
    if isinstance(value, VarBase):
        value = value.value
    if isinstance(value, torch.Tensor):
        t = value.detach()
        return t if device is None else t.to(device)
    arr = np.asarray(value)
    dev = device if device is not None else _mode.eager_device()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` (a snapshot: gradients accumulate in place,
    and a CPU tensor's ``numpy()`` shares its memory)."""
    a = t.detach().cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


class _PseudoOp:
    """What a lowering reads of an op: type, attrs, slot -> names."""

    __slots__ = ("type", "attrs", "inputs", "outputs")

    def __init__(self, type, attrs, inputs=None, outputs=None):
        self.type = type
        self.attrs = attrs
        self.inputs = inputs or {}
        self.outputs = outputs or {}


class VarBase:
    """Eager tensor: a torch tensor + autograd metadata."""

    _name_counter = itertools.count(1)

    def __init__(self, value, name=None, stop_gradient=False,
                 persistable=False):
        t = value if isinstance(value, torch.Tensor) else _as_tensor(value)
        self.name = name or f"eager_tmp_{next(VarBase._name_counter)}"
        self.persistable = persistable
        self._value = t
        self._stop_gradient = bool(stop_gradient)
        self._sync_leaf()

    def _sync_leaf(self):
        """A leaf tensor requires grad exactly when the VarBase takes
        gradients (floating point, not stop_gradient)."""
        t = self._value
        if t.grad_fn is None:
            want = (not self._stop_gradient) and (
                t.is_floating_point() or t.is_complex())
            if t.requires_grad != want:
                if t.requires_grad:
                    t = t.detach()
                else:
                    t.requires_grad_(True)
                self._value = t

    # -- value / info ---------------------------------------------------------
    @property
    def value(self) -> torch.Tensor:
        return self._value

    @value.setter
    def value(self, v):
        self.set_value(v)

    @property
    def stop_gradient(self) -> bool:
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, flag):
        self._stop_gradient = bool(flag)
        self._sync_leaf()

    def numpy(self):
        return _host(self._value)

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return str(self._value.dtype).replace("torch.", "")

    def detach(self):
        return VarBase(self._value.detach(), stop_gradient=True)

    def clear_gradient(self):
        self._value.grad = None

    @property
    def grad(self) -> Optional[torch.Tensor]:
        return self._value.grad

    @property
    def gradient(self):
        g = self._value.grad
        return None if g is None else _host(g)

    def set_value(self, v):
        """Replace the value (a new tensor, so that any tensor autograd
        saved keeps its version); the gradient so far stays."""
        old = self._value
        if isinstance(v, VarBase):
            v = v.value
        if isinstance(v, torch.Tensor) and v is old:
            return
        new = _as_tensor(v, old.device)
        if (new.data_ptr() == old.data_ptr() and new.shape == old.shape
                and new.dtype == old.dtype and new.stride() == old.stride()):
            return
        grad = old.grad
        self._value = new
        self._sync_leaf()
        if (grad is not None and self._value.requires_grad
                and grad.shape == self._value.shape):
            self._value.grad = grad

    def astype(self, dtype):
        return _trace("cast", {"X": [self]}, ["Out"],
                      {"out_dtype": str(dtype)})[0]

    def __repr__(self):
        return (f"VarBase(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype})")

    # -- autograd -------------------------------------------------------------
    def backward(self, retain_graph=False):
        run_backward(self)

    # -- operator sugar -------------------------------------------------------
    def _ew(self, other, op, reverse=False):
        if not isinstance(other, VarBase):
            other = VarBase(torch.as_tensor(other, dtype=self._value.dtype,
                                            device=self._value.device),
                            stop_gradient=True)
        a, b = (other, self) if reverse else (self, other)
        return _trace(op, {"X": [a], "Y": [b]}, ["Out"], {"axis": -1})[0]

    def __add__(self, o):
        return self._ew(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._ew(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._ew(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._ew(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._ew(o, "elementwise_div")

    def __neg__(self):
        return _trace("scale", {"X": [self]}, ["Out"], {"scale": -1.0})[0]

    def __getitem__(self, idx):
        """Ints and unit-step slices through the ``slice`` and
        ``squeeze2`` ops, so that gradients flow (:123-187); any other
        index gives a detached copy, as JAX's."""
        items = idx if isinstance(idx, tuple) else (idx,)
        axes, starts, ends, squeeze_axes = [], [], [], []
        for i, it in enumerate(items):
            if isinstance(it, int):
                axes.append(i)
                starts.append(it)
                ends.append(it + 1)
                squeeze_axes.append(i)
            elif isinstance(it, builtins.slice) and it.step in (None, 1):
                if it.start is None and it.stop is None:
                    continue
                axes.append(i)
                starts.append(it.start or 0)
                ends.append(it.stop if it.stop is not None else 10 ** 9)
            else:
                return VarBase(self._value.detach()[idx], stop_gradient=True)
        out = self
        if axes:
            (out,) = _trace("slice", {"Input": [out]}, ["Out"],
                            {"axes": axes, "starts": starts, "ends": ends})
        if squeeze_axes:
            out, _ = _trace("squeeze2", {"X": [out]}, ["Out", "XShape"],
                            {"axes": squeeze_axes})
        return out


def to_variable(value, name=None, zero_copy=None):
    """A VarBase on the eager device; float64 becomes float32."""
    if isinstance(value, VarBase):
        return value
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.float64:
            t = t.float()
        return VarBase(t.to(_mode.eager_device()), name=name)
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return VarBase(_as_tensor(arr), name=name)


_op_idents = itertools.count(1)
# the op the tracer last started: named when a CUDA graph capture fails
_current_op: Optional[str] = None


def _eager_ctx(device) -> LoweringContext:
    from ..core.framework import default_startup_program

    return LoweringContext(device,
                           seed=int(default_startup_program().random_seed))


def _trace(op_type: str, ins: Dict[str, List[VarBase]], out_slots: List[str],
           attrs: Dict[str, Any], n_outs: Optional[Dict[str, int]] = None):
    """Eager TraceOp: run the lowering now (reference
    imperative/tracer.cc:87-110); returns the outputs of ``out_slots``
    as one flat list of VarBases."""
    opdef = get_op_def(op_type)
    attrs = dict(attrs)
    attrs["op_ident"] = next(_op_idents)
    flat_ins = [v for vs in ins.values() for v in vs]
    stop = (_no_grad or opdef.stop_gradient
            or all(v.stop_gradient for v in flat_ins))
    raw = {}
    for slot, vs in ins.items():
        cut = stop or slot in opdef.no_grad_slots
        raw[slot] = [v.value.detach() if cut or v.stop_gradient else v.value
                     for v in vs]
    n_outs = n_outs or {}
    pseudo = _PseudoOp(
        op_type, attrs, {s: [v.name for v in vs] for s, vs in ins.items()},
        {s: [f"{op_type}.{s}.{k}" for k in range(n_outs.get(s, 1))]
         for s in out_slots})
    device = (flat_ins[0].value.device if flat_ins
              else _mode.eager_device())
    global _current_op
    _current_op = op_type
    with torch.set_grad_enabled(not stop):
        outs = opdef.lower(_eager_ctx(device), pseudo, raw)
    flat: List[VarBase] = []
    for slot in out_slots:
        for t in outs.get(slot, []):
            if not isinstance(t, torch.Tensor):
                t = torch.as_tensor(t, device=device)
            if stop and t.requires_grad:
                t = t.detach()
            if t.requires_grad and t.grad_fn is not None:
                t.retain_grad()
            flat.append(VarBase(t, stop_gradient=stop))
    return flat


def run_backward(root: VarBase):
    """BasicEngine: ``torch.autograd`` from the root, seeded with ones,
    the graph kept for another call (imperative/engine.cc)."""
    t = root.value
    if not t.requires_grad:
        if root.stop_gradient and t.grad_fn is None:
            raise RuntimeError("backward() on a leaf with stop_gradient=True")
        return
    torch.autograd.backward(t, torch.ones_like(t), retain_graph=True)
    # the root's own gradient is the seed, not a sum over calls (JAX
    # sets it to ones on every call)
    if t.grad_fn is not None:
        t.grad = torch.ones_like(t)
