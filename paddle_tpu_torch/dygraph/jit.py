"""Dygraph capture: ``TracedLayer`` and ``to_static``.

The port's counterpart of ``paddle_tpu/dygraph/jit.py`` (reference
fluid/dygraph/jit.py). JAX compiles the layer's forward with
``jax.jit``; the port captures it, at the example shapes, into one CUDA
graph over static input buffers, as ``runtime.graphs.GraphedStep`` does
for the engines' steps:

* the forward runs once eagerly on a side stream (the library handles
  and workspaces are made then), then once under capture, with autograd
  off; a forward that cannot be captured (a host sync in a lowering)
  makes ``trace`` raise and name the op being traced, as ``jax.jit``
  refuses concrete Python control flow over a tracer. There is no
  eager fallback on the card.
* a call copies its inputs into the static buffers and replays the
  graph; a parameter or buffer whose tensor was replaced since the
  capture (an optimizer step, ``set_dict``) is copied into the tensor
  the graph reads first. The replay adds the graph's kernel launches to
  the wrappers' counters (``runtime.graphs.graph_launches``).
* the layer's buffers (BatchNorm's running statistics) are restored
  after the capture, so trace in eval mode.

On the CPU, ``trace`` and ``to_static`` run the forward eagerly.
``save_inference_model`` writes JAX's ``__traced_params__.npz`` (the
parameters as ``p0``, ``p1``, ...) and nothing more.
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import numpy as np
import torch

from . import base
from .base import VarBase, _as_tensor, no_grad

__all__ = ["TracedLayer", "to_static", "dygraph_to_static_graph",
           "dygraph_to_static_output"]


def _tensors(inputs):
    return [x.value.detach() if isinstance(x, VarBase) else _as_tensor(x)
            for x in inputs]


def _state(layer):
    return list(layer.parameters()) + list(layer.buffers()) if layer else []


class _GraphedForward:
    """``fn(*VarBases) -> VarBase`` captured over static inputs shaped
    like ``example`` (CUDA), or run eagerly (CPU)."""

    def __init__(self, fn: Callable, example, state, what: str):
        self.fn, self.state, self.what = fn, list(state), what
        self.device = example[0].device
        self.graph = None
        self.launches = {}
        if self.device.type == "cuda":
            self._capture(example)

    def _run(self, xs):
        with no_grad(), torch.no_grad():
            out = self.fn(*[VarBase(x, stop_gradient=True) for x in xs])
        return out.value if isinstance(out, VarBase) else out

    def _capture(self, example):
        from ..kernels import _build
        from ..runtime.graphs import (CAPTURE_ERROR_MODE, graph_launches,
                                      kernel_node_names)

        self.static = [x.clone() for x in example]
        held = [(v, v.value) for v in self.state]
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        base._current_op = None
        try:
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._run(self.static)
            cur.wait_stream(side)
            torch.cuda.synchronize(self.device)
            self._restore(held)
            with _build.recording() as tally, \
                    torch.cuda.graph(graph, stream=side,
                                     capture_error_mode=CAPTURE_ERROR_MODE):
                out = self._run(self.static)
            graph.instantiate()
        except Exception as e:
            raise RuntimeError(
                f"{self.what}: the forward cannot be captured as a CUDA graph "
                f"(at op {base._current_op!r}): {e}") from e
        finally:
            self._restore(held)
        self.launches = graph_launches(
            kernel_node_names(graph.raw_cuda_graph()), tally, self.what)
        self.graph, self.out = graph, out
        self.read = [v.value for v in self.state]

    @staticmethod
    def _restore(held):
        for v, t in held:
            if v.value is not t:
                v._value = t

    def __call__(self, xs):
        if self.graph is None:
            return self._run(xs)
        from ..kernels import KERNELS

        with torch.no_grad():
            for v, t in zip(self.state, self.read):
                if v.value is not t:
                    t.copy_(v.value)
            for s, x in zip(self.static, xs):
                s.copy_(x)
        self.graph.replay()
        for name, n in self.launches.items():
            KERNELS[name].launches += n
        return self.out.clone()


class TracedLayer:
    """A Layer's forward captured at the example inputs' shapes."""

    def __init__(self, layer, forward: _GraphedForward):
        self._layer = layer
        self._forward = forward
        self._params = layer.parameters()

    @staticmethod
    def trace(layer, inputs):
        """(the output on ``inputs``, the TracedLayer)."""
        fwd = _GraphedForward(layer, _tensors(inputs), _state(layer),
                              f"TracedLayer.trace({type(layer).__name__})")
        traced = TracedLayer(layer, fwd)
        return traced(inputs)[0], traced

    def __call__(self, inputs):
        return [VarBase(self._forward(_tensors(inputs)), stop_gradient=True)]

    def save_inference_model(self, dirname, feed=None, fetch=None):
        os.makedirs(dirname, exist_ok=True)
        np.savez(os.path.join(dirname, "__traced_params__.npz"),
                 **{f"p{i}": p.numpy() for i, p in enumerate(self._params)})


def to_static(fn: Callable = None):
    """Decorator: ``fn`` over VarBases, captured a CUDA graph for each
    set of input shapes and dtypes it meets (run eagerly on the CPU).
    What ``fn`` reads besides its arguments (a layer's parameters) is
    read at the capture, as ``jax.jit`` bakes it into its trace."""

    def deco(f):
        graphs = {}

        @functools.wraps(f)
        def wrapper(*args):
            xs = _tensors(args)
            key = tuple((tuple(x.shape), x.dtype, str(x.device)) for x in xs)
            if key not in graphs:
                graphs[key] = _GraphedForward(f, xs, (),
                                              f"to_static({f.__name__})")
            return VarBase(graphs[key](xs), stop_gradient=True)

        return wrapper

    return deco(fn) if fn is not None else deco


def dygraph_to_static_graph(fn=None):
    """Reference fluid/dygraph/jit.py alias: AST-convert a dygraph
    function (the ``declarative`` entry)."""
    from .dygraph_to_static import declarative

    return declarative(fn) if fn is not None else declarative


dygraph_to_static_output = dygraph_to_static_graph
