"""A generation engine's fixed-shape step, bound once and replayed as a
CUDA graph: the port's counterpart of the JAX engine's bound steps
(``paddle_tpu/generation/engine.py:481-482``, ``_bind_ragged`` :1177,
``_bind_decode`` :1423), where one jitted executable serves every step
of the engine's life.

A ``GraphedStep`` owns the step's static input buffers (tokens,
positions, counts, block tables, adapter slots), the engine's pools and
scale planes as the step's state (allocated once by the engine), and,
once captured, one static output. Every call

1. copies the host arrays into the static buffers (on CUDA through
   pinned staging tensors, ``non_blocking``);
2. on CUDA, replays the graph captured over them (``capture``); on the
   CPU, calls the step eagerly on the same buffers;
3. copies the output to the host.

The CPU path goes through the same static buffers, so the CPU tests
exercise their refresh; it runs only where the engine was asked for the
CPU. There is no fallback: ``capture`` raises when the step cannot be
captured, and a captured step only replays.

A replay runs no Python, so the kernel wrappers' launch counters
(``kernels.launch_counts``) would stop. During ``capture`` the wrappers
count into the capture's own tally (``kernels._build.recording``, this
thread only: a capture launches nothing). The captured graph's kernel
nodes are then read back through the CUDA driver and counted by name
(``kernels.GRAPH_NODES``); the capture raises unless each kernel's
nodes equal its wrapper's tally, and every replay adds those node
counts. ``runs`` counts calls, ``replays`` graph replays, ``captures``
captures.
"""

from __future__ import annotations

import ctypes
import re
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..flags import _flags
from ..kernels import GRAPH_NODES, KERNELS, _build
from .dispatch import record_step

__all__ = ["GraphedStep", "graph_launches", "kernel_node_names"]

_NODE_PATTERNS = {k: re.compile(p) for k, p in GRAPH_NODES.items()}
_KERNEL_NODE = 0                         # CU_GRAPH_NODE_TYPE_KERNEL
_libs: Dict[str, ctypes.CDLL] = {}


def cuda_driver() -> ctypes.CDLL:
    """The CUDA driver library this process already uses."""
    if "cuda" not in _libs:
        path = "libcuda.so.1"
        with open("/proc/self/maps") as maps:
            for line in maps:
                if "libcuda.so" in line:
                    path = line.split()[-1]
                    break
        _libs["cuda"] = ctypes.CDLL(path)
    return _libs["cuda"]


def demangle(name: str) -> str:
    """A C++ symbol as source spells it (``__cxa_demangle``); the name
    itself where it is not a mangled one."""
    if "cxx" not in _libs:
        _libs["cxx"] = ctypes.CDLL("libstdc++.so.6")
        _libs["c"] = ctypes.CDLL(None)
        getattr(_libs["cxx"], "__cxa_demangle").restype = ctypes.c_void_p
    status = ctypes.c_int(-1)
    buf = getattr(_libs["cxx"], "__cxa_demangle")(
        name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not buf:
        return name
    try:
        return ctypes.string_at(buf).decode()
    finally:
        _libs["c"].free(ctypes.c_void_p(buf))


def kernel_node_names(raw_graph: int) -> List[str]:
    """The demangled kernel names of a captured ``cudaGraph_t``'s kernel
    nodes (``CUDAGraph(keep_graph=True).raw_cuda_graph()``), read
    through the driver API."""
    cu, vp = cuda_driver(), ctypes.c_void_p

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{fn} failed with CUresult {rc}")

    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", vp(raw_graph), None, ctypes.byref(n))
    nodes = (vp * n.value)()
    call("cuGraphGetNodes", vp(raw_graph), nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", vp(node), ctypes.byref(kind))
        if kind.value != _KERNEL_NODE:
            continue
        params = (ctypes.c_ubyte * 128)()    # CUDA_KERNEL_NODE_PARAMS_v2
        call("cuGraphKernelNodeGetParams_v2", vp(node), params)
        func = vp.from_buffer(params, 0).value      # CUfunction func
        name = ctypes.c_char_p()
        call("cuFuncGetName", ctypes.byref(name), vp(func))
        names.append(demangle(name.value.decode()))
    return names


def graph_launches(names: List[str], tally: Mapping[str, int],
                   step: str) -> Dict[str, int]:
    """Each kernel's launches in a graph, from its kernel node names: the
    nodes that match the kernel's ``GRAPH_NODES`` pattern. Raises unless
    they equal ``tally``, what the wrappers counted during the capture
    (a wrapper without a pattern counts as no node)."""
    nodes: Dict[str, int] = {}
    for name in names:
        hits = [k for k, pat in _NODE_PATTERNS.items() if pat.search(name)]
        if len(hits) > 1:
            raise RuntimeError(f"kernel node {name!r} matches {hits}")
        if hits:
            nodes[hits[0]] = nodes.get(hits[0], 0) + 1
    if nodes != dict(tally):
        raise RuntimeError(
            f"the {step} step's graph holds the kernel nodes {nodes}, its "
            f"wrappers counted {dict(tally)} launches while it was captured")
    return nodes


# the capture mode of every GraphedStep: only the capturing thread's
# unsafe calls count against the capture ("global", torch's default,
# would fail it on any thread's cudaMalloc or synchronize)
CAPTURE_ERROR_MODE = "thread_local"

class GraphedStep:
    """``step(**feeds, **state)`` over static buffers of the shapes and
    dtypes ``feeds`` names (``{name: (shape, dtype)}``); ``state`` is
    passed as it is every call (the engine's pools)."""

    def __init__(self, step: Callable, feeds: Mapping[str, Tuple[tuple,
                                                                 torch.dtype]],
                 state: Mapping[str, Any], device, name: str):
        self.step = step
        self.state = dict(state)
        self.device = torch.device(device)
        self.name = name
        self._cuda = self.device.type == "cuda"
        self.static = {n: torch.zeros(shape, dtype=dt, device=self.device)
                       for n, (shape, dt) in feeds.items()}
        # host side of the copies in: pinned, so that they are async
        self._staging = None
        if self._cuda:
            self._staging = {n: torch.zeros(t.shape, dtype=t.dtype,
                                            pin_memory=True)
                             for n, t in self.static.items()}
            self._staging_np = {n: t.numpy() for n, t in
                                self._staging.items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self._host_out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.runs = self.replays = self.captures = 0

    # -- the step ------------------------------------------------------------
    def _copy_in(self, host: Mapping[str, np.ndarray]) -> None:
        if self._cuda:
            for n, t in self.static.items():
                np.copyto(self._staging_np[n], host[n], casting="unsafe")
                t.copy_(self._staging[n], non_blocking=True)
        else:
            for n, t in self.static.items():
                t.copy_(torch.from_numpy(np.ascontiguousarray(host[n])))

    def run(self, **host: np.ndarray) -> np.ndarray:
        """One step: ``host`` holds every feed as a host array of its
        buffer's shape; returns the step's output on the host, after the
        step's writes into the pools have finished."""
        t_obs = time.perf_counter()
        self._copy_in(host)
        if self.graph is not None:
            self.graph.replay()
            out = self.out
            self.replays += 1
            for name, n in self.launches.items():
                KERNELS[name].launches += n
        else:
            out = self.step(**self.static, **self.state)
        self.runs += 1
        if not self._cuda:
            res = out.numpy()
            self._telemetry(t_obs, res)
            return res
        if self._host_out is None:
            # a normal tensor even when the first call runs under the
            # engine loop's inference mode: later calls copy into it
            # from outside it too
            with torch.inference_mode(False):
                self._host_out = torch.empty(out.shape, dtype=out.dtype,
                                             pin_memory=True)
        self._host_out.copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        res = self._host_out.numpy().copy()
        self._telemetry(t_obs, res)
        return res

    def _telemetry(self, t0: float, res: np.ndarray) -> None:
        if _flags["observability_metrics"]:
            record_step((time.perf_counter() - t0) * 1e3,
                        int(res.shape[0]) if res.ndim else 0, self.runs)

    def eager(self, state: Optional[Mapping[str, Any]] = None,
              **host: np.ndarray) -> torch.Tensor:
        """The step called eagerly on fresh tensors made from ``host``,
        over ``state`` (by default the engine's own): the reference a
        replay is held to, and what an engine without bound steps would
        run."""
        feeds = {n: torch.from_numpy(np.ascontiguousarray(host[n])).to(
                     device=self.device, dtype=t.dtype)
                 for n, t in self.static.items()}
        return self.step(**feeds, **(self.state if state is None
                                     else state))

    # -- capture -------------------------------------------------------------
    def capture(self) -> None:
        """Capture the step over the static buffers as a CUDA graph, on a
        side stream after one eager call there (PyTorch's graph recipe:
        the library handles and workspaces a capture must not create are
        made then). The capture is ``thread_local``
        (``CAPTURE_ERROR_MODE``): another thread of the process that
        allocates or synchronizes meanwhile (a serving worker, an HTTP
        handler copying a result to the host) does not break it. The buffers are zeroed first: every row of those
        calls is idle and writes only junk page 0. The replays' launch
        counts are the graph's kernel nodes (``graph_launches``). Raises
        ``RuntimeError`` when the step cannot be captured."""
        if not self._cuda:
            raise ValueError(f"the {self.name} step runs on {self.device}: "
                             "a CUDA graph needs a CUDA device")
        if self.graph is not None:
            raise RuntimeError(f"the {self.name} step is already captured")
        for t in self.static.values():
            t.zero_()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.step(**self.static, **self.state)
        cur.wait_stream(side)
        torch.cuda.synchronize(self.device)
        # kept un-instantiated at the end of the capture, so that its
        # nodes can be read
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with _build.recording() as tally, \
                    torch.cuda.graph(graph, stream=side,
                                     capture_error_mode=CAPTURE_ERROR_MODE):
                out = self.step(**self.static, **self.state)
            graph.instantiate()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the {self.name} step "
                               f"failed: {e}") from e
        self.launches = graph_launches(
            kernel_node_names(graph.raw_cuda_graph()), tally, self.name)
        self.graph, self.out = graph, out
        self.captures += 1
