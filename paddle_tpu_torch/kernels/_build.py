"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ONE shared library with a plain C interface, loaded with
``ctypes``: no PyTorch headers are compiled, so a build takes seconds.
The sources compile in parallel (one ``nvcc`` per file, all started
together), then one link. The library lands in ``kernels/build/``
(listed in ``.gitignore``) under a name that carries the hash of the
sources and flags, so it is built at first use and again whenever a
source changes.

Nothing here runs at import: ``nvcc`` is looked up and invoked only by
``library()``, which only a wrapper that is about to launch a kernel on
a CUDA tensor calls. On a machine without ``nvcc`` that call raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "sources", "source_hash",
           "count", "recording", "evaluating_shapes", "takes_plain",
           "find_nvcc", "build", "library", "last_build"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LIB_STEM = "libpaddle_tpu_torch_kernels"

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_i64 = ctypes.c_longlong
# argtypes of every C entry of the library: pointers and the stream are
# c_void_p (a bare int would be cut to 32 bits), sizes c_int, element
# counts and label values c_longlong
SIGNATURES: Dict[str, List] = {
    "pt_layer_norm_fwd": [_vp] * 6 + [_int, _int, _float] + [_int] * 4
                         + [_vp],
    "pt_layer_norm_bwd": [_vp] * 9 + [_int] * 8 + [_vp],
    "pt_ragged_paged_attention": [_vp] * 9 + [_int] * 10 + [_float, _int,
                                                             _int, _vp],
    "pt_softmax_xent_fwd": [_vp] * 4 + [_int, _int, _i64, _int, _vp],
    "pt_softmax_xent_bwd": [_vp] * 5 + [_int, _int, _i64, _int, _vp],
    "pt_fused_adam": [_vp] * 8 + [_i64] + [_float] * 6 + [_int, _vp],
    "pt_fused_momentum": [_vp] * 5 + [_i64, _float, _int, _int, _vp],
    "pt_paged_attention": [_vp] * 8 + [_int] * 9 + [_float, _int, _vp],
    "pt_flash_attention_fwd": [_vp] * 7 + [_int] * 6 + [_float, _int, _int,
                                                        _vp],
    "pt_flash_attention_bwd_delta": [_vp] * 3 + [_i64, _int, _int, _vp],
    "pt_flash_attention_bwd_dq": [_vp] * 10 + [_int] * 6 + [_float, _int,
                                                            _int, _vp],
    "pt_flash_attention_bwd_dkv": [_vp] * 10 + [_int] * 6 + [_float, _int,
                                                             _int, _vp],
    "pt_ragged_paged_attention_q": [_vp] * 11 + [_int] * 10 + [_float, _int,
                                                               _int, _vp],
    "pt_quant_matmul": [_vp] * 5 + [_int] * 6 + [_vp],
    "pt_quant_matmul_fma": [_vp] * 4 + [_int] * 4 + [_vp],
    "pt_batched_lora_add": [_vp] * 4 + [ctypes.POINTER(_vp)] * 3
                           + [ctypes.POINTER(_int)] * 2 + [_int] * 10 + [_vp],
}

# shape evaluation (``runtime.dispatch.eval_shapes``) on this thread
_shape_eval = threading.local()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_last_build: Dict[str, object] = {}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """sha256 over every source and header under csrc/ and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of paddle_tpu_torch are built from "
        "kernels/csrc/ at first use and need the CUDA toolkit")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the library unless the current sources are
    already built; returns its path. ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills of each kernel) to the log kept
    in ``last_build()``. Raises RuntimeError with nvcc's output when a
    source does not compile."""
    out = BUILD_DIR / f"{LIB_STEM}_{source_hash()[:16]}.so"
    if out.exists() and not verbose:
        _last_build.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    extra = ["-Xptxas", "-v"] if verbose else []
    log: List[str] = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _obj, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
             *[obj for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        os.replace(tmp_lib, out)   # atomic: a concurrent loader sees all
    seconds = time.perf_counter() - t0
    _last_build.update(path=str(out), seconds=seconds, cached=False,
                       log="\n".join(log))
    from .. import profiler

    profiler.record_compile("kernels/build", seconds)
    return out


def last_build() -> Dict[str, object]:
    """path, seconds, cached and the compiler log of the last build()."""
    return dict(_last_build)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes
    and restype set on every entry. One load per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


_recording = threading.local()


def count(fn) -> None:
    """One launch of wrapper ``fn``'s kernel: added to ``fn.launches``,
    or, while this thread captures a CUDA graph (``recording``), to the
    capture's tally under ``fn.__name__``: a capture launches nothing,
    the graph's replays do (``runtime/graphs.py``)."""
    tally = getattr(_recording, "tally", None)
    if tally is None:
        fn.launches += 1
    else:
        tally[fn.__name__] = tally.get(fn.__name__, 0) + 1


@contextlib.contextmanager
def recording():
    """Count this thread's launches into a fresh tally (yielded) instead
    of the wrappers' counters, for the span of a CUDA graph capture."""
    saved = getattr(_recording, "tally", None)
    _recording.tally = tally = {}
    try:
        yield tally
    finally:
        _recording.tally = saved


@contextlib.contextmanager
def evaluating_shapes():
    """While this thread evaluates shapes on ``meta`` tensors
    (``runtime.dispatch.eval_shapes``), the wrappers that a Program's
    ops reach take a meta tensor down their plain version, which
    computes no values; outside it, a meta tensor raises as any device
    other than the CPU and CUDA does."""
    saved = getattr(_shape_eval, "on", False)
    _shape_eval.on = True
    try:
        yield
    finally:
        _shape_eval.on = saved


def takes_plain(t) -> bool:
    """Whether a wrapper hands tensor ``t`` to its plain version: a CPU
    tensor, or a meta tensor inside ``evaluating_shapes``. A CUDA tensor
    never does: it launches the kernel or raises."""
    kind = t.device.type
    return kind == "cpu" or (kind == "meta"
                             and getattr(_shape_eval, "on", False))
