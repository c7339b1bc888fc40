"""The flags the port reads, with the JAX package's names and API.

A copy of the matching entries of ``paddle_tpu/flags.py`` and of its
``get_flags`` / ``set_flags`` / ``flag`` (:368-395). Only what the
ported slices read is here; the reference's env overrides, autotune
profiles and live-flag generations come with the host tiers.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["DEFAULTS", "flag", "get_flags", "set_flags",
           "optimizer_fuse_enabled"]

DEFAULTS = {
    # the paged KV cache preallocates generation_num_pages pages of
    # generation_page_size token slots per layer (page 0 is the junk
    # page); the engine runs generation_max_decode_batch lanes
    "generation_page_size": 16,
    "generation_num_pages": 512,
    "generation_max_decode_batch": 8,
    "generation_queue_capacity": 64,
    "generation_max_new_tokens": 64,
    # one [lanes, generation_chunk_tokens] mixed prefill+decode step;
    # longer prompts prefill in chunks across steps
    "generation_chunk_tokens": 16,
    # "auto" | "on" | "off": AdamOptimizer emits the one-pass fused_adam
    # op (the K10 kernel on CUDA) instead of the unfused adam chain
    "optimizer_fuse": "auto",
}

_flags: Dict[str, Any] = dict(DEFAULTS)


def _key(name: str) -> str:
    key = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
    if key not in _flags:
        raise ValueError(f"unknown flag {name!r}; the port knows "
                         f"{sorted(_flags)}")
    return key


def flag(name: str):
    """The current value of one flag (KeyError names the flag)."""
    try:
        return _flags[name]
    except KeyError:
        raise KeyError(f"unknown flag {name!r}; the port knows "
                       f"{sorted(_flags)}") from None


def get_flags(names) -> Dict[str, Any]:
    if isinstance(names, str):
        names = [names]
    return {n: _flags[_key(n)] for n in names}


def set_flags(flag_dict: Dict[str, Any]) -> None:
    for n, v in flag_dict.items():
        _flags[_key(n)] = v


def optimizer_fuse_enabled() -> bool:
    """The ``optimizer_fuse`` flag: "on"/"off" force; "auto" fuses when
    a CUDA device is present, the counterpart of the reference's
    ``jax.default_backend() == "tpu"`` (``kernels/fused_optim.py``
    :253-273)."""
    v = str(flag("optimizer_fuse")).lower()
    if v in ("on", "1", "true", "yes"):
        return True
    if v in ("off", "0", "false", "no"):
        return False
    return torch.cuda.is_available()
