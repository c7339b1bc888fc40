"""The ``generation_*`` defaults the ported engine reads.

A copy of the matching entries of ``paddle_tpu/flags.py`` (the engine
ctor arguments override each). Only what this slice reads is here; the
JAX package's flag registry, env overrides and live flags come with
the host tiers.
"""

from __future__ import annotations

__all__ = ["DEFAULTS", "flag"]

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
}


def flag(name: str):
    """The default of one generation flag (KeyError names the flag)."""
    try:
        return DEFAULTS[name]
    except KeyError:
        raise KeyError(f"unknown flag {name!r}; the port knows "
                       f"{sorted(DEFAULTS)}") from None
