"""The flags the port reads, with the JAX package's names and API.

A copy of the matching entries of ``paddle_tpu/flags.py`` (the
generation, quantize and adapter defaults of :60-147, spec and radix
ones included, the serving defaults of :54-57, the data-tier defaults
of :41-47 and :326-329, the ``disagg_*``, ``traffic_*``,
``observability_*`` and ``slo_*`` defaults of :216-312) and of its
``FLAGS_<name>`` environment overrides read at import (``_coerce``, the
pinned set, :337-366) and ``get_flags`` / ``set_flags`` / ``flag`` /
``generation`` (:368-395). ``set_flags`` bumps the generation, which
``Executor.bind`` keys on, so a flag change re-binds a step. Only what
the ported slices read is here (``observability_xla_analysis`` has no
XLA to analyse); the autotune profiles (:399-570) are ROADMAP A11.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

__all__ = ["DEFAULTS", "flag", "get_flags", "set_flags", "generation",
           "optimizer_fuse_enabled"]

DEFAULTS = {
    # the overlapped step (BoundStep.run_pipelined / Executor.
    # run_pipelined): prepared feeds the feeder thread may run ahead of
    # the step; 2 is double buffering (one batch in the step, one being
    # normalized and copied to the card), each more pins one more batch
    "dispatch_pipeline_depth": 2,
    # reader.py GeneratorLoader: batches the loader thread stages on the
    # device ahead of the consumer (each entry holds one batch of device
    # memory); raise it only when paddle_reader_buffer_empty_stall_total
    # shows a bursty input pipeline starving the step
    "reader_prefetch_depth": 2,
    # accepted, inert: the reference's reader benchmark mode and its
    # profiler's output name (profiler.profiler(profile_path=) names it)
    "reader_queue_speed_test_mode": False,
    "tracer_profile_fname": "",
    # the paged KV cache preallocates generation_num_pages pages of
    # generation_page_size token slots per layer (page 0 is the junk
    # page); the engine runs generation_max_decode_batch lanes
    "generation_page_size": 16,
    "generation_num_pages": 512,
    "generation_max_decode_batch": 8,
    "generation_queue_capacity": 64,
    "generation_max_new_tokens": 64,
    # "ragged" (the default): one [lanes, generation_chunk_tokens] mixed
    # prefill+decode step, longer prompts prefilling in chunks across
    # steps; "two_lane": a prefill lane over a ladder of sequence buckets
    # (generation_prefill_buckets, max_position always added) and a
    # decode lane of one token per sequence (the K13 kernel)
    "generation_engine_mode": "ragged",
    "generation_chunk_tokens": 16,
    "generation_prefill_buckets": "16,32,64,128,256,512",
    # generation_spec_tokens > 0 turns on speculative decoding: a draft
    # model (GenerationEngine(draft=...)) proposes up to k tokens per
    # sequence per step and the target verifies them in the same ragged
    # step, greedy-identical by construction
    "generation_spec_tokens": 0,
    # radix prefix cache (generation/kvcache.py trie, ragged only):
    # generation_prefix_cache publishes every full KV page into a
    # refcounted prefix trie and admits new prompts ONTO their matched
    # prefix pages (copy-on-write sharing: a warm shared prompt
    # prefills once and occupies one set of pages).
    # generation_prefix_min_pages is the match granularity floor
    # (matches shorter than this many full pages are ignored);
    # generation_trie_max_pages caps trie-resident pages (0 =
    # unlimited; the pool itself still reclaims trie leaves LRU-first
    # under pressure); generation_trie_tenant_quota caps trie-resident
    # pages PER TENANT (submit(tenant=) attributes publishes): a tenant
    # at quota recycles its OWN LRU leaves (0 = no per-tenant cap)
    "generation_prefix_cache": False,
    "generation_prefix_min_pages": 1,
    "generation_trie_max_pages": 0,
    "generation_trie_tenant_quota": 0,
    # "float32" or "int8": int8 KV pages with one float32 scale per
    # (kv head, token slot), about 3.9x the tokens a pool byte budget
    # holds at head_dim 128 (the ragged engine's K2q path)
    "generation_kv_dtype": "float32",
    # "off" | "int8" | "int8_block" | "fp8": Predictor construction and
    # the GenerationEngine quantize every matmul weight ONCE at load
    # (the fp32 originals dropped) and run it through the K11 kernel;
    # quantize_block is int8_block's block down the contraction axis.
    # Per instance: Config.enable_weight_quantization /
    # GenerationEngine(quantize_weights=...)
    "quantize_weights": "off",
    "quantize_block": 256,
    # batched LoRA (ragged engine): adapter_pool_max_bytes > 0 builds an
    # AdapterStore over every matmul weight at engine construction;
    # adapter_rank_buckets names the bucket ranks; adapter_slots_per_
    # bucket > 0 overrides the byte-derived slots per bucket (the zero
    # slot excluded); adapter_tenant_quota caps resident adapters per
    # tenant (0 = none)
    "adapter_pool_max_bytes": 0,
    "adapter_rank_buckets": "8,16",
    "adapter_slots_per_bucket": 0,
    "adapter_tenant_quota": 0,
    # the traffic tier's per-(tenant, adapter) admission table
    # ("alice:summarize=10:20,*:translate=5": name:adapter=rate[:burst],
    # "*" matches any tenant); "" = no per-adapter admission
    "traffic_adapter_quotas": "",
    # serving (paddle_tpu_torch.serving): the ServingEngine coalesces
    # up to serving_max_batch_size rows or waits serving_batch_timeout_ms,
    # whichever first; a full admission queue (serving_queue_capacity)
    # rejects with Overloaded; serving_num_workers Predictor clones run
    # the batches
    "serving_max_batch_size": 16,
    "serving_batch_timeout_ms": 5.0,
    "serving_queue_capacity": 256,
    "serving_num_workers": 2,
    # disagg/ (disaggregated prefill/decode serving): the page-store
    # rendezvous between prefill and decode workers.
    # disagg_wire_encoding picks how float32 KV pages cross the wire:
    # "int8_block" quantizes blockwise at block=head_dim (one float32
    # scale per head/token slot; int8 pool pages always ship verbatim),
    # "raw" ships float32 bytes untouched. disagg_store_endpoint
    # ("host:port") names the page store when the env contract
    # (PADDLE_PAGESTORE_ENDPOINT, or the first PADDLE_TRAINER_ENDPOINTS
    # host at disagg_store_port) does not; disagg_store_max_bytes caps
    # the store's host RAM (LRU leaf eviction; 0 = unbounded);
    # disagg_fetch_timeout_s bounds every store RPC;
    # disagg_handoff_threads sizes the DisaggService's prefill->decode
    # dispatcher pool
    "disagg_wire_encoding": "int8_block",
    "disagg_store_endpoint": "",
    "disagg_store_port": 8793,
    "disagg_store_max_bytes": 268435456,
    "disagg_fetch_timeout_s": 5.0,
    "disagg_handoff_threads": 2,
    # traffic/ (SLO-aware admission, TrafficConfig.from_flags):
    # traffic_queue_capacity is the bounded depth of each priority
    # class's queue; traffic_tenants declares per-tenant token buckets
    # ("alice=100:200,bob=50" = name=rate_rps[:burst]); unknown tenants
    # get traffic_default_rate / traffic_default_burst (rate 0 =
    # unlimited); a queued batch/best_effort request is promoted one
    # class per traffic_aging_ms; traffic_shed_headroom scales the
    # service-time estimate when deciding a deadline is unmeetable;
    # traffic_max_inflight bounds requests handed to the engine at once
    # (0 = from the engine's batch geometry); a deadline-miss ratio
    # above traffic_slo_miss_threshold for traffic_slo_window_s dumps
    # the flight recorder; a streamed /v1/generate whose client stops
    # reading for traffic_stream_write_timeout_s seconds is cancelled
    # (its KV pages free at the next step; 0 disables)
    "traffic_queue_capacity": 64,
    "traffic_tenants": "",
    "traffic_default_rate": 0.0,
    "traffic_default_burst": 0.0,
    "traffic_aging_ms": 500.0,
    "traffic_shed_headroom": 1.2,
    "traffic_max_inflight": 0,
    "traffic_slo_miss_threshold": 0.5,
    "traffic_slo_window_s": 5.0,
    "traffic_stream_write_timeout_s": 30.0,
    # "auto" | "on" | "off": AdamOptimizer emits the one-pass fused_adam
    # op (the K10 kernel on CUDA) instead of the unfused adam chain
    "optimizer_fuse": "auto",
    # supervised training (resilience/): a checkpoint every N steps or
    # every T seconds, whichever fires first (0 disables that trigger);
    # keep_last bounds the retention GC; a step that raises is retried
    # up to resilience_max_retries times with exponential backoff from
    # resilience_retry_backoff_s; a non-finite loss rolls back to the
    # last committed checkpoint at most resilience_max_rollbacks times;
    # resilience_watchdog_timeout_s > 0 runs each step under a hang
    # watchdog; resilience_fault_spec injects deterministic faults
    # ("raise@12,nan@20,hang@30:2.5,kill@40") for chaos testing
    "resilience_ckpt_every_steps": 50,
    "resilience_ckpt_every_secs": 0.0,
    "resilience_keep_last": 3,
    "resilience_max_retries": 3,
    "resilience_retry_backoff_s": 0.05,
    "resilience_max_rollbacks": 2,
    "resilience_watchdog_timeout_s": 0.0,
    "resilience_fault_spec": "",
    # bounds every phase of a multi-process checkpoint save: the
    # stage-ready handshake, rank 0's wait for every shard-done file and
    # the other ranks' wait for the commit marker
    "dist_commit_timeout_s": 120.0,
    # observability_metrics turns on the per-step telemetry (wall time,
    # examples/s) of bound steps, the traffic estimator's input;
    # observability_tracing turns span call sites into trace-id/span-id
    # spans logged into the flight recorder; observability_flight keeps
    # the constant-memory ring (capacity entries) that dumps JSON to
    # observability_dump_dir ("" = the system tempdir) on a NaN
    # rollback, a watchdog hang, SIGTERM or SIGUSR2
    "observability_metrics": True,
    "observability_tracing": False,
    "observability_flight": True,
    "observability_flight_capacity": 512,
    "observability_dump_dir": "",
    # fleet observability (observability/fleet.py):
    # observability_fleet_endpoints seeds the FleetAggregator with a
    # comma list of worker metrics endpoints ("name=host:port" or bare
    # "host:port"); observability_fleet_timeout_s is the per-endpoint
    # scrape deadline. slo_deadline_miss_budget is the error budget the
    # burn rate is measured against; slo_ttft_p99_ms / slo_itl_p99_ms
    # are latency targets (0 = none); slo_window_s is the sliding
    # window; slo_burn_threshold > 0 arms the sustained-burn trigger
    # (one fleet-wide flight dump, latched until the burn recedes)
    "observability_fleet_endpoints": "",
    "observability_fleet_timeout_s": 1.0,
    "slo_deadline_miss_budget": 0.01,
    "slo_ttft_p99_ms": 0.0,
    "slo_itl_p99_ms": 0.0,
    "slo_window_s": 30.0,
    "slo_burn_threshold": 0.0,
}

_flags: Dict[str, Any] = {}

# bumped by every set_flags: Executor.bind keys its bound steps on it,
# so a step bound under other flag values is bound anew
_generation = 0

# flags the user pinned (FLAGS_<name> in the environment or set_flags),
# as opposed to defaults
_explicit: set = set()


def _coerce(default, raw: str):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def _init():
    for name, default in DEFAULTS.items():
        env = os.environ.get(f"FLAGS_{name}")
        if env is not None:
            _flags[name] = _coerce(default, env)
            _explicit.add(name)
        else:
            _flags[name] = default


_init()


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
    global _generation
    for n, v in flag_dict.items():
        key = _key(n)
        _flags[key] = v
        _explicit.add(key)
    _generation += 1


def generation() -> int:
    """How many ``set_flags`` calls this process has made."""
    return _generation


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
