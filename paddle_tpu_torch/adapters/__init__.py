"""paddle_tpu_torch.adapters — batched LoRA multiplexing (counterpart
of ``paddle_tpu.adapters``): device-resident, rank-bucketed factor
pools (``store.AdapterStore``), the step-model rewrite that routes
each batch row's adapter delta into the matmuls
(``rewrite.rewrite_for_lora``, over the K12 kernel), and per-row slots
fed by the ragged engine (``GenerationEngine(adapter_store=...)``,
``submit(..., adapter=...)``).

The HTTP admin surface is ``serving.ServingServer``'s
``/v1/admin/adapters`` and ``/v1/admin/adapters/evict``; the hot base
swap under an adapter store is ``GenerationEngine.swap_base``; the
traffic tier's per-(tenant, adapter) quotas are
``traffic.parse_adapter_quotas`` (the ``traffic_adapter_quotas`` flag).
Every store registers with the metrics registry
(``paddle_adapter_*{store=}``).
"""

from .rewrite import LoraReport, lora_targets, rewrite_for_lora
from .store import (DEFAULT_RANK_BUCKETS, AdapterError, AdapterInUse,
                    AdapterMissing, AdapterPoolFull, AdapterQuotaExceeded,
                    AdapterStore)

__all__ = ["AdapterStore", "AdapterError", "AdapterMissing",
           "AdapterPoolFull", "AdapterQuotaExceeded", "AdapterInUse",
           "DEFAULT_RANK_BUCKETS", "rewrite_for_lora", "lora_targets",
           "LoraReport"]
