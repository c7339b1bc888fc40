"""paddle_tpu_torch.disagg: disaggregated prefill/decode serving (the
counterpart of ``paddle_tpu/disagg/``).

The package splits the two inference phases onto separate engines and
streams finished KV pages between them through a host-RAM page store:

* ``pagestore`` — the store itself (radix-keyed page runs), the
  blockwise-int8 wire encoding (int8-KV pool pages ship VERBATIM;
  fp32 pages quantize one scale per (head, token-slot) — exactly the
  pool's scale-plane layout), the length-prefixed TCP server/client,
  and coordinator-env store discovery.
* ``roles`` — ``PrefillWorker`` (engine pinned to chunked prefill,
  publishes pages to the store), ``DecodeWorker`` (admission consults
  the store before cold prefill and resumes at the fork point), and
  ``DisaggService`` (the engine-shaped facade the traffic tier drives
  unchanged: admit once, prefill on the prefill pool, hand the ticket
  to the decode worker the ``paddle_generation_*`` gauges pick).

Because the decode worker re-derives the first output token from the
spliced prefix, the split topology is token-identical to co-located
greedy serving: the pages splice bit for bit with int8 KV pools or
``disagg_wire_encoding="raw"``. On the card the two engines of a split
share the SMs, so the decode ITL under a prefill flood is reported
(``chip_smoke.py --phases f``), not gated.
"""

from __future__ import annotations

from .pagestore import (HostPageStore, PageStoreClient, PageStoreServer,
                        decode_page, discover_store, encode_page,
                        encode_pages, fp32_page_bytes, run_for_pool,
                        store_endpoint_from_env)
from .roles import DecodeWorker, DisaggService, DisaggStream, PrefillWorker

__all__ = [
    "HostPageStore", "PageStoreServer", "PageStoreClient",
    "encode_page", "encode_pages", "decode_page", "run_for_pool",
    "fp32_page_bytes",
    "store_endpoint_from_env", "discover_store",
    "PrefillWorker", "DecodeWorker", "DisaggService", "DisaggStream",
]
