"""Feeds onto the device ahead of the step: the one H2D path of the
data tiers (``reader.GeneratorLoader``'s prefetch thread and
``BoundStep.run_pipelined``'s feeder).

The JAX package starts ``jax.device_put`` on its loader thread
(``paddle_tpu/reader.py:149-168``) and lets the runtime order the copy
before the step. Here the ordering is explicit, as the reference's
``operators/reader/buffered_reader.cc`` does it on a CUDA stream:

* ``host_tensor`` turns a feed value into the host tensor
  ``BoundStep.run`` would make of it (the variable's dtype, else
  float64 as float32), so a prefetched batch equals a plain step's feed
  bit for bit;
* ``DeviceStager.stage`` (producer thread) copies the host tensors into
  pinned memory and from there to the card with ``non_blocking=True``
  on a stream of its own, and records an event after the copies;
* ``claim`` (consumer thread) makes the consumer's current stream wait
  for that event and calls ``record_stream`` on every tensor: the
  tensors were allocated on the side stream, and without it the caching
  allocator could hand their blocks to the next batch's copy while the
  step still reads them.

On the CPU there is nothing to copy: ``stage`` returns the host tensors
and no event.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["host_tensor", "DeviceStager", "claim"]


def host_tensor(value, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``value`` as a tensor of ``dtype`` (None: float64 becomes float32,
    anything else keeps its dtype). A tensor stays on its device; any
    other value becomes a host tensor (sharing a numpy array's memory
    where no cast is needed)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        arr = np.asarray(value)
        if arr.dtype == np.float64 and dtype is None:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t if dtype is None else t.to(dtype)


class DeviceStager:
    """Copies host tensors to ``device`` on a dedicated CUDA stream."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def stage(self, tensors: Sequence[torch.Tensor]
              ) -> Tuple[List[torch.Tensor], Any]:
        """(the tensors on the device, the event after their copies). A
        tensor already on a CUDA device passes untouched; the event then
        also follows the work queued on this thread's stream (a loader's
        batch, which its own ``claim`` ordered there)."""
        if self.stream is None:
            return list(tensors), None
        out = []
        if any(t.is_cuda for t in tensors):
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for t in tensors:
                if t.is_cuda:
                    out.append(t)
                else:
                    out.append(t.pin_memory().to(self.device,
                                                 non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event


def claim(tensors: Sequence[torch.Tensor], event) -> List[torch.Tensor]:
    """On the consuming thread: order its current stream after the
    copies and tie every tensor's memory to that stream."""
    if event is None:
        return list(tensors)
    stream = torch.cuda.current_stream(tensors[0].device if tensors
                                       else None)
    stream.wait_event(event)
    for t in tensors:
        if t.is_cuda:
            t.record_stream(stream)
    return list(tensors)
