"""Inference serving (counterpart of ``paddle_tpu.serving``): dynamic
micro-batching over the Program Predictor and its HTTP front end.

    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.serving import ServingEngine, ServingServer

    cfg = Config(model_dir); cfg.enable_shape_bucketing()
    engine = ServingEngine(create_predictor(cfg))
    outs = engine.predict({"ids": ids, "mask": mask}, deadline_ms=50)
    srv = ServingServer(engine, port=8500)   # /v1/predict /healthz /metrics

Streamed ``POST /v1/generate`` and the adapter admin endpoints serve a
``generation.GenerationEngine`` passed as
``ServingServer(engine, generation_engine=...)``.
"""

from .engine import (DeadlineExceeded, EngineClosed, Overloaded,
                     RequestCancelled, ServingEngine, ServingError,
                     ServingFuture)
from .metrics import ServingMetrics, StreamingHistogram
from .server import ServingServer

__all__ = ["ServingEngine", "ServingServer", "ServingMetrics",
           "StreamingHistogram", "ServingFuture", "ServingError",
           "Overloaded", "DeadlineExceeded", "EngineClosed",
           "RequestCancelled"]
