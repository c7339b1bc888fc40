"""Inference entry points (counterpart of ``paddle_tpu.inference``):
the Program Predictor over a directory saved by
``io.save_inference_model``."""

from .predictor import (AnalysisConfig, Config, PaddlePredictor, Predictor,
                        create_paddle_predictor, create_predictor)

__all__ = ["AnalysisConfig", "Config", "PaddlePredictor", "Predictor",
           "create_paddle_predictor", "create_predictor"]
