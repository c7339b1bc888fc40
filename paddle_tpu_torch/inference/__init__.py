"""Inference entry points (counterpart of ``paddle_tpu.inference``)."""

from .predictor import Config, Predictor, create_predictor

__all__ = ["Config", "Predictor", "create_predictor"]
