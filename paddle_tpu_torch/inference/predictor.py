"""Predictor API (counterpart of ``paddle_tpu/inference/predictor.py``).

    pred = create_predictor(Config(lm_model_dir))          # on CUDA
    (logits,) = pred.run([tokens])                         # [B, S] -> [B, S, V]

A ``Config`` names either a directory saved by the JAX package's
``save_inference_model`` for a ``build_lm_program`` GPT (its
``__params__.npz`` and ``__model__`` are read with numpy and json), or
in-memory weights under the same names (``Config.set_params``). The
predictor runs the ``GPTLM`` module; it is the generation engine's
source of weights and its independent oracle.

Unlike the JAX predictor, whose program is compiled for the saved
sequence length, ``run`` takes any sequence length up to
``max_position``.

Weight quantization (``inference/predictor.py:107, :187-202`` there):
``Config.enable_weight_quantization(mode)``, or the ``quantize_weights``
flag, quantizes every matmul weight once at load
(``quantize.rewrite_for_inference``); ``predictor.quantize_report``
says what was quantized and why anything stayed float.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import io
from ..device import resolve_device
from ..flags import flag
from ..generation.model import GPTLM, load_jax_params
from ..models.gpt import GPTConfig
from ..quantize import rewrite_for_inference

__all__ = ["Config", "Predictor", "create_predictor"]


class Config:
    """Where the model comes from: ``Config(model_dir)``, or
    ``Config().set_params(gpt_config, params)`` for weights in memory
    (numpy arrays or tensors under the ``__params__.npz`` names)."""

    def __init__(self, model_dir: Optional[str] = None):
        self.model_dir = model_dir
        self.gpt_config: Optional[GPTConfig] = None
        self.params: Optional[Dict[str, object]] = None
        self._quantize_weights: Optional[str] = None

    def set_params(self, gpt_config: GPTConfig,
                   params: Dict[str, object]) -> "Config":
        self.gpt_config = gpt_config
        self.params = params
        return self

    def enable_weight_quantization(self, mode: str = "int8") -> "Config":
        """Quantize every matmul weight once at load: ``mode`` in
        {"int8", "int8_block", "fp8", "off"} (per-instance override of
        the ``quantize_weights`` flag; the block is ``quantize_block``)."""
        self._quantize_weights = str(mode)
        return self


class Predictor:
    def __init__(self, config: Config,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if config.params is not None:
            cfg, params = config.gpt_config, config.params
            self.feed_names, self.fetch_names = ["tokens"], ["logits"]
        elif config.model_dir is not None:
            params = io.load_params(config.model_dir)
            meta = io.load_model_meta(config.model_dir)
            cfg = io.gpt_config_from_model(params, meta)
            self.feed_names = list(meta["feed_names"])
            self.fetch_names = list(meta["fetch_names"])
        else:
            raise ValueError("Config names no model directory and no params")
        if len(self.feed_names) != 1:
            raise ValueError(f"a GPT LM takes one feed (tokens); the model "
                             f"has {self.feed_names}")
        self.gpt_config = cfg
        self.lm = GPTLM(cfg, self.device)
        load_jax_params(self.lm, params)
        del params
        # weight quantization at load (config override > flag)
        self.quantize_report = None
        qmode = (config._quantize_weights
                 if config._quantize_weights is not None
                 else str(flag("quantize_weights")))
        if qmode and qmode != "off":
            self.quantize_report = rewrite_for_inference(
                self.lm, qmode, block=int(flag("quantize_block")))
        self._lock = threading.Lock()

    def run(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """[tokens [B, S] int] -> [logits [B, S, V]] as numpy."""
        if len(inputs) != 1:
            raise ValueError(f"run takes [tokens]; got {len(inputs)} inputs")
        tokens = torch.as_tensor(np.asarray(inputs[0], dtype=np.int64))
        if tokens.dim() != 2:
            raise ValueError(f"tokens must be [B, S]; got {tuple(tokens.shape)}")
        with self._lock:
            logits = self.lm(tokens.to(self.device))
            return [logits.float().cpu().numpy()]

    def clone(self) -> "Predictor":
        """Shares the weights (the module), own lock — per-thread use."""
        p = object.__new__(Predictor)
        p.__dict__.update(self.__dict__)
        p._lock = threading.Lock()
        return p


def create_predictor(config: Config,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Predictor:
    """A Predictor on ``device`` (CUDA when None; raises if there is no
    GPU — pass ``device="cpu"`` for the plain CPU path)."""
    return Predictor(config, device)
