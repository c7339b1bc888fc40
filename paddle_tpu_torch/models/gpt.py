"""GPT configuration (a copy of the ``GPTConfig`` dataclass of
``paddle_tpu/models/gpt.py``). The torch modules that run it live in
``generation/model.py``; the Program-IR model functions are the training
slice's work."""

from __future__ import annotations

import dataclasses

__all__ = ["GPTConfig"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    use_flash_attention: bool = False
    # MoE fields kept for a like-for-like config; the port serves
    # dense FFNs only (moe_every must stay 0)
    moe_every: int = 0
    moe_experts: int = 8
    moe_capacity: float = 1.25
    moe_aux_coeff: float = 0.01

    @staticmethod
    def small():
        return GPTConfig()

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=1000, hidden_size=64, num_layers=2,
                         num_heads=4, ffn_size=256, max_position=128,
                         hidden_dropout=0.0, attention_dropout=0.0)

    @staticmethod
    def gpt3_1p3b():
        """GPT-3 XL shape (paper table 2.1): 24 layers, d_model 2048,
        16 heads x 128; ~1.3B params."""
        return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                         ffn_size=8192, max_position=1024)
