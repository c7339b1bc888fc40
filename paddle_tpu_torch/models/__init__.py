"""Model configurations (the GPT config for the serving slice)."""

from .gpt import GPTConfig

__all__ = ["GPTConfig"]
