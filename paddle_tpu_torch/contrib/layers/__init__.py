"""fluid.contrib.layers: the port has its RNN stacks and cells
(``rnn_impl.py``); the rest of ``paddle_tpu/contrib/layers/`` is ROADMAP
A11."""

from .rnn_impl import *  # noqa: F401,F403
from . import rnn_impl

__all__ = list(rnn_impl.__all__)
