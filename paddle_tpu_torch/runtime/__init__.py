"""The bound fast path (the reference's ``paddle_tpu/runtime/``):

  - ``dispatch.py``: ``BoundStep``, what ``Executor.bind`` resolves and
    ``Executor.run`` goes through;
  - ``graphs.py``: ``GraphedStep``, a generation engine's fixed-shape
    step over static buffers, replayed as a CUDA graph on the card.
"""
