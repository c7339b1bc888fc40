"""paddle_tpu_torch: the PyTorch / CUDA (Hopper) port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package is
its counterpart in PyTorch idiom (``nn.Module``s, plain functions on
tensors, an explicit ``device``, explicit ``torch.Generator``s). It
never imports ``jax``, ``jaxlib`` or any part of ``paddle_tpu``: what
it needs from there it keeps as its own copy.

Ported so far (the serving slice): the ragged ``GenerationEngine``
over a GPT ``Predictor``, with hand-written CUDA kernels for the
ragged paged attention and the layer-norm forward.

    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.generation import GenerationEngine
    pred = create_predictor(Config(lm_model_dir))      # CUDA by default
    eng = GenerationEngine(pred, pred.gpt_config)
    eng.generate([1, 5, 9], max_new_tokens=32)

Entry points run on CUDA unless the caller passes ``device="cpu"``;
with no GPU and no device given they raise instead of falling back.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
