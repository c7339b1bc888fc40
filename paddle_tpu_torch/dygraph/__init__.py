"""Imperative (dygraph) mode: the port's counterpart of
``paddle_tpu/dygraph/`` (reference paddle/fluid/imperative/ and
python/paddle/fluid/dygraph/).

Eager mode runs each op's registered lowering (``core/registry.py``) on
torch tensors at once (``base._trace``), on the device of
``guard(place)`` (``CUDAPlace(0)`` when no place is named, which raises
with no GPU), and ``torch.autograd`` computes the gradients. Layers
trace the same ops as the Program builder, so they run the same
lowerings and, on the card, the same kernels. ``TracedLayer`` and
``to_static`` capture a forward into a CUDA graph (``jit.py``);
``declarative`` rewrites a function's Python control flow
(``dygraph_to_static.py``); ``DataParallel`` sums gradients over a
``torch.distributed`` world.

    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.dygraph as dg
    with dg.guard(fluid.CUDAPlace(0)):          # or fluid.CPUPlace()
        model = dg.Sequential(dg.Linear(8, 32, act="relu"), dg.Linear(32, 3))
        opt = fluid.optimizer.Adam(1e-2)
        loss = fluid.layers.mean(model(dg.to_variable(x)))
        loss.backward()
        opt.minimize(loss, parameter_list=model.parameters())
        model.clear_gradients()
"""

from .base import (
    guard,
    enabled,
    enable_dygraph,
    disable_dygraph,
    to_variable,
    VarBase,
    no_grad,
)
from .layers import Layer
from . import nn
from .nn import Linear, Conv2D, Pool2D, BatchNorm, Embedding, LayerNorm, Dropout
from .parallel import DataParallel, prepare_context, ParallelEnv
from .checkpoint import save_dygraph, load_dygraph
from .jit import (TracedLayer, to_static, dygraph_to_static_graph,
                  dygraph_to_static_output)
from .dygraph_to_static import declarative, convert_to_static
from .container import Sequential, LayerList, ParameterList
from .learning_rate_scheduler import (
    LearningRateDecay, PiecewiseDecay, NaturalExpDecay, ExponentialDecay,
    InverseTimeDecay, PolynomialDecay, CosineDecay, NoamDecay,
)
