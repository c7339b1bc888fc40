"""LeNet for MNIST: the port's copy of ``paddle_tpu/models/mnist.py``
(Fluid's tests/book/test_recognize_digits.py), and seeded MNIST-shaped
batches."""

from __future__ import annotations

import numpy as np

from .. import layers, nets
from ..core.framework import Program, program_guard

__all__ = ["build_lenet", "synthetic_mnist_batch"]


def build_lenet(optimizer=None):
    """(main, startup, feeds, fetches): img [N, 1, 28, 28] float32 and
    label [N, 1] int64 in; loss and top-1 acc out; two conv-pool blocks
    and three fc layers; ``optimizer.minimize(loss)`` when given."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", [1, 28, 28])
        label = layers.data("label", [1], dtype="int64")
        c1 = nets.simple_img_conv_pool(img, 6, 5, 2, 2, conv_padding=2, act="relu")
        c2 = nets.simple_img_conv_pool(c1, 16, 5, 2, 2, act="relu")
        f1 = layers.fc(c2, 120, act="relu")
        f2 = layers.fc(f1, 84, act="relu")
        logits = layers.fc(f2, 10)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        if optimizer is not None:
            optimizer.minimize(loss)
    return main, startup, {"img": img, "label": label}, {"loss": loss, "acc": acc}


def synthetic_mnist_batch(rng: np.random.RandomState, batch: int):
    """MNIST-shaped data from a seed: images uniform in [0, 1), labels
    uniform over the 10 digits."""
    return {"img": rng.rand(batch, 1, 28, 28).astype("float32"),
            "label": rng.randint(0, 10, (batch, 1)).astype("int64")}
