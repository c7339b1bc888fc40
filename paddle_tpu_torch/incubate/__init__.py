"""``fluid.incubate``: the dataset-authoring generators and fleet's
training utilities (the port's copy of ``paddle_tpu/incubate/``)."""

from . import data_generator, fleet  # noqa: F401
