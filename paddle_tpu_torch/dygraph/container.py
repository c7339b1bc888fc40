"""Layer containers: the port's copy of ``paddle_tpu/dygraph/container.py``
(reference fluid/dygraph/container.py)."""

from __future__ import annotations

from .layers import Layer


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        for i, l in enumerate(layers):
            if isinstance(l, (list, tuple)):
                name, l = l
            else:
                name = str(i)
            self.add_sublayer(name, l)

    def forward(self, x):
        for l in self._sub_layers.values():
            x = l(x)
        return x

    def __getitem__(self, i):
        return list(self._sub_layers.values())[i]

    def __len__(self):
        return len(self._sub_layers)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, l in enumerate(sublayers or []):
            self.add_sublayer(str(i), l)

    def append(self, l):
        self.add_sublayer(str(len(self._sub_layers)), l)
        return self

    def __getitem__(self, i):
        return list(self._sub_layers.values())[i]

    def __iter__(self):
        return iter(self._sub_layers.values())

    def __len__(self):
        return len(self._sub_layers)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.add_parameter(str(i), p)

    def append(self, p):
        self.add_parameter(str(len(self._parameters)), p)
        return self

    def __getitem__(self, i):
        return list(self._parameters.values())[i]

    def __iter__(self):
        return iter(self._parameters.values())

    def __len__(self):
        return len(self._parameters)
