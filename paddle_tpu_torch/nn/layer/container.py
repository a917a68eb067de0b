"""Containers (port of paddle_tpu/nn/layer/container.py): ``Sequential``,
``LayerList``, ``ParameterList`` and ``LayerDict`` over ``Layer``'s
registry (Module's ``_modules`` and ``_parameters``)."""
from __future__ import annotations

import collections

from ..layer_base import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            for name, l in layers[0].items():
                self.add_sublayer(name, l)
        else:
            for i, l in enumerate(layers):
                if isinstance(l, (list, tuple)) and len(l) == 2:
                    self.add_sublayer(l[0], l[1])
                else:
                    self.add_sublayer(str(i), l)

    def forward(self, x):
        for l in self._modules.values():
            x = l(x)
        return x

    def __getitem__(self, idx):
        keys = list(self._modules)
        if isinstance(idx, slice):
            return Sequential(*[self._modules[k] for k in keys[idx]])
        return self._modules[keys[idx]]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._modules.clear()
        for i, l in enumerate(layers):
            self._modules[str(i)] = l

    def extend(self, sublayers):
        for l in sublayers:
            self.append(l)
        return self

    def __getitem__(self, idx):
        keys = list(self._modules)
        if isinstance(idx, slice):
            return LayerList([self._modules[k] for k in keys[idx]])
        return self._modules[keys[idx]]

    def __setitem__(self, idx, layer):
        self._modules[list(self._modules)[idx]] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return self._parameters[list(self._parameters)[idx]]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) else sublayers
        for name, l in items:
            self.add_sublayer(name, l)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __contains__(self, key):
        return key in self._modules

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def pop(self, key):
        l = self._modules[key]
        del self._modules[key]
        return l

    def clear(self):
        self._modules.clear()
