"""``Layer`` and ``ParamAttr`` (port of paddle_tpu/nn/layer_base.py).

``Layer`` is a ``torch.nn.Module`` with paddle's names on top of
Module's machinery: parameters, sublayers and buffers are Module's
(``_parameters``, ``_modules``, ``_buffers``), ``__call__`` is Module's
(its forward pre-hooks and forward hooks take paddle's ``(layer,
inputs)`` and ``(layer, inputs, outputs)``), and the optimizers, autograd,
``torch.func.functional_call`` and ``torch.export`` see a Module.

Where a paddle method overrides a Module method of the same name
(``parameters``, ``named_parameters``, ``state_dict``,
``register_buffer``, ``to``), it takes paddle's parameters in paddle's
order and, keyword-only after them, the Module parameters that torch's
own callers pass (``remove_duplicate``, ``recurse``, ``prefix``,
``keep_vars``, ``persistent``).

``create_parameter`` follows paddle_tpu's precedence: the ParamAttr's
initializer, else the global one (``initializer.set_global_initializer``),
else the layer's default. It builds on the card unless the caller asks
otherwise (``device.param_device``): ``set_device("cpu")``, or a torch
device context such as the meta device the models build on. The
parameter carries paddle's attributes: ``optimize_attr["learning_rate"]``,
``regularizer``, ``need_clip``, ``trainable`` (and ``requires_grad =
trainable``), and ``param_name`` where the ParamAttr names it (paddle's
``name``: a torch tensor's ``name`` is read-only); the port's optimizers
and clips read the first three.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import threading

import numpy as np
import torch
from torch import nn

from ..device import param_device
from ..framework.dtype import convert_dtype
from . import initializer as I

__all__ = ["Layer", "ParamAttr"]

_state = threading.local()


@contextlib.contextmanager
def _no_default_init():
    """Build layers without their random default draws, for a caller
    that draws the weights itself afterwards; constant fills still run.
    (The models build on the meta device instead, where nothing is
    drawn.)"""
    prev = getattr(_state, "skip", False)
    _state.skip = True
    try:
        yield
    finally:
        _state.skip = prev


def _skip_random_init() -> bool:
    return getattr(_state, "skip", False)


class ParamAttr:
    """paddle's ``ParamAttr``: a parameter's name, initializer, learning
    rate scale, regularizer, trainability and whether gradient clipping
    applies to it."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None / True -> a default ParamAttr, False -> None (no
        parameter), a string -> its name, an initializer -> its
        initializer; a ParamAttr as it is."""
        if attr is None or attr is True:
            return ParamAttr()
        if attr is False:
            return None
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"Invalid param attr: {attr!r}")


def _as_tensor(value):
    """A torch tensor from a tensor, a numpy array or anything numpy
    takes."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.as_tensor(np.asarray(value))


class Layer(nn.Module):
    """paddle's ``nn.Layer`` over ``torch.nn.Module`` (module
    docstring)."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._name_scope = name_scope or self.__class__.__name__.lower()

    def __deepcopy__(self, memo):
        """Module's deep copy, keeping each parameter's paddle attributes
        (``optimize_attr``, ``regularizer``, ``need_clip``, ...), which
        ``nn.Parameter``'s own deep copy drops."""
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        new.__setstate__(copy.deepcopy(self.__dict__, memo))
        for name, p in self._parameters.items():
            if p is not None and p.__dict__:
                new._parameters[name].__dict__.update(
                    copy.deepcopy(p.__dict__, memo))
        return new

    # ---- construction ----
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new parameter of ``shape`` (None where ``attr`` is False),
        initialised by the ParamAttr's initializer, else the global one,
        else ``default_initializer``, else zeros for a bias and Xavier
        normal for a weight. Built on ``device.param_device()``: the card
        (raises without one) unless ``set_device`` or a torch device
        context says otherwise; on the meta device nothing is drawn, and
        inside ``_no_default_init()`` no random initializer runs."""
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        init = attr.initializer or I._global_initializer(is_bias) or \
            default_initializer or \
            (I.Constant(0.0) if is_bias else I.XavierNormal())
        p = nn.Parameter(torch.empty(
            tuple(int(s) for s in shape),
            dtype=convert_dtype(dtype or self._dtype),
            device=param_device()),
            requires_grad=bool(attr.trainable))
        if not (init.random and _skip_random_init()):
            init._fill(p)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        p.trainable = attr.trainable
        if attr.name is not None:
            p.param_name = attr.name
        return p

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    nn.Parameter):
            parameter = nn.Parameter(_as_tensor(parameter))
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """Module's ``register_buffer``; ``persistable`` is paddle's name
        for ``persistent`` (a non-persistable buffer stays out of
        ``state_dict``)."""
        if persistent is not None:
            persistable = persistent
        super().register_buffer(name, tensor, persistent=bool(persistable))
        return tensor

    # ---- traversal ----
    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """(name, layer) of every sublayer, depth first in registration
        order, each once (``layers_set``: the ids seen)."""
        layers_set = layers_set if layers_set is not None else set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, sub in self._modules.items():
            if sub is None or id(sub) in layers_set:
                continue
            layers_set.add(id(sub))
            p = prefix + ("." if prefix else "") + name
            yield p, sub
            if isinstance(sub, Layer):
                yield from sub.named_sublayers(prefix=p,
                                               layers_set=layers_set)
            else:
                for n, m in sub.named_modules(prefix=p):
                    if m is not sub and id(m) not in layers_set:
                        layers_set.add(id(m))
                        yield n, m

    def parameters(self, include_sublayers=True, *, recurse=None):
        """The parameters, each once, as a list."""
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_parameters(self, prefix="", include_sublayers=True, *,
                         recurse=None, remove_duplicate=True):
        """(name, parameter): this layer's own, then its sublayers' depth
        first, each parameter once (``remove_duplicate``)."""
        if recurse is not None:
            include_sublayers = recurse
        return super().named_parameters(prefix=prefix,
                                        recurse=include_sublayers,
                                        remove_duplicate=remove_duplicate)

    # ---- dtype and device ----
    def astype(self, dtype):
        """Cast the floating-point parameters and buffers to ``dtype`` in
        place (the Parameter objects stay the same)."""
        dt = convert_dtype(dtype)
        return self._apply(lambda t: t.to(dt) if t.is_floating_point()
                           else t)

    def to(self, device=None, dtype=None, blocking=None):
        """Move to ``device`` ("cpu", "gpu", "gpu:N", "cuda:N" or a torch
        device) and cast the floating-point tensors to ``dtype``, in place.
        ``blocking=False`` copies without blocking the host. A torch dtype
        in ``device``'s place is taken as torch's ``to`` takes it."""
        if isinstance(device, torch.dtype):
            device, dtype = None, device
        elif isinstance(device, str):
            device = device.replace("gpu", "cuda")
        kw = {"non_blocking": blocking is False}
        if device is not None:
            kw["device"] = torch.device(device)
        if dtype is not None:
            kw["dtype"] = convert_dtype(dtype)
        return super().to(**kw)

    # ---- state dict ----
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix=None,
                   keep_vars=False):
        """{name: tensor}: the parameters (each once, in
        ``named_parameters`` order), then the persistable buffers.
        Tensors are detached views of the layer's own (``keep_vars``: the
        Parameters themselves). ``use_hook`` is accepted and ignored."""
        pre = (structured_name_prefix if prefix is None
               else prefix).rstrip(".")
        dest = destination if destination is not None else \
            collections.OrderedDict()
        for name, p in self.named_parameters(
                prefix=pre, include_sublayers=include_sublayers):
            dest[name] = p if keep_vars else p.detach()
        layers = [("", self)] + (list(self.named_sublayers())
                                 if include_sublayers else [])
        for lname, sub in layers:
            for bname, b in sub._buffers.items():
                if b is None or bname in sub._non_persistent_buffers_set:
                    continue
                name = ".".join(x for x in (pre, lname, bname) if x)
                dest[name] = b if keep_vars else b.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (torch tensors, numpy arrays or
        what numpy takes) into this layer's parameters and buffers of the
        same names, cast to each one's dtype and device. Returns
        ``(missing, unexpected)``: the layer's names the dict lacks, and
        the dict's names the layer lacks. A shape that differs raises."""
        own = self.state_dict(keep_vars=True)
        missing = []
        with torch.no_grad():
            for name, t in own.items():
                if name not in state_dict:
                    missing.append(name)
                    continue
                v = _as_tensor(state_dict[name])
                if v.numel() != t.numel():
                    raise ValueError(
                        f"set_state_dict: {name} has shape "
                        f"{tuple(v.shape)}, the layer's {tuple(t.shape)}")
                t.copy_(v.reshape(t.shape).to(t.device, t.dtype))
        unexpected = [n for n in state_dict if n not in own]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # ---- hooks ----
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after each forward; a value
        it returns replaces the outputs. Returns a handle with
        ``remove()``."""
        return self.register_forward_hook(hook)

    # ---- misc ----
    def full_name(self):
        return self._name_scope

    def clear_gradients(self):
        """Drop every parameter's gradient (paddle_tpu's ``clear_grad``
        sets it to None)."""
        for p in self.parameters():
            p.grad = None
