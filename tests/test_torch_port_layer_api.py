"""paddle_tpu_torch's ``Layer`` system against paddle_tpu's on the CPU.

The same tiny model is built in both packages (``_tiny``) and every
``Layer`` method is held to the reference's result: names and order of
sublayers, parameters, buffers and state-dict keys, ``set_state_dict``'s
``(missing, unexpected)``, casts, hooks, ``full_name`` and
``clear_gradients``. ``ParamAttr`` (name, learning rate, regularizer,
trainable, need_clip) on a tiny model trains 3 steps under SGD and AdamW
as paddle_tpu's eager ``step()`` does, at rtol 1e-5 / atol 1e-6.

Initializers: the deterministic fills (``Constant``, ``Assign``,
``Dirac``, ``Bilinear``), ``calculate_gain`` and ``_fans`` equal the
reference's exactly; the draws come from other generators by design, so
they are held by their moments (a 256 x 256 draw: the mean within 4
standard errors, the standard deviation within 2 %) and, for
``Orthogonal``, by ``Q^T Q = gain^2 I`` at atol 1e-5.
``set_global_initializer``'s precedence, the containers and ``nn.utils``
(atol 1e-6) are held to the reference; ``save`` / ``load`` read each
other's f32 files, and the port's bf16 round trip is bit for bit.
"""
import collections
import math
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.nn import utils as jutils
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import nn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.io import state as tstate
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn import utils as tutils


@pytest.fixture(autouse=True)
def _on_cpu():
    """Layers build on the card by default; these tests build them on the
    CPU, as paddle's ``set_device("cpu")`` asks."""
    tpkg.set_device("cpu")
    yield
    tpkg.set_device(None)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy(), np.float32)


def _tiny(pk):
    """The same model in package ``pk`` (``nn`` and ``zeros``)."""
    class Tiny(pk.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pk.nn.Linear(4, 8)
            self.act = pk.nn.ReLU()
            self.blocks = pk.nn.LayerList([pk.nn.Linear(8, 8),
                                           pk.nn.LayerNorm(8)])
            self.scale = self.create_parameter(
                [8], default_initializer=pk.nn.initializer.Constant(1.5))
            self.register_buffer("steps", pk.zeros([2]))
            self.register_buffer("scratch", pk.zeros([3]),
                                 persistable=False)
            self.head = pk.nn.Linear(8, 3)

        def forward(self, x):
            h = self.act(self.fc1(x))
            for b in self.blocks:
                h = b(h)
            return self.head(h * self.scale)
    return Tiny()


class _Pkg:
    def __init__(self, nn_mod, zeros):
        self.nn, self.zeros = nn_mod, zeros


JPK = _Pkg(jnn, lambda s: paddle.zeros(s))
TPK = _Pkg(nn, lambda s: torch.zeros(s))


def _pair(seed=0):
    """(port model, reference model) with the reference's weights."""
    jm, tm = _tiny(JPK), _tiny(TPK)
    rs = np.random.RandomState(seed)
    sd = {k: rs.randn(*v.shape).astype(np.float32)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict(sd)
    assert tm.set_state_dict(sd) == ([], [])
    return tm, jm


_X = np.random.RandomState(7).randn(5, 4).astype(np.float32)


def test_forward_after_set_state_dict_matches():
    tm, jm = _pair()
    np.testing.assert_allclose(_np(tm(torch.from_numpy(_X))),
                               _np(jm(paddle.to_tensor(_X))), atol=1e-6)


@pytest.mark.parametrize("method", [
    "named_sublayers", "sublayers", "sublayers_self", "named_parameters",
    "parameters_own", "named_parameters_prefix", "state_dict",
    "state_dict_prefix", "state_dict_own", "full_name",
    "sublayer_full_names"])
def test_traversal_matches_reference(method):
    tm, jm = _pair()

    def names(m):
        return {
            "named_sublayers": lambda: [n for n, _ in m.named_sublayers()],
            "sublayers": lambda: [type(s).__name__ for s in m.sublayers()],
            "sublayers_self": lambda: [type(s).__name__ for s in
                                       m.sublayers(include_self=True)],
            "named_parameters": lambda: [
                (n, list(p.shape)) for n, p in m.named_parameters()],
            "parameters_own": lambda: [list(p.shape) for p in
                                       m.parameters(include_sublayers=False)],
            "named_parameters_prefix": lambda: [
                n for n, _ in m.named_parameters(prefix="net")],
            "state_dict": lambda: list(m.state_dict()),
            "state_dict_prefix": lambda: list(m.state_dict(
                structured_name_prefix="net")),
            "state_dict_own": lambda: list(m.state_dict(
                include_sublayers=False)),
            "full_name": lambda: m.full_name(),
            "sublayer_full_names": lambda: [s.full_name()
                                            for s in m.sublayers()],
        }[method]()
    got, want = names(tm), names(jm)
    if method == "sublayers_self":
        # the reference's Tiny is its own class; the rest share names
        got, want = got[1:], want[1:]
    if method == "state_dict_prefix":
        # paddle_tpu matches its non-persistable buffers against
        # unprefixed names, so a prefix lets them into its state dict
        # (layer_base.py:211-219); the port keeps them out
        assert "net.scratch" in want
        want = [n for n in want if n != "net.scratch"]
    assert got == want


def test_set_state_dict_reports_missing_and_unexpected():
    tm, jm = _pair()
    sd = {k: _np(v) for k, v in jm.state_dict().items()}
    del sd["fc1.bias"]
    sd["extra.weight"] = np.zeros(2, np.float32)
    for fn in ("set_state_dict", "set_dict", "load_dict"):
        assert getattr(tm, fn)(sd) == getattr(jm, fn)(sd) == (
            ["fc1.bias"], ["extra.weight"])
    with pytest.raises(ValueError, match="shape"):
        tm.set_state_dict({"fc1.weight": np.zeros((2, 2), np.float32)})


def test_set_state_dict_takes_torch_tensors_and_casts():
    tm, _ = _pair()
    tm.bfloat16()
    w = torch.arange(32, dtype=torch.float64).reshape(4, 8)
    tm.set_state_dict({"fc1.weight": w})
    assert tm.fc1.weight.dtype == torch.bfloat16
    assert torch.equal(tm.fc1.weight.float(), w.float())


def test_add_sublayer_parameter_and_buffers():
    for pk in (TPK, JPK):
        m = pk.nn.Layer()
        lin = m.add_sublayer("lin", pk.nn.Linear(2, 3))
        assert lin is m.lin
        p = m.create_parameter([3], default_initializer=(
            pk.nn.initializer.Constant(2.0)))
        assert m.add_parameter("gain", p) is p
        m.register_buffer("b1", pk.zeros([1]))
        m.register_buffer("b2", pk.zeros([1]), persistable=False)
        assert list(m.state_dict()) == ["gain", "lin.weight", "lin.bias",
                                        "b1"]
        assert [n for n, _ in m.named_sublayers()] == ["lin"]
        np.testing.assert_array_equal(_np(m.gain), [2.0, 2.0, 2.0])


@pytest.mark.parametrize("how", ["astype", "to", "bfloat16", "half",
                                 "float"])
def test_casts_match_reference(how):
    tm, jm = _pair()
    for m in (tm, jm):
        if how == "astype":
            m.astype("bfloat16")
        elif how == "to":
            m.to(dtype="float16")
        else:
            getattr(m, how)()
    want = {"astype": "bfloat16", "to": "float16", "bfloat16": "bfloat16",
            "half": "float16", "float": "float32"}[how]
    for (tn, tp), (jn, jp) in zip(tm.named_parameters(),
                                  jm.named_parameters()):
        assert tn == jn
        assert str(tp.dtype) == f"torch.{want}"
        assert str(jp.dtype).endswith(want)
    assert tm.steps.dtype == getattr(torch, want)
    tm.float()
    assert tm.to("cpu") is tm and tm.fc1.weight.device.type == "cpu"


def test_forward_hooks_match_reference():
    tm, jm = _pair()
    outs = []
    for m, wrap in ((tm, torch.from_numpy), (jm, paddle.to_tensor)):
        h1 = m.register_forward_pre_hook(lambda lyr, inp: (inp[0] * 2,))
        h2 = m.register_forward_post_hook(lambda lyr, inp, out: out + 1)
        outs.append(_np(m(wrap(_X))))
        h1.remove()
        h2.remove()
        outs.append(_np(m(wrap(_X))))
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-6)
    np.testing.assert_allclose(outs[1], outs[3], atol=1e-6)
    assert not np.allclose(outs[0], outs[1])


def test_clear_gradients_and_extra_repr():
    tm, jm = _pair()
    for m, wrap in ((tm, torch.from_numpy), (jm, paddle.to_tensor)):
        m(wrap(_X)).sum().backward()
        assert m.fc1.weight.grad is not None
        m.clear_gradients()
        assert all(p.grad is None for p in m.parameters())
    assert tm.fc1.extra_repr() == jm.fc1.extra_repr()
    assert tm.blocks[1].extra_repr() == jm.blocks[1].extra_repr()


def test_create_parameter_sets_paddle_attributes():
    reg = treg.L2Decay(0.1)
    attr = nn.ParamAttr(name="w0", initializer=I.Constant(3.0),
                        learning_rate=0.5, regularizer=reg, trainable=False,
                        need_clip=False)
    p = nn.Layer().create_parameter([2, 2], attr=attr)
    assert p.param_name == "w0" and p.optimize_attr == {"learning_rate": 0.5}
    assert p.regularizer is reg and p.need_clip is False
    assert p.requires_grad is False and p.trainable is False
    assert torch.equal(p.detach(), torch.full((2, 2), 3.0))
    assert nn.Layer().create_parameter([2], attr=False) is None
    assert nn.Layer().create_parameter([2], dtype="bfloat16").dtype == \
        torch.bfloat16
    with pytest.raises(TypeError):
        nn.Layer().create_parameter([2], attr=3)


def _attr_model(pk, reg, name):
    """Linear -> ReLU -> Linear with every ParamAttr field in use."""
    return pk.nn.Sequential(
        pk.nn.Linear(4, 8, weight_attr=pk.nn.ParamAttr(
            name=name, learning_rate=0.5, regularizer=reg.L2Decay(0.1)),
            bias_attr=pk.nn.ParamAttr(trainable=False)),
        pk.nn.ReLU(),
        pk.nn.Linear(8, 3, weight_attr=pk.nn.ParamAttr(need_clip=False),
                     bias_attr=pk.nn.ParamAttr(learning_rate=2.0)))


@pytest.mark.parametrize("opt", ["SGD", "AdamW"])
def test_param_attr_training_matches_reference(opt):
    jm, tm = _attr_model(JPK, jreg, "fc1_w"), _attr_model(TPK, treg, "fc1_w")
    rs = np.random.RandomState(3)
    tm.set_state_dict({k: _np(v) for k, v in jm.state_dict().items()})
    x = rs.randn(6, 4).astype(np.float32)
    y = rs.randn(6, 3).astype(np.float32)
    kw = dict(learning_rate=0.05)
    jo = getattr(jopt, opt)(parameters=jm.parameters(),
                            grad_clip=jnn.ClipGradByGlobalNorm(0.5), **kw)
    to = getattr(topt, opt)(parameters=tm.parameters(),
                            grad_clip=nn.ClipGradByGlobalNorm(0.5), **kw)
    for _ in range(3):
        d = jm(paddle.to_tensor(x)) - paddle.to_tensor(y)
        (d * d).mean().backward()
        jo.step()
        jo.clear_grad()
        d = tm(torch.from_numpy(x)) - torch.from_numpy(y)
        (d * d).mean().backward()
        to.step()
        to.clear_grad()
    before = _attr_model(TPK, treg, "fc1_w")
    for (n, p), (_, q) in zip(tm.named_parameters(), jm.named_parameters()):
        np.testing.assert_allclose(_np(p), _np(q), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    # the frozen bias never moved; the others did
    assert tm[0].bias.requires_grad is False
    assert tm[0].weight.param_name == "fc1_w"
    del before


# ---- initializers ----

@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.75,), (3, 5)),
    ("Assign", (np.arange(15, dtype=np.float64).reshape(3, 5) / 7,), (3, 5)),
    ("Dirac", (), (4, 2, 3, 3)),
    ("Dirac", (2,), (4, 2, 3)),
    ("Bilinear", (), (2, 2, 4, 4)),
    ("Bilinear", (), (3, 1, 5)),
], ids=["constant", "assign", "dirac", "dirac-groups", "bilinear",
        "bilinear-1d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deterministic_fills_equal_reference(name, args, shape, dtype):
    got = getattr(I, name)(*args)(shape, dtype)
    want = getattr(jnn.initializer, name)(*args)(shape, dtype)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("shape", [(5,), (3, 7), (4, 2, 3, 3), ()])
def test_fans_and_gains_equal_reference(shape):
    assert I._fans(shape) == jnn.initializer._fans(shape)
    for nl, param in (("relu", None), ("tanh", None), ("leaky_relu", 0.2),
                      ("leaky_relu", None), ("selu", None), ("conv2d", None),
                      ("linear", None), ("unknown", None)):
        assert I.calculate_gain(nl, param) == \
            jnn.initializer.calculate_gain(nl, param)


def _moments(init_t, init_j, shape, mean, std):
    """The port's and the reference's draws both sit at (mean, std)."""
    for arr in (_np(init_t(shape)), np.asarray(init_j(shape), np.float32)):
        n = arr.size
        assert abs(arr.mean() - mean) <= 4 * std / math.sqrt(n) + 1e-7
        assert abs(arr.std() - std) <= 0.02 * std


@pytest.mark.parametrize("name,args,mean,std", [
    ("Normal", (1.0, 2.0), 1.0, 2.0),
    ("Uniform", (-3.0, 1.0), -1.0, 4.0 / math.sqrt(12)),
    ("XavierNormal", (), 0.0, math.sqrt(2.0 / 512)),
    ("XavierUniform", (), 0.0, math.sqrt(6.0 / 512) / math.sqrt(3)),
    ("KaimingNormal", (), 0.0, math.sqrt(2.0) / 16),
    ("KaimingUniform", (), 0.0, math.sqrt(2.0) * math.sqrt(3.0 / 256)
     / math.sqrt(3)),
    ("XavierNormal", (None, None, 2.0), 0.0, 2 * math.sqrt(2.0 / 512)),
    ("KaimingNormal", (None, 0.1, "leaky_relu"), 0.0,
     math.sqrt(2.0 / 1.01) / 16),
])
def test_random_draws_by_moments(name, args, mean, std):
    _moments(getattr(I, name)(*args), getattr(jnn.initializer, name)(*args),
             (256, 256), mean, std)


def test_truncated_normal_draw():
    arr = _np(I.TruncatedNormal(1.0, 0.5, -1.0, 1.5)((256, 256)))
    assert arr.min() >= 1.0 - 0.5 - 1e-6 and arr.max() <= 1.0 + 0.75 + 1e-6
    # the mean and std of N(0, 1) truncated to [-1, 1.5], scaled by 0.5
    from math import erf, exp, pi, sqrt
    phi = [exp(-t * t / 2) / sqrt(2 * pi) for t in (-1.0, 1.5)]
    Z = 0.5 * (erf(1.5 / sqrt(2)) - erf(-1.0 / sqrt(2)))
    m = (phi[0] - phi[1]) / Z
    v = 1 + (-1.0 * phi[0] - 1.5 * phi[1]) / Z - m * m
    ref = np.asarray(jnn.initializer.TruncatedNormal(1.0, 0.5, -1.0, 1.5)(
        (256, 256)), np.float32)
    for a in (arr, ref):
        assert abs(a.mean() - (1.0 + 0.5 * m)) < 4 * 0.5 / 256
        assert abs(a.std() - 0.5 * math.sqrt(v)) < 0.02 * 0.5 * math.sqrt(v)


@pytest.mark.parametrize("shape,gain", [((16, 16), 1.0), ((8, 24), 2.0),
                                        ((24, 8), 0.5), ((2, 4, 16), 1.0)])
def test_orthogonal_draw(shape, gain):
    w = I.Orthogonal(gain)(shape).reshape(-1, shape[-1]).double()
    rows, cols = w.shape
    g = w.T @ w if rows >= cols else w @ w.T
    np.testing.assert_allclose(g.numpy(), gain * gain * np.eye(min(rows,
                                                                  cols)),
                               atol=1e-5)


def test_draws_on_meta_and_under_no_default_init():
    with torch.device("meta"):
        assert I.Normal()((3, 3)).is_meta
    from paddle_tpu_torch.nn.layer_base import _no_default_init
    with _no_default_init():
        lin = nn.Linear(3, 3, weight_attr=I.Constant(2.0))
        assert torch.equal(lin.weight.detach(), torch.full((3, 3), 2.0))
        assert torch.equal(lin.bias.detach(), torch.zeros(3))


def test_layers_build_on_the_card_by_default():
    """With no ``set_device`` and no torch device context, a layer and an
    initializer build on the card, and raise naming CUDA where there is
    none; ``set_device("cpu")`` and torch's device contexts (meta, cpu)
    are honoured, and ``set_device(None)`` goes back to the card."""
    tpkg.set_device(None)
    if torch.cuda.is_available():
        assert nn.Linear(2, 3).weight.device.type == "cuda"
        assert nn.Transformer(16, 2, 1, 1, 32).decoder.layers[0] \
            .linear2.bias.device.type == "cuda"
        assert tpkg.get_device() == f"gpu:{torch.cuda.current_device()}"
    else:
        for build in (lambda: nn.Linear(2, 3),
                      lambda: nn.Transformer(16, 2, 1, 1, 32),
                      lambda: nn.LayerNorm(4), lambda: I.Normal()((2,)),
                      lambda: nn.Transformer.generate_square_subsequent_mask(
                          3),
                      tpkg.get_device, lambda: tpkg.set_device("gpu:0")):
            with pytest.raises(RuntimeError, match="CUDA"):
                build()
    with torch.device("meta"):
        assert nn.Linear(2, 3).weight.is_meta
    with torch.device("cpu"):
        assert nn.Linear(2, 3).weight.device.type == "cpu"
    assert tpkg.set_device("cpu") == torch.device("cpu")
    assert tpkg.get_device() == "cpu:0"
    m = nn.Transformer(16, 2, 1, 1, 32)
    assert {p.device.type for p in m.parameters()} == {"cpu"}
    assert I.XavierUniform()((2, 3)).device.type == "cpu"


@pytest.mark.parametrize("case", ["global", "attr-wins", "reset"])
def test_global_initializer_precedence(case):
    out = []
    for pk in (TPK, JPK):
        init = pk.nn.initializer
        try:
            if case != "reset":
                init.set_global_initializer(init.Constant(0.5),
                                            init.Constant(0.25))
            else:
                init.set_global_initializer(init.Constant(0.5))
                init.set_global_initializer(None, None)
            attr = (pk.nn.ParamAttr(initializer=init.Constant(2.0))
                    if case == "attr-wins" else None)
            lin = pk.nn.Linear(3, 2, weight_attr=attr)
            out.append((_np(lin.weight), _np(lin.bias)))
        finally:
            init.set_global_initializer(None, None)
    (tw, tb), (jw, jb) = out
    np.testing.assert_array_equal(tb, jb)
    if case == "reset":              # the built-in defaults: draws
        assert tw.std() > 0 and jw.std() > 0
    else:
        np.testing.assert_array_equal(tw, jw)


# ---- containers ----

def _layers(pk):
    return [pk.nn.Linear(2, 3), pk.nn.ReLU(), pk.nn.Linear(3, 2)]


@pytest.mark.parametrize("kind", ["sequential", "sequential-dict",
                                  "sequential-pairs", "layerlist",
                                  "parameterlist", "layerdict"])
def test_containers_match_reference(kind):
    got = []
    for pk, zeros in ((TPK, torch.zeros), (JPK, paddle.zeros)):
        ls = _layers(pk)
        if kind == "sequential":
            c = pk.nn.Sequential(*ls)
            view = [list(c.state_dict()), len(c), len(c[1:]),
                    type(c[-1]).__name__]
        elif kind == "sequential-dict":
            c = pk.nn.Sequential(collections.OrderedDict(
                [("a", ls[0]), ("b", ls[1])]))
            view = [list(c.state_dict()), [type(x).__name__ for x in c]]
        elif kind == "sequential-pairs":
            c = pk.nn.Sequential(("x", ls[0]), ("y", ls[2]))
            view = [list(c.state_dict())]
        elif kind == "layerlist":
            c = pk.nn.LayerList(ls[:1])
            c.append(ls[1])
            c.extend([ls[2]])
            c.insert(1, pk.nn.Linear(3, 3))
            c[0] = pk.nn.Linear(2, 2)
            view = [list(c.state_dict()), len(c), len(c[1:3]),
                    [n for n, _ in c.named_parameters()]]
        elif kind == "parameterlist":
            c = pk.nn.ParameterList([ls[0].weight])
            c.append(ls[2].bias)
            view = [list(c.state_dict()), len(c),
                    [list(p.shape) for p in c]]
        else:
            c = pk.nn.LayerDict({"a": ls[0]})
            c["b"] = ls[2]
            c.update([("c", ls[1])])
            popped = c.pop("c")
            view = [list(c.state_dict()), list(c.keys()), "b" in c, len(c),
                    type(popped).__name__]
            del c["a"]
            view.append(list(c))
        got.append(view)
    assert got[0] == got[1]


def test_sequential_forward_matches_reference():
    jl, tl = _layers(JPK), _layers(TPK)
    js, ts = jnn.Sequential(*jl), nn.Sequential(*tl)
    ts.set_state_dict({k: _np(v) for k, v in js.state_dict().items()})
    x = np.random.RandomState(4).randn(3, 2).astype(np.float32)
    np.testing.assert_allclose(_np(ts(torch.from_numpy(x))),
                               _np(js(paddle.to_tensor(x))), atol=1e-6)


# ---- nn.utils ----

def _grads_pair():
    tm, jm = _pair(1)
    for m, wrap in ((tm, torch.from_numpy), (jm, paddle.to_tensor)):
        out = m(wrap(_X)) * 0.1         # gradients of order 0.1-1
        (out * out).mean().backward()
    return tm, jm


def _jgrad(p):
    return np.asarray(p._grad, np.float32)


@pytest.mark.parametrize("what", ["to_vector", "from_vector", "norm2",
                                  "norm-inf", "norm-small", "value"])
def test_utils_match_reference(what):
    tm, jm = _grads_pair()
    tp, jp = tm.parameters(), jm.parameters()
    if what == "to_vector":
        np.testing.assert_array_equal(
            _np(nn.parameters_to_vector(tp)),
            _np(jnn.parameters_to_vector(jp)))
        return
    if what == "from_vector":
        v = np.random.RandomState(5).randn(
            sum(p.numel() for p in tp)).astype(np.float32)
        nn.vector_to_parameters(torch.from_numpy(v), tp)
        jnn.vector_to_parameters(paddle.to_tensor(v), jp)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(_np(a), _np(b))
        return
    if what == "value":
        tutils.clip_grad_value_(tp, 0.3)
        jutils.clip_grad_value_(jp, 0.3)
    else:
        kw = {"norm2": (1.0, 2.0), "norm-inf": (0.5, float("inf")),
              "norm-small": (1e4, 2.0)}[what]
        tot = tutils.clip_grad_norm_(tp, *kw)
        jtot = jutils.clip_grad_norm_(jp, *kw)
        np.testing.assert_allclose(float(tot), float(_np(jtot)), atol=1e-6)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(_np(a.grad), _jgrad(b), atol=1e-6)


def _reparam_pair(fn, **kw):
    rs = np.random.RandomState(6)
    w, b = rs.randn(4, 3).astype(np.float32), rs.randn(3).astype(np.float32)
    out = []
    for pk, u in ((TPK, tutils), (JPK, jutils)):
        lin = pk.nn.Linear(4, 3)
        lin.set_state_dict({"weight": w, "bias": b})
        getattr(u, fn)(lin, **kw)
        out.append(lin)
    return out


@pytest.mark.parametrize("fn,kw", [
    ("weight_norm", {}), ("weight_norm", {"dim": 1}),
    ("weight_norm", {"dim": None}), ("spectral_norm", {}),
    ("spectral_norm", {"n_power_iterations": 3, "dim": 0})],
    ids=["wn0", "wn1", "wn-all", "sn", "sn3-dim0"])
def test_reparameterisations_match_reference(fn, kw):
    tl, jl = _reparam_pair(fn, **kw)
    assert sorted(n for n, _ in tl.named_parameters()) == \
        sorted(n for n, _ in jl.named_parameters())
    assert list(tl.state_dict()) == list(jl.state_dict())
    for _ in range(2):               # spectral_norm's buffers move
        to = tl(torch.from_numpy(_X[:, :4]))
        jo = jl(paddle.to_tensor(_X[:, :4]))
    np.testing.assert_allclose(_np(to), _np(jo), atol=1e-6)
    (to * to).sum().backward()
    (jo * jo).sum().backward()
    for (n, p), (_, q) in zip(sorted(tl.named_parameters()),
                              sorted(jl.named_parameters())):
        np.testing.assert_allclose(_np(p.grad), _jgrad(q), atol=1e-5,
                                   err_msg=n)
    if fn == "weight_norm":
        tutils.remove_weight_norm(tl)
        jutils.remove_weight_norm(jl)
        assert [n for n, _ in tl.named_parameters()] == ["bias", "weight"]
        np.testing.assert_allclose(_np(tl.weight), _np(jl.weight), atol=1e-6)


# ---- save / load ----

def test_reference_file_loads_in_the_port(tmp_path):
    tm, jm = _pair(2)
    path = str(tmp_path / "ref.pdparams")
    paddle.save(jm.state_dict(), path)
    sd = tpkg.load(path)
    assert list(sd) == list(jm.state_dict())
    assert isinstance(sd["fc1.weight"], torch.nn.Parameter)
    fresh = _tiny(TPK)
    assert fresh.set_state_dict(sd) == ([], [])
    np.testing.assert_allclose(_np(fresh(torch.from_numpy(_X))),
                               _np(jm(paddle.to_tensor(_X))), atol=1e-6)
    npy = tpkg.load(path, return_numpy=True)
    assert isinstance(npy["fc1.weight"], np.ndarray)


def test_port_file_loads_in_the_reference(tmp_path):
    tm, jm = _pair(2)
    path = str(tmp_path / "port.pdparams")
    tpkg.save({"model": tm.state_dict(), "step": 3, "lr": [0.1, 0.2]}, path)
    obj = paddle.load(path)
    assert obj["step"] == 3 and obj["lr"] == [0.1, 0.2]
    fresh = _tiny(JPK)
    fresh.set_state_dict(obj["model"])
    np.testing.assert_allclose(_np(fresh(paddle.to_tensor(_X))),
                               _np(tm(torch.from_numpy(_X))), atol=1e-6)


def test_bf16_round_trip_is_bit_exact(tmp_path):
    t = torch.randn(64, dtype=torch.float32).to(torch.bfloat16)
    t[:4] = torch.tensor([float("inf"), float("-inf"), -0.0, 1e-40])
    t = t.view(torch.int16)
    t[4] = 0x7FC1                   # a NaN with a payload
    t = t.view(torch.bfloat16)
    p = torch.nn.Parameter(t.clone())
    p.param_name = "w"
    path = str(tmp_path / "bf16.pdparams")
    tpkg.save({"p": p, "t": t, "i": torch.arange(3)}, path)
    got = tpkg.load(path)
    assert got["p"].dtype == torch.bfloat16
    assert torch.equal(got["p"].view(torch.int16), t.view(torch.int16))
    assert torch.equal(got["t"].view(torch.int16), t.view(torch.int16))
    assert got["p"].param_name == "w" and torch.equal(got["i"],
                                                      torch.arange(3))
    # paddle_tpu reads the same values, widened to f32
    ref = paddle.load(path)
    np.testing.assert_array_equal(np.asarray(ref["t"].numpy(), np.float32)
                                  .view(np.int32),
                                  t.float().numpy().view(np.int32))


def test_reference_bf16_file(tmp_path, monkeypatch):
    w = np.random.RandomState(8).randn(16).astype(np.float32)
    path = str(tmp_path / "ref_bf16.pdparams")
    paddle.save({"w": paddle.to_tensor(w).astype("bfloat16")}, path)
    want = torch.from_numpy(w).to(torch.bfloat16)
    assert torch.equal(tpkg.load(path)["w"].view(torch.int16),
                       want.view(torch.int16))
    # without ml_dtypes the file cannot be read: a named error
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(tstate.BFloat16FileError):
        tpkg.load(path)
