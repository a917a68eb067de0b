"""paddle_tpu_torch's optimizers, schedulers, clips and the optimizer API
against paddle_tpu on the CPU.

Parameters and gradients are made with numpy from a seed and handed to
both sides; each comparison starts both sides from the same state. An
optimizer runs 5 steps in three forms: the port's eager ``step()``
against paddle_tpu's eager ``step()`` (which reads per-parameter
attributes off its ``Parameter``s) and against paddle_tpu's functional
``apply_gradients``; and a port optimizer that takes paddle_tpu's
functional state after step 2 through ``convert.py`` and runs steps 3-5.

Tolerances: f32 parameters and slots atol 1e-6 / rtol 1e-5 (the same f32
operations, fused and reduced in other orders by XLA:CPU and PyTorch's
CPU kernels); a bf16 parameter within rtol 2**-8 (one bf16 rounding of
its f32 value), its f32 master and slots as f32. Schedulers are the same
host arithmetic on both sides: abs 1e-12.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt_mod
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
import paddle_tpu_torch.optimizer as topt_mod
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.convert import (load_paddle_tpu_opt_state,
                                      load_paddle_tpu_optimizer_state_dict)
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr

_SHAPES = {"a.weight": (8, 16), "a.bias": (16,), "b.weight": (16, 4)}
_STEPS = 5


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bf16=False, what=""):
    got = got.detach().float().numpy()
    if bf16:
        np.testing.assert_allclose(got, _np(want), rtol=2.0 ** -8, atol=0,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-6,
                                   err_msg=what)


# case: (class name, kwargs given the package's (optimizer, regularizer)
# modules, bf16 "b.weight", compared to the functional path too)
CASES = {
    "sgd-l1decay": ("SGD", lambda o, r: dict(
        learning_rate=0.1, weight_decay=r.L1Decay(0.05)), False, True),
    "momentum-nesterov-l2-bf16-master": ("Momentum", lambda o, r: dict(
        learning_rate=0.05, momentum=0.9, use_nesterov=True,
        weight_decay=r.L2Decay(0.01), multi_precision=True), True, True),
    "adamax": ("Adamax", lambda o, r: dict(learning_rate=0.01), False, True),
    "adagrad": ("Adagrad", lambda o, r: dict(
        learning_rate=0.1, initial_accumulator_value=0.1), False, True),
    "adadelta": ("Adadelta", lambda o, r: dict(learning_rate=1.0, rho=0.9),
                 False, True),
    "rmsprop-centered-momentum": ("RMSProp", lambda o, r: dict(
        learning_rate=0.01, centered=True, momentum=0.9), False, True),
    "rmsprop-bf16-no-master": ("RMSProp", lambda o, r: dict(
        learning_rate=0.01, momentum=0.5), True, True),
    "lamb-bf16-master": ("Lamb", lambda o, r: dict(
        learning_rate=0.01, lamb_weight_decay=0.01, multi_precision=True),
        True, True),
    # paddle_tpu's functional path never calls the exclude function
    "lamb-exclude-fn": ("Lamb", lambda o, r: dict(
        learning_rate=0.01, lamb_weight_decay=0.1,
        exclude_from_weight_decay_fn=lambda p: p.ndim == 1), False, False),
    "lars-exclude": ("Lars", lambda o, r: dict(
        learning_rate=0.1, lars_coeff=0.02, lars_weight_decay=0.01,
        exclude_from_weight_decay=["bias"]), False, True),
    "dgc-ramp": ("DGCMomentum", lambda o, r: dict(
        learning_rate=0.1, rampup_begin_step=1, rampup_step=2,
        sparsity=[0.5, 0.75, 0.9]), False, True),
    "dgc-ramp-nesterov": ("DGCMomentum", lambda o, r: dict(
        learning_rate=0.1, rampup_begin_step=2, rampup_step=1,
        sparsity=[0.6, 0.8], use_nesterov=True), False, True),
}


def _module(params):
    """A module whose named_parameters() are ``params`` {"x.y": p}."""
    m = torch.nn.Module()
    for name, p in params.items():
        sub, attr = name.split(".")
        if not hasattr(m, sub):
            m.add_module(sub, torch.nn.Module())
        getattr(m, sub).register_parameter(attr, p)
    return m


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_reference(case):
    cls, kw, bf16, functional = CASES[case]
    rs = np.random.RandomState(zlib.crc32(case.encode()) % 2 ** 31)
    vals = {n: rs.randn(*s).astype(np.float32) for n, s in _SHAPES.items()}
    grads = [{n: (rs.randn(*s) * 2).astype(np.float32)
              for n, s in _SHAPES.items()} for _ in range(_STEPS)]
    low = {"b.weight"} if bf16 else set()
    jdt = {n: jnp.bfloat16 if n in low else jnp.float32 for n in vals}
    tdt = {n: torch.bfloat16 if n in low else torch.float32 for n in vals}

    jp = {n: JaxParameter(jnp.asarray(v).astype(jdt[n]), name=n)
          for n, v in vals.items()}
    jopt = getattr(jopt_mod, cls)(parameters=list(jp.values()),
                                  **kw(jopt_mod, paddle.regularizer))
    tp = {n: torch.nn.Parameter(torch.from_numpy(v.copy()).to(tdt[n]))
          for n, v in vals.items()}
    topt = getattr(topt_mod, cls)(parameters=list(tp.items()),
                                  **kw(topt_mod, treg))
    if functional:
        fopt = getattr(jopt_mod, cls)(parameters=[],
                                      **kw(jopt_mod, paddle.regularizer))
        fp = {n: jnp.asarray(v).astype(jdt[n]) for n, v in vals.items()}
        fstate = fopt.init(fp)
        apply = jax.jit(lambda p, g, s, t: fopt.apply_gradients(p, g, s,
                                                                step=t))
    resumed = None
    for t, g in enumerate(grads, 1):
        for n in vals:
            jp[n]._grad = jnp.asarray(g[n]).astype(jdt[n])
            tp[n].grad = torch.from_numpy(g[n]).to(tdt[n])
        jopt.step()
        topt.step()
        if functional:
            fp, fstate = apply(fp, {n: jnp.asarray(g[n]).astype(jdt[n])
                                    for n in vals}, fstate, t)
            if resumed is not None:
                for n, p in rp.items():
                    p.grad = torch.from_numpy(g[n]).to(tdt[n])
                resumed.step()
            if t == 2:      # paddle_tpu's state after 2 steps, into the port
                rp = {n: torch.nn.Parameter(torch.from_numpy(
                    np.array(fp[n].astype(jnp.float32))).to(tdt[n]))
                    for n in vals}
                resumed = getattr(topt_mod, cls)(
                    parameters=list(rp.values()), **kw(topt_mod, treg))
                load_paddle_tpu_opt_state(
                    resumed, _module(rp),
                    jax.tree_util.tree_map(np.asarray, fstate), step=2)
    assert topt._step_count == _STEPS
    for n in vals:
        _close(tp[n], jp[n].value, n in low, f"{case} eager {n}")
        assert {s for s, d in jopt._accumulators.items() if n in d} == {
            s for s, d in topt._accumulators.items() if n in d}
        for slot, d in jopt._accumulators.items():
            if n in d:
                _close(topt._accumulators[slot][n], d[n], what=f"{n}.{slot}")
        if functional:
            _close(tp[n], fp[n], n in low, f"{case} functional {n}")
            _close(rp[n], fp[n], n in low, f"{case} resumed {n}")
            assert set(fstate[n]) == {s for s, d in topt._accumulators.items()
                                      if n in d}
            for slot, arr in fstate[n].items():
                _close(topt._accumulators[slot][n], arr, what=f"{n}.{slot}")
                _close(resumed._accumulators[slot][n], arr,
                       what=f"resumed {n}.{slot}")
    assert ("master" in topt._accumulators) == (
        bf16 and bool(kw(topt_mod, treg).get("multi_precision")))


SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 30],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(
        0.5, decay_steps=15, end_lr=0.01, power=2.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.PolynomialDecay(0.5, 20, end_lr=0.0), warmup_steps=8,
        start_lr=0.0, end_lr=0.5),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, milestones=[6, 15, 33],
                                                 gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.5,
                                                           lambda e: 0.97),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.5, T_max=25, eta_min=0.01),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, T_0=5, T_mult=2, eta_min=0.01),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.5, factor=0.5, patience=2, cooldown=1, threshold=0.01),
    "LinearLR": lambda m: m.LinearLR(0.5, total_steps=30, start_factor=0.2),
    "OneCycleLR": lambda m: m.OneCycleLR(0.5, total_steps=40,
                                         three_phase=True),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.5, step_size_up=4,
                                     step_size_down=6, mode="triangular2"),
}
# ReduceOnPlateau's metric: falling, then plateaus that trigger reductions
_METRICS = [1.0 / (1 + 0.1 * i) if i % 9 < 4 else 2.0 for i in range(40)]


def test_every_scheduler_is_covered():
    assert set(SCHEDULERS) | {"LRScheduler"} == set(jlr.__all__) \
        == set(tlr.__all__)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_reference(name):
    """40 steps of each scheduler against paddle_tpu's; at step 20 the
    port continues from its own state dict in a fresh scheduler, and a
    second fresh one from paddle_tpu's state dict."""
    def advance(s, i):
        if name == "ReduceOnPlateau":
            s.step(_METRICS[i])
        else:
            s.step()
    js, ts = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    from_ref = None
    for i in range(40):
        for s in (ts, from_ref):
            if s is not None:
                assert abs(s() - js()) <= 1e-12, (name, i, s(), js())
        if i == 20:
            assert ts.state_dict() == js.state_dict()
            assert ts.state_keys() == ts.state_dict()
            own = SCHEDULERS[name](tlr)
            own.set_state_dict(ts.state_dict())
            ts = own
            from_ref = SCHEDULERS[name](tlr)
            from_ref.set_dict(js.state_dict())
        for s in (js, ts, from_ref):
            if s is not None:
                advance(s, i)
    if name == "ReduceOnPlateau":
        assert ts() < 0.5                  # it did reduce


def _pairs(rs, need_clip_off="a.bias"):
    grads = {n: (rs.randn(*s) * 3).astype(np.float32)
             for n, s in _SHAPES.items()}
    jp, tp = [], []
    for n, s in _SHAPES.items():
        j = JaxParameter(jnp.zeros(s), name=n)
        t = torch.nn.Parameter(torch.zeros(s))
        j.need_clip = t.need_clip = n != need_clip_off
        jp.append((j, Tensor(jnp.asarray(grads[n]))))
        tp.append((t, torch.from_numpy(grads[n])))
    return jp, tp


_CLIPS = {"global": lambda m: m.ClipGradByGlobalNorm(0.5),
          "norm": lambda m: m.ClipGradByNorm(0.5),
          "value": lambda m: m.ClipGradByValue(0.3)}


@pytest.mark.parametrize("kind", sorted(_CLIPS))
def test_clip_matches_reference(kind):
    """Both forms of each clip: ``__call__`` over (param, grad) pairs
    (the global norm leaves a ``need_clip = False`` parameter out of the
    norm and unclipped; paddle_tpu's other two clip every pair) and
    ``clip_raw`` over a list, with ``clip_grads_raw``."""
    jp, tp = _pairs(np.random.RandomState(1))
    jc, tc = _CLIPS[kind](jclip), _CLIPS[kind](tclip)
    assert isinstance(tc, tclip.ClipGradBase)
    params = [p for p, _ in jp]

    @jax.jit                     # one program, not op by op
    def reference(gs):
        called = jc([(p, Tensor(g)) for p, g in zip(params, gs)])
        return [g.value for _, g in called], jclip.clip_grads_raw(gs, jc)

    called, want = reference([g.value for _, g in jp])
    for jg, (_, tg) in zip(called, tc(tp)):
        np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-6, atol=1e-7)
    raw = [g for _, g in tp]
    for got, w in zip(tclip.clip_grads_raw(raw, tc), want):
        np.testing.assert_allclose(got.numpy(), _np(w), rtol=1e-6, atol=1e-7)
    assert tclip.clip_grads_raw(raw, None) is raw
    if kind == "global":           # need_clip = False: the raw gradient
        torch.testing.assert_close(tc(tp)[1][1], tp[1][1], rtol=0, atol=0)


@pytest.mark.parametrize("kind", sorted(_CLIPS))
def test_clip_in_the_update_skips_need_clip_false(kind):
    """Three SGD steps with each clip as ``grad_clip`` against
    paddle_tpu's eager step: a ``need_clip = False`` parameter is left
    out of every clip and moves by its raw gradient."""
    rs = np.random.RandomState(2)
    jparams, tparams = [], []
    for n, s in _SHAPES.items():
        v = rs.randn(*s).astype(np.float32)
        j = JaxParameter(jnp.asarray(v), name=n)
        t = torch.nn.Parameter(torch.from_numpy(v.copy()))
        j.need_clip = t.need_clip = n != "a.bias"
        jparams.append(j)
        tparams.append(t)
    jopt = paddle.optimizer.SGD(0.1, parameters=jparams,
                                grad_clip=_CLIPS[kind](jclip))
    topt = topt_mod.SGD(0.1, parameters=tparams,
                        grad_clip=_CLIPS[kind](tclip))
    start = tparams[1].detach().clone()
    raw = torch.zeros_like(start)
    for _ in range(3):
        for j, t in zip(jparams, tparams):
            g = (rs.randn(*t.shape) * 3).astype(np.float32)
            j._grad = jnp.asarray(g)
            t.grad = torch.from_numpy(g)
        raw += tparams[1].grad
        jopt.step()
        topt.step()
    for j, t in zip(jparams, tparams):
        _close(t, j.value, what=f"{kind} {j.name}")
    torch.testing.assert_close(tparams[1].detach(), start - 0.1 * raw,
                               rtol=1e-6, atol=1e-6)


def test_exports_match_reference():
    import paddle_tpu.regularizer as jreg
    assert set(topt_mod.__all__) == set(jopt_mod.__all__)
    assert set(treg.__all__) == set(jreg.__all__)
    assert treg.L1Decay is topt_mod.L1Decay
    assert set(tclip.__all__) == set(jclip.__all__) | {"ClipGradBase"}


def _adam_pair(sched):
    """paddle_tpu's and the port's Adam over the same named parameters,
    with the same scheduler."""
    rs = np.random.RandomState(3)
    vals = {n: rs.randn(*s).astype(np.float32) for n, s in _SHAPES.items()}
    jp = [JaxParameter(jnp.asarray(v), name=n) for n, v in vals.items()]
    tp = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for n, v in vals.items()}
    jopt = paddle.optimizer.Adam(learning_rate=sched(jlr), parameters=jp)
    topt = topt_mod.Adam(learning_rate=sched(tlr),
                         parameters=list(tp.items()))
    return rs, jp, tp, jopt, topt


def _step_both(rs, jp, tp, jopt, topt):
    for j in jp:
        g = rs.randn(*j.shape).astype(np.float32)
        j._grad = jnp.asarray(g)
        tp[j.name].grad = torch.from_numpy(g)
    jopt.step()
    topt.step()
    jopt._learning_rate.step()
    topt._learning_rate.step()


def test_state_dict_matches_and_reference_state_loads():
    """``state_dict`` keys (``f"{name}_{slot}"``, "@step",
    "LR_Scheduler") equal paddle_tpu's; paddle_tpu's state dict after 2
    steps, through ``convert.py``, loads by ``set_state_dict`` into a
    fresh port optimizer whose next step equals paddle_tpu's."""
    def sched(m):
        return m.StepDecay(0.01, step_size=2, gamma=0.5)
    rs, jp, tp, jopt, topt = _adam_pair(sched)
    for _ in range(2):
        _step_both(rs, jp, tp, jopt, topt)
    jstate = jopt.state_dict()
    tstate = topt.state_dict()
    assert set(tstate) == set(jstate)
    assert tstate["@step"] == jstate["@step"] == 2
    assert tstate["LR_Scheduler"] == jstate["LR_Scheduler"]
    for key, val in jstate.items():
        if key not in ("@step", "LR_Scheduler"):
            _close(tstate[key], val.value, what=key)
    fresh_p = {n: torch.nn.Parameter(torch.from_numpy(np.array(j.value)))
               for n, j in zip(tp, jp)}
    fresh = topt_mod.Adam(learning_rate=sched(tlr),
                          parameters=list(fresh_p.items()))
    numpy_state = {k: (v if k in ("@step", "LR_Scheduler")
                       else np.asarray(v.value)) for k, v in jstate.items()}
    load_paddle_tpu_optimizer_state_dict(fresh, numpy_state)
    assert fresh._step_count == 2 and fresh.get_lr() == jopt.get_lr()
    _step_both(rs, jp, fresh_p, jopt, fresh)
    for j in jp:
        _close(fresh_p[j.name], j.value, what=j.name)
    with pytest.raises(KeyError, match="zz_moment1"):
        load_paddle_tpu_optimizer_state_dict(
            fresh, {"zz_moment1": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="a.bias_moment1"):
        load_paddle_tpu_optimizer_state_dict(
            fresh, {"a.bias_moment1": np.zeros(3, np.float32)})


def test_set_state_dict_takes_the_longest_name():
    """A parameter ``w`` must not take the slots of ``w_ho``."""
    w, w_ho = (torch.nn.Parameter(torch.zeros(2)),
               torch.nn.Parameter(torch.zeros(3)))
    opt = topt_mod.Momentum(parameters=[("w", w), ("w_ho", w_ho)])
    opt.set_state_dict({"w_velocity": np.ones(2, np.float32),
                        "w_ho_velocity": np.full(3, 2.0, np.float32),
                        "@step": 4})
    assert opt._accumulators["velocity"]["w"].tolist() == [1.0, 1.0]
    assert opt._accumulators["velocity"]["w_ho"].tolist() == [2.0] * 3
    assert opt._step_count == 4


def test_set_lr_and_set_lr_scheduler():
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt_mod.SGD(learning_rate=0.1, parameters=[p])
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5
    sched = tlr.StepDecay(0.2, step_size=1, gamma=0.5)
    opt.set_lr_scheduler(sched)
    assert opt.get_lr() == 0.2
    with pytest.raises(RuntimeError, match="scheduler"):
        opt.set_lr(0.3)
    sched.step()
    assert opt.get_lr() == 0.1
    jopt = paddle.optimizer.SGD(learning_rate=jlr.StepDecay(0.2, 1),
                                parameters=[JaxParameter(jnp.ones(3))])
    with pytest.raises(RuntimeError, match="scheduler"):
        jopt.set_lr(0.3)


def test_clear_gradients_and_minimize():
    """``minimize`` is backward + step (the same update as doing both by
    hand); ``clear_gradients`` keeps zero-filled grads, ``clear_grad(
    set_to_zero=False)`` drops them."""
    x = torch.from_numpy(np.random.RandomState(4).randn(5, 8)
                         .astype(np.float32))
    w1 = torch.nn.Parameter(torch.ones(8, 2))
    w2 = torch.nn.Parameter(torch.ones(8, 2))
    o1 = topt_mod.Momentum(0.1, parameters=[w1])
    o2 = topt_mod.Momentum(0.1, parameters=[w2])
    _, pg = o1.minimize(torch.tanh(x @ w1).sum())
    assert pg[0][0] is w1 and pg[0][1] is w1.grad
    torch.tanh(x @ w2).sum().backward()
    o2.step()
    torch.testing.assert_close(w1.detach(), w2.detach(), rtol=0, atol=0)
    o1.clear_gradients()
    assert w1.grad is not None and not w1.grad.any()
    o1.clear_grad(set_to_zero=False)
    assert w1.grad is None


def test_init_and_apply_gradients_match_reference():
    """The functional pair over dicts of tensors against paddle_tpu's
    (Lamb with bf16 master weights and a clip, 3 steps at explicit lr and
    step numbers): new parameters and state each time, the inputs left
    as they were."""
    rs = np.random.RandomState(5)
    vals = {n: rs.randn(*s).astype(np.float32) for n, s in _SHAPES.items()}
    low = "b.weight"
    kw = dict(lamb_weight_decay=0.01, multi_precision=True)
    jopt = paddle.optimizer.Lamb(0.01, parameters=[],
                                 grad_clip=jclip.ClipGradByGlobalNorm(1.0),
                                 **kw)
    topt = topt_mod.Lamb(0.01, parameters=[],
                         grad_clip=tclip.ClipGradByGlobalNorm(1.0), **kw)
    jp = {n: jnp.asarray(v).astype(jnp.bfloat16 if n == low else jnp.float32)
          for n, v in vals.items()}
    tp = {n: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if n == low else torch.float32)
        for n, v in vals.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    apply = jax.jit(lambda p, g, s, lr, t: jopt.apply_gradients(
        p, g, s, lr=lr, step=t))
    assert {n: set(s) for n, s in ts.items()} == {n: set(s)
                                                   for n, s in js.items()}
    for t, lr in ((1, 0.02), (2, 0.01), (7, 0.005)):
        g = {n: (rs.randn(*s) * 2).astype(np.float32)
             for n, s in _SHAPES.items()}
        before = {n: v.clone() for n, v in tp.items()}
        jp, js = apply(jp, {n: jnp.asarray(a).astype(jp[n].dtype)
                            for n, a in g.items()}, js, lr, t)
        new_tp, new_ts = topt.apply_gradients(
            tp, {n: torch.from_numpy(a).to(tp[n].dtype) for n, a in g.items()},
            ts, lr=lr, step=t)
        for n in tp:
            assert torch.equal(tp[n], before[n])           # inputs kept
        tp, ts = new_tp, new_ts
        for n in vals:
            _close(tp[n], jp[n], n == low, f"step {t} {n}")
            for slot, arr in js[n].items():
                _close(ts[n][slot], arr, what=f"step {t} {n}.{slot}")


def test_load_opt_state_carries_the_scheduler():
    """``load_paddle_tpu_opt_state(..., lr_state=)`` takes paddle_tpu's
    scheduler state with the slots: the port continues the schedule where
    paddle_tpu's stands, and its slots replace the optimizer's own; a
    scheduler state for an optimizer without a scheduler raises."""
    def sched(m):
        return m.LinearWarmup(m.CosineAnnealingDecay(0.1, T_max=8), 3,
                              0.0, 0.1)
    js = sched(jlr)
    for _ in range(5):
        js.step()
    p = {"a.weight": torch.nn.Parameter(torch.zeros(2, 3))}
    opt = topt_mod.Momentum(learning_rate=sched(tlr),
                            parameters=list(p.values()))
    opt._accumulators["stale"] = {"a.weight": torch.ones(2, 3)}
    state = {"a.weight": {"velocity": np.full((2, 3), 0.5, np.float32)}}
    load_paddle_tpu_opt_state(opt, _module(p), state, step=5,
                              lr_state=js.state_dict())
    assert set(opt._accumulators) == {"velocity"}
    assert opt._step_count == 5
    for _ in range(6):
        assert opt.get_lr() == js()
        js.step()
        opt._learning_rate.step()
    plain = topt_mod.Momentum(learning_rate=0.1, parameters=list(p.values()))
    with pytest.raises(ValueError, match="scheduler"):
        load_paddle_tpu_opt_state(plain, _module(p), state,
                                  lr_state=js.state_dict())
