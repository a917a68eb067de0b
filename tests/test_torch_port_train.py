"""paddle_tpu_torch training (optimizer, schedulers, clip, GPT loss and
grads, TrainStep) against paddle_tpu.

Weights and optimizer state cross as numpy arrays
(``load_paddle_tpu_params``, ``load_paddle_tpu_opt_state``); batches and
gradients are made with numpy from a seed and handed to both sides. The
GPT cases run ``gpt_tiny`` (hidden 64, 4 layers, 4 heads) in f32 on the
CPU, where the port's attention and cross-entropy run their kernels'
plain versions.

Tolerances: the AdamW / Adam update atol 1e-6 on the f32 parameters and
slots (the same f32 operations, possibly fused differently), bf16
parameters within one bf16 rounding step of their f32 master (rtol
2**-8); the gpt_tiny loss atol 1e-5 and every parameter grad atol 1e-5
(f32 matmul and softmax summation orders differ between XLA:CPU and
PyTorch's CPU kernels); TrainStep losses rtol 1e-4 per step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.jit.functional import functional_call, raw_state
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.convert import (load_paddle_tpu_opt_state,
                                      load_paddle_tpu_params)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamW, L2Decay
from paddle_tpu_torch.optimizer import lr as tlr

_SHAPES = {"a.weight": (8, 16), "a.bias": (16,), "b.weight": (16, 4)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", ["adamw-clip-master", "adam-l2-no-master"])
def test_optimizer_update_matches_apply_gradients(case):
    """Three updates of f32 and bf16 parameters from the same grads: the
    port's eager ``step()`` against paddle_tpu's ``apply_gradients``."""
    rs = np.random.RandomState(0)
    vals = {n: rs.randn(*s).astype(np.float32) for n, s in _SHAPES.items()}
    low = {"b.weight"}                             # the bf16 parameter
    if case == "adamw-clip-master":
        kw = dict(weight_decay=0.05, multi_precision=True,
                  apply_decay_param_fun=lambda n: not n.endswith("bias"))
        jopt = paddle.optimizer.AdamW(learning_rate=3e-3, parameters=[],
                                      grad_clip=JaxClip(1.0), **kw)
        topt_cls, tkw = AdamW, dict(grad_clip=ClipGradByGlobalNorm(1.0), **kw)
    else:
        jopt = paddle.optimizer.Adam(learning_rate=3e-3, parameters=[],
                                     weight_decay=paddle.regularizer.L2Decay(
                                         0.02))
        topt_cls, tkw = Adam, dict(weight_decay=L2Decay(0.02))
    jp = {n: jnp.asarray(v).astype(jnp.bfloat16 if n in low else jnp.float32)
          for n, v in vals.items()}
    tp = {n: torch.nn.Parameter(torch.from_numpy(v).to(
        torch.bfloat16 if n in low else torch.float32))
        for n, v in vals.items()}
    topt = topt_cls(learning_rate=3e-3, parameters=list(tp.items()), **tkw)
    state = jopt.init(jp)
    for t in range(1, 4):
        grads = {n: (rs.randn(*s) * 2).astype(np.float32)
                 for n, s in _SHAPES.items()}
        jg = {n: jnp.asarray(g).astype(jp[n].dtype) for n, g in grads.items()}
        jp, state = jopt.apply_gradients(jp, jg, state, step=t)
        for n, p in tp.items():
            p.grad = torch.from_numpy(grads[n]).to(p.dtype)
        topt.step()
    for n, p in tp.items():
        for slot, arr in state[n].items():
            np.testing.assert_allclose(
                topt._accumulators[slot][n].numpy(), _np(arr), rtol=0,
                atol=1e-6, err_msg=f"{n}.{slot}")
        if n in low:
            np.testing.assert_allclose(p.float().detach().numpy(), _np(jp[n]),
                                       rtol=2.0 ** -8, atol=0)
        else:
            np.testing.assert_allclose(p.detach().numpy(), _np(jp[n]), rtol=0,
                                       atol=1e-6)
    assert ("master" in topt._accumulators) == (case == "adamw-clip-master")


@pytest.mark.parametrize("case", ["adamw-lr_ratio", "adam-regularizer"])
def test_optimizer_per_parameter_attributes_match_eager_step(case):
    """Per-parameter learning rates (``optimize_attr``), regularizers and
    AdamW's ``lr_ratio`` (passed by position, in paddle_tpu's order):
    three updates of the port's ``step()`` against paddle_tpu's eager
    ``step()``, which reads the same attributes off its parameters."""
    from paddle_tpu.core.tensor import Parameter as JaxParameter
    rs = np.random.RandomState(2)
    vals = {n: rs.randn(*s).astype(np.float32) for n, s in _SHAPES.items()}
    attrs = {"a.weight": (0.5, None), "a.bias": (1.0, 0.2),
             "b.weight": (2.0, 0.0)}            # (lr scale, L2 coefficient)
    jp = [JaxParameter(jnp.asarray(v), name=n) for n, v in vals.items()]
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy()))
          for v in vals.values()]
    for j, t, (scale, coeff) in zip(jp, tp, attrs.values()):
        for p, reg in ((j, paddle.regularizer.L2Decay), (t, L2Decay)):
            p.optimize_attr = {"learning_rate": scale}
            p.regularizer = None if coeff is None else reg(coeff)
    if case == "adamw-lr_ratio":
        ratio = {id(p): r for ps in (jp, tp) for p, r in zip(ps, (1.0, 3.0,
                                                                 0.25))}
        args = (3e-3, 0.9, 0.999, 1e-8)
        jopt = paddle.optimizer.AdamW(*args, jp, 0.05,
                                      lambda p: ratio[id(p)])
        topt = AdamW(*args, list(zip(vals, tp)), 0.05,
                     lambda p: ratio[id(p)])
    else:
        jopt = paddle.optimizer.Adam(3e-3, parameters=jp, weight_decay=0.01)
        topt = Adam(3e-3, parameters=list(zip(vals, tp)), weight_decay=0.01)
    for _ in range(3):
        for j, t in zip(jp, tp):
            g = (rs.randn(*t.shape) * 2).astype(np.float32)
            j._grad = jnp.asarray(g)
            t.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
    for n, j, t in zip(vals, jp, tp):
        np.testing.assert_allclose(t.detach().numpy(), _np(j.value), rtol=0,
                                   atol=1e-6, err_msg=n)
        for slot in ("moment1", "moment2"):
            np.testing.assert_allclose(
                topt._accumulators[slot][n].numpy(),
                _np(jopt._accumulators[slot][n]), rtol=0, atol=1e-6,
                err_msg=f"{n}.{slot}")


def test_clip_by_global_norm_matches():
    rs = np.random.RandomState(1)
    grads = [(rs.randn(*s) * 3).astype(np.float32) for s in _SHAPES.values()]
    want = JaxClip(0.5).clip_raw([jnp.asarray(g) for g in grads])
    got = ClipGradByGlobalNorm(0.5).clip_raw([torch.from_numpy(g)
                                              for g in grads])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-7)


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=6),
                            warmup_steps=3, start_lr=1e-4, end_lr=1e-3)


def test_lr_schedulers_match():
    js, ts = _sched(jlr), _sched(tlr)
    for _ in range(12):
        assert ts() == js()
        js.step()
        ts.step()


@pytest.fixture(scope="module")
def seeded():
    """A seeded paddle_tpu gpt_tiny, its numpy params and 5 batches."""
    paddle.seed(7)
    jm = JaxGPT(jax_gpt_tiny())
    params, _ = raw_state(jm)
    rs = np.random.RandomState(0)
    batches = [rs.randint(0, 256, (2, 32)).astype(np.int64)
               for _ in range(5)]
    return jm, {n: np.asarray(v) for n, v in params.items()}, batches


def _port_model(params):
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    return load_paddle_tpu_params(tm, params)


def test_gpt_tiny_loss_and_grads_match(seeded):
    jm, params, batches = seeded
    ids = batches[0]
    _, buffers = raw_state(jm)

    @jax.jit
    def value_and_grad(p, x):
        def loss_of(p_):
            out, _ = functional_call(jm, p_, buffers, x, training=True)
            return JaxGPT.loss_fn(Tensor(out), Tensor(x)).value
        return jax.value_and_grad(loss_of)(p)

    jloss, jgrads = value_and_grad({n: jnp.asarray(v)
                                    for n, v in params.items()},
                                   jnp.asarray(ids))
    tm = _port_model(params).train()
    x = torch.from_numpy(ids)
    loss = tm.loss_fn(tm(x), x)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(jgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(got[n].grad.numpy(), _np(g), rtol=0,
                                   atol=1e-5, err_msg=n)


def _jax_step(jm, accumulate_steps=1):
    opt = paddle.optimizer.AdamW(learning_rate=_sched(jlr),
                                 parameters=jm.parameters(),
                                 grad_clip=JaxClip(1.0))
    return JaxTrainStep(jm, jm.make_loss_fn(), opt,
                        accumulate_steps=accumulate_steps)


def _port_step(tm, accumulate_steps=1):
    opt = AdamW(learning_rate=_sched(tlr), parameters=tm.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    return TrainStep(tm, tm.make_loss_fn(), opt,
                     accumulate_steps=accumulate_steps)


@pytest.fixture(scope="module")
def jax_trajectory(seeded):
    """paddle_tpu's TrainStep over the 5 batches (f32 AdamW, warmup +
    cosine schedule, global-norm clip): the losses, and its params and
    optimizer state after 2 steps."""
    jm, _, batches = seeded
    step = _jax_step(jm)
    losses, snap = [], None
    for i, ids in enumerate(batches):
        x = paddle.to_tensor(ids)
        losses.append(float(step(x, x).numpy()))
        if i == 1:
            snap = ({n: np.asarray(v) for n, v in step.params.items()},
                    jax.tree_util.tree_map(np.asarray, step.opt_state),
                    step.update_count)
    return losses, snap


def test_train_step_trajectory_matches(seeded, jax_trajectory):
    _, params, batches = seeded
    want, _ = jax_trajectory
    tm = _port_model(params)
    step = _port_step(tm)
    got = [step(torch.from_numpy(b), torch.from_numpy(b)).item()
           for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert (step.step_count, step.update_count) == (5, 5)
    assert step.optimizer._learning_rate.last_epoch == 5
    assert step.sync_to_model() is tm


def test_train_step_resumes_from_loaded_opt_state(seeded, jax_trajectory):
    """Start the port from paddle_tpu's params and optimizer state after 2
    steps; steps 3-5 give paddle_tpu's losses."""
    _, _, batches = seeded
    want, (params, opt_state, update_count) = jax_trajectory
    tm = _port_model(params)
    step = _port_step(tm)
    load_paddle_tpu_opt_state(step.optimizer, tm, opt_state,
                              step=update_count)
    for _ in range(update_count):
        step.optimizer._learning_rate.step()
    got = [step(torch.from_numpy(b), torch.from_numpy(b)).item()
           for b in batches[2:]]
    np.testing.assert_allclose(got, want[2:], rtol=1e-4, atol=0)
    moment = step.optimizer._accumulators["moment1"]["gpt.ln_f.weight"]
    assert moment.dtype == torch.float32 and moment.abs().sum() > 0


def test_load_opt_state_is_strict(seeded):
    _, params, _ = seeded
    tm = _port_model(params)
    opt = AdamW(parameters=tm.parameters())
    state = {n: {"moment1": np.zeros_like(v), "moment2": np.zeros_like(v)}
             for n, v in params.items()}
    bad = dict(state)
    bad.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError, match="gpt.ln_f.bias"):
        load_paddle_tpu_opt_state(opt, tm, bad)
    bad = dict(state, **{"gpt.ln_f.bias": {"moment1": np.zeros(3)}})
    with pytest.raises(ValueError, match="gpt.ln_f.bias.moment1"):
        load_paddle_tpu_opt_state(opt, tm, bad)


def test_train_step_accumulate_two_matches(seeded):
    """accumulate_steps=2 over 4 calls: two updates, each with the mean of
    two micro-batches' grads."""
    jm, params, batches = seeded
    jstep = _jax_step(jm, accumulate_steps=2)
    want = []
    for b in batches[:4]:
        x = paddle.to_tensor(b)
        want.append(float(jstep(x, x).numpy()))
    tm = _port_model(params)
    step = _port_step(tm, accumulate_steps=2)
    got = [step(torch.from_numpy(b), torch.from_numpy(b)).item()
           for b in batches[:4]]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert (step.step_count, step.update_count) == (4, 2)
    assert all(p.grad is None for p in tm.parameters())
    final = {n: _np(v) for n, v in jstep.params.items()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[n], rtol=0,
                                   atol=1e-5, err_msg=n)


def test_bfloat16_matches_paddle_tpu_and_trains_with_master_weights(seeded):
    """``model.bfloat16()`` casts every float parameter, as paddle_tpu's
    ``Layer.bfloat16()`` does; a bf16 TrainStep with ``multi_precision``
    keeps f32 masters and its loss falls over 5 steps on one batch."""
    _, params, batches = seeded
    jm = JaxGPT(jax_gpt_tiny())
    jm.bfloat16()
    jdt = {n: str(v.dtype) for n, v in raw_state(jm)[0].items()}
    tm = _port_model(params).bfloat16()
    assert {n: str(p.dtype).replace("torch.", "")
            for n, p in tm.named_parameters()} == jdt
    assert set(jdt.values()) == {"bfloat16"}
    step = TrainStep(tm, tm.make_loss_fn(),
                     AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                           multi_precision=True))
    x = torch.from_numpy(batches[0])
    losses = [step(x, x).item() for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    masters = step.optimizer._accumulators["master"]
    assert len(masters) == len(jdt)
    assert all(m.dtype == torch.float32 for m in masters.values())
