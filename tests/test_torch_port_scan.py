"""paddle_tpu_torch's ``TrainStep`` window API (``scan_steps``, ``warm``,
``skip_step``, ``flush_accumulation``, ``eval_fn``) against paddle_tpu's
and against the port's own per-step loop, on ``gpt_tiny`` cut to 2
layers in f32 on the CPU.

Both sides start from the same seeded weights (``load_paddle_tpu_params``)
and take the same numpy batches. Tolerances: against paddle_tpu, losses
rtol 1e-4 and parameters rtol 1e-4 / atol 1e-5 (the TrainStep trajectory
tolerance of ``tests/test_torch_port_train.py``: XLA:CPU and PyTorch sum
in other orders); against the port's own loop, bit for bit (the same
code in the same order); ``eval_fn`` atol 1e-5.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.jit.functional import raw_state
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit import training as ttraining
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

LAYERS = 2


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=6),
                            warmup_steps=3, start_lr=1e-4, end_lr=1e-3)


# (kind, argument): "scan" k batches, "call" one, "skip", "flush"
SEQUENCES = {
    1: (("scan", 3), ("call", None), ("skip", None), ("call", None)),
    2: (("scan", 3), ("flush", None), ("skip", None), ("scan", 3)),
}


def _drive(step, batches, seq, stack, single):
    """Run ``seq`` on ``step``; returns the losses as floats."""
    losses, i = [], 0
    for kind, k in seq:
        if kind == "scan":
            sb = stack(batches[i:i + k])
            losses += [float(x) for x in step.scan_steps(k, sb, sb)]
            i += k
        elif kind == "call":
            x = single(batches[i])
            losses.append(float(step(x, x)))
            i += 1
        elif kind == "skip":
            step.skip_step()
            i += 1
        else:
            step.flush_accumulation()
    return losses


def _counters(step):
    return (step.step_count, step.update_count,
            step.optimizer._learning_rate.last_epoch)


@pytest.fixture(scope="module")
def seeded():
    """A seeded paddle_tpu gpt_tiny (2 layers), its numpy params, 12
    batches and paddle_tpu's runs of both sequences: (losses, params,
    counters, Adam's step number)."""
    paddle.seed(7)
    jm = JaxGPT(dataclasses.replace(jax_gpt_tiny(), num_layers=LAYERS))
    params = {n: np.asarray(v) for n, v in raw_state(jm)[0].items()}
    rs = np.random.RandomState(0)
    batches = [rs.randint(0, 256, (2, 32)).astype(np.int64)
               for _ in range(12)]
    runs = {}
    for k, seq in SEQUENCES.items():
        opt = paddle.optimizer.AdamW(learning_rate=_sched(jlr),
                                     parameters=jm.parameters(),
                                     grad_clip=JaxClip(1.0))
        step = JaxTrainStep(jm, jm.make_loss_fn(), opt, accumulate_steps=k)
        losses = _drive(step, batches, seq, np.stack, paddle.to_tensor)
        runs[k] = (losses, {n: np.asarray(v) for n, v in step.params.items()},
                   _counters(step))
    return jm, params, batches, runs


def _port_model(params, **kw):
    tm = GPTForCausalLM(dataclasses.replace(gpt_tiny(**kw), num_layers=LAYERS),
                        device="cpu", seed=1)
    return load_paddle_tpu_params(tm, params)


def _port_step(tm, k=1, learning_rate=None):
    opt = AdamW(learning_rate=(_sched(tlr) if learning_rate is None
                               else learning_rate),
                parameters=tm.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    return TrainStep(tm, tm.make_loss_fn(), opt, accumulate_steps=k)


def _stack(bs):
    return torch.from_numpy(np.stack(bs))


@pytest.mark.parametrize("k", sorted(SEQUENCES))
def test_scan_steps_matches_reference(seeded, k):
    """With k = 1: a window of 3, a trailing ``__call__``, ``skip_step``
    at an update (so Adam's next t is the larger update count) and a
    call. With k = 2: a window of 3 from a micro-step, then
    ``flush_accumulation`` (the one pending micro-step's grads), a
    ``skip_step`` at a micro-step, and a window of 3 from an update
    position. Against paddle_tpu's same sequence: losses, parameters,
    counters and the scheduler."""
    _, params, batches, runs = seeded
    want, want_params, want_counters = runs[k]
    tm = _port_model(params)
    step = _port_step(tm, k)
    got = _drive(step, batches, SEQUENCES[k], _stack, torch.from_numpy)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert _counters(step) == want_counters
    assert step.optimizer._step_count == step.update_count
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[n],
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    if k == 1:           # t after the skip: 6, not the 5 updates applied
        assert step.update_count == 6


@pytest.mark.parametrize("k", sorted(SEQUENCES))
def test_scan_steps_equals_the_port_loop_bitwise(seeded, k):
    """At dropout 0.1: the sequence with its windows against the same
    sequence of single calls on the same weights: equal losses (so equal
    masks) and parameters, bit for bit."""
    _, params, batches, _ = seeded
    runs = []
    for windows in (True, False):
        tm = _port_model(params, dropout=0.1)
        step = _port_step(tm, k)
        seq = SEQUENCES[k]
        if not windows:
            seq = [c for kind, n in seq
                   for c in ([("call", None)] * n if kind == "scan"
                             else [(kind, n)])]
        trandom.seed(3)
        losses = _drive(step, batches, seq, _stack, torch.from_numpy)
        runs.append((losses, {n: p.detach().clone()
                              for n, p in tm.named_parameters()},
                     _counters(step)))
    (l0, p0, c0), (l1, p1, c1) = runs
    assert l0 == l1 and c0 == c1
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def test_scan_steps_rejects_bad_window(seeded):
    """As paddle_tpu's ``test_scan_steps_rejects_bad_window``: K < 1 and
    a leaf whose leading dim is not K raise ValueError (so does a 0-d
    leaf), and nothing moves."""
    _, params, batches, _ = seeded
    step = _port_step(_port_model(params))
    xs = _stack(batches[:4])
    for k, leaves in ((0, (xs, xs)), (3, (xs, xs)), (4, (xs, xs[0, 0, 0]))):
        with pytest.raises(ValueError):
            step.scan_steps(k, *leaves)
    assert _counters(step) == (0, 0, 0)


@pytest.mark.parametrize("k", [1, 2])
def test_window_rollback_after_a_failing_step(seeded, k):
    """A ``loss_fn`` that raises at the window's third step: the error
    propagates, and the counters, the optimizer's step number and the
    scheduler end as after 2 sequential steps, whose updates stay
    applied (the parameters equal two ``__call__``s')."""
    _, params, batches, _ = seeded
    sb = _stack(batches[:4])

    tm = _port_model(params)
    step = _port_step(tm, k)
    loss_fn = step.loss_fn
    calls = []

    def failing(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("step 3 fails")
        return loss_fn(*a)
    step.loss_fn = failing
    with pytest.raises(RuntimeError, match="step 3 fails"):
        step.scan_steps(4, sb, sb)

    ref_m = _port_model(params)
    ref = _port_step(ref_m, k)
    for b in batches[:2]:
        x = torch.from_numpy(b)
        ref(x, x)
    assert _counters(step) == _counters(ref)
    assert step.optimizer._step_count == ref.optimizer._step_count
    assert step.optimizer.get_lr() == ref.optimizer.get_lr()
    assert (step.optimizer._learning_rate.state_dict()
            == ref.optimizer._learning_rate.state_dict())
    for (n, p), q in zip(tm.named_parameters(), ref_m.parameters()):
        assert torch.equal(p, q), n


def test_masks_after_a_skip_match_the_unfaulted_run(seeded):
    """At learning rate 0 and dropout 0.1, the same batch every step: a
    run with one ``skip_step`` gives, at step counts 3-5, the losses of an
    unfaulted run at those counts; the masks do change from step to
    step."""
    _, params, batches, _ = seeded
    x = torch.from_numpy(batches[0])
    runs = []
    for skip in (False, True):
        step = _port_step(_port_model(params, dropout=0.1),
                          learning_rate=0.0)
        trandom.seed(5)
        losses = []
        for i in range(5):
            if skip and i == 1:
                step.skip_step()
                losses.append(None)
            else:
                losses.append(float(step(x, x)))
        runs.append(losses)
    assert runs[1][2:] == runs[0][2:]
    assert len(set(runs[0])) == 5


@pytest.mark.parametrize("k", [1, 2])
def test_warm_changes_nothing(seeded, k):
    """``warm`` returns paddle_tpu's sites, creates the optimizer's slots
    (zeros) and moves no parameter, counter, LR or random state: the
    steps after it equal the steps without it, bit for bit. ``store=``
    raises NotImplementedError naming A8."""
    _, params, batches, _ = seeded
    x = torch.from_numpy(batches[0])
    runs = []
    for warm in (True, False):
        tm = _port_model(params, dropout=0.1)
        step = _port_step(tm, k)
        trandom.seed(9)
        if warm:
            before = ({n: p.detach().clone()
                       for n, p in tm.named_parameters()},
                      _counters(step), step.optimizer.get_lr(),
                      trandom.get_rng_state())
            recs = step.warm(x, x, scan_k=4)
            sites = (["train_step"] if k == 1
                     else ["train_step_acc", "train_step_apply"])
            assert [r["site"] for r in recs] == sites + ["train_step_scan_k4"]
            assert all(r["built"] == {} and r["device"] == "cpu"
                       for r in recs)
            for n, p in tm.named_parameters():
                assert torch.equal(p, before[0][n]), n
            assert (_counters(step), step.optimizer.get_lr()) == before[1:3]
            state = trandom.get_rng_state()
            assert state["seed"] == before[3]["seed"]
            assert all(torch.equal(state["states"][d], s)
                       for d, s in before[3]["states"].items())
            moments = step.optimizer._accumulators["moment1"]
            assert set(moments) == set(before[0])
            assert not any(m.any() for m in moments.values())
            with pytest.raises(NotImplementedError, match="A8"):
                step.warm(x, x, store=object())
        runs.append([float(step(x, x)) for _ in range(2 * k)]
                    + [p.detach().clone() for p in tm.parameters()])
    assert runs[0][:2 * k] == runs[1][:2 * k]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2 * k:],
                                                   runs[1][2 * k:]))


def test_eval_fn_matches_reference_and_restores_the_mode(seeded):
    jm, params, batches, _ = seeded
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=jm.parameters())
    jstep = JaxTrainStep(jm, jm.make_loss_fn(), opt)
    want = np.asarray(jstep.eval_fn()(paddle.to_tensor(batches[1])).value)
    tm = _port_model(params, dropout=0.1)
    step = _port_step(tm)
    run = step.eval_fn()
    for mode in (True, False):
        tm.train(mode)
        got = run(torch.from_numpy(batches[1]))
        assert tm.training is mode and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_window_functions_are_module_level():
    """``window_schedule`` advances a stand-in step as the sequential path
    would: lr read before each step, the scheduler stepped after each
    update, micro-steps carrying the next update's number."""
    sched = tlr.StepDecay(1.0, step_size=1, gamma=0.5)
    stand = types.SimpleNamespace(
        accumulate_steps=2, auto_lr_step=True, step_count=1, update_count=1,
        optimizer=types.SimpleNamespace(_step_count=0, _learning_rate=sched,
                                        get_lr=sched))
    lrs, nos, counts, upd = ttraining.window_schedule(stand, 3)
    assert lrs.tolist() == [1.0, 0.5, 0.5]
    assert nos.tolist() == [1.0, 2.0, 2.0]
    assert counts.tolist() == [2, 3, 4]
    assert upd.tolist() == [True, False, True]
    assert (stand.step_count, stand.update_count,
            stand.optimizer._step_count) == (4, 3, 2)
    assert callable(ttraining.make_scan_window)
    assert callable(ttraining.window_rollback)
