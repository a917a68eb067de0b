"""paddle_tpu_torch's BERT/ERNIE (models/bert.py) against paddle_tpu's.

Weights cross as numpy arrays from ``raw_state`` by parameter name
(``load_paddle_tpu_params``); ids, token types, padding masks and labels
are made with numpy from a seed and handed to both sides. ``bert_tiny`` /
``ernie_3_tiny`` (vocab 512, hidden 64, 2 layers, 4 heads, dropout 0) in
f32 on the CPU, where the port's attention and cross-entropy run their
kernels' plain versions and paddle_tpu its XLA attention.

Tolerances: outputs, logits, losses and every gradient atol 1e-5 (the
same f32 operations, matmul and softmax sums taken in other orders by
XLA:CPU and PyTorch's CPU kernels; values are O(1)); the 5-step
TrainStep losses rtol 1e-4, as the GPT trajectory's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.jit.functional import functional_call, raw_state
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.optimizer import AdamW

B, S = 2, 16


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(seed=0, vocab=512):
    """ids, token types and a padding mask (row 1 padded after 11
    tokens) as int64 numpy arrays."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (B, S)).astype(np.int64)
    tt = rs.randint(0, 2, (B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1, 11:] = 0
    return ids, tt, mask


def _pair(jcls, tcls, cfg_name, **kw):
    """A seeded paddle_tpu model, and the port's with its weights."""
    paddle.seed(3)
    jm = jcls(getattr(jbert, cfg_name)(), **kw)
    params, _ = raw_state(jm)
    params = {n: np.asarray(v) for n, v in params.items()}
    tm = tcls(getattr(tbert, cfg_name)(), device="cpu", seed=1, **kw)
    return jm, load_paddle_tpu_params(tm, params), params


def _jax_forward(jm, params, *args):
    _, buffers = raw_state(jm)
    out, _ = jax.jit(lambda p, *a: functional_call(
        jm, p, buffers, *a, training=False))(
        {n: jnp.asarray(v) for n, v in params.items()},
        *[None if a is None else jnp.asarray(a) for a in args])
    return out


def _t(a):
    return None if a is None else torch.from_numpy(a)


def test_bert_config_fields_and_factories_match_reference():
    assert ([(f.name, f.default) for f in dataclasses.fields(tbert.BertConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jbert.BertConfig)])
    for name in ("bert_tiny", "bert_base", "ernie_3_tiny", "ernie_3_base"):
        assert (dataclasses.asdict(getattr(tbert, name)())
                == dataclasses.asdict(getattr(jbert, name)())), name
    assert tbert.ernie_3_base(hidden_act="gelu").hidden_act == "gelu"


def test_gpt_6p7b_fields_match_reference():
    from paddle_tpu.models.gpt import gpt_6p7b as jax_6p7b
    from paddle_tpu_torch.models import gpt_6p7b
    assert dataclasses.asdict(gpt_6p7b()) == dataclasses.asdict(jax_6p7b())


def test_scan_layers_raises():
    """``scan_layers`` is ported: at dropout 0 the encoder builds as
    paddle_tpu's, with its stacked ``layers.*__*`` names and shapes; at
    dropout 0.1 both raise NotImplementedError."""
    paddle.seed(0)
    params, _ = raw_state(jbert.BertModel(jbert.bert_tiny(scan_layers=True)))
    tm = tbert.BertModel(tbert.bert_tiny(scan_layers=True), device="cpu")
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: tuple(a.shape) for n, a in params.items()}
    for build, mod in ((lambda c: jbert.BertModel(c), jbert),
                       (lambda c: tbert.BertModel(c, device="cpu"), tbert)):
        with pytest.raises(NotImplementedError, match="dropout"):
            build(dataclasses.replace(mod.bert_tiny(scan_layers=True),
                                      dropout=0.1))


def test_parameter_names_match_reference():
    for jcls, tcls in ((jbert.BertForSequenceClassification,
                        tbert.BertForSequenceClassification),
                       (jbert.BertForMaskedLM, tbert.BertForMaskedLM)):
        paddle.seed(0)
        params, _ = raw_state(jcls(jbert.bert_tiny()))
        got = {n: tuple(p.shape) for n, p in
               tcls(tbert.bert_tiny(), device="cpu").named_parameters()}
        assert got == {n: tuple(v.shape) for n, v in params.items()}


def test_init_draws_seeded_weights():
    """Normal 2-D weights, LayerNorm weights ones, biases zeros; one seed
    gives the same model twice, another seed another."""
    cfg = tbert.bert_tiny()
    a = tbert.BertForMaskedLM(cfg, device="cpu", seed=4)
    b = tbert.BertForMaskedLM(cfg, device="cpu", seed=4)
    c = tbert.BertForMaskedLM(cfg, device="cpu", seed=5)
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    for n, p in pa.items():
        assert torch.equal(p, pb[n]), n
        if n.endswith("layer_norm.weight") or ".ln_" in n and \
                n.endswith(".weight"):
            assert bool((p == 1).all()), n
        elif p.ndim == 1:
            assert bool((p == 0).all()), n
        else:
            assert not torch.equal(p, pc[n]), n
            assert abs(p.std().item() - cfg.initializer_range) < 0.005, n
    assert not a.training


@pytest.mark.parametrize("case", ["ids", "token types", "mask", "both",
                                  "ernie"])
def test_encoder_outputs_match(case):
    """Sequence and pooled outputs, with and without a padding mask and
    token types (B1's plain version without a mask, the masked plain
    attention with one), atol 1e-5."""
    cfg = "ernie_3_tiny" if case == "ernie" else "bert_tiny"
    jcls = jbert.ErnieModel if case == "ernie" else jbert.BertModel
    tcls = tbert.ErnieModel if case == "ernie" else tbert.BertModel
    jm, tm, params = _pair(jcls, tcls, cfg)
    ids, tt, mask = _inputs()
    tt = tt if case in ("token types", "both", "ernie") else None
    mask = mask if case in ("mask", "both", "ernie") else None
    want = _jax_forward(jm, params, ids, tt, mask)
    with torch.no_grad():
        got = tm(_t(ids), _t(tt), _t(mask))
    assert got[0].shape == (B, S, 64) and got[1].shape == (B, 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=1e-5)


def test_sequence_too_long_raises():
    tm = tbert.BertModel(tbert.bert_tiny(), device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        tm(torch.zeros(1, 129, dtype=torch.int64))


def test_mask_bias_stays_f32_in_bf16():
    """In a bf16 model the padding bias is the f32 (m - 1) * 1e30: the
    padded keys get exactly zero probability, so the outputs of the kept
    rows do not see the padded tokens."""
    tm = tbert.BertModel(tbert.bert_tiny(), device="cpu", seed=2).bfloat16()
    ids, _, mask = _inputs(1)
    other = ids.copy()
    other[1, 11:] = (other[1, 11:] + 7) % 512     # change only the padding
    with torch.no_grad():
        a = tm(_t(ids), None, _t(mask))[0]
        b = tm(_t(other), None, _t(mask))[0]
    assert torch.equal(a[1, :11], b[1, :11])
    assert torch.equal(a[0], b[0])


def _classifier_loss_and_grads(jm, params, ids, tt, mask, labels):
    _, buffers = raw_state(jm)

    @jax.jit
    def value_and_grad(p):
        def loss_of(p_):
            out, _ = functional_call(jm, p_, buffers, jnp.asarray(ids),
                                     jnp.asarray(tt), jnp.asarray(mask),
                                     training=True)
            return jbert.BertForSequenceClassification.loss_fn(
                Tensor(out), Tensor(jnp.asarray(labels))).value
        return jax.value_and_grad(loss_of)(p)

    return value_and_grad({n: jnp.asarray(v) for n, v in params.items()})


def test_classifier_loss_and_grads_match():
    """The classifier's loss (B2's plain version at V = 2) and every
    parameter's gradient at dropout 0, with token types and a padding
    mask, atol 1e-5."""
    jm, tm, params = _pair(jbert.BertForSequenceClassification,
                           tbert.BertForSequenceClassification, "bert_tiny")
    ids, tt, mask = _inputs(2)
    labels = np.array([1, 0], np.int64)
    jloss, jgrads = _classifier_loss_and_grads(jm, params, ids, tt, mask,
                                               labels)
    tm.train()
    loss = tm.loss_fn(tm(_t(ids), _t(tt), _t(mask)), _t(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(jgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(got[n].grad.numpy(), _np(g), rtol=0,
                                   atol=1e-5, err_msg=n)


def test_mlm_logits_and_loss_match():
    """The MLM head (decoder tied to the word embedding, its own bias):
    logits, and the loss over the rows whose label is not ignore_index
    (about a quarter of them), atol 1e-5."""
    jm, tm, params = _pair(jbert.BertForMaskedLM, tbert.BertForMaskedLM,
                           "bert_tiny")
    with torch.no_grad():                  # a nonzero decoder bias
        tm.decoder_bias.copy_(torch.linspace(-1, 1, 512))
    params["decoder_bias"] = tm.decoder_bias.detach().numpy().copy()
    ids, tt, mask = _inputs(3)
    rs = np.random.RandomState(4)
    labels = rs.randint(0, 512, (B, S)).astype(np.int64)
    labels[rs.rand(B, S) < 0.25] = -100
    want = _jax_forward(jm, params, ids, tt, mask)
    want_loss = jbert.BertForMaskedLM.loss_fn(
        Tensor(want), Tensor(jnp.asarray(labels))).value
    with torch.no_grad():
        got = tm(_t(ids), _t(tt), _t(mask))
        loss = tm.loss_fn(got, _t(labels))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0,
                               atol=1e-5)


def test_finetune_trajectory_matches():
    """A 5-step TrainStep of the classifier (AdamW, n_inputs = 3: ids,
    token types, mask) against paddle_tpu's on the same batches, rtol
    1e-4."""
    jm, tm, _ = _pair(jbert.BertForSequenceClassification,
                      tbert.BertForSequenceClassification, "bert_tiny")
    rs = np.random.RandomState(5)
    batches = []
    for i in range(5):
        ids, tt, mask = _inputs(10 + i)
        labels = rs.randint(0, 2, B).astype(np.int64)
        batches.append((ids, tt, mask, labels))
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    jstep = JaxTrainStep(jm, jbert.BertForSequenceClassification.loss_fn,
                         jopt, n_inputs=3)
    want = [float(jstep(*[paddle.to_tensor(a) for a in b]).numpy())
            for b in batches]
    step = TrainStep(tm, tm.loss_fn,
                     AdamW(learning_rate=1e-3, parameters=tm.parameters()),
                     n_inputs=3)
    got = [step(*[_t(a) for a in b]).item() for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
