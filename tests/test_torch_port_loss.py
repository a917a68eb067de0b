"""paddle_tpu_torch fused cross-entropy (B2) and loss functionals against
paddle_tpu.

The port's ``ce_fwd`` / ``ce_bwd`` run their plain versions on CPU
tensors; they are held against paddle_tpu's Pallas kernels in interpret
mode, both the grid-free body and the gridded TPU body (``force_grid``),
at N=300 rows, V=1000, 1001 and 1003 columns, with and without a
padded-vocab tail, and with bf16 dlogits of f32 logits (``out_dtype``).
The host's split of a row for the CUDA kernels (``row_split``) is
checked to cover every column once, and the backward's output to share
the logits' offset from a 16-byte boundary.
``cross_entropy`` is held against paddle_tpu's, with the fused-CE knob
off and on, through paddle_tpu's eager tape for the grads. Inputs are
made with numpy from a seed and handed to both sides.

Tolerances: per-row loss and LSE atol 1e-5 (f32 log-sum-exp of 1000
terms, summed in another order); dlogits entry by entry, with no atol
so that masked zeros stay zero: rtol 1e-6 in f32 (an elementwise exp of
the same f32 values), and in bf16 one bf16 rounding step of the entry
(rtol 2**-7: the two sides may round an f32 value on either side of a
bf16 tie);
losses and grads of the functionals atol 1e-5 (f32), plus rtol 1e-6 on
a summed loss (a sum of 64 losses near 273 is only good to its f32
rounding, ~3e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as PF
from paddle_tpu.kernels.fused_ce import ce_bwd as jax_ce_bwd
from paddle_tpu.kernels.fused_ce import ce_fwd as jax_ce_fwd
from paddle_tpu.kernels.fused_ce import online_lse as jax_online_lse
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.kernels import fused_ce as tce
from paddle_tpu_torch.models import GPTForCausalLM
from paddle_tpu_torch.nn import functional as TF

ATOL = 1e-5


def _f32(x):
    """numpy f32 of a jax array."""
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ce_inputs(N=300, V=1000, vv=None, seed=0):
    rs = np.random.RandomState(seed)
    lg = (rs.randn(N, V) * 3).astype(np.float32)
    lab = rs.randint(0, vv or V, N).astype(np.int32)
    lab[:3] = [0, (vv or V) - 1, V - 1]    # first, last valid, last column
    g = rs.rand(N).astype(np.float32)
    return lg, lab, g


def _hold_ce_to_pallas(dtype, valid_vocab, force_grid, V=1000):
    lg, lab, g = _ce_inputs(V=V, vv=valid_vocab, seed=bool(valid_vocab))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jlg = jnp.asarray(lg).astype(jdt)
    tlg = torch.from_numpy(lg).to(tdt)
    tlab = torch.from_numpy(lab)
    jper, jlse = jax_ce_fwd(jlg, jnp.asarray(lab), valid_vocab,
                            interpret=True, force_grid=force_grid)
    per, lse = tce.ce_fwd(tlg, tlab, valid_vocab)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax_online_lse(jlg, valid_vocab)), rtol=0,
        atol=ATOL)
    jd = jax_ce_bwd(jlg, jnp.asarray(lab), jlse, jnp.asarray(g),
                    valid_vocab, interpret=True, force_grid=force_grid)
    d = tce.ce_bwd(tlg, tlab, torch.from_numpy(np.asarray(jlse)),
                   torch.from_numpy(g), valid_vocab)
    assert d.dtype == tdt and d.shape == tlg.shape
    want = _f32(jd)
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(d.float().numpy(), want, rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid_vocab", [None, 900])
@pytest.mark.parametrize("force_grid", [False, True])
def test_ce_plain_matches_pallas_interpret(dtype, valid_vocab, force_grid):
    _hold_ce_to_pallas(dtype, valid_vocab, force_grid)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,valid_vocab", [(1001, None), (1001, 999),
                                           (1003, None), (1003, 900)])
@pytest.mark.parametrize("force_grid", [False, True])
def test_ce_plain_matches_pallas_interpret_unaligned_vocab(
        dtype, V, valid_vocab, force_grid):
    """The same at vocabularies that are no multiple of 8 (the rows of
    the kernels' inputs start at drifting offsets from a 16-byte
    boundary), with and without a padded-vocab tail."""
    _hold_ce_to_pallas(dtype, valid_vocab, force_grid, V=V)


@pytest.mark.parametrize("V,valid_vocab", [(1000, None), (1003, None),
                                           (1003, 900)])
def test_ce_bwd_plain_bf16_out_matches_pallas_f32_cast(V, valid_vocab):
    """``out_dtype=torch.bfloat16`` on f32 logits (the fused loss's bf16
    dlogits) against paddle_tpu's f32 ``ce_bwd`` cast to bf16: one bf16
    rounding step of the entry (rtol 2**-7), masked zeros exactly zero."""
    lg, lab, g = _ce_inputs(V=V, vv=valid_vocab, seed=2)
    jlg, jlab = jnp.asarray(lg), jnp.asarray(lab)
    _, jlse = jax_ce_fwd(jlg, jlab, valid_vocab, interpret=True)
    jd = jax_ce_bwd(jlg, jlab, jlse, jnp.asarray(g), valid_vocab,
                    interpret=True).astype(jnp.bfloat16)
    d = tce.ce_bwd_plain(torch.from_numpy(lg), torch.from_numpy(lab),
                         torch.from_numpy(np.asarray(jlse)),
                         torch.from_numpy(g), valid_vocab,
                         out_dtype=torch.bfloat16)
    assert d.dtype == torch.bfloat16 and d.shape == (300, V)
    np.testing.assert_allclose(d.float().numpy(), _f32(jd), rtol=2.0 ** -7,
                               atol=0)


@pytest.mark.parametrize("elem", [2, 4])
def test_ce_split_covers_every_column_once(elem):
    """The host's split (``row_split``, which the kernels compute row by
    row): over a grid of N, V and base offsets, each row's head, body
    vectors and tail cover every column of [0, n) exactly once, the head
    ends on a 16-byte boundary, and the tail is shorter than a vector."""
    for N in (1, 7, 64, 256, 263):
        for V in (1, 2, 7, 9, 1001, 1003, 30522, 50304):
            for width in {16 // elem, 8}:    # the backward's bf16 side: 8
                for base in range(width):
                    for row in range(min(N, 2 * width + 1)):
                        start = (base + row * V) % width
                        for n in {V, max(1, V - 2)}:
                            head, nvec, tail = tce.row_split(start, n, width)
                            assert min(head, nvec, tail) >= 0
                            cover = np.zeros(n, np.int64)
                            cover[:head] += 1
                            assert head == n or (start + head) % width == 0
                            cover[head:head + nvec * width] += 1
                            cover[head + nvec * width:] += 1
                            assert tail == n - head - nvec * width < width \
                                or head == n
                            assert (cover == 1).all(), (N, V, n, start)


@pytest.mark.parametrize("dt_in,dt_out", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_ce_bwd_output_shares_the_input_offset(dt_in, dt_out):
    """The backward's dlogits sit as far past a 16-byte boundary as the
    logits (modulo the wider type's vector), so a 16-byte boundary of the
    narrower type's row is one of the other's: checked on views of a
    buffer at every element offset."""
    N, V = 5, 1003
    elem_in = torch.empty((), dtype=dt_in).element_size()
    elem_out = torch.empty((), dtype=dt_out).element_size()
    step = 16 // max(elem_in, elem_out)
    buf = torch.empty(N * V + 16, dtype=dt_in)
    for k in range(16 // elem_in):
        lg = buf[k:k + N * V].view(N, V)
        out = tce._like_offset(lg, dt_out)
        assert out.shape == (N, V) and out.dtype == dt_out
        assert out.is_contiguous()
        assert tce._offset(out) % step == tce._offset(lg) % step


def test_online_lse_fully_masked_row_is_neg_inf_not_nan():
    lg = torch.randn(3, 8)
    lse = tce.online_lse(lg, valid_vocab=8)
    assert torch.isfinite(lse).all()
    lg[1] = float("-inf")
    lse = tce.online_lse(lg)
    assert lse[1] == float("-inf") and torch.isfinite(lse[[0, 2]]).all()


def _paddle_loss_and_grad(logits, label, **kw):
    x = paddle.to_tensor(logits, stop_gradient=False)
    loss = PF.cross_entropy(x, paddle.to_tensor(label), **kw)
    loss.sum().backward()
    return np.asarray(loss.numpy()), np.asarray(x.grad.numpy())


def _port_loss_and_grad(logits, label, **kw):
    x = torch.from_numpy(logits.copy()).requires_grad_()
    loss = TF.cross_entropy(x, torch.from_numpy(label), **kw)
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("fused_knob", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("label_shape", ["flat", "trailing-1"])
def test_cross_entropy_hard_labels_match(monkeypatch, fused_knob, reduction,
                                         label_shape):
    """[4, 16, 50] logits, int64 labels with ignore_index rows: the fused
    (kernel) path on the port, paddle_tpu with its fused-CE knob off
    (``_fused_softmax_ce``) and on (``_pallas_softmax_ce``)."""
    if fused_knob:
        monkeypatch.setenv("PADDLE_TPU_FUSED_CE", "1")
    rs = np.random.RandomState(5)
    logits = rs.randn(4, 16, 50).astype(np.float32)
    label = rs.randint(0, 50, (4, 16)).astype(np.int64)
    label[0, :5] = -100
    label[3, -1] = 7
    if label_shape == "trailing-1":
        label = label[..., None]
    want, wgrad = _paddle_loss_and_grad(logits, label, reduction=reduction)
    tce.ce_fwd.launches = tce.ce_bwd.launches = 0
    got, grad = _port_loss_and_grad(logits, label, reduction=reduction)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(grad, wgrad, rtol=0, atol=ATOL)
    assert tce.ce_fwd.launches == tce.ce_bwd.launches == 0   # CPU: plain


def test_cross_entropy_all_rows_ignored_mean_is_zero():
    logits = np.random.RandomState(6).randn(5, 9).astype(np.float32)
    label = np.full(5, -100, np.int64)
    got, grad = _port_loss_and_grad(logits, label)
    want, wgrad = _paddle_loss_and_grad(logits, label)
    assert float(got) == float(want) == 0.0
    assert not grad.any() and not wgrad.any()


@pytest.mark.parametrize("case", ["soft", "weight", "smoothing", "axis"])
def test_cross_entropy_plain_paths_match(case):
    """Soft labels, class weights, label smoothing and a non-last class
    axis: plain tensor code on both sides."""
    rs = np.random.RandomState(7)
    logits = rs.randn(6, 10).astype(np.float32)
    label = rs.randint(0, 10, 6).astype(np.int64)
    label[2] = -100
    kw = {}
    if case == "soft":
        p = rs.rand(6, 10).astype(np.float32)
        label = p / p.sum(-1, keepdims=True)
        kw = {"soft_label": True}
    elif case == "weight":
        w = rs.rand(10).astype(np.float32)
        want, wgrad = (np.asarray(t) for t in _paddle_weighted(logits, label,
                                                               w))
        got, grad = _port_loss_and_grad(logits, label,
                                        weight=torch.from_numpy(w))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(grad, wgrad, rtol=0, atol=ATOL)
        return
    elif case == "smoothing":
        kw = {"label_smoothing": 0.1}
    else:
        logits = rs.randn(3, 10, 4).astype(np.float32)
        label = rs.randint(0, 10, (3, 4)).astype(np.int64)
        kw = {"axis": 1, "soft_label": True}
        p = rs.rand(3, 10, 4).astype(np.float32)
        label = p / p.sum(1, keepdims=True)
    want, wgrad = _paddle_loss_and_grad(logits, label, **kw)
    got, grad = _port_loss_and_grad(logits, label, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(grad, wgrad, rtol=0, atol=ATOL)


def _paddle_weighted(logits, label, w):
    x = paddle.to_tensor(logits, stop_gradient=False)
    loss = PF.cross_entropy(x, paddle.to_tensor(label),
                            weight=paddle.to_tensor(w))
    loss.backward()
    return loss.numpy(), x.grad.numpy()


def test_softmax_with_cross_entropy_matches():
    rs = np.random.RandomState(8)
    logits = rs.randn(5, 12).astype(np.float32)
    label = rs.randint(0, 12, (5, 1)).astype(np.int64)
    jl, js = PF.softmax_with_cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(label),
        return_softmax=True)
    tl, ts = TF.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label),
        return_softmax=True)
    assert tuple(tl.shape) == (5, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()), rtol=0,
                               atol=ATOL)


def test_gpt_loss_fn_shift_matches():
    """The port's ``loss_fn`` (last position's label ignored, no [B, S-1,
    V] copy) against paddle_tpu's (logits sliced to S-1): loss and
    dlogits, with an ignore_index label inside the sequence too."""
    rs = np.random.RandomState(9)
    logits = rs.randn(3, 11, 40).astype(np.float32)
    ids = rs.randint(0, 40, (3, 11)).astype(np.int64)
    ids[1, 4] = -100
    x = paddle.to_tensor(logits, stop_gradient=False)
    want = JaxGPT.loss_fn(x, paddle.to_tensor(ids))
    want.backward()
    t = torch.from_numpy(logits.copy()).requires_grad_()
    got = GPTForCausalLM.loss_fn(t, torch.from_numpy(ids))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want.numpy()), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(x.grad.numpy()),
                               rtol=0, atol=ATOL)


def test_cross_entropy_hard_labels_non_last_axis():
    """Hard labels with the class axis at 1: the port takes each row's
    own label along that axis. paddle_tpu's ``take_along_axis`` with an
    appended label axis broadcasts against the wrong dimension here
    (ROADMAP.md §C), so the reference is log_softmax + gather."""
    rs = np.random.RandomState(10)
    logits = torch.from_numpy(rs.randn(3, 5, 4).astype(np.float32))
    label = torch.from_numpy(rs.randint(0, 5, (3, 4)).astype(np.int64))
    label[1, 2] = -100
    got = TF.cross_entropy(logits, label, axis=1, reduction="none")
    want = -torch.log_softmax(logits, 1).gather(
        1, label.clamp(min=0)[:, None])[:, 0]
    want[1, 2] = 0.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
