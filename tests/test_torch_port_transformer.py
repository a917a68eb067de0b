"""paddle_tpu_torch.nn's transformer layers against paddle_tpu's on the
CPU, in f32 after the weights are copied by ``set_state_dict``.

``MultiHeadAttention`` (no mask, a bool mask in 2-D and 3-D, a float
mask, cross-attention with Sq != Sk, ``StaticCache`` and an incremental
``Cache`` over 3 steps), the encoder and decoder layers with
``normalize_before`` both ways, and ``nn.Transformer(d_model=16, nhead=2,
2 + 2 layers)``: outputs and the gradient of every parameter at atol
1e-5. A state dict written by ``paddle_tpu.save`` loads through
``paddle_tpu_torch.load`` and gives the reference's outputs. Greedy
incremental decoding through ``gen_cache`` gives the tokens of the
cacheless decode with the causal mask, in the port and in paddle_tpu.
``flash_attn_unpadded`` on ragged packed lengths, causal and not: outputs
and gradients at atol 1e-5. On the CPU the port's attention runs B1's
plain version (no mask) or the plain masked branch; paddle_tpu runs its
XLA attention off the TPU.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import nn

jfa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")

ATOL = 1e-5
D_MODEL, NHEAD = 16, 2


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


def _copy(tm, jm):
    """Give the port layer ``tm`` the reference layer ``jm``'s weights."""
    sd = {k: _np(v) for k, v in jm.state_dict().items()}
    assert tm.set_state_dict(sd) == ([], [])


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _hold(tout, jout, tm, jm, rs):
    """Outputs at ATOL; then the gradient of sum(out * g) w.r.t. every
    parameter at ATOL."""
    np.testing.assert_allclose(_np(tout), _np(jout), atol=ATOL)
    g = _rand(rs, *tout.shape)
    (tout * torch.from_numpy(g)).sum().backward()
    (jout * paddle.to_tensor(g)).sum().backward()
    jgrads = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        q = jgrads[n]
        if p.grad is None:
            assert q.grad is None or not _np(q.grad).any(), n
            continue
        np.testing.assert_allclose(_np(p.grad), _np(q.grad), atol=ATOL,
                                   err_msg=n)


def _mha_pair(seed=0, **kw):
    jm = jnn.MultiHeadAttention(D_MODEL, NHEAD, **kw)
    tm = nn.MultiHeadAttention(D_MODEL, NHEAD, **kw)
    _copy(tm, jm)
    return tm, jm, np.random.RandomState(seed)


@pytest.mark.parametrize("case", ["none", "bool", "bool3d", "float",
                                  "cross", "static"])
def test_multi_head_attention(case):
    tm, jm, rs = _mha_pair()
    x = _rand(rs, 2, 5, D_MODEL)
    kv = _rand(rs, 2, 7, D_MODEL)
    mask = None
    if case == "bool":
        mask = rs.rand(5, 5) > 0.4
        np.fill_diagonal(mask, True)
    elif case == "bool3d":
        mask = rs.rand(2, 5, 5) > 0.4
        mask[:, np.arange(5), np.arange(5)] = True
    elif case == "float":
        mask = _rand(rs, 2, NHEAD, 5, 5)
    tmask = None if mask is None else torch.from_numpy(mask)
    jmask = None if mask is None else paddle.to_tensor(mask)
    tx, jx = torch.from_numpy(x), paddle.to_tensor(x)
    if case == "cross":
        tkv, jkv = torch.from_numpy(kv), paddle.to_tensor(kv)
        tout, jout = tm(tx, tkv, tkv), jm(jx, jkv, jkv)
    elif case == "static":
        tkv, jkv = torch.from_numpy(kv), paddle.to_tensor(kv)
        tc = tm.gen_cache(tkv, tkv, type=tm.StaticCache)
        jc = jm.gen_cache(jkv, jkv, type=jm.StaticCache)
        (tout, tc2), (jout, jc2) = tm(tx, cache=tc), jm(jx, cache=jc)
        assert isinstance(tc2, nn.MultiHeadAttention.StaticCache)
        np.testing.assert_allclose(_np(tc2.k), _np(jc2.k), atol=ATOL)
    else:
        tout, jout = tm(tx, attn_mask=tmask), jm(jx, attn_mask=jmask)
    _hold(tout, jout, tm, jm, rs)


def test_multi_head_attention_incremental_cache():
    tm, jm, rs = _mha_pair(1)
    x = _rand(rs, 2, 3, D_MODEL)
    tc = tm.gen_cache(torch.from_numpy(x), type=tm.Cache)
    jc = jm.gen_cache(paddle.to_tensor(x), type=jm.Cache)
    assert tuple(tc.k.shape) == (2, 0, NHEAD, D_MODEL // NHEAD)
    touts, jouts = [], []
    for i in range(3):
        tout, tc = tm(torch.from_numpy(x[:, i:i + 1]), cache=tc)
        jout, jc = jm(paddle.to_tensor(x[:, i:i + 1]), cache=jc)
        touts.append(tout)
        jouts.append(jout)
        np.testing.assert_allclose(_np(tout), _np(jout), atol=ATOL)
    np.testing.assert_allclose(_np(tc.k), _np(jc.k), atol=ATOL)
    np.testing.assert_allclose(_np(tc.v), _np(jc.v), atol=ATOL)
    # the cached steps equal one causal pass over the 3 positions
    full = tm(torch.from_numpy(x), attn_mask=nn.Transformer.
              generate_square_subsequent_mask(3))
    np.testing.assert_allclose(_np(torch.cat(touts, 1)), _np(full),
                               atol=ATOL)
    _hold(torch.cat(touts, 1), paddle.concat(jouts, axis=1), tm, jm, rs)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_encoder_and_decoder_layers(kind, normalize_before):
    rs = np.random.RandomState(2)
    kw = dict(d_model=D_MODEL, nhead=NHEAD, dim_feedforward=32, dropout=0.0,
              activation="gelu", normalize_before=normalize_before)
    cls = "TransformerEncoderLayer" if kind == "encoder" else \
        "TransformerDecoderLayer"
    jm, tm = getattr(jnn, cls)(**kw), getattr(nn, cls)(**kw)
    _copy(tm, jm)
    src, tgt = _rand(rs, 2, 5, D_MODEL), _rand(rs, 2, 4, D_MODEL)
    if kind == "encoder":
        tout = tm(torch.from_numpy(src))
        jout = jm(paddle.to_tensor(src))
    else:
        mask = np.tril(np.ones((4, 4), bool))
        tout = tm(torch.from_numpy(tgt), torch.from_numpy(src),
                  torch.from_numpy(mask))
        jout = jm(paddle.to_tensor(tgt), paddle.to_tensor(src),
                  paddle.to_tensor(mask))
    _hold(tout, jout, tm, jm, rs)


def _transformer_pair(**kw):
    kw = dict(d_model=D_MODEL, nhead=NHEAD, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=32, dropout=0.0, **kw)
    jm, tm = jnn.Transformer(**kw), nn.Transformer(**kw)
    _copy(tm, jm)
    return tm, jm


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_outputs_and_grads(normalize_before):
    tm, jm = _transformer_pair(normalize_before=normalize_before)
    rs = np.random.RandomState(3)
    src, tgt = _rand(rs, 2, 6, D_MODEL), _rand(rs, 2, 5, D_MODEL)
    tmask = nn.Transformer.generate_square_subsequent_mask(5)
    jmask = jnn.Transformer.generate_square_subsequent_mask(5)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask.numpy()))
    tout = tm(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=tmask)
    jout = jm(paddle.to_tensor(src), paddle.to_tensor(tgt), tgt_mask=jmask)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    _hold(tout, jout, tm, jm, rs)


def test_reference_saved_transformer_loads_in_the_port(tmp_path):
    jm = jnn.Transformer(D_MODEL, NHEAD, 2, 2, 32, dropout=0.0)
    path = str(tmp_path / "transformer.pdparams")
    paddle.save(jm.state_dict(), path)
    tm = nn.Transformer(D_MODEL, NHEAD, 2, 2, 32, dropout=0.0)
    assert tm.set_state_dict(tpkg.load(path)) == ([], [])
    rs = np.random.RandomState(4)
    src, tgt = _rand(rs, 2, 6, D_MODEL), _rand(rs, 2, 5, D_MODEL)
    np.testing.assert_allclose(
        _np(tm(torch.from_numpy(src), torch.from_numpy(tgt))),
        _np(jm(paddle.to_tensor(src), paddle.to_tensor(tgt))), atol=ATOL)


V, BOS, STEPS = 11, 1, 6


def _seq2seq(pk):
    """Embedding -> Transformer -> Linear in the ``nn`` module ``pk``,
    the shape of user code."""
    class Seq2Seq(pk.Layer):
        def __init__(self):
            super().__init__()
            self.emb = pk.Embedding(V, D_MODEL)
            self.tr = pk.Transformer(D_MODEL, NHEAD, 2, 2, 32, dropout=0.0)
            self.out = pk.Linear(D_MODEL, V)
    return Seq2Seq()


def _greedy_cached(m, memory, B):
    ys = torch.full((B, 1), BOS, dtype=torch.int64)
    cache = m.tr.decoder.gen_cache(memory)
    assert isinstance(cache[0][0], nn.MultiHeadAttention.Cache)
    assert isinstance(cache[0][1], nn.MultiHeadAttention.StaticCache)
    toks = []
    for _ in range(STEPS):
        h, cache = m.tr.decoder(m.emb(ys[:, -1:]), memory, cache=cache)
        nxt = m.out(h[:, -1]).argmax(-1)
        toks.append(nxt)
        ys = torch.cat([ys, nxt[:, None]], 1)
    return torch.stack(toks, 1)


def _greedy_full(m, memory, B):
    ys = torch.full((B, 1), BOS, dtype=torch.int64)
    for _ in range(STEPS):
        mask = nn.Transformer.generate_square_subsequent_mask(ys.shape[1])
        h = m.tr.decoder(m.emb(ys), memory, mask)
        ys = torch.cat([ys, m.out(h[:, -1]).argmax(-1)[:, None]], 1)
    return ys[:, 1:]


def test_greedy_incremental_decoding_equals_cacheless():
    jm, tm = _seq2seq(jnn), _seq2seq(nn)
    jm.eval()
    tm.eval()
    _copy(tm, jm)
    src = np.random.RandomState(5).randint(0, V, (3, 7))
    B = src.shape[0]
    with torch.no_grad():
        memory = tm.tr.encoder(tm.emb(torch.from_numpy(src)))
        cached = _greedy_cached(tm, memory, B)
        plain = _greedy_full(tm, memory, B)
    np.testing.assert_array_equal(cached.numpy(), plain.numpy())
    # paddle_tpu's cacheless decoder, teacher-forced on those tokens in one
    # causal pass, picks the same token at every step
    ys = np.concatenate([np.full((B, 1), BOS), cached.numpy()], 1)[:, :-1]
    jmem = jm.tr.encoder(jm.emb(paddle.to_tensor(src)))
    h = jm.tr.decoder(jm.emb(paddle.to_tensor(ys)), jmem,
                      jnn.Transformer.generate_square_subsequent_mask(STEPS))
    np.testing.assert_array_equal(
        np.asarray(paddle.argmax(jm.out(h), axis=-1).numpy()),
        cached.numpy())


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_unpadded_matches_reference(causal):
    rs = np.random.RandomState(6)
    lq = [3, 7, 1, 5]
    lk = lq if causal else [4, 2, 6, 3]
    H, D = 2, 8
    cq = np.concatenate([[0], np.cumsum(lq)]).astype(np.int32)
    ck = np.concatenate([[0], np.cumsum(lk)]).astype(np.int32)
    q, k, v = (_rand(rs, n, H, D) for n in (cq[-1], ck[-1], ck[-1]))
    g = _rand(rs, cq[-1], H, D)
    scale = D ** -0.5
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout, none = tfa.flash_attn_unpadded(
        tq, tk, tv, torch.from_numpy(cq), torch.from_numpy(ck), max(lq),
        max(lk), scale, causal=causal)
    assert none is None
    jq, jk, jv = (paddle.to_tensor(a, stop_gradient=False)
                  for a in (q, k, v))
    jout, _ = jfa.flash_attn_unpadded(
        jq, jk, jv, paddle.to_tensor(cq), paddle.to_tensor(ck), max(lq),
        max(lk), scale, causal=causal)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=ATOL)
    (tout * torch.from_numpy(g)).sum().backward()
    (jout * paddle.to_tensor(g)).sum().backward()
    for a, b, n in ((tq, jq, "dq"), (tk, jk, "dk"), (tv, jv, "dv")):
        np.testing.assert_allclose(_np(a.grad), _np(b.grad), atol=ATOL,
                                   err_msg=n)
    # and each sequence alone through scaled_dot_product_attention
    for i in range(len(lq)):
        qs = tq[cq[i]:cq[i + 1]][None]
        ks, vs = tk[ck[i]:ck[i + 1]][None], tv[ck[i]:ck[i + 1]][None]
        alone = tfa.scaled_dot_product_attention(qs, ks, vs,
                                                 is_causal=causal)
        np.testing.assert_allclose(_np(tout[cq[i]:cq[i + 1]]), _np(alone[0]),
                                   atol=ATOL)


def test_sdp_kernel_is_a_no_op():
    with tfa.sdp_kernel(enable_flash=True, enable_math=False) as ctx:
        assert isinstance(ctx, tfa.sdp_kernel)
