"""BERT/ERNIE encoder family (port of paddle_tpu/models/bert.py): the
fine-tune heads and the encoder that serving exports (``jit.save``).

Parameter names and layouts match paddle_tpu's, so weights carry across by
name with no transpose (``convert.load_paddle_tpu_params``): the blocks
are ``layer_{i}`` (``bert.layer_0.attn.qkv.weight`` ``[H, 3H]``, laid out
``[q; k; v]``), every Linear weight is ``[in, out]``, and the MLM decoder
is tied to ``embeddings.word_embeddings.weight`` with its own
``decoder_bias``.

Attention is bidirectional. Without a padding mask and without dropout
(evaluation and serving) it runs the B1 flash-attention kernels,
non-causal, as paddle_tpu runs ``_pallas_flash``; with a mask it is the
plain masked attention, and in training with ``dropout > 0`` the plain
attention-dropout branch, both XLA code in paddle_tpu. The ``[B, S]`` 1/0
mask becomes the additive f32 bias ``(m - 1) * 1e30`` of shape ``[B, 1, 1,
S]``, kept in f32 in a bf16 model (rounded to bf16 it would no longer
cancel to exactly -1e30 against f32 logits). The classifier's and the MLM
head's losses run the fused cross-entropy kernels (B2). The GEMMs, the
masked attention, the dropout branch and the MLM decoder's matmul are
plain PyTorch, as they are XLA code there.

``scan_layers`` stacks the encoder layers into one ``ScannedStack``
(``models/scanned.py``; dropout must be 0, as in paddle_tpu). ERNIE is
BERT with a relu FFN (``ernie_3_*``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..nn import Dropout, Embedding, Layer, LayerNorm, Linear, Tanh
from ..nn import functional as F
from .scanned import ScannedStack, stacked_init_kinds

__all__ = ["BertConfig", "BertModel", "BertForSequenceClassification",
           "BertForMaskedLM", "ErnieModel", "bert_tiny", "bert_base",
           "ernie_3_tiny", "ernie_3_base"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    hidden_act: str = "gelu"
    dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    scan_layers: bool = False


def bert_tiny(**kw):
    return BertConfig(vocab_size=512, hidden_size=64, num_layers=2,
                      num_heads=4, intermediate_size=128, max_seq_len=128,
                      dropout=0.0, **kw)


def bert_base(**kw):
    return BertConfig(**kw)


def ernie_3_tiny(**kw):
    kw.setdefault("hidden_act", "relu")
    return bert_tiny(**kw)


def ernie_3_base(**kw):
    # ERNIE-3.0-base: BERT-base geometry, relu FFN
    kw.setdefault("hidden_act", "relu")
    return BertConfig(**kw)


def _materialize(model: nn.Module, cfg: BertConfig, device, seed: int):
    """Allocate ``model``'s parameters (built on the meta device) on
    ``device`` and draw them there with one generator of that device
    seeded by ``seed``, in parameter order: 2-D weights from ``N(0,
    initializer_range)``, LayerNorm weights ones, every other vector (the
    biases, ``decoder_bias``) zeros, as paddle_tpu initialises them (a
    ``ScannedStack``'s leaves by its rule, the same one stacked). CPU
    and CUDA generators draw different numbers: to compare a CPU and a card
    model, copy the weights (``convert.load_paddle_tpu_params``). The
    model is left in eval mode. ``device="meta"`` leaves it unallocated
    (the heads draw their whole tree once)."""
    if device == "meta":
        return
    dev = resolve_device(device)
    model.to_empty(device=dev)
    kinds = stacked_init_kinds(model)
    kinds.update({id(m.weight): "ones" for m in model.modules()
                  if isinstance(m, LayerNorm)})
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    with torch.no_grad():
        for p in model.parameters():
            kind = kinds.get(id(p), "normal" if p.ndim == 2 else "zeros")
            if kind == "normal":
                p.normal_(0.0, cfg.initializer_range, generator=gen)
            elif kind == "ones":
                p.fill_(1.0)
            else:
                p.zero_()
    model.eval()


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = Embedding(cfg.max_seq_len,
                                             cfg.hidden_size)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, ids, token_type_ids=None):
        S = ids.shape[-1]
        n = self.position_embeddings.num_embeddings
        if isinstance(S, int) and S > n:
            raise ValueError(f"sequence length {S} exceeds max_seq_len {n}")
        torch._check(S <= n)            # a symbolic S under torch.export
        pos = torch.arange(S, device=ids.device)
        x = self.word_embeddings(ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(Layer):
    """Bidirectional self-attention with an optional padding mask."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_heads
        if h % nh:
            raise ValueError("hidden_size % num_heads != 0")
        self.num_heads = nh
        self.head_dim = h // nh
        self.qkv = Linear(h, 3 * h)
        self.out_proj = Linear(h, h)
        self.attn_dropout = cfg.dropout
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, attn_mask=None):
        B, S, _ = x.shape
        qkv = self.qkv(x)
        H = qkv.shape[-1] // 3
        shape = (B, S, self.num_heads, self.head_dim)
        q, k, v = (qkv[..., :H].reshape(shape),
                   qkv[..., H:2 * H].reshape(shape),
                   qkv[..., 2 * H:].reshape(shape))
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             dropout_p=self.attn_dropout,
                                             is_causal=False,
                                             training=self.training)
        return self.dropout(self.out_proj(ctx.reshape(B, S, H)))


class BertLayer(Layer):
    """Post-LN transformer encoder block (original BERT arrangement)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.attn = BertSelfAttention(cfg)
        self.ln_1 = LayerNorm(h, epsilon=cfg.layer_norm_eps)
        self.fc_in = Linear(h, cfg.intermediate_size)
        self.fc_out = Linear(cfg.intermediate_size, h)
        self.ln_2 = LayerNorm(h, epsilon=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.dropout)
        self.act = F.relu if cfg.hidden_act == "relu" else F.gelu

    def forward(self, x, attn_mask=None):
        x = self.ln_1(x + self.attn(x, attn_mask))
        y = self.dropout(self.fc_out(self.act(self.fc_in(x))))
        return self.ln_2(x + y)


class BertPooler(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.activation = Tanh()

    def forward(self, x):
        return self.activation(self.dense(x[:, 0]))       # [CLS] token


class BertModel(Layer):
    """Encoder stack + pooler. Returns (sequence_output, pooled_output).

    ``device``: the card when omitted (raises without one); pass
    ``device="cpu"`` for the CPU. The weights are drawn on that device by
    a generator of that device seeded by ``seed`` (``_materialize``); the
    model is built in eval mode."""

    def __init__(self, cfg: BertConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        if cfg.scan_layers:
            # guard before anything is built
            ScannedStack.reject_dropout(cfg.dropout)
        with torch.device("meta"):
            self.embeddings = BertEmbeddings(cfg)
            if cfg.scan_layers:
                self.layers = ScannedStack(lambda: BertLayer(cfg),
                                           cfg.num_layers,
                                           cfg.initializer_range)
            else:
                self.layers = []
                for i in range(cfg.num_layers):
                    layer = BertLayer(cfg)
                    self.add_module(f"layer_{i}", layer)
                    self.layers.append(layer)
            self.pooler = BertPooler(cfg)
        _materialize(self, cfg, device, seed)

    @property
    def device(self) -> torch.device:
        return self.pooler.dense.weight.device

    def forward(self, ids, token_type_ids=None, attention_mask=None):
        mask = None
        if attention_mask is not None:
            # [B, S] 1/0 -> additive f32 [B, 1, 1, S]
            m = attention_mask.to(torch.float32)
            mask = ((m - 1.0) * 1e30).reshape(m.shape[0], 1, 1, m.shape[1])
        x = self.embeddings(ids, token_type_ids)
        if self.cfg.scan_layers:
            x = self.layers(x, mask)
            return x, self.pooler(x)
        for layer in self.layers:
            x = layer(x, mask)
        return x, self.pooler(x)


class ErnieModel(BertModel):
    """ERNIE-3.0-class encoder — same architecture, relu-FFN configs."""


class BertForSequenceClassification(Layer):
    """Fine-tune head (``BASELINE.json`` config 2: ERNIE-3.0/BERT-base
    fine-tune). ``device`` and ``seed`` as ``BertModel``'s, one generator
    drawing the encoder's weights and then the classifier's."""

    def __init__(self, cfg: BertConfig, num_classes: int = 2, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg, device="meta")
        with torch.device("meta"):
            self.dropout = Dropout(cfg.dropout)
            self.classifier = Linear(cfg.hidden_size, num_classes)
        _materialize(self, cfg, device, seed)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def forward(self, ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))

    @staticmethod
    def loss_fn(logits, labels):
        """Mean cross-entropy over the batch (the B2 kernels)."""
        return F.cross_entropy(logits, labels).mean()


class BertForMaskedLM(Layer):
    """MLM head; the decoder is tied to the input word embedding (a plain
    matmul, XLA code in paddle_tpu) with an untied output bias."""

    def __init__(self, cfg: BertConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg, device="meta")
        with torch.device("meta"):
            self.transform = Linear(cfg.hidden_size, cfg.hidden_size)
            self.layer_norm = LayerNorm(cfg.hidden_size,
                                        epsilon=cfg.layer_norm_eps)
            self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        _materialize(self, cfg, device, seed)

    @property
    def device(self) -> torch.device:
        return self.decoder_bias.device

    def forward(self, ids, token_type_ids=None, attention_mask=None):
        x, _ = self.bert(ids, token_type_ids, attention_mask)
        x = self.layer_norm(F.gelu(self.transform(x)))
        w = self.bert.embeddings.word_embeddings.weight
        return torch.matmul(x, w.t()) + self.decoder_bias

    @staticmethod
    def loss_fn(logits, labels, ignore_index: int = -100):
        """MLM loss: the mean over positions whose label is not
        ``ignore_index`` (the B2 kernels over every row)."""
        V = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1),
                               ignore_index=ignore_index).mean()
