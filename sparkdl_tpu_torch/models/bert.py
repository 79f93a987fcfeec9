"""BERT-base encoder and the GLUE sequence classifier — BASELINE
configuration 4 ("BERT-base fine-tune on GLUE with Spark DataFrame
reader").

The counterpart of ``sparkdl_tpu/models/bert.py``: config, self-attention
with its three dispatch branches, layer, encoder, classifier,
:func:`glue_loss_fn` and :func:`bert_finetune_loss`, plus
:func:`load_flax_params`, which fills a model from the JAX package's
parameter tree. Module and parameter names follow the flax modules
(``query``, ``key``, ``value``, ``attention_output``, ``intermediate``,
``output_dense``, ``*_norm``, ``pooler``, ``classifier``).

The dtype flow is the reference's, step for step (a bf16 residual stream
would be another model):

- every parameter is stored in f32 and cast at use to the compute dtype,
  as flax's ``Dense(dtype=...)`` and ``Embed(dtype=...)`` do; an optimizer
  updates the f32 weights;
- the embeddings are summed in the compute dtype, normalised in f32 and
  only then cast to it; every LayerNorm computes in f32 (eps 1e-12) and
  returns f32, so the residual stream is f32 after the first layer;
- GELU is exact (``erf``), the pooler computes in the compute dtype with
  ``tanh``, the classifier in f32.

Attention (:class:`BertSelfAttention`) dispatches as the reference does:
a maskless ``attn_fn`` call when no padding was declared, ``kv_mask`` when
a mask was given (an ``attn_fn`` that takes none raises ``TypeError``),
and dense f32-softmax attention with the additive ``-1e30`` bias
otherwise. Only the dense branch drops attention probabilities: the flash
kernels carry no dropout. ``"auto"`` resolves through
``ops.flash_attention.resolve_attn_fn``: the kernels on a card (a CUDA
input they do not take raises), dense attention on the CPU. BERT pads on
the right, and its positions are ``arange(S)`` whatever the padding.

Dropout draws from an explicit ``torch.Generator`` (``generator=``):
``torch.rand(...) < 1 - rate`` keeps an element and scales it by
``1 / (1 - rate)``, as flax's ``Dropout`` does; the bits differ from
JAX's. In a gang's implicit step the generator is a
``utils.rng.RowWindow``, which draws this rank's rows of the global
batch's masks. ``deterministic=True`` (the default) is the identity.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import resolve_attn_fn
from ..utils.platform import resolve_device
from ..utils.rng import uniform


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.1

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        """For tests: 2 layers, 128-wide."""
        return cls(vocab_size=1000, hidden_size=128, num_layers=2,
                   num_heads=4, intermediate_size=256,
                   max_position_embeddings=128)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def dropout(x, rate: float, generator):
    """flax ``Dropout``: keep each element with probability ``1 - rate``
    (``torch.rand < 1 - rate`` from ``generator``) and scale the kept ones
    by ``1 / (1 - rate)``. ``generator`` None is the identity; a
    ``utils.rng.RowWindow`` (a gang's step) draws this rank's rows of the
    global batch's mask."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if keep_prob <= 0.0:
        return torch.zeros_like(x)
    keep = uniform(x.shape, generator, x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class Dense(nn.Module):
    """flax ``Dense(dtype=...)``: f32 ``weight [out, in]`` and ``bias``,
    input, weight and bias cast to ``dtype`` at use."""

    def __init__(self, in_features: int, features: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_features), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        d = self.dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class LayerNorm(nn.Module):
    """flax ``LayerNorm(dtype=float32)``: f32 statistics, f32 ``scale``
    and ``bias``, f32 out."""

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, self.eps)


def _accepts_kv_mask(fn) -> bool:
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return True
    return "kv_mask" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, device):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        h = cfg.hidden_size
        self.query = Dense(h, h, dtype, device)
        self.key = Dense(h, h, dtype, device)
        self.value = Dense(h, h, dtype, device)
        self.attention_output = Dense(h, h, dtype, device)

    def forward(self, x, attn_fn, bias=None, mask=None, generator=None):
        c = self.cfg
        b, s, _ = x.shape

        def heads(t):  # [B, S, H*D] → [B, H, S, D], contiguous for a kernel
            return t.view(b, s, c.num_heads, c.head_dim).transpose(
                1, 2).contiguous()

        q, k, v = (heads(lin(x)) for lin in (self.query, self.key,
                                              self.value))
        attn_fn = resolve_attn_fn(attn_fn)
        # attn_fn runs only when the padding state is expressible to it:
        # an explicit [B, S] mask (→ kv_mask), or no padding at all (bias
        # None too); a caller with only an additive bias keeps the dense
        # path, so the bias is never dropped
        if attn_fn is not None and mask is None and bias is None:
            o = attn_fn(q, k, v, causal=False)
        elif attn_fn is not None and mask is not None:
            if not _accepts_kv_mask(attn_fn):
                raise TypeError(
                    f"BertSelfAttention.attn_fn {attn_fn} does not accept "
                    f"kv_mask — padded encoder batches need a mask-capable "
                    f"attention (e.g. ops.flash_attention.flash_attention); "
                    f"for unpadded batches call without an attention_mask")
            o = attn_fn(q, k, v, causal=False, kv_mask=mask)
        else:
            scores = (q @ k.transpose(-1, -2)) / math.sqrt(c.head_dim)
            scores = scores.float()
            if bias is not None:
                scores = scores + bias  # the mask as an additive bias
            p = torch.softmax(scores, dim=-1).to(self.dtype)
            p = dropout(p, c.dropout_rate, generator)
            o = p @ v
        o = o.transpose(1, 2).reshape(b, s, c.hidden_size)
        return self.attention_output(o)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg, dtype, device)
        self.attention_norm = LayerNorm(h, eps, device)
        self.intermediate = Dense(h, cfg.intermediate_size, dtype, device)
        self.output_dense = Dense(cfg.intermediate_size, h, dtype, device)
        self.output_norm = LayerNorm(h, eps, device)

    def forward(self, x, attn_fn, bias=None, mask=None, generator=None):
        rate = self.cfg.dropout_rate
        a = self.attention(x, attn_fn, bias, mask, generator)
        a = dropout(a, rate, generator)
        x = self.attention_norm(x + a)
        h = F.gelu(self.intermediate(x), approximate="none")
        h = dropout(self.output_dense(h), rate, generator)
        return self.output_norm(x + h)


class BertEncoder(nn.Module):
    """Token ids (+ mask, + segments) → ``(sequence_output, pooled)``.

    ``attn_fn``: ``"auto"`` (default; the kernels on a card, dense on the
    CPU), a callable ``(q, k, v, causal=..., kv_mask=...)``, or None for
    dense attention. ``device``: None means ``cuda`` and raises without
    one — pass ``device="cpu"`` for the CPU. ``dtype`` is the compute
    dtype; parameters are f32. Weights are drawn from ``generator`` (on
    ``device``; default seed 0) as BERT initializes them (its
    ``initializer_range``, 0.02): Dense weights and embeddings N(0,
    0.02²), biases 0, norm scales 1."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32,
                 attn_fn="auto", device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dtype, self.attn_fn = cfg, dtype, attn_fn
        h = cfg.hidden_size

        def table(n):
            return nn.Parameter(torch.empty((n, h), dtype=torch.float32,
                                            device=device))

        self.word_embeddings = table(cfg.vocab_size)
        self.position_embeddings = table(cfg.max_position_embeddings)
        self.token_type_embeddings = table(cfg.type_vocab_size)
        self.embeddings_norm = LayerNorm(h, cfg.layer_norm_eps, device)
        self.layers = nn.ModuleList(BertLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.pooler = Dense(h, h, dtype, device)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.device

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        _reset(self, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True, generator=None):
        """``input_ids`` ``[B, S]`` → ``(x [B, S, hidden] f32, pooled
        [B, hidden] in the compute dtype)``. ``attention_mask`` ``[B, S]``
        (1 = token, 0 = pad); None declares no padding, which lets a
        maskless ``attn_fn`` run. ``deterministic=False`` applies dropout
        drawn from ``generator``."""
        c, d = self.cfg, self.dtype
        g = _dropout_generator(deterministic, generator)
        s = input_ids.shape[1]
        emb = F.embedding(input_ids, self.word_embeddings).to(d)
        pos = self.position_embeddings[:s].to(d)[None]
        if token_type_ids is None:
            # every position is type 0: its row, broadcast (the same values
            # as a lookup of zeros, and a backward that sums in a fixed
            # order, where the card's embedding backward sums the B·S
            # duplicate ids in none)
            seg = self.token_type_embeddings[0].to(d)
        else:
            seg = F.embedding(token_type_ids,
                              self.token_type_embeddings).to(d)
        x = self.embeddings_norm(emb + pos + seg)
        x = dropout(x, c.dropout_rate, g).to(d)
        # [B, S] mask → additive bias [B, 1, 1, S]; None when no mask was
        # given, so the layers know there is no padding
        bias = None if attention_mask is None else (
            (1.0 - attention_mask[:, None, None, :].float()) * -1e30)
        for layer in self.layers:
            x = layer(x, self.attn_fn, bias, attention_mask, g)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForSequenceClassification(nn.Module):
    """The GLUE head: encoder + dropout + an f32 linear classifier over
    the pooled ``[CLS]`` → logits ``[B, num_classes]`` f32. The encoder
    sits at ``.bert``; ``attn_fn`` reads and sets its policy."""

    def __init__(self, cfg: BertConfig, num_classes: int = 2,
                 dtype=torch.float32, attn_fn="auto", device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.num_classes, self.dtype = cfg, num_classes, dtype
        self.bert = BertEncoder(cfg, dtype, attn_fn, device, generator)
        self.classifier = Dense(cfg.hidden_size, num_classes, torch.float32,
                                device)
        with torch.no_grad():
            _reset(self.classifier, generator)

    @property
    def device(self) -> torch.device:
        return self.bert.device

    @property
    def attn_fn(self):
        return self.bert.attn_fn

    @attn_fn.setter
    def attn_fn(self, fn) -> None:
        self.bert.attn_fn = fn

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True, generator=None):
        g = _dropout_generator(deterministic, generator)
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                              deterministic, g)
        pooled = dropout(pooled, self.cfg.dropout_rate, g)
        return self.classifier(pooled)


def _dropout_generator(deterministic: bool, generator):
    if deterministic:
        return None
    if generator is None:
        raise ValueError("deterministic=False needs a generator= for the "
                         "dropout masks")
    return generator


INITIALIZER_RANGE = 0.02  # BERT's weight init std


def _reset(module: nn.Module, generator) -> None:
    dev = next(module.parameters()).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    for name, p in module.named_parameters():
        if name.endswith("scale"):
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:  # Dense [out, in], or an embedding table [n, hidden]
            p.copy_(torch.randn(p.shape, generator=generator, device=dev)
                    * INITIALIZER_RANGE)


def _logits(model, batch, generator=None):
    return model(batch["input_ids"], batch.get("attention_mask"),
                 batch.get("token_type_ids"),
                 deterministic=generator is None,
                 generator=generator).float()


def _classification_loss(logits, labels):
    loss = F.cross_entropy(logits, labels.long())
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": acc}


def glue_loss_fn():
    """``loss_fn(model, batch)`` for ``RunnerContext.fit``: batch =
    ``{input_ids, attention_mask, token_type_ids?, label}``, the model run
    deterministic (no dropout); softmax cross-entropy in f32 and
    ``{"accuracy": ...}``. For dropout use :func:`bert_finetune_loss` with
    ``fit(with_rng=True)``."""
    def loss_fn(model, batch):
        return _classification_loss(_logits(model, batch), batch["label"])

    return loss_fn


def bert_finetune_loss(model: BertForSequenceClassification):
    """The dropout-active GLUE loss: ``loss_fn(m, batch, rng=None)`` runs
    ``model`` with dropout drawn from ``rng`` (a ``torch.Generator`` on the
    model's device, or in a gang a ``utils.rng.RowWindow`` over one, which
    a ``with_rng=True`` train step hands it anew each step); ``rng=None``
    runs it deterministic, equal to :func:`glue_loss_fn`. ``model`` is the
    module the step trains (the step's own, ``m``, holds the same
    weights)."""
    def loss_fn(m, batch, rng=None):
        return _classification_loss(_logits(model, batch, rng),
                                    batch["label"])

    return loss_fn


# ---------------------------------------------------------------------------
# Weights carried across from the JAX package
# ---------------------------------------------------------------------------

def _encoder_map(enc: BertEncoder, prefix: tuple):
    out = [(prefix + (name, "embedding"), getattr(enc, name), False)
           for name in ("word_embeddings", "position_embeddings",
                        "token_type_embeddings")]

    def norm(path, mod):
        out.append((path + ("scale",), mod.scale, False))
        out.append((path + ("bias",), mod.bias, False))

    def dense(path, mod):
        out.append((path + ("kernel",), mod.weight, True))
        out.append((path + ("bias",), mod.bias, False))

    norm(prefix + ("embeddings_norm",), enc.embeddings_norm)
    for i, layer in enumerate(enc.layers):
        p = prefix + (f"layer_{i}",)
        for name in ("query", "key", "value", "attention_output"):
            dense(p + ("attention", name), getattr(layer.attention, name))
        for name in ("intermediate", "output_dense"):
            dense(p + (name,), getattr(layer, name))
        norm(p + ("attention_norm",), layer.attention_norm)
        norm(p + ("output_norm",), layer.output_norm)
    dense(prefix + ("pooler",), enc.pooler)
    return out


def _param_map(model):
    """(flax path, torch parameter, transposed) for every weight of a
    :class:`BertEncoder` or :class:`BertForSequenceClassification`: a flax
    Dense ``kernel [in, out]`` is a ``weight [out, in]``."""
    if isinstance(model, BertEncoder):
        return _encoder_map(model, ())
    out = _encoder_map(model.bert, ("bert",))
    out.append((("classifier", "kernel"), model.classifier.weight, True))
    out.append((("classifier", "bias"), model.classifier.bias, False))
    return out


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


@torch.no_grad()
def load_flax_params(model, params):
    """Fill a :class:`BertEncoder` or :class:`BertForSequenceClassification`
    from the JAX package's parameter tree, nested dicts of arrays
    (``bert/layer_0/attention/query/kernel`` ``[in, out]``,
    ``bert/word_embeddings/embedding``, ``*_norm/{scale,bias}``,
    ``classifier/{kernel,bias}``; an encoder's tree has no ``bert`` level);
    a ``{"params": ...}`` wrapper is accepted. Raises on a missing,
    unexpected or mis-shaped leaf. Returns the model."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    leaves = dict(_flatten(params))
    for path, param, transposed in _param_map(model):
        if path not in leaves:
            raise KeyError(f"flax params lack {'/'.join(path)}")
        arr = torch.from_numpy(np.array(leaves.pop(path), np.float32))
        if transposed:
            arr = arr.T
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(arr.shape)} "
                             f"does not fit {tuple(param.shape)}")
        param.copy_(arr)
    if leaves:
        raise ValueError(f"unexpected flax params: "
                         f"{sorted('/'.join(p) for p in leaves)}")
    return model


@torch.no_grad()
def flax_params(model) -> dict:
    """The inverse of :func:`load_flax_params`: the model's weights as the
    JAX package's nested parameter dict of f32 numpy arrays."""
    tree: dict = {}
    for path, param, transposed in _param_map(model):
        t = param.detach().float().cpu()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (t.T if transposed else t).contiguous().numpy()
    return tree
