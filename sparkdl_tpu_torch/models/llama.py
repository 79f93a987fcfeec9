"""Llama-style decoder-only transformer with LoRA, and KV-cache generation.

The counterpart of ``sparkdl_tpu/models/llama.py:36-1052``: the single-
device, float-weight part — config, RMSNorm, LoRADense, rope, the
attention with its training path and its static-cache decode path, MLP,
layer, model, and ``generate``. The continuous-batching slot and paged
primitives, weight and KV quantization and the tensor-parallel kernel
mesh are not ported yet (ROADMAP.md).

Hazards the port keeps, each from the JAX module:

- :func:`rope` rotates INTERLEAVED pairs (``x[..., 0::2]``,
  ``x[..., 1::2]``; ``llama.py:169-173``), not Hugging Face's half split;
- :class:`RMSNorm` computes in f32 and casts back (``:79-82``);
- ``lm_head`` computes in f32 even when the model dtype is bf16 (``:793``);
- GQA prefill repeats K/V to Hq heads before the flash kernel
  (``:605-606``); decode reads the untiled cache;
- a decode step attends slots ``< cur + 1`` (its own token included) and
  masks each row's left pad (``:627-635``).

Differences of idiom: the model holds its weights (``nn.Module``), so
:func:`generate` takes no ``variables``; :func:`load_flax_params` fills a
model from the JAX package's parameter tree. The KV cache is a
:class:`KVCache` whose tensors are written IN PLACE at the running index
(JAX returned a new cache from every step). Sampling draws from an
explicit ``torch.Generator``; greedy decoding is deterministic and
matches the JAX package token for token.
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

from ..ops import flash_decode as fd
from ..ops.flash_attention import resolve_attn_fn
from ..parallel.ring_attention import NEG_INF
from ..utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    # LoRA: rank 0 disables adapters entirely (no extra params).
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = ("q_proj", "v_proj")

    @classmethod
    def llama3_8b(cls, lora_rank: int = 0) -> "LlamaConfig":
        return cls(lora_rank=lora_rank)

    @classmethod
    def tiny(cls, lora_rank: int = 0) -> "LlamaConfig":
        """For tests: 2 layers, 128-wide, GQA 4:2."""
        return cls(vocab_size=512, hidden_size=128, num_layers=2,
                   num_heads=4, num_kv_heads=2, intermediate_size=256,
                   rope_theta=10000.0, lora_rank=lora_rank)

    @classmethod
    def small(cls, lora_rank: int = 0) -> "LlamaConfig":
        """~1B-class config (TinyLlama-shaped)."""
        return cls(vocab_size=32000, hidden_size=2048, num_layers=16,
                   num_heads=16, num_kv_heads=8, intermediate_size=5632,
                   rope_theta=10000.0, lora_rank=lora_rank)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class RMSNorm(nn.Module):
    """f32 normalisation, cast back to the input's dtype; f32 scale."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (y * self.scale).to(x.dtype)


class LoRADense(nn.Module):
    """Linear with optional LoRA: y = xW + (alpha/r)·(xA)B, no bias."""

    def __init__(self, in_features: int, features: int, rank: int = 0,
                 alpha: float = 16.0, dtype=torch.float32, device=None):
        super().__init__()
        self.rank, self.alpha = rank, alpha
        kw = dict(bias=False, dtype=dtype, device=device)
        self.base = nn.Linear(in_features, features, **kw)
        if rank > 0:
            self.lora_a = nn.Linear(in_features, rank, **kw)
            self.lora_b = nn.Linear(rank, features, **kw)

    def forward(self, x):
        x = x.to(self.base.weight.dtype)
        y = self.base(x)
        if self.rank > 0:
            y = y + (self.alpha / self.rank) * self.lora_b(self.lora_a(x))
        return y


def rope(x, positions, theta: float):
    """Rotary position embedding on interleaved pairs. x: ``[B, H, S, D]``;
    positions: ``[S]`` (shared) or ``[B, S]`` (per row — left-padded
    serving, where row r's first real token sits at a different slot)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions.float()[..., None] * freqs  # [..., S, D/2]
    if angles.dim() == 3:
        angles = angles[:, None]  # [B, 1, S, D/2] broadcasts over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def _prefill_attn_fn(fn, need_mask: bool):
    """The attention to run at prefill: ``fn`` when it can express the
    left-pad mask contract — only an explicit ``kv_mask`` parameter proves
    support (a ``**kwargs`` wrapper would swallow the mask and attend to
    pad tokens) — else None, the dense cache path."""
    if fn is None or not need_mask:
        return fn
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None
    return fn if "kv_mask" in params else None


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        c, hd = cfg, cfg.head_dim

        def proj(name, n_in, n_out):
            return LoRADense(n_in, n_out,
                             rank=c.lora_rank if name in c.lora_targets
                             else 0, alpha=c.lora_alpha, dtype=dtype,
                             device=device)

        self.q_proj = proj("q_proj", c.hidden_size, c.num_heads * hd)
        self.k_proj = proj("k_proj", c.hidden_size, c.num_kv_heads * hd)
        self.v_proj = proj("v_proj", c.hidden_size, c.num_kv_heads * hd)
        self.o_proj = proj("o_proj", c.num_heads * hd, c.hidden_size)

    def forward(self, x, positions, attn_fn, kv=None, cur: int = 0,
                pad_lens=None, first_chunk: bool = False):
        """``kv`` None: the training path (causal self-attention over x).
        ``kv = (k_cache, v_cache)``: the serving path — this call's S
        tokens are written into the caches at slot ``cur`` (in place) and
        attend the cache; ``pad_lens`` ``[B]`` masks each row's left pad
        and counts rope positions from its first real token."""
        c = self.cfg
        B, S, _ = x.shape
        hd, hq, hkv = c.head_dim, c.num_heads, c.num_kv_heads
        rep = hq // hkv
        q = self.q_proj(x).view(B, S, hq, hd).transpose(1, 2)
        k = self.k_proj(x).view(B, S, hkv, hd).transpose(1, 2)
        v = self.v_proj(x).view(B, S, hkv, hd).transpose(1, 2)

        if kv is None:
            q = rope(q, positions, c.rope_theta)
            k = rope(k, positions, c.rope_theta)
            if rep != 1:
                k = k.repeat_interleave(rep, dim=1)
                v = v.repeat_interleave(rep, dim=1)
            if attn_fn is not None:
                o = attn_fn(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True)
            else:
                s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
                mask = torch.ones((S, S), dtype=torch.bool,
                                  device=x.device).tril()
                s = torch.where(mask, s.float(), NEG_INF)
                p = torch.softmax(s, dim=-1).to(q.dtype)
                o = torch.einsum("bhqk,bhkd->bhqd", p, v)
        else:
            o = self._cached(q, k, v, kv, attn_fn, cur, pad_lens,
                             first_chunk)
        o = o.transpose(1, 2).reshape(B, S, hq * hd)
        return self.o_proj(o)

    def _cached(self, q, k, v, kv, attn_fn, cur, pad_lens, first_chunk):
        c = self.cfg
        B, hq, S, hd = q.shape
        hkv = c.num_kv_heads
        rep = hq // hkv
        k_cache, v_cache = kv
        max_len = k_cache.shape[2]
        if cur + S > max_len:
            raise ValueError(f"cache overflow: writing {S} tokens at slot "
                             f"{cur} of a {max_len}-slot cache")
        if first_chunk and cur != 0:
            raise ValueError(f"first_chunk writes at cache slot 0, but the "
                             f"cache is filled to {cur}")
        steps = cur + torch.arange(S, device=q.device)
        if pad_lens is None:
            pos = steps  # [S], shared across rows
        else:
            pos = (steps[None, :] - pad_lens[:, None]).clamp_min(0)  # [B, S]
        q = rope(q, pos, c.rope_theta)
        k = rope(k, pos, c.rope_theta)
        # In place: the step's K/V land in the caller's cache tensors.
        k_cache[:, :, cur:cur + S] = k
        v_cache[:, :, cur:cur + S] = v

        # Prefill through attn_fn over the square S-slice: only at cache
        # slot 0 (first_chunk, which _prefill passes), where every slot past
        # S is causally dead, so causal + a pad kv_mask equals the masked
        # dense-vs-cache compute. A later chunk must attend earlier cache
        # too and takes the dense path.
        fn = (_prefill_attn_fn(attn_fn, pad_lens is not None)
              if S > 1 and first_chunk else None)
        if fn is not None:
            kf = k.repeat_interleave(rep, dim=1) if rep != 1 else k
            vf = v.repeat_interleave(rep, dim=1) if rep != 1 else v
            args = (q.contiguous(), kf.contiguous(), vf.contiguous())
            if pad_lens is None:
                return fn(*args, causal=True)
            kv_mask = (torch.arange(S, device=q.device)[None, :]
                       >= pad_lens[:, None]).float()
            return fn(*args, causal=True, kv_mask=kv_mask)
        if S == 1:
            dec = fd.decode_fn_for(attn_fn)
            if dec is not None:
                # slots < cur+1 are live (the step's own token attends to
                # itself); left-pad slots masked per row. Inputs the kernel
                # does not take raise there: no dense stand-in.
                return dec(q, k_cache, v_cache, cur + 1, pad_lens)
        # Grouped-query attention against the untiled cache: the GQA
        # tiling folds into the einsum's group axis instead of repeating
        # the whole cache every step.
        qg = q.reshape(B, hkv, rep, S, hd)
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k_cache) / math.sqrt(hd)
        col = torch.arange(max_len, device=q.device)[None, :]
        valid = col <= steps[:, None]  # [S, max_len] causal-vs-cache
        if pad_lens is not None:
            # [B, S, max_len]: also exclude each row's pad slots
            valid = valid[None] & (col[None] >= pad_lens[:, None, None])
            valid = valid[:, None, None]  # [B, 1, 1, S, max_len]
        s = torch.where(valid, s.float(), NEG_INF)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bgrqk,bgkd->bgrqd", p, v_cache).reshape(
            B, hq, S, hd)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.float32, device=None):
        super().__init__()
        c = cfg

        def proj(name, n_in, n_out):
            return LoRADense(n_in, n_out,
                             rank=c.lora_rank if name in c.lora_targets
                             else 0, alpha=c.lora_alpha, dtype=dtype,
                             device=device)

        self.gate_proj = proj("gate_proj", c.hidden_size, c.intermediate_size)
        self.up_proj = proj("up_proj", c.hidden_size, c.intermediate_size)
        self.down_proj = proj("down_proj", c.intermediate_size, c.hidden_size)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.attn = LlamaAttention(cfg, dtype, device)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.mlp = LlamaMLP(cfg, dtype, device)

    def forward(self, x, positions, attn_fn, kv=None, cur: int = 0,
                pad_lens=None, first_chunk: bool = False):
        x = x + self.attn(self.attn_norm(x), positions, attn_fn, kv, cur,
                          pad_lens, first_chunk)
        return x + self.mlp(self.mlp_norm(x))


@dataclasses.dataclass
class KVCache:
    """Per-layer K/V tensors ``[B, Hkv, max_len, head_dim]`` and the
    running fill index, a host int (``idx``). Written in place."""
    k: list
    v: list
    idx: int = 0


class LlamaModel(nn.Module):
    """Token ids ``[B, S]`` → logits ``[B, S, vocab]`` (f32).

    ``attn_fn``: ``"auto"`` (default) resolves to the flash kernel policy
    when a CUDA device exists and to in-model dense attention elsewhere
    (``ops.flash_attention.resolve_attn_fn``); or pass a callable
    ``(q, k, v, causal=..., kv_mask=...)`` or None. ``device``: None means
    ``cuda`` and raises without one — pass ``device="cpu"`` for the CPU.
    Weights are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; default seed 0): projections N(0, 1/fan_in), embeddings
    N(0, 1/hidden), LoRA A N(0, 0.02²) and B zero, norm scales one."""

    def __init__(self, cfg: LlamaConfig, dtype=torch.float32,
                 attn_fn="auto", device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dtype, self.attn_fn = cfg, dtype, attn_fn
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 dtype=torch.float32, device=device)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)

        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * std)

        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("lora_b.weight"):
                p.zero_()
            elif name.endswith("lora_a.weight"):
                normal(p, 0.02)
            else:  # Linear [out, in] or embedding [vocab, hidden]
                normal(p, 1.0 / math.sqrt(p.shape[1]))

    def forward(self, input_ids, cache: KVCache | None = None, pad_lens=None,
                first_chunk: bool = False, last_only: bool = False):
        """``cache`` None: the training forward. With a :class:`KVCache`:
        the serving forward — writes at ``cache.idx`` and advances it.
        ``first_chunk`` (serving, True only when writing at slot 0 —
        :func:`_prefill` passes it) enables the square flash prefill.
        ``last_only``: logits of the last position only, ``[B, 1, V]``."""
        if pad_lens is not None and cache is None:
            raise ValueError(
                "pad_lens is a KV-cache serving feature; the training path "
                "has no left-pad masking — feed right-padded batches with a "
                "loss mask instead")
        S = input_ids.shape[1]
        positions = torch.arange(S, device=input_ids.device)
        attn_fn = resolve_attn_fn(self.attn_fn)
        cur = 0 if cache is None else cache.idx
        x = self.embed_tokens(input_ids)
        for i, layer in enumerate(self.layers):
            kv = None if cache is None else (cache.k[i], cache.v[i])
            x = layer(x, positions, attn_fn, kv, cur, pad_lens, first_chunk)
        if cache is not None:
            cache.idx = cur + S
        if last_only:
            x = x[:, -1:]
        return self.lm_head(self.final_norm(x).float())


# ---------------------------------------------------------------------------
# Weights carried across from the JAX package
# ---------------------------------------------------------------------------

def _param_map(model: LlamaModel):
    """(flax path, torch parameter, transposed) for every weight: a flax
    Dense kernel ``[in, out]`` is a ``Linear.weight`` ``[out, in]``."""
    out = [(("embed_tokens", "embedding"), model.embed_tokens.weight, False)]

    def dense(prefix, mod):
        out.append((prefix + ("base", "kernel"), mod.base.weight, True))
        if mod.rank > 0:
            out.append((prefix + ("lora_a", "kernel"), mod.lora_a.weight,
                        True))
            out.append((prefix + ("lora_b", "kernel"), mod.lora_b.weight,
                        True))

    for i, layer in enumerate(model.layers):
        p = (f"layer_{i}",)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            dense(p + ("attn", name), getattr(layer.attn, name))
        for name in ("gate_proj", "up_proj", "down_proj"):
            dense(p + ("mlp", name), getattr(layer.mlp, name))
        out.append((p + ("attn_norm", "scale"), layer.attn_norm.scale, False))
        out.append((p + ("mlp_norm", "scale"), layer.mlp_norm.scale, False))
    out.append((("final_norm", "scale"), model.final_norm.scale, False))
    out.append((("lm_head", "kernel"), model.lm_head.weight, True))
    return out


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


@torch.no_grad()
def load_flax_params(model: LlamaModel, params) -> LlamaModel:
    """Fill ``model`` from the JAX package's Llama parameter tree, given as
    nested dicts of numpy arrays (``params['layer_0']['attn']['q_proj']
    ['base']['kernel']`` ``[in, out]``, ``embed_tokens/embedding``,
    ``*_norm/scale``, ``lm_head/kernel``, optional ``lora_a``/``lora_b``);
    a ``{"params": ...}`` wrapper is accepted. Raises on a missing,
    unexpected or mis-shaped leaf. Returns the model."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    leaves = dict(_flatten(params))
    for path, param, transposed in _param_map(model):
        if path not in leaves:
            raise KeyError(f"flax params lack {'/'.join(path)}")
        arr = torch.from_numpy(np.array(leaves.pop(path)))
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
def flax_params(model: LlamaModel) -> dict:
    """The inverse of :func:`load_flax_params`: the model's weights as the
    JAX package's nested parameter dict of numpy arrays."""
    tree: dict = {}
    for path, param, transposed in _param_map(model):
        t = param.detach().cpu()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (t.T if transposed else t).contiguous().numpy()
    return tree


# ---------------------------------------------------------------------------
# Generation (KV-cache serving)
# ---------------------------------------------------------------------------

def init_cache(model: LlamaModel, batch_size: int, max_len: int) -> KVCache:
    """Zeroed KV cache, ``[batch, kv_heads, max_len, head_dim]`` per layer,
    in the model's dtype on the model's device."""
    c = model.cfg
    shape = (batch_size, c.num_kv_heads, max_len, c.head_dim)

    def zeros():
        return torch.zeros(shape, dtype=model.dtype, device=model.device)

    return KVCache([zeros() for _ in range(c.num_layers)],
                   [zeros() for _ in range(c.num_layers)])


def _sample(logits, generator, temperature: float, top_k: int = 0,
            top_p: float = 1.0):
    """Greedy (temperature <= 0) or temperature sampling with optional
    top-k / nucleus (top-p) truncation, one sort serving both filters."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k > 0 or top_p < 1.0:
        sl = torch.sort(logits, dim=-1, descending=True).values
        if top_k > 0:
            ranks = torch.arange(sl.shape[-1], device=sl.device)
            sl = torch.where(ranks < top_k, sl, -torch.inf)
        if top_p < 1.0:
            probs = torch.softmax(sl, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            # keep the smallest prefix with cumulative prob >= top_p
            # (rank 0 always kept: cum - probs is 0 there)
            sl = torch.where(cum - probs < top_p, sl, -torch.inf)
        # cutoff = smallest surviving logit; ties at the cutoff stay in
        cutoff = torch.where(torch.isfinite(sl), sl, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


@torch.no_grad()
def _prefill(model: LlamaModel, prompt_ids, cache: KVCache, pad_lens=None):
    """The whole prompt in one cache write at slot 0 → last-position
    logits ``[B, V]`` f32. With left-padded prompts (``pad_lens``) the
    newest real token of every row is the last position."""
    logits = model(prompt_ids, cache=cache, pad_lens=pad_lens,
                   first_chunk=True, last_only=True)
    return logits[:, -1]


@torch.no_grad()
def _decode_step(model: LlamaModel, cache: KVCache, tok, pad_lens=None):
    """One token per row at ``cache.idx`` → its logits ``[B, V]`` f32."""
    return model(tok[:, None], cache=cache, pad_lens=pad_lens)[:, -1]


def _decode(model, cache, last_logits, generator, pad_lens=None, *,
            max_new_tokens: int, temperature: float, top_k: int = 0,
            top_p: float = 1.0, eos_id: int | None = None):
    """One token per step → ``(tokens [B, max_new_tokens], n_steps)``.

    Each step emits the token already sampled and runs the model on it to
    sample the next, as the JAX loop does, so ``n_steps`` model steps run.
    Without ``eos_id`` that is exactly ``max_new_tokens``. With it the loop
    stops as soon as every row has emitted eos (one host sync a step);
    unwritten slots hold eos_id."""
    def step(tok):
        return _sample(_decode_step(model, cache, tok, pad_lens), generator,
                       temperature, top_k, top_p)

    tok = _sample(last_logits, generator, temperature, top_k, top_p)
    if eos_id is None:
        out = []
        for _ in range(max_new_tokens):
            out.append(tok)
            tok = step(tok)
        if not out:
            return tok.new_empty((tok.shape[0], 0)), 0
        return torch.stack(out, dim=1), max_new_tokens
    out = torch.full((tok.shape[0], max_new_tokens), eos_id,
                     dtype=tok.dtype, device=tok.device)
    done = tok == eos_id
    i = 0
    while i < max_new_tokens and not bool(done.all()):
        out[:, i] = tok
        nxt = torch.where(done, eos_id, step(tok))
        done = done | (nxt == eos_id)
        tok = nxt
        i += 1
    return out, i


def left_pad_prompts(prompts, pad_id: int = 0, pad_to: int | None = None):
    """Variable-length prompt lists → ``(ids [B, Lmax] int64, pad_lens [B]
    int32)``, left-padded: every row's newest token is the last position,
    so one prefill and one decode loop serve mixed lengths. ``pad_to``
    pins Lmax."""
    lens = [len(p) for p in prompts]
    if min(lens, default=0) < 1:
        raise ValueError("every prompt needs at least one token id")
    lmax = max(lens)
    if pad_to is not None:
        if pad_to < lmax:
            raise ValueError(f"pad_to={pad_to} < longest prompt {lmax}")
        lmax = pad_to
    ids = torch.full((len(prompts), lmax), pad_id, dtype=torch.int64)
    for r, p in enumerate(prompts):
        ids[r, lmax - len(p):] = torch.as_tensor(p, dtype=torch.int64)
    return ids, torch.tensor([lmax - n for n in lens], dtype=torch.int32)


def _tensor(x, dtype, device) -> torch.Tensor:
    """A tensor, array or nested list as a tensor of ``dtype`` on
    ``device``."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def generate(model: LlamaModel, prompt_ids, max_new_tokens: int,
             temperature: float = 0.0, generator=None,
             pad_to: int | None = None, pad_lens=None, top_k: int = 0,
             top_p: float = 1.0, eos_id: int | None = None,
             return_steps: bool = False):
    """Greedy / temperature sampling with a KV cache, on the model's
    device.

    A prefill writes the whole prompt's cache in one pass (through the
    flash kernel when the model's attention resolves to it), then a decode
    loop emits one token per step (through the flash-decode kernel
    likewise). For mixed-length prompts, left-pad with
    :func:`left_pad_prompts` and pass ``pad_lens``. With ``eos_id`` the
    loop stops as soon as every row has finished.

    ``prompt_ids``: ``[B, Lp]`` ints (tensor or array), Lp >= 1. The cache
    holds ``pad_to`` slots, default ``Lp + max_new_tokens``. ``generator``
    (on the model's device) draws the samples; default seed 0. Returns
    ``[B, Lp + max_new_tokens]`` int64 (left-pad slots included); with
    ``return_steps=True``, ``(ids, n_decode_steps)``."""
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p} — 0 would "
                         f"mask every token and degenerate to id 0")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (0 disables), got {top_k}")
    if eos_id is not None and (isinstance(eos_id, bool)
                               or not isinstance(eos_id, (int, np.integer))):
        raise TypeError(f"eos_id must be an int token id or None, "
                        f"got {eos_id!r}")
    device = model.device
    prompt_ids = _tensor(prompt_ids, torch.int64, device)
    b, lp = prompt_ids.shape
    if lp < 1:
        raise ValueError("prompt_ids must contain at least one token")
    max_len = pad_to or (lp + max_new_tokens)
    if max_len < lp + max_new_tokens:
        raise ValueError(f"pad_to={pad_to} < prompt+new ="
                         f" {lp + max_new_tokens}")
    if pad_lens is not None:
        pad_lens = _tensor(pad_lens, torch.int32, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cache = init_cache(model, b, int(max_len))
    last_logits = _prefill(model, prompt_ids, cache, pad_lens)
    toks, n_steps = _decode(model, cache, last_logits, generator, pad_lens,
                            max_new_tokens=int(max_new_tokens),
                            temperature=float(temperature), top_k=int(top_k),
                            top_p=float(top_p),
                            eos_id=None if eos_id is None else int(eos_id))
    ids = torch.cat([prompt_ids, toks], dim=1)
    return (ids, n_steps) if return_steps else ids
