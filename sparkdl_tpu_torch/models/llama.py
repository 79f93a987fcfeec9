"""Llama-style decoder-only transformer with LoRA, and KV-cache generation.

The counterpart of ``sparkdl_tpu/models/llama.py``'s single-device
part: config, RMSNorm, LoRADense (with the int8 base of the reference's
``QuantDense``), rope, the attention with its training path, its
static-cache decode path and its per-slot (``slot_cur``) serving
branches, MLP, layer, model, ``generate``, the continuous-batching slot
primitives, the paged block-table primitives, the block-quantized
(int8 / fp8) KV pool, int8 projection weights (:func:`quantize_params`)
and the LoRA training utilities (:func:`lora_mask`,
:func:`lora_optimizer`, :func:`causal_lm_loss_fn`). Sequence-parallel
prefill takes ``attn_fn=partial(parallel.ring_attention, mesh=...)``.

Tensor-parallel serving (the reference's ``kernel_mesh``): a model built
with ``kernel_mesh=`` (a ``{"tp": n}`` ``DeviceMesh``, one process a
device) holds one rank's shard — 1/n of the attention heads, of the MLP
columns, of the embedding's hidden dim and of ``lm_head``'s vocabulary,
where ``parallel.sharding.serving_tp_layout``'s rules split them (an
indivisible dim stays whole, as ``divisible_rules`` leaves it) — and
issues the collectives GSPMD inserted for the reference: one
``all_reduce`` on the tp group after each row-parallel product (o_proj,
down_proj), an ``all_gather`` of the embedding's hidden slices and of
the logits' vocabulary slices, so every rank holds the same logits. Its
decode kernels run on the local heads through ``parallel.sharding
.head_sharded_kernel``. :func:`shard_model` makes it from the global
model. The config stays the global one (its ``head_dim`` is
``hidden_size // num_heads``); the modules take their local counts from
the mesh.

Sharded training (the reference's FSDP×TP step): :func:`shard_model` on
a ``{"data": d, "model": m}`` mesh builds the same split over ``model``
with collectives that carry gradients (``parallel.fsdp``: the copy into
q/k/v, gate/up and ``lm_head`` all-reduces backward, the row sums are the
identity backward, the gathers keep the rank's slice) and keeps only the
``data`` shard of each weight the rules split there, gathered at use.

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
:func:`generate` and the slot primitives take no ``variables``;
:func:`load_flax_params` fills a model from the JAX package's parameter
tree. The KV cache, the slot cache and the paged pool are each a
:class:`KVCache` whose tensors are written IN PLACE (JAX donated its
buffers and returned new ones from every step); the running ``idx`` and
a quantized pool's ``kv_scale`` planes are plain attributes. Sampling
draws from an explicit ``torch.Generator``; greedy decoding is
deterministic and matches the JAX package token for token.

The compiled decode step: where the JAX package jits the decode loop and
each slot step, the port replays every S = 1 step of :func:`_decode` and
of the serving backends from a captured CUDA graph
(``core.runtime.CompileCache.get``). A step reads nothing from the host:
the generate() step writes at the cache's device fill index
(``KVCache.idx_dev``), the slot steps at their ``slot_cur`` operand.
Sampling runs after the step, eagerly, so a sampled stream draws from its
generator exactly as an eager step does.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import math
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.runtime import CompileCache
from ..ops import flash_decode as fd
from ..ops import paged_flash_decode as pfd
from ..ops.flash_attention import flash_attention_fwd, resolve_attn_fn
from ..parallel.fsdp import copy_in, gather_block, linear, reduce_out
from ..parallel.ring_attention import NEG_INF
from ..parallel.sharding import dispatch_counter
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
    """Linear with optional LoRA: y = xW + (alpha/r)·(xA)B, no bias,
    computed in ``dtype``: the input and the weights are cast to it at use
    (a no-op for weights stored in it; ``models.pretrained.
    cast_float_leaves`` may store them in another).

    An int8 base (:func:`quantize_params`, or a quantized tree through
    :func:`load_flax_params`) is the reference's ``QuantDense``: ``base.
    weight`` holds the codes ``[out, in]`` and ``base.weight_scale`` the
    f32 absmax scale of each output channel ``[out]``; the product runs
    against the codes cast to ``dtype`` and the scale is applied after it
    in f32 (``(x @ q.T)·s``, then cast back, as the reference does). The
    cast writes a ``dtype`` copy of the codes for the product (XLA fuses
    it into the reference's dot). The adapters stay float."""

    def __init__(self, in_features: int, features: int, rank: int = 0,
                 alpha: float = 16.0, dtype=torch.float32, device=None):
        super().__init__()
        self.rank, self.alpha, self.dtype = rank, alpha, dtype
        # (adapter, group) of a training tensor-parallel projection: the
        # adapter replicated over the group enters it through copy_in
        self.adapter_copy = None
        kw = dict(bias=False, dtype=dtype, device=device)
        self.base = nn.Linear(in_features, features, **kw)
        if rank > 0:
            self.lora_a = nn.Linear(in_features, rank, **kw)
            self.lora_b = nn.Linear(rank, features, **kw)

    def forward(self, x):
        d = self.dtype
        x = x.to(d)
        w = self.base.weight
        if w.dtype == torch.int8:
            y = (F.linear(x, w.to(d)).float()
                 * self.base.weight_scale).to(d)
        else:
            y = linear(x, w, d)
        if self.rank > 0:
            wa, wb = self.lora_a.weight, self.lora_b.weight
            if self.adapter_copy is not None:
                which, group = self.adapter_copy
                if which == "lora_a":
                    wa = copy_in(wa, group)
                else:
                    wb = copy_in(wb, group)
            a = F.linear(x, wa.to(d))
            y = y + (self.alpha / self.rank) * F.linear(a, wb.to(d))
        return y


_COLUMN_PROJ = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")


def _tp_proj(c, name, n_in, n_out, dtype, device, plan, group):
    """One projection of a layer; under a training plan a LoRA adapter the
    rules replicate over the group (A of a column-parallel projection, B
    of a row-parallel one) enters it through ``copy_in``, so its partial
    gradients are summed."""
    m = LoRADense(n_in, n_out,
                  rank=c.lora_rank if name in c.lora_targets else 0,
                  alpha=c.lora_alpha, dtype=dtype, device=device)
    if plan.train and group is not None and m.rank > 0:
        m.adapter_copy = ("lora_a" if name in _COLUMN_PROJ else "lora_b",
                          group)
    return m


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


def _table_blocks(tables, bi, real):
    """Physical pool block for each logical block index ``bi``, with
    every position whose ``real`` flag is False routed to the trash
    block 0 — the trash-route-NEVER-clamp rule shared by the paged
    chunk prefill and the in-layer decode/verify writes (an
    out-of-table or pad position must land where nobody reads, never
    slide back over a committed block). ``tables`` is a ``[MB]`` row
    (the chunk primitive) or ``[B, MB]`` slot tables; the ``min`` clamp
    only keeps the gather in bounds — clamped positions are ~real and
    route to trash."""
    mb = tables.shape[-1]
    safe = bi.clamp_max(mb - 1).long()
    blk = tables.long()[safe] if tables.dim() == 1 else \
        torch.gather(tables.long(), 1, safe)
    return torch.where(real, blk, 0)


def _dense_slot_attention(q, k_all, v_all, qpos, pads, dtype):
    """Masked dense causal-vs-cache attention for the per-slot
    (``slot_cur``) serving paths — ONE definition shared by the paged
    and unpaged dense arms: query i of row r attends cache columns
    ``[pads[r], qpos[r, i]]``. GQA runs against the untiled cache (group
    axis in the einsum, no repeat of K/V); masked columns get exactly
    zero probability (exp underflow of -1e30), so table-aliased garbage
    never perturbs live rows."""
    B, S = qpos.shape
    hq, hkv, hd = q.shape[1], k_all.shape[1], q.shape[3]
    qg = q.reshape(B, hkv, hq // hkv, S, hd)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k_all) / math.sqrt(hd)
    col = torch.arange(k_all.shape[2], device=q.device)[None, None, :]
    valid = (col <= qpos[..., None]) & (col >= pads[:, None, None])
    s = torch.where(valid[:, None, None], s.float(), NEG_INF)
    p = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bgrqk,bgkd->bgrqd", p, v_all).reshape(B, hq, S, hd)


# ---------------------------------------------------------------------------
# Block-quantized KV: the paged pool's K/V leaves store int8 (or fp8)
# CODES and a parallel ``kv_scale`` [pool_blocks, Hkv, 2] f32 plane per
# layer holds one absmax scale per (physical block, kv head, K-or-V):
# dequant is codes·scale. The scale is a property of the PHYSICAL block,
# so radix grafts (table pointer copies) and copy-on-write (block copies)
# move scales with their codes, and the paged kernel dequantizes as it
# reads — no float copy of the cache exists in device memory.
# ---------------------------------------------------------------------------

KV_QUANT_DTYPES: dict = {"int8": (torch.int8, 127.0),
                         "fp8": (torch.float8_e4m3fn, 448.0)}


def kv_quant_spec(name: str):
    """(storage dtype, qmax) for a KV quant mode name — raises with the
    available modes on a miss, never silently falls back."""
    try:
        return KV_QUANT_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown KV quant dtype {name!r}; available: "
            f"{sorted(KV_QUANT_DTYPES)}") from None


def kv_quant_name(dtype) -> str | None:
    """Quant mode name for a stored K/V dtype, or None for a float
    cache — quantization is detected from the POOL, not a model flag."""
    for name, (dt, _) in KV_QUANT_DTYPES.items():
        if dtype == dt:
            return name
    return None


def _kv_qmax(dtype) -> float:
    for dt, qmax in KV_QUANT_DTYPES.values():
        if dtype == dt:
            return qmax
    raise ValueError(f"not a KV quant storage dtype: {dtype}")


def _requant(x, qdt, qmax):
    """f32 values (already divided by scale) → codes: round (half to
    even, as ``jnp.round``) and clip for int storage, clip and cast for
    fp8 (the cast itself rounds to nearest even)."""
    if not qdt.is_floating_point:
        x = torch.round(x)
    return x.clamp(-qmax, qmax).to(qdt)


def _quant_insert_rows(codes, plane, ch, blk, off, rows):
    """Insert float ``rows`` [N, Hkv, hd] at pool positions
    ``(blk[n], :, off[n], :)`` of a quantized ``codes`` leaf IN PLACE,
    maintaining the shared per-(block, head) scale ``plane[..., ch]``
    (ch 0 = K, 1 = V). ONE routine serves the in-layer decode/verify
    writes, the chunk-prefill scatter and the blocking-prefill scatter.

    Scale discipline, in scatter order (as the JAX package's):
    1. an ``off == 0`` row is a block's FIRST write (positions fill
       sequentially under the write-frontier invariant), so its scale
       resets to 0 — a freed-then-reallocated block must not inherit
       the previous tenant's scale (non-first rows reset the trash
       block 0, which nothing reads live);
    2. scatter-max of the incoming rows' absmax/qmax grows the scale
       (duplicate blocks in ``blk`` accumulate — a multi-row write into
       one block yields the block's true absmax);
    3. surviving rows of every touched block requantize by
       old_s/new_s — exact when the scale did not grow, one ≤½-LSB
       rounding when it did; ratio 0 (a fresh block) wipes stale codes;
    4. the new rows quantize at the final scale.

    ``index_put_`` with duplicate indices keeps one of the written
    values: step 3's duplicates (one block named by several rows) carry
    identical content — the same old codes times the same ratio — and
    step 4's duplicate (block, offset) pairs occur only on the trash
    block 0, whose content nothing reads live."""
    qdt = codes.dtype
    qmax = _kv_qmax(qdt)
    rows = rows.float()
    blk = blk.long()
    off = off.long()
    col = plane[:, :, ch]                       # [P, Hkv] view
    # index_fill_, not an indexed assignment of 0.0: that copies a CPU
    # scalar tensor, which a CUDA graph capture refuses
    col.index_fill_(0, torch.where(off == 0, blk, 0), 0.0)
    amax = rows.abs().amax(-1)                  # [N, Hkv]
    old_s = col[blk]
    col.scatter_reduce_(0, blk[:, None].expand_as(amax), amax / qmax,
                        "amax")
    new_s = col[blk]
    safe = new_s.clamp_min(1e-30)
    ratio = torch.where(new_s > 0, old_s / safe, 0.0)
    codes[blk] = _requant(codes[blk].float() * ratio[:, :, None, None],
                          qdt, qmax)
    codes[blk, :, off] = _requant(rows / safe[:, :, None], qdt, qmax)


@dataclasses.dataclass
class _SlotStep:
    """What every layer of one slot step (decode or verify window)
    shares: the per-row fill indices, pads, logical query positions
    ``qpos`` ``[B, S]``, rope positions, the block tables (paged) and
    the cache write's index tuple, computed once per forward. ``sel``
    picks the written rows of the step's ``[B, S]`` K/V (None: all)."""
    cur: torch.Tensor
    pads: torch.Tensor
    qpos: torch.Tensor
    pos: torch.Tensor
    tables: torch.Tensor | None
    where: tuple
    sel: tuple | None = None


def _slot_step(slot_cur, pad_lens, s: int, cache, tables) -> _SlotStep:
    dev = slot_cur.device
    cur = slot_cur.to(torch.int32)
    pads = (torch.zeros_like(cur) if pad_lens is None
            else pad_lens.to(device=dev, dtype=torch.int32))
    qpos = cur.long()[:, None] + torch.arange(s, device=dev)[None, :]
    pos = (qpos - pads.long()[:, None]).clamp_min(0)
    if tables is not None:
        # Writes go through the table; a position past it (an
        # overhanging draft column) routes to the trash block 0.
        bs, mb = cache.k[0].shape[2], tables.shape[1]
        bi = qpos // bs
        return _SlotStep(cur, pads, qpos, pos, tables,
                         (_table_blocks(tables, bi, bi < mb), qpos % bs))
    rows = torch.arange(cur.shape[0], device=dev)[:, None].expand(-1, s)
    if s == 1:
        # a decode step writes at cur < max_len (the engine's admission)
        return _SlotStep(cur, pads, qpos, pos, None, (rows, qpos))
    # A verify window's writes past the row's end are DROPPED, never
    # clamped back over committed rows.
    sel = (qpos < cache.k[0].shape[2]).nonzero(as_tuple=True)
    return _SlotStep(cur, pads, qpos, pos, None, (rows[sel], qpos[sel]), sel)


def _all_reduce(y, group):
    """Sum ``y`` over the tensor-parallel ``group`` (a row-parallel
    product's partial sums): in place when no gradient is taken, through
    ``parallel.fsdp.reduce_out`` (the identity backward) when one is;
    ``y`` itself without a group."""
    if group is None:
        return y
    if torch.is_grad_enabled() and y.requires_grad:
        return reduce_out(y, group)
    import torch.distributed as dist
    dist.all_reduce(y, group=group)
    return y


def _all_gather_last(x, group, n: int):
    """The ``n`` ranks' slices of ``x``'s last dim, joined in rank order
    (a hidden- or vocabulary-sharded output; the gradient keeps the
    rank's slice); ``x`` itself without a group."""
    if group is None:
        return x
    return gather_block(x, -1, group, n)


@dataclasses.dataclass(frozen=True)
class _TpPlan:
    """One rank's share of the model on a mesh, as the rules ``shard_model``
    places the weights by decide it: the group each split dim gathers or
    reduces over (None: the rules leave that dim whole, an indivisible
    one, or no mesh at all).

    A ``{"tp": size}`` mesh is the serving model's, under
    ``divisible_rules(serving_tp_layout(size).rules, mesh)``. A training
    mesh (its axes among ``data`` / ``model``, e.g. ``{"data": 2,
    "model": 2}``) splits over ``model`` by ``rules`` (default
    :func:`training_rules` at the mesh, the rules ``shard_model`` places
    a training model by); ``train`` is then set and the modules'
    collectives carry gradients (Megatron's conjugate pairs,
    ``parallel.fsdp``). A mesh without ``model`` splits nothing."""
    size: int = 1
    heads_group: object = None
    mlp_group: object = None
    embed_group: object = None
    head_group: object = None
    mesh: object = None
    train: bool = False

    @classmethod
    def of(cls, cfg: LlamaConfig, mesh, rules=None) -> "_TpPlan":
        if mesh is None:
            return cls()
        from ..parallel.sharding import divisible_rules, serving_tp_layout
        names = list(mesh.mesh_dim_names)
        if names == ["tp"]:
            axis = "tp"
        elif "tp" in names or not set(names) <= {"data", "model"}:
            raise ValueError(f"the tensor-parallel model takes a one-axis "
                             f"{{'tp': n}} mesh (serving) or a training mesh "
                             f"over 'data' and 'model', got axes "
                             f"{tuple(names)}")
        elif "model" in names:
            axis = "model"
        else:
            return cls(train=True)
        n = mesh.size(names.index(axis))
        # raises unless the heads split evenly
        layout = serving_tp_layout(n, cfg, axis=axis)
        if rules is None:
            rules = layout.rules if axis == "tp" else training_rules(mesh)
        rules = divisible_rules(rules, mesh)
        g = mesh.get_group(axis)

        def group(*leaves):
            """``g`` when the rules split every ``(name, shape, dim)``
            leaf on ``dim``, None when they split none of them; the
            modules' collectives serve no other layout."""
            on = [[i for i, ax in enumerate(rules(
                (name,), torch.empty(shape, device="meta"))) if ax == axis]
                for name, shape, _ in leaves]
            if all(o == [d] for o, (_, _, d) in zip(on, leaves)):
                return g
            if not any(on):
                return None
            raise ValueError(f"the tensor-parallel model cannot serve the "
                             f"rules' split dims "
                             f"{dict(zip((x[0] for x in leaves), on))}")

        q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        attn, mlp = "layers.0.attn.", "layers.0.mlp."
        return cls(
            n,
            group((attn + "q_proj.base.weight", (q, h), 0),
                  (attn + "k_proj.base.weight", (kv, h), 0),
                  (attn + "o_proj.base.weight", (h, q), 1)),
            group((mlp + "gate_proj.base.weight", (f, h), 0),
                  (mlp + "up_proj.base.weight", (f, h), 0),
                  (mlp + "down_proj.base.weight", (h, f), 1)),
            group(("embed_tokens.weight", (v, h), 1)),
            group(("lm_head.weight", (v, h), 0)),
            mesh if axis == "tp" else None, axis == "model")

    def part(self, width: int, group) -> int:
        return width // self.size if group is not None else width


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.float32, device=None,
                 plan: _TpPlan = _TpPlan()):
        super().__init__()
        self.cfg = cfg
        c, hd = cfg, cfg.head_dim
        # this rank's heads (all of them without a mesh), the group the
        # o_proj partial sums reduce over, the mesh of the decode dispatch
        self.heads = plan.part(c.num_heads, plan.heads_group)
        self.kv_heads = plan.part(c.num_kv_heads, plan.heads_group)
        self.group, self.kernel_mesh = plan.heads_group, plan.mesh
        self.train_tp = plan.train

        def proj(name, n_in, n_out):
            return _tp_proj(c, name, n_in, n_out, dtype, device, plan,
                            self.group)

        self.q_proj = proj("q_proj", c.hidden_size, self.heads * hd)
        self.k_proj = proj("k_proj", c.hidden_size, self.kv_heads * hd)
        self.v_proj = proj("v_proj", c.hidden_size, self.kv_heads * hd)
        self.o_proj = proj("o_proj", self.heads * hd, c.hidden_size)

    def forward(self, x, positions, attn_fn, kv=None, cur: int = 0,
                pad_lens=None, first_chunk: bool = False, slots=None):
        """``kv`` None: the training path (causal self-attention over x).
        ``kv = (k_cache, v_cache)``: the serving path — this call's S
        tokens are written into the caches at slot ``cur`` (in place) and
        attend the cache; ``pad_lens`` ``[B]`` masks each row's left pad
        and counts rope positions from its first real token. With
        ``slots`` (a :class:`_SlotStep`) every row is an independent
        in-flight request at its own fill index (:meth:`_slot`); ``kv``
        then is the slot cache or the paged pool, plus a quantized
        pool's scale plane as a third entry."""
        c = self.cfg
        B, S, _ = x.shape
        hd, hq, hkv = c.head_dim, self.heads, self.kv_heads
        rep = hq // hkv
        if self.train_tp:
            x = copy_in(x, self.group)
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
        elif slots is not None:
            o = self._slot(q, k, v, kv, attn_fn, slots)
        else:
            o = self._cached(q, k, v, kv, attn_fn, cur, pad_lens,
                             first_chunk)
        o = o.transpose(1, 2).reshape(B, S, hq * hd)
        return _all_reduce(self.o_proj(o), self.group)

    def _slot(self, q, k, v, kv, attn_fn, st: _SlotStep):
        """The continuous-batching step / speculative verify window: row
        r's S tokens write at ``[cur[r], cur[r] + S)`` and query i
        attends ``[pads[r], cur[r] + i]`` — dense causal-vs-cache under
        the write-frontier invariant: every row at or past the frontier
        is (re)written before any attention can read it, so rejected
        drafts leave inert garbage the next real write overwrites.

        Paged (``st.tables``): ``kv`` is the shared pool, written and
        read through the tables; attention runs in the paged kernel
        (:func:`ops.paged_flash_decode.paged_decode_fn_for`) or, where
        the caller turned it off, over the gathered view. Unpaged:
        ``kv`` is the ``[num_slots, Hkv, max_len, hd]`` slot cache; a
        decode step (S = 1) runs the flash-decode kernel with per-row
        ``cur + 1`` when the model's attention pairs with it; a verify
        window attends densely, as in the JAX package."""
        c = self.cfg
        hkv, hd = self.kv_heads, c.head_dim
        q = rope(q, st.pos, c.rope_theta)
        k = rope(k, st.pos, c.rope_theta)
        kr, vr = k.transpose(1, 2), v.transpose(1, 2)   # [B, S, Hkv, hd]
        k_cache, v_cache = kv[0], kv[1]
        plane = kv[2] if len(kv) > 2 else None
        if st.tables is not None:
            blk, off = st.where
            if plane is None:
                # duplicate (block, offset) pairs occur only on the trash
                # block 0 (parked slots, overhanging columns)
                k_cache[blk, :, off] = kr.to(k_cache.dtype)
                v_cache[blk, :, off] = vr.to(v_cache.dtype)
            else:
                fb, fo = blk.reshape(-1), off.reshape(-1)
                _quant_insert_rows(k_cache, plane, 0, fb, fo,
                                   kr.reshape(-1, hkv, hd))
                _quant_insert_rows(v_cache, plane, 1, fb, fo,
                                   vr.reshape(-1, hkv, hd))
            dec = pfd.paged_decode_fn_for(attn_fn, self.kernel_mesh)
            if dec is not None:
                return dec(q.contiguous(), k_cache, v_cache, st.tables,
                           st.cur, st.pads, plane)
            k_all = pfd.gathered_view(k_cache, st.tables, plane, 0).to(
                q.dtype)
            v_all = pfd.gathered_view(v_cache, st.tables, plane, 1).to(
                q.dtype)
            return _dense_slot_attention(q, k_all, v_all, st.qpos, st.pads,
                                         q.dtype)
        rows, cols = st.where
        if st.sel is not None:
            kr, vr = kr[st.sel], vr[st.sel]
        k_cache[rows, :, cols] = kr.to(k_cache.dtype)
        v_cache[rows, :, cols] = vr.to(v_cache.dtype)
        if q.shape[2] == 1:
            dec = fd.decode_fn_for(attn_fn, self.kernel_mesh)
            if dec is not None:
                # per-row cur: each slot reads only its own live slots
                return dec(q, k_cache, v_cache, st.cur + 1, st.pads)
        return _dense_slot_attention(q, k_cache, v_cache, st.qpos, st.pads,
                                     q.dtype)

    def _cached(self, q, k, v, kv, attn_fn, cur, pad_lens, first_chunk):
        """``cur``: the host fill index, or for the S = 1 step the
        cache's device fill index (a 0-d tensor), which a captured graph
        reads at every replay."""
        c = self.cfg
        B, hq, S, hd = q.shape
        hkv = self.kv_heads
        rep = hq // hkv
        k_cache, v_cache = kv
        max_len = k_cache.shape[2]
        steps = cur + torch.arange(S, device=q.device)
        if pad_lens is None:
            pos = steps  # [S], shared across rows
        else:
            pos = (steps[None, :] - pad_lens[:, None]).clamp_min(0)  # [B, S]
        q = rope(q, pos, c.rope_theta)
        k = rope(k, pos, c.rope_theta)
        # In place: the step's K/V land in the caller's cache tensors.
        if torch.is_tensor(cur):
            k_cache.index_copy_(2, steps, k.to(k_cache.dtype))
            v_cache.index_copy_(2, steps, v.to(v_cache.dtype))
        else:
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
            dec = fd.decode_fn_for(attn_fn, self.kernel_mesh)
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
    def __init__(self, cfg: LlamaConfig, dtype=torch.float32, device=None,
                 plan: _TpPlan = _TpPlan()):
        super().__init__()
        c = cfg
        # the group the down_proj partial sums reduce over (None: whole)
        self.group = plan.mlp_group
        self.train_tp = plan.train
        inter = plan.part(c.intermediate_size, plan.mlp_group)

        def proj(name, n_in, n_out):
            return _tp_proj(c, name, n_in, n_out, dtype, device, plan,
                            self.group)

        self.gate_proj = proj("gate_proj", c.hidden_size, inter)
        self.up_proj = proj("up_proj", c.hidden_size, inter)
        self.down_proj = proj("down_proj", inter, c.hidden_size)

    def forward(self, x):
        if self.train_tp:
            x = copy_in(x, self.group)
        return _all_reduce(
            self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x)),
            self.group)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.float32, device=None,
                 plan: _TpPlan = _TpPlan()):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.attn = LlamaAttention(cfg, dtype, device, plan)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.mlp = LlamaMLP(cfg, dtype, device, plan)

    def forward(self, x, positions, attn_fn, kv=None, cur: int = 0,
                pad_lens=None, first_chunk: bool = False, slots=None):
        x = x + self.attn(self.attn_norm(x), positions, attn_fn, kv, cur,
                          pad_lens, first_chunk, slots)
        return x + self.mlp(self.mlp_norm(x))


@dataclasses.dataclass
class KVCache:
    """Per-layer K/V tensors and the running fill index, a host int
    (``idx``), all written in place. A generate() cache or the engine's
    slot cache holds ``[B, Hkv, max_len, head_dim]`` per layer; a paged
    pool holds ``[pool_blocks, Hkv, block_size, head_dim]`` blocks, and a
    quantized pool the codes plus one ``[pool_blocks, Hkv, 2]`` f32 scale
    plane per layer (``kv_scale``; None for a float cache).

    ``idx_dev`` (an :func:`init_cache` cache): the fill index again, as a
    0-d int64 tensor on the cache's device. The S = 1 step writes at it
    and advances it on the device, so a captured step reads no host
    value; ``idx`` serves the bounds checks and the prefill, and the two
    agree after every call."""
    k: list
    v: list
    idx: int = 0
    kv_scale: list | None = None
    idx_dev: torch.Tensor | None = None

    def layer(self, i: int) -> tuple:
        """Layer ``i``'s ``(k, v)``, plus its scale plane when quantized."""
        if self.kv_scale is None:
            return self.k[i], self.v[i]
        return self.k[i], self.v[i], self.kv_scale[i]

    def tensors(self) -> list:
        """Every tensor of the cache (K, V and scale planes)."""
        return [*self.k, *self.v, *(self.kv_scale or [])]


class LlamaModel(nn.Module):
    """Token ids ``[B, S]`` → logits ``[B, S, vocab]`` (f32).

    ``attn_fn``: ``"auto"`` (default) resolves to the flash kernel policy
    when a CUDA device exists and to in-model dense attention elsewhere
    (``ops.flash_attention.resolve_attn_fn``); or pass a callable
    ``(q, k, v, causal=..., kv_mask=...)`` or None. ``device``: None means
    ``cuda`` and raises without one — pass ``device="cpu"`` for the CPU.
    Weights are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; default seed 0): projections N(0, 1/fan_in), embeddings
    N(0, 1/hidden), LoRA A N(0, 0.02²) and B zero, norm scales one.

    ``kernel_mesh``: a ``{"tp": n}`` mesh makes this one rank's shard of
    the tensor-parallel serving model (module doc; :func:`shard_model`
    fills it from the global model). Its ``heads`` / ``kv_heads`` are the
    rank's. A training mesh (axes among ``data`` / ``model``) makes one
    rank's Megatron split over ``model`` by ``tp_rules`` (default
    :func:`training_rules` at the mesh, which ``shard_model`` places the
    weights by), whose collectives carry gradients; its
    ``kernel_mesh`` is then None (no decode dispatch).
    :func:`shard_model` builds it and shards it over ``data``."""

    def __init__(self, cfg: LlamaConfig, dtype=torch.float32,
                 attn_fn="auto", device=None, generator=None,
                 kernel_mesh=None, tp_rules=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dtype, self.attn_fn = cfg, dtype, attn_fn
        plan = _TpPlan.of(cfg, kernel_mesh, tp_rules)
        self.kernel_mesh, self.tp_size = plan.mesh, plan.size
        self.train_tp = plan.train
        self.embed_group, self.head_group = plan.embed_group, plan.head_group
        # this rank's query and KV heads: the cache's and pool's head axis
        self.heads = plan.part(cfg.num_heads, plan.heads_group)
        self.kv_heads = plan.part(cfg.num_kv_heads, plan.heads_group)
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, plan.part(cfg.hidden_size, plan.embed_group),
            dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, dtype, device, plan)
            for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.lm_head = nn.Linear(
            cfg.hidden_size, plan.part(cfg.vocab_size, plan.head_group),
            bias=False, dtype=torch.float32, device=device)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        # a norm scale: never sharded, so reading it gathers nothing
        return self.final_norm.scale.device

    @property
    def weight_quant(self) -> str | None:
        """"int8" when the projections hold codes
        (:func:`quantize_params`), else None."""
        return "int8" if any(m.base.weight.dtype == torch.int8
                             for _, m in _projections(self)) else None

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
                first_chunk: bool = False, last_only: bool = False,
                slot_cur=None, block_tables=None):
        """``cache`` None: the training forward. With a :class:`KVCache`:
        the serving forward — writes at ``cache.idx`` and advances it (an
        S = 1 call on a cache with ``idx_dev`` writes at that device
        index; while a CUDA graph captures the call, the host index is
        left to the caller, which advances it at each replay).
        ``first_chunk`` (serving, True only when writing at slot 0 —
        :func:`_prefill` passes it) enables the square flash prefill.
        ``last_only``: logits of the last position only, ``[B, 1, V]``.

        ``slot_cur`` ``[B]`` (continuous batching): every cache row is an
        independent request at its own fill index; ``cache.idx`` is
        neither read nor advanced. With ``block_tables`` ``[B, MB]`` the
        cache is the paged pool, addressed through the tables."""
        if pad_lens is not None and cache is None:
            raise ValueError(
                "pad_lens is a KV-cache serving feature; the training path "
                "has no left-pad masking — feed right-padded batches with a "
                "loss mask instead")
        if slot_cur is not None and cache is None:
            raise ValueError("slot_cur needs the slot cache or paged pool")
        S = input_ids.shape[1]
        positions = torch.arange(S, device=input_ids.device)
        attn_fn = resolve_attn_fn(self.attn_fn)
        slots = None if slot_cur is None else _slot_step(
            slot_cur, pad_lens, S, cache, block_tables)
        cached = cache is not None and slots is None
        host = not (input_ids.is_cuda
                    and torch.cuda.is_current_stream_capturing())
        cur = 0
        if cached:
            if host:
                check_fill(cache, S, first_chunk)
            cur = cache.idx_dev if S == 1 and cache.idx_dev is not None \
                else cache.idx
        x = _all_gather_last(self.embed_tokens(input_ids), self.embed_group,
                             self.tp_size).to(self.dtype)
        for i, layer in enumerate(self.layers):
            kv = None if cache is None else cache.layer(i)
            x = layer(x, positions, attn_fn, kv, cur, pad_lens, first_chunk,
                      slots)
        if cached:
            if torch.is_tensor(cur):
                cur.add_(1)
            if host:
                cache.idx += S
                if S > 1 and cache.idx_dev is not None:
                    cache.idx_dev.fill_(cache.idx)
        if last_only:
            x = x[:, -1:]
        h = self.final_norm(x).float()
        if self.train_tp:
            h = copy_in(h, self.head_group)
        return _all_gather_last(linear(h, self.lm_head.weight, torch.float32),
                                self.head_group, self.tp_size)


def check_fill(cache: KVCache, s: int, first_chunk: bool = False) -> None:
    """Raise unless ``s`` tokens fit at ``cache.idx`` (and, for a first
    chunk, the cache is empty): the host-side bounds checks of a cached
    call, which a replayed step runs before its replay."""
    max_len = cache.k[0].shape[2]
    if cache.idx + s > max_len:
        raise ValueError(f"cache overflow: writing {s} tokens at slot "
                         f"{cache.idx} of a {max_len}-slot cache")
    if first_chunk and cache.idx != 0:
        raise ValueError(f"first_chunk writes at cache slot 0, but the "
                         f"cache is filled to {cache.idx}")


# ---------------------------------------------------------------------------
# Weights carried across from the JAX package
# ---------------------------------------------------------------------------

_ATTN_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP_PROJ = ("gate_proj", "up_proj", "down_proj")


def _projections(model: LlamaModel):
    """(flax path, :class:`LoRADense`) for every layer's seven
    projections, in the reference's tree order."""
    for i, layer in enumerate(model.layers):
        p = (f"layer_{i}",)
        for name in _ATTN_PROJ:
            yield p + ("attn", name), getattr(layer.attn, name)
        for name in _MLP_PROJ:
            yield p + ("mlp", name), getattr(layer.mlp, name)


def _param_map(model: LlamaModel):
    """(flax path, torch tensor, transposed) for every weight: a flax
    Dense kernel ``[in, out]`` is a ``Linear.weight`` ``[out, in]``; an
    int8 base adds its ``kernel_scale``."""
    out = [(("embed_tokens", "embedding"), model.embed_tokens.weight, False)]
    for prefix, mod in _projections(model):
        out.append((prefix + ("base", "kernel"), mod.base.weight, True))
        if mod.base.weight.dtype == torch.int8:
            out.append((prefix + ("base", "kernel_scale"),
                        mod.base.weight_scale, False))
        if mod.rank > 0:
            out.append((prefix + ("lora_a", "kernel"), mod.lora_a.weight,
                        True))
            out.append((prefix + ("lora_b", "kernel"), mod.lora_b.weight,
                        True))
    for i, layer in enumerate(model.layers):
        p = (f"layer_{i}",)
        out.append((p + ("attn_norm", "scale"), layer.attn_norm.scale, False))
        out.append((p + ("mlp_norm", "scale"), layer.mlp_norm.scale, False))
    out.append((("final_norm", "scale"), model.final_norm.scale, False))
    out.append((("lm_head", "kernel"), model.lm_head.weight, True))
    return out


def _set_base(mod: LoRADense, codes, scale=None) -> None:
    """Give ``mod`` an int8 base (``codes`` ``[out, in]``, f32 ``scale``
    ``[out]``) or, with ``codes`` a float tensor and no scale, a float
    base again. The old weight is released here."""
    base = mod.base
    base.weight = nn.Parameter(codes, requires_grad=scale is None)
    if scale is None:
        if "weight_scale" in base._buffers:
            del base._buffers["weight_scale"]
    else:
        base.register_buffer("weight_scale", scale)


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
    a ``{"params": ...}`` wrapper is accepted. A quantized tree (the
    reference's ``quantize_params``: an int8 ``kernel`` and its
    ``kernel_scale``) gives the projections int8 bases; a float tree
    gives them float ones, whatever the model held. Raises on a missing,
    unexpected or mis-shaped leaf. Returns the model."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    leaves = dict(_flatten(params))
    for prefix, mod in _projections(model):
        kernel = leaves.get(prefix + ("base", "kernel"))
        w = mod.base.weight
        if kernel is None or ((np.asarray(kernel).dtype == np.int8)
                              == (w.dtype == torch.int8)):
            continue
        if w.dtype == torch.int8:   # a float tree: float bases again
            _set_base(mod, torch.zeros(w.shape, dtype=mod.dtype,
                                       device=w.device))
        else:                       # a quantized tree: int8 bases
            _set_base(mod, torch.zeros(w.shape, dtype=torch.int8,
                                       device=w.device),
                      torch.ones(w.shape[0], device=w.device))
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


@torch.no_grad()
def load_state(model: LlamaModel, state) -> LlamaModel:
    """Fill ``model`` from a ``state_dict``-named mapping of tensors of
    its own shapes (a tensor-parallel rank's local shards): a projection
    whose ``base.weight`` comes as int8 codes takes an int8 base with its
    ``base.weight_scale``. Raises on a missing, unexpected or mis-shaped
    entry. Returns the model."""
    state = dict(state)
    for name, mod in model.named_modules():
        codes = state.get(f"{name}.base.weight")
        if isinstance(mod, LoRADense) and codes is not None and \
                codes.dtype == torch.int8 != mod.base.weight.dtype:
            _set_base(mod, codes.detach().clone(),
                      state[f"{name}.base.weight_scale"].detach().clone())
    for name, t in model.state_dict().items():
        if name not in state:
            raise KeyError(f"the state lacks {name}")
        src = state.pop(name)
        if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
            raise ValueError(f"{name}: {src.dtype} {tuple(src.shape)} does "
                             f"not fit {t.dtype} {tuple(t.shape)}")
        t.copy_(src)
    if state:
        raise ValueError(f"unexpected state entries: {sorted(state)}")
    return model


@torch.no_grad()
def shard_model(model: LlamaModel, mesh, rules=None) -> LlamaModel:
    """This rank's shard of the global ``model`` on ``mesh`` (every rank of
    the mesh calls it, with the same model).

    A training mesh (axes among ``data`` / ``model``, e.g. ``{"data": 2,
    "model": 2}``): the FSDP×TP model the sharded train step trains
    (``runner.train_state.make_train_step(mesh=)``). ``rules`` (default
    ``lora_rules(transformer_tp_rules(data_axis="data", mesh=mesh))``,
    axes the mesh lacks dropped) place every parameter;
    the model is built with the Megatron split over ``model`` those rules
    give (local heads, MLP columns, embedding hidden slice, ``lm_head``
    vocabulary slice, the conjugate collectives) and the ``attn_fn`` of
    ``model``, and each parameter the rules shard over ``data`` keeps
    only its ``data`` shard, all-gathered at each use and its gradient
    reduce-scattered (``parallel.fsdp.shard_module``, ZeRO-3). The result
    trains; build its optimizer after this call.

    A ``{"tp": n}`` mesh: the tensor-parallel serving model, the global
    ``state_dict`` placed by
    ``parallel.sharding.shard_params`` under ``divisible_rules(
    serving_tp_layout(n).rules, mesh)`` — int8 codes and their scales
    included, column scales split with their rows, row scales whole —
    and each ``DTensor``'s local shard loaded into a model built with
    ``kernel_mesh=mesh`` and dense prefill (``attn_fn=None``). So each
    rank holds exactly the shard ``DTensor`` placement gives it, and
    nothing global: the caller may drop ``model``. Quantize the global
    model first (:func:`quantize_params`): a row-parallel shard holds
    only part of each scale's row. The result takes no gradient."""
    from ..parallel.sharding import (divisible_rules, serving_tp_layout,
                                     shard_params)

    if model.device.type != mesh.device_type:
        raise ValueError(f"the model lies on {model.device}, the mesh's "
                         f"devices are {mesh.device_type}")
    if list(mesh.mesh_dim_names) != ["tp"]:
        return _shard_for_training(model, mesh, rules)
    local = LlamaModel(model.cfg, dtype=model.dtype, attn_fn=None,
                       device=model.device, kernel_mesh=mesh)
    rules = divisible_rules(serving_tp_layout(local.tp_size).rules, mesh)
    placed = shard_params(dict(model.state_dict()), mesh, rules)
    load_state(local, {k: t.to_local() for k, t in placed.items()})
    del placed
    return local.requires_grad_(False)


def training_rules(mesh):
    """The FSDP×TP rules of a training mesh: ``lora_rules(
    transformer_tp_rules(data_axis="data", mesh=mesh))`` at its extents,
    the axes the mesh lacks dropped (a ``{"data": n}`` mesh is FSDP
    alone, a ``{"model": n}`` one the Megatron split alone)."""
    from ..parallel.sharding import P, lora_rules, transformer_tp_rules

    names = set(mesh.mesh_dim_names)
    base = lora_rules(transformer_tp_rules(
        data_axis="data" if "data" in names else None,
        mesh=mesh if "data" in names else None))

    def rules(path, leaf):
        return P(*(a if a in names else None for a in base(path, leaf)))

    return rules


def _shard_for_training(model: LlamaModel, mesh, rules):
    from ..parallel.fsdp import shard_module
    from ..parallel.sharding import divisible_rules

    if model.weight_quant is not None:
        raise ValueError("the sharded train step trains float weights; "
                         "this model holds int8 codes")
    rules = divisible_rules(training_rules(mesh) if rules is None
                            else rules, mesh)
    local = LlamaModel(model.cfg, dtype=model.dtype, attn_fn=model.attn_fn,
                       device=model.device, kernel_mesh=mesh,
                       tp_rules=rules)
    shard_module(local, mesh, rules, state=model.state_dict(),
                 gather_axes=("data",))
    for name, p in local.sparkdl_placement.locals.items():
        p.requires_grad_(dict(model.named_parameters())[name].requires_grad)
    return local


# ---------------------------------------------------------------------------
# int8 projection weights
# ---------------------------------------------------------------------------

# The projections of every layer — attention q/k/v/o and MLP gate/up/down
# (the reference's ``WEIGHT_QUANT_TARGETS``). lm_head, embed, the norms and
# the LoRA adapters stay float.
WEIGHT_QUANT_TARGETS = frozenset(_ATTN_PROJ + _MLP_PROJ)


@torch.no_grad()
def quantize_params(model: LlamaModel, name: str = "int8") -> LlamaModel:
    """Quantize ``model``'s projection weights IN PLACE (the reference's
    ``quantize_params`` returns a new tree; the port's model holds its
    weights): every base in :data:`WEIGHT_QUANT_TARGETS` becomes int8
    codes plus an absmax per-output-channel f32 scale, computed in f32
    from the stored weight — ``s = max|row| / 127`` (1 where the row is
    all zero, so the dequant stays finite) and ``q = clamp(round(w / s),
    -127, 127)``, rounding half to even as ``jnp.round`` does. Each float
    weight is released as its codes land, so the model never holds both
    copies of more than one projection. Bases already int8 are left as
    they are. Returns the model."""
    if name != "int8":
        raise ValueError(
            f"unsupported weight quant dtype {name!r} (int8 only)")
    for _, mod in _projections(model):
        if mod.base.weight.dtype == torch.int8:
            continue
        w = mod.base.weight.float()
        amax = w.abs().amax(dim=1)
        # a true division by a tensor: CUDA turns a division by a Python
        # scalar into a product with its reciprocal, which rounds apart
        s = amax / torch.full_like(amax, 127.0)
        s = torch.where(s > 0, s, torch.ones_like(s))
        q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(
            torch.int8)
        del w
        _set_base(mod, q, s)
    return model


def projection_bytes(model: LlamaModel) -> int:
    """Bytes the projections' weights hold on the device: int8 codes plus
    their scales, or the float weights (the adapters not counted)."""
    n = 0
    for _, mod in _projections(model):
        for t in (mod.base.weight, getattr(mod.base, "weight_scale", None)):
            if t is not None:
                n += t.numel() * t.element_size()
    return n


# ---------------------------------------------------------------------------
# Generation (KV-cache serving)
# ---------------------------------------------------------------------------

def init_cache(model: LlamaModel, batch_size: int, max_len: int) -> KVCache:
    """Zeroed KV cache, ``[batch, kv_heads, max_len, head_dim]`` per layer
    (the model's own ``kv_heads``: a tensor-parallel rank's share),
    in the model's dtype on the model's device, with its fill index on
    the host and on the device (``idx_dev``)."""
    c = model.cfg
    shape = (batch_size, model.kv_heads, max_len, c.head_dim)

    def zeros():
        return torch.zeros(shape, dtype=model.dtype, device=model.device)

    return KVCache([zeros() for _ in range(c.num_layers)],
                   [zeros() for _ in range(c.num_layers)],
                   idx_dev=torch.zeros((), dtype=torch.int64,
                                       device=model.device))


#: the kernel wrappers whose ``launches`` count CUDA launches, and the
#: tensor-parallel model's dispatch counts of the decode kernels
#: (``parallel.sharding.head_sharded_kernel``); a replayed step adds what
#: its capture counted (``core.runtime.StepGraph``)
LAUNCH_COUNTED = (flash_attention_fwd, fd.flash_decode,
                  pfd.paged_flash_decode,
                  dispatch_counter("flash_decode"),
                  dispatch_counter("paged_flash_decode"))


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
    """One token per row at ``cache.idx`` → its logits ``[B, V]`` f32: the
    step that :func:`_decode` replays from a CUDA graph on the card, and
    the eager step."""
    return model(tok[:, None], cache=cache, pad_lens=pad_lens)[:, -1]


def _decode(model, cache, last_logits, generator, pad_lens=None, *,
            max_new_tokens: int, temperature: float, top_k: int = 0,
            top_p: float = 1.0, eos_id: int | None = None):
    """One token per step → ``(tokens [B, max_new_tokens], n_steps)``.

    Each step emits the token already sampled and runs the model on it to
    sample the next, as the JAX loop does, so ``n_steps`` model steps run.
    Without ``eos_id`` that is exactly ``max_new_tokens``. With it the loop
    stops as soon as every row has emitted eos (one host sync a step,
    outside the step); unwritten slots hold eos_id.

    Every step is :func:`_decode_step` through a
    ``core.runtime.CompileCache`` of this call, keyed by the cache's
    (batch, max_len, dtype): on the card the first step is captured into
    a CUDA graph and the rest replay it; on the CPU each runs eagerly
    through the same static buffers. The graph is released on return."""
    graphs = CompileCache()
    key = (tuple(cache.k[0].shape), str(cache.k[0].dtype), id(cache))
    step_fn = functools.partial(_decode_step, model, cache)

    def step(tok):
        check_fill(cache, 1)
        n = cache.idx
        logits = graphs.get("decode_step", key, step_fn, (tok, pad_lens),
                            LAUNCH_COUNTED)
        cache.idx = n + 1  # a replay leaves the host index to its caller
        return _sample(logits, generator, temperature, top_k, top_p)

    tok = _sample(last_logits, generator, temperature, top_k, top_p)
    try:
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
    finally:
        graphs.drop()


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


# ---------------------------------------------------------------------------
# Slot-level serving primitives (continuous batching — serving.engine)
# ---------------------------------------------------------------------------
# generate() runs whole batches in lockstep. The primitives below are the
# per-SLOT halves the in-flight batching engine composes instead: a
# refill writes one new request's cache into one row of a shared slot
# cache (the other rows' in-flight state untouched), and a decode step
# advances EVERY slot one token at its own fill index. The caches are
# written in place; slot, offset and fill indices are plain arguments.


@torch.no_grad()
def prefill_into_slot(model: LlamaModel, prompt_ids, pad_len, cache: KVCache,
                      slot: int, generator=None, *, temperature: float = 0.0,
                      top_k: int = 0, top_p: float = 1.0):
    """Prefill ONE request into row ``slot`` of the engine's slot cache
    (the blocking whole-prompt refill).

    ``prompt_ids``: ``[1, Lb]``, left-padded to the engine's bucket
    length (``pad_len``: ``[1]`` — the :func:`left_pad_prompts`
    contract). The prompt runs the standard first-chunk prefill (the
    flash kernel when the model's attention resolves to it) against the
    row's first ``Lb`` positions, which it writes in place — compute is
    O(Lb²), never O(Lb·max_len), and positions count from the first real
    token exactly as in ``generate()``, so a refilled slot's logits are
    those of a fresh static run of the same prompt. Returns the first
    sampled token, ``[1]``."""
    lb = prompt_ids.shape[1]
    row = KVCache([k[slot:slot + 1, :, :lb] for k in cache.k],
                  [v[slot:slot + 1, :, :lb] for v in cache.v])
    logits = model(prompt_ids, cache=row, pad_lens=pad_len, first_chunk=True,
                   last_only=True)
    return _sample(logits[:, -1].float(), generator, temperature, top_k,
                   top_p)


@torch.no_grad()
def prefill_chunk_into_slot(model: LlamaModel, chunk_ids, cache: KVCache,
                            slot: int, offset: int, n_valid: int,
                            generator=None, *, window: int | None = None,
                            temperature: float = 0.0, top_k: int = 0,
                            top_p: float = 1.0):
    """Consume ``C`` prompt tokens of ONE request into row ``slot`` at
    cache positions ``[offset, offset + C)`` — the stall-free engine's
    chunk primitive, interleaved with :func:`slot_decode_step` so a
    refill never monopolizes the device.

    ``chunk_ids``: ``[1, C]``, **zero-aligned** (token ``i`` at cache
    position ``i``, no left pad); the FINAL chunk right-pads and
    ``n_valid`` names its real tokens. The pad tail's K/V rows are
    written but harmless (causality bounds every real query, and the
    decode step overwrites position ``L`` first). ``window`` (default the
    full row) bounds the rows the chunk attends: the caller passes the
    request's chunk-aligned prompt length. The chunk runs the model's
    multi-call cache path (dense attention over the window) against the
    slot's own row, written in place. Returns the token sampled at the
    last REAL position, ``[1]`` — meaningful on the final chunk."""
    w = cache.k[0].shape[2] if window is None \
        else min(int(window), cache.k[0].shape[2])
    row = KVCache([k[slot:slot + 1, :, :w] for k in cache.k],
                  [v[slot:slot + 1, :, :w] for v in cache.v], idx=offset)
    logits = model(chunk_ids, cache=row)
    last = logits[:, max(int(n_valid) - 1, 0)]
    return _sample(last.float(), generator, temperature, top_k, top_p)


@torch.no_grad()
def slot_decode_logits(model: LlamaModel, cache: KVCache, tokens, slot_cur,
                       pad_lens):
    """The model half of :func:`slot_decode_step`, ``[num_slots, V]``
    f32: the step the serving backend replays from a CUDA graph."""
    return model(tokens[:, None], cache=cache, pad_lens=pad_lens,
                 slot_cur=slot_cur)[:, -1].float()


@torch.no_grad()
def slot_decode_step(model: LlamaModel, cache: KVCache, tokens, slot_cur,
                     pad_lens, generator=None, *, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 1.0):
    """One in-flight decode iteration: every slot advances one token at
    its OWN fill index. ``tokens`` ``[num_slots]`` (idle slots' values
    are irrelevant — their output is discarded host-side); ``slot_cur``
    ``[num_slots]`` per-slot fill indices (the token writes there and
    attends ``[pad_lens[r], slot_cur[r]]``). Returns the next tokens,
    ``[num_slots]``."""
    return _sample(slot_decode_logits(model, cache, tokens, slot_cur,
                                      pad_lens),
                   generator, temperature, top_k, top_p)


@torch.no_grad()
def slot_verify_step(model: LlamaModel, cache: KVCache, tokens, slot_cur,
                     pad_lens):
    """The speculative VERIFY window: one batched forward checks k
    drafted tokens per slot. ``tokens`` ``[num_slots, k+1]`` — column 0
    is each slot's current token, columns 1..k its drafts. Row r writes
    its k+1 K/V rows at ``[slot_cur[r], slot_cur[r]+k]`` (writes past
    ``max_len`` are dropped) and query i attends ``[pad_lens[r],
    slot_cur[r]+i]``; rejected rows sit past the new frontier and are
    overwritten before any attention reads them, so reject is a pure
    host-side ``cur`` non-advance. Returns the greedy proposals
    ``[num_slots, k+1]``: ``proposals[r, i]`` is the token the target
    emits after ``tokens[r, :i+1]``."""
    logits = model(tokens, cache=cache, pad_lens=pad_lens, slot_cur=slot_cur)
    return logits.float().argmax(-1)


# ---------------------------------------------------------------------------
# Paged slot primitives (block-table serving)
# ---------------------------------------------------------------------------
# The primitives above address a PRIVATE [num_slots, ..., max_len, ...]
# cache row per slot. The paged variants address ONE shared pool of
# [pool_blocks, Hkv, block_size, hd] K/V blocks per layer through a
# per-slot block TABLE ([max_blocks] ints): logical cache position p of a
# slot lives at pool position (table[p // block_size], p % block_size).
# The decode / verify primitives hand the pool and the tables straight
# to the model: each layer writes only the new positions through the
# table and attends the pool THROUGH the table (the paged flash-decode
# kernel, ops.paged_flash_decode), so per-step traffic is O(cur) per
# slot. The chunk / whole-prompt prefill primitives attend a
# window-bounded gathered view (prefill is compute-bound).


def paged_pool_spec(model: LlamaModel, pool_blocks: int, block_size: int,
                    kv_quant: str | None = None) -> list:
    """``(shape, dtype)`` of every tensor of the paged pool — the single
    source of truth for allocation (:func:`init_paged_pool`) AND byte
    accounting (``serving.backend.pool_bytes_per_block``). With
    ``kv_quant`` ('int8'/'fp8') the K/V leaves store codes in the quant
    dtype and every layer gains a ``kv_scale`` ``[pool_blocks, Hkv, 2]``
    f32 plane (``[..., 0]`` = K scales, ``[..., 1]`` = V)."""
    c = model.cfg
    shape = (int(pool_blocks), model.kv_heads, int(block_size), c.head_dim)
    dt = model.dtype if kv_quant is None else kv_quant_spec(kv_quant)[0]
    spec = [(shape, dt)] * (2 * c.num_layers)
    if kv_quant is not None:
        spec += [((int(pool_blocks), model.kv_heads, 2),
                  torch.float32)] * c.num_layers
    return spec


def init_paged_pool(model: LlamaModel, pool_blocks: int, block_size: int,
                    kv_quant: str | None = None) -> KVCache:
    """Zeroed shared K/V pool: per layer ``[pool_blocks, kv_heads,
    block_size, head_dim]`` — structurally an :func:`init_cache` with
    batch=pool_blocks and max_len=block_size, which is exactly the
    block-major paged layout. Block 0 is the trash block
    (``serving.paging.BlockAllocator``): idle slots' tables point at it,
    so masked garbage writes land where no request reads. ``kv_quant``
    stores K/V as codes with a per-block ``kv_scale`` plane
    (:func:`paged_pool_spec`)."""
    spec = paged_pool_spec(model, pool_blocks, block_size, kv_quant)
    n = model.cfg.num_layers
    made = [torch.zeros(s, dtype=dt, device=model.device) for s, dt in spec]
    return KVCache(made[:n], made[n:2 * n],
                   kv_scale=made[2 * n:] if kv_quant is not None else None)


def _gather_view(pool: KVCache, tables) -> KVCache:
    """Dense per-slot cache view through the block tables: ``[P, Hkv,
    bs, hd]`` pool leaves + ``[S, MB]`` tables → ``[S, Hkv, MB*bs, hd]``
    rows per layer. A quantized pool yields the DEQUANTIZED f32 view
    (codes·per-block scale). The reference the equivalence tests compare
    against; the serving paths read through the tables instead."""
    planes = pool.kv_scale or [None] * len(pool.k)
    return KVCache(
        [pfd.gathered_view(k, tables, p, 0) for k, p in zip(pool.k, planes)],
        [pfd.gathered_view(v, tables, p, 1) for v, p in zip(pool.v, planes)])


def _pool_insert(pool: KVCache, i: int, blk, off, k_rows, v_rows) -> None:
    """Write ``[N, Hkv, hd]`` K/V rows of layer ``i`` at pool positions
    ``(blk[n], off[n])``, quantizing into a codes pool. Duplicate
    (block, offset) pairs occur only on the trash block 0."""
    if pool.kv_scale is None:
        pool.k[i][blk, :, off] = k_rows.to(pool.k[i].dtype)
        pool.v[i][blk, :, off] = v_rows.to(pool.v[i].dtype)
    else:
        _quant_insert_rows(pool.k[i], pool.kv_scale[i], 0, blk, off, k_rows)
        _quant_insert_rows(pool.v[i], pool.kv_scale[i], 1, blk, off, v_rows)


@torch.no_grad()
def paged_slot_decode_step(model: LlamaModel, pool: KVCache, tables, tokens,
                           slot_cur, pad_lens, generator=None, *,
                           temperature: float = 0.0, top_k: int = 0,
                           top_p: float = 1.0):
    """One in-flight decode iteration over the BLOCK-TABLE cache: every
    slot advances one token at its own fill index, reading its cache
    through ``tables`` (``[num_slots, max_blocks]``) and writing exactly
    its one new position into the pool. Idle or block-stalled slots'
    writes land at whatever their table names at the frontier — the
    engine parks those entries on the trash block. Attention runs in the
    paged flash-decode kernel (no gathered view exists), or over the
    gathered view where the caller turned the kernel off. Returns the
    next tokens, ``[num_slots]``."""
    return _sample(paged_slot_decode_logits(model, pool, tables, tokens,
                                            slot_cur, pad_lens),
                   generator, temperature, top_k, top_p)


@torch.no_grad()
def paged_slot_decode_logits(model: LlamaModel, pool: KVCache, tables,
                             tokens, slot_cur, pad_lens):
    """The model half of :func:`paged_slot_decode_step`, ``[num_slots,
    V]`` f32: the step the paged backend replays from a CUDA graph."""
    return model(tokens[:, None], cache=pool, pad_lens=pad_lens,
                 slot_cur=slot_cur, block_tables=tables)[:, -1].float()


@torch.no_grad()
def paged_slot_verify_step(model: LlamaModel, pool: KVCache, tables, tokens,
                           slot_cur, pad_lens):
    """:func:`slot_verify_step` through the block tables: row r's k+1
    positions write through ``tables`` into the pool (the engine
    allocated the window's growth blocks up front; a position whose
    block it could not serve routes to the trash block 0 and its
    proposal is never committed), and attention reads the pool through
    the tables exactly like :func:`paged_slot_decode_step` — the paged
    kernel covers this S = k+1 window too. Returns the greedy proposals
    ``[num_slots, k+1]``."""
    logits = model(tokens, cache=pool, pad_lens=pad_lens, slot_cur=slot_cur,
                   block_tables=tables)
    return logits.float().argmax(-1)


@torch.no_grad()
def paged_prefill_chunk_into_slot(model: LlamaModel, chunk_ids,
                                  pool: KVCache, table_row, offset: int,
                                  n_valid: int, generator=None, *,
                                  window: int, temperature: float = 0.0,
                                  top_k: int = 0, top_p: float = 1.0):
    """:func:`prefill_chunk_into_slot` through a block table: consume
    ``C`` zero-aligned prompt tokens at logical positions ``[offset,
    offset + C)`` of the slot whose table is ``table_row`` (``[MB]``).
    The chunk attends a dense (dequantized) view of the table's first
    ``ceil(window / block_size)`` blocks and scatters only its own REAL
    positions back through the table, so a grafted shared-prefix block
    is READ here, never written. A window past the table (a resume
    whose chunk-aligned length exceeds max_len) pads the view with
    scratch rows instead of sliding the write back over committed rows.
    No kernel runs here: the chunk attends the view densely, as in the
    JAX package. Returns the last-real-position sample ``[1]``."""
    bs = pool.k[0].shape[2]
    c = chunk_ids.shape[1]
    wb = -(-int(window) // bs)
    mbv = min(wb, table_row.shape[0])

    def view(leaf, plane, ch):
        v = pfd.gathered_view(leaf, table_row[None, :mbv], plane, ch).to(
            model.dtype)                           # [1, Hkv, mbv*bs, hd]
        if wb > mbv:
            v = torch.cat([v, v.new_zeros((1, leaf.shape[1], (wb - mbv) * bs,
                                           leaf.shape[3]))], dim=2)
        return v

    planes = pool.kv_scale or [None] * len(pool.k)
    row = KVCache([view(k, p, 0) for k, p in zip(pool.k, planes)],
                  [view(v, p, 1) for v, p in zip(pool.v, planes)],
                  idx=int(offset))
    logits = model(chunk_ids, cache=row)
    pos = int(offset) + torch.arange(c, device=table_row.device)
    bi = pos // bs
    # Only REAL tokens' rows persist: the final chunk's pad tail and
    # anything past the table route to the trash block 0 — never clamp
    # onto a live block.
    real = (pos < int(offset) + int(n_valid)) & (bi < table_row.shape[0])
    blk = _table_blocks(table_row, bi, real)
    off = pos % bs
    for i in range(len(pool.k)):
        new_k = row.k[i][0, :, offset:offset + c].transpose(0, 1)
        new_v = row.v[i][0, :, offset:offset + c].transpose(0, 1)
        _pool_insert(pool, i, blk, off, new_k, new_v)
    last = logits[:, max(int(n_valid) - 1, 0)]
    return _sample(last.float(), generator, temperature, top_k, top_p)


@torch.no_grad()
def paged_prefill_into_slot(model: LlamaModel, prompt_ids, pad_len,
                            pool: KVCache, table_row, generator=None, *,
                            temperature: float = 0.0, top_k: int = 0,
                            top_p: float = 1.0):
    """:func:`prefill_into_slot` through a block table — the blocking
    (whole-prompt, left-padded bucket) refill for paged backends: the
    prompt runs the first-chunk prefill (the flash kernel when the
    model's attention resolves to it) against a private ``[1, Lb]``
    scratch cache, then every one of its ``Lb`` rows scatters to the
    pool position the table names (left-pad rows included — masked
    garbage, as in the per-slot variant). Returns the first token
    ``[1]``."""
    bs = pool.k[0].shape[2]
    lb = prompt_ids.shape[1]
    small = init_cache(model, 1, lb)
    logits = model(prompt_ids, cache=small, pad_lens=pad_len,
                   first_chunk=True, last_only=True)
    pos = torch.arange(lb, device=table_row.device)
    blk = table_row.long()[pos // bs]
    off = pos % bs
    for i in range(len(pool.k)):
        _pool_insert(pool, i, blk, off, small.k[i][0].transpose(0, 1),
                     small.v[i][0].transpose(0, 1))
    return _sample(logits[:, -1].float(), generator, temperature, top_k,
                   top_p)


@torch.no_grad()
def copy_pool_block(pool: KVCache, src: int, dst: int) -> None:
    """Copy one physical block's K/V (every layer) in place — the paged
    copy-on-write primitive: a write that would land in a SHARED block
    (refcount >= 2 after a radix graft) first duplicates it so the other
    holders keep reading the original. A quantized pool's scale planes
    copy with their codes, so the duplicate dequantizes bit-identically
    to the original."""
    for t in pool.tensors():
        t[dst] = t[src]


# ---------------------------------------------------------------------------
# LoRA training utilities
# ---------------------------------------------------------------------------

def lora_mask(model: nn.Module) -> dict:
    """Parameter name → True for the LoRA adapters (``lora_a`` /
    ``lora_b``, trainable), False for every base weight (frozen)."""
    return {name: ("lora_a" in name or "lora_b" in name)
            for name, _ in model.named_parameters()}


def lora_optimizer(learning_rate: float = 1e-4):
    """Adam on the LoRA adapters only; the base weights are frozen.

    Returns the optimizer's factory, ``model → torch.optim.Adam``, which
    :class:`runner.train_state.TrainState` calls: it sets
    ``requires_grad=False`` on every base weight (so no gradient is even
    computed for them, and they stay bit-identical through training, as
    the JAX package's ``set_to_zero`` keeps them) and builds Adam over the
    adapters with optax's defaults, betas (0.9, 0.999) and eps 1e-8."""
    def make(model: nn.Module) -> torch.optim.Optimizer:
        mask = lora_mask(model)
        train = []
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
            if mask[name]:
                train.append(p)
        if not train:
            raise ValueError("lora_optimizer: the model has no LoRA adapters "
                             "(LlamaConfig(lora_rank=0))")
        return torch.optim.Adam(train, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)

    return make


def causal_lm_loss_fn():
    """Next-token loss for ``RunnerContext.fit``: ``loss_fn(model, batch)``
    with batch = ``{"input_ids": [B, S]}`` (labels = input_ids shifted
    left; the last position dropped). Logits in f32; returns ``(loss,
    {"perplexity": exp(loss)})``."""
    def loss_fn(model, batch):
        ids = batch["input_ids"]
        logits = model(ids)[:, :-1].float()
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               ids[:, 1:].reshape(-1))
        return loss, {"perplexity": torch.exp(loss)}

    return loss_fn
