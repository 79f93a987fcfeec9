"""Foreign pretrained-checkpoint importers — name-mapping external layouts
onto the flax-layout trees the port's weight bridges load — and the
serving-weights cast.

The port's copy of ``sparkdl_tpu/models/pretrained.py``. Each importer
returns what the reference's returns: the reference's flax-layout tree of
numpy arrays (``{"params": ...}``, or ``{"params", "batch_stats"}`` for
the image zoo), which the port's models load through
``models.llama.load_flax_params``, ``models.bert.load_flax_params`` and
``models.registry.load_flax_variables``. The supported foreign layouts:

- **HuggingFace-layout safetensors** for Llama (``model.layers.N.self_attn.
  q_proj.weight`` …) and BERT (``bert.encoder.layer.N.attention.self.query.
  weight`` …). Linear weights are torch ``[out, in]`` and transpose to
  flax ``[in, out]``; Llama q/k projections additionally permute head
  dims from HF's half-split rotary convention to the interleaved one
  ``models.llama`` uses (see ``_rope_permutation``). Published files hold
  bf16: numpy has no bf16, so a path is read with
  ``safetensors.torch.load_file`` and bf16 tensors widen to f32, which is
  exact.
- **Keras-layout ``.h5``** (both the legacy ``layer_names`` topological
  format of the published keras-applications ImageNet files and the
  Keras-3 ``.weights.h5`` format) for the image zoo → ``models/resnet.py``
  / ``vgg.py`` / ``inception.py`` / ``xception.py`` trees. Conv biases
  present in keras ResNet files are folded into the following BatchNorm's
  moving mean (exact under eval-mode BN; a bias preceding train-mode BN
  is a no-op); separable convs transpose keras' (h,w,in,1) depthwise
  kernels to flax's (h,w,1,in). ``h5py`` is imported inside
  :func:`read_keras_h5` only.

Everything runs offline on locally-provided files. The image templates
are the port module's own weights in flax layout
(``registry.state_dict_to_flax``).
"""

from __future__ import annotations

import copy
import re
from typing import Mapping

import numpy as np
import torch
from torch import nn


class CheckpointMismatch(ValueError):
    """A foreign checkpoint doesn't match the target model/config."""


def _to_numpy(v) -> np.ndarray:
    """A torch tensor or array-like as numpy; bf16 widens to f32 (exact),
    since numpy has no bf16."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def _as_state_dict(path_or_state) -> dict[str, np.ndarray]:
    """Accept a safetensors path or an already-loaded ``{name: array}``
    dict (numpy arrays or torch tensors); bf16 leaves widen to f32."""
    if isinstance(path_or_state, str):
        from safetensors.torch import load_file
        loaded = load_file(path_or_state)
        # one tensor at a time: the bf16 copy goes as its f32 one lands
        return {k: _to_numpy(loaded.pop(k)) for k in list(loaded)}
    return {k: _to_numpy(v) for k, v in path_or_state.items()}

def _t(w: np.ndarray) -> np.ndarray:
    """torch Linear [out, in] → flax Dense kernel [in, out]."""
    return np.ascontiguousarray(np.asarray(w).T)


def _take(state: dict, key: str, shape=None) -> np.ndarray:
    try:
        w = state.pop(key)
    except KeyError:
        raise CheckpointMismatch(
            f"checkpoint is missing {key!r}; present keys start with "
            f"{sorted(state)[:3]}") from None
    if shape is not None and tuple(w.shape) != tuple(shape):
        raise CheckpointMismatch(
            f"{key}: checkpoint shape {tuple(w.shape)} != "
            f"model shape {tuple(shape)}")
    return np.asarray(w)


# ---------------------------------------------------------------------------
# HF Llama
# ---------------------------------------------------------------------------

def _rope_permutation(head_dim: int) -> np.ndarray:
    """Per-head output-dim permutation HF→interleaved.

    HF checkpoints pair rotary dims as (j, j+d/2) (``rotate_half``); this
    repo's :func:`models.llama.rope` pairs (2j, 2j+1). Both use frequency
    ``theta^(-2j/d)`` for pair j, so remapping dim ``2j ← j`` and
    ``2j+1 ← j+d/2`` makes attention outputs identical (q·k inner products
    are invariant under a shared per-head permutation of q and k).
    """
    half = head_dim // 2
    perm = np.empty(head_dim, dtype=np.int64)
    perm[0::2] = np.arange(half)
    perm[1::2] = np.arange(half, head_dim)
    return perm


def _permute_rope_rows(w: np.ndarray, n_heads: int) -> np.ndarray:
    """Apply the HF→interleaved permutation to a [heads*hd, in] torch
    weight's output rows, per head."""
    out, inner = w.shape
    hd = out // n_heads
    perm = _rope_permutation(hd)
    return w.reshape(n_heads, hd, inner)[:, perm, :].reshape(out, inner)


def import_hf_llama(path_or_state, cfg) -> dict:
    """HF-layout Llama safetensors → ``{"params": ...}`` for
    :class:`models.llama.LlamaModel` built with ``cfg``.

    Accepts both ``model.layers...``-prefixed (LlamaForCausalLM) and bare
    ``layers...`` (LlamaModel) key styles. A missing ``lm_head.weight``
    (tied-embedding checkpoints) falls back to the token embedding.
    LoRA adapter leaves (``cfg.lora_rank > 0``) are NOT expected in the
    file — import the base weights, then fine-tune adapters from zero
    (flax initializes them on first apply via ``init``; merge trees with
    :func:`merge_into_template`).
    """
    state = _as_state_dict(path_or_state)
    if any(k.startswith("model.") for k in state):
        state = {k[len("model."):] if k.startswith("model.") else k: v
                 for k, v in state.items()}

    hs, hd = cfg.hidden_size, cfg.head_dim
    q_out = cfg.num_heads * hd
    kv_out = cfg.num_kv_heads * hd
    params: dict = {}

    emb = _take(state, "embed_tokens.weight", (cfg.vocab_size, hs))
    params["embed_tokens"] = {"embedding": emb}

    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        attn = {
            "q_proj": {"base": {"kernel": _t(_permute_rope_rows(
                _take(state, p + "self_attn.q_proj.weight", (q_out, hs)),
                cfg.num_heads))}},
            "k_proj": {"base": {"kernel": _t(_permute_rope_rows(
                _take(state, p + "self_attn.k_proj.weight", (kv_out, hs)),
                cfg.num_kv_heads))}},
            "v_proj": {"base": {"kernel": _t(
                _take(state, p + "self_attn.v_proj.weight", (kv_out, hs)))}},
            "o_proj": {"base": {"kernel": _t(
                _take(state, p + "self_attn.o_proj.weight", (hs, q_out)))}},
        }
        mlp = {
            "gate_proj": {"base": {"kernel": _t(_take(
                state, p + "mlp.gate_proj.weight",
                (cfg.intermediate_size, hs)))}},
            "up_proj": {"base": {"kernel": _t(_take(
                state, p + "mlp.up_proj.weight",
                (cfg.intermediate_size, hs)))}},
            "down_proj": {"base": {"kernel": _t(_take(
                state, p + "mlp.down_proj.weight",
                (hs, cfg.intermediate_size)))}},
        }
        params[f"layer_{i}"] = {
            "attn": attn,
            "mlp": mlp,
            "attn_norm": {"scale": _take(
                state, p + "input_layernorm.weight", (hs,))},
            "mlp_norm": {"scale": _take(
                state, p + "post_attention_layernorm.weight", (hs,))},
        }

    params["final_norm"] = {"scale": _take(state, "norm.weight", (hs,))}
    if "lm_head.weight" in state:
        params["lm_head"] = {"kernel": _t(_take(
            state, "lm_head.weight", (cfg.vocab_size, hs)))}
    else:  # tied embeddings
        params["lm_head"] = {"kernel": np.ascontiguousarray(emb.T)}

    leftovers = [k for k in state if not k.endswith("rotary_emb.inv_freq")]
    if leftovers:
        raise CheckpointMismatch(
            f"{len(leftovers)} unconsumed checkpoint keys, "
            f"e.g. {sorted(leftovers)[:3]} — config mismatch?")
    return {"params": params}


# ---------------------------------------------------------------------------
# HF BERT
# ---------------------------------------------------------------------------

def _hf_ln(state: dict, prefix: str, width: int) -> dict:
    """HF LayerNorm → flax {scale, bias}; tolerates old gamma/beta names."""
    if prefix + ".gamma" in state:
        return {"scale": _take(state, prefix + ".gamma", (width,)),
                "bias": _take(state, prefix + ".beta", (width,))}
    return {"scale": _take(state, prefix + ".weight", (width,)),
            "bias": _take(state, prefix + ".bias", (width,))}


def _hf_dense(state: dict, prefix: str, in_w: int, out_w: int) -> dict:
    return {"kernel": _t(_take(state, prefix + ".weight", (out_w, in_w))),
            "bias": _take(state, prefix + ".bias", (out_w,))}


_IGNORED_BERT = re.compile(r"(^|\.)(cls\.|seq_relationship|position_ids$)")


def _check_consumed(state: dict, ignore: re.Pattern = _IGNORED_BERT):
    leftovers = [k for k in state if not ignore.search(k)]
    if leftovers:
        raise CheckpointMismatch(
            f"{len(leftovers)} unconsumed checkpoint keys, "
            f"e.g. {sorted(leftovers)[:3]} — config mismatch?")


def import_hf_bert(path_or_state, cfg, num_classes: int | None = None) -> dict:
    """HF-layout BERT safetensors → ``{"params": ...}``.

    With ``num_classes`` the result fits
    :class:`models.bert.BertForSequenceClassification` (a matching
    ``classifier.weight`` in the file is used, otherwise the head is
    zero-initialized — the HF fine-tuning convention); without it, a bare
    :class:`models.bert.BertEncoder` tree is returned.
    """
    state = _as_state_dict(path_or_state)
    for pref in ("bert.", "model."):
        if any(k.startswith(pref + "embeddings.") for k in state):
            state = {(k[len(pref):] if k.startswith(pref) else k): v
                     for k, v in state.items()}
            break
    hs = cfg.hidden_size

    bert: dict = {
        "word_embeddings": {"embedding": _take(
            state, "embeddings.word_embeddings.weight",
            (cfg.vocab_size, hs))},
        "position_embeddings": {"embedding": _take(
            state, "embeddings.position_embeddings.weight",
            (cfg.max_position_embeddings, hs))},
        "token_type_embeddings": {"embedding": _take(
            state, "embeddings.token_type_embeddings.weight",
            (cfg.type_vocab_size, hs))},
        "embeddings_norm": _hf_ln(state, "embeddings.LayerNorm", hs),
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        bert[f"layer_{i}"] = {
            "attention": {
                "query": _hf_dense(state, p + "attention.self.query", hs, hs),
                "key": _hf_dense(state, p + "attention.self.key", hs, hs),
                "value": _hf_dense(state, p + "attention.self.value", hs, hs),
                "attention_output": _hf_dense(
                    state, p + "attention.output.dense", hs, hs),
            },
            "attention_norm": _hf_ln(
                state, p + "attention.output.LayerNorm", hs),
            "intermediate": _hf_dense(
                state, p + "intermediate.dense", hs, cfg.intermediate_size),
            "output_dense": _hf_dense(
                state, p + "output.dense", cfg.intermediate_size, hs),
            "output_norm": _hf_ln(state, p + "output.LayerNorm", hs),
        }
    bert["pooler"] = _hf_dense(state, "pooler.dense", hs, hs)

    if num_classes is None:
        _check_consumed(state)
        return {"params": bert}

    if "classifier.weight" in state \
            and state["classifier.weight"].shape[0] == num_classes:
        head = _hf_dense(state, "classifier", hs, num_classes)
    else:
        state.pop("classifier.weight", None)
        state.pop("classifier.bias", None)
        head = {"kernel": np.zeros((hs, num_classes), np.float32),
                "bias": np.zeros((num_classes,), np.float32)}
    _check_consumed(state)
    return {"params": {"bert": bert, "classifier": head}}


# ---------------------------------------------------------------------------
# Keras .h5 reading (legacy topological + Keras-3 .weights.h5)
# ---------------------------------------------------------------------------

def read_keras_h5(path: str) -> dict[str, list[np.ndarray]]:
    """Read a Keras weights file → {layer_name: [arrays in save order]}.

    Handles the legacy topological format of the published
    keras-applications ImageNet files (root attr ``layer_names``, per-layer
    attr ``weight_names``) and the Keras-3 ``.weights.h5`` layout
    (``_layer_checkpoint_dependencies/<name>/vars/<i>``).
    """
    import h5py
    out: dict[str, list[np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        if "layer_names" in root.attrs:  # legacy topological format
            for lname in root.attrs["layer_names"]:
                lname = lname.decode() if isinstance(lname, bytes) else lname
                g = root[lname]
                weights = []
                for wname in g.attrs.get("weight_names", []):
                    wname = (wname.decode()
                             if isinstance(wname, bytes) else wname)
                    weights.append(np.asarray(g[wname]))
                if weights:
                    out[lname.split("/")[-1]] = weights
            return out
        deps = "_layer_checkpoint_dependencies"
        if deps in root:  # Keras-3 format
            def walk(group, name):
                for child, item in group.items():
                    if child == "vars" and len(item):
                        out[name] = [np.asarray(item[str(i)])
                                     for i in range(len(item))]
                    elif hasattr(item, "items"):
                        walk(item, child)
            walk(root[deps], "")
            return out
    raise CheckpointMismatch(f"{path}: unrecognized Keras weights layout")


def _keras_convbn(layers: Mapping[str, list], conv_name: str, bn_name: str):
    """One keras conv+bn pair → (conv_params, bn_params, bn_stats).

    A conv bias (keras-applications ResNet convs have one; this repo's
    conv-bn units don't) is folded into the BN moving mean — exact under
    eval-mode BN, and a bias feeding train-mode BN is mathematically inert.
    BN saved with ``scale=False`` (keras InceptionV3) gets scale=1.
    """
    if conv_name not in layers:
        raise CheckpointMismatch(f"Keras file has no layer {conv_name!r}")
    if bn_name not in layers:
        raise CheckpointMismatch(f"Keras file has no layer {bn_name!r}")
    cw = list(layers[conv_name])
    kernel = np.asarray(cw[0])  # keras HWIO == flax HWIO
    bias = np.asarray(cw[1]) if len(cw) > 1 else None
    bw = list(layers[bn_name])
    if len(bw) == 4:
        gamma, beta, mean, var = (np.asarray(a) for a in bw)
    elif len(bw) == 3:  # scale=False
        beta, mean, var = (np.asarray(a) for a in bw)
        gamma = np.ones_like(beta)
    else:
        raise CheckpointMismatch(
            f"{bn_name}: expected 3 or 4 BN arrays, got {len(bw)}")
    if bias is not None:
        mean = mean - bias
    return ({"kernel": kernel}, {"scale": gamma, "bias": beta},
            {"mean": mean, "var": var})


def _keras_dense(layers: Mapping[str, list], name: str) -> dict:
    if name not in layers:
        raise CheckpointMismatch(f"Keras file has no layer {name!r}")
    w = layers[name]
    leaf = {"kernel": np.asarray(w[0])}  # keras Dense kernel is [in, out]
    if len(w) > 1:
        leaf["bias"] = np.asarray(w[1])
    return leaf


def _leaves_with_path(tree, prefix=()):
    """(key path, leaf) of a nested dict, keys in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves_with_path(v, prefix + (str(k),))
        elif v is not None:
            yield prefix + (str(k),), v


def _check_tree_shapes(got: dict, template: dict, where: str = ""):
    """Every template leaf must exist in ``got`` with the same shape."""
    gleaves = {p: np.shape(v) for p, v in _leaves_with_path(got)}
    for key, tv in _leaves_with_path(template):
        if key not in gleaves:
            raise CheckpointMismatch(f"{where}: import missed {key}")
        if tuple(gleaves[key]) != tuple(np.shape(tv)):
            raise CheckpointMismatch(
                f"{where}: {'/'.join(key)} imported shape {gleaves[key]} "
                f"!= model shape {tuple(np.shape(tv))}")


# ---------------------------------------------------------------------------
# Keras → image-zoo trees
# ---------------------------------------------------------------------------

_KERAS_RESNET_STAGES = {"ResNet50": (3, 4, 6, 3), "ResNet101": (3, 4, 23, 3),
                        "ResNet152": (3, 8, 36, 3)}


def import_keras_resnet(path: str, template: dict,
                        name: str = "ResNet50") -> dict:
    """Keras-layout ResNet{50,101,152} ``.h5`` → ``models/resnet.py`` tree.

    Name mapping: ``conv1_conv``/``conv1_bn`` → ``stem_conv``/``stem_bn``;
    ``conv{s+1}_block{b}_{k}_conv`` → ``stage{s}_block{b}/conv{k}``
    (``_0_conv``, the projection shortcut, → ``proj_conv``);
    ``predictions`` → ``head``.

    keras-applications ResNet is the v1 architecture (downsampling stride
    on the first 1x1 conv); this repo's default is v1.5 (stride on the
    3x3). Shapes are identical either way — build the model with
    ``stride_on_3x3=False`` for exact keras semantics.
    """
    if name not in _KERAS_RESNET_STAGES:
        raise CheckpointMismatch(
            f"No Keras .h5 layout exists for {name!r} — keras-applications "
            f"ships only {sorted(_KERAS_RESNET_STAGES)}")
    layers = read_keras_h5(path)
    params: dict = {}
    stats: dict = {}

    conv, bn, st = _keras_convbn(layers, "conv1_conv", "conv1_bn")
    params["stem_conv"], params["stem_bn"], stats["stem_bn"] = conv, bn, st

    for s, n_blocks in enumerate(_KERAS_RESNET_STAGES[name]):
        for b in range(n_blocks):
            kpre = f"conv{s + 2}_block{b + 1}"
            mine = f"stage{s + 1}_block{b + 1}"
            bp: dict = {}
            bs: dict = {}
            for k in (1, 2, 3):
                conv, bn, st = _keras_convbn(
                    layers, f"{kpre}_{k}_conv", f"{kpre}_{k}_bn")
                bp[f"conv{k}"], bp[f"bn{k}"], bs[f"bn{k}"] = conv, bn, st
            if f"{kpre}_0_conv" in layers:  # projection shortcut (block 1)
                conv, bn, st = _keras_convbn(
                    layers, f"{kpre}_0_conv", f"{kpre}_0_bn")
                bp["proj_conv"], bp["proj_bn"], bs["proj_bn"] = conv, bn, st
            params[mine], stats[mine] = bp, bs

    if "head" in template.get("params", {}):
        params["head"] = _keras_dense(
            layers, "predictions" if "predictions" in layers else "head")

    out = {"params": params, "batch_stats": stats}
    _check_tree_shapes(out, template, f"keras {name}")
    return out


def import_keras_vgg(path: str, template: dict) -> dict:
    """Keras-layout VGG16/19 ``.h5`` → ``models/vgg.py`` tree. Layer names
    (block1_conv1 … fc1, fc2, predictions→head) map 1:1; kernels are HWIO /
    [in, out] in both frameworks."""
    layers = read_keras_h5(path)
    params = {}
    for lname in template["params"]:
        src = lname
        if lname == "head" and "head" not in layers:
            src = "predictions"
        params[lname] = _keras_dense(layers, src)
    out = {"params": params}
    _check_tree_shapes(out, template, "keras VGG")
    return out


def _inception_conv_order() -> list[tuple[str, ...]]:
    """This repo's InceptionV3 ConvBN module paths in *creation order* —
    which matches keras-applications' conv2d_bn call order exactly (same
    branch order per mixed block, verified by the forward-equivalence
    test), so the file's auto-numbered conv2d_N/batch_normalization_N
    layers map by index."""
    order: list[tuple[str, ...]] = [(f"stem{i}",) for i in range(1, 6)]
    a = ["b1x1", "b5x5_1", "b5x5_2", "b3x3dbl_1", "b3x3dbl_2", "b3x3dbl_3",
         "bpool"]
    b = ["b3x3", "b3x3dbl_1", "b3x3dbl_2", "b3x3dbl_3"]
    c = ["b1x1", "b7x7_1", "b7x7_2", "b7x7_3", "b7x7dbl_1", "b7x7dbl_2",
         "b7x7dbl_3", "b7x7dbl_4", "b7x7dbl_5", "bpool"]
    d = ["b3x3_1", "b3x3_2", "b7x7x3_1", "b7x7x3_2", "b7x7x3_3", "b7x7x3_4"]
    e = ["b1x1", "b3x3_1", "b3x3_2a", "b3x3_2b", "b3x3dbl_1", "b3x3dbl_2",
         "b3x3dbl_3a", "b3x3dbl_3b", "bpool"]
    blocks = [a, a, a, b, c, c, c, c, d, e, e]
    for i, names in enumerate(blocks):
        order.extend((f"mixed{i}", n) for n in names)
    return order


def _numbered(layers: Mapping[str, list], stem: str) -> list[str]:
    """Layer names matching ``stem`` or ``stem_N``, sorted by N (creation
    order). The published InceptionV3 files number from 1; fresh keras
    sessions from 0/none — sorting by suffix handles both."""
    pat = re.compile(rf"^{re.escape(stem)}(?:_(\d+))?$")
    found = []
    for k in layers:
        m = pat.match(k)
        if m:
            found.append((int(m.group(1) or 0), k))
    return [k for _, k in sorted(found)]


def import_keras_inception(path: str, template: dict) -> dict:
    """Keras-layout InceptionV3 ``.h5`` → ``models/inception.py`` tree.

    The published file auto-numbers its conv/bn layers (conv2d_1, …); they
    are matched to this repo's ConvBN modules by creation order (see
    :func:`_inception_conv_order`). BN is saved with ``scale=False`` →
    scale=1.
    """
    layers = read_keras_h5(path)
    convs = _numbered(layers, "conv2d")
    bns = _numbered(layers, "batch_normalization")
    order = _inception_conv_order()
    if len(convs) != len(order) or len(bns) != len(order):
        raise CheckpointMismatch(
            f"InceptionV3 expects {len(order)} conv/bn pairs, file has "
            f"{len(convs)} convs / {len(bns)} bns")
    params: dict = {}
    stats: dict = {}

    def setd(root, p, leaf):
        for k in p[:-1]:
            root = root.setdefault(k, {})
        root[p[-1]] = leaf

    for path_, cname, bname in zip(order, convs, bns):
        conv, bn, st = _keras_convbn(layers, cname, bname)
        setd(params, path_ + ("conv",), conv)
        setd(params, path_ + ("bn",), bn)
        setd(stats, path_ + ("bn",), st)

    if "head" in template.get("params", {}):
        params["head"] = _keras_dense(
            layers, "predictions" if "predictions" in layers else "head")
    out = {"params": params, "batch_stats": stats}
    _check_tree_shapes(out, template, "keras InceptionV3")
    return out


def _keras_sepconv(layers: Mapping[str, list], sep_name: str,
                   bn_name: str):
    """One keras SeparableConv2D(+BN) → this repo's SeparableConvBN leaves.

    Keras stores [depthwise_kernel (h,w,in,1), pointwise_kernel] in ONE
    layer; flax's grouped-conv depthwise kernel is (h,w,1,in) — transpose
    the last two axes."""
    if sep_name not in layers:
        raise CheckpointMismatch(f"Keras file has no layer {sep_name!r}")
    w = layers[sep_name]
    if len(w) != 2:
        raise CheckpointMismatch(
            f"{sep_name}: expected [depthwise, pointwise], got {len(w)} "
            f"arrays (biased separable convs are not part of this layout)")
    dw = np.transpose(np.asarray(w[0]), (0, 1, 3, 2))
    pw = np.asarray(w[1])
    bw = list(layers.get(bn_name, ()))
    if len(bw) != 4:
        raise CheckpointMismatch(f"{bn_name}: expected 4 BN arrays")
    gamma, beta, mean, var = (np.asarray(a) for a in bw)
    return ({"depthwise": {"kernel": dw}, "pointwise": {"kernel": pw},
             "bn": {"scale": gamma, "bias": beta}},
            {"bn": {"mean": mean, "var": var}})


def import_keras_xception(path: str, template: dict) -> dict:
    """Keras-layout Xception ``.h5`` → ``models/xception.py`` tree.

    Named layers (block{i}_sepconv{j}, block1_conv{1,2}) map directly; the
    four residual 1x1 convs are auto-named (conv2d[_N]) and map by creation
    order: entry1, entry2, entry3, exit projections.
    """
    layers = read_keras_h5(path)
    params: dict = {}
    stats: dict = {}

    for i in (1, 2):
        conv, bn, st = _keras_convbn(layers, f"block1_conv{i}",
                                     f"block1_conv{i}_bn")
        params[f"stem_conv{i}"] = conv
        params[f"stem_bn{i}"] = bn
        stats[f"stem_bn{i}"] = st

    def sep_into(block: dict, bstats: dict, key: str, kname: str):
        p, s = _keras_sepconv(layers, kname, kname + "_bn")
        block[key] = p
        bstats[key] = s

    for i in (1, 2, 3):  # entry blocks ← keras block2..4
        bp: dict = {}
        bs: dict = {}
        for j in (1, 2):
            sep_into(bp, bs, f"sep{j}", f"block{i + 1}_sepconv{j}")
        params[f"entry{i}"], stats[f"entry{i}"] = bp, bs
    for i in range(1, 9):  # middle blocks ← keras block5..12
        for j in (1, 2, 3):
            p, s = _keras_sepconv(layers, f"block{i + 4}_sepconv{j}",
                                  f"block{i + 4}_sepconv{j}_bn")
            params[f"middle{i}_sep{j}"] = p
            stats[f"middle{i}_sep{j}"] = s
    for key, kname in (("exit_sep1", "block13_sepconv1"),
                       ("exit_sep2", "block13_sepconv2"),
                       ("exit_sep3", "block14_sepconv1"),
                       ("exit_sep4", "block14_sepconv2")):
        p, s = _keras_sepconv(layers, kname, kname + "_bn")
        params[key] = p
        stats[key] = s

    # residual projections: auto-named conv2d[_N]/batch_normalization[_N],
    # creation order = entry1, entry2, entry3, exit
    convs = _numbered(layers, "conv2d")
    bns = _numbered(layers, "batch_normalization")
    if len(convs) != 4 or len(bns) != 4:
        raise CheckpointMismatch(
            f"Xception expects 4 auto-named residual conv/bn pairs, file "
            f"has {len(convs)}/{len(bns)}")
    for block, cname, bname in zip(
            ["entry1", "entry2", "entry3", None], convs, bns):
        conv, bn, st = _keras_convbn(layers, cname, bname)
        if block is None:  # the exit-flow projection is flat-named
            params["exit_proj_conv"], params["exit_proj_bn"] = conv, bn
            stats["exit_proj_bn"] = st
        else:
            params[block]["proj_conv"] = conv
            params[block]["proj_bn"] = bn
            stats[block]["proj_bn"] = st

    if "head" in template.get("params", {}):
        params["head"] = _keras_dense(
            layers, "predictions" if "predictions" in layers else "head")
    out = {"params": params, "batch_stats": stats}
    _check_tree_shapes(out, template, "keras Xception")
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def load_pretrained(model_name: str, path: str, *, cfg=None,
                    num_classes: int | None = None,
                    template: dict | None = None) -> dict:
    """One entry point: foreign checkpoint file → flax variables for a
    named model of this framework.

    - ``load_pretrained("llama", f, cfg=LlamaConfig(...))`` — HF safetensors
    - ``load_pretrained("bert", f, cfg=BertConfig(), num_classes=2)``
    - ``load_pretrained("ResNet50"|"VGG16"|"InceptionV3", f)`` — Keras .h5
      (``template`` defaults to the registry model's seeded weights in
      flax layout, ``registry.state_dict_to_flax``; pass the tree of an
      existing model instance to validate against it)
    - any registry name with a ``.msgpack``/flax-path ``.safetensors`` file
      falls through to the native readers in :mod:`models.registry`
      (``load_flax_msgpack``, ``load_safetensors``).
    """
    lname = model_name.lower()
    if lname.startswith("llama"):
        from .llama import LlamaConfig
        return import_hf_llama(path, cfg or LlamaConfig())
    if lname.startswith("bert"):
        from .bert import BertConfig
        return import_hf_bert(path, cfg or BertConfig.base(),
                              num_classes=num_classes)

    from . import registry
    if path.endswith((".h5", ".hdf5", ".weights.h5")):
        if template is None:
            template = registry.state_dict_to_flax(
                registry.get_model(model_name).init_params())
        if lname.startswith("resnet"):
            return import_keras_resnet(path, template, name=model_name)
        if lname.startswith("vgg"):
            return import_keras_vgg(path, template)
        if lname.startswith("inception"):
            return import_keras_inception(path, template)
        if lname.startswith("xception"):
            return import_keras_xception(path, template)
        raise CheckpointMismatch(
            f"No Keras .h5 importer for {model_name!r} (supported: "
            f"ResNet50/101/152, VGG16/19, InceptionV3, Xception)")
    if template is None:
        template = registry.state_dict_to_flax(
            registry.get_model(model_name).init_params())
    if path.endswith(".safetensors"):
        return registry.load_safetensors(template, path)
    return registry.load_flax_msgpack(template, path)


def merge_into_template(imported: dict, template: dict) -> dict:
    """Overlay imported leaves onto a full template tree (e.g. a LoRA model
    whose adapter leaves aren't in the base checkpoint): template leaves
    missing from ``imported`` are kept; shapes must match where present."""
    if not isinstance(template, dict):
        return imported if imported is not None else template
    out = {}
    for k, tv in template.items():
        iv = imported.get(k) if isinstance(imported, dict) else None
        if iv is None:
            out[k] = tv
        elif isinstance(tv, dict):
            out[k] = merge_into_template(iv, tv)
        else:
            if tuple(np.shape(iv)) != tuple(np.shape(tv)):
                raise CheckpointMismatch(
                    f"merge: {k} shape {np.shape(iv)} != {np.shape(tv)}")
            out[k] = iv
    return out


def cast_float_leaves(model: nn.Module, dtype="bfloat16") -> nn.Module:
    """The serving-weights cast: a deep copy of ``model`` with its float
    parameters and buffers of two or more dimensions cast to ``dtype`` (a
    name such as ``"bfloat16"`` or a ``torch.dtype``); ``model`` itself is
    untouched, as the reference's pytree map leaves its input. Integer and
    1-D tensors pass through; casting twice is casting once.

    Dense kernels and embedding tables are virtually all the bytes. The
    port's models cast every weight to their compute dtype at use
    (``models.bert``; ``models.llama``'s projections and its f32
    ``lm_head``), so pre-casting the matrices to that dtype changes
    nothing they compute; 1-D ones (norm scales, biases) stay as they
    are, because the norms compute in f32 from them. A module that
    computes in f32 from a matrix (a logits head) sees bf16-rounded
    weights — the standard bf16-serving trade-off. Use the original
    weights where bit-exact f32 parity matters (training, equivalence
    tests)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    out = copy.deepcopy(model)
    with torch.no_grad():
        for t in list(out.parameters()) + list(out.buffers()):
            if t.is_floating_point() and t.dim() >= 2:
                t.data = t.data.to(dt)
    return out
