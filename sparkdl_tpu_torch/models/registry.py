"""Named-model registry — per-model metadata for the image transformers.

The counterpart of ``sparkdl_tpu/models/registry.py`` (the reference's
``keras_applications.py`` registry): for each supported named model —
InceptionV3, Xception, ResNet50, VGG16, VGG19 (+ extra ResNet depths) — the
constructor, expected input size, preprocessing function and bottleneck
feature dimension. The preprocess functions are tensor-pure, so they run on
whichever device the batch lies on, inside the scoring step.

Weights: nothing is downloaded; models initialise from a seed with the
flax default distributions (``image_layers.init_flax_defaults``).
``save_weights``/``load_weights`` are ``torch.save``/``torch.load`` of the
state dict, and :func:`load_flax_variables` carries the JAX package's
``{"params", "batch_stats"}`` into a port model (the image half of the
weight bridge); :func:`state_dict_to_flax` is its inverse. The
reference's two native weight formats read into that flax layout with
no flax at hand: flax msgpack (:func:`load_flax_msgpack`, ``msgpack``
only, chunked arrays included) and safetensors keyed by flax path
(:func:`load_safetensors`, and :func:`save_safetensors`, which writes
that file from a port model or a flax-layout tree).

The LLM half: :func:`llm_config` names the Llama configs and
:data:`DRAFT_PAIRS` / :func:`draft_for` / :func:`register_draft_pair`
pair each target family with its speculative draft family, as the
reference does (``serving.draft.DraftModelProvider.from_registry``
builds the draft from them).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from . import inception, resnet, vgg, xception

IMAGENET_CLASSES = 1000

_CAFFE_MEAN = (103.939, 116.779, 123.68)  # BGR order
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)


def _as_float(x):
    """Integer image batches (the uint8 wire format — 4x fewer host→device
    bytes than f32) upcast before the arithmetic: without this, caffe's
    mean subtraction would run in uint8 and WRAP (103.94 → 103, 90-103 →
    243+)."""
    return x if x.is_floating_point() else x.float()


def preprocess_tf(x):
    """Scale [0,255] → [-1,1] (InceptionV3 / Xception convention)."""
    return _as_float(x) / 127.5 - 1.0


def preprocess_caffe(x):
    """RGB→BGR + ImageNet mean subtraction (ResNet50/VGG convention)."""
    x = _as_float(x).flip(-1)
    return x - torch.tensor(_CAFFE_MEAN, dtype=x.dtype, device=x.device)


def preprocess_torch(x):
    x = _as_float(x) / 255.0
    mean = torch.tensor(_TORCH_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_TORCH_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


@dataclass(frozen=True)
class NamedImageModel:
    """Metadata + builders for one named model."""
    name: str
    factory: Callable[..., Any]  # (num_classes, dtype, seed) → nn.Module
    input_size: tuple[int, int]  # (H, W)
    preprocess: Callable  # NHWC [0,255] tensor → model input
    feature_dim: int
    num_classes: int = IMAGENET_CLASSES

    def build(self, dtype=torch.float32, num_classes: int | None = None,
              seed: int = 0, device=None, **build_kwargs) -> nn.Module:
        """The model in eval mode with f32 weights drawn from ``seed``
        (flax defaults, on the CPU), moved to ``device`` (default: left
        on the CPU). ``dtype`` is the compute dtype. ``build_kwargs`` pass
        through to the factory (``stride_on_3x3=False`` for keras-v1
        ResNet semantics; ``input_size=`` for VGG, whose ``fc1`` width
        follows the input it is built for)."""
        model = self.factory(num_classes=num_classes or self.num_classes,
                             dtype=dtype, seed=seed, **build_kwargs)
        model.eval()
        return model if device is None else model.to(device)

    def init_params(self, seed: int = 0, num_classes: int | None = None,
                    **build_kwargs) -> dict:
        """The state dict (f32, CPU) of a model built from ``seed`` — the
        counterpart of the reference's variables pytree."""
        return self.build(torch.float32, num_classes, seed,
                          **build_kwargs).state_dict()

    def apply_fn(self, model: nn.Module, features_only: bool = False,
                 with_preprocess: bool = True) -> Callable:
        """``fn(batch)`` over ``model``; ``batch`` is an NHWC tensor in
        [0,255] when ``with_preprocess`` (the image-struct convention).
        Runs under ``torch.inference_mode``."""
        def fn(batch):
            with torch.inference_mode():
                x = self.preprocess(batch) if with_preprocess else batch
                return model(x, features_only=features_only)

        return fn


SUPPORTED_MODELS: dict[str, NamedImageModel] = {}


def _register(m: NamedImageModel):
    SUPPORTED_MODELS[m.name] = m
    return m


_register(NamedImageModel("InceptionV3", inception.InceptionV3, (299, 299),
                          preprocess_tf, 2048))
_register(NamedImageModel("Xception", xception.Xception, (299, 299),
                          preprocess_tf, 2048))
_register(NamedImageModel("ResNet50", resnet.ResNet50, (224, 224),
                          preprocess_caffe, 2048))
_register(NamedImageModel("ResNet18", resnet.ResNet18, (224, 224),
                          preprocess_caffe, 512))
_register(NamedImageModel("ResNet34", resnet.ResNet34, (224, 224),
                          preprocess_caffe, 512))
_register(NamedImageModel("ResNet101", resnet.ResNet101, (224, 224),
                          preprocess_caffe, 2048))
_register(NamedImageModel("ResNet152", resnet.ResNet152, (224, 224),
                          preprocess_caffe, 2048))
_register(NamedImageModel("VGG16", vgg.VGG16, (224, 224),
                          preprocess_caffe, 4096))
_register(NamedImageModel("VGG19", vgg.VGG19, (224, 224),
                          preprocess_caffe, 4096))


def get_model(name: str) -> NamedImageModel:
    try:
        return SUPPORTED_MODELS[name]
    except KeyError:
        raise ValueError(
            f"Unknown model {name!r}; supported: {sorted(SUPPORTED_MODELS)}"
        ) from None


def decodePredictions(logits: np.ndarray, top: int = 5) -> list[list[dict]]:
    """Top-k decode of classifier logits (DeepImagePredictor's
    ``decodePredictions``). Offline environment → numeric class ids, not the
    ImageNet label text the reference downloaded."""
    logits = np.asarray(logits)
    probs = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs /= probs.sum(axis=-1, keepdims=True)
    out = []
    for row in probs:
        idx = np.argsort(row)[::-1][:top]
        out.append([{"class": int(i), "label": f"class_{int(i)}",
                     "score": float(row[i])} for i in idx])
    return out


# ---------------------------------------------------------------------------
# LLM family metadata — draft/target pairing for speculative serving
# ---------------------------------------------------------------------------
# The image registry above names vision models; the generation stack's
# families live in ``models.llama`` as config constructors. Speculative
# decoding (serving.draft.DraftModelProvider) needs a DRAFT model per
# target family — registry-driven so deployments swap pairings without
# touching engine code. Names: ``llama3_8b`` / ``llama_small``
# (TinyLlama-shaped ~1B) / ``llama_tiny`` (test scale).

# target family -> draft family (each one tier down: the draft must be
# cheap relative to its target or speculation cannot pay)
DRAFT_PAIRS: dict[str, str] = {
    "llama3_8b": "llama_small",
    "llama_small": "llama_tiny",
}


def register_draft_pair(target: str, draft: str) -> None:
    """Name ``draft`` as the speculative draft family for ``target``
    (overwrites an existing pairing — deployments tune this)."""
    if target == draft:
        raise ValueError(f"{target!r} cannot draft for itself — a draft "
                         f"model the size of its target saves nothing")
    DRAFT_PAIRS[str(target)] = str(draft)


def draft_for(model_name: str) -> str | None:
    """The registered draft family for ``model_name`` (None when the
    family has no pairing — the engine then uses n-gram
    self-drafting)."""
    return DRAFT_PAIRS.get(model_name)


def llm_config(name: str):
    """Named LLM config constructor (``models.llama.LlamaConfig``
    classmethods). Lazy import: the image-model paths never pay it."""
    from .llama import LlamaConfig
    factories = {"llama3_8b": LlamaConfig.llama3_8b,
                 "llama_small": LlamaConfig.small,
                 "llama_tiny": LlamaConfig.tiny}
    try:
        factory = factories[name]
    except KeyError:
        raise ValueError(f"Unknown LLM config {name!r}; supported: "
                         f"{sorted(factories)}") from None
    return factory()


# ---------------------------------------------------------------------------
# Weight persistence and the flax bridge
# ---------------------------------------------------------------------------

def save_weights(model: nn.Module, path: str):
    """``torch.save`` of ``model``'s state dict (CPU tensors)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)


def load_weights(model: nn.Module, path: str) -> nn.Module:
    """Load a :func:`save_weights` file into ``model`` (strict: every name
    and shape must match); returns ``model``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model


_LEAF_NAMES = {("params", "kernel"): "weight", ("params", "bias"): "bias",
               ("params", "scale"): "weight",
               ("batch_stats", "mean"): "running_mean",
               ("batch_stats", "var"): "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(variables) -> dict:
    """The reference's ``{"params", "batch_stats"}`` (numpy leaves) as a
    port state dict: conv kernels HWIO → OIHW (a depthwise ``(3, 3, 1, C)``
    becomes ``(C, 1, 3, 3)``), dense ``(in, out)`` → ``(out, in)``,
    BatchNorm ``scale/bias/mean/var`` → ``weight/bias/running_mean/
    running_var``. Names keep the flax module path, dotted."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})):
            *mods, leaf_name = path
            try:
                name = _LEAF_NAMES[(coll, leaf_name)]
            except KeyError:
                raise ValueError(f"unknown flax leaf {coll}/"
                                 f"{'/'.join(path)}") from None
            a = np.asarray(leaf, dtype=np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            out[".".join(mods + [name])] = torch.from_numpy(
                np.ascontiguousarray(a))
    return out


def load_flax_variables(module: nn.Module, variables) -> nn.Module:
    """Load the JAX package's variables into ``module`` in place (see
    :func:`flax_to_state_dict`). Raises ``ValueError`` naming every name
    left over in either direction and every shape that differs; nothing
    is loaded then. Returns ``module``."""
    state = flax_to_state_dict(variables)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    shapes = sorted(f"{k}: flax {tuple(state[k].shape)} vs port "
                    f"{tuple(own[k].shape)}"
                    for k in set(own) & set(state)
                    if tuple(own[k].shape) != tuple(state[k].shape))
    if missing or extra or shapes:
        raise ValueError(
            "flax variables do not fit the port model: "
            f"missing {missing[:8]}{' …' if len(missing) > 8 else ''}, "
            f"unexpected {extra[:8]}{' …' if len(extra) > 8 else ''}, "
            f"shape mismatches {shapes[:8]}")
    with torch.no_grad():
        for k, v in state.items():
            own[k].copy_(v)
    return module


_FLAX_LEAVES = {"running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var"),
                "bias": ("params", "bias")}


def state_dict_to_flax(state) -> dict:
    """The inverse of :func:`flax_to_state_dict`: a port state dict as the
    reference's ``{"params", "batch_stats"}`` of f32 numpy arrays. A
    ``weight`` of two or more dimensions is a ``kernel`` (OIHW → HWIO,
    ``(out, in)`` → ``(in, out)``), a 1-D one a BatchNorm or LayerNorm
    ``scale``; ``running_mean``/``running_var`` are ``batch_stats``
    ``mean``/``var``. Other buffers (``num_batches_tracked``) have no
    flax leaf and are left out."""
    out: dict = {}
    for name, t in state.items():
        *mods, leaf = name.split(".")
        a = t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t, np.float32)
        if leaf == "weight":
            coll, flax_leaf = ("params", "kernel") if a.ndim >= 2 \
                else ("params", "scale")
        elif leaf in _FLAX_LEAVES:
            coll, flax_leaf = _FLAX_LEAVES[leaf]
        else:
            continue
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim == 2:
            a = a.T
        node = out.setdefault(coll, {})
        for m in mods:
            node = node.setdefault(m, {})
        node[flax_leaf] = np.ascontiguousarray(a, dtype=np.float32)
    return out


# flax.serialization's msgpack extension codes and chunk marker
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    """flax's ``(shape, dtype name, buffer)`` array encoding, as a
    writable array (torch takes it without a copy); bf16 (which numpy
    lacks) widens to f32."""
    import msgpack
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    buffer = bytearray(buffer)
    if dtype_name == b"bfloat16":
        if not buffer:
            return np.zeros(shape, np.float32)
        t = torch.frombuffer(buffer, dtype=torch.bfloat16)
        return t.float().numpy().reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _ext_unpack(code, data):
    import msgpack
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(d):
    """flax stores an array over ``MAX_CHUNK_SIZE`` bytes as a dict of
    flat chunks (``{"__msgpack_chunked_array__": True, "shape": {"0":
    ...}, "chunks": {"0": ...}}``); join them back, in place."""
    if not isinstance(d, dict):
        return d
    if _CHUNKED in d:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    for k, v in d.items():
        d[k] = _unchunk(v)
    return d


def _restore(template, state, path=()):
    """flax's ``from_state_dict`` over nested dicts: every template key
    must be in ``state`` (extra keys are dropped); leaves come from
    ``state`` as they are."""
    if not isinstance(template, dict):
        return state
    missing = set(map(str, template)) - set(state)
    if missing:
        raise ValueError(
            f"The target dict keys and state dict keys do not match, "
            f"target dict contains keys {missing} which are not present "
            f"in state dict at path /{'/'.join(path)}")
    return {k: _restore(v, state[str(k)], path + (str(k),))
            for k, v in template.items()}


def load_flax_msgpack(variables_template, path: str) -> dict:
    """Read a flax msgpack weights file (the reference's ``save_weights``,
    ``flax.serialization.to_bytes``) into ``variables_template``'s
    structure, with ``msgpack`` alone: ext type 1 arrays, ext type 3
    numpy scalars and chunked arrays. Returns the flax-layout tree of
    numpy arrays (load it with :func:`load_flax_variables`)."""
    import msgpack
    with open(path, "rb") as f:
        state = msgpack.unpackb(f.read(), ext_hook=_ext_unpack, raw=False)
    return _restore(variables_template, _unchunk(state))


def load_safetensors(variables_template, path: str) -> dict:
    """Import a safetensors file whose keys are '/'-joined flax param
    paths into ``variables_template``'s structure, strict: a missing key
    or a shape that differs raises ``ValueError`` (no silent reshape — a
    same-size transposed tensor, e.g. a torch OI export against flax IO,
    would load as garbage). bf16 tensors widen to f32. Returns the
    flax-layout tree of numpy arrays."""
    from safetensors.torch import load_file

    from .pretrained import _to_numpy
    loaded = load_file(path)
    flat = {"/".join(map(str, path)): leaf
            for path, leaf in _flatten(variables_template)}
    missing = [k for k in flat if k not in loaded]
    if missing:
        raise ValueError(f"safetensors file missing {len(missing)} keys, "
                         f"e.g. {missing[:3]}")
    out: dict = {}
    for k, tmpl in flat.items():
        arr = _to_numpy(loaded[k])
        if arr.shape != tuple(np.shape(tmpl)):
            raise ValueError(f"Shape mismatch for {k}: file has "
                             f"{arr.shape}, model expects "
                             f"{tuple(np.shape(tmpl))}")
        node = out
        *mods, leaf = k.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    return out


def save_safetensors(model_or_variables, path: str):
    """Write a safetensors file keyed by '/'-joined flax paths, the file
    the reference's ``save_safetensors`` writes and :func:`load_safetensors`
    (either package's) reads. ``model_or_variables``: a port module, whose
    ``state_dict`` goes through :func:`state_dict_to_flax` (f32, flax
    layouts), or a flax-layout tree of numpy arrays or tensors (nested
    dicts), written as it is."""
    from safetensors.torch import save_file

    tree = (state_dict_to_flax(model_or_variables.state_dict())
            if isinstance(model_or_variables, nn.Module)
            else model_or_variables)
    flat = {}
    for p, leaf in _flatten(tree):
        t = leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else \
            torch.from_numpy(np.array(leaf))
        flat["/".join(map(str, p))] = t.contiguous()
    save_file(flat, path)
