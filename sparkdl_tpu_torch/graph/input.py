"""XlaInputGraph — normalize any model artifact into a GraphFunction.

The counterpart of ``sparkdl_tpu/graph/input.py``. Reference surface:
``python/sparkdl/graph/input.py``'s ``TFInputGraph`` with
``fromGraph``/``fromGraphDef``/``fromSavedModel``/``fromCheckpoint``
(+``WithSignature`` variants) — one constructor per TF-1.x artifact kind,
all normalizing to (graphdef, feeds, fetches).

The native artifact kinds here are torch-world: functions, modules
holding their weights, Keras-3 models on the torch backend, serialized
``torch.export`` programs (``GraphFunction.dump``), and weight files
(``.npz``, ``.safetensors``, ``.h5``, TF checkpoints). The reference's
``fromFlax(module, variables)`` is :meth:`XlaInputGraph.fromModule`.

Legacy TF artifacts (SavedModel, frozen GraphDef) stay loadable through
a bridge: the TF function, pruned to feeds/fetches, is called eagerly on
host numpy and its results come back as tensors on the graph's device.
On the CPU that is what the reference's ``jax2tf.call_tf`` did; it needs
TensorFlow, and raises an ``ImportError`` naming it where TensorFlow does
not import. A bridged graph does not serialize (``torch.export`` cannot
trace a TF call). Every constructor computes on ``device`` (unset → the
card; ``"cpu"`` must be asked for).
"""

from __future__ import annotations

import os
from typing import Callable, Mapping, Sequence

import numpy as np

from .function import GraphFunction, _to_device
from .utils import op_name, tensor_name


def _tf(what: str):
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            f"{what} needs TensorFlow (the tensorflow package), which does "
            f"not import here: {e}") from e
    return tf


class XlaInputGraph:
    """A normalized (GraphFunction, feeds, fetches) triple."""

    def __init__(self, gfn: GraphFunction):
        self.gfn = gfn

    @property
    def input_names(self) -> list[str]:
        return self.gfn.input_names

    @property
    def output_names(self) -> list[str]:
        return self.gfn.output_names

    def translateToGraphFunction(self) -> GraphFunction:
        return self.gfn

    asGraphFunction = translateToGraphFunction

    # ---- native torch-world artifacts -----------------------------------

    @classmethod
    def fromGraph(cls, fn: Callable, feed_names: Sequence[str] | None = None,
                  fetch_names: Sequence[str] | None = None,
                  device=None) -> "XlaInputGraph":
        """A torch function (the 'live graph' of this world)."""
        return cls(GraphFunction.fromTorch(fn, feed_names, fetch_names,
                                           device=device))

    @classmethod
    def fromGraphFunction(cls, gfn: GraphFunction) -> "XlaInputGraph":
        return cls(gfn)

    @classmethod
    def fromSerialized(cls, path_or_bytes, device=None) -> "XlaInputGraph":
        """A ``GraphFunction.dump`` artifact (torch.export) — the analogue
        of loading a frozen GraphDef file."""
        if isinstance(path_or_bytes, (bytes, bytearray)):
            return cls(GraphFunction.deserialize(bytes(path_or_bytes),
                                                 device=device))
        return cls(GraphFunction.load(os.fspath(path_or_bytes),
                                      device=device))

    @classmethod
    def fromKeras(cls, model_or_file, device=None) -> "XlaInputGraph":
        return cls(GraphFunction.fromKeras(model_or_file, device=device))

    @classmethod
    def fromModule(cls, module, device=None,
                   **forward_kwargs) -> "XlaInputGraph":
        """A ``torch.nn.Module`` holding its weights (the reference's
        ``fromFlax(module, variables, **apply_kwargs)``)."""
        return cls(GraphFunction.fromModule(module, device=device,
                                            **forward_kwargs))

    @classmethod
    def fromCheckpoint(cls, checkpoint_path: str, model_fn: Callable,
                       input_name: str = "input",
                       output_name: str = "output",
                       device=None) -> "XlaInputGraph":
        """Weights-at-rest + a model function → GraphFunction.

        ``checkpoint_path``: a ``.safetensors`` file, a Keras
        ``.h5``/``.weights.h5`` file, a ``.npz`` or a TF checkpoint
        prefix (:func:`load_weights`). ``model_fn(params, batch)`` binds
        them; ``params`` is the nested dict with its arrays as tensors on
        ``device``. (The reference's ``fromCheckpoint`` instead pulled the
        graph out of the colocated meta-graph — the weights here are
        separate from the program, so the program must be supplied.)
        """
        from ..utils.platform import resolve_device
        device = resolve_device(device)
        params = _tree_to_device(load_weights(checkpoint_path), device)
        return cls(GraphFunction.fromTorch(
            lambda batch: model_fn(params, batch),
            [input_name], [output_name], device=device))

    # ---- TF-era bridge (eager TF call on host numpy) ---------------------

    @classmethod
    def fromSavedModel(cls, saved_model_dir: str,
                       signature: str = "serving_default",
                       feed_names: Sequence[str] | None = None,
                       fetch_names: Sequence[str] | None = None,
                       device=None) -> "XlaInputGraph":
        """TF-2 SavedModel → GraphFunction calling its signature eagerly.

        Reference parity: ``TFInputGraph.fromSavedModel(WithSignature)`` —
        the signature's structured inputs/outputs become the feeds/fetches.
        """
        tf = _tf("XlaInputGraph.fromSavedModel")
        from ..utils.platform import resolve_device
        device = resolve_device(device)

        loaded = tf.saved_model.load(saved_model_dir)
        try:
            sig = loaded.signatures[signature]
        except KeyError:
            raise ValueError(
                f"SavedModel has no signature {signature!r}; available: "
                f"{list(loaded.signatures)}") from None
        in_keys = sorted(sig.structured_input_signature[1])
        out_keys = sorted(sig.structured_outputs)
        # feed/fetch names select BY NAME from the signature (never
        # positionally): they must be signature keys.
        feeds = [op_name(n) for n in feed_names] if feed_names else in_keys
        fetches = ([op_name(n) for n in fetch_names] if fetch_names
                   else out_keys)
        for n in feeds:
            if n not in in_keys:
                raise ValueError(f"Feed {n!r} is not a signature input; "
                                 f"inputs: {in_keys}")
        for n in fetches:
            if n not in out_keys:
                raise ValueError(f"Fetch {n!r} is not a signature output; "
                                 f"outputs: {out_keys}")
        if set(feeds) != set(in_keys):
            raise ValueError(
                f"All signature inputs must be fed; missing "
                f"{sorted(set(in_keys) - set(feeds))}")

        def fn(feeds_dict: dict) -> dict:
            out = sig(**{n: tf.constant(_host(feeds_dict[n]))
                         for n in in_keys})
            return {f: _to_device(out[f].numpy(), device) for f in fetches}

        fn.loaded = loaded  # keep the loaded object alive with the graph
        return cls(GraphFunction(fn, feeds, fetches, device=device))

    @classmethod
    def fromSavedModelWithSignature(cls, saved_model_dir: str,
                                    signature_def_key: str,
                                    device=None) -> "XlaInputGraph":
        return cls.fromSavedModel(saved_model_dir,
                                  signature=signature_def_key,
                                  device=device)

    @classmethod
    def fromGraphDef(cls, graph_def, feed_names: Sequence[str],
                     fetch_names: Sequence[str],
                     device=None) -> "XlaInputGraph":
        """A frozen TF GraphDef (proto or serialized bytes) pruned to
        feeds/fetches, called eagerly."""
        tf = _tf("XlaInputGraph.fromGraphDef")
        from ..utils.platform import resolve_device
        device = resolve_device(device)

        if isinstance(graph_def, (bytes, bytearray)):
            gd = tf.compat.v1.GraphDef()
            gd.ParseFromString(bytes(graph_def))
            graph_def = gd
        wrapped = tf.compat.v1.wrap_function(
            lambda: tf.graph_util.import_graph_def(graph_def, name=""), [])
        pruned = wrapped.prune(
            feeds=[wrapped.graph.get_tensor_by_name(tensor_name(n))
                   for n in feed_names],
            fetches=[wrapped.graph.get_tensor_by_name(tensor_name(n))
                     for n in fetch_names])
        feeds = [op_name(n) for n in feed_names]
        fetches = [op_name(n) for n in fetch_names]

        def fn(feeds_dict: dict) -> dict:
            out = pruned(*[tf.constant(_host(feeds_dict[n]))
                           for n in feeds])
            if not isinstance(out, (tuple, list)):
                out = (out,)
            return {f: _to_device(o.numpy(), device)
                    for f, o in zip(fetches, out)}

        return cls(GraphFunction(fn, feeds, fetches, device=device))


TFInputGraph = XlaInputGraph  # reference-compat alias


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") \
        else np.asarray(t)


def _tree_to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_device(v, device) for k, v in tree.items()}
    return _to_device(tree, device)


# ---------------------------------------------------------------------------
# Weight loading (offline formats)
# ---------------------------------------------------------------------------

def load_weights(path: str) -> Mapping:
    """Checkpoint file/dir → nested dict of numpy arrays.

    Supports: .safetensors, Keras .h5 weight files, .npz, and TF2
    checkpoints (prefix with .index beside it). An orbax checkpoint
    directory raises ``ValueError``: reading one needs
    ``orbax.checkpoint``, which imports jax (ROADMAP.md, Queue C 2).
    """
    path = os.fspath(path)
    if os.path.isdir(path):
        if any(n.startswith("ocdbt") or n in ("_METADATA", "manifest.ocdbt")
               or n.endswith(".orbax-checkpoint")
               or n == "_CHECKPOINT_METADATA" for n in os.listdir(path)):
            raise ValueError(
                f"{path!r} is an orbax checkpoint directory; reading it "
                f"needs orbax.checkpoint, which imports jax, so "
                f"sparkdl_tpu_torch does not read it (ROADMAP.md, Queue "
                f"C 2). Save the weights as .safetensors or .npz instead")
        raise ValueError(f"Unrecognized checkpoint directory {path!r}")
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        return _unflatten(load_file(path))  # _unflatten splits "/" and "."
    if path.endswith((".h5", ".hdf5")):
        return _load_h5(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return _unflatten({k: z[k] for k in z.files})
    if os.path.exists(path + ".index"):
        return _load_tf_checkpoint(path)
    raise ValueError(f"Cannot determine checkpoint format of {path!r}")


def _unflatten(flat: Mapping[str, object]) -> dict:
    # Both "/" and "." appear as path separators in the wild: this repo's
    # own safetensors writers join with "/", Keras h5 uses "/", TF
    # checkpoints use "/", npz conventions vary.
    tree: dict = {}
    for key, val in flat.items():
        parts = key.replace("/", ".").split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _load_h5(path: str) -> dict:
    import h5py
    out: dict = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            node = out
            parts = [p for p in name.split("/") if p]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = obj[()]

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def _load_tf_checkpoint(prefix: str) -> dict:
    tf = _tf("load_weights of a TF checkpoint")
    reader = tf.train.load_checkpoint(prefix)
    flat = {name: reader.get_tensor(name)
            for name in reader.get_variable_to_shape_map()}
    return _unflatten(flat)
