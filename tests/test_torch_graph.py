"""The port's graph toolkit (``sparkdl_tpu_torch.graph``) against the JAX
package's (``sparkdl_tpu.graph``), on the CPU.

Twins of the 34 tests of ``tests/test_graph.py``, in its order and under
its names. Where a test computes, the same seeded numpy goes through the
reference's ``GraphFunction`` over a jax function and through the port's
over its torch twin, and the two outputs are held to each other:
elementwise and small matmul graphs to ``TOL`` (float32: rtol 1e-6, atol
1e-6; both packages round each op once), and both to the closed form the
reference test checks. Serialize round trips run at batches 1, 2 and 7
and must reproduce the live graph bitwise (the exported program runs the
same ops on the same CPU).

The Keras twin needs Keras on its torch backend, and this process runs
keras on jax (``tests/conftest.py``), so the port's half of it runs in one
subprocess for the file (``keras_child``: ``sys.executable`` with
``KERAS_BACKEND=torch`` on ``_KERAS_CHILD``, kept here), which reads the
``.keras`` file the reference's keras wrote and returns an npz.

Beyond the twins: the cross-package magic refusal, the orbax directory's
``ValueError``, the kernel-export refusal, and ``jit`` at several feed
shapes.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sparkdl_tpu import graph as J
from sparkdl_tpu_torch.graph import (GraphFunction, IsolatedSession,
                                     TFInputGraph, XlaInputGraph,
                                     buildFlattener, buildSpImageConverter,
                                     load_weights, makeGraphUDF, op_name,
                                     tensor_name, validated_input,
                                     validated_output)

CPU = {"device": "cpu"}
TOL = {"rtol": 1e-6, "atol": 1e-6}
BATCHES = (1, 2, 7)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def close(got, ref, **tol):
    np.testing.assert_allclose(_np(got), _np(ref), **(tol or TOL))


# ---------------------------------------------------------------- utils ----

def test_name_hygiene():
    for f in (op_name, J.op_name):
        assert f("x:0") == "x" and f("x") == "x"
        with pytest.raises(ValueError):
            f("bad name!")
        with pytest.raises(TypeError):
            f(None)
    for f in (tensor_name, J.tensor_name):
        assert f("x") == "x:0" and f("x:1") == "x:1"


def test_validated_feeds_fetches():
    for vi, vo in ((validated_input, validated_output),
                   (J.validated_input, J.validated_output)):
        assert vi("a:0", ["a", "b"]) == "a"
        with pytest.raises(ValueError):
            vi("c", ["a", "b"])
        assert vo("b", ["a", "b"]) == "b"
        with pytest.raises(ValueError):
            vo("z:0", ["a"])


# -------------------------------------------------------- GraphFunction ----

def test_from_jax_and_call():
    ref = J.GraphFunction.fromJax(lambda x: x * 2.0, ["x"], ["y"])
    g = GraphFunction.fromTorch(lambda x: x * 2.0, ["x"], ["y"], **CPU)
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    out = g(x=x)
    assert isinstance(out["y"], torch.Tensor) and out["y"].device.type == "cpu"
    close(out["y"], ref(x=x)["y"])
    close(out["y"], 2.0 * x)
    # TF-style ":0" spellings accepted
    close(g({"x:0": x})["y"], ref({"x:0": x})["y"])
    for gg in (g, ref):
        with pytest.raises(ValueError, match="Missing feeds"):
            gg({})
        with pytest.raises(ValueError, match="Unknown feeds"):
            gg(x=np.ones(3), z=np.ones(3))
    # tensor feeds are taken as they are
    close(g(x=torch.from_numpy(x))["y"], 2.0 * x)


def test_multi_output_requires_names():
    for make in (J.GraphFunction.fromJax,
                 lambda f, *a: GraphFunction.fromTorch(f, *a, **CPU)):
        with pytest.raises(ValueError, match="declare output_names"):
            make(lambda x: (x, x * 2), ["x"])(x=np.ones(2))
    x = np.random.RandomState(1).randn(2).astype(np.float32)
    ref = J.GraphFunction.fromJax(lambda x: (x + 1, x * 2), ["x"], ["a", "b"])
    g = GraphFunction.fromTorch(lambda x: (x + 1, x * 2), ["x"], ["a", "b"],
                                **CPU)
    out, rout = g(x=x), ref(x=x)
    close(out["a"], rout["a"])
    close(out["b"], rout["b"])
    g2 = GraphFunction.fromTorch(lambda x: {"s": x.sum()}, ["x"], ["s"], **CPU)
    assert float(g2(x=np.ones(4, np.float32))["s"]) == 4.0


def test_from_list_chains_positionally():
    x = np.random.RandomState(2).randn(3).astype(np.float32)
    ra = J.GraphFunction.fromJax(lambda x: x + 1.0, ["x"], ["u"])
    rb = J.GraphFunction.fromJax(lambda u: u * 3.0, ["inp"], ["v"])
    a = GraphFunction.fromTorch(lambda x: x + 1.0, ["x"], ["u"], **CPU)
    b = GraphFunction.fromTorch(lambda u: u * 3.0, ["inp"], ["v"], **CPU)
    chain = GraphFunction.fromList([a, b])
    assert chain.input_names == ["x"] and chain.output_names == ["v"]
    want = J.GraphFunction.fromList([ra, rb])(x=x)["v"]
    close(chain(x=x)["v"], want)
    close(a.then(b)(x=x)["v"], want)
    two_out = GraphFunction.fromTorch(lambda x: (x, x), ["x"], ["p", "q"],
                                      **CPU)
    with pytest.raises(ValueError, match="arity"):
        GraphFunction.fromList([two_out, b])


def test_rename():
    x = np.random.RandomState(3).randn(2).astype(np.float32)
    ref = J.GraphFunction.fromJax(lambda x: x * 2.0, ["x"], ["y"]).rename(
        inputs={"x": "image"}, outputs={"y": "features"})
    g = GraphFunction.fromTorch(lambda x: x * 2.0, ["x"], ["y"], **CPU)
    r = g.rename(inputs={"x": "image"}, outputs={"y": "features"})
    assert r.input_names == ref.input_names == ["image"]
    assert r.output_names == ref.output_names == ["features"]
    close(r(image=x)["features"], ref(image=x)["features"])


def test_serialize_roundtrip_symbolic_batch(tmp_path):
    w = np.random.RandomState(4).randn(3, 2).astype(np.float32)
    ref = J.GraphFunction.fromJax(lambda x: jnp.tanh(x @ w), ["x"], ["y"])
    wt = torch.from_numpy(w)
    g = GraphFunction.fromTorch(lambda x: torch.tanh(x @ wt), ["x"], ["y"],
                                **CPU)
    path = os.path.join(tmp_path, "g.pt2")
    g.dump(path, {"x": ((None, 3), "float32")})
    g2 = GraphFunction.load(path, **CPU)
    assert g2.input_names == ["x"] and g2.output_names == ["y"]
    for n in BATCHES:  # symbolic batch dim: any size works
        x = np.random.RandomState(n).randn(n, 3).astype(np.float32)
        assert torch.equal(g2(x=x)["y"], g(x=x)["y"])
        close(g2(x=x)["y"], ref(x=x)["y"])
    with pytest.raises(ValueError, match="serialize needs input_specs"):
        GraphFunction.fromTorch(lambda x: x, ["x"], ["y"], **CPU).serialize()
    with pytest.raises(ValueError, match="Not a serialized"):
        GraphFunction.deserialize(b"junk", **CPU)


def test_serialize_independent_variable_dims():
    # leading None dims share the batch symbol; other None dims are each
    # independent — batch != height must work after a roundtrip
    rblob = J.GraphFunction.fromJax(lambda x: x.sum(axis=(1, 2)), ["x"],
                                    ["y"]).serialize(
        {"x": ((None, None, 3), "float32")})
    g = GraphFunction.fromTorch(lambda x: x.sum(dim=(1, 2)), ["x"], ["y"],
                                **CPU)
    g2 = GraphFunction.deserialize(
        g.serialize({"x": ((None, None, 3), "float32")}), **CPU)
    for n, h in ((2, 7), (1, 5), (7, 1)):
        x = np.random.RandomState(n * h).randn(n, h, 3).astype(np.float32)
        assert torch.equal(g2(x=x)["y"], g(x=x)["y"])
        close(g2(x=x)["y"], J.GraphFunction.deserialize(rblob)(x=x)["y"],
              rtol=1e-5, atol=1e-6)
    assert np.allclose(_np(g2(x=np.ones((2, 7, 3), np.float32))["y"]), 21.0)


def test_jit_and_single_output_adapter():
    ref = J.GraphFunction.fromJax(lambda x: x - 1.0, ["x"], ["y"])
    g = GraphFunction.fromTorch(lambda x: x - 1.0, ["x"], ["y"], **CPU)
    jitted = g.jit()
    for n in (3, 5, 3):  # a new feed shape is a new captured step
        x = np.random.RandomState(n).randn(n).astype(np.float32)
        close(jitted(x=x)["y"], ref.jit()(x=x)["y"])
    assert g._graphs.signatures(next(iter(g._graphs._keys))) == 2
    fn = g.as_single_output_fn()
    x = np.ones((3,), np.float32)
    close(fn(torch.from_numpy(x)), ref.as_single_output_fn()(x))
    multi = GraphFunction.fromTorch(lambda a, b: a + b, ["a", "b"], ["y"],
                                    **CPU)
    with pytest.raises(ValueError, match="exactly one input"):
        multi.as_single_output_fn()


# ------------------------------------------------------ IsolatedSession ----

def test_isolated_session_build_run_export():
    v = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    w = np.full((3,), 2.0, np.float32)
    with J.IsolatedSession() as rs:
        rx = rs.placeholder((None, 3), "float32", name="x")
        rw = rs.constant(w, name="w")
        rz = rs.apply(jnp.tanh, rx * rw + 1.0, name="z")
        rgfn = rs.asGraphFunction([rx], [rz])
    with IsolatedSession(**CPU) as issn:
        x = issn.placeholder((None, 3), "float32", name="x")
        wn = issn.constant(w, name="w")
        z = issn.apply(torch.tanh, x * wn + 1.0, name="z")
        gfn = issn.asGraphFunction([x], [z])
    expect = np.tanh(v * 2.0 + 1.0)
    # eager run (Session.run analogue)
    close(issn.run(z, {"x": v}), rs.run(rz, {"x": v}))
    close(issn.run(z, {"x": v}), expect)
    # exported artifact
    close(gfn(x=v)["z"], rgfn(x=v)["z"])
    close(gfn(x=v)["z"], expect)
    assert gfn.input_names == ["x"] and gfn.output_names == ["z"]


def test_isolated_session_operators():
    av = np.array([2.0, 4.0], np.float32)
    bv = np.array([1.0, 2.0], np.float32)
    outs = []
    for sess in (J.IsolatedSession(), IsolatedSession(**CPU)):
        with sess as issn:
            a = issn.placeholder((None,), name="a")
            b = issn.placeholder((None,), name="b")
            exprs = [a + b, a - b, a * b, a / b, -a, 1.0 + a, 2.0 * b,
                     3.0 - a, 6.0 / b, a[0]]
            gfn = issn.asGraphFunction([a, b], exprs)
        out = gfn(a=av, b=bv)
        outs.append([out[n] for n in gfn.output_names])
    for got, ref, want in zip(outs[1], outs[0],
                              [av + bv, av - bv, av * bv, av / bv, -av,
                               1 + av, 2 * bv, 3 - av, 6 / bv, av[0]]):
        close(got, ref)
        close(got, want)


def test_import_graph_function_splices():
    x = np.random.RandomState(5).randn(2).astype(np.float32)
    outs = []
    for mod, sess, make in (
            (J, J.IsolatedSession, lambda f: J.GraphFunction.fromJax(
                f, ["x"], ["y"])),
            (None, lambda: IsolatedSession(**CPU),
             lambda f: GraphFunction.fromTorch(f, ["x"], ["y"], **CPU))):
        inner = make(lambda x: x * 10.0)
        with sess() as issn:
            a = issn.placeholder((None,), name="a")
            mid = issn.apply(lambda t: t + 1.0, a)
            o = issn.importGraphFunction(inner, [mid], prefix="sub")
            gfn = issn.asGraphFunction([a], o)
        outs.append(gfn(a=x)[gfn.output_names[0]])
        with pytest.raises(ValueError, match="expects 1 inputs"):
            with sess() as issn:
                a = issn.placeholder((None,), name="a")
                issn.importGraphFunction(inner, [a, a])
    close(outs[1], outs[0])
    close(outs[1], (x + 1.0) * 10.0)


def test_cross_session_nodes_rejected():
    for sess in (J.IsolatedSession, lambda: IsolatedSession(**CPU)):
        with sess() as s1:
            a = s1.placeholder((None,), name="a")
        with sess() as s2:
            with pytest.raises(ValueError, match="another session"):
                s2.apply(torch.tanh, a)


def test_non_placeholder_input_rejected():
    for sess in (J.IsolatedSession, lambda: IsolatedSession(**CPU)):
        with sess() as issn:
            a = issn.placeholder((None,), name="a")
            z = issn.apply(torch.tanh, a)
            with pytest.raises(ValueError, match="not a placeholder"):
                issn.asGraphFunction([z], [z])


# --------------------------------------------------------------- pieces ----

def test_sp_image_converter_bgr_and_rescale():
    x = np.random.RandomState(0).randint(0, 256, (2, 5, 5, 3)).astype(np.uint8)
    conv = buildSpImageConverter("BGR", scale=1 / 127.5, offset=-1.0, **CPU)
    rconv = J.buildSpImageConverter("BGR", scale=1 / 127.5, offset=-1.0)
    out = conv(image=x)["converted"]
    assert out.dtype == torch.float32
    close(out, rconv(image=x)["converted"])
    close(out, x[..., ::-1].astype(np.float32) / 127.5 - 1.0)
    # RGB passthrough, no rescale: exact
    conv2 = buildSpImageConverter("RGB", **CPU)
    np.testing.assert_array_equal(
        _np(conv2(image=x)["converted"]),
        np.asarray(J.buildSpImageConverter("RGB")(image=x)["converted"]))


def test_flattener_and_composed_pipeline():
    x = np.random.RandomState(1).randint(0, 256, (3, 4, 4, 3)).astype(np.uint8)
    chain = GraphFunction.fromList([buildSpImageConverter("BGR", **CPU),
                                    buildFlattener("converted", "flattened",
                                                   **CPU)])
    ref = J.GraphFunction.fromList([J.buildSpImageConverter("BGR"),
                                    J.buildFlattener("converted",
                                                     "flattened")])
    out = chain(image=x)["flattened"]
    assert tuple(out.shape) == (3, 48)
    np.testing.assert_array_equal(_np(out),
                                  np.asarray(ref(image=x)["flattened"]))
    np.testing.assert_array_equal(
        _np(out), x[..., ::-1].reshape(3, -1).astype(np.float32))


# -------------------------------------------------------- XlaInputGraph ----

def test_from_graph_and_from_graph_function():
    x = np.random.RandomState(6).randn(2).astype(np.float32)
    ig = XlaInputGraph.fromGraph(lambda x: x * 2.0, ["x"], ["y"], **CPU)
    rig = J.XlaInputGraph.fromGraph(lambda x: x * 2.0, ["x"], ["y"])
    close(ig.translateToGraphFunction()(x=x)["y"],
          rig.translateToGraphFunction()(x=x)["y"])
    assert TFInputGraph is XlaInputGraph
    g = GraphFunction.fromTorch(lambda x: x, ["x"], ["y"], **CPU)
    assert XlaInputGraph.fromGraphFunction(g).asGraphFunction() is g


def test_from_serialized(tmp_path):
    g = GraphFunction.fromTorch(lambda x: x + 5.0, ["x"], ["y"], **CPU)
    ref = J.GraphFunction.fromJax(lambda x: x + 5.0, ["x"], ["y"])
    blob = g.serialize({"x": ((None,), "float32")})
    ig = XlaInputGraph.fromSerialized(blob, **CPU)
    for n in BATCHES:
        x = np.random.RandomState(n).randn(n).astype(np.float32)
        got = ig.translateToGraphFunction()(x=x)["y"]
        assert torch.equal(got, g(x=x)["y"])
        close(got, ref(x=x)["y"])
    p = os.path.join(tmp_path, "g.pt2")
    g.dump(p, {"x": ((None,), "float32")})
    ig2 = XlaInputGraph.fromSerialized(p, **CPU)
    assert ig2.output_names == ["y"]


_KERAS_CHILD = r'''
import json, os, sys
import numpy as np
os.environ["KERAS_BACKEND"] = "torch"
sys.path.insert(0, sys.argv[1])
from sparkdl_tpu_torch.graph import GraphFunction, XlaInputGraph
out = {"port_imported_jax": np.array("jax" in sys.modules)}
args = json.loads(sys.argv[2])
x = np.load(args["x"])
ig = XlaInputGraph.fromKeras(args["model"], device="cpu")
gfn = ig.translateToGraphFunction()
out["got"] = gfn(input=x)["output"].numpy()
try:
    gfn.serialize()
    out["free_batch_error"] = np.array("")
except ValueError as e:
    out["free_batch_error"] = np.array(str(e))
fixed = GraphFunction.deserialize(
    gfn.serialize({"input": ((x.shape[0], 6), "float32")}), device="cpu")
out["fixed"] = fixed(input=x)["output"].numpy()
try:
    fixed(input=x[:2])
    out["fixed_refuses_other_batch"] = np.array(False)
except Exception:
    out["fixed_refuses_other_batch"] = np.array(True)
import keras
out["backend"] = np.array(keras.backend.backend())
np.savez(args["out"], **out)
'''


@pytest.fixture(scope="module")
def keras_child(tmp_path_factory):
    """The reference's keras (jax backend, this process) writes the
    model; the port reads it in a KERAS_BACKEND=torch subprocess."""
    keras = pytest.importorskip("keras")
    d = tmp_path_factory.mktemp("keras_graph")
    keras.utils.set_random_seed(0)
    model = keras.Sequential([
        keras.layers.Input((6,)),
        keras.layers.Dense(4, activation="tanh"),
        keras.layers.Dense(2),
    ])
    model.save(str(d / "m.keras"))
    x = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    np.save(d / "x.npy", x)
    args = {"model": str(d / "m.keras"), "x": str(d / "x.npy"),
            "out": str(d / "out.npz")}
    env = dict(os.environ, KERAS_BACKEND="torch")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _KERAS_CHILD, root,
                          json.dumps(args)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(args["out"]) as z:
        return model, x, {k: z[k] for k in z.files}


def test_from_keras_equivalence(keras_child):
    """The same .keras file: the reference's graph (keras on jax) and the
    port's (keras on torch) agree to 1e-5 (the reference's own tolerance
    against the live model). Keras's input checks fix the batch under
    torch.export, so the port refuses a free-batch serialize (ROADMAP.md
    C 2) and serializes at a fixed batch, which then refuses another."""
    model, x, out = keras_child
    rig = J.XlaInputGraph.fromKeras(model)
    want = np.asarray(rig.translateToGraphFunction()(input=x)["output"])
    np.testing.assert_allclose(out["got"], want, atol=1e-5)
    np.testing.assert_allclose(out["got"], np.asarray(model(x)), atol=1e-5)
    assert str(out["backend"]) == "torch"
    assert not bool(out["port_imported_jax"])
    assert "Keras-on-torch" in str(out["free_batch_error"])
    np.testing.assert_array_equal(out["fixed"], out["got"])
    assert bool(out["fixed_refuses_other_batch"])


def test_from_flax():
    """The reference's ``fromFlax(module, variables)`` is the port's
    ``fromModule(module)``: the flax Dense's variables carried into a
    torch Linear give the same outputs."""
    import flax.linen as nn
    import jax

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(2)(x)

    m = Tiny()
    variables = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(
            np.asarray(variables["params"]["Dense_0"]["kernel"]).T.copy()))
        lin.bias.copy_(torch.from_numpy(
            np.asarray(variables["params"]["Dense_0"]["bias"])))
    ig = XlaInputGraph.fromModule(lin, **CPU)
    rig = J.XlaInputGraph.fromFlax(m, variables)
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    got = ig.translateToGraphFunction()(input=x)["output"]
    close(got, rig.translateToGraphFunction()(input=x)["output"],
          rtol=1e-6, atol=1e-6)
    close(got, np.asarray(m.apply(variables, x)), rtol=1e-6, atol=1e-6)
    # forward keyword arguments reach the module; a module on another
    # device than the graph's is refused
    feats = GraphFunction.fromModule(
        torch.nn.Identity(), **CPU)(input=x)["output"]
    close(feats, x)
    with pytest.raises(ValueError, match="lie on"):
        GraphFunction.fromModule(lin.to("meta"), **CPU)


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def test_from_saved_model(tf, tmp_path):
    class M(tf.Module):
        def __init__(self):
            super().__init__()
            self.w = tf.Variable(tf.ones((3, 2)))

        @tf.function(input_signature=[
            tf.TensorSpec([None, 3], tf.float32, name="x")])
        def __call__(self, x):
            return {"y": tf.matmul(x, self.w) + 1.0}

    path = os.path.join(tmp_path, "sm")
    tf.saved_model.save(M(), path)
    ig = XlaInputGraph.fromSavedModel(path, **CPU)
    rig = J.XlaInputGraph.fromSavedModel(path)
    assert ig.input_names == rig.input_names == ["x"]
    assert ig.output_names == rig.output_names == ["y"]
    x = np.random.RandomState(7).randn(2, 3).astype(np.float32)
    got = ig.translateToGraphFunction()(x=x)["y"]
    assert isinstance(got, torch.Tensor)
    close(got, rig.translateToGraphFunction()(x=x)["y"], rtol=1e-6,
          atol=1e-6)
    with pytest.raises(ValueError, match="no signature"):
        XlaInputGraph.fromSavedModel(path, signature="nope", **CPU)
    ig2 = XlaInputGraph.fromSavedModelWithSignature(path, "serving_default",
                                                    **CPU)
    assert ig2.output_names == ["y"]
    # feed/fetch names bind BY NAME against signature keys, never position
    with pytest.raises(ValueError, match="not a signature input"):
        XlaInputGraph.fromSavedModel(path, feed_names=["wrong"], **CPU)
    with pytest.raises(ValueError, match="not a signature output"):
        XlaInputGraph.fromSavedModel(path, fetch_names=["nope"], **CPU)


def test_from_saved_model_fetch_selection_by_name(tf, tmp_path):
    class M2(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec([None, 2], tf.float32, name="x")])
        def __call__(self, x):
            # alphabetical order is (logits, probs); select 'probs' by name
            return {"logits": x * 10.0, "probs": x * 0.1}

    path = os.path.join(tmp_path, "sm2")
    tf.saved_model.save(M2(), path)
    ig = XlaInputGraph.fromSavedModel(path, fetch_names=["probs"], **CPU)
    rig = J.XlaInputGraph.fromSavedModel(path, fetch_names=["probs"])
    x = np.random.RandomState(8).randn(2, 2).astype(np.float32)
    out = ig.translateToGraphFunction()(x=x)
    assert list(out) == ["probs"]
    close(out["probs"], rig.translateToGraphFunction()(x=x)["probs"])


def test_from_graph_def(tf):
    with tf.Graph().as_default() as g:
        xin = tf.compat.v1.placeholder(tf.float32, [None, 3], name="xin")
        tf.identity(xin * 2.0 + 0.5, name="yout")
    x = np.random.RandomState(9).randn(2, 3).astype(np.float32)
    ig = XlaInputGraph.fromGraphDef(g.as_graph_def(), ["xin"], ["yout"],
                                    **CPU)
    rig = J.XlaInputGraph.fromGraphDef(g.as_graph_def(), ["xin"], ["yout"])
    out = ig.translateToGraphFunction()(xin=x)["yout"]
    close(out, rig.translateToGraphFunction()(xin=x)["yout"])
    close(out, x * 2.0 + 0.5)
    # serialized proto bytes accepted too
    ig2 = XlaInputGraph.fromGraphDef(
        g.as_graph_def().SerializeToString(), ["xin:0"], ["yout:0"], **CPU)
    close(ig2.translateToGraphFunction()(xin=x)["yout"], x * 2.0 + 0.5)


# ------------------------------------------------------- weight loading ----

def _same_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_load_weights_npz(tmp_path):
    p = os.path.join(tmp_path, "w.npz")
    np.savez(p, **{"layer1.kernel": np.ones((2, 2)),
                   "layer1.bias": np.zeros(2)})
    tree = load_weights(p)
    assert set(tree["layer1"]) == {"kernel", "bias"}
    _same_tree(tree, J.load_weights(p))


def test_load_weights_safetensors(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    p = os.path.join(tmp_path, "w.safetensors")
    # both separators appear in the wild ("/" is what this repo's own
    # safetensors writers emit)
    st.save_file({"a.b": np.arange(4, dtype=np.float32),
                  "Dense_0/kernel": np.ones((2, 2), np.float32)}, p)
    tree = load_weights(p)
    assert np.allclose(tree["a"]["b"], np.arange(4))
    assert tree["Dense_0"]["kernel"].shape == (2, 2)
    _same_tree(tree, J.load_weights(p))


def test_load_weights_h5(tmp_path):
    h5py = pytest.importorskip("h5py")
    p = os.path.join(tmp_path, "w.h5")
    with h5py.File(p, "w") as f:
        f.create_dataset("dense/kernel", data=np.ones((3, 3)))
    tree = load_weights(p)
    assert tree["dense"]["kernel"].shape == (3, 3)
    _same_tree(tree, J.load_weights(p))


def test_load_weights_tf_checkpoint(tf, tmp_path):
    v = tf.Variable(np.full((2,), 7.0, np.float32), name="my/var")
    ckpt = tf.train.Checkpoint(v=v)
    prefix = ckpt.write(os.path.join(tmp_path, "ck"))
    tree = load_weights(prefix)
    flat = []

    def walk(node):
        for val in node.values():
            (walk if isinstance(val, dict) else
             lambda x: flat.append(np.asarray(x)))(val)
    walk(tree)
    assert any(a.shape == (2,) and np.allclose(a, 7.0) for a in flat)
    assert set(tree) == set(J.load_weights(prefix))


def test_load_weights_unknown(tmp_path):
    for lw in (load_weights, J.load_weights):
        with pytest.raises(ValueError, match="Cannot determine"):
            lw(os.path.join(tmp_path, "nothing.xyz"))


def test_from_checkpoint_binds_model_fn(tmp_path):
    p = os.path.join(tmp_path, "w.npz")
    w = np.random.RandomState(10).randn(3, 2).astype(np.float32)
    np.savez(p, **{"w": w})
    ig = XlaInputGraph.fromCheckpoint(
        p, lambda params, batch: batch @ params["w"], **CPU)
    rig = J.XlaInputGraph.fromCheckpoint(
        p, lambda params, batch: batch @ params["w"])
    x = np.random.RandomState(11).randn(2, 3).astype(np.float32)
    close(ig.translateToGraphFunction()(input=x)["output"],
          rig.translateToGraphFunction()(input=x)["output"],
          rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- makeGraphUDF ----

def test_make_graph_udf_end_to_end():
    import pandas as pd

    import sparkdl_tpu as jsdl
    import sparkdl_tpu_torch as tdl
    from sparkdl_tpu.udf import registry as jreg
    from sparkdl_tpu_torch.udf import applyUDF, unregisterUDF

    rows = {"v": [np.random.RandomState(i).randn(2).astype(np.float32)
                  for i in range(5)]}
    makeGraphUDF(GraphFunction.fromTorch(lambda x: x * 3.0, ["x"], ["y"],
                                         **CPU), "triple")
    J.makeGraphUDF(J.GraphFunction.fromJax(lambda x: x * 3.0, ["x"], ["y"]),
                   "triple")
    try:
        out = applyUDF(tdl.DataFrame.fromPandas(pd.DataFrame(rows)),
                       "triple", "v", "tripled").toPandas()
        ref = jreg.applyUDF(jsdl.DataFrame.fromPandas(pd.DataFrame(rows)),
                            "triple", "v", "tripled").toPandas()
        got = np.stack(out["tripled"].to_numpy())
        close(got, np.stack(ref["tripled"].to_numpy()))
        close(got, np.stack(rows["v"]) * 3.0)
    finally:
        unregisterUDF("triple")
        jreg.unregisterUDF("triple")


def test_make_graph_udf_kinds():
    from sparkdl_tpu_torch.udf import listUDFs, unregisterUDF
    try:
        makeGraphUDF(lambda x: x + 1, "callable_udf", **CPU)
        blob = GraphFunction.fromTorch(lambda x: x, ["x"], ["y"],
                                       **CPU).serialize(
            {"x": ((None,), "float32")})
        makeGraphUDF(blob, "blob_udf", **CPU)
        assert {"callable_udf", "blob_udf"} <= set(listUDFs())
        # a bare-string fetches must mean the fetch name, not its first char
        g3 = GraphFunction.fromTorch(lambda x: {"probs": x}, ["x"],
                                     ["probs"], **CPU)
        makeGraphUDF(g3, "str_fetch_udf", fetches="probs")
        with pytest.raises(TypeError, match="asGraphFunction"):
            makeGraphUDF(IsolatedSession(**CPU), "bad")
        with pytest.raises(TypeError, match="Cannot make a UDF"):
            makeGraphUDF(123, "bad")
        # the reference's blob is refused by name
        rblob = J.GraphFunction.fromJax(lambda x: x, ["x"], ["y"]).serialize(
            {"x": ((None,), "float32")})
        with pytest.raises(ValueError, match="JAX package"):
            makeGraphUDF(rblob, "foreign_udf", **CPU)
        assert "foreign_udf" not in listUDFs()
    finally:
        for n in ("callable_udf", "blob_udf", "str_fetch_udf"):
            unregisterUDF(n)


def test_image_input_placeholder_and_utils():
    from sparkdl_tpu.transformers import utils as JU
    from sparkdl_tpu.utils import flatten_with_paths as jflat
    from sparkdl_tpu.utils import tree_size_bytes as jsize
    from sparkdl_tpu_torch.transformers.utils import (
        IMAGE_INPUT_PLACEHOLDER_NAME, imageInputPlaceholder, imageInputSpec)
    from sparkdl_tpu_torch.utils import Timer, flatten_with_paths, \
        tree_size_bytes

    assert IMAGE_INPUT_PLACEHOLDER_NAME == JU.IMAGE_INPUT_PLACEHOLDER_NAME
    assert imageInputSpec(8, 8) == JU.imageInputSpec(8, 8)
    node = imageInputPlaceholder(3, 8, 8, **CPU)
    issn = node.session
    out = issn.apply(lambda b: b.reshape(b.shape[0], -1), node)
    gfn = issn.asGraphFunction([node], [out])
    x = np.random.RandomState(0).rand(2, 8, 8, 3).astype(np.float32)
    res = gfn({IMAGE_INPUT_PLACEHOLDER_NAME: x})
    assert tuple(res[out.name].shape) == (2, 192)
    close(res[out.name], x.reshape(2, -1))
    g2 = GraphFunction.deserialize(gfn.serialize(imageInputSpec(8, 8)), **CPU)
    for n in BATCHES:
        xn = np.random.RandomState(n).rand(n, 8, 8, 3).astype(np.float32)
        got = g2({IMAGE_INPUT_PLACEHOLDER_NAME: xn})[out.name]
        assert tuple(got.shape) == (n, 192)
        assert torch.equal(got, gfn({IMAGE_INPUT_PLACEHOLDER_NAME: xn})[
            out.name])

    tree = {"a": {"b": np.zeros((2, 2), np.float32)}, "c": np.zeros(3),
            "d": [np.ones(2, np.int32), {"e": np.ones(1)}]}
    assert dict(flatten_with_paths(tree))["a/b"].shape == (2, 2)
    assert [p for p, _ in flatten_with_paths(tree)] == \
        [p for p, _ in jflat(tree)]
    assert tree_size_bytes(tree) == jsize(tree) == 2 * 2 * 4 + 3 * 8 + 8 + 8
    ttree = {"w": torch.zeros(2, 3), "b": [torch.zeros(4, dtype=torch.int64)]}
    assert [p for p, _ in flatten_with_paths(ttree)] == ["b/0", "w"]
    assert tree_size_bytes(ttree) == 2 * 3 * 4 + 4 * 8
    with Timer() as t:
        pass
    assert t.seconds >= 0.0


def test_as_graph_function_validates_placeholders_at_export():
    """An output depending on an undeclared placeholder must fail at
    asGraphFunction (export) time, not with 'No feed provided' at call
    time, in both packages."""
    import sparkdl_tpu as jsdl
    import sparkdl_tpu_torch as tdl
    for sess in (jsdl.IsolatedSession, lambda: tdl.IsolatedSession(**CPU)):
        with sess() as issn:
            x = issn.placeholder(name="x")
            y = issn.placeholder(name="y")
            z = x + y
            with pytest.raises(ValueError, match=r"placeholder.*'y'"):
                issn.asGraphFunction([x], [z])
            gfn = issn.asGraphFunction([x, y], [z])  # declared: fine
            out = gfn({"x": np.ones(2, np.float32),
                       "y": np.ones(2, np.float32)})
            np.testing.assert_allclose(_np(out[gfn.output_names[0]]), 2.0)


def test_probe_output_names_via_eval_shape():
    """With input_specs, undeclared multi-output fns fail at construction
    (the port runs them on fake tensors where the reference runs
    jax.eval_shape); dict returns get their keys as output names."""
    specs = {"input": ((None, 3), "float32")}
    calls = []

    def counted(x):
        calls.append(type(x).__name__)
        return {"a": x * 2, "b": x + 1}

    gfn = GraphFunction.fromTorch(counted, input_specs=specs, **CPU)
    assert gfn.output_names == ["a", "b"] == J.GraphFunction.fromJax(
        lambda x: {"a": x * 2, "b": x + 1}, input_specs=specs).output_names
    assert calls == ["FakeTensor"]  # no compute on real tensors

    # undeclared tuple multi-output: construction-time error
    with pytest.raises(ValueError, match="declare output_names"):
        GraphFunction.fromTorch(lambda x: (x, x * 2), input_specs=specs,
                                **CPU)

    # without specs: permissive default, error still surfaces at call
    gfn2 = GraphFunction.fromTorch(lambda x: (x, x * 2), **CPU)
    assert gfn2.output_names == ["output"]
    with pytest.raises(ValueError):
        gfn2({"input": np.ones((2, 3), np.float32)})


# ------------------------------------------------- beyond the reference ----

def test_each_package_refuses_the_others_blob():
    spec = {"x": ((None, 2), "float32")}
    ours = GraphFunction.fromTorch(lambda x: x * 2, ["x"], ["y"],
                                   **CPU).serialize(spec)
    theirs = J.GraphFunction.fromJax(lambda x: x * 2, ["x"],
                                     ["y"]).serialize(spec)
    with pytest.raises(ValueError, match="JAX package"):
        GraphFunction.deserialize(theirs, **CPU)
    with pytest.raises(ValueError, match="Not a serialized"):
        J.GraphFunction.deserialize(ours)


def test_orbax_directory_names_the_difference(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax.*C 2"):
        load_weights(str(d))
    e = tmp_path / "plain"
    e.mkdir()
    with pytest.raises(ValueError, match="Unrecognized checkpoint"):
        load_weights(str(e))


def test_serialize_refuses_a_kernel_call():
    """A wrapper's CUDA branch refuses to be traced
    (``ops._build.refuse_export``); serialize says so. On the CPU the
    wrappers take their plain versions, so the refusal is driven
    directly here (the card test drives flash_attention itself)."""
    from sparkdl_tpu_torch.ops import _build

    def fn(x):
        _build.refuse_export("flash_attention")
        return x

    g = GraphFunction.fromTorch(fn, ["x"], ["y"], **CPU)
    close(g(x=np.ones(2, np.float32))["y"], np.ones(2))  # no export: runs
    with pytest.raises(ValueError, match="flash_attention's CUDA kernel"):
        g.serialize({"x": ((None,), "float32")})


def test_device_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is the CPU-only path")
    for make in (lambda: GraphFunction(lambda f: f, ["x"], ["y"]),
                 lambda: IsolatedSession(),
                 lambda: buildFlattener(),
                 lambda: GraphFunction.fromTorch(lambda x: x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_serialize_takes_the_exporters_upper_bound():
    """A function that bounds its batch from above (on the card cuDNN
    takes at most 65535 rows; here a ``torch._check``) still serializes
    with a free batch: the program takes every size from 1 to the bound
    and refuses one past it. A lower bound above 1 is an error."""
    import json

    def capped(x):
        torch._check(x.shape[0] <= 100)
        return x * 2

    g = GraphFunction.fromTorch(capped, ["x"], ["y"], **CPU)
    blob = g.serialize({"x": ((None, 3), "float32")})
    hlen = int.from_bytes(blob[18:26], "little")
    assert json.loads(blob[26:26 + hlen])["max_sizes"] == {"d1": 100}
    g2 = GraphFunction.deserialize(blob, **CPU)
    for n in (*BATCHES, 100):
        x = np.random.RandomState(n).randn(n, 3).astype(np.float32)
        assert torch.equal(g2(x=x)["y"], g(x=x)["y"])
    with pytest.raises(Exception):
        g2(x=np.ones((101, 3), np.float32))

    def floored(x):
        torch._check(x.shape[0] >= 4)
        return x * 2

    with pytest.raises(ValueError, match="could not export"):
        GraphFunction.fromTorch(floored, ["x"], ["y"], **CPU).serialize(
            {"x": ((None, 3), "float32")})


def test_udf_stage_is_the_udfs_device_step():
    """``udf.udfStage`` gives the stage a graph UDF applies, whose runner
    drives the same device step without a DataFrame (the card machine
    has no pyarrow); a token UDF has none."""
    from sparkdl_tpu_torch.udf import registry as reg
    gfn = GraphFunction.fromTorch(lambda x: torch.tanh(x) * 3.0, ["x"],
                                  ["y"], **CPU)
    makeGraphUDF(gfn, "stage_udf", batchSize=4)
    try:
        runner = reg.udfStage("stage_udf", "x", "y")._get_runner()
        x = np.random.RandomState(12).randn(6, 3).astype(np.float32)
        got = np.concatenate(list(runner.run([x[:4], x[4:]])))
        close(got, gfn(x=x)["y"])
    finally:
        reg.unregisterUDF("stage_udf")
    reg._UDF_REGISTRY["token_udf"] = lambda df, i, o: df
    try:
        with pytest.raises(ValueError, match="no transformer stage"):
            reg.udfStage("token_udf", "x", "y")
    finally:
        reg.unregisterUDF("token_udf")
    with pytest.raises(ValueError, match="not registered"):
        reg.udfStage("nope", "x", "y")
