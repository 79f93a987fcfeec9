"""The port's Keras ``.h5`` importers against the JAX package's and
against Keras itself, on the CPU.

Keras-applications ResNet50, VGG16 (32², 10 classes), InceptionV3 and
Xception are built with random weights by the installed keras and saved
as legacy whole-model ``.h5`` files (the published files' layout); the
whole module skips where keras is missing. Keras runs on whatever backend
it is installed with: the port's twins compare its forward only as
numbers. Each family's imported tree equals the reference's bitwise, and
the Keras-3 ``.weights.h5`` layout is refused alike by both. Twins of
``tests/test_pretrained.py``'s Keras tests hold the port's models against
the Keras forward at the reference's tolerance (2e-3), and
``DeepImageFeaturizer(weightsPath=<.h5>)`` against both Keras and the
reference's featurizer (the f32 rule of ``test_torch_image_models``).
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import numpy as np
import pytest
import torch

from sparkdl_tpu.models import pretrained as JP
from sparkdl_tpu_torch.models import inception, resnet, xception
from sparkdl_tpu_torch.models import pretrained as P
from sparkdl_tpu_torch.models import registry as R
from test_torch_pretrained import (_image_df, _leaves, assert_f32_close,
                                   assert_trees_bitwise)

KERAS_TOL = 2e-3  # tests/test_pretrained.py
FAMILIES = {  # name: (keras kwargs, port template kwargs)
    "ResNet50": ({}, {}),
    "VGG16": ({"input_shape": (32, 32, 3), "classes": 10},
              {"num_classes": 10, "input_size": (32, 32)}),
    "InceptionV3": ({}, {}),
    "Xception": ({}, {}),
}


@pytest.fixture(scope="module")
def keras_files(tmp_path_factory):
    """{family: (keras model, legacy .h5 path)} plus a Keras-3
    ``.weights.h5`` of the VGG16 under ``"weights_h5"``."""
    keras = pytest.importorskip("keras")
    d = tmp_path_factory.mktemp("keras")
    keras.utils.set_random_seed(0)
    out = {}
    for name, (kw, _) in FAMILIES.items():
        km = getattr(keras.applications, name)(
            weights=None, classifier_activation=None, **kw)
        f = str(d / f"{name}.h5")
        km.save(f)  # legacy whole-model HDF5: real layer names survive
        out[name] = (km, f)
    out["weights_h5"] = str(d / "vgg16.weights.h5")
    out["VGG16"][0].save_weights(out["weights_h5"])
    return out


def _template(name):
    return R.state_dict_to_flax(R.get_model(name).init_params(
        **FAMILIES[name][1]))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_keras_family_tree_equals_reference(keras_files, name):
    f = keras_files[name][1]
    template = _template(name)
    got = P.load_pretrained(name, f, template=template)
    assert_trees_bitwise(got, JP.load_pretrained(name, f,
                                                 template=template))
    # every template leaf is filled, with its shape
    have = dict(_leaves(got))
    for path, v in _leaves(template):
        assert np.shape(have[path]) == np.shape(v), path
    if not FAMILIES[name][1]:  # the registry's own template by default
        assert_trees_bitwise(P.load_pretrained(name, f), got)


def test_keras3_weights_h5_layout_refused_alike(keras_files):
    """keras 3's ``.weights.h5`` (``layers/<name>/vars/<i>``) is neither of
    the two layouts the reference reads: both packages refuse it with
    one message."""
    msgs = []
    for pkg in (JP, P):
        with pytest.raises(pkg.CheckpointMismatch) as ei:
            pkg.read_keras_h5(keras_files["weights_h5"])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "unrecognized" in msgs[0]


@pytest.mark.parametrize("name", ["ResNet50", "InceptionV3"])
def test_keras_broken_files_raise_alike(keras_files, tmp_path, name):
    """A template of another width, and a file that lacks a layer."""
    import h5py
    f = keras_files[name][1]
    template = _template(name)
    key = "stem_conv" if name == "ResNet50" else "stem1"
    leaf = template["params"][key]
    if "kernel" not in leaf:
        leaf = leaf["conv"]
    leaf["kernel"] = np.zeros((1, 1, 3, 5), np.float32)
    msgs = []
    for pkg in (JP, P):
        with pytest.raises(pkg.CheckpointMismatch) as ei:
            pkg.load_pretrained(name, f, template=template)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    g = str(tmp_path / "cut.h5")
    with h5py.File(f, "r") as src, h5py.File(g, "w") as dst:
        root = src["model_weights"]
        names = [n.decode() if isinstance(n, bytes) else n
                 for n in root.attrs["layer_names"]]
        keep = names[:len(names) // 2]
        for n in keep:
            src.copy(root[n], dst, name=n)
        dst.attrs["layer_names"] = np.array([n.encode() for n in keep])
    msgs = []
    for pkg in (JP, P):
        with pytest.raises(pkg.CheckpointMismatch) as ei:
            pkg.load_pretrained(name, g, template=_template(name))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def _forward(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


def _loaded(module, variables):
    module.eval()
    return R.load_flax_variables(module, variables)


def test_import_keras_resnet50_forward_equivalence(keras_files):
    km, f = keras_files["ResNet50"]
    variables = P.load_pretrained("ResNet50", f, template=_template(
        "ResNet50"))
    x = np.random.RandomState(0).uniform(
        -2, 2, (2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(km(x, training=False))
    # keras-applications ResNet is v1: stride on the first 1x1
    mine = _loaded(resnet.ResNet50(num_classes=1000, stride_on_3x3=False),
                   variables)
    np.testing.assert_allclose(_forward(mine, x), want, rtol=KERAS_TOL,
                               atol=KERAS_TOL)


def test_import_keras_inceptionv3_forward_equivalence(keras_files):
    km, f = keras_files["InceptionV3"]
    variables = P.load_pretrained("InceptionV3", f)
    x = np.random.RandomState(1).uniform(
        -1, 1, (1, 299, 299, 3)).astype(np.float32)
    want = np.asarray(km(x, training=False))
    mine = _loaded(inception.InceptionV3(num_classes=1000), variables)
    np.testing.assert_allclose(_forward(mine, x), want, rtol=KERAS_TOL,
                               atol=KERAS_TOL)


def test_import_keras_xception_forward_equivalence(keras_files):
    km, f = keras_files["Xception"]
    variables = P.load_pretrained("Xception", f)
    x = np.random.RandomState(2).uniform(
        -1, 1, (1, 299, 299, 3)).astype(np.float32)
    want = np.asarray(km(x, training=False))
    mine = _loaded(xception.Xception(num_classes=1000), variables)
    np.testing.assert_allclose(_forward(mine, x), want, rtol=KERAS_TOL,
                               atol=KERAS_TOL)


def test_featurizer_with_keras_h5_weights(keras_files):
    """BASELINE config 1's shape: ``DeepImageFeaturizer(weightsPath=<keras
    .h5>)`` runs the imported weights with keras-v1 semantics; its
    features match the Keras model's bottleneck (avg_pool) features and
    the reference featurizer's on the same file."""
    import keras
    import sparkdl_tpu as sdl
    import sparkdl_tpu_torch as tdl
    km, f = keras_files["ResNet50"]
    feat = tdl.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                   modelName="ResNet50", batchSize=4,
                                   weightsPath=f, device="cpu")
    assert feat._build_kwargs() == {"stride_on_3x3": False}
    df = _image_df(tdl, n=3, size=224)
    got = np.stack([np.asarray(r.features, np.float32)
                    for r in feat.transform(df).collect()])

    # the same rows, RGB, through keras (structs store BGR at rest)
    imgs = np.stack([np.asarray(tdl.image.imageIO.imageStructToArray(
        r.image))[:, :, ::-1] for r in df.collect()]).astype(np.float32)
    feat_keras = keras.Model(km.input, km.layers[-2].output)  # avg_pool
    x = R.preprocess_caffe(torch.from_numpy(imgs)).numpy()
    want = np.asarray(feat_keras(x, training=False))
    np.testing.assert_allclose(got, want, rtol=KERAS_TOL, atol=KERAS_TOL)

    ref = sdl.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                  modelName="ResNet50", batchSize=4,
                                  weightsPath=f).setWeights(
        JP.load_pretrained("ResNet50", f, template=_template("ResNet50")))
    ref_rows = ref.transform(_image_df(sdl, n=3, size=224)).collect()
    assert_f32_close(got, np.stack([np.asarray(r.features, np.float32)
                                    for r in ref_rows]))
