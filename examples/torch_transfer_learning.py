"""Transfer learning, reference-style, on the PyTorch port
(``sparkdl_tpu_torch``): the twin of ``transfer_learning.py``.

DeepImageFeaturizer (truncated named model → bottleneck features) feeding
LogisticRegression inside a Pipeline, on a synthetic two-class image set.
The DataFrame needs pyarrow and pandas.

Run: python examples/torch_transfer_learning.py [--device cpu]
(the default device is the CUDA card). Env: N_IMAGES / MODEL_NAME to scale.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import sparkdl_tpu_torch as sdl
from sparkdl_tpu_torch.image import imageIO


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args().device
    n = int(os.environ.get("N_IMAGES", "16"))
    model_name = os.environ.get("MODEL_NAME", "ResNet18")

    # Two synthetic classes: dark images (label 0) vs bright images (1).
    rng = np.random.RandomState(0)
    structs, labels = [], []
    for i in range(n):
        label = i % 2
        base = 40 if label == 0 else 200
        img = np.clip(rng.randint(-30, 30, (64, 64, 3)) + base,
                      0, 255).astype(np.uint8)
        structs.append(imageIO.imageArrayToStruct(img))
        labels.append(label)
    df = sdl.DataFrame.fromPydict({"image": structs, "label": labels},
                                  numPartitions=2)

    featurizer = sdl.DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName=model_name,
        batchSize=8, device=device)
    lr = sdl.LogisticRegression(featuresCol="features", labelCol="label",
                                maxIter=60, device=device)
    model = sdl.Pipeline([featurizer, lr]).fit(df)

    preds = model.transform(df).collect()
    acc = np.mean([int(r["prediction"]) == r["label"] for r in preds])
    print(f"{model_name} features -> LogisticRegression: "
          f"train accuracy {acc:.2f} on {n} images ({device})")
    assert acc >= 0.75, "separable synthetic classes should fit"


if __name__ == "__main__":
    main()
