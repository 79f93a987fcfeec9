"""The port's 299-px registry models (InceptionV3, Xception) against the
JAX package's, on the CPU: the twins of ``tests/test_torch_image_models.py``'s
parity and parameter-count tests, in a file of their own so that each
file's flax traces and compiles stay well inside the suite's per-file
budget, and the depthwise kernel's layout through the bridge. Same
variables (numpy, seeded), same inputs, same tolerance: f32 |Δ| ≤
1e-5·max(1, max|ref|) + 1e-4·|ref| (the rationale is in that file's
docstring).

Sizes: InceptionV3 at 75x75 (its VALID grid reductions need ≥ 75);
Xception at 71x71, where every stride-2 pool meets an odd input (33, 17,
9, 5), and at 74x74, where the first entry block's pool meets 34 and pads
``(0, 1)`` — as the second one's meets 74 at the full 299x299.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import numpy as np
import pytest

from sparkdl_tpu_torch.models import registry as R
from test_torch_image_models import (check_features_and_logits,
                                     check_param_counts, flax_variables)

CASES_299 = [("InceptionV3", 75), ("Xception", 71), ("Xception", 74)]


@pytest.mark.parametrize("name,size", CASES_299,
                         ids=[f"{n}-{s}" for n, s in CASES_299])
def test_features_and_logits_match_flax(name, size):
    check_features_and_logits(name, size)


@pytest.mark.parametrize("name,size", CASES_299[:2],
                         ids=[n for n, _ in CASES_299[:2]])
def test_param_counts_equal_flax(name, size):
    check_param_counts(name, size)


def test_depthwise_kernel_layout():
    variables = flax_variables("Xception", 71)
    k = variables["params"]["entry2"]["sep1"]["depthwise"]["kernel"]
    assert k.shape == (3, 3, 1, 128)
    sd = R.flax_to_state_dict(variables)
    w = sd["entry2.sep1.depthwise.weight"]
    assert tuple(w.shape) == (128, 1, 3, 3)
    np.testing.assert_array_equal(w[5, 0].numpy(), k[:, :, 0, 5])
