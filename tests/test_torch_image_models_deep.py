"""The deeper registry models of the port (ResNet101, ResNet152, VGG19)
against the JAX package's, on the CPU: the twins of
``tests/test_torch_image_models.py``'s parity and parameter-count tests,
in a file of their own so that each file's flax compiles stay well inside
the suite's per-file budget. Same variables (numpy, seeded), same inputs,
same tolerance: f32 |Δ| ≤ 1e-5·max(1, max|ref|) + 1e-4·|ref| (the
rationale is in that file's docstring).
"""

import pytest

from test_torch_image_models import (check_features_and_logits,
                                     check_param_counts)

DEEP_CASES = [("ResNet101", 32), ("ResNet152", 32), ("VGG19", 64)]


@pytest.mark.parametrize("name,size", DEEP_CASES,
                         ids=[f"{n}-{s}" for n, s in DEEP_CASES])
def test_features_and_logits_match_flax(name, size):
    check_features_and_logits(name, size)


@pytest.mark.parametrize("name,size", DEEP_CASES,
                         ids=[n for n, _ in DEEP_CASES])
def test_param_counts_equal_flax(name, size):
    check_param_counts(name, size)
