"""Xception as an ``nn.Module`` — the counterpart of
``sparkdl_tpu/models/xception.py``.

Chollet 2017 (arXiv:1610.02357): depthwise-separable conv stacks with
linear residuals. Separable conv = depthwise (``groups=C``; the flax
kernel ``(3, 3, 1, C)`` becomes ``(C, 1, 3, 3)``) + 1x1 pointwise. Input
299x299, bottleneck = 2048-d global-average-pool features, BN epsilon
1e-3. The stride-2 max pools pad ``"SAME"`` by flax's rule with −inf:
``(0, 1)`` on an even input (74 → 37 at 299x299).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .image_layers import (BatchNorm, Conv, Dense, global_mean_f32,
                           init_flax_defaults, max_pool, nhwc_to_model)

_EPS = 1e-3
_MOMENTUM = 0.99  # flax's: the share of the old statistics kept


class SeparableConvBN(nn.Module):
    def __init__(self, in_features: int, filters: int):
        super().__init__()
        self.depthwise = Conv(in_features, in_features, 3, use_bias=False,
                              groups=in_features)
        self.pointwise = Conv(in_features, filters, 1, use_bias=False)
        self.bn = BatchNorm(filters, _EPS, momentum=_MOMENTUM)

    def forward(self, x):
        return self.bn(self.pointwise(self.depthwise(x)))


class XceptionBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 relu_first: bool = True):
        super().__init__()
        self.strides = strides
        self.relu_first = relu_first
        self.sep1 = SeparableConvBN(in_features, filters)
        self.sep2 = SeparableConvBN(filters, filters)
        # flax projects when the residual's shape differs from the
        # branch's: a stride or a change of width
        self.has_proj = strides > 1 or in_features != filters
        if self.has_proj:
            self.proj_conv = Conv(in_features, filters, 1, strides,
                                  use_bias=False)
            self.proj_bn = BatchNorm(filters, _EPS, momentum=_MOMENTUM)

    def forward(self, x):
        y = F.relu(x) if self.relu_first else x
        y = self.sep2(F.relu(self.sep1(y), inplace=True))
        if self.strides > 1:
            y = max_pool(y, 3, self.strides, "SAME")
        residual = self.proj_bn(self.proj_conv(x)) if self.has_proj else x
        return y + residual


class Xception(nn.Module):
    """``forward(x, features_only=)`` on NHWC input; weights drawn from
    ``seed`` (flax defaults)."""

    def __init__(self, num_classes: int = 1000, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        self.dtype = dtype
        # Entry flow; VALID stem padding (the paper's and keras-
        # applications' convention).
        self.stem_conv1 = Conv(3, 32, 3, 2, "VALID", use_bias=False)
        self.stem_bn1 = BatchNorm(32, _EPS, momentum=_MOMENTUM)
        self.stem_conv2 = Conv(32, 64, 3, 1, "VALID", use_bias=False)
        self.stem_bn2 = BatchNorm(64, _EPS, momentum=_MOMENTUM)
        self.entry1 = XceptionBlock(64, 128, 2, relu_first=False)
        self.entry2 = XceptionBlock(128, 256, 2)
        self.entry3 = XceptionBlock(256, 728, 2)
        # Middle flow: 8 identity blocks of 3 separable convs
        for i in range(8):
            for j in range(3):
                self.add_module(f"middle{i + 1}_sep{j + 1}",
                                SeparableConvBN(728, 728))
        # Exit flow
        self.exit_proj_conv = Conv(728, 1024, 1, 2, use_bias=False)
        self.exit_proj_bn = BatchNorm(1024, _EPS, momentum=_MOMENTUM)
        self.exit_sep1 = SeparableConvBN(728, 728)
        self.exit_sep2 = SeparableConvBN(728, 1024)
        self.exit_sep3 = SeparableConvBN(1024, 1536)
        self.exit_sep4 = SeparableConvBN(1536, 2048)
        self.feature_dim = 2048
        self.head = Dense(2048, num_classes, dtype=torch.float32)
        init_flax_defaults(self, seed)

    def forward(self, x, features_only: bool = False):
        x = nhwc_to_model(x, self.dtype)
        x = F.relu(self.stem_bn1(self.stem_conv1(x)), inplace=True)
        x = F.relu(self.stem_bn2(self.stem_conv2(x)), inplace=True)
        x = self.entry3(self.entry2(self.entry1(x)))
        for i in range(8):
            y = x
            for j in range(3):
                y = getattr(self, f"middle{i + 1}_sep{j + 1}")(F.relu(y))
            x = y + x
        residual = self.exit_proj_bn(self.exit_proj_conv(x))
        y = self.exit_sep1(F.relu(x))
        y = self.exit_sep2(F.relu(y, inplace=True))
        x = max_pool(y, 3, 2, "SAME") + residual
        x = F.relu(self.exit_sep3(x), inplace=True)
        x = F.relu(self.exit_sep4(x), inplace=True)
        x = global_mean_f32(x)
        if features_only:
            return x
        return self.head(x)
