"""ResNet v1 family as ``nn.Module``\\ s — the counterpart of
``sparkdl_tpu/models/resnet.py``.

Submodules carry the flax model's names (``stem_conv``,
``stage2_block1.conv2``, ``head``, ...) so ``registry.load_flax_variables``
maps the reference's variables one to one. NHWC in, ``channels_last``
inside; ``dtype`` is the compute dtype (parameters stay f32). The strided
3×3 convolutions (v1.5 ``conv2``, ``BasicBlock.conv1``) pad ``"SAME"`` by
flax's rule, ``(0, 1)`` on an even input (``image_layers.Conv``).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .image_layers import (BatchNorm, Conv, Dense, batch_norm,
                           global_mean_f32, init_flax_defaults, max_pool,
                           nhwc_to_model)

_EPS = 1e-5


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck with projection shortcut on shape change.

    ``stride_on_3x3=True`` (default) is the v1.5 variant (downsampling in
    the 3x3, as torchvision); ``False`` is the original v1 / keras-
    applications placement (stride on the first 1x1) — parameter shapes
    are identical, only the conv semantics differ."""
    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int,
                 stride_on_3x3: bool = True):
        super().__init__()
        s1, s2 = (1, strides) if stride_on_3x3 else (strides, 1)
        out = filters * 4
        self.conv1 = Conv(in_features, filters, 1, s1, use_bias=False)
        self.bn1 = BatchNorm(filters, _EPS)
        self.conv2 = Conv(filters, filters, 3, s2, use_bias=False)
        self.bn2 = BatchNorm(filters, _EPS)
        self.conv3 = Conv(filters, out, 1, use_bias=False)
        self.bn3 = BatchNorm(out, _EPS)
        self.has_proj = strides != 1 or in_features != out
        if self.has_proj:
            self.proj_conv = Conv(in_features, out, 1, strides,
                                  use_bias=False)
            self.proj_bn = BatchNorm(out, _EPS)

    def forward(self, x, train: bool = False):
        """``train=True`` returns ``(y, new BatchNorm statistics)``, keyed
        by buffer name (``bn1.running_mean``, ...)."""
        st = {} if train else None
        y = F.relu(batch_norm(self.bn1, "bn1", self.conv1(x), st),
                   inplace=True)
        y = F.relu(batch_norm(self.bn2, "bn2", self.conv2(y), st),
                   inplace=True)
        y = batch_norm(self.bn3, "bn3", self.conv3(y), st)
        residual = batch_norm(self.proj_bn, "proj_bn", self.proj_conv(x),
                              st) if self.has_proj else x
        y = F.relu(y + residual, inplace=True)
        return (y, st) if train else y


class BasicBlock(nn.Module):
    """3x3 → 3x3 block (ResNet-18/34)."""
    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int):
        super().__init__()
        self.conv1 = Conv(in_features, filters, 3, strides, use_bias=False)
        self.bn1 = BatchNorm(filters, _EPS)
        self.conv2 = Conv(filters, filters, 3, use_bias=False)
        self.bn2 = BatchNorm(filters, _EPS)
        self.has_proj = strides != 1 or in_features != filters
        if self.has_proj:
            self.proj_conv = Conv(in_features, filters, 1, strides,
                                  use_bias=False)
            self.proj_bn = BatchNorm(filters, _EPS)

    def forward(self, x, train: bool = False):
        """``train=True`` returns ``(y, new BatchNorm statistics)``, keyed
        by buffer name."""
        st = {} if train else None
        y = F.relu(batch_norm(self.bn1, "bn1", self.conv1(x), st),
                   inplace=True)
        y = batch_norm(self.bn2, "bn2", self.conv2(y), st)
        residual = batch_norm(self.proj_bn, "proj_bn", self.proj_conv(x),
                              st) if self.has_proj else x
        y = F.relu(y + residual, inplace=True)
        return (y, st) if train else y


class ResNet(nn.Module):
    """ResNet v1. ``forward(x, features_only=True)`` yields the pooled
    bottleneck features — the featurizer output of DeepImageFeaturizer.
    ``x`` is NHWC; weights are drawn from ``seed`` (flax defaults).

    ``forward(x, train=True)`` runs every BatchNorm in train mode (batch
    statistics, momentum 0.9) and returns ``(logits or features,
    new_stats)``: the new running statistics keyed by the model's buffer
    names (``stem_bn.running_mean``, ``stage2_block1.bn2.running_var``,
    ...), the counterpart of ``model.apply(..., train=True,
    mutable=["batch_stats"])``. No buffer changes inside the forward;
    ``train_state.make_train_step(mutable=True)`` copies them in."""

    def __init__(self, stage_sizes: Sequence[int], block,
                 num_classes: int = 1000, width: int = 64,
                 dtype=torch.float32, stride_on_3x3: bool = True,
                 seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = Conv(3, width, 7, 2, padding=((3, 3), (3, 3)),
                              use_bias=False)
        self.stem_bn = BatchNorm(width, _EPS)
        ch = width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                kw = ({"stride_on_3x3": stride_on_3x3}
                      if block is BottleneckBlock else {})
                blk = block(ch, width * 2 ** i, strides, **kw)
                self.add_module(f"stage{i + 1}_block{j + 1}", blk)
                ch = width * 2 ** i * block.expansion
        self.blocks = [f"stage{i + 1}_block{j + 1}"
                       for i, n in enumerate(stage_sizes) for j in range(n)]
        self.feature_dim = ch
        self.head = Dense(ch, num_classes, dtype=torch.float32)
        init_flax_defaults(self, seed)

    def forward(self, x, train: bool = False, features_only: bool = False):
        stats = {} if train else None
        x = nhwc_to_model(x, self.dtype)
        x = F.relu(batch_norm(self.stem_bn, "stem_bn", self.stem_conv(x),
                              stats), inplace=True)
        x = max_pool(x, 3, 2, padding=((1, 1), (1, 1)))
        for name in self.blocks:
            x = getattr(self, name)(x, train=train)
            if train:
                x, st = x
                stats.update({f"{name}.{k}": v for k, v in st.items()})
        x = global_mean_f32(x)  # global average pool → (N, C), f32
        if not features_only:
            x = self.head(x)
        return (x, stats) if train else x


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3], block=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3], block=BottleneckBlock)
