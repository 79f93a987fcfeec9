"""InceptionV3 as an ``nn.Module`` — the counterpart of
``sparkdl_tpu/models/inception.py``, the flagship DeepImageFeaturizer model
(input 299x299, bottleneck = 2048-d global-average-pool features; BASELINE
config 1).

Szegedy et al. 2015 ("Rethinking the Inception Architecture",
arXiv:1512.00567): factorized 7x7 branches, grid reductions,
expanded-filter-bank mixed9/10 blocks. Submodules carry the flax model's
names (``stem1``, ``mixed4.b7x7_2.conv``, ...). Every strided convolution
and pool is ``"VALID"``; the ``"SAME"`` ones are stride 1 and pad
symmetrically. BN epsilon 1e-3, momentum 0.9997; the 3x3 average pool of
each mixed block leaves the padding out of its count.

Train mode (``forward(x, train=True)``) threads one dict through the
blocks: each ``ConvBN`` files its BatchNorm's new running statistics in
it under the buffers' names (``mixed4.b7x7_2.bn.running_mean``, ...),
``prefix`` carrying the path down.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .image_layers import (BatchNorm, Conv, Dense, avg_pool_same,
                           batch_norm, global_mean_f32, init_flax_defaults,
                           max_pool, nhwc_to_model)


class ConvBN(nn.Module):
    """conv → BN (eps 1e-3) → ReLU, the flax ``ConvBN`` unit."""

    def __init__(self, in_features: int, filters: int, kernel,
                 strides=1, padding="SAME"):
        super().__init__()
        self.conv = Conv(in_features, filters, kernel, strides, padding,
                         use_bias=False)
        self.bn = BatchNorm(filters, 1e-3, momentum=0.9997)

    def forward(self, x, st: dict | None = None, prefix: str = ""):
        return F.relu(batch_norm(self.bn, f"{prefix}bn", self.conv(x), st),
                      inplace=True)


class _Block(nn.Module):
    """A mixed block: ``forward(x, st, prefix)`` runs its ``ConvBN``s
    through :meth:`units`."""

    def units(self, st, prefix: str):
        """``c(name, x)``: this block's ``ConvBN`` ``name`` on ``x``, its
        statistics filed in ``st`` under ``prefix + name``."""
        return lambda name, x: getattr(self, name)(x, st, f"{prefix}{name}.")


class InceptionA(_Block):
    def __init__(self, in_features: int, pool_features: int):
        super().__init__()
        self.b1x1 = ConvBN(in_features, 64, 1)
        self.b5x5_1 = ConvBN(in_features, 48, 1)
        self.b5x5_2 = ConvBN(48, 64, 5)
        self.b3x3dbl_1 = ConvBN(in_features, 64, 1)
        self.b3x3dbl_2 = ConvBN(64, 96, 3)
        self.b3x3dbl_3 = ConvBN(96, 96, 3)
        self.bpool = ConvBN(in_features, pool_features, 1)
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x, st=None, prefix=""):
        c = self.units(st, prefix)
        b1 = c("b1x1", x)
        b5 = c("b5x5_2", c("b5x5_1", x))
        b3 = c("b3x3dbl_3", c("b3x3dbl_2", c("b3x3dbl_1", x)))
        bp = c("bpool", avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(_Block):
    """Grid reduction 35→17."""

    def __init__(self, in_features: int):
        super().__init__()
        self.b3x3 = ConvBN(in_features, 384, 3, 2, "VALID")
        self.b3x3dbl_1 = ConvBN(in_features, 64, 1)
        self.b3x3dbl_2 = ConvBN(64, 96, 3)
        self.b3x3dbl_3 = ConvBN(96, 96, 3, 2, "VALID")
        self.out_features = 384 + 96 + in_features

    def forward(self, x, st=None, prefix=""):
        c = self.units(st, prefix)
        b3 = c("b3x3", x)
        bd = c("b3x3dbl_3", c("b3x3dbl_2", c("b3x3dbl_1", x)))
        bp = max_pool(x, 3, 2)
        return torch.cat([b3, bd, bp], dim=1)


class InceptionC(_Block):
    """Factorized 7x7 branches."""

    def __init__(self, in_features: int, c7: int):
        super().__init__()
        self.b1x1 = ConvBN(in_features, 192, 1)
        self.b7x7_1 = ConvBN(in_features, c7, 1)
        self.b7x7_2 = ConvBN(c7, c7, (1, 7))
        self.b7x7_3 = ConvBN(c7, 192, (7, 1))
        self.b7x7dbl_1 = ConvBN(in_features, c7, 1)
        self.b7x7dbl_2 = ConvBN(c7, c7, (7, 1))
        self.b7x7dbl_3 = ConvBN(c7, c7, (1, 7))
        self.b7x7dbl_4 = ConvBN(c7, c7, (7, 1))
        self.b7x7dbl_5 = ConvBN(c7, 192, (1, 7))
        self.bpool = ConvBN(in_features, 192, 1)
        self.out_features = 768

    def forward(self, x, st=None, prefix=""):
        c = self.units(st, prefix)
        b1 = c("b1x1", x)
        b7 = c("b7x7_3", c("b7x7_2", c("b7x7_1", x)))
        bd = c("b7x7dbl_1", x)
        for name in ("b7x7dbl_2", "b7x7dbl_3", "b7x7dbl_4", "b7x7dbl_5"):
            bd = c(name, bd)
        bp = c("bpool", avg_pool_same(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(_Block):
    """Grid reduction 17→8."""

    def __init__(self, in_features: int):
        super().__init__()
        self.b3x3_1 = ConvBN(in_features, 192, 1)
        self.b3x3_2 = ConvBN(192, 320, 3, 2, "VALID")
        self.b7x7x3_1 = ConvBN(in_features, 192, 1)
        self.b7x7x3_2 = ConvBN(192, 192, (1, 7))
        self.b7x7x3_3 = ConvBN(192, 192, (7, 1))
        self.b7x7x3_4 = ConvBN(192, 192, 3, 2, "VALID")
        self.out_features = 320 + 192 + in_features

    def forward(self, x, st=None, prefix=""):
        c = self.units(st, prefix)
        b3 = c("b3x3_2", c("b3x3_1", x))
        b7 = c("b7x7x3_1", x)
        for name in ("b7x7x3_2", "b7x7x3_3", "b7x7x3_4"):
            b7 = c(name, b7)
        bp = max_pool(x, 3, 2)
        return torch.cat([b3, b7, bp], dim=1)


class InceptionE(_Block):
    """Expanded filter bank (split 3x3 into 1x3 + 3x1)."""

    def __init__(self, in_features: int):
        super().__init__()
        self.b1x1 = ConvBN(in_features, 320, 1)
        self.b3x3_1 = ConvBN(in_features, 384, 1)
        self.b3x3_2a = ConvBN(384, 384, (1, 3))
        self.b3x3_2b = ConvBN(384, 384, (3, 1))
        self.b3x3dbl_1 = ConvBN(in_features, 448, 1)
        self.b3x3dbl_2 = ConvBN(448, 384, 3)
        self.b3x3dbl_3a = ConvBN(384, 384, (1, 3))
        self.b3x3dbl_3b = ConvBN(384, 384, (3, 1))
        self.bpool = ConvBN(in_features, 192, 1)
        self.out_features = 2048

    def forward(self, x, st=None, prefix=""):
        c = self.units(st, prefix)
        b1 = c("b1x1", x)
        b3 = c("b3x3_1", x)
        b3 = torch.cat([c("b3x3_2a", b3), c("b3x3_2b", b3)], dim=1)
        bd = c("b3x3dbl_2", c("b3x3dbl_1", x))
        bd = torch.cat([c("b3x3dbl_3a", bd), c("b3x3dbl_3b", bd)], dim=1)
        bp = c("bpool", avg_pool_same(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """``forward(x, features_only=)`` on NHWC input; weights drawn from
    ``seed`` (flax defaults).

    ``forward(x, train=True)`` runs every BatchNorm in train mode (batch
    statistics, momentum 0.9997) and returns ``(logits or features,
    new_stats)``, the new running statistics keyed by the model's buffer
    names, as ``ResNet.forward(train=True)``; no buffer changes inside
    the forward."""

    def __init__(self, num_classes: int = 1000, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        self.dtype = dtype
        # Stem: 299x299x3 → 35x35x192
        self.stem1 = ConvBN(3, 32, 3, 2, "VALID")
        self.stem2 = ConvBN(32, 32, 3, 1, "VALID")
        self.stem3 = ConvBN(32, 64, 3, 1, "SAME")
        self.stem4 = ConvBN(64, 80, 1, 1, "VALID")
        self.stem5 = ConvBN(80, 192, 3, 1, "VALID")
        ch = 192
        blocks = [("mixed0", InceptionA, (32,)), ("mixed1", InceptionA, (64,)),
                  ("mixed2", InceptionA, (64,)), ("mixed3", InceptionB, ()),
                  ("mixed4", InceptionC, (128,)),
                  ("mixed5", InceptionC, (160,)),
                  ("mixed6", InceptionC, (160,)),
                  ("mixed7", InceptionC, (192,)), ("mixed8", InceptionD, ()),
                  ("mixed9", InceptionE, ()), ("mixed10", InceptionE, ())]
        for name, cls, args in blocks:
            blk = cls(ch, *args)
            self.add_module(name, blk)
            ch = blk.out_features
        self.blocks = [name for name, _, _ in blocks]
        self.feature_dim = ch
        self.head = Dense(ch, num_classes, dtype=torch.float32)
        init_flax_defaults(self, seed)

    def forward(self, x, train: bool = False, features_only: bool = False):
        st = {} if train else None

        def c(name, y):
            return getattr(self, name)(y, st, f"{name}.")

        x = nhwc_to_model(x, self.dtype)
        x = c("stem2", c("stem1", x))
        x = max_pool(c("stem3", x), 3, 2)
        x = max_pool(c("stem5", c("stem4", x)), 3, 2)
        for name in self.blocks:
            x = c(name, x)
        x = global_mean_f32(x)  # 8x8x2048 → 2048 (the bottleneck)
        if not features_only:
            x = self.head(x)
        return (x, st) if train else x
