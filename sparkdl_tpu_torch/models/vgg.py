"""VGG16/VGG19 as ``nn.Module``\\ s — the counterpart of
``sparkdl_tpu/models/vgg.py``.

The featurizer takes VGG's fc2 (4096-d) activations as the bottleneck:
``features_only`` returns the post-fc2 ReLU. ``fc1``'s input width follows
the ``input_size`` the model is built for (flax infers it from the input it
is initialised with): ``(H // 32) · (W // 32) · 512``.

Flatten order: flax flattens the NHWC activation as ``(h, w, c)``. A
channels-last tensor's ``reshape(N, -1)`` would flatten in the logical
NCHW order ``(c, h, w)``, so the activation is permuted to NHWC before it
is flattened, and ``fc1`` takes the reference's rows as they are.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .image_layers import (Conv, Dense, init_flax_defaults, max_pool,
                           nhwc_to_model)

_WIDTHS = (64, 128, 256, 512, 512)


class VGG(nn.Module):
    def __init__(self, cfg: Sequence[int], num_classes: int = 1000,
                 dtype=torch.float32, input_size=(224, 224), seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.convs = []
        ch = 3
        h, w = (int(v) for v in input_size)
        for b, (n_convs, width) in enumerate(zip(cfg, _WIDTHS)):
            for c in range(n_convs):
                name = f"block{b + 1}_conv{c + 1}"
                self.add_module(name, Conv(ch, width, 3))
                self.convs.append(name)
                ch = width
            self.convs.append(None)  # a 2x2 max pool closes each block
            h, w = h // 2, w // 2
        self.fc1 = Dense(h * w * ch, 4096)
        self.fc2 = Dense(4096, 4096)
        self.feature_dim = 4096
        self.head = Dense(4096, num_classes, dtype=torch.float32)
        init_flax_defaults(self, seed)

    def forward(self, x, features_only: bool = False):
        x = nhwc_to_model(x, self.dtype)
        for name in self.convs:
            if name is None:
                x = max_pool(x, 2, 2)
            else:
                x = F.relu(getattr(self, name)(x), inplace=True)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c)
        x = F.relu(self.fc1(x), inplace=True)
        x = F.relu(self.fc2(x), inplace=True)
        x = x.float()
        if features_only:
            return x
        return self.head(x)


VGG16 = partial(VGG, cfg=[2, 2, 3, 3, 3])
VGG19 = partial(VGG, cfg=[2, 2, 4, 4, 4])
