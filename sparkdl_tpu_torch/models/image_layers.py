"""The layers the port's image models are built from, with flax's
semantics.

The JAX package's image models are flax ``linen`` modules. These are their
PyTorch counterparts, so that a model built here from the same variables
computes what the flax model computes:

- :class:`Conv` pads ``"SAME"`` the way flax does: ``t = max((ceil(n/s) -
  1)·s + k - n, 0)`` split ``(t // 2, t - t // 2)``. On an even input at
  stride 2 with a 3×3 kernel that is ``(0, 1)``, where PyTorch's symmetric
  ``padding=1`` would shift every output; asymmetric pads go through
  ``F.pad`` first. Its weight is OIHW (flax: HWIO), ``groups`` is flax's
  ``feature_group_count``.
- :class:`BatchNorm` runs inference normalisation in f32 on f32 statistics
  and casts its output to the input's dtype, as flax's ``BatchNorm`` does
  under ``dtype=bfloat16`` (``F.batch_norm`` with f32 parameters on a bf16
  input). It is never folded into the convolution. In train mode it
  normalises with the batch's statistics and returns the new running
  statistics beside its output (:func:`batch_norm` files them by name).
  Inside :func:`sync_batch_stats` (the data-parallel train step) the
  batch statistics are those of the gang's global batch.
- :func:`max_pool` pads ``"SAME"`` with −inf by the same rule;
  :func:`avg_pool_same` leaves the padding out of the count
  (``count_include_pad=False``).
- Weights and biases are float32 parameters; each layer casts them to the
  input's dtype at use, as flax's ``promote_dtype`` does.
- :func:`init_flax_defaults` draws the flax default initialisation from a
  ``torch.Generator``: conv and dense kernels ``lecun_normal`` (a normal
  truncated at ±2, std ``sqrt(1/fan_in) / .8796…``), biases 0, BN scale 1,
  bias 0, mean 0, variance 1.

The models take NHWC at their API boundary (the image-struct convention)
and run ``channels_last`` inside: ``nhwc_to_model`` turns an NHWC tensor
into a logical NCHW tensor whose memory is NHWC, which is what cuDNN's
NHWC convolutions read.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def _pair(v) -> tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax / XLA ``"SAME"`` padding ``(lo, hi)`` of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _resolve_pads(padding, hw, kernel, stride):
    """``((lo_h, hi_h), (lo_w, hi_w))`` for ``"SAME"``, ``"VALID"`` or an
    explicit pair of pairs."""
    if padding == "SAME":
        return tuple(same_pads(n, k, s) for n, k, s in zip(hw, kernel, stride))
    if padding == "VALID":
        return (0, 0), (0, 0)
    return tuple(tuple(int(v) for v in p) for p in padding)


class Conv(nn.Module):
    """flax ``nn.Conv`` (NHWC kernel HWIO) as an OIHW convolution over a
    channels-last tensor."""

    def __init__(self, in_features: int, features: int, kernel,
                 strides=1, padding="SAME", use_bias: bool = True,
                 groups: int = 1):
        super().__init__()
        self.kernel = _pair(kernel)
        self.strides = _pair(strides)
        self.padding = padding
        self.groups = int(groups)
        self.weight = nn.Parameter(torch.empty(
            features, in_features // self.groups, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        (lh, hh), (lw, hw) = _resolve_pads(self.padding, x.shape[-2:],
                                           self.kernel, self.strides)
        if lh == hh and lw == hw:
            pad = (lh, lw)
        else:
            x = F.pad(x, (lw, hw, lh, hh))
            pad = (0, 0)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.strides, pad,
                        1, self.groups)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm``, in both of its modes.

    ``forward(x)`` is ``use_running_average=True``: f32 normalisation from
    the f32 running statistics, output in the input's dtype.

    ``forward(x, train=True)`` is ``use_running_average=False``: it
    normalises with the batch's mean and biased variance over every dim
    but the channels', computed in f32 whatever the input's dtype, output
    in the input's dtype, and gradients flow through the batch
    statistics. It returns ``(y, (new_mean, new_var))``, the new running
    statistics as values, ``momentum·old + (1 − momentum)·batch`` with the
    biased variance (flax's ``momentum``; PyTorch's ``momentum`` is its
    complement). It writes no buffer: the train step copies the values in
    once, after the optimizer step, so a forward that
    ``torch.utils.checkpoint`` runs again in the backward does not update
    them twice.

    In one process the batch statistics come from
    ``aten._native_batch_norm_legit`` (``save_mean`` and ``save_invstd``,
    no second pass over the activations); the variance is ``invstd^-2 −
    eps``, taken in f64. flax computes it as E[x²] − E[x]², so the two
    agree to f32 rounding, not bit for bit. With ``sync_group`` set (by
    :func:`sync_batch_stats`) they are the gang's: :class:`_SyncBatchNorm`
    over the process group, flax's E[x²] − E[x]² over the global
    batch."""

    def __init__(self, features: int, eps: float, momentum: float = 0.9):
        super().__init__()
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.sync_group = None  # a process group while sync_batch_stats

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.sync_group is not None:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                                self.eps, self.sync_group)
        else:
            y, mean, invstd = \
                torch.ops.aten._native_batch_norm_legit.no_stats(
                    x, self.weight, self.bias, True, 0.0, self.eps)
            with torch.no_grad():
                var = invstd.double().pow(-2).sub_(self.eps).clamp_(min=0)
        with torch.no_grad():
            m = self.momentum
            new_mean = self.running_mean * m \
                + mean.to(self.running_mean.dtype) * (1 - m)
            new_var = self.running_var * m \
                + var.to(self.running_var.dtype) * (1 - m)
        return y, (new_mean, new_var)


def _channel_dims(x) -> tuple[list, list]:
    """(the dims a channel's statistics reduce over, the shape that
    broadcasts a per-channel vector against ``x``)."""
    return ([0] + list(range(2, x.ndim)),
            [1, x.shape[1]] + [1] * (x.ndim - 2))


class _SyncBatchNorm(torch.autograd.Function):
    """BatchNorm in train mode over the global batch of a process group.

    Forward: each rank's per-channel ``[Σx, Σx², n]`` in f32, one
    all-reduce (sum), then ``mean = Σx/N`` and ``var = max(Σx²/N − mean²,
    0)``: flax's fast variance over the global batch, what the
    reference's GSPMD step computes. ``y = (x − mean)·(rsqrt(var + eps)·w)
    + b`` in f32, cast to the input's dtype, as flax's ``_normalize``.

    Backward: each rank's ``[Σdy, Σdy·x̂]``, one all-reduce (sum), then
    ``dx = (dy − Σdy/N − x̂·Σdy·x̂/N)·rsqrt(var + eps)·w``. The scale and
    bias gradients are the rank's own sums: the step's gradient mean over
    the ranks makes them the global batch's. Each rank's ``dy`` is the
    gradient of its own mean loss, so ``dx`` is the rank count times the
    global mean loss's, as every other local gradient is; the step's
    mean divides that out.

    At world size 1 the all-reduces leave the sums as they are. Each call
    issues two collectives (forward, backward), so every rank must run the
    same BatchNorms in the same order; ``torch.utils.checkpoint`` re-runs
    the forward, and with it the forward's all-reduce, in the backward on
    every rank alike."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        dims, shape = _channel_dims(x)
        c = x.shape[1]
        xf = x.float()
        sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                          xf.new_full((1,), x.numel() // c)])
        dist.all_reduce(sums, group=group)
        count = sums[2 * c:]
        mean = sums[:c] / count
        var = (sums[c:2 * c] / count - mean * mean).clamp_(min=0)
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean.view(shape)) * (invstd * weight).view(shape) \
            + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, count = ctx.saved_tensors
        dims, shape = _channel_dims(x)
        c = x.shape[1]
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        dyf = dy.float()
        sums = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        dbias, dweight = sums[:c].clone(), sums[c:].clone()
        dist.all_reduce(sums, group=ctx.group)
        dx = (dyf - (sums[:c] / count).view(shape)
              - xhat * (sums[c:] / count).view(shape)) \
            * (invstd * weight).view(shape)
        return dx.to(x.dtype), dweight, dbias, None, None


@contextlib.contextmanager
def sync_batch_stats(model: nn.Module, group):
    """Every :class:`BatchNorm` of ``model`` in train mode takes its batch
    statistics over ``group``'s global batch while the context is open
    (``group`` a ``torch.distributed`` process group); on leaving it, each
    goes back to its own batch. The data-parallel train step enters it
    around its forward and backward."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in layers:
        m.sync_group = group
    try:
        yield
    finally:
        for m in layers:
            m.sync_group = None


def batch_norm(layer: BatchNorm, name: str, x, stats: dict | None):
    """``layer(x)``; in train mode (``stats`` a dict) also files its new
    running statistics in ``stats`` under the buffers' names relative to
    the caller, ``<name>.running_mean`` and ``<name>.running_var``."""
    if stats is None:
        return layer(x)
    y, (mean, var) = layer(x, train=True)
    stats[f"{name}.running_mean"] = mean
    stats[f"{name}.running_var"] = var
    return y


class Dense(nn.Module):
    """flax ``nn.Dense`` (kernel ``(in, out)``) as ``F.linear`` (weight
    ``(out, in)``), computing in ``dtype`` (None: the input's)."""

    def __init__(self, in_features: int, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dt = self.dtype or x.dtype
        x = x.to(dt)
        return F.linear(x, self.weight.to(dt), self.bias.to(dt))


def max_pool(x, window, strides, padding="VALID"):
    """flax ``nn.max_pool``: the padding (``"SAME"`` by flax's rule, or
    explicit pairs) holds −inf."""
    window, strides = _pair(window), _pair(strides)
    (lh, hh), (lw, hw) = _resolve_pads(padding, x.shape[-2:], window,
                                       strides)
    if lh == hh and lw == hw and 2 * lh <= window[0] \
            and 2 * lw <= window[1]:
        return F.max_pool2d(x, window, strides, (lh, lw))
    x = F.pad(x, (lw, hw, lh, hh), value=-math.inf)
    return F.max_pool2d(x, window, strides)


def avg_pool_same(x):
    """flax ``nn.avg_pool(x, (3, 3), (1, 1), "SAME",
    count_include_pad=False)``."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def nhwc_to_model(x, dtype):
    """An NHWC tensor → the logical NCHW, channels-last tensor the layers
    take, in ``dtype`` (flax's ``x.astype(self.dtype)`` at the model's
    top)."""
    return x.permute(0, 3, 1, 2).to(dtype=dtype,
                                    memory_format=torch.channels_last)


def global_mean_f32(x):
    """The global average pool → (N, C), averaged in the activation dtype
    (accumulated in f32) and then cast to f32, as the flax models'
    ``jnp.mean(x, (1, 2)).astype(jnp.float32)`` does."""
    return x.mean(dim=(2, 3)).float()


_TRUNC = 0.87962566103423978  # std of a unit normal truncated at ±2


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax ``lecun_normal``: a normal truncated at ±2 standard deviations,
    scaled to std ``sqrt(1 / fan_in)``, drawn by the inverse CDF from
    ``gen``'s uniforms."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.empty(t.shape, dtype=torch.float64).uniform_(lo, hi,
                                                           generator=gen)
    z = (torch.erfinv(u) * math.sqrt(2)).clamp_(-2.0, 2.0)
    t.copy_(z * (math.sqrt(1.0 / fan_in) / _TRUNC))


@torch.no_grad()
def init_flax_defaults(module: nn.Module, seed: int) -> nn.Module:
    """Draw every :class:`Conv` and :class:`Dense` kernel of ``module``
    from one CPU ``torch.Generator`` seeded by ``seed``, in registration
    order; set biases to 0 and BatchNorm to scale 1, bias 0, mean 0,
    variance 1. The same seed gives the same weights on every device: the
    draw happens on the CPU, before the module moves."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in module.modules():
        if isinstance(m, Conv):
            fan_in = m.weight.shape[1] * m.kernel[0] * m.kernel[1]
            _lecun_normal_(m.weight, fan_in, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Dense):
            _lecun_normal_(m.weight, m.weight.shape[1], gen)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return module
