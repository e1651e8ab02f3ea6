"""Visual frontend of AV-HuBERT: a 3-D conv stem and a per-frame ResNet-18.

Port of ``avsl_tpu/models/resnet3d.py`` (``TimeChannelStemConv``,
``ChannelPReLU``, ``BasicBlock``, ``ResNetTrunk``, ``ResNet3DFrontend``),
with the fairseq AV-HuBERT state-dict names (which Auto-AVSR's
``Conv3dResNet`` shares; its swish has no parameters):
``frontend3D.0`` (the [C, 1, 5, 7, 7] stem kernel), ``frontend3D.1`` (its
BatchNorm), ``frontend3D.2`` (its PReLU) and
``trunk.layerS.B.{conv1, bn1, relu1, conv2, bn2, relu2, downsample.{0,1}}``.

As in the JAX package, the stem (k=(5,7,7), stride (1,2,2), one input
channel) runs as a 2-D convolution with the five temporal taps stacked on
the channel axis, so every frame of a clip batch goes through the 2-D
trunk as one batch with no transpose; the convolutions themselves are
PyTorch's (cuDNN on the card), as XLA computes them in the JAX package.
BatchNorm runs in fp32 on the compute-dtype activations, cast back, as
flax's ``BatchNorm(momentum=0.9, dtype=float32)`` does: on the running
statistics when ``use_running_average`` (the default, as in JAX), else on
the batch's statistics, which then update the running ones. Its weight,
bias and statistics and the PReLU slopes are fp32, the convolution kernels
live in ``param_dtype`` and are cast to the compute dtype at use.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from avsl_tpu_torch.core.mesh import all_reduce_sum, current_row_shard
from avsl_tpu_torch.models.layers import cast_param, recomputing


class CastConv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias are cast to ``compute_dtype`` at
    use when they are stored in another dtype."""

    def __init__(self, *args, param_dtype=torch.bfloat16, compute_dtype=None, **kw):
        super().__init__(*args, dtype=param_dtype, **kw)
        self.compute_dtype = compute_dtype or param_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, cast_param(self.weight, self.compute_dtype),
                                  cast_param(self.bias, self.compute_dtype))


class BatchNormF32(nn.Module):
    """BatchNorm over dim 1: fp32 ``weight``, ``bias``, ``running_mean`` and
    ``running_var``, computed in fp32 on the activations and cast back to
    their dtype.

    With ``use_running_average=False`` it is flax's training BatchNorm
    (``use_fast_variance=True``): the batch mean and the biased variance
    ``max(0, E[x^2] - E[x]^2)`` over every non-channel position, in fp32,
    normalise the batch (``(x - mean) * (rsqrt(var + eps) * weight) +
    bias``), and the buffers become ``momentum * running + (1 - momentum)
    * batch`` with the biased variance. ``F.batch_norm`` in training would
    store the unbiased variance instead. A remat recompute
    (:func:`~avsl_tpu_torch.models.layers.recomputing`) normalises the same
    way and leaves the buffers alone: flax updates ``batch_stats`` once.
    Inside a data-parallel step whose rows are sharded
    (``core/mesh.py::row_shard_scope``) the sums of ``x`` and ``x^2`` are
    added over the data ranks first, so the statistics are the global
    batch's, as under JAX's jit."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9, device=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.empty(channels, **f32))
        self.bias = nn.Parameter(torch.empty(channels, **f32))
        self.register_buffer("running_mean", torch.empty(channels, **f32))
        self.register_buffer("running_var", torch.empty(channels, **f32))

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        del generator  # deterministic: unit scale, zero shift, unit statistics
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, use_running_average: bool = True) -> torch.Tensor:
        if use_running_average:
            return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps).to(x.dtype)
        xf = x.float()
        axes = [d for d in range(x.ndim) if d != 1]
        rows = current_row_shard()
        if rows is None:
            mean = xf.mean(dim=axes)
            var = torch.clamp_min(xf.square().mean(dim=axes) - mean.square(), 0.0)
        else:
            sums = all_reduce_sum(torch.stack([xf.sum(dim=axes), xf.square().sum(dim=axes)]),
                                  rows.group)
            n = (xf.numel() // xf.shape[1]) * rows.size
            mean = sums[0] / n
            var = torch.clamp_min(sums[1] / n - mean.square(), 0.0)
        if not recomputing():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        shape = [1, -1] + [1] * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class ChannelPReLU(nn.Module):
    """Per-channel PReLU over dim 1 (torch ``nn.PReLU(num_parameters=C)``):
    an fp32 slope per channel, 0.25 at initialisation, cast to the
    activation dtype at use."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device, dtype=torch.float32))

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        del generator
        self.weight.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


def _activation(relu_type: str, channels: int, device) -> nn.Module:
    """``relu_type``: "prelu" (a slope per channel), "swish" (``x *
    sigmoid(x)``, Auto-AVSR's) or "relu"."""
    if relu_type == "prelu":
        return ChannelPReLU(channels, device=device)
    return nn.SiLU() if relu_type == "swish" else nn.ReLU()


class BasicBlock(nn.Module):
    """ResNet basic block: conv3x3 (stride) -> BN -> act -> conv3x3 -> BN,
    plus the identity or a 1x1 strided conv + BN, then act."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, relu_type: str = "prelu",
                 dtype=torch.bfloat16, param_dtype=None, device=None):
        super().__init__()
        conv = dict(bias=False, device=device, param_dtype=param_dtype or dtype,
                    compute_dtype=dtype)
        self.conv1 = CastConv2d(in_planes, planes, 3, stride=stride, padding=1, **conv)
        self.bn1 = BatchNormF32(planes, device=device)
        self.relu1 = _activation(relu_type, planes, device)
        self.conv2 = CastConv2d(planes, planes, 3, stride=1, padding=1, **conv)
        self.bn2 = BatchNormF32(planes, device=device)
        self.relu2 = _activation(relu_type, planes, device)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                CastConv2d(in_planes, planes, 1, stride=stride, **conv),
                BatchNormF32(planes, device=device),
            )

    def forward(self, x: torch.Tensor, use_running_average: bool = True) -> torch.Tensor:
        out = self.relu1(self.bn1(self.conv1(x), use_running_average))
        out = self.bn2(self.conv2(out), use_running_average)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](self.downsample[0](x), use_running_average)
        return self.relu2(out + residual)


class ResNetTrunk(nn.Module):
    """2-D ResNet-18 trunk: [N, C0, H, W] -> [N, planes[-1]] (global mean)."""

    def __init__(self, in_planes: int, layers: Sequence[int] = (2, 2, 2, 2),
                 planes: Sequence[int] = (64, 128, 256, 512), relu_type: str = "prelu",
                 dtype=torch.bfloat16, param_dtype=None, device=None):
        super().__init__()
        for stage, (n_blocks, width) in enumerate(zip(layers, planes)):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(BasicBlock(in_planes, width, stride, relu_type, dtype=dtype,
                                         param_dtype=param_dtype, device=device))
                in_planes = width
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, use_running_average: bool = True) -> torch.Tensor:
        for stage in self.children():
            for block in stage:
                x = block(x, use_running_average)
        return x.mean(dim=(2, 3))


class ResNet3DFrontend(nn.Module):
    """Lip-clip encoder: [B, T, H, W(, 1)] -> [B, T, backbone_channels].

    Stem: Conv3D(1 -> frontend_channels, k=(5,7,7), s=(1,2,2), padding
    (2,3,3)) + BN + PReLU + MaxPool (1,3,3)/(1,2,2) with padding 1; then
    the time axis folds into the batch and all frames run through the 2-D
    ResNet trunk together. Takes the clip with or without the trailing
    singleton channel.
    """

    def __init__(self, frontend_channels: int = 64, backbone_channels: int = 512,
                 relu_type: str = "prelu", dtype=torch.bfloat16, param_dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        pdtype = param_dtype or dtype
        self.backbone_channels = backbone_channels
        self.frontend3D = nn.Sequential(
            nn.Conv3d(1, frontend_channels, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3),
                      bias=False, device=device, dtype=pdtype),
            BatchNormF32(frontend_channels, device=device),
            _activation(relu_type, frontend_channels, device),
        )
        bc = backbone_channels
        self.trunk = ResNetTrunk(
            frontend_channels,
            planes=(max(bc // 8, 8), max(bc // 4, 8), max(bc // 2, 8), bc),
            relu_type=relu_type, dtype=dtype, param_dtype=pdtype, device=device,
        )

    def stem(self, video: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W] -> [B*T, C, H/2, W/2]: the Conv3D as a 2-D conv over
        the five time-shifted frames t-2..t+2 (zeros past either end)."""
        b, t, h, w = video.shape
        xp = F.pad(video.to(self.dtype), (0, 0, 0, 0, 2, 2))  # conv3d's time padding
        taps = torch.stack([xp[:, i:i + t] for i in range(5)], dim=2).reshape(b * t, 5, h, w)
        kernel = cast_param(self.frontend3D[0].weight, self.dtype)[:, 0]  # [C, 5, 7, 7]
        return F.conv2d(taps, kernel, stride=2, padding=3)

    def forward(self, video: torch.Tensor, use_running_average: bool = True) -> torch.Tensor:
        if video.ndim == 5:
            video = video[..., 0]
        b, t = video.shape[:2]
        x = self.frontend3D[2](self.frontend3D[1](self.stem(video), use_running_average))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        return self.trunk(x, use_running_average).view(b, t, self.backbone_channels)
