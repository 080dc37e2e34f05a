"""Feature-extractor backbones for perceptual losses, channels-first.

Counterpart of generativemodels_tpu/networks/backbones.py: AlexNet, VGG16
and SqueezeNet1.1 features (the LPIPS taps), the 2D ResNet50 trunk
(torchvision / RadImageNet) and the 3D MedicalNet ResNets (10: basic
blocks, 50: bottlenecks). Architectures only: the parameter names are the
torchvision and MedicalNet names (`features.{i}`, `conv1`, `bn1`,
`layer{s}.{r}.conv{k}`, `.downsample.{0,1}`), so a checkpoint of the
original network loads by `load_state_dict` (after
`networks.pretrained.strip_prefixes`). No weight file ships with the
package. BatchNorm computes in eval mode with its running statistics, as
the JAX module runs it (`use_running_average=True`).
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["AlexNetFeatures", "VGG16Features", "SqueezeNetFeatures", "ResNetFeatures"]

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_BN = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet `.features`; forward returns the 5 ReLU taps."""

    TAPS = (1, 4, 7, 9, 11)

    def __init__(self) -> None:
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return _taps(self.features, x, self.TAPS)


class VGG16Features(nn.Module):
    """torchvision VGG16 `.features`; forward returns the 5 ReLU taps (the
    last ReLU of each block, before its max-pool)."""

    def __init__(self) -> None:
        super().__init__()
        layers: list[nn.Module] = []
        taps, c_in = [], 3
        for block, (c, reps) in enumerate(((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))):
            for _ in range(reps):
                layers += [nn.Conv2d(c_in, c, 3, 1, 1), nn.ReLU()]
                c_in = c
            taps.append(len(layers) - 1)
            if block < 4:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.taps = tuple(taps)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return _taps(self.features, x, self.taps)


class _Fire(nn.Module):
    def __init__(self, c_in: int, squeeze: int, expand: int) -> None:
        super().__init__()
        self.squeeze = nn.Conv2d(c_in, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


class SqueezeNetFeatures(nn.Module):
    """torchvision SqueezeNet1.1 `.features`; forward returns the 7 LPIPS
    taps (after conv1's ReLU, fire3, fire5, fire6, fire7, fire8, fire9)."""

    TAPS = (1, 4, 7, 9, 10, 11, 12)

    def __init__(self) -> None:
        super().__init__()
        pool = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 3, 2), nn.ReLU(), pool,
            _Fire(64, 16, 64), _Fire(128, 16, 64), pool,
            _Fire(128, 32, 128), _Fire(256, 32, 128), pool,
            _Fire(256, 48, 192), _Fire(384, 48, 192), _Fire(384, 64, 256),
            _Fire(512, 64, 256),
        )

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return _taps(self.features, x, self.TAPS)


def _taps(features: nn.Sequential, x: torch.Tensor, taps: Sequence[int]) -> list[torch.Tensor]:
    out = []
    for i, layer in enumerate(features):
        x = layer(x)
        if i in taps:
            out.append(x)
        if i == taps[-1]:
            break
    return out


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, spatial_dims: int, c_in: int, features: int, stride: int) -> None:
        super().__init__()
        conv, bn = _CONV[spatial_dims], _BN[spatial_dims]
        self.conv1 = conv(c_in, features, 1, bias=False)
        self.bn1 = bn(features)
        self.conv2 = conv(features, features, 3, stride, 1, bias=False)
        self.bn2 = bn(features)
        self.conv3 = conv(features, features * 4, 1, bias=False)
        self.bn3 = bn(features * 4)
        self.downsample = None
        if c_in != features * 4 or stride != 1:
            self.downsample = nn.Sequential(
                conv(c_in, features * 4, 1, stride, bias=False), bn(features * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (self.downsample(x) if self.downsample is not None else x))


class _BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, spatial_dims: int, c_in: int, features: int, stride: int) -> None:
        super().__init__()
        conv, bn = _CONV[spatial_dims], _BN[spatial_dims]
        self.conv1 = conv(c_in, features, 3, stride, 1, bias=False)
        self.bn1 = bn(features)
        self.conv2 = conv(features, features, 3, 1, 1, bias=False)
        self.bn2 = bn(features)
        self.downsample = None
        if c_in != features or stride != 1:
            self.downsample = nn.Sequential(conv(c_in, features, 1, stride, bias=False),
                                            bn(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + (self.downsample(x) if self.downsample is not None else x))


class ResNetFeatures(nn.Module):
    """ResNet trunk (2D ResNet50, or 3D MedicalNet ResNet10 / 50); forward
    returns the last stage's (layer4) activation. `in_channels` is 3 for the
    2D networks and 1 for MedicalNet's."""

    def __init__(
        self,
        spatial_dims: int = 2,
        block: str = "bottleneck",
        layers: Sequence[int] = (3, 4, 6, 3),
        in_channels: int | None = None,
    ) -> None:
        super().__init__()
        in_channels = in_channels or (3 if spatial_dims == 2 else 1)
        self.spatial_dims = spatial_dims
        self.conv1 = _CONV[spatial_dims](in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _BN[spatial_dims](64)
        block_cls = _Bottleneck if block == "bottleneck" else _BasicBlock
        c_in, features = 64, 64
        for stage, reps in enumerate(layers):
            blocks = []
            for r in range(reps):
                stride = 2 if stage > 0 and r == 0 else 1
                blocks.append(block_cls(spatial_dims, c_in, features, stride))
                c_in = features * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            features *= 2
        self.num_stages = len(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = _MAX_POOL[self.spatial_dims](h, 3, 2, padding=1)
        for stage in range(self.num_stages):
            h = getattr(self, f"layer{stage + 1}")(h)
        return h
