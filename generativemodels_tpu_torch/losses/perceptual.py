"""Perceptual losses with LPIPS / RadImageNet / MedicalNet / ResNet backends.

Counterpart of generativemodels_tpu/losses/perceptual.py: `PerceptualLoss`
over (B, C, *spatial) images, with the LPIPS backends (AlexNet, VGG16,
SqueezeNet1.1 taps: channel-normalised feature distances, averaged over
channels, or weighted by LPIPS' learned heads), the ResNet backends
(torchvision / RadImageNet ResNet50 in 2D, MedicalNet ResNet10 / 50 in 3D:
channel-normalised layer4 distances summed over channels) and the 2.5D pass
for volumes, whose slices along each spatial axis become a batch of 2D
images of which a random `fake_3d_ratio` is kept. The slice choice is drawn
from the `torch.Generator` passed to the call (`slice_indices` is the seam
that draws it). The backbones run with the weights supplied
(`state_dict`, `lin_weights`, or a checkpoint at `pretrained_path`) or,
for development only, with torch's random initialisation: no weight file
is in the repository and none can be fetched.
"""
from __future__ import annotations

import os
import warnings

import torch

from ..networks.backbones import (
    AlexNetFeatures,
    ResNetFeatures,
    SqueezeNetFeatures,
    VGG16Features,
)


def normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalise across the channel axis (1) of (B, C, *spatial)."""
    return x / (torch.sqrt(torch.sum(x**2, dim=1, keepdim=True)) + eps)


def spatial_average(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes of (B, C, *spatial), kept as size 1."""
    return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)


_LPIPS_NETS = {"alex": AlexNetFeatures, "vgg": VGG16Features, "squeeze": SqueezeNetFeatures}
# ImageNet normalisation of the LPIPS scaling layer (images in [-1, 1])
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def _channels(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device).reshape(
        (1, -1) + (1,) * (like.ndim - 2))


class _LPIPSBackend:
    """Multi-layer normalised feature distances; averaged over channels
    without `lin_weights`, weighted and summed with them (full LPIPS)."""

    def __init__(self, net: str, state_dict=None, lin_weights=None) -> None:
        self.module = _LPIPS_NETS[net]().eval()
        if state_dict is not None:
            self.module.load_state_dict(state_dict, strict=True)
        self.lin_weights = lin_weights

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        shift, scale = _channels(_LPIPS_SHIFT, input), _channels(_LPIPS_SCALE, input)
        feats_x = self.module((input - shift) / scale)
        feats_y = self.module((target - shift) / scale)
        total = 0.0
        for i, (fx, fy) in enumerate(zip(feats_x, feats_y)):
            diff = (normalize_tensor(fx) - normalize_tensor(fy)) ** 2
            if self.lin_weights is not None:
                w = torch.as_tensor(self.lin_weights[i], dtype=diff.dtype, device=diff.device)
                total = total + spatial_average(torch.sum(diff * w.reshape(1, -1, 1, 1), dim=1,
                                                          keepdim=True))
            else:
                total = total + spatial_average(torch.mean(diff, dim=1, keepdim=True))
        return total


class _ResNetBackend:
    """RadImageNet / torchvision ResNet50 (2D) or MedicalNet ResNet10 / 50 (3D)."""

    def __init__(self, mode: str, state_dict=None) -> None:
        self.mode = mode  # "radimagenet" | "torchvision" | "medicalnet_resnet10" | "..._resnet50"
        if mode == "medicalnet_resnet10":
            self.module = ResNetFeatures(spatial_dims=3, block="basic", layers=(1, 1, 1, 1))
        elif mode == "medicalnet_resnet50":
            self.module = ResNetFeatures(spatial_dims=3)
        else:
            self.module = ResNetFeatures(spatial_dims=2)
        self.module.eval()
        if state_dict is not None:
            self.module.load_state_dict(state_dict, strict=True)

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.mode in ("radimagenet", "torchvision"):
            if input.shape[1] == 1:
                input, target = input.repeat(1, 3, 1, 1), target.repeat(1, 3, 1, 1)
            if self.mode == "radimagenet":
                # RGB -> BGR, then the mean subtracted
                mean = _channels((0.406, 0.456, 0.485), input)
                input, target = input.flip(1) - mean, target.flip(1) - mean
            else:
                mean = _channels((0.485, 0.456, 0.406), input)
                std = _channels((0.229, 0.224, 0.225), input)
                input, target = (input - mean) / std, (target - mean) / std
        else:  # MedicalNet: one z-score over the batch (population std, as jnp.std)
            input = (input - input.mean()) / input.std(correction=0)
            target = (target - target.mean()) / target.std(correction=0)
        diff = (normalize_tensor(self.module(input)) - normalize_tensor(self.module(target))) ** 2
        return spatial_average(torch.sum(diff, dim=1, keepdim=True))


class PerceptualLoss:
    """Feature-space perceptual loss over (B, C, *spatial) images.

    Args:
        spatial_dims: 2 or 3.
        network_type: "alex" | "vgg" | "squeeze" | "radimagenet_resnet50" |
            "medicalnet_resnet10_23datasets" | "medicalnet_resnet50_23datasets"
            | "resnet50".
        is_fake_3d: the 2.5D pass for 3D inputs.
        fake_3d_ratio: the share of slices an axis keeps in the 2.5D pass.
        pretrained: True with no weights supplied warns that the backbone runs
            with random weights; False or "allow_random" acknowledges it.
        state_dict / lin_weights: the backbone's weights under its checkpoint
            names and LPIPS' heads (see `networks.pretrained`).
        pretrained_path / lin_path / pretrained_state_dict_key: a checkpoint
            to load them from; `cache_dir` is searched for
            `<network_type>.{pt,pth}` when no path is given.
    The networks live on the CPU until moved with `to(device)`.
    """

    def __init__(
        self,
        spatial_dims: int,
        network_type: str = "alex",
        is_fake_3d: bool = True,
        fake_3d_ratio: float = 0.5,
        pretrained: bool | str = True,
        state_dict: dict | None = None,
        lin_weights=None,
        pretrained_path: str | None = None,
        lin_path: str | None = None,
        cache_dir: str | None = None,
        pretrained_state_dict_key: str | None = None,
    ) -> None:
        if spatial_dims not in (2, 3):
            raise NotImplementedError("Perceptual loss is implemented only in 2D and 3D.")
        if (spatial_dims == 2 or is_fake_3d) and "medicalnet_" in network_type:
            raise ValueError(
                "MedicalNet networks are only compatible with spatial_dims=3. "
                "Argument is_fake_3d must be set to False."
            )
        self.spatial_dims = spatial_dims
        self.is_fake_3d = is_fake_3d
        self.fake_3d_ratio = fake_3d_ratio
        if pretrained_path is None and cache_dir is not None:
            for ext in (".pt", ".pth"):
                candidate = os.path.join(cache_dir, network_type + ext)
                if os.path.exists(candidate):
                    pretrained_path = candidate
                    break
        if (pretrained is True and pretrained_path is None and state_dict is None
                and lin_weights is None):
            warnings.warn(
                "PerceptualLoss(pretrained=True) has no weights to load: no "
                "pretrained_path/state_dict/lin_weights were supplied and none can be "
                "downloaded. The backbone will run with RANDOM weights — the loss is NOT "
                "a perceptual metric. Pass pretrained_path=<torch checkpoint>, or set "
                "pretrained=False (or pretrained='allow_random') to acknowledge random init.",
                UserWarning, stacklevel=2,
            )
        if pretrained_path is not None:
            from ..networks.pretrained import load_pretrained_perceptual

            loaded = load_pretrained_perceptual(network_type, pretrained_path, lin_path=lin_path,
                                                state_dict_key=pretrained_state_dict_key)
            state_dict = loaded["state_dict"]
            lin_weights = loaded["lin_weights"] or lin_weights

        if spatial_dims == 3 and not is_fake_3d:
            kind = "medicalnet_resnet50" if "resnet50" in network_type else "medicalnet_resnet10"
            self.backend = _ResNetBackend(kind, state_dict)
        elif "radimagenet_" in network_type:
            self.backend = _ResNetBackend("radimagenet", state_dict)
        elif network_type == "resnet50":
            self.backend = _ResNetBackend("torchvision", state_dict)
        elif network_type in _LPIPS_NETS:
            self.backend = _LPIPSBackend(network_type, state_dict, lin_weights)
        else:
            raise ValueError(f"Unsupported network_type: {network_type}")

    def to(self, device) -> PerceptualLoss:
        self.backend.module.to(device)
        return self

    def slice_indices(self, n_total: int, n_keep: int, generator, device) -> torch.Tensor:
        """The 2.5D pass's random choice of `n_keep` of `n_total` slices."""
        return torch.randperm(n_total, generator=generator, device=device)[:n_keep]

    def _axis_loss(self, input, target, spatial_axis: int, generator) -> torch.Tensor:
        """2.5D: the slices along one spatial axis become batch entries."""
        preserved = [2, 3, 4]
        preserved.remove(spatial_axis)

        def batchify(x):
            s = x.permute(0, spatial_axis, 1, *preserved)
            return s.reshape(-1, *s.shape[2:])

        input_slices, target_slices = batchify(input), batchify(target)
        n_total = input_slices.shape[0]
        indices = self.slice_indices(n_total, int(n_total * self.fake_3d_ratio), generator,
                                     input.device)
        return torch.mean(self.backend(input_slices[indices], target_slices[indices]))

    def __call__(self, input: torch.Tensor, target: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        if target.shape != input.shape:
            raise ValueError(
                f"ground truth has differing shape ({target.shape}) from input ({input.shape})"
            )
        if self.spatial_dims == 3 and self.is_fake_3d:
            loss = sum(self._axis_loss(input, target, axis, generator) for axis in (2, 3, 4))
        else:
            loss = self.backend(input, target)
        return torch.mean(loss)
