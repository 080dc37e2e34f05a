"""Pretrained-weight plumbing for the perceptual backbones.

Counterpart of generativemodels_tpu/networks/pretrained.py: the name maps of
the original checkpoints (torchvision AlexNet / VGG16 / SqueezeNet1.1 /
ResNet50, RadImageNet ResNet50, MedicalNet 3D ResNet10 / 50) and the
loaders. The port's backbones carry the checkpoints' own names, so a
checkpoint loads by `load_state_dict` after `strip_prefixes`; each map
(torch module name -> the JAX module's parameter path) selects which of a
checkpoint's modules the backbone holds, and `networks/convert.py` reads it
backwards to carry JAX parameters over. No weight file is in the
repository: obtain a checkpoint elsewhere, save it with `torch.save`, and
pass its path to `PerceptualLoss(pretrained_path=...)`.
`load_reference_checkpoint` loads a reference bundle's checkpoint into any
port network.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

_BUFFERS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _vgg16_name_map() -> dict[str, str]:
    torch_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    return {f"features.{t}": f"conv{i}" for i, t in enumerate(torch_idx)}


def _squeezenet_name_map() -> dict[str, str]:
    # torchvision squeezenet1_1 .features Fire indices 3,4,6,7,9,10,11,12
    m = {"features.0": "conv1"}
    for fire, idx in enumerate([3, 4, 6, 7, 9, 10, 11, 12], start=2):
        for sub in ("squeeze", "expand1x1", "expand3x3"):
            m[f"features.{idx}.{sub}"] = f"fire{fire}/{sub}"
    return m


def _resnet_name_map(layers: tuple[int, ...], blocks_have_bn3: bool) -> dict[str, str]:
    m = {"conv1": "conv1", "bn1": "bn1"}
    n_convs = 3 if blocks_have_bn3 else 2
    for stage, reps in enumerate(layers, start=1):
        for r in range(reps):
            for k in range(1, n_convs + 1):
                m[f"layer{stage}.{r}.conv{k}"] = f"layer{stage}_{r}/conv{k}"
                m[f"layer{stage}.{r}.bn{k}"] = f"layer{stage}_{r}/bn{k}"
            m[f"layer{stage}.{r}.downsample.0"] = f"layer{stage}_{r}/conv_down"
            m[f"layer{stage}.{r}.downsample.1"] = f"layer{stage}_{r}/bn_down"
    return m


#: torch checkpoint module names -> JAX parameter paths, per backbone
NAME_MAPS: dict[str, dict[str, str]] = {
    # torchvision alexnet .features conv indices 0,3,6,8,10 (LPIPS taps)
    "alex": {
        "features.0": "conv1",
        "features.3": "conv2",
        "features.6": "conv3",
        "features.8": "conv4",
        "features.10": "conv5",
    },
    "vgg": _vgg16_name_map(),
    "squeeze": _squeezenet_name_map(),
    # torchvision / RadImageNet ResNet50 (bottleneck, layers 3-4-6-3)
    "resnet50": _resnet_name_map((3, 4, 6, 3), blocks_have_bn3=True),
    "radimagenet_resnet50": _resnet_name_map((3, 4, 6, 3), blocks_have_bn3=True),
    # MedicalNet 3D ResNets (basic blocks for resnet10)
    "medicalnet_resnet10_23datasets": _resnet_name_map((1, 1, 1, 1), blocks_have_bn3=False),
    "medicalnet_resnet50_23datasets": _resnet_name_map((3, 4, 6, 3), blocks_have_bn3=True),
}
NAME_MAPS["medicalnet_resnet10"] = NAME_MAPS["medicalnet_resnet10_23datasets"]
NAME_MAPS["medicalnet_resnet50"] = NAME_MAPS["medicalnet_resnet50_23datasets"]
NAME_MAPS["torchvision"] = NAME_MAPS["resnet50"]
NAME_MAPS["radimagenet"] = NAME_MAPS["radimagenet_resnet50"]


def strip_prefixes(state_dict: dict) -> dict:
    """Drop DataParallel / hub wrappers: 'module.' (MedicalNet) and 'net.' (lpips)."""
    out = {}
    for k, v in state_dict.items():
        for prefix in ("module.", "net."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    return out


def backbone_state_dict(state_dict: dict, network_type: str) -> dict[str, torch.Tensor]:
    """A checkpoint's entries that the backbone holds (its map's modules,
    wrappers stripped), as tensors for the port's `load_state_dict`; the
    classifier heads and the like drop out."""
    if network_type not in NAME_MAPS:
        raise ValueError(f"no NAME_MAP for {network_type!r}; known: {sorted(NAME_MAPS)}")
    modules = NAME_MAPS[network_type]
    out = {}
    for key, value in strip_prefixes(state_dict).items():
        module, _, leaf = key.rpartition(".")
        if module in modules and leaf in _BUFFERS:
            out[key] = torch.as_tensor(value)
    return out


def load_lpips_lin_weights(state_dict: dict) -> list[torch.Tensor]:
    """LPIPS' learned per-layer channel weights: `lin{i}.model.1.weight` (or
    `lins.{i}...`), (1, C_i, 1, 1) each, as (C_i,) tensors by layer index."""
    state_dict = strip_prefixes(state_dict)
    weights = []
    i = 0
    while True:
        w = state_dict.get(f"lin{i}.model.1.weight")
        if w is None:
            w = state_dict.get(f"lins.{i}.model.1.weight")
        if w is None:
            break
        weights.append(torch.as_tensor(w).reshape(-1))
        i += 1
    if not weights:
        raise ValueError("no lin{i}.model.1.weight entries found in state dict")
    return weights


def _load_state_dict(path: str, state_dict_key: str | None = None) -> dict:
    """A torch .pt/.pth checkpoint as a flat dict; `state_dict_key` selects a
    sub-dict, else a "state_dict" wrapper (MedicalNet's) is unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if state_dict_key is not None:
        obj = obj[state_dict_key]
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def load_pretrained_perceptual(
    network_type: str,
    backbone_path: str,
    lin_path: str | None = None,
    state_dict_key: str | None = None,
) -> dict:
    """{"state_dict": the backbone's entries, "lin_weights": LPIPS heads or
    None}: splat into `PerceptualLoss(..., **loaded)`."""
    state_dict = backbone_state_dict(_load_state_dict(backbone_path, state_dict_key),
                                     network_type)
    lin_weights = None
    if lin_path is not None:
        lin_weights = load_lpips_lin_weights(_load_state_dict(lin_path))
    return {"state_dict": state_dict, "lin_weights": lin_weights}


def load_reference_checkpoint(checkpoint: str | dict, model: nn.Module) -> nn.Module:
    """Load a reference bundle's torch checkpoint into a port module.

    Counterpart of generativemodels_tpu/networks/zoo_convert.py's
    `load_reference_checkpoint`, which converts the same state dict to flax
    variables; the port's modules carry the reference's own keys, so this
    is a strict `load_state_dict` after the unwrapping the JAX function
    does: a `{"state_dict": ...}` container and DataParallel's `module.`
    prefix (`strip_prefixes`)::

        unet = parser.get_parsed_content("network_def")
        load_reference_checkpoint("models/model.pt", unet)

    Args:
        checkpoint: a .pt/.pth file (read with `weights_only=True`), a .npz
            of arrays, or an in-memory state dict.
        model: the port module the weights target.

    Returns:
        `model`, holding the checkpoint's weights. A missing or unexpected
        key raises RuntimeError.
    """
    if isinstance(checkpoint, dict):
        state_dict = checkpoint
        if isinstance(state_dict.get("state_dict"), dict):
            state_dict = state_dict["state_dict"]
    elif str(checkpoint).endswith(".npz"):
        with np.load(checkpoint) as f:
            state_dict = {k: f[k] for k in f.files}
    else:
        state_dict = _load_state_dict(str(checkpoint))
    model.load_state_dict(
        {k: torch.as_tensor(v) for k, v in strip_prefixes(state_dict).items()}, strict=True
    )
    return model

