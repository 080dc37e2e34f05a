"""JAX parameter trees -> state dicts of the port's modules.

Counterpart of the UNet part of generativemodels_tpu/networks/zoo_convert.py,
in the other direction: a flax params tree of DiffusionModelUNet (nested
dict of numpy arrays) becomes a state dict for the port's
DiffusionModelUNet, whose keys are the reference torch keys.

Leaf transforms:
    flax ConvND kernel (*k, I, O)  -> Conv{1,2,3}d weight (O, I, *k)
    flax Dense kernel (in, out)    -> Linear weight (out, in)
    flax GroupNorm scale           -> weight
    flax Embed embedding           -> Embedding weight (as is)
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_UNET_SEGMENT_REWRITES = {
    "time_embed_0": "time_embed.0",
    "time_embed_2": "time_embed.2",
    "out_norm": "out.0",
    "out_conv": "out.2",
}


def _unet_segment(parent: str, p: str) -> str:
    """Rewrite one flax module name to the reference torch name."""
    if p.startswith("down_") and p[5:].isdigit():
        return f"down_blocks.{p[5:]}"
    if p.startswith("up_") and p[3:].isdigit():
        return f"up_blocks.{p[3:]}"
    if p.startswith("resnet_") and parent.startswith(("down_", "up_")):
        return f"resnets.{p[7:]}"
    if p.startswith("attn_") and p[5:].isdigit():
        return f"attentions.{p[5:]}"
    return _UNET_SEGMENT_REWRITES.get(p, p)


def _translate_unet(dirs: tuple[str, ...]) -> str:
    return ".".join(_unet_segment(dirs[i - 1] if i else "", p) for i, p in enumerate(dirs))


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _torch_leaf(leaf: str, w: np.ndarray) -> tuple[str, np.ndarray]:
    """(torch parameter name, array in torch layout) for one flax leaf."""
    if leaf == "kernel":
        if w.ndim >= 3:  # conv (*k, I, O) -> (O, I, *k)
            return "weight", np.transpose(w, (w.ndim - 1, w.ndim - 2, *range(w.ndim - 2)))
        return "weight", w.T
    if leaf in ("scale", "embedding"):
        return "weight", w
    if leaf == "bias":
        return "bias", w
    raise ValueError(f"unknown flax leaf {leaf!r}")


def unet_state_dict_from_jax(
    params: Mapping, expected: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Map a JAX DiffusionModelUNet params tree onto the port's state-dict keys.

    Args:
        params: the flax ``variables["params"]`` tree, arrays as numpy (or
            anything `np.asarray` takes).
        expected: the target module's ``state_dict()``; it fixes the key set
            and the shapes. A conv's key carries the `conv` child
            (``<prefix>.conv.weight``), a Linear's does not.

    Returns:
        {torch key: float32 tensor}, every tensor a fresh copy, ready for
        ``load_state_dict(..., strict=True)``.

    Raises:
        KeyError on a JAX leaf with no torch key, or a torch key that no JAX
        leaf fills; ValueError on a shape mismatch.
    """
    out: dict[str, torch.Tensor] = {}
    for (*dirs, leaf), value in _flatten(params).items():
        prefix = _translate_unet(tuple(dirs))
        name, w = _torch_leaf(leaf, np.asarray(value, dtype=np.float32))
        for key in (f"{prefix}.{name}", f"{prefix}.conv.{name}"):
            if key in expected:
                break
        else:
            raise KeyError(f"JAX parameter {'/'.join((*dirs, leaf))} has no torch key ({prefix}.{name})")
        if key in out:
            raise KeyError(f"two JAX parameters map to {key}")
        if tuple(w.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"shape mismatch at {key}: JAX gives {tuple(w.shape)}, "
                f"torch expects {tuple(expected[key].shape)}"
            )
        out[key] = torch.tensor(np.ascontiguousarray(w))  # copies: never aliases `params`
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"torch keys with no JAX parameter: {missing[:8]} ({len(missing)} total)")
    return out
