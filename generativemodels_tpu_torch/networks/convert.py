"""JAX parameter trees -> state dicts of the port's modules.

Counterpart of the DiffusionModelUNet, DiffusionModelEncoder, ControlNet,
AutoencoderKL, VQVAE, PatchGAN and perceptual-backbone parts of
generativemodels_tpu/networks/zoo_convert.py, in the other direction: a flax
params tree (nested dict of numpy arrays) becomes a state dict for the port's
module, whose keys are the reference torch keys.

Leaf transforms:
    flax ConvND kernel (*k, I, O)           -> Conv{1,2,3}d weight (O, I, *k)
    flax ConvTransposeND kernel (*k, I, O)  -> ConvTranspose{1,2,3}d weight
                                               (I, O, *k), flipped on every
                                               spatial axis (lax.conv_transpose
                                               runs the kernel unflipped)
    flax Dense kernel (in, out)             -> Linear weight (out, in)
    flax GroupNorm / LayerNorm scale        -> weight
    flax Embed embedding                    -> Embedding weight (as is)
    flax BatchNorm batch_stats mean / var   -> running_mean / running_var
Every tensor of a result is a fresh copy: none aliases the JAX arrays.
"""
from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence

import numpy as np
import torch

_UNET_SEGMENT_REWRITES = {
    "time_embed_0": "time_embed.0",
    "time_embed_2": "time_embed.2",
    "out_norm": "out.0",
    "out_conv": "out.2",
    "out_0": "out.0",  # DiffusionModelEncoder head
    "out_3": "out.3",
    "to_out": "to_out.0",  # CrossAttention's output Linear, in a Sequential with its Dropout
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
    if p.startswith("block_") and p[6:].isdigit():  # a SpatialTransformer's blocks
        return f"transformer_blocks.{p[6:]}"
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


def _torch_leaf(leaf: str, w: np.ndarray, transposed: bool) -> tuple[str, np.ndarray]:
    """(torch parameter name, array in torch layout) for one flax leaf;
    `transposed`: the leaf is a ConvTransposeND kernel."""
    if leaf == "kernel":
        n = w.ndim - 2
        if transposed:  # (*k, I, O) -> (I, O, *k), flipped spatially
            w = np.transpose(w, (n, n + 1, *range(n)))
            return "weight", np.flip(w, tuple(range(2, w.ndim)))
        if w.ndim >= 3:  # conv (*k, I, O) -> (O, I, *k)
            return "weight", np.transpose(w, (n + 1, n, *range(n)))
        return "weight", w.T
    if leaf in ("scale", "embedding"):
        return "weight", w
    if leaf == "bias":
        return "bias", w
    if leaf in ("mean", "var"):
        return f"running_{leaf}", w
    raise ValueError(f"unknown flax leaf {leaf!r}")


def _state_dict_from_jax(
    params: Mapping,
    expected: Mapping[str, torch.Tensor],
    translate: Callable[[tuple[str, ...]], str],
    transposed: frozenset[tuple[str, ...]] = frozenset(),
) -> dict[str, torch.Tensor]:
    """Every leaf of `params` under the torch key `translate` gives its
    module path (`<prefix>.<name>` or, for a conv, `<prefix>.conv.<name>`),
    checked as the public functions below say."""
    out: dict[str, torch.Tensor] = {}
    for (*dirs, leaf), value in _flatten(params).items():
        prefix = translate(tuple(dirs))
        name, w = _torch_leaf(leaf, np.asarray(value, dtype=np.float32), tuple(dirs) in transposed)
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
    return _state_dict_from_jax(params, expected, _translate_unet)


def diffusion_model_encoder_state_dict_from_jax(
    params: Mapping, expected: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Map a JAX DiffusionModelEncoder params tree onto the port's keys.

    The down path maps as the UNet's. The head's first Linear (`out.0`)
    reads a channels-first flatten of the last (B, C, *spatial) features in
    the port (as in the reference) and a channels-last one in the JAX
    module, so its input columns are permuted from (S, C) to (C, S) order,
    C being the last level's width. Run one forward of the port's module
    first: `out.0` takes its width there. Arguments, result and errors as
    `unet_state_dict_from_jax`.
    """
    out = _state_dict_from_jax(params, expected, _translate_unet)
    last = max(int(k.split(".")[1]) for k in out if k.startswith("down_blocks."))
    channels = next(
        v.shape[0] for k, v in out.items()
        if k.startswith(f"down_blocks.{last}.resnets.") and k.endswith("conv2.conv.weight")
    )
    weight = out["out.0.weight"]  # (512, S * C), columns in JAX's (S, C) order
    width, cols = weight.shape
    if cols % channels:
        raise ValueError(f"out.0 takes {cols} features, not a multiple of the width {channels}")
    out["out.0.weight"] = (
        weight.reshape(width, cols // channels, channels).transpose(1, 2).reshape(width, cols)
        .contiguous()
    )
    return out


def _translate_controlnet(dirs: tuple[str, ...]) -> str:
    """The UNet's down and mid naming, plus controlnet_cond_embedding.{conv_in,
    blocks.{i}, conv_out} and the zero convs controlnet_down_blocks.{i} and
    controlnet_mid_block (the reference's ControlNet keys)."""
    parts = []
    for i, p in enumerate(dirs):
        parent = dirs[i - 1] if i else ""
        if p.startswith("controlnet_down_") and p[16:].isdigit():
            parts.append(f"controlnet_down_blocks.{p[16:]}")
        elif parent == "controlnet_cond_embedding" and p.startswith("block_"):
            parts.append(f"blocks.{p[6:]}")
        else:
            parts.append(_unet_segment(parent, p))
    return ".".join(parts)


def controlnet_state_dict_from_jax(
    params: Mapping, expected: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Map a JAX ControlNet params tree onto the port's state-dict keys.
    Arguments, result and errors as `unet_state_dict_from_jax`."""
    return _state_dict_from_jax(params, expected, _translate_controlnet)


def _aekl_block_map(
    num_channels: Sequence[int],
    num_res_blocks: Sequence[int],
    attention_levels: Sequence[bool],
    with_encoder_nonlocal_attn: bool,
    with_decoder_nonlocal_attn: bool,
) -> dict[tuple[str, str], str]:
    """(side, flax module name) -> torch prefix ``{side}.blocks.{i}``, in the
    append order of the reference Encoder and Decoder (the order of
    `AEKLEncoder.blocks` and `AEKLDecoder.blocks`)."""
    n_levels = len(num_channels)
    encoder = ["conv_in"]
    for i in range(n_levels):
        for j in range(num_res_blocks[i]):
            encoder.append(f"res_{i}_{j}")
            if attention_levels[i]:
                encoder.append(f"attn_{i}_{j}")
        if i != n_levels - 1:
            encoder.append(f"down_{i}")
    if with_encoder_nonlocal_attn:
        encoder += ["mid_res_1", "mid_attn", "mid_res_2"]
    encoder += ["norm_out", "conv_out"]

    decoder = ["conv_in"]
    if with_decoder_nonlocal_attn:
        decoder += ["mid_res_1", "mid_attn", "mid_res_2"]
    rev_res = list(reversed(list(num_res_blocks)))
    rev_att = list(reversed(list(attention_levels)))
    for i in range(n_levels):
        for j in range(rev_res[i]):
            decoder.append(f"res_{i}_{j}")
            if rev_att[i]:
                decoder.append(f"attn_{i}_{j}")
        if i != n_levels - 1:
            decoder.append(f"up_{i}")
    decoder += ["norm_out", "conv_out"]
    return {
        (side, name): f"{side}.blocks.{i}"
        for side, names in (("encoder", encoder), ("decoder", decoder))
        for i, name in enumerate(names)
    }


def autoencoderkl_state_dict_from_jax(
    params: Mapping,
    expected: Mapping[str, torch.Tensor],
    num_channels: Sequence[int],
    num_res_blocks: Sequence[int] | int,
    attention_levels: Sequence[bool],
    with_encoder_nonlocal_attn: bool = True,
    with_decoder_nonlocal_attn: bool = True,
    use_convtranspose: bool = False,
) -> dict[str, torch.Tensor]:
    """Map a JAX AutoencoderKL params tree onto the port's state-dict keys.

    The configuration arguments are the model's: they fix the flat
    ``encoder.blocks.{i}`` / ``decoder.blocks.{i}`` numbering. A bare
    GroupNorm (``norm_out``) maps to ``...blocks.{n}.weight``, a conv to
    ``...blocks.{k}.conv.weight``, the down and up convs to
    ``...blocks.{k}.conv.conv.weight``; under `use_convtranspose` the up
    convs' kernels are transposed and flipped. Arguments, result and errors
    otherwise as `unet_state_dict_from_jax`.
    """
    if isinstance(num_res_blocks, int):
        num_res_blocks = (num_res_blocks,) * len(num_channels)
    block_map = _aekl_block_map(
        num_channels, num_res_blocks, attention_levels, with_encoder_nonlocal_attn,
        with_decoder_nonlocal_attn,
    )

    def translate(dirs: tuple[str, ...]) -> str:
        if dirs[0] in ("encoder", "decoder") and len(dirs) >= 2:
            return ".".join([block_map[dirs[0], dirs[1]], *dirs[2:]])
        return ".".join(dirs)  # quant_conv_mu, quant_conv_log_sigma, post_quant_conv

    transposed = frozenset(
        ("decoder", f"up_{i}", "conv") for i in range(len(num_channels) - 1) if use_convtranspose
    )
    return _state_dict_from_jax(params, expected, translate, transposed)


def vqvae_state_dict_from_jax(
    params: Mapping,
    codebook: Mapping,
    expected: Mapping[str, torch.Tensor],
    num_channels: Sequence[int],
    num_res_layers: int,
) -> dict[str, torch.Tensor]:
    """Map a JAX VQVAE's params tree and its "codebook" collection onto the
    port's state-dict keys.

    The flat ``encoder.blocks.{i}`` numbering: per level the strided conv
    (``down_{i}``) and its residual units (``res_{i}_{j}``), then
    ``conv_out``; ``decoder.blocks.{i}``: ``conv_in``, then per level the
    residual units and the transposed conv (``up_{i}``, its kernel
    transposed and flipped). The codebook's ``embedding``,
    ``ema_cluster_size`` and ``ema_w`` become the buffers
    ``quantizer.quantizer.embedding.weight``, ``.ema_cluster_size`` and
    ``.ema_w``. Errors as `unet_state_dict_from_jax`.
    """
    block_map: dict[tuple[str, str], str] = {}
    encoder = []
    for i in range(len(num_channels)):
        encoder += [f"down_{i}"] + [f"res_{i}_{j}" for j in range(num_res_layers)]
    decoder = ["conv_in"]
    for i in range(len(num_channels)):
        decoder += [f"res_{i}_{j}" for j in range(num_res_layers)] + [f"up_{i}"]
    for side, names in (("encoder", encoder + ["conv_out"]), ("decoder", decoder)):
        block_map.update({(side, name): f"{side}.blocks.{i}" for i, name in enumerate(names)})

    def translate(dirs: tuple[str, ...]) -> str:
        return ".".join([block_map[dirs[0], dirs[1]], *dirs[2:]])

    prefix = "quantizer.quantizer."
    out = _state_dict_from_jax(
        params, {k: v for k, v in expected.items() if not k.startswith(prefix)}, translate,
        frozenset(("decoder", f"up_{i}") for i in range(len(num_channels))),
    )
    leaves = codebook["quantizer"]["quantizer"]
    for leaf, key in (("embedding", "embedding.weight"), ("ema_cluster_size", "ema_cluster_size"),
                      ("ema_w", "ema_w")):
        w = np.asarray(leaves[leaf], dtype=np.float32)
        if tuple(w.shape) != tuple(expected[prefix + key].shape):
            raise ValueError(f"shape mismatch at {prefix + key}: JAX gives {tuple(w.shape)}, "
                             f"torch expects {tuple(expected[prefix + key].shape)}")
        out[prefix + key] = torch.tensor(np.ascontiguousarray(w))
    return out


def _translate_patchgan(dirs: tuple[str, ...]) -> str:
    """``layer_{l}`` -> ``{l}``, ``norm_{l}`` -> ``{l}.adn.N`` (the flax norm
    child folded in); ``initial_conv``, ``final_conv`` and
    ``discriminator_{i}`` keep their names."""
    parts = []
    for p in dirs:
        if p.startswith("layer_") and p[6:].isdigit():
            parts.append(p[6:])
        elif p.startswith("norm_") and p[5:].isdigit():
            parts.append(f"{p[5:]}.adn.N")
        elif p not in ("BatchNorm_0", "GroupNorm_0"):
            parts.append(p)
    return ".".join(parts)


def patchgan_state_dict_from_jax(
    params: Mapping,
    expected: Mapping[str, torch.Tensor],
    batch_stats: Mapping | None = None,
) -> dict[str, torch.Tensor]:
    """Map a JAX PatchDiscriminator's or MultiScalePatchDiscriminator's params
    tree, and its BatchNorm ``batch_stats`` collection (required when the norm
    is "BATCH"), onto the port's state-dict keys. JAX keeps no count of
    batches: each ``num_batches_tracked`` is 0. Errors as
    `unet_state_dict_from_jax`."""
    tree = _flatten(params)
    if batch_stats:
        tree.update(_flatten(batch_stats))
    counters = {k: torch.zeros((), dtype=torch.long) for k in expected
                if k.endswith(".num_batches_tracked")}
    out = _state_dict_from_jax(
        _unflatten(tree), {k: v for k, v in expected.items() if k not in counters},
        _translate_patchgan,
    )
    out.update(counters)
    return out


def _unflatten(flat: Mapping[tuple, object]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def backbone_state_dict_from_jax(
    params: Mapping,
    expected: Mapping[str, torch.Tensor],
    network_type: str,
    batch_stats: Mapping | None = None,
) -> dict[str, torch.Tensor]:
    """Map a JAX perceptual backbone's params tree (and its BatchNorm
    ``batch_stats``, for the ResNets) onto the port's state-dict keys, the
    checkpoint names of `networks.pretrained.NAME_MAPS[network_type]` read
    backwards; each ``num_batches_tracked`` is 0. Errors as
    `unet_state_dict_from_jax`."""
    from .pretrained import NAME_MAPS

    to_torch = {path: name for name, path in NAME_MAPS[network_type].items()}
    tree = _flatten(params)
    if batch_stats:
        tree.update(_flatten(batch_stats))
    counters = {k: torch.zeros((), dtype=torch.long) for k in expected
                if k.endswith(".num_batches_tracked")}
    out = _state_dict_from_jax(
        _unflatten(tree), {k: v for k, v in expected.items() if k not in counters},
        lambda dirs: to_torch["/".join(dirs)],
    )
    out.update(counters)
    return out
