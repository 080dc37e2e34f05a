"""The port's config parser, its reference-bundle loader and its JSON presets,
against the JAX package's parser and YAML presets.

The presets are held equal, key by key, to `yaml.safe_load` of the JAX
preset after the target prefix rewrite; `load_preset` builds the port's
networks on torch's meta device (no memory), each with the parameter
count, and the multiset of parameter sizes, of the JAX network the JAX
preset builds (`jax.eval_shape` of its init: nothing computed).
"""
from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from generativemodels_tpu import config as jax_config
from generativemodels_tpu_torch import config
from generativemodels_tpu_torch.networks.nets import DiffusionModelUNet
from generativemodels_tpu_torch.networks.schedulers import DDPMScheduler
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PRESETS = ("brain_3d_ldm", "cxr_ldm", "mednist_ddpm")


def _rewrite(node):
    if isinstance(node, dict):
        return {k: (v.replace("generativemodels_tpu.", "generativemodels_tpu_torch.", 1)
                    if k == "_target_" else _rewrite(v)) for k, v in node.items()}
    if isinstance(node, list):
        return [_rewrite(v) for v in node]
    return node


@pytest.mark.parametrize("name", PRESETS)
def test_json_preset_equals_the_yaml_after_the_rewrite(name):
    with open(os.path.join(jax_config.PRESET_DIR, f"{name}.yaml")) as f:
        want = _rewrite(yaml.safe_load(f))
    assert config.load_preset(name).config == want


def _jax_param_sizes(module, *inputs, **kwargs) -> list[int]:
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs, **kwargs)
    return sorted(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("name", PRESETS)
def test_load_preset_builds_the_port_modules_on_meta(name):
    ours, theirs = config.load_preset(name), jax_config.load_preset(name)
    with torch.device("meta"):
        network = ours.resolve("network")
        autoencoder = ours.resolve("autoencoder") if "autoencoder" in ours.config else None
    assert isinstance(network, DiffusionModelUNet)
    assert all(p.device.type == "meta" for p in network.parameters())
    jnet = theirs.resolve("network")
    nd, c_in = jnet.spatial_dims, jnet.in_channels
    kwargs = {}
    if jnet.with_conditioning:
        kwargs["context"] = jnp.zeros((1, 1, jnet.cross_attention_dim))
    want = _jax_param_sizes(jnet, jnp.zeros((1, c_in) + (16,) * nd), jnp.zeros((1,), jnp.int32),
                            **kwargs)
    assert sorted(p.numel() for p in network.parameters()) == want
    if autoencoder is not None:
        jae = theirs.resolve("autoencoder")
        want = _jax_param_sizes(jae, jnp.zeros((1, 1) + (16,) * nd))
        assert sorted(p.numel() for p in autoencoder.parameters()) == want
    inferer = ours.resolve("inferer")
    assert type(inferer).__module__.startswith("generativemodels_tpu_torch.")
    assert inferer.scheduler is ours.resolve("scheduler")


def _semantics_config(target: str) -> dict:
    return {
        "channels": [8, 16],
        "steps": 10,
        "nested": {"a": [1, {"b": 5}]},
        "twice": "$@steps * 2",
        "last": "@channels#1",
        "deep": "@nested::a::1::b",
        "levels": "$[False] * len(@channels)",
        "maths": "$math.floor(@steps / 3) + max(@channels)",
        "off": {"_target_": target, "num_train_timesteps": 5, "_disabled_": True},
        "scheduler": {"_target_": target, "num_train_timesteps": "@steps",
                      "_requires_": "@twice"},
    }


@pytest.mark.parametrize("item", ["twice", "last", "deep", "levels", "maths", "off", "nested"])
def test_parser_resolves_as_jax(item):
    ours = config.ConfigParser(_semantics_config(
        "generativemodels_tpu_torch.networks.schedulers.DDPMScheduler"))
    theirs = jax_config.ConfigParser(_semantics_config(
        "generativemodels_tpu.networks.schedulers.DDPMScheduler"))
    assert ours.resolve(item) == theirs.resolve(item)


def test_parser_instantiates_and_caches_targets():
    parser = config.ConfigParser(_semantics_config(
        "generativemodels_tpu_torch.networks.schedulers.DDPMScheduler"))
    scheduler = parser.resolve("scheduler")
    assert isinstance(scheduler, DDPMScheduler) and scheduler.num_train_timesteps == 10
    assert parser.resolve("scheduler") is scheduler
    parser.update({"steps": 20})
    assert parser.resolve("scheduler").num_train_timesteps == 20
    with pytest.raises(ValueError, match="dotted path"):
        config.ConfigParser({"x": {"_target_": "nodots"}}).resolve("x")


def test_load_preset_names_the_available_presets():
    with pytest.raises(FileNotFoundError, match="brain_3d_ldm"):
        config.load_preset("no_such_preset")


def test_yaml_file_without_pyyaml_says_so(tmp_path, monkeypatch):
    path = tmp_path / "bundle.yaml"
    path.write_text("steps: 3\n")
    assert config.ConfigParser.load_file(str(path)).config == {"steps": 3}
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML is not installed"):
        config.ConfigParser.load_file(str(path))


def test_reference_bundle_targets_name_the_port(tmp_path):
    bundle = {
        "network_def": {
            "_target_": "generative.networks.nets.DiffusionModelUNet",
            "_requires_": "$torch.cuda.set_device(0)",
            "spatial_dims": 2, "in_channels": 1, "out_channels": 1,
            "num_channels": [8, 8], "attention_levels": [False, True],
            "num_res_blocks": 1, "num_head_channels": 8, "norm_num_groups": 8,
        },
        "scheduler": {"_target_": "generative.networks.schedulers.DDPMScheduler",
                      "num_train_timesteps": 10},
        "local": {"_target_": "scripts.sampler.Sampler"},
    }
    path = tmp_path / "common.json"
    path.write_text(json.dumps(bundle))
    parser = config.load_reference_bundle(str(path))
    assert isinstance(parser.resolve("network_def"), DiffusionModelUNet)
    assert isinstance(parser.resolve("scheduler"), DDPMScheduler)
    jax_tree = jax_config.rewrite_targets(bundle)
    port_tree = config.rewrite_targets(bundle, {"scripts.sampler.Sampler": "pkg.Sampler"})
    assert port_tree["local"]["_target_"] == "pkg.Sampler"
    del port_tree["local"], jax_tree["local"]
    assert port_tree == _rewrite(jax_tree)
