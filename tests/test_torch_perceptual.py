"""The port's perceptual backbones, PerceptualLoss and pretrained-weight maps
against the JAX package, with random weights (no weight file is in the
repository and none can be fetched).

- Each backbone's features (AlexNet, VGG16 and SqueezeNet1.1 taps; the 2D
  bottleneck and the 3D basic-block ResNet trunks, narrowed to one block a
  stage, BatchNorm in eval mode with random statistics), every JAX
  parameter drawn from a numpy seed and carried over by
  `backbone_state_dict_from_jax`: 1e-5 of each feature map's largest value
  (f32 convolution sums in another order).
- PerceptualLoss in 2D, in 2.5D with the slice choice injected (the JAX
  call's permutations replayed through `slice_indices`), with and without
  LPIPS' learned heads, and MedicalNet's 3D ResNet10: rtol 1e-5.
- The name maps round-trip a state dict through the JAX converter and back,
  every entry equal; the loaders strip wrappers, keep the backbone's
  entries and read LPIPS' heads.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.losses import PerceptualLoss as JaxPerceptual
from generativemodels_tpu.networks import backbones as jbackbones
from generativemodels_tpu.networks import pretrained as jpretrained
from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu_torch.losses import PerceptualLoss
from generativemodels_tpu_torch.networks import backbone_state_dict_from_jax, backbones
from generativemodels_tpu_torch.networks import pretrained
from tests.test_torch_patchgan import random_stats
from tests.test_torch_unet import random_params

RTOL = 1e-5
# name: (JAX module, port module, NAME_MAPS key, input shape channels-first)
BACKBONES = {
    "alex": (jbackbones.AlexNetFeatures(), backbones.AlexNetFeatures, "alex", (2, 3, 64, 64)),
    "vgg": (jbackbones.VGG16Features(), backbones.VGG16Features, "vgg", (2, 3, 32, 32)),
    "squeeze": (jbackbones.SqueezeNetFeatures(), backbones.SqueezeNetFeatures, "squeeze",
                (2, 3, 64, 64)),
    "resnet_2d": (jbackbones.ResNetFeatures(layers=(1, 1, 1, 1)),
                  lambda: backbones.ResNetFeatures(layers=(1, 1, 1, 1)), "resnet50",
                  (2, 3, 32, 32)),
    "resnet_3d": (jbackbones.ResNetFeatures(spatial_dims=3, block="basic", layers=(1, 1, 1, 1)),
                  lambda: backbones.ResNetFeatures(3, "basic", (1, 1, 1, 1)),
                  "medicalnet_resnet10", (2, 1, 16, 16, 16)),
}


def _cl(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.moveaxis(x, 1, -1))


def build_pair(name: str, seed: int = 0):
    """(JAX module, variables, port module with the same weights, eval)."""
    jmodule, port_cls, net, shape = BACKBONES[name]
    struct = zoo_convert.variables_structure(jmodule, jnp.zeros(shape[:1] + shape[2:] + shape[1:2]))
    variables = {"params": random_params(struct["params"], seed)}
    if "batch_stats" in struct:
        variables["batch_stats"] = random_stats(struct["batch_stats"], seed + 1)
    port = port_cls().eval()
    port.load_state_dict(backbone_state_dict_from_jax(
        variables["params"], port.state_dict(), net, variables.get("batch_stats")), strict=True)
    return jmodule, variables, port


def assert_close(got: torch.Tensor, want, rtol: float = RTOL) -> None:
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("name", list(BACKBONES))
def test_backbone_features_match_jax(name):
    jmodule, variables, port = build_pair(name)
    shape = BACKBONES[name][3]
    x = np.random.RandomState(1).standard_normal(shape).astype(np.float32)
    want = jmodule.apply(variables, _cl(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if not isinstance(want, list):
        want, got = [want], [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g, np.moveaxis(np.asarray(w), -1, 1))


class _Replayed(PerceptualLoss):
    """The 2.5D slice choices given, in call order."""

    def __init__(self, choices, **kwargs) -> None:
        super().__init__(**kwargs)
        self.choices = list(choices)

    def slice_indices(self, n_total, n_keep, generator, device):
        chosen = self.choices.pop(0)
        assert len(chosen) == n_keep
        return torch.as_tensor(chosen, device=device)


@pytest.mark.parametrize("case", ["2d", "2d_lin", "fake_3d", "medicalnet_3d"])
def test_perceptual_loss_matches_jax(case):
    spatial_dims = 2 if case.startswith("2d") else 3
    name = "resnet_3d" if case == "medicalnet_3d" else "alex"
    _, variables, port = build_pair(name, seed=2)
    rng = np.random.RandomState(3)
    shape = {"2d": (2, 3, 64, 64), "2d_lin": (2, 3, 64, 64), "fake_3d": (1, 3, 32, 32, 32),
             "medicalnet_3d": (2, 1, 16, 16, 16)}[case]
    x, y = (rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(2))
    lin = None
    if case == "2d_lin":
        lin = [rng.uniform(0, 1, c).astype(np.float32) for c in (64, 192, 384, 256, 256)]
    kwargs = dict(spatial_dims=spatial_dims, pretrained=False)
    if case == "medicalnet_3d":
        kwargs.update(network_type="medicalnet_resnet10_23datasets", is_fake_3d=False)
    jloss = JaxPerceptual(**kwargs, params=variables["params"],
                          batch_stats=variables.get("batch_stats"), lin_weights=lin)
    key = jax.random.PRNGKey(4)
    want = float(jloss(jnp.asarray(x), jnp.asarray(y), key=key))
    choices = []
    if case == "fake_3d":
        for k, axis in zip(jax.random.split(key, 3), (2, 3, 4)):
            n_total = shape[0] * shape[axis]
            choices.append(np.asarray(jax.random.permutation(k, n_total)[:n_total // 2]))
    loss = _Replayed(choices, **kwargs, state_dict=port.state_dict(), lin_weights=lin)
    with torch.no_grad():
        got = float(loss(torch.from_numpy(x), torch.from_numpy(y)))
    assert want > 1e-4
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert not loss.choices  # every axis drew its slices


def test_fake_3d_draws_its_slices_from_the_generator():
    loss = PerceptualLoss(spatial_dims=3, network_type="squeeze", pretrained=False)
    x, y = torch.rand(1, 3, 32, 32, 32), torch.rand(1, 3, 32, 32, 32)
    with torch.no_grad():
        a = loss(x, y, generator=torch.Generator().manual_seed(5))
        b = loss(x, y, generator=torch.Generator().manual_seed(5))
    assert float(a) == float(b) and float(a) > 0


@pytest.mark.parametrize("network_type", sorted(pretrained.NAME_MAPS))
def test_name_maps_round_trip_a_state_dict(network_type):
    """A state dict of the port's backbone -> the JAX converter -> back."""
    if "medicalnet" in network_type:
        layers = (1, 1, 1, 1) if "resnet10" in network_type else (3, 4, 6, 3)
        port = backbones.ResNetFeatures(3, "basic" if "resnet10" in network_type
                                        else "bottleneck", layers)
    elif network_type in ("alex", "vgg", "squeeze"):
        port = {"alex": backbones.AlexNetFeatures, "vgg": backbones.VGG16Features,
                "squeeze": backbones.SqueezeNetFeatures}[network_type]()
    else:
        port = backbones.ResNetFeatures(2)
    torch.manual_seed(6)
    state = {k: v + torch.rand(v.shape) if v.is_floating_point() else v
             for k, v in port.state_dict().items()}
    params, stats = jpretrained.convert_backbone_state_dict(
        {k: v.numpy() for k, v in state.items()}, network_type)
    back = backbone_state_dict_from_jax(params, port.state_dict(), network_type, stats)
    assert back.keys() == state.keys()
    for k, v in state.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)


def test_loaders(tmp_path):
    """Wrappers stripped, heads and classifiers dropped, LPIPS' heads read."""
    port = backbones.AlexNetFeatures()
    wrapped = {f"module.{k}": v for k, v in port.state_dict().items()}
    wrapped["module.classifier.1.weight"] = torch.zeros(4, 9216)
    path = tmp_path / "alex.pth"
    torch.save({"state_dict": wrapped}, path)
    lin = {f"lin{i}.model.1.weight": torch.full((1, c, 1, 1), float(i))
           for i, c in enumerate((64, 192, 384, 256, 256))}
    lin_path = tmp_path / "lin.pth"
    torch.save(lin, lin_path)
    loaded = pretrained.load_pretrained_perceptual("alex", str(path), lin_path=str(lin_path))
    assert loaded["state_dict"].keys() == port.state_dict().keys()
    assert [w.shape[0] for w in loaded["lin_weights"]] == [64, 192, 384, 256, 256]
    loss = PerceptualLoss(2, cache_dir=str(tmp_path), lin_path=str(lin_path))
    assert loss.backend.lin_weights is not None
    with pytest.raises(ValueError, match="NAME_MAP"):
        pretrained.backbone_state_dict({}, "inception")
    with pytest.raises(ValueError, match="lin"):
        pretrained.load_lpips_lin_weights({})
    with pytest.warns(UserWarning, match="RANDOM"):
        PerceptualLoss(2)
    with pytest.raises(ValueError, match="MedicalNet"):
        PerceptualLoss(2, network_type="medicalnet_resnet10_23datasets")
