"""The port's adversarial losses, spectral loss, adversarial engine, VQ-GAN
step and batch preparation against the JAX package.

Tolerances:
- PatchAdversarialLoss (three criteria x for_discriminator x target, one
  tensor and a list, three reductions), feature_matching_loss and
  JukeboxLoss: rtol 1e-6 (elementwise f32 arithmetic, sums in another
  order);
- the adversarial step (a small AutoencoderKL with an attention level and a
  BatchNorm PatchDiscriminator, three steps, the latent draw replayed from
  the port's generator into the JAX step): losses at rtol 1e-4; parameters,
  D's BatchNorm statistics and the EMA at atol 1e-6 + rtol 1e-4. Adam runs
  with eps 1e-3 on both sides, for tests/test_torch_train.py's reason (at
  1e-8 its first steps move a parameter by lr * sign(grad), so the rounding
  noise of a gradient near zero becomes a full step of random sign);
- the VQ-GAN step (three steps, the first reconstruction-only): the same,
  with the codebook buffers among the state.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from generativemodels_tpu import engines as jengines
from generativemodels_tpu.losses import JukeboxLoss as JaxJukebox
from generativemodels_tpu.losses import PatchAdversarialLoss as JaxAdvLoss
from generativemodels_tpu.losses import feature_matching_loss as jax_fm
from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import VQVAE as JaxVQVAE
from generativemodels_tpu.networks.nets import AutoencoderKL as JaxAEKL
from generativemodels_tpu.networks.nets import PatchDiscriminator as JaxPatch
from generativemodels_tpu.networks.schedulers import DDPMScheduler as JaxDDPM
from generativemodels_tpu.recipes import train_vqgan as jvqgan
from generativemodels_tpu_torch import engines
from generativemodels_tpu_torch.losses import (
    JukeboxLoss,
    PatchAdversarialLoss,
    feature_matching_loss,
)
from generativemodels_tpu_torch.networks import (
    autoencoderkl_state_dict_from_jax,
    patchgan_state_dict_from_jax,
    vqvae_state_dict_from_jax,
)
from generativemodels_tpu_torch.networks.nets import VQVAE, AutoencoderKL, PatchDiscriminator
from generativemodels_tpu_torch.networks.schedulers import DDPMScheduler
from generativemodels_tpu_torch.recipes import train_2d_ldm, train_vqgan
from generativemodels_tpu_torch.utils import AdversarialIterationEvents, AdversarialKeys
from tests.test_torch_patchgan import random_stats
from tests.test_torch_unet import random_params
from tests.test_torch_vqvae import random_codebook
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL = 1e-6
STEP_RTOL = 1e-4
STATE_ATOL = 1e-6
LR, EPS = 1e-4, 1e-3
BATCH = 2
AEKL = dict(spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=(8, 16), attention_levels=(False, True), latent_channels=3,
            norm_num_groups=4, with_encoder_nonlocal_attn=False,
            with_decoder_nonlocal_attn=False)
DISC = dict(spatial_dims=2, num_channels=8, in_channels=1, num_layers_d=2, norm="BATCH")


def _logits(seed: int, shapes=((2, 1, 5, 5), (2, 1, 3, 3))) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, rtol: float = LOSS_RTOL) -> None:
    if isinstance(got, list):  # reduction "none" over a list: one loss a discriminator
        assert isinstance(want, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("criterion", ["least_squares", "bce", "hinge"])
def test_patch_adversarial_loss_matches_jax(criterion, reduction):
    jloss = JaxAdvLoss(reduction=reduction, criterion=criterion)
    loss = PatchAdversarialLoss(reduction=reduction, criterion=criterion)
    logits = _logits(0)
    for as_list in (False, True):
        j_in = [jnp.asarray(x) for x in logits] if as_list else jnp.asarray(logits[0])
        t_in = [torch.from_numpy(x) for x in logits] if as_list else torch.from_numpy(logits[0])
        for target_is_real, for_d in ((True, True), (False, True), (True, False)):
            _close(loss(t_in, target_is_real, for_d), jloss(j_in, target_is_real, for_d))
    with pytest.warns(UserWarning, match="target_is_real"):
        loss(torch.from_numpy(logits[0]), False, False)


def test_least_squares_without_activation_and_bad_arguments():
    logits = _logits(1)[0]
    _close(PatchAdversarialLoss(no_activation_leastsq=True)(torch.from_numpy(logits), True, True),
           JaxAdvLoss(no_activation_leastsq=True)(jnp.asarray(logits), True, True))
    with pytest.raises(ValueError, match="criterion"):
        PatchAdversarialLoss(criterion="wasserstein")
    with pytest.raises(ValueError, match="reduction"):
        PatchAdversarialLoss(reduction="max")


def test_feature_matching_loss_matches_jax():
    rng = np.random.RandomState(2)
    shapes = [(2, 4, 8, 8), (2, 8, 4, 4)]
    real = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(2)]
    fake = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(2)]
    tt = [[torch.from_numpy(x) for x in xs] for xs in fake]
    for leaf in tt[0] + tt[1]:
        leaf.requires_grad_(True)
    for r, f, tr, tf in ((real, fake, real, tt), (real[0], fake[0], real[0], tt[0])):
        want = jax_fm(jax.tree_util.tree_map(jnp.asarray, r),
                      jax.tree_util.tree_map(jnp.asarray, f))
        got = feature_matching_loss(jax.tree_util.tree_map(torch.from_numpy, tr), tf)
        _close(got, want)
    with pytest.raises(ValueError, match="feature pair"):
        feature_matching_loss([], [])


@pytest.mark.parametrize("spatial_dims, signal, reduction", [
    (2, None, "mean"), (3, None, "sum"), (2, (3, 12, 10), "none")])
def test_jukebox_loss_matches_jax(spatial_dims, signal, reduction):
    rng = np.random.RandomState(3)
    shape = (2, 2) + (8,) * spatial_dims
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    want = JaxJukebox(spatial_dims, fft_signal_size=signal, reduction=reduction)(
        jnp.asarray(a), jnp.asarray(b))
    got = JukeboxLoss(spatial_dims, fft_signal_size=signal, reduction=reduction)(
        torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=1e-6)


# --- the adversarial step ---------------------------------------------------

def _aekl_pair(seed: int):
    jaekl = JaxAEKL(**AEKL)
    x = jnp.zeros((BATCH, 1, 16, 16))
    params = random_params(zoo_convert.params_structure(jaekl, x, method=JaxAEKL.reconstruct),
                           seed)
    port = AutoencoderKL(**AEKL)
    port.load_state_dict(_aekl_state(params, port), strict=True)
    return jaekl, params, port.train()


def _aekl_state(params, port) -> dict:
    return autoencoderkl_state_dict_from_jax(
        params, port.state_dict(), AEKL["num_channels"], AEKL["num_res_blocks"],
        AEKL["attention_levels"], False, False)


def _disc_pair(seed: int, kw: dict = DISC):
    jdisc = JaxPatch(**kw)
    variables = zoo_convert.variables_structure(jdisc, jnp.zeros((BATCH, 1, 16, 16)))
    params = random_params(variables["params"], seed)
    stats = random_stats(variables["batch_stats"], seed + 1) if "batch_stats" in variables \
        else None
    port = PatchDiscriminator(**kw)
    port.load_state_dict(patchgan_state_dict_from_jax(params, port.state_dict(), stats),
                         strict=True)
    return jdisc, params, stats, port.train()


def _assert_state(port: nn.Module, want: dict, what: str) -> None:
    got = port.state_dict()
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=STEP_RTOL,
                                   atol=STATE_ATOL, err_msg=f"{what}: {key}")


def _images(step: int) -> np.ndarray:
    rng = np.random.RandomState(100 + step)
    return rng.uniform(0, 1, (BATCH, 1, 16, 16)).astype(np.float32)


def jax_stage1_step(jaekl, jdisc, kl_weight: float, adv_weight: float,
                    ema_decay: float | None = None, batch_stats: bool = True):
    """The JAX recipes' stage-1 step (train_2d_ldm / train_3d_ldm), with the
    latent noise injected: its `inputs` are (images, eps)."""
    adv = JaxAdvLoss(criterion="least_squares")

    def g_forward(params, model_state, inputs, rng):
        images, eps = inputs
        z_mu, z_sigma = jaekl.apply({"params": params}, images, method=JaxAEKL.encode)
        recon = jaekl.apply({"params": params}, z_mu + eps * z_sigma, method=JaxAEKL.decode)
        return (recon, z_mu, z_sigma), model_state

    def d_forward(params, stats, x):
        images = x[0] if isinstance(x, tuple) else x
        if not batch_stats:
            return jdisc.apply({"params": params}, images)[-1], stats
        outs, new = jdisc.apply({"params": params, "batch_stats": stats}, images,
                                deterministic=False, mutable=["batch_stats"])
        return outs[-1], new["batch_stats"]

    def recon_loss(g_out, targets):
        recon, z_mu, z_sigma = g_out
        l1 = jnp.mean(jnp.abs(recon - targets))
        kl = 0.5 * jnp.mean(z_mu**2 + z_sigma**2 - jnp.log(z_sigma**2 + 1e-12) - 1)
        return l1 + kl_weight * kl

    tx = optax.adam(LR, eps=EPS)
    return tx, jengines.make_adversarial_train_step(
        g_forward, d_forward, tx, tx, recon_loss,
        lambda f: adv(f, target_is_real=True, for_discriminator=False),
        lambda r, f: 0.5 * (adv(r, True, True) + adv(f, False, True)),
        adv_weight=adv_weight, donate=False, ema_decay=ema_decay)


def run_stage1_pair(steps, j_steps, state, jstate, images, latent_shape):
    """Each step on both sides, the port's latent draws replayed into the JAX
    step; the losses held at STEP_RTOL. Returns both states."""
    generator = torch.Generator().manual_seed(5)
    replay = torch.Generator().manual_seed(5)
    for i, (step, j_step, x) in enumerate(zip(steps, j_steps, images)):
        state, out = step(state, torch.from_numpy(x), torch.from_numpy(x), generator)
        eps = torch.randn(latent_shape, generator=replay).numpy()
        jstate, jout = j_step(jstate, (jnp.asarray(x), jnp.asarray(eps)), jnp.asarray(x),
                              jax.random.PRNGKey(i))
        for key in (AdversarialKeys.RECONSTRUCTION_LOSS, AdversarialKeys.GENERATOR_LOSS,
                    AdversarialKeys.DISCRIMINATOR_LOSS, "loss"):
            np.testing.assert_allclose(float(out[key]), float(jout[key]), rtol=STEP_RTOL,
                                       err_msg=f"step {i}: {key}")
    return state, jstate


@pytest.mark.parametrize("ema_decay", [None, 0.9], ids=["plain", "ema"])
def test_adversarial_step_matches_jax(ema_decay):
    """Three steps of the 2D LDM recipe's stage-1 step (warm-up first, then
    adversarial) on both sides: the port's draws its latent noise from a
    generator, and the JAX step gets the same draws as inputs."""
    jaekl, g_params, aekl = _aekl_pair(0)
    jdisc, d_params, d_stats, disc = _disc_pair(1)
    kl_weight, adv_weight = 1e-2, 0.5
    tx, j_warm = jax_stage1_step(jaekl, jdisc, kl_weight, 0.0, ema_decay)
    _, j_full = jax_stage1_step(jaekl, jdisc, kl_weight, adv_weight, ema_decay)
    jstate = jengines.AdversarialTrainState(
        g_params=g_params, g_model_state={}, g_opt_state=tx.init(g_params),
        d_params=d_params, d_model_state=d_stats, d_opt_state=tx.init(d_params),
        step=jnp.asarray(0), g_ema_params=g_params if ema_decay else None)

    # port: the recipe's steps
    warm, full = train_2d_ldm.make_stage1_steps(kl_weight, adv_weight)
    if ema_decay:
        warm.ema_decay = full.ema_decay = ema_decay
    state = engines.init_adversarial_state(
        aekl, torch.optim.Adam(aekl.parameters(), lr=LR, eps=EPS),
        disc, torch.optim.Adam(disc.parameters(), lr=LR, eps=EPS), ema=bool(ema_decay))
    state, jstate = run_stage1_pair([warm, full, full], [j_warm, j_full, j_full], state, jstate,
                                    [_images(i) for i in range(3)], (BATCH, 3, 8, 8))
    assert state.step == 3
    _assert_state(aekl, _aekl_state(jstate.g_params, aekl), "G")
    _assert_state(disc, patchgan_state_dict_from_jax(jstate.d_params, disc.state_dict(),
                                                     jstate.d_model_state), "D")
    if ema_decay:
        want = _aekl_state(jstate.g_ema_params, aekl)
        for name, e in state.g_ema_params.items():
            np.testing.assert_allclose(e.numpy(), want[name].numpy(), rtol=STEP_RTOL,
                                       atol=STATE_ATOL, err_msg=f"EMA: {name}")


def test_generator_phase_leaves_discriminator_as_it_was():
    """D's statistics move twice a step (reals, then fakes), never in G's
    phase; D's parameters take no gradient from G's loss."""
    _, _, aekl = _aekl_pair(2)
    _, _, _, disc = _disc_pair(3)
    bn = disc._modules["0"].adn.N
    before = bn.running_mean.clone()
    seen = []

    def d_forward(d, x):
        seen.append(bn.running_mean.clone())
        return train_2d_ldm.disc_forward(d, x)

    _, full = train_2d_ldm.make_stage1_steps(1e-2, 1.0)
    full.d_forward = d_forward
    state = engines.init_adversarial_state(aekl, torch.optim.SGD(aekl.parameters(), lr=0.0),
                                           disc, torch.optim.SGD(disc.parameters(), lr=0.0))
    x = torch.from_numpy(_images(0))
    full(state, x, x, torch.Generator().manual_seed(0))
    assert len(seen) == 3
    torch.testing.assert_close(seen[0], before, rtol=0, atol=0)  # G's phase
    torch.testing.assert_close(seen[1], before, rtol=0, atol=0)  # restored after it
    assert not torch.equal(seen[2], before)  # moved by the reals
    assert all(p.requires_grad for p in disc.parameters())


def test_vqgan_step_matches_jax():
    """Three steps of the VQ-GAN recipe's step (the first reconstruction-only)
    against the JAX `make_vqgan_step`, the codebook buffers included."""
    vq_cfg = dict(spatial_dims=2, in_channels=1, out_channels=1, num_channels=(8, 16),
                  num_res_layers=1, num_res_channels=(8, 16),
                  downsample_parameters=((2, 4, 1, 1),) * 2,
                  upsample_parameters=((2, 4, 1, 1, 0),) * 2, num_embeddings=16,
                  embedding_dim=4)
    jvq = JaxVQVAE(**vq_cfg)
    struct = zoo_convert.variables_structure(jvq, jnp.zeros((BATCH, 1, 16, 16)))
    g_params = random_params(struct["params"], 4)
    codebook = {"quantizer": {"quantizer": random_codebook(5)}}
    vq = VQVAE(**vq_cfg)
    vq.load_state_dict(vqvae_state_dict_from_jax(g_params, codebook, vq.state_dict(),
                                                 (8, 16), 1), strict=True)
    disc_kw = dict(DISC, norm="INSTANCE")
    jdisc, d_params, _, disc = _disc_pair(6, disc_kw)
    tx = optax.adam(LR, eps=EPS)
    j_steps = [jvqgan.make_vqgan_step(jvq, jdisc, tx, tx, adv_weight=w, fm_weight=0.5)
               for w in (0.0, 0.3)]
    jstate = jvqgan.VQGANState(g_params=g_params, codebook=codebook,
                               g_opt_state=tx.init(g_params), d_params=d_params,
                               d_opt_state=tx.init(d_params), step=jnp.asarray(0))
    steps = [train_vqgan.make_vqgan_step(adv_weight=w, fm_weight=0.5) for w in (0.0, 0.3)]
    state = train_vqgan.VQGANState(vq.train(), torch.optim.Adam(vq.parameters(), lr=LR, eps=EPS),
                                   disc, torch.optim.Adam(disc.parameters(), lr=LR, eps=EPS), 0)
    for i in range(3):
        x = _images(i)
        state, out = steps[min(i, 1)](state, torch.from_numpy(x))
        jstate, jout = j_steps[min(i, 1)](jstate, jnp.asarray(x))
        for key, value in jout.items():
            np.testing.assert_allclose(float(out[key]), float(value), rtol=STEP_RTOL,
                                       atol=1e-7, err_msg=f"step {i}: {key}")
    assert state.step == 3
    _assert_state(vq, vqvae_state_dict_from_jax(jstate.g_params, jstate.codebook,
                                                vq.state_dict(), (8, 16), 1), "G")
    _assert_state(disc, patchgan_state_dict_from_jax(jstate.d_params, disc.state_dict()), "D")


class _Scale(nn.Module):
    def __init__(self, value: float) -> None:
        super().__init__()
        self.w = nn.Parameter(torch.tensor(value))

    def forward(self, x):
        return x * self.w


def test_trainer_fires_events_in_the_jax_order():
    """Two epochs of two batches through both trainers (G and D each one
    scalar weight, SGD): the same events in the same order, the same weights."""
    batches = [np.full((2, 3), v, np.float32) for v in (1.0, 2.0)]

    def recorder(events):
        names = list(AdversarialIterationEvents) + ["iteration_completed", "epoch_completed"]
        return {str(n): (lambda n: lambda trainer, out: events.append(str(n)))(n)
                for n in names}

    j_events: list[str] = []
    jtrainer = jengines.AdversarialTrainer(
        [jnp.asarray(b) for b in batches], 2,
        g_forward=lambda p, s, x, rng: (x * p["w"], s),
        d_forward=lambda p, s, x: (x * p["w"], s),
        g_tx=optax.sgd(0.1), d_tx=optax.sgd(0.1),
        recon_loss_function=lambda f, t: jnp.mean((f - t) ** 2),
        g_loss_function=lambda f: jnp.mean(f**2), d_loss_function=lambda r, f: jnp.mean(r - f),
        initial_state=jengines.AdversarialTrainState(
            {"w": jnp.asarray(0.5)}, {}, optax.sgd(0.1).init({"w": 0.5}),
            {"w": jnp.asarray(2.0)}, {}, optax.sgd(0.1).init({"w": 2.0}), jnp.asarray(0)),
        adv_weight=0.5, handlers=recorder(j_events))
    jstate = jtrainer.run()

    events: list[str] = []
    g, d = _Scale(0.5), _Scale(2.0)
    trainer = engines.AdversarialTrainer(
        [torch.from_numpy(b) for b in batches], 2,
        g_forward=lambda m, x, gen: m(x), d_forward=lambda m, x: m(x),
        recon_loss_function=lambda f, t: torch.mean((f - t) ** 2),
        g_loss_function=lambda f: torch.mean(f**2),
        d_loss_function=lambda r, f: torch.mean(r - f),
        initial_state=engines.init_adversarial_state(
            g, torch.optim.SGD(g.parameters(), lr=0.1), d,
            torch.optim.SGD(d.parameters(), lr=0.1)),
        adv_weight=0.5, handlers={AdversarialIterationEvents(k) if k in
                                  {e.value for e in AdversarialIterationEvents} else k: v
                                  for k, v in recorder(events).items()})
    state = trainer.run()
    assert events == j_events and len(events) == 2 * (2 * 12 + 1)
    assert trainer.iteration == jtrainer.iteration == 4
    for got, want in ((state.g_model.w, jstate.g_params["w"]),
                      (state.d_model.w, jstate.d_params["w"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)


@pytest.mark.parametrize("v_prediction", [False, True], ids=["epsilon", "v"])
def test_prepare_batch_matches_jax(v_prediction):
    """Injected noise and timesteps (the draws' seams overridden on both
    sides); a dict batch with a condition."""
    rng = np.random.RandomState(7)
    images = rng.standard_normal((2, 1, 8, 8)).astype(np.float32)
    noise = rng.standard_normal(images.shape).astype(np.float32)
    cond = rng.standard_normal((2, 1, 4)).astype(np.float32)
    timesteps = np.array([3, 901])

    def injected(base, to, *args):
        class Injected(base):
            def get_noise(self, images, key):
                return to(noise)

            def get_timesteps(self, images, key):
                return to(timesteps)

        return Injected(*args)

    if v_prediction:
        jprep = injected(jengines.VPredictionPrepareBatch, jnp.asarray, JaxDDPM(), 1000, "c")
        prep = injected(engines.VPredictionPrepareBatch, torch.from_numpy, DDPMScheduler(),
                        1000, "c")
    else:
        jprep = injected(jengines.DiffusionPrepareBatch, jnp.asarray, 1000, "c")
        prep = injected(engines.DiffusionPrepareBatch, torch.from_numpy, 1000, "c")
    j_img, j_target, j_kw = jprep({"image": jnp.asarray(images), "c": jnp.asarray(cond)},
                                  jax.random.PRNGKey(0))
    img, target, kw = prep({"image": torch.from_numpy(images), "c": torch.from_numpy(cond)})
    np.testing.assert_array_equal(img.numpy(), np.asarray(j_img))
    np.testing.assert_allclose(target.numpy(), np.asarray(j_target), rtol=1e-6, atol=1e-7)
    assert kw.keys() == j_kw.keys() == {"noise", "timesteps", "conditioning"}
    np.testing.assert_array_equal(kw["timesteps"].numpy(), np.asarray(j_kw["timesteps"]))


def test_prepare_batch_draws_from_the_generator():
    prep = engines.DiffusionPrepareBatch(1000)
    images = torch.zeros(4, 1, 8, 8)
    a = prep(images, torch.Generator().manual_seed(3))
    b = prep(images, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    assert torch.equal(a[2]["timesteps"], b[2]["timesteps"])
    assert a[2]["timesteps"].shape == (4,) and int(a[2]["timesteps"].max()) < 1000
