"""VQ-VAE + autoregressive transformer inferer.

Counterpart of generativemodels_tpu/inferers/vqvae_transformer.py:
`VQVAETransformerInferer` (teacher-forced training forward with a BOS token
and a random crop to `max_seq_len`; token-by-token sampling with
temperature, top-k and the BOS token never drawn; the teacher-forced
likelihood with its windowed continuation, as a spatial log-probability
map) and `resolve_use_cache`.

The sampling loops are Python loops of eager forwards, in place of JAX's
`lax.scan`s. The windowed path re-forwards the reference's growing (then
cropped) window, `tokens[:, max(0, pos - max_seq_len):pos]`, where JAX
forwards a left-aligned window of static length and reads the logits at
its last filled position: under the causal mask both give the logits of
the same prefix, and a growing window does less work for short prefixes
(JAX's static length is what one compiled TPU program needs). A window
under 1024 tokens therefore takes the plain attention path; from 1024
tokens on a CUDA tensor, at head widths 32-256, the flash kernels. The
KV-cache path decodes one token a step through `DecoderOnlyTransformer`'s
`TransformerCache` (masked, plain attention, as in JAX). Draws come from a
`torch.Generator`: categorical draws as the argmax of the logits plus
Gumbel noise (JAX's `random.categorical` draws so too), the crop's start
from `randint`. Sampled tokens match JAX's only where no draw is random:
greedy (`top_k=1`) chains.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .latent import _resize_spatial


def resolve_use_cache(total_len: int, max_seq_len: int, bos_len: int, transformer_model) -> bool:
    """Whether sampling decodes with the KV cache: whenever it can.

    The cache needs the whole sequence to fit `max_seq_len`, a single BOS
    token and the port's `DecoderOnlyTransformer` (the JAX rule's
    "unbindable flax module"). The JAX rule also waits for 2048 tokens on a
    TPU, where the windowed forward won at 256 and 1024 tokens. On an H100
    (chip_smoke.py phase 11 (a), PERF.md §6) the cached path takes half the
    device time and 22% fewer kernels a 256-token sample; on the host's
    clock, which sets the pace, the two paths tie within its noise at 256
    tokens (batch 1 and 16) and the cache is as fast or faster at 1024. The
    cache is never the slower choice, so the port takes no length
    threshold, on the card or the CPU.
    """
    from ..networks.nets.transformer import DecoderOnlyTransformer

    return (total_len <= max_seq_len and bos_len == 1
            and isinstance(transformer_model, DecoderOnlyTransformer))


def _index(order, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(order, dtype=torch.long, device=device)


def _draw(logits: torch.Tensor, temperature: float, top_k: int | None, bos: int,
          generator: torch.Generator) -> torch.Tensor:
    """One token a row from (B, V) logits: temperature, top-k, BOS masked,
    then argmax(logits + Gumbel noise)."""
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    logits[:, bos] = -math.inf  # `logits` is a new tensor here
    noise = torch.empty_like(logits).exponential_(generator=generator)
    return torch.argmax(logits - torch.log(noise), dim=-1)


class VQVAETransformerInferer:
    """Orchestrates a VQVAE, a transformer and an `Ordering`.

    `vqvae_model` exposes `index_quantize`, `decode_samples` and
    `num_embeddings` (the port's `VQVAE`); `transformer_model` is a callable
    `(tokens, context=None) -> logits` with `max_seq_len` (the port's
    `DecoderOnlyTransformer`, which also decodes with a cache).
    """

    def __call__(
        self,
        inputs: torch.Tensor,
        vqvae_model,
        transformer_model,
        ordering,
        condition: torch.Tensor | None = None,
        return_latent: bool = False,
        generator: torch.Generator | None = None,
    ):
        """Teacher-forced training forward over the (cropped) token sequence;
        with `return_latent`, (logits, targets, the latent's spatial shape).
        A `generator` is required when the sequence exceeds `max_seq_len`:
        it draws the crop's start."""
        with torch.no_grad():  # a constant, as JAX's stop_gradient makes it
            latent = vqvae_model.index_quantize(inputs)
        latent_spatial_dim = tuple(latent.shape[1:])
        latent = latent.reshape(latent.shape[0], -1)
        latent = latent[:, _index(ordering.get_sequence_ordering(), latent.device)]

        target = latent
        bos = vqvae_model.num_embeddings
        latent = F.pad(latent, (1, 0), value=bos)[:, :-1].long()

        seq_len = latent.shape[1]
        max_seq_len = transformer_model.max_seq_len
        if max_seq_len < seq_len:
            if generator is None:
                raise ValueError(
                    "a `generator` is required to draw the random training crop when the "
                    "token sequence exceeds max_seq_len"
                )
            start = int(torch.randint(0, seq_len + 1 - max_seq_len, (), generator=generator,
                                      device=generator.device))
            window = latent[:, start:start + max_seq_len]
            target_window = target[:, start:start + max_seq_len]
        else:
            window, target_window = latent, target

        prediction = transformer_model(window, context=condition)
        if return_latent:
            return prediction, target_window, latent_spatial_dim
        return prediction

    @torch.no_grad()
    def sample(
        self,
        latent_spatial_dim,
        starting_tokens: torch.Tensor,
        vqvae_model,
        transformer_model,
        ordering,
        conditioning: torch.Tensor | None = None,
        temperature: float = 1.0,
        top_k: int | None = None,
        verbose: bool = False,
        generator: torch.Generator | None = None,
        use_cache: bool | None = None,
    ) -> torch.Tensor:
        """Sample the token grid after `starting_tokens` (B, bos_len), then
        decode it. `use_cache` None follows `resolve_use_cache`; True
        decodes with the KV cache (the sequence must fit `max_seq_len`),
        False re-forwards the window each step. `generator` draws every
        token (one seeded with 0 on the tokens' device by default)."""
        device = starting_tokens.device
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        seq_len = math.prod(latent_spatial_dim)
        batch, bos_len = starting_tokens.shape
        total_len = bos_len + seq_len
        max_seq_len = transformer_model.max_seq_len
        window = min(max_seq_len, total_len)
        bos = vqvae_model.num_embeddings

        buf = torch.zeros((batch, total_len), dtype=torch.long, device=device)
        buf[:, :bos_len] = starting_tokens.long()
        if use_cache is None:
            use_cache = resolve_use_cache(total_len, max_seq_len, bos_len, transformer_model)
        if use_cache:
            cache = transformer_model.init_cache(batch, device)
        for i in range(seq_len):
            pos = bos_len + i  # where the next token goes
            if verbose and i % 100 == 0:
                print(f"sampling token {i + 1}/{seq_len}")
            if use_cache:
                logits, cache = transformer_model(buf[:, pos - 1:pos], context=conditioning,
                                                  cache=cache)
            else:
                logits = transformer_model(buf[:, max(0, pos - window):pos],
                                           context=conditioning)
            buf[:, pos] = _draw(logits[:, -1, :], temperature, top_k, bos, generator)

        latent_seq = buf[:, bos_len:]
        latent_seq = latent_seq[:, _index(ordering.get_revert_sequence_ordering(), device)]
        latent = latent_seq.reshape((batch,) + tuple(latent_spatial_dim))
        return vqvae_model.decode_samples(latent)

    @torch.no_grad()
    def get_likelihood(
        self,
        inputs: torch.Tensor,
        vqvae_model,
        transformer_model,
        ordering,
        condition: torch.Tensor | None = None,
        resample_latent_likelihoods: bool = False,
        resample_interpolation_mode: str = "nearest",
        verbose: bool = False,
    ) -> torch.Tensor:
        """Log-likelihood map of the input's tokens, (B, *latent_spatial), or
        (B, 1, *input_spatial) resampled with `jax.image.resize`'s
        conventions ("nearest" with half-pixel centres, "bilinear" and
        "trilinear" linear with align_corners=False)."""
        if resample_latent_likelihoods and resample_interpolation_mode not in (
            "nearest",
            "bilinear",
            "trilinear",
        ):
            raise ValueError(
                "resample_interpolation mode should be either nearest, bilinear, or "
                f"trilinear, got {resample_interpolation_mode}"
            )
        latent = vqvae_model.index_quantize(inputs)
        latent_spatial_dim = tuple(latent.shape[1:])
        batch = latent.shape[0]
        latent = latent.reshape(batch, -1)
        latent = latent[:, _index(ordering.get_sequence_ordering(), latent.device)]
        seq_len = math.prod(latent_spatial_dim)

        bos = vqvae_model.num_embeddings
        latent = F.pad(latent, (1, 0), value=bos).long()
        max_seq_len = transformer_model.max_seq_len
        target = latent[:, 1:]

        # the first chunk: one teacher-forced pass
        logits = transformer_model(latent[:, :min(max_seq_len, latent.shape[1])],
                                   context=condition)
        n = min(logits.shape[1], seq_len)  # positions that predict a real token
        probs = torch.softmax(logits[:, :n].float(), dim=-1)
        gathered = [torch.gather(probs, 2, target[:, :n, None])[..., 0]]
        # the windowed continuation: one forward for each position past max_seq_len
        for i in range(max_seq_len, seq_len):
            if verbose and (i - max_seq_len) % 100 == 0:
                print(f"likelihood token {i + 1}/{seq_len}")
            window = latent[:, i + 1 - max_seq_len:i + 1]
            p = torch.softmax(transformer_model(window, context=condition)[:, -1, :].float(),
                              dim=-1)
            gathered.append(torch.gather(p, 1, target[:, i:i + 1]))
        log_probs = torch.log(torch.cat(gathered, dim=1))
        log_probs = log_probs[:, _index(ordering.get_revert_sequence_ordering(), latent.device)]
        probs_reshaped = log_probs.reshape((batch,) + latent_spatial_dim)
        if resample_latent_likelihoods:
            probs_reshaped = _resize_spatial(probs_reshaped[:, None], inputs.shape[2:],
                                             resample_interpolation_mode)
        return probs_reshaped
