#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build and check its kernels, serve,
train, sample the 3D 128^3 model and train it, run the attention probes, the
latent route, the conditioned models, stage-1 adversarial training, the
autoregressive VQ-VAE + transformer stack, SPADE, the host data path
(the loader, training from disk, serving a checkpoint, the eval recipes),
export, tracing and the remaining recipes, and the multi-device paths.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. card and build: the card's name and power limit (nvidia-smi), the torch
     and CUDA versions, what the host offers the data path (the C++
     compiler, zlib.h, png.h, jpeglib.h, PyYAML, PIL, tensorboard), the TF32
     settings, and the builds of
     generativemodels_tpu_torch/csrc/flash_fwd.cu, flash_bwd.cu,
     fused_conv.cu and flash_probes.cu (one nvcc each, started together)
     with their times, the compiler's warnings and each entry function's
     registers, stack frame and spill bytes from ptxas (kernels 1-7 must
     have neither, and no wgmma may be serialized: kernels 6 and 7 overlap
     their products with the softmax, and kernels 1-4 on their wgmma route
     issue one tile's products with the next tile's), and each kernel's
     count of instantiations (kernels 1-4 have no mma.sync one at bf16 D =
     64 and 256 in the exp2 contracts, where their wgmma bodies run, kernels
     2-4 none at f32 D = 64, nor kernels 2 and 3 at f32 D = 128 and 256,
     where their TF32 wgmma bodies run in all three contracts);
  2. kernels against their plain versions: O and lse of the flash-attention
     forward kernel against `flash_attention_reference` (then the forward
     against the plain attention path at seq 256-1024, the numbers behind
     the flash threshold), dq, dk, dv of the split backward kernels and of
     the fused backward kernel against `flash_attention_backward_reference`
     (the fused one also against the split ones: dk, dv to the bit where
     the two run one body of `attention_route` (the wgmma ones for bf16 at
     D = 64 and 256, the TF32 one at f32 D = 64, else mma.sync), within the
     fused dq margin at f32 D = 128 and 256, where kernel 3 runs its TF32
     wgmma bodies and kernel 4 mma.sync, and dq within the fused dq margin
     of its largest value (at f32 D = 64, 128 and 256, where kernel 2 runs
     the TF32 bodies, also of the size of the terms that cancel at Sk = 1:
     `fused_agree`);
     and kernels 2 and 3 against themselves: dq, dk and dv must be the same
     to the bit over two launches; each case prints its routes, and the
     times of kernels 2 and 3 beside their bounds (and their share of
     them), the plain version's and SDPA's backward; the wgmma route's own
     cases, ROUTE_CASES, run kernels 1-4 in both exp2 contracts and under
     upcast, ROUTE_CASES_F32 the same shapes in f32, on kernels 2-4's
     TF32 body, ROUTE_CASES_WIDE the same shapes at bf16 D = 256, on
     kernels 1-4's D = 256 wgmma bodies, ROUTE_CASES_F32_WIDE the same
     shapes in f32 at D = 128 and 256, on kernels 1-3's TF32 bodies
     streamed over D), and the
     fused GroupNorm-SiLU-conv3d kernel against
     `fused_norm_silu_conv3d_reference` (two launches equal to the bit, and
     the sums over one 3D forward's 22 launches), at the shapes the serving, training
     and 3D sampling paths and their neighbours use, with both times (CUDA
     events), the least time the card could take (bound) and the time of a
     library call as a yardstick;
  3. serving: `recipes.serve.build_sampler` at the full serving config
     (2D UNet (128, 256, 256), 64x64, batch 4, DDIM-50) with every
     parameter drawn from a seeded generator, behind `start_server`,
     answering /healthz and three POST /sample requests (seeds 0, 1, 0);
     the forward kernel's launches counted over those requests; the kernel
     path held against the plain attention path for one UNet forward and
     for every step of one DDIM-50 chain;
  4. training: (a) `recipes.train_2d_ddpm.main` at its defaults (f32, batch
     64, 64x64) for ten steps, (b) the bench.py config (bf16 compute, batch
     128; kernels 2 and 3 on their D = 256 wgmma body) through
     `make_diffusion_train_step` for ten steps, each with the three
     kernels' launches counted over the run, and again for four steps
     under GMTPU_FLASH_FUSED_BWD=1 (kernel 4 on its D = 256 wgmma body, 3
     launches a step), its losses against the split run's; (c) one step's parameter
     gradients with seeded random weights, the kernel path against the
     plain attention path, without and with `use_checkpointing`;
  5. 3D sampling: bench.py's 3D UNet (32, 64, 128) in bf16 at 128^3, batch
     1, with GMTPU_FUSED_RESBLOCK=1, sampled through
     `DiffusionInferer.sample` once with DDIM-50 and three times with
     DPM-Solver++(2M)-10, the fused-conv and flash launches counted; the
     kernel path held against the unfused, plain-attention path for one
     forward in f32 and in bf16 and for every step of a DPM-10 chain; one
     profiled forward; then one POST /sample to
     `serve.build_sampler(solver="dpmsolver", ddim_steps=10)` on the 2D
     serving config;
  6. 3D training: (a) `recipes.train_3d_ddpm.main` at bench.py's 3D training
     config (UNet (32, 64, 128), bf16, 128^3, batch 1, no remat, lr 2.5e-5)
     for ten steps, once with the split backward and once with
     GMTPU_FLASH_FUSED_BWD=1, the launches counted; (b) one step's
     parameter gradients with seeded random weights: in f32 at 64^3 the
     split- and fused-kernel paths against the plain attention path, in
     bf16 at 128^3 the fused path against the split path; (c) one profiled
     training step at 128^3 with each backward;
  7. the attention-forward probes (kernels 6 and 7, wgmma fed by a TMA
     ring): (a) each of the ten kernel variants (seven of
     `ops.flash_overlap`, three of `ops.flash_vpu`) against its plain
     version at four shapes, the probes' own (2, 32768, 32768, 64) bf16 on
     its first 2048 query rows; (b) the entry points
     `probes.probe_overlap.main` and `probes.probe_attn_vpu.main` at their
     defaults, which time every variant at (2, 32768, 32768, 64) bf16,
     with the launches of kernels 1, 6 and 7 counted, each time printed
     beside its TFLOP/s, its share of the bound, the plain version's time
     and its ratio to kernel 1 (the VPU probe's `base` in the same call)
     and to flash SDPA;
  8. the latent 128^3 route: bench.py's fifth config (AEKL (32, 64, 64) bf16
     around the UNet (64, 128, 256) bf16 at a 32^3 latent, scale factor 0.3,
     random weights) through `LatentDiffusionInferer` and
     `probes/bench_3d_ldm.py`: (a) one training forward (the encode at
     128^3, one UNet forward); (b) the kernel path against the plain path,
     one UNet forward in f32 and bf16 and every step of an f32 DDIM-50 chain;
     (c) seconds per DDIM-50 and DPM-Solver++(2M)-10 sample from noise to
     the decoded volume (one warm-up, three timed, host clock) and the
     chain/decode split by CUDA events, kernel 1 counted at 5 launches a
     forward; (d) the same with GMTPU_FUSED_RESBLOCK=1, its forward held
     against the plain bf16 path; (e) `get_likelihood` (DDPM-50, KL maps
     resampled trilinearly to 128^3), `sample(save_intermediates=True)` and
     a PNDM-50 sample; (f) profiles of one UNet forward, one decode and one
     encode;
  9. conditioning: (a) the brain 3D LDM bundle at full width (the UNet
     (256, 512, 768) with cross-attention over the (1, 1, 4) covariates and
     upcast_attention, the AEKL (64, 128, 128, 128), bf16, random weights)
     through `recipes.brain_ldm_sampler.sample_brain_ldm`, DDIM-50 from the
     20x28x20 latent to the 160x224x160 volume, with and without
     GMTPU_FUSED_RESBLOCK=1: seconds per sample, chain and decode by CUDA
     events, busy share, peak memory, and the fused route held against the
     unfused one (an f32 and a bf16 forward, every step of an f32 DDIM-50
     chain); (b) the JAX ControlNet recipe's UNet and ControlNet through
     `ControlNetDiffusionInferer.sample` at batch 4, DDIM-50, 4 kernel-1
     launches a step, held against the plain path; (c) classifier-free
     guidance (`recipes.guidance.sample_with_guidance`) on the CXR LDM's
     UNet at full width with a (1, 77, 1024) context, DDIM-50 and
     DPM-Solver++-10, and one guided prediction against its two forwards.
 10. stage-1 and adversarial training: (a) `recipes.train_3d_ldm.main` at the
     JAX recipe's widths (AEKL (32, 64, 64) with attention at 32^3 = 32768
     tokens, PatchGAN 32 channels, latent UNet (32, 64, 64)) on a 128^3
     volume at batch 2 in f32 with the split and the fused backward, then in
     bf16: 2 warm-up + 6 adversarial stage-1 steps, 5 stage-2 steps and a
     DDPM-2 latent sample, seconds a step, peak memory, and kernels 1-4
     counted against what the attention blocks imply; (b) one stage-1
     generator step's gradients at 64^3, the kernel paths against the plain
     attention path; (c) `recipes.train_vqgan.main` and (d)
     `recipes.train_2d_ldm.main` at their defaults (no kernel on their
     paths); (e) a profiled stage-1 step at 128^3.
 11. the autoregressive stack: (a) the 2D VQ-VAE + transformer tutorial
     config (VQ-VAE (256, 256), 256 codes; transformer dim 96, depth 12, 8
     heads, random weights) through `VQVAETransformerInferer.sample` on the
     windowed and the KV-cache paths at 256 tokens (batch 1 and 16) and 1024
     tokens (batch 1), and 1024 tokens through max_seq_len 256 (the windowed
     path), seconds a sample by host clock and CUDA events, profiles of a
     256-token sample on each path (busy share), the numbers behind
     `resolve_use_cache`'s CUDA threshold, and a greedy (top_k=1) windowed
     chain against a cached one (equal tokens); (b)
     `recipes.train_vqvae_transformer.main` at --size 128 (1024 causal
     tokens of head width 32, kernels 1-3, then 1 and 4) for a few steps of
     each stage, seconds a step, peak memory and the kernels' launches; (c)
     one stage-2 step's gradients and (d) `get_likelihood` at 1024 tokens,
     the kernel paths against the plain attention path;
 12. SPADE: `recipes.train_spade_vae.main` and `recipes.train_spade_ldm.main`
     (with --sample) at their defaults for a few steps (no kernel: their
     attention stays under 1024 tokens), seconds a step and peak memory, and
     one SPADE UNet forward on the card against the CPU.
 13. the host data path: (a) the port's loader (csrc/dataloader.cpp, built
     with g++; its PNG and JPEG decoders only where their headers are):
     64 NIfTI files read 20 times with 4 workers in file order every time
     and in the seeded shuffle order, .npy files, 8- and 16-bit grey PNGs
     (decoded natively, or through PIL with the native decoder's scaling
     where the build has no PNG decoder, in file order either way), and
     volumes a second at 160x224x160, .nii and .nii.gz;
     (b) `recipes.train_2d_ddpm.main` at its defaults from gzipped NIfTI
     slices (--fit crop_pad --augment --cache --checkpoint-dir), kernels 1-3
     counted, steps/s and busy share beside the same run on synthetic blobs,
     the checkpoint's save and restore timed; (c) `recipes.serve` with
     --checkpoint-dir: three DDIM-50 requests of batch 4, 150 kernel-1
     launches each, each equal to an in-process sample of the trained
     weights; (d) `recipes.eval_quality.main` at its defaults with a few
     train steps from disk (kernels 1-3), its FID and MS-SSIM on the card
     against the CPU on the same features and images; (e)
     `recipes.eval_brain_ldm.main` at full width (4 samples and 2
     same-covariate pairs, DDIM-50, FID on (a)'s volumes): seconds a sample,
     the metrics' seconds, peak memory.
 14. export, tracing and the A10 recipes, on kernels 1-5 bound as
     `torch.library` ops of the `gmtpu_torch` namespace (phase 2 passes each
     op through `torch.library.opcheck` on CUDA tensors): (b) the 2D serving
     sampler (phase 3's widths, its chain cut to DDIM-10) exported by
     `utils/export.py` to a .pt2 file, served in process and by
     `recipes.serve --export-path --oneshot` in a separate process that
     builds no network, its images equal to the in-process sampler's to the
     bit with 30 kernel-1 launches both ways, the export's seconds, the file's size and a request's
     seconds; (c) phase 5's 3D sampler (bf16, 128^3, GMTPU_FUSED_RESBLOCK=1)
     exported with DDIM-10, equal bits, 22 kernel-5 and 4 kernel-1 launches
     a forward both ways; (d) one 2D request inside `utils.trace` and an
     `annotate` span, the Chrome trace naming the span, the op and its
     kernel; (e) the five library recipes (anomaly, inpaint,
     super_resolution, classifier_guidance, diffusion_autoencoder) at the
     serving widths and 64x64 on the kernel path against the plain path,
     `recipes.train_controlnet.main` at its defaults for a few steps
     (kernels 1-3 counted) and one ControlNet step's gradients against the
     plain path, `recipes.compare_schedulers.main` with a few training steps
     and step counts 10 and 25, and `recipes.segmentation_ddpm.main` at its
     defaults (no kernel).
 15. multi-device (parallel/, ops/sharded_attention.py): (a)
     `recipes.train_3d_ddpm.main --data-parallel` at phase 6 (a)'s config on
     an `nccl` group of one rank, its losses equal to phase 6 (a)'s split run
     to the bit, kernels 1-3 counted; (b) the sequence-parallel pieces at the
     3D attention shape (2, 32768, 32768, 64) bf16 for n = 2 and 4: the
     allgather's local kernel 1 at (2, S/n, S, 64) and kernels 2-3 at Sq =
     S/n against the unsharded kernels' rows (dk, dv summed over the n
     blocks), the ring's n chunks of kernel 1 with its lse at (2, S/n, S/n,
     64) merged by `_combine_chunks`, and kernel 5's halo-slab calls of the
     128^3 96->32 case against its unsharded output, each timed; (c)
     `probes/multi_card.py` on two `gloo` ranks that share cuda:0 (`nccl`
     refuses two ranks on one card): the cut ("space": 2) 3D training step
     at 128^3 and the allgather and ring attention at the 3D shape, against
     one rank; a collective that gloo refuses fails the phase; (d) the same
     way, the 3D LDM recipe's stage-1 G+D step (`train_3d_ldm.build_models`,
     128^3, batch 2) cut on {"space": 2} in f32 (losses within 1e-5 of the
     uncut step, G's and D's gradients within 1e-5 or twice the distance of
     two f32 orders of the uncut step, the PatchGAN's float64 gradients
     within 1e-8) and bf16 (within twice the uncut bf16 step's distance from
     f32), kernels 1-3 counted on each rank
     over the cut f32 step (the AEKL's attention through the allgather at
     (2, 16384, 32768, 64) f32), and the VQ-GAN recipe's step (64x64, batch
     16) cut on {"space": 2}; (b) also times SDPA's backward at the
     allgather's shapes and kernel 5's plain version and F.conv3d on a halo
     slab.
Phase 2 also holds kernels 1-4 at phase 10's two f32 shapes, (2, 32768,
32768, 64) and (2, 4096, 4096, 64), at phase 15 (d)'s (2, 16384, 32768,
64) f32 (a rank's allgather rows), at phase 11's causal (64, 1024, 1024,
32) f32, and under the JAX kernel's other two contracts
(`upcast=True`, the running max of GMTPU_FLASH_NOMAX=0) against their plain
versions, Sk = 1 and 77 among the shapes, times them at the 2D and 3D
shapes, runs one forward of (b)'s UNet under each contract against the
plain path, and holds kernel 5 at the brain UNet's shapes.
The second-to-last line is one JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import base64
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "fused_conv.cu", "flash_probes.cu")
CSRC = "generativemodels_tpu_torch/csrc/"
TPU_KERNELS = "generativemodels_tpu/ops/flash_attention.py"
# JSON name: (launcher in ops, source, the Pallas kernel it replaces)
KERNELS = {
    "flash_fwd": ("FLASH_FWD", "flash_fwd.cu", f"{TPU_KERNELS}:202"),  # _fwd_kernel
    "flash_bwd_dq": ("FLASH_BWD_DQ", "flash_bwd.cu", f"{TPU_KERNELS}:343"),  # _dq_kernel
    "flash_bwd_dkv": ("FLASH_BWD_DKV", "flash_bwd.cu", f"{TPU_KERNELS}:475"),  # _dkv_kernel
    # _dfused_kernel, under GMTPU_FLASH_FUSED_BWD=1
    "flash_bwd_fused": ("FLASH_BWD_FUSED", "flash_bwd.cu", f"{TPU_KERNELS}:572"),
    "fused_conv": ("FUSED_CONV", "fused_conv.cu", "generativemodels_tpu/ops/fused_conv.py:93"),
    # the attention-forward probes, run by their entry points in phase 7
    "flash_probe_overlap": ("FLASH_PROBE_OVERLAP", "flash_probes.cu",
                            "benchmarks/probe_overlap.py:94"),  # _kernel
    "flash_probe_vpu": ("FLASH_PROBE_VPU", "flash_probes.cu",
                        "benchmarks/probe_attn_vpu.py:45"),  # _fwd_kernel_var
}
# the card's published peaks (H100 SXM data sheet, dense, 700 W): f32 on the
# CUDA cores (kernel 5 runs its f32 products there, with no TF32), bf16 on
# the tensor cores, and the device memory's rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# the f32 paths of kernels 1-4 run each f32 product as three TF32
# products on the tensor cores (3xTF32): their useful operations cost three
# at the TF32 rate, 495 TFLOP/s, so their bound is useful operations x 3 /
# 495e12 (not / 67e12, which a 3xTF32 kernel may beat)
PEAK_3XTF32 = 495e12 / 3

# (name, (BH, Sq, Sk, D), dtype name, causal)
KERNEL_CASES = (
    ("serve_f32", (4, 1024, 1024, 256), "float32", False),
    ("serve_bf16", (4, 1024, 1024, 256), "bfloat16", False),
    ("level2_f32", (4, 256, 256, 256), "float32", False),
    ("head64_bf16", (2, 4096, 4096, 64), "bfloat16", False),  # the latent UNet's (phase 8)
    ("causal_f32", (4, 1024, 1024, 128), "float32", True),
    ("ragged_cross_f32", (2, 1000, 777, 64), "float32", False),
    ("3d_level2_bf16", (2, 32768, 32768, 64), "bfloat16", False),  # the 3D UNet's attention
    ("train_bench_bf16", (128, 1024, 1024, 256), "bfloat16", False),  # bench.py, batch 128
    ("head32_bf16", (4, 1024, 1024, 32), "bfloat16", False),
    ("causal_bf16", (4, 1024, 1024, 128), "bfloat16", True),
    ("ragged_cross_bf16", (2, 1000, 777, 64), "bfloat16", False),
    # phase 10's f32 3D LDM recipe: the stage-1 AEKL's attention at 32^3 and
    # the latent UNet's level 1 at 16^3, both one head of 64 at batch 2
    ("aekl_3d_f32", (2, 32768, 32768, 64), "float32", False),
    ("latent_unet_f32", (2, 4096, 4096, 64), "float32", False),
    # phase 11's autoregressive training path: the recipe's stage 2 at --size
    # 128, batch 16 x 4 heads of 32 over 1024 causal tokens
    ("ar_causal_f32", (64, 1024, 1024, 32), "float32", True),
    # ControlNet's sampler (batch 4) and training step at its defaults (batch
    # 16), heads of 128, and the 2D f32 recipe's training step (batch 64,
    # heads of 256): kernel 1's TF32 body at the shapes those paths give it
    ("controlnet_sample_f32", (4, 1024, 1024, 128), "float32", False),
    ("controlnet_train_f32", (16, 1024, 1024, 128), "float32", False),
    ("train_recipe_f32", (64, 1024, 1024, 256), "float32", False),
)
# O, max|diff|: f32 differs from the plain version only in summation order
# (the 3xTF32 products keep f32 accuracy); bf16 O is rounded to bf16 (one
# ulp near 1 is 2**-7)
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
# lse, max|diff|: an f32 log of the same row sums in another order, in both
# types (the bf16 row sum follows the same rounding rule as the plain version)
LSE_TOLERANCE = {"float32": 1e-5, "bfloat16": 1e-4}
# the flash threshold (`ops/attention.py::_FLASH_MIN_SEQ`, 1024, set on a
# TPU): kernel 1 against the plain attention path through
# `dot_product_attention` at these sequence lengths, as (B, heads, D, dtype)
THRESHOLD_SEQS = (256, 512, 1024)
THRESHOLD_CASES = ((2, 2, 64, "bfloat16"), (4, 1, 256, "float32"))
# kernels whose every instantiation must show no stack frame and no spills
# in phase 1 (kernels 1-7, whose accumulators live in registers), and how
# many instantiations the ptxas log of each source must report for them
# (kernel 1: 4 head widths x the contracts, 2 in bf16 and 3 in f32
# (csrc/flash_contract.cuh), where bf16 D = 64 in the 2 exp2 contracts is
# the wgmma body at 64- and 128-row blocks (4) in place of 2 mma.sync ones;
# kernels 2-4: 3 kernels x the same 20, where each at bf16 D = 64 in the 2
# exp2 contracts is its wgmma body (6 in all), each at bf16 D = 256 in the
# 2 exp2 contracts its D = 256 wgmma body (6 in all), each at f32 D = 64 in
# the 3 contracts its TF32 wgmma body (9 in all), and kernels 2 and 3 at f32
# D = 128 and 256 their TF32 body streamed over D (12 in all); kernel 5: the
# f32 kernel at 3 BN, the bf16 kernel at the 3 depth runs of
# `ops.fused_conv.CONV_RUNS`; kernels 6 and 7: 7 overlap variants and the 4
# (scale in kernel, bf16 p) pairs), so that a log that stops matching fails
NO_STACK_KERNELS = ("flash_fwd_bf16_kernel", "flash_fwd_f32_kernel", "flash_fwd_wgmma_kernel",
                    "flash_fwd_wide_kernel", "flash_fwd_stream_kernel",
                    "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_bwd_fused_kernel",
                    "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
                    "flash_bwd_fused_wgmma_kernel", "flash_bwd_dq_tf32_kernel",
                    "flash_bwd_dkv_tf32_kernel", "flash_bwd_fused_tf32_kernel",
                    "flash_bwd_dq_wide_kernel", "flash_bwd_dkv_wide_kernel",
                    "flash_bwd_fused_wide_kernel", "flash_bwd_dq_stream_kernel",
                    "flash_bwd_dkv_stream_kernel",
                    "fused_conv_f32_kernel", "fused_conv_mma_kernel",
                    "flash_probe_overlap_kernel", "flash_probe_vpu_kernel")
NO_STACK_INSTANCES = {"flash_fwd.cu": 24, "flash_bwd.cu": 60, "fused_conv.cu": 6,
                      "flash_probes.cu": 11}
# the same counts kernel by kernel for the flash sources: the mma.sync
# bodies of kernels 1-4 lack bf16 D = 64 in the exp2 contracts (kernel 1's
# bf16 one: 3 other widths x 2 contracts; kernels 2-4's: 20 - 2), which the
# wgmma bodies take (kernel 1 at two block heights); those of kernels 2-4
# also lack bf16 D = 256 in the exp2 contracts and f32 at D = 64 (kernels 2
# and 3 also at 128 and 256: 20 - 2 - 2 - 9, bf16 D = 32 and 128 and f32 D
# = 32 left; kernel 4: 20 - 2 - 2 - 3), which their D = 256 wgmma and TF32
# bodies take
KERNEL_INSTANCES = {
    "flash_fwd.cu": {"flash_fwd_bf16_kernel": 4, "flash_fwd_f32_kernel": 6,
                     "flash_fwd_wgmma_kernel": 4, "flash_fwd_wide_kernel": 4,
                     "flash_fwd_stream_kernel": 6},
    "flash_bwd.cu": {"flash_bwd_dq_kernel": 7, "flash_bwd_dkv_kernel": 7,
                     "flash_bwd_fused_kernel": 13, "flash_bwd_dq_wgmma_kernel": 2,
                     "flash_bwd_dkv_wgmma_kernel": 2, "flash_bwd_fused_wgmma_kernel": 2,
                     "flash_bwd_dq_wide_kernel": 2, "flash_bwd_dkv_wide_kernel": 2,
                     "flash_bwd_fused_wide_kernel": 2, "flash_bwd_dq_tf32_kernel": 3,
                     "flash_bwd_dkv_tf32_kernel": 3, "flash_bwd_fused_tf32_kernel": 3,
                     "flash_bwd_dq_stream_kernel": 6, "flash_bwd_dkv_stream_kernel": 6},
}
# (name, (BH, Sq, Sk, D), dtype name, causal) of the backward kernels
BACKWARD_CASES = (
    ("train_bench_bf16", (128, 1024, 1024, 256), "bfloat16", False),  # bench.py, batch 128
    ("train_recipe_f32", (64, 1024, 1024, 256), "float32", False),  # the recipe, batch 64
    ("causal_f32", (4, 1024, 1024, 128), "float32", True),
    ("ragged_cross_f32", (2, 1000, 777, 64), "float32", False),
    ("head64_bf16", (2, 4096, 4096, 64), "bfloat16", False),
    ("3d_level2_bf16", (2, 32768, 32768, 64), "bfloat16", False),  # the 3D training step's
    ("aekl_3d_f32", (2, 32768, 32768, 64), "float32", False),  # phase 10, stage 1
    ("latent_unet_f32", (2, 4096, 4096, 64), "float32", False),  # phase 10, stage 2
    # phase 15 (d)'s cut f32 stage-1 step: a rank's local rows of the
    # allgather against every key
    ("seq_parallel_f32", (2, 16384, 32768, 64), "float32", False),
    ("ar_causal_f32", (64, 1024, 1024, 32), "float32", True),  # phase 11, stage 2
)
# max|diff| / max|ref| of dq, dk, dv: f32 sums over 1024+ keys in another
# order; bf16 rounds ds, p and the outputs to bf16
BACKWARD_TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
# the fused kernel's dq against the split kernel's, relative to max|dq|: the
# same f32 products summed in another order (the key blocks' parts in
# key-block order; both kernels compute every ds by one function, so a bf16
# ds rounds alike); a bf16 dq may also round to the other side of a tie, one
# bf16 ulp (2**-7 of the value's power of two)
FUSED_DQ_RTOL = 1e-5
# the plain backward holds several f32 (Sq, Sk) matrices of each head at
# once: above this many elements in one it runs one head at a time (the 3D
# shape: 4.3 GB a matrix)
PLAIN_BACKWARD_MAX = 2**28
SERVE = dict(spatial_dims=2, size=64, channels=(128, 256, 256), norm_groups=32, batch=4,
             ddim_steps=50)
SEEDS = (0, 1, 0)
# per UNet forward at 64x64: down_1.attn_0, up_1.attn_0 and up_1.attn_1 run
# at 32x32 = 1024 tokens (the 16x16 level and the mid block stay plain)
LAUNCHES_PER_FORWARD = 3
FORWARD_RTOL = 1e-4  # kernel path vs plain path, one UNet forward, relative to max |out|
CHAIN_ATOL = 1e-3  # the same for each step of a DDIM-50 chain, absolute
TRAIN_STEPS = 10
# phase 4 (b)'s bench.py config again under GMTPU_FLASH_FUSED_BWD=1
BENCH_FUSED_STEPS = 4
# bench.py's training config: the recipe's model in bf16 compute at batch 128
BENCH = dict(channels=(128, 256, 256), size=64, batch=128, lr=2.5e-5)
GRAD_BATCH = 4
GRAD_RTOL = 1e-3  # kernel path vs plain path, max|diff| / max|grad| of every parameter
# kernel 5 at each distinct (Cin, Cout, residual, level) of the 3D UNet's
# forward at 128^3, batch 1: (name, (B, D, H, W), Cin, Cout, residual, dtype)
FUSED_CASES = (
    ("128_32to32", (1, 128, 128, 128), 32, 32, False, "bfloat16"),  # down 0
    ("128_32to32r", (1, 128, 128, 128), 32, 32, True, "bfloat16"),
    ("128_96to32", (1, 128, 128, 128), 96, 32, False, "bfloat16"),  # up 2
    ("128_64to32", (1, 128, 128, 128), 64, 32, False, "bfloat16"),
    ("64_32to64", (1, 64, 64, 64), 32, 64, False, "bfloat16"),  # down 1
    ("64_64to64r", (1, 64, 64, 64), 64, 64, True, "bfloat16"),
    ("64_192to64", (1, 64, 64, 64), 192, 64, False, "bfloat16"),  # up 1
    ("64_96to64", (1, 64, 64, 64), 96, 64, False, "bfloat16"),
    ("32_64to128", (1, 32, 32, 32), 64, 128, False, "bfloat16"),  # down 2
    ("32_128to128r", (1, 32, 32, 32), 128, 128, True, "bfloat16"),
    ("32_128to128", (1, 32, 32, 32), 128, 128, False, "bfloat16"),  # mid
    ("32_256to128", (1, 32, 32, 32), 256, 128, False, "bfloat16"),  # up 0
    ("32_192to128", (1, 32, 32, 32), 192, 128, False, "bfloat16"),
    ("128_96to32_f32", (1, 128, 128, 128), 96, 32, False, "float32"),
    ("32_128to128r_f32", (1, 32, 32, 32), 128, 128, True, "float32"),
    ("ragged_f32", (2, 5, 7, 9), 40, 24, True, "float32"),
)
FUSED_MAIN_CASE = "128_96to32"  # the kernels line's numbers for kernel 5
# kernel 5 at each distinct (Cin, Cout, residual, level) of the brain LDM
# UNet's forward (phase 9) at its 20x28x20 latent under the fused route: odd
# extents, H != W, W < 32, Cin up to 1536 on the up path; and how many times
# one forward launches each (34 in all)
BRAIN_FUSED_CASES = tuple(
    (f"brain_{name}", shape, cin, cout, residual, "bfloat16")
    for name, shape, cin, cout, residual in (
        ("l0_256to256", (1, 20, 28, 20), 256, 256, False),
        ("l0_256to256r", (1, 20, 28, 20), 256, 256, True),
        ("l0_768to256", (1, 20, 28, 20), 768, 256, False),
        ("l0_512to256", (1, 20, 28, 20), 512, 256, False),
        ("l1_256to512", (1, 10, 14, 10), 256, 512, False),
        ("l1_512to512r", (1, 10, 14, 10), 512, 512, True),
        ("l1_512to512", (1, 10, 14, 10), 512, 512, False),
        ("l1_1280to512", (1, 10, 14, 10), 1280, 512, False),
        ("l1_1024to512", (1, 10, 14, 10), 1024, 512, False),
        ("l1_768to512", (1, 10, 14, 10), 768, 512, False),
        ("l2_512to768", (1, 5, 7, 5), 512, 768, False),
        ("l2_768to768r", (1, 5, 7, 5), 768, 768, True),
        ("l2_768to768", (1, 5, 7, 5), 768, 768, False),
        ("l2_1536to768", (1, 5, 7, 5), 1536, 768, False),
        ("l2_1280to768", (1, 5, 7, 5), 1280, 768, False),
    )
)
BRAIN_FUSED_LAUNCHES = {
    "brain_l0_256to256": 2, "brain_l0_256to256r": 5, "brain_l0_768to256": 1,
    "brain_l0_512to256": 2, "brain_l1_256to512": 1, "brain_l1_512to512r": 5,
    "brain_l1_512to512": 1, "brain_l1_1280to512": 1, "brain_l1_1024to512": 1,
    "brain_l1_768to512": 1, "brain_l2_512to768": 1, "brain_l2_768to768r": 7,
    "brain_l2_768to768": 3, "brain_l2_1536to768": 2, "brain_l2_1280to768": 1,
}
# how many times one forward of the 3D UNet at 128^3 launches kernel 5 at
# each bf16 case (22 in all; phase 5 counts them on the model): the weights
# of phase 2's sums over a forward
FUSED_FORWARD_LAUNCHES = {
    "128_32to32": 1, "128_32to32r": 3, "128_96to32": 1, "128_64to32": 1,
    "64_32to64": 1, "64_64to64r": 3, "64_192to64": 1, "64_96to64": 1,
    "32_64to128": 1, "32_128to128r": 5, "32_128to128": 2, "32_256to128": 1, "32_192to128": 1,
}
# max|diff| / max|ref|: f32 differs from the plain version in summation
# order over 27 * Cin products; bf16 rounds the output to bf16 (2**-8 of
# its value) after f32 sums in another order
FUSED_TOLERANCE = {"float32": 1e-5, "bfloat16": 1e-2}
# bench.py's 3D sampling config: 3D UNet (32, 64, 128), attention on the last
# level only, 64 head channels, bf16 compute, 128^3, batch 1
THREE_D = dict(channels=(32, 64, 128), size=128, batch=1, head_channels=64, norm_groups=32)
DDIM_STEPS_3D = 50
DPM_STEPS = 10
DPM_SEEDS = (0, 1, 2)
# kernel path vs unfused plain-attention path, one 3D forward in f32:
# max|diff| / max|out|; f32 sums in another order, and the fused route's
# GroupNorm variance is E[x^2] - E[x]^2 with the temb folded in algebra
FORWARD_RTOL_3D = 1e-4
# in bf16 both paths round to bf16 at other places (the fused route rounds
# the normalised activation once and the conv output after its bias; the
# unfused route after the norm, the SiLU and the conv): the kernel path may
# differ from the plain bf16 path by at most twice the plain bf16 path's own
# distance from the plain f32 path (a forward, and every DPM-10 step), the
# triangle bound if the kernel path rounds no worse than the plain one
BF16_RATIO_3D = 2.0
# kernel groups of the 3D forward's profile, matched in this order by name
PROFILE_GROUPS = (
    ("fused_conv (kernel 5)", ("fused_conv",)),
    ("flash_fwd (kernel 1)", ("flash_fwd",)),
    ("layout copies and casts", ("copy", "nchwToNhwc", "nhwcToNchw", "Memcpy")),
    ("cuDNN convolutions", ("xmma", "cudnn", "conv", "gemm")),
    ("GroupNorm and statistics", ("Moments", "reduce_kernel", "group_norm", "pow_tensor")),
    ("other", ("",)),
)
# bench.py's 3D training config (measure_3d_train_steps_per_sec) as recipe flags
TRAIN_3D_ARGS = ("--size", "128", "--batch", "1", "--channels", "32", "64", "128",
                 "--dtype", "bf16", "--no-remat", "--lr", "2.5e-5")
# one 3D training step's launches: four attention blocks (down 2, mid, two in
# up 0), each one forward and one backward; the training route keeps the
# unfused ResnetBlock, as the JAX one does, so no kernel 5
TRAIN_3D_LAUNCHES = {
    "split": dict(flash_fwd=4, flash_bwd_dq=4, flash_bwd_dkv=4),
    "fused": dict(flash_fwd=4, flash_bwd_fused=4),
}
GRAD_SIZE_3D = 64  # the f32 gradient check: attention at 16^3 = 4096 tokens, plain path fits
# the bf16 gradients at 128^3, fused path vs split path, in the norm of all
# parameters' gradients together, ||diff|| / ||grad||: the two differ only in
# dq's f32 summation order, which moves a bf16 dq element by one ulp (2**-8
# of it) at most; each layer before the attention may then round its bf16
# backward to the other side, a few ulps of a gradient element at most, so
# even every element off by 2**-8 would give 3.9e-3. The largest
# max|diff| / max|grad| of one parameter is printed beside it, not checked:
# where a small gradient is a sum of bf16 terms that cancel (the time
# embedding's bias), one re-rounded term is ~1e-2 of it, as two runs of the
# same fused path show
BF16_GRAD_RTOL_3D = 1e-2
# phase 2 (d): the JAX kernel's other two contracts on kernels 1-4, as
# (upcast, no_max): `upcast=True` (the reference's upcast_attention: f32
# operands, the scale after the product, natural exp, running max) and
# `no_max=False` (GMTPU_FLASH_NOMAX=0: the running max in the log2 domain)
CONTRACTS = {"upcast": (True, True), "running_max": (False, False)}
# (name, (BH, Sq, Sk, D), dtype name, causal, timed): the model shapes, D
# 32-256, causal, ragged, and the cross-attention contexts Sk = 1 (the brain
# covariates) and 77 (CXR text) at Sq 1024 and 4096; the timed cases are
# the 2D serving shape and the 3D training shape
CONTRACT_CASES = (
    ("serve", (4, 1024, 1024, 256), "float32", False, True),
    ("serve", (4, 1024, 1024, 256), "bfloat16", False, True),
    ("3d_level2", (2, 32768, 32768, 64), "bfloat16", False, True),
    ("head64", (2, 4096, 4096, 64), "bfloat16", False, False),
    ("causal", (4, 1024, 1024, 128), "float32", True, False),
    ("causal", (4, 1024, 1024, 128), "bfloat16", True, False),
    ("head32", (4, 1024, 1024, 32), "float32", False, False),
    ("ragged", (2, 1000, 777, 64), "bfloat16", False, False),
    ("ctx1_1024", (8, 1024, 1, 32), "float32", False, False),
    ("ctx1_4096", (8, 4096, 1, 64), "bfloat16", False, False),
    ("ctx1_4096", (4, 4096, 1, 256), "float32", False, False),
    ("ctx77_1024", (8, 1024, 77, 128), "bfloat16", False, False),
    ("ctx77_1024", (8, 1024, 77, 64), "float32", False, False),
    ("ctx77_4096", (4, 4096, 77, 256), "bfloat16", False, False),
)
# the wgmma route's own cases (bf16 at D = 64; Sq and Sk no multiples of its
# 64-row tiles or 128-row blocks): causal, ragged, the contexts Sk = 1 and 77,
# Sq below and above Sk (the sequence-parallel allgather's local rows against
# every key). Phase 2 (d) runs them after CONTRACT_CASES under each contract
# of CONTRACTS and under the default one (no_max), which phase 2's backward
# cases hold at the model shapes alone
ROUTE_CASES = (
    ("route_causal", (3, 257, 257, 64), "bfloat16", True, False),
    ("route_ragged", (2, 200, 333, 64), "bfloat16", False, False),
    ("route_ctx1", (4, 1024, 1, 64), "bfloat16", False, False),
    ("route_ctx77", (4, 1000, 77, 64), "bfloat16", False, False),
    ("route_sq_below_sk", (2, 512, 2048, 64), "bfloat16", False, False),
    ("route_sq_above_sk_causal", (2, 700, 300, 64), "bfloat16", True, False),
)
# the same cases in f32: kernels 2-4's TF32 wgmma bodies (f32 at D = 64,
# 32-row tiles, 128-row blocks) in all three contracts
ROUTE_CASES_F32 = tuple((f"{name}_f32", shape, "float32", causal, timed)
                        for name, shape, _, causal, timed in ROUTE_CASES)
# the same shapes at head width 256 in bf16: kernels 1-4's D = 256
# wgmma bodies (kernel 1: 64- or 128-row blocks, 64-key stages; kernel 2:
# 128-row blocks, 32-key tiles; kernels 3 and 4: 64-key blocks, 64-row q
# tiles) in both exp2 contracts (upcast runs them all in f32 on the TF32
# bodies below, kernel 4 on mma.sync)
ROUTE_CASES_WIDE = tuple((f"{name}_d256", (bh, sq, sk, 256), dtype_name, causal, timed)
                         for name, (bh, sq, sk, _), dtype_name, causal, timed in ROUTE_CASES)
# the same shapes in f32 at head widths 128 and 256: kernels 1, 2 and 3's
# TF32 bodies streamed over D (64-row blocks, 32-row tiles; kernel 1's
# blocks in clusters of two that split the keys where its blocks would leave
# half of the SMs idle, as these shapes' do) in all three contracts
ROUTE_CASES_F32_WIDE = tuple((f"{name}_f32_d{d}", (bh, sq, sk, d), "float32", causal, timed)
                             for d in (128, 256)
                             for name, (bh, sq, sk, _), _, causal, timed in ROUTE_CASES)
CONTRACT_RUNS = ([(c, flags, CONTRACT_CASES) for c, flags in CONTRACTS.items()]
                 + [(c, flags, cases) for cases in (ROUTE_CASES, ROUTE_CASES_F32,
                                                    ROUTE_CASES_WIDE, ROUTE_CASES_F32_WIDE)
                    for c, flags in {**CONTRACTS, "no_max": (False, True)}.items()])
# the kernels line's contract numbers: kernel 1 and kernels 2 + 3 at the 2D
# serving shape in f32 (kernel 1's main case), kernel 4 at the 3D shape
CONTRACT_MAIN = {"flash_fwd": ("serve", "float32"), "flash_bwd_dq": ("serve", "float32"),
                 "flash_bwd_dkv": ("serve", "float32"),
                 "flash_bwd_fused": ("3d_level2", "bfloat16")}

# phase 9 (a): the brain 3D LDM bundle (the published
# brain_image_synthesis_latent_diffusion_model config, as the JAX recipe
# recipes/eval_brain_ldm.py:113-118 builds it without --tiny: the networks of
# recipes/brain_ldm_sampler.py), bf16, seeded random weights; the preset's
# DDIM (brain_3d_ldm.yaml:33-39) for 50 steps; the latent of
# eval_brain_ldm.py's BUNDLE_LATENT, decoded 8x to 160x224x160
BRAIN_LATENT = (1, 3, 20, 28, 20)
BRAIN_COVARIATES = dict(gender=1.0, age=0.6, ventricular_vol=0.3, brain_vol=0.7)
BRAIN_STEPS = 50
BRAIN_RUNS = 2  # timed samples after one warm-up, each setting of the fused route
# phase 9 (b): the JAX ControlNet recipe's config (recipes/train_controlnet.py:
# 118-125 and its defaults: channels (64, 128, 128), one res block, attention
# on levels 1-2 with 128-wide heads, 32 groups, 64x64; the ControlNet with
# conditioning_embedding_num_channels (16,), :152-154), sampled at batch 4
# (:183-196) by DDIM-50. Kernel 1 runs at level 1's 32x32 = 1024 tokens,
# (4, 1024, 1024, 128): once in the ControlNet's down path, three times in
# the UNet's (one down, two up); level 2 and the mid block stay plain
CONTROLNET = dict(channels=(64, 128, 128), size=64, batch=4, norm_groups=32, steps=50)
CN_FLASH_PER_FORWARD = 4
# phase 2 (d)'s model forwards on (b)'s UNet: under GMTPU_FLASH_NOMAX=0, and
# with the brain bundle's conditioning (cross_attention_dim 4, a (4, 1, 4)
# context, upcast_attention; upcast_attention acts in the SpatialTransformer
# only): each of its three level-1 transformers launches kernel 1 twice, the
# self-attention at (4, 1024, 1024, 128) and the cross-attention at (4,
# 1024, 1, 128)
CONTRACT_UNET_LAUNCHES = {"running_max": 3, "upcast": 6}
# phase 9 (c): classifier-free guidance on the CXR LDM's UNet at full width
# (config/presets/cxr_ldm.yaml:20-30: (256, 512, 768), two res blocks,
# attention on levels 1-2, heads (0, 512, 768), cross_attention_dim 1024, 3
# latent channels), bf16, a 64x64 latent, a (1, 77, 1024) text context,
# guidance 7.0, the preset's DDIM (:32-38) for 50 steps and DPM-Solver++ for
# 10. Every attention is at D = 512 or 768: the plain path in both packages
CXR = dict(channels=(256, 512, 768), heads=(0, 512, 768), latent=(1, 3, 64, 64),
           context=(1, 77, 1024), guidance=7.0, ddim_steps=50, dpm_steps=10)

# phase 7 (a): (name, (BH, Sq, Sk, D), query rows held against the plain
# version, None for all); the plain version over all keys is exact for the
# rows it computes, so the probes' shape is checked on its first 2048 rows.
# A variant whose kernel does not take a shape runs at the nearest one it
# does (`ops.flash_probes.nearest_shape`): kernel 7 at Sk = 256 for "small" (its 128-key step),
# q2 at Sq = 256 for "ring" (whole 128-row blocks). "small" ends on a half
# key tile for kernel 6; "ring" has nine key tiles (the four-stage K/V ring
# wraps twice, an odd count) under a last block of 64 query rows, BH odd
PROBE_CASES = (
    ("head64", (2, 4096, 4096, 64), None),
    ("3d_level2", (2, 32768, 32768, 64), 2048),
    ("small", (1, 128, 192, 64), None),
    ("ring", (3, 192, 1152, 64), None),
)
# `ops.flash_probes.relative_error`: bf16 output, p rounded to bf16 after f32
# sums in another order, and the packed bf16 exp rounds its argument to bf16;
# mxu_only on the rows whose plain |l| >= 1, each against its own max
PROBE_TOLERANCE = 2e-2
# the variant of each probe kernel whose numbers stand in the kernels line
PROBE_MAIN_VARIANT = {"flash_probe_overlap": "full", "flash_probe_vpu": "both"}
PLAIN_PROBE_ITERS = 3  # the plain versions take 40-275 ms a call at the probes' shape
# phase 8: bench.py's latent 128^3 config (probes/bench_3d_ldm.py): AEKL (32,
# 64, 64) bf16 around the UNet (64, 128, 256) bf16 at a 32^3 latent. Kernel 1
# runs at 16^3 = 4096 tokens, 2 heads of 64: 2 launches in down level 1, 3 in
# up level 1 (the 8^3 level and the mid block, 512 tokens, stay plain)
LDM_FLASH_PER_FORWARD = 5
LDM_RUNS = 3  # timed samples after one warm-up, each solver
LDM_LIKELIHOOD_STEPS = 50  # DDPM plan of the likelihood
LDM_PNDM_STEPS = 50  # PNDM's plan (59 steps with the Runge-Kutta warm-up)
LDM_INTERMEDIATE_STEPS = 100  # DDIM-50 keeps t = 900, 800, ..., 0
# kernel groups of the latent forward's and the decode's profiles
LDM_PROFILE_GROUPS = (
    ("fused_conv (kernel 5)", ("fused_conv",)),
    ("flash_fwd (kernel 1)", ("flash_fwd",)),
    ("nearest upsampling", ("upsample_nearest", "UpSample")),
    ("layout copies and casts", ("copy", "nchwToNhwc", "nhwcToNchw", "Memcpy")),
    ("cuDNN convolutions and cuBLAS products", ("xmma", "cudnn", "conv", "gemm", "Conv",
                                                "cutlass")),
    ("GroupNorm and statistics", ("Moments", "reduce_kernel", "group_norm", "GroupNorm",
                                  "pow_tensor")),
    ("other", ("",)),
)

# phase 10: the JAX recipe recipes/train_3d_ldm.py at its model widths (AEKL
# (32, 64, 64), attention on its last level, 3 latent channels; PatchGAN 32
# channels, 3 layers, instance norm; latent UNet (32, 64, 64), heads of 64)
# and its f32 default, on a 128^3 volume at batch 2, with seeded random
# weights; two reconstruction-only steps among eight stage-1 steps, then five
# stage-2 steps and a DDPM-2 latent sample
LDM3D_STEPS = dict(warmup=2, stage1=8, stage2=5, sample=2)
LDM3D_ARGS = ("--size", "128", "--batch", "2", "--warmup-steps", str(LDM3D_STEPS["warmup"]),
              "--stage1-steps", str(LDM3D_STEPS["stage1"]),
              "--stage2-steps", str(LDM3D_STEPS["stage2"]),
              "--sample", "--sample-steps", str(LDM3D_STEPS["sample"]))
# kernel launches: a stage-1 step's G forward runs the AEKL's two attention
# blocks at 32^3 = 32768 tokens (encoder level 2, decoder level 0), forward
# and backward (D has no attention); a stage-2 step's encode runs the
# encoder's block forward only (no autograd), its UNet forward three blocks
# at 16^3 = 4096 tokens (one down, two up; the 8^3 level and the mid block,
# 512 tokens, stay plain), each forward and backward; the scale factor's
# encode and the sample's decode one forward each, a sample step three
LDM3D_LAUNCHES = {
    "split": (dict(flash_fwd=2, flash_bwd_dq=2, flash_bwd_dkv=2),
              dict(flash_fwd=4, flash_bwd_dq=3, flash_bwd_dkv=3)),
    "fused": (dict(flash_fwd=2, flash_bwd_fused=2), dict(flash_fwd=4, flash_bwd_fused=3)),
}
LDM3D_RUNS = (("split", "0", "f32"), ("fused", "1", "f32"), ("split", "0", "bf16"))
# the head width of its attention (the AEKL's at (2, 32768, 32768, 64), the
# latent UNet's at (2, 4096, 4096, 64))
LDM3D_HEAD = 64
LDM3D_GRAD_SIZE = 64  # the gradient check: the AEKL's attention at 16^3 = 4096 tokens
# phase 10 (c), (d): the 2D recipes at their defaults (train_vqgan: VQ-VAE
# (128, 256), 256 codes of 32, PatchGAN 64 channels, batch 16, 64x64;
# train_2d_ldm: AEKL (64, 128, 128), UNet (64, 128, 128), batch 16, 64x64);
# neither launches a kernel (no attention in the VQ-VAE or the 2D AEKL; the
# 2D latent UNet attends at 8x8 and 4x4, under the flash threshold)
VQGAN_ARGS = ("--steps", "12", "--warmup-steps", "2")
LDM2D_ARGS = ("--stage1-steps", "6", "--warmup-steps", "2", "--stage2-steps", "6")
# kernel groups of a stage-1 step's profile, matched in this order by name
LDM3D_PROFILE_GROUPS = (
    ("flash_bwd_fused (kernel 4)", ("flash_bwd_fused",)),
    ("flash_bwd_dq (kernel 2)", ("flash_bwd_dq",)),
    ("flash_bwd_dkv (kernel 3)", ("flash_bwd_dkv",)),
    ("flash_fwd (kernel 1)", ("flash_fwd",)),
    ("cuDNN convolutions and cuBLAS products", ("xmma", "cudnn", "conv", "gemm", "Conv",
                                                "cutlass", "sm90", "wgrad", "dgrad")),
    ("GroupNorm forward and backward", ("Moments", "GroupNorm", "group_norm", "FusedParams",
                                        "InternalGradients")),
    ("InstanceNorm (var_mean) and other reductions", ("Welford", "reduce_kernel")),
    ("copies, casts and fills", ("copy", "nchwToNhwc", "nhwcToNchw", "Memcpy", "Memset",
                                 "fill")),
    ("Adam", ("multi_tensor", "adam", "Adam")),
    ("other (SiLU, LeakyReLU, adds, upsampling, losses)", ("",)),
)

# phase 11 (a): the 2D VQ-VAE + transformer MedNIST tutorial config
# (benchmarks/bench_ar_sampling.py:42-56): VQ-VAE (256, 256), 256 codes of 32,
# two stride-2 levels; DecoderOnlyTransformer dim 96, depth 12, 8 heads (head
# width 12: under every kernel width, so its attention stays plain)
AR_TUTORIAL = dict(vq_channels=(256, 256), num_embeddings=256, dim=96, depth=12, heads=8)
# (grid edge, batch, warm-up first) of the cache-rule timings on the
# windowed path (max_seq_len = the grid, as the tutorial) and the cached one
# (max_seq_len = the grid + BOS)
AR_TIMINGS = ((16, 1, True), (16, 16, False), (32, 1, False))
# timed samples a path at each of AR_TIMINGS, the two paths alternating,
# the best of each reported; a sample is host-bound (busy share ~0.1), so
# its host-clock time moves by a quarter with the load on a shared host,
# and the best-of-3 ratio of the two paths at 256 tokens ranged 0.81-1.29x
# over three runs on one card: a tie within that noise, which no host-clock
# margin can gate. The cache rule (resolve_use_cache: the cache whenever
# the sequence fits) is held on the profiles instead: a cached sample must
# take less device time and fewer kernels than a windowed one.
AR_REPEATS = 3
AR_OVERLENGTH = (32, 1, 256)  # grid edge, batch, max_seq_len: JAX forces the windowed path
# phase 11 (b): the recipe at --size 128 (a 32x32 grid, 1024 tokens of head
# width 32, batch 16): kernel 1 four times a stage-2 forward and four times
# in the closing likelihood; kernels 2 and 3 (or 4) four times a backward
AR_RECIPE_STEPS = dict(stage1=3, stage2=5)
AR_RECIPE_ARGS = ("--size", "128", "--stage1-steps", str(AR_RECIPE_STEPS["stage1"]),
                  "--stage2-steps", str(AR_RECIPE_STEPS["stage2"]))
AR_LAUNCHES = {
    "split": dict(flash_fwd=4 * AR_RECIPE_STEPS["stage2"] + 4,
                  flash_bwd_dq=4 * AR_RECIPE_STEPS["stage2"],
                  flash_bwd_dkv=4 * AR_RECIPE_STEPS["stage2"]),
    "fused": dict(flash_fwd=4 * AR_RECIPE_STEPS["stage2"] + 4,
                  flash_bwd_fused=4 * AR_RECIPE_STEPS["stage2"]),
}
AR_GRAD_BATCH = 4
LIKELIHOOD_RTOL = 1e-4  # the kernel path's log-likelihood map, relative to its largest value
# kernel groups of a sample's profile, matched in this order by name
AR_PROFILE_GROUPS = (
    ("flash_fwd (kernel 1)", ("flash_fwd",)),
    ("cuBLAS products", ("gemm", "gemv", "cutlass", "sm90", "xmma", "dot")),
    ("softmax", ("softmax", "Softmax")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("sampling (top-k, Gumbel, argmax)", ("topk", "sort", "exponential", "argmax", "distribution",
                                          "bitonic", "radix")),
    ("copies, casts, fills, masks", ("copy", "Memcpy", "Memset", "fill", "masked", "index")),
    ("other (GELU, adds, embeddings, decode)", ("",)),
)
# phase 12: the SPADE recipes at their defaults for a few steps (their
# attention, 8x8 latent tokens in the UNet, stays plain: no kernel launches)
SPADE_VAE_ARGS = ("--steps", "6", "--sample")
SPADE_LDM_ARGS = ("--stage1-steps", "6", "--warmup-steps", "3", "--stage2-steps", "5", "--sample")
SPADE_RTOL = 1e-4  # one SPADE UNet forward on the card against the CPU, f32
# phase 13: the host data path, checkpoints and the two eval recipes. (a) the
# loader: LOADER_FILES small NIfTI volumes read LOADER_EPOCHS times with
# LOADER_WORKERS workers, in file order every time (and in the seeded shuffle
# order), then BRAIN_VOLUMES volumes at the brain bundle's 160x224x160,
# uncompressed and gzipped, for volumes a second
LOADER_FILES = 64
LOADER_EPOCHS = 20
LOADER_WORKERS = 4
LOADER_SHAPE = (16, 16, 16)
BRAIN_VOLUME = (160, 224, 160)
BRAIN_VOLUMES = 8
THROUGHPUT_EPOCHS = 2
# (b) the 2D recipe at its defaults (f32, UNet (128, 256, 256), 64x64, batch
# 64) from DISK_FILES gzipped NIfTI slices of DISK_EDGE^2, centre-cropped to
# 64, cached and augmented, then serving its checkpoint (c): 150 kernel-1
# launches a DDIM-50 request of SERVE's batch 4
DISK_FILES = 256
DISK_EDGE = 72
DISK_STEPS = 12
DISK_ARGS = ("--steps", str(DISK_STEPS), "--fit", "crop_pad", "--augment", "--cache")
CKPT_SEEDS = (0, 1, 2)
# (d) eval_quality at its defaults (UNet (64, 128, 128) in bf16, 64x64, batch
# 64, 64 samples at batch 32, DDIM-50) with a few train steps: kernels 1-3 at
# (64, 1024, 1024, 128) bf16 in training, kernel 1 at (32, 1024, 1024, 128)
# in sampling, 3 of each a step or forward
EVAL_TRAIN_STEPS = 4
EVAL_QUALITY_ARGS = ("--train-steps", str(EVAL_TRAIN_STEPS))
EVAL_SAMPLE = dict(count=64, batch=32, steps=50)
# the card's metrics against the CPU's on the same features and images. FID
# in f32 from 64 samples of 2048 features: the covariances have rank 63, and
# the eigenvalues of their null spaces are f32 rounding noise that each
# eigh resolves its own way (the CPU's f32 FID sits 6e-4 from its f64 one on
# such features; the card's sits 8.5e-5 from the CPU's on the H100). The
# limit lies a few times above that noise. (d) prints beside it the same FID
# with TF32 matmuls (3.0e-5 from the CPU's on the H100, inside the noise: no
# FID limit tells a TF32 leak, so the phases pin TF32 off themselves);
# MS-SSIM: f32 sums of the same convolutions in another order
FID_RTOL = 2e-3
MSSSIM_ATOL = 1e-5
# (e) eval_brain_ldm at full width: 4 samples with distinct covariates plus
# its default 2 same-covariate pairs, DDIM-50, FID on (a)'s volumes
EVAL_BRAIN_ARGS = ("--sample-count", "4", "--ddim-steps", "50")

# phase 14: export, tracing and the A10 recipes
EXPORT_SEED = 3
# the exports' DDIM steps: the graph unrolls the chain, and tracing it costs
# ~4 ms of host time a graph node (the 2D chain at DDIM-50 took 145-225 s)
EXPORT_DDIM_2D = 10
EXPORT_DDIM_3D = 10
CN_TRAIN_STEPS = (2, 4)  # train_controlnet: UNet pre-training steps, ControlNet steps
CN_TRAIN_ARGS = ("--pretrain-steps", str(CN_TRAIN_STEPS[0]), "--steps", str(CN_TRAIN_STEPS[1]))
CMP_TRAIN_STEPS = 3
CMP_STEP_COUNTS = (10, 25)
CMP_ARGS = ("--train-steps", str(CMP_TRAIN_STEPS), "--step-counts",
            *(str(n) for n in CMP_STEP_COUNTS))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def host_line(native) -> str:
    """What the host offers the data path: the C++ compiler, the headers the
    loader's decoders need, the route each image family takes (the native
    decoder, or PIL where its header is missing; this builds the loader),
    and the optional Python packages (found, not imported)."""
    import importlib.util

    import scipy

    cxx = subprocess.run([native._compiler(), "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()[0]
    headers = ", ".join(f"{h} {'yes' if native.has_header(h) else 'no'}"
                        for h in ("zlib.h", "png.h", "jpeglib.h"))
    packages = ", ".join(f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}"
                         for m in ("yaml", "PIL", "tensorboard"))
    routes = ", ".join(f"{family} {route}" for family, route in native.decoder_routes().items())
    return (f"host: {cxx}; headers: {headers}; image decoders: {routes}; packages: {packages}; "
            f"numpy {np.__version__}, scipy {scipy.__version__}; {os.cpu_count()} cores")


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(flop: float, nbytes: float, dtype_name: str, peak: float | None = None) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate for their type (or `peak`) and the bytes over the memory
    rate."""
    by_ops = flop / (peak or PEAK_FLOPS[dtype_name]) * 1e3
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(by_ops, by_bytes),
                bound_by="operations" if by_ops >= by_bytes else "bytes")


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the mask leaves live: the work this run's data needs."""
    if not causal:
        return sq * sk
    return sum(min(sk, row + 1) for row in range(sq))


def library_attention_ms(torch, q, k, v, scale: float, causal: bool,
                         dout=None) -> tuple[float, str]:
    """A yardstick only, never used by the port: one PyTorch call of the same
    attention, `scaled_dot_product_attention`, timed forward (dout None) or
    backward (dq, dk, dv from an output of the same inputs).

    The (BH, S, D) inputs go in as (BH, 1, S, D) views: SDPA's fused
    backends take only 4-D inputs and would otherwise fall back to its
    unfused math path. One fused backend is pinned, flash for bf16 and
    memory-efficient for f32 (flash takes no f32), so a fallback raises
    instead of being timed. Returns (ms, the backend's name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    backend = (SDPBackend.FLASH_ATTENTION if q.dtype == torch.bfloat16
               else SDPBackend.EFFICIENT_ATTENTION)
    q, k, v = (t.detach().unsqueeze(1) for t in (q, k, v))
    with sdpa_kernel(backend):
        if dout is None:
            return time_ms(lambda: sdpa(q, k, v, scale=scale, is_causal=causal)), backend.name
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = sdpa(q, k, v, scale=scale, is_causal=causal)
        dout = dout.unsqueeze(1)
        ms = time_ms(lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True))
    del out
    return ms, backend.name


def check_kernel(torch, ops) -> dict:
    """Phase 2: each case's kernel output against the plain version; each
    case records its body (`attention_route`) and block height."""
    results = {}
    g = torch.Generator("cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (bh, sq, sk, d), dtype_name, causal in KERNEL_CASES:
        dtype = getattr(torch, dtype_name)

        def rand(n):
            return torch.randn((bh, n, d), generator=g, device="cuda").to(dtype)

        q, k, v = rand(sq), rand(sk), rand(sk)
        scale = d**-0.5
        o, lse = ops.FLASH_FWD(q, k, v, scale=scale, causal=causal)
        o_ref, lse_ref = ops.flash_attention_reference(q, k, v, scale=scale, causal=causal)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        tol, lse_tol = TOLERANCE[dtype_name], LSE_TOLERANCE[dtype_name]
        ms = time_ms(lambda: ops.FLASH_FWD(q, k, v, scale=scale, causal=causal))
        plain_ms = time_ms(
            lambda: ops.flash_attention_reference(q, k, v, scale=scale, causal=causal)
        )
        library_ms, backend = library_attention_ms(torch, q, k, v, scale, causal)
        esize = q.element_size()
        lim = bound(4 * bh * attention_pairs(sq, sk, causal) * d,
                    bh * d * esize * (2 * sq + 2 * sk) + 4 * bh * sq, dtype_name,
                    PEAK_3XTF32 if dtype == torch.float32 else None)
        ok = (err_o <= tol and err_lse <= lse_tol and bool(torch.isfinite(o.float()).all())
              and ms >= lim["bound_ms"])
        route = route_name(ops, dtype, d, False, "flash_fwd")
        rows, splits = forward_block_rows(bh, sq, d, dtype_name, sms)
        blocks = f"{rows}-row blocks" + (f" in clusters of {splits}" if splits > 1 else "")
        log(f"kernel {name}: (BH={bh}, Sq={sq}, Sk={sk}, D={d}) {dtype_name} causal={causal} "
            f"route {route}, {blocks}: "
            f"max|dO|={err_o:.3e} (tol {tol:g}) max|dlse|={err_lse:.3e} (tol {lse_tol:g}) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA ({backend}) {library_ms:.4f} ms, "
            f"bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel case {name} out of tolerance")
        results[name] = dict(max_abs_err=max(err_o, err_lse), ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, body=route, **lim)
        del q, k, v, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    return results


def source_constants(source: str, namespace: str | None = None) -> dict:
    """The `constexpr int kName = <number>;` declarations of a csrc/ source
    (the first of each name), or of the first block of its `namespace`."""
    with open(os.path.join(REPO, CSRC, source)) as f:
        text = f.read()
    if namespace is not None:
        start = text.index(f"namespace {namespace} {{")
        text = text[start:text.index(f"}}  // namespace {namespace}", start)]
    found = {}
    for name, value in re.findall(r"constexpr int (k\w+) = (\d+);", text):
        found.setdefault(name, int(value))
    return found


def dkv_tiles(dtype_name: str, d: int) -> tuple[int, int]:
    """(q rows of a q tile, keys of a block) of kernel 4 (and of kernel 3,
    which shares kernel 4's body) for inputs of `dtype_name` and head width
    `d`, read from the `constexpr int`s of csrc/flash_bwd.cu: on the wgmma
    route at bf16 D = 64 (namespace `wg`) and on the TF32 route at f32 D =
    64 (namespace `tf`) a q tile is `kTile` rows and a block `kConsumers` x
    `kRows` keys; on the wgmma route at bf16 D = 256 (namespace `wd`) a q
    tile is `kDkvTile` rows and a block `kRows` keys, which both consumers
    share; else the mma.sync body's `kBrBf16` or `kBrF32` and `kBcNarrow`
    or `kBcWide`."""
    tiles = source_constants("flash_bwd.cu")
    for namespace, dtype_of in (("wg", "bfloat16"), ("tf", "float32")):
        body = source_constants("flash_bwd.cu", namespace)
        if dtype_name == dtype_of and d == body["kD"]:
            return body["kTile"], body["kConsumers"] * body["kRows"]
    wide = source_constants("flash_bwd.cu", "wd")
    if dtype_name == "bfloat16" and d == wide["kD"]:
        return wide["kDkvTile"], wide["kRows"]
    rows = tiles["kBrBf16"] if dtype_name == "bfloat16" else tiles["kBrF32"]
    return rows, tiles["kBcNarrow"] if d <= tiles["kNarrowD"] else tiles["kBcWide"]


def forward_block_rows(bh: int, sq: int, d: int, dtype_name: str, sms: int) -> tuple[int, int]:
    """Query rows of one block of kernel 1 and the blocks of a cluster that
    share their keys, as its launcher picks them (for the exp2 contracts;
    upcast runs the f32 bodies): on the wgmma routes (bf16 at D = 64 and
    256, csrc/flash_fwd.cu's namespaces `wg` and `wd`) two consumer
    warpgroups of `kRows` unless their blocks leave half of the card's SMs
    or more idle, then one; on the TF32 route (f32 at D = 128 and 256,
    namespace `ts`) `kRows` rows, in clusters of `kSplits` blocks, each
    taking a share of the keys, where one block a row block leaves half of
    the SMs or more idle; on the mma.sync bodies 128 rows at bf16 D = 32 (4
    warps of two 16-row fragments), 64 at bf16 D = 128, 32 in f32."""
    consts = source_constants("flash_fwd.cu")
    rows = consts["kRows"]
    if dtype_name == "bfloat16" and d in (64, 256):
        return (rows if 2 * bh * -(-sq // (2 * rows)) <= sms else 2 * rows), 1
    if dtype_name == "float32" and d in (128, 256):
        return rows, consts["kSplits"] if 2 * bh * -(-sq // rows) <= sms else 1
    if dtype_name == "bfloat16":
        return (128 if d <= 64 else 64), 1
    return 32, 1


def fused_dq_adds(bh: int, sq: int, sk: int, d: int, dtype_name: str, causal: bool) -> int:
    """Kernel 4's ordered dq adds, in pairs of f32 (float2 atomics on the
    mma.sync route; TMA reductions of 32-column boxes on the wgmma route):
    one for each 2 columns of each query row that each key block's q loop
    reaches (under the causal mask the loop starts at the block's first
    key)."""
    keys = dkv_tiles(dtype_name, d)[1]
    rows = sum(sq - min(sq, k0) if causal else sq for k0 in range(0, sk, keys))
    return bh * rows * d // 2


def within_fused_margin(torch, got, want, floor=None) -> bool:
    """`got` within FUSED_DQ_RTOL of max|want| (or of `floor`, where larger)
    of `want`, elementwise, plus one bf16 ulp of each element's value in
    bf16 (the same f32 sums in another order may round to the other side of
    a tie)."""
    a, b = got.float(), want.float()
    margin = FUSED_DQ_RTOL * max(b.abs().max().item(), floor or 0.0)
    if want.dtype == torch.bfloat16:
        margin = margin + torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
    return bool(((a - b).abs() <= margin).all())


def route_name(ops, dtype, d: int, upcast: bool, kernel: str) -> str:
    """The body `kernel` runs for these inputs (`ops.attention_route`)."""
    from generativemodels_tpu_torch.ops.flash_attention import ROUTE_TF32, ROUTE_WGMMA

    route = ops.attention_route(dtype, d, upcast, kernel=kernel)
    return {ROUTE_WGMMA: "wgmma", ROUTE_TF32: "tf32"}.get(route, "mma")


def fused_agree(torch, ops, fused, split, upcast: bool = False,
                floors=(None, None, None)) -> tuple[bool, str]:
    """Kernel 4's dq, dk, dv against kernels 2 + 3's on the same inputs, and
    the rule applied, as a case prints it. dk, dv: equal to the bit where
    kernels 3 and 4 run one body (the same dV and dK products in the same
    order: the mma.sync body `dkv_block`; the wgmma and TF32 bodies' shared
    products and probabilities), else within the fused margin. dq: within
    the fused margin (its parts are summed in another order). Where two
    kernels run different bodies (kernels 2 and 3 on the TF32 ones at f32 D
    = 128 and 256, kernel 4 on mma.sync), the margin is also taken of
    `floors` (`grad_scales`: at Sk = 1 dq and dk cancel to rounding, and two
    bodies' rounding differs), and so is dq's on the TF32 route, where
    kernel 2 computes s and dp query-major and kernel 4 key-major, each
    3xTF32 product summing its lo x hi terms in the other order; where they
    share one, of the largest value alone."""
    dtype, d = split[1].dtype, split[1].shape[-1]
    dq_body, dkv_body, fused_body = (route_name(ops, dtype, d, upcast, kernel) for kernel in
                                     ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"))
    dq_rounds_apart = dq_body != fused_body or fused_body == "tf32"
    ok = within_fused_margin(torch, fused[0], split[0], floors[0] if dq_rounds_apart else None)
    ulp = " + one bf16 ulp" if dtype == torch.bfloat16 else ""
    if dkv_body == fused_body:
        ok = ok and torch.equal(fused[1], split[1]) and torch.equal(fused[2], split[2])
        dkv_rule = "equal to the bit"
    else:
        ok = (ok and within_fused_margin(torch, fused[1], split[1], floors[1])
              and within_fused_margin(torch, fused[2], split[2], floors[2]))
        dkv_rule = f"within {FUSED_DQ_RTOL:g} of max (or the Sk = 1 floor){ulp}"
    dq_size = "max (or the Sk = 1 floor)" if dq_rounds_apart else "max"
    return ok, (f"bodies {dq_body}/{dkv_body}/{fused_body}: dk, dv {dkv_rule}, dq within "
                f"{FUSED_DQ_RTOL:g} of {dq_size}{ulp}")


def check_backward(torch, ops) -> dict:
    """Phase 2, backward: dq of kernel 2, dk, dv of kernel 3 and all three of
    kernel 4 against the plain backward, from the forward kernel's O and log2
    lse; kernel 4 also against kernels 2 + 3 on the same inputs
    (`fused_agree`); kernels 2 and 4
    against themselves: kernel 2's dq rows belong to one block (one
    warpgroup on the wgmma route) and kernel 4's dq parts are added in
    key-block order, so two launches of each must give the same dq (and
    kernel 4 the same dk, dv) to the bit. Each case records the body
    (`attention_route`) of kernels 2-4."""
    from generativemodels_tpu_torch.ops.flash_attention import _backward_rows, _prescaled

    results = {}
    g = torch.Generator("cuda").manual_seed(1)
    for name, (bh, sq, sk, d), dtype_name, causal in BACKWARD_CASES:
        dtype = getattr(torch, dtype_name)

        def rand(n):
            return torch.randn((bh, n, d), generator=g, device="cuda").to(dtype)

        q, k, v, dout = rand(sq), rand(sk), rand(sk), rand(sq)
        scale = d**-0.5
        out, lse2 = ops.FLASH_FWD(q, k, v, scale=scale, causal=causal, log2_lse=True)
        qp = _prescaled(q, scale)
        do2, delta = _backward_rows(out, dout)

        def dq_kernel():
            return ops.FLASH_BWD_DQ(qp, k, v, do2, lse2, delta, causal=causal)

        def dkv_kernel():
            return ops.FLASH_BWD_DKV(qp, k, v, do2, lse2, delta, causal=causal)

        def fused_kernel():
            return ops.FLASH_BWD_FUSED(qp, k, v, do2, lse2, delta, causal=causal)

        def plain():
            if sq * sk <= PLAIN_BACKWARD_MAX:
                return ops.flash_attention_backward_reference(
                    qp, k, v, out, lse2, dout, causal=causal)
            heads = [ops.flash_attention_backward_reference(
                qp[i:i + 1], k[i:i + 1], v[i:i + 1], out[i:i + 1], lse2[i:i + 1],
                dout[i:i + 1], causal=causal) for i in range(bh)]
            return tuple(torch.cat(parts) for parts in zip(*heads))

        got = (dq_kernel(), *dkv_kernel())
        dq_again, dkv_again = dq_kernel(), dkv_kernel()
        fused, fused_again = fused_kernel(), fused_kernel()
        want = plain()
        torch.cuda.synchronize()
        abs_err, rel_err, fused_abs, fused_rel = {}, {}, {}, {}
        for label, a, f, b in zip(("dq", "dk", "dv"), got, fused, want):
            ref = b.float().abs().max().item()
            abs_err[label] = (a.float() - b.float()).abs().max().item()
            rel_err[label] = abs_err[label] / ref
            fused_abs[label] = (f.float() - b.float()).abs().max().item()
            fused_rel[label] = fused_abs[label] / ref
        # kernel 4 against kernels 2 + 3
        bodies = {kernel: route_name(ops, dtype, d, False, kernel)
                  for kernel in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")}
        agree, rule = fused_agree(torch, ops, fused, got)
        dq_f, dq_s = fused[0].float(), got[0].float()
        dq_vs_split = ((dq_f - dq_s).abs().max() / dq_s.abs().max()).item()
        # the dq elements of kernel 4 that differ from kernel 2's, printed:
        # they differ in the order of their f32 sums over the keys only
        dq_differ = int((fused[0] != got[0]).sum().item())
        spread = (fused_again[0].float() - dq_f).abs().max().item()
        spread_count = sum(int((a != b).sum().item()) for a, b in zip(fused_again, fused))
        dq_spread_count = int((dq_again != got[0]).sum().item())
        dkv_spread_count = sum(int((a != b).sum().item()) for a, b in zip(dkv_again, got[1:]))
        del got, want, fused, fused_again, dq_again, dkv_again, dq_f, dq_s
        torch.cuda.empty_cache()
        ms_dq, ms_dkv, plain_ms = time_ms(dq_kernel), time_ms(dkv_kernel), time_ms(plain)
        ms_fused = time_ms(fused_kernel)
        # SDPA's backward computes all of dq, dk, dv: the yardstick of both rows
        library_ms, backend = library_attention_ms(torch, q, k, v, scale, causal, dout=dout)
        pairs, esize = attention_pairs(sq, sk, causal), q.element_size()
        rows = 8 * bh * sq  # lse2 and delta, f32
        tensor_f32 = PEAK_3XTF32 if dtype == torch.float32 else None  # kernels 2, 3 and 4
        lim_dq = bound(6 * bh * pairs * d, bh * d * esize * (3 * sq + 2 * sk) + rows, dtype_name,
                       tensor_f32)
        lim_dkv = bound(8 * bh * pairs * d, bh * d * esize * (2 * sq + 4 * sk) + rows,
                        dtype_name, tensor_f32)
        lim_fused = bound(10 * bh * pairs * d, bh * d * esize * (3 * sq + 4 * sk) + rows,
                          dtype_name, tensor_f32)
        tol = BACKWARD_TOLERANCE[dtype_name]
        ok = (all(e <= tol for e in rel_err.values()) and dq_spread_count == 0
              and dkv_spread_count == 0)
        pair_bound = lim_dq["bound_ms"] + lim_dkv["bound_ms"]
        fused_ok = all(e <= tol for e in fused_rel.values()) and agree and spread_count == 0
        log(f"backward {name}: (BH={bh}, Sq={sq}, Sk={sk}, D={d}) {dtype_name} causal={causal} "
            + " ".join(f"max|d{x[1:]}|/max={rel_err[x]:.3e}" for x in ("dq", "dk", "dv"))
            + f" tol={tol:g}; two launches differ in {dq_spread_count} dq and "
            f"{dkv_spread_count} dk, dv elements (must be 0); dq kernel {ms_dq:.4f} ms (bound "
            f"{lim_dq['bound_ms']:.4f}, {lim_dq['bound_ms'] / ms_dq:.1%} of it), dkv kernel "
            f"{ms_dkv:.4f} ms (bound {lim_dkv['bound_ms']:.4f}, "
            f"{lim_dkv['bound_ms'] / ms_dkv:.1%}) (sum {ms_dq + ms_dkv:.4f}, bound "
            f"{pair_bound:.4f}, {pair_bound / (ms_dq + ms_dkv):.1%}), plain backward "
            f"{plain_ms:.4f} ms, SDPA ({backend}) backward {library_ms:.4f} ms -> "
            f"{'ok' if ok else 'FAIL'}")
        log(f"fused backward {name}: "
            + " ".join(f"max|d{x[1:]}|/max={fused_rel[x]:.3e}" for x in ("dq", "dk", "dv"))
            + f" tol={tol:g}; against kernels 2 + 3 ({rule}): {agree}, "
            f"max|ddq|/max|dq| {dq_vs_split:.3e}, {dq_differ} dq elements differ; "
            f"two launches: max|ddq| {spread:.3e}, {spread_count} elements of dq, dk, dv "
            f"differ (must be 0); "
            f"{fused_dq_adds(bh, sq, sk, d, dtype_name, causal):.4e} ordered dq pair adds; "
            f"fused kernel "
            f"{ms_fused:.4f} ms (bound {lim_fused['bound_ms']:.4f} ms, {lim_fused['bound_by']}) "
            f"against kernels 2 + 3 {ms_dq + ms_dkv:.4f} ms -> {'ok' if fused_ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"backward case {name} out of tolerance")
        if not fused_ok:
            raise AssertionError(f"fused backward case {name} out of tolerance")
        results[name] = dict(
            dq=dict(max_abs_err=abs_err["dq"], ms=ms_dq, plain_ms=plain_ms,
                    library_ms=library_ms, body=bodies["flash_bwd_dq"], **lim_dq),
            dkv=dict(max_abs_err=max(abs_err["dk"], abs_err["dv"]), ms=ms_dkv, plain_ms=plain_ms,
                     library_ms=library_ms, body=bodies["flash_bwd_dkv"], **lim_dkv),
            fused=dict(max_abs_err=max(fused_abs.values()), ms=ms_fused, plain_ms=plain_ms,
                       library_ms=library_ms, body=bodies["flash_bwd_fused"], **lim_fused),
        )
        del q, k, v, dout, out, lse2, qp, do2, delta
        torch.cuda.empty_cache()
    return results


def plain_by_heads(torch, fn, q, k, *args, **kwargs):
    """`fn` over all heads at once, or head by head where one head's (Sq, Sk)
    f32 matrix passes PLAIN_BACKWARD_MAX elements (the 3D shape); every
    tensor argument is split along its first axis."""
    bh, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    if sq * sk <= PLAIN_BACKWARD_MAX:
        return fn(q, k, *args, **kwargs)
    heads = [fn(q[i:i + 1], k[i:i + 1], *(a[i:i + 1] for a in args), **kwargs)
             for i in range(bh)]
    return tuple(torch.cat(parts) for parts in zip(*heads))


def library_contract_ms(torch, upcast: bool, q, k, v, scale, causal, dout=None):
    """SDPA's time for a contract, one backend pinned as `library_attention_ms`
    pins it: under upcast on f32 copies of the inputs (memory-efficient)."""
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
        dout = None if dout is None else dout.float()
    return library_attention_ms(torch, q, k, v, scale, causal, dout=dout)


def grad_scales(torch, q_in, k, v, dout, upcast: bool, scale: float) -> tuple:
    """The sizes the contract checks hold dq, dk, dv to: each gradient's
    largest plain value, except that at Sk = 1 a row's softmax over its one
    key is 1, so ds = p (dp - delta) cancels to rounding and dq, dk are 0 in
    exact arithmetic; both are then held at the size of the cancelling
    terms, max|dO| max|v| max|k| (max|q| for dk) in row norms, times the
    scale under upcast, and only dv keeps its own size."""
    if k.shape[1] != 1:
        return None, None, None

    def rows(t):
        return t.float().norm(dim=-1).max().item()

    terms = rows(dout) * rows(v) * (scale if upcast else 1.0)
    return terms * rows(k), terms * rows(q_in), None


def grad_error(a, b, floor) -> float:
    """max|a - b| / max(max|b|, floor)."""
    ref = b.float().abs().max().item()
    return (a.to(b.dtype).float() - b.float()).abs().max().item() / max(ref, floor or 0.0)


def check_contracts(torch, ops) -> dict:
    """Phase 2 (d): kernels 1-4 under the JAX kernel's other two contracts
    (CONTRACTS) against their plain versions at CONTRACT_CASES, and at
    ROUTE_CASES under those and the default contract (CONTRACT_RUNS): O and
    the lse of kernel 1 against `flash_attention_reference`, dq, dk, dv of
    kernels 2 + 3 and of kernel 4 against `flash_attention_backward_reference`
    (from the kernel's O and lse, fed as the `flash_fwd` op's gradient feeds
    them), with kernel 4's dq, dk, dv against kernels 2 + 3's by
    `fused_agree`, and two launches of kernels 2 and 3, and of kernel 4,
    equal to the bit. The timed cases print each kernel's time beside the
    plain version's, the bound and SDPA's."""
    from generativemodels_tpu_torch.ops.flash_attention import _backward_rows, _prescaled

    results = {}
    g = torch.Generator("cuda").manual_seed(21)
    for contract, (upcast, no_max), cases in CONTRACT_RUNS:
        kw = dict(upcast=upcast, no_max=no_max)
        for name, (bh, sq, sk, d), dtype_name, causal, timed in cases:
            dtype = getattr(torch, dtype_name)

            def rand(n):
                return torch.randn((bh, n, d), generator=g, device="cuda").to(dtype)

            q, k, v, dout = rand(sq), rand(sk), rand(sk), rand(sq)
            scale = d**-0.5

            def fwd():
                return ops.FLASH_FWD(q, k, v, scale=scale, causal=causal, **kw)

            def plain_fwd():
                return plain_by_heads(torch, lambda *a: ops.flash_attention_reference(
                    *a, scale=scale, causal=causal, **kw), q, k, v)

            o, lse = fwd()
            o_ref, lse_ref = plain_fwd()
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            lse_scale = max(1.0, lse_ref.abs().max().item())
            del o_ref, lse_ref
            # the backward's inputs as the flash_fwd op's gradient hands them on
            out, lse_b = ops.FLASH_FWD(q, k, v, scale=scale, causal=causal, log2_lse=not upcast,
                                       **kw)
            q_in = q if upcast else _prescaled(q, scale)
            bkw = dict(causal=causal, scale=scale, **kw)
            do_k, delta = _backward_rows(out, dout, upcast)
            if upcast:
                kq, kk, kv, do_k = q_in.float(), k.float(), v.float(), do_k.float()
            else:
                kq, kk, kv = q_in, k, v

            def split():
                return (ops.FLASH_BWD_DQ(kq, kk, kv, do_k, lse_b, delta, **bkw),
                        *ops.FLASH_BWD_DKV(kq, kk, kv, do_k, lse_b, delta, **bkw))

            def fused():
                return ops.FLASH_BWD_FUSED(kq, kk, kv, do_k, lse_b, delta, **bkw)

            def plain_bwd():
                return plain_by_heads(torch, lambda *a: ops.flash_attention_backward_reference(
                    *a, **bkw), q_in, k, v, out, lse_b, dout)

            got_s, again_s, got_f, again_f = split(), split(), fused(), fused()
            want = plain_bwd()
            torch.cuda.synchronize()
            same_bits = all(torch.equal(a, b) for a, b in zip(got_s, again_s))
            same_fused = all(torch.equal(a, b) for a, b in zip(got_f, again_f))
            del again_s, again_f
            floors = grad_scales(torch, q_in, k, v, dout, upcast, scale)
            rel_s = max(grad_error(a, b, f) for a, b, f in zip(got_s, want, floors))
            rel_f = max(grad_error(a, b, f) for a, b, f in zip(got_f, want, floors))
            abs_s = max((a.to(b.dtype).float() - b.float()).abs().max().item()
                        for a, b in zip(got_s, want))
            abs_f = max((a.to(b.dtype).float() - b.float()).abs().max().item()
                        for a, b in zip(got_f, want))
            agree, rule = fused_agree(torch, ops, got_f, got_s, upcast, floors)
            finite = all(bool(torch.isfinite(t.float()).all()) for t in (o, *got_s, *got_f))
            del got_s, got_f, want
            tol, lse_tol = TOLERANCE[dtype_name], LSE_TOLERANCE[dtype_name]
            btol = BACKWARD_TOLERANCE[dtype_name]
            ok = (finite and err_o <= tol and err_lse <= lse_tol * lse_scale and rel_s <= btol
                  and rel_f <= btol and agree and same_bits and same_fused)
            label = (f"contract {contract} {name}: (BH={bh}, Sq={sq}, Sk={sk}, D={d}) "
                     f"{dtype_name} causal={causal}")
            log(f"{label}: kernel 1 max|dO|={err_o:.3e} (tol {tol:g}) max|dlse|={err_lse:.3e} "
                f"(tol {lse_tol:g} x {lse_scale:.2f}); kernels 2 + 3 max|dgrad|/max "
                f"{rel_s:.3e}, kernel 4 {rel_f:.3e} (tol {btol:g}); kernel 4 against kernels "
                f"2 + 3 ({rule}): {agree}; kernels 2 + 3 twice equal to the bit: {same_bits}, "
                f"kernel 4: {same_fused} (kernel 1's body "
                f"{route_name(ops, dtype, d, upcast, 'flash_fwd')}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{label}: out of tolerance")
            if timed:
                pairs, esize = attention_pairs(sq, sk, causal), q.element_size()
                # f32 products run as 3xTF32: the f32 route, also under upcast
                f32_route = upcast or dtype == torch.float32
                peak = PEAK_3XTF32 if f32_route else None
                peak_type = "float32" if f32_route else dtype_name
                rows = 8 * bh * sq
                lims = dict(
                    fwd=bound(4 * bh * pairs * d, bh * d * esize * (2 * sq + 2 * sk) + 4 * bh * sq,
                              peak_type, peak),
                    dq=bound(6 * bh * pairs * d, bh * d * esize * (3 * sq + 2 * sk) + rows,
                             peak_type, peak),
                    dkv=bound(8 * bh * pairs * d, bh * d * esize * (2 * sq + 4 * sk) + rows,
                              peak_type, peak),
                    fused=bound(10 * bh * pairs * d, bh * d * esize * (3 * sq + 4 * sk) + rows,
                                peak_type, peak),
                )
                ms = dict(fwd=time_ms(fwd),
                          dq=time_ms(lambda: ops.FLASH_BWD_DQ(kq, kk, kv, do_k, lse_b, delta,
                                                              **bkw)),
                          dkv=time_ms(lambda: ops.FLASH_BWD_DKV(kq, kk, kv, do_k, lse_b, delta,
                                                                **bkw)),
                          fused=time_ms(fused))
                plain_ms = dict(fwd=time_ms(plain_fwd, iters=5), bwd=time_ms(plain_bwd, iters=5))
                lib_fwd, backend = library_contract_ms(torch, upcast, q, k, v, scale, causal)
                lib_bwd, _ = library_contract_ms(torch, upcast, q, k, v, scale, causal,
                                                 dout=dout)
                log(f"{label}: kernel 1 {ms['fwd']:.4f} ms (bound {lims['fwd']['bound_ms']:.4f}, "
                    f"{lims['fwd']['bound_by']}; plain {plain_ms['fwd']:.4f}; SDPA ({backend}) "
                    f"{lib_fwd:.4f}); kernel 2 {ms['dq']:.4f} ms (bound "
                    f"{lims['dq']['bound_ms']:.4f}), kernel 3 {ms['dkv']:.4f} ms (bound "
                    f"{lims['dkv']['bound_ms']:.4f}), kernel 4 {ms['fused']:.4f} ms (bound "
                    f"{lims['fused']['bound_ms']:.4f}); plain backward {plain_ms['bwd']:.4f} ms, "
                    f"SDPA ({backend}) backward {lib_bwd:.4f} ms")
                errs = dict(fwd=max(err_o, err_lse), dq=abs_s, dkv=abs_s, fused=abs_f)
                results[contract, name, dtype_name] = {
                    part: dict(max_abs_err=errs[part], ms=ms[part],
                               plain_ms=plain_ms["fwd" if part == "fwd" else "bwd"],
                               library_ms=lib_fwd if part == "fwd" else lib_bwd, **lims[part])
                    for part in ("fwd", "dq", "dkv", "fused")
                }
            del q, k, v, dout, o, lse, out, lse_b, q_in, kq, kk, kv, do_k, delta
            torch.cuda.empty_cache()
    return results


def contract_numbers(contracts: dict) -> dict:
    """The kernels line's `contracts` entry of kernels 1-4 (CONTRACT_MAIN)."""
    parts = dict(flash_fwd="fwd", flash_bwd_dq="dq", flash_bwd_dkv="dkv", flash_bwd_fused="fused")
    return {
        kernel: {contract: dict(shape=f"{name} {dtype_name}",
                                **contracts[contract, name, dtype_name][parts[kernel]])
                 for contract in CONTRACTS}
        for kernel, (name, dtype_name) in CONTRACT_MAIN.items()
    }


def measure_threshold(torch, ops) -> None:
    """Phase 2: kernel 1 against the plain attention path, both through
    `dot_product_attention` on packed (B, S, heads * D) inputs, at the
    sequence lengths around the flash threshold. Measured, not acted on:
    `_FLASH_MIN_SEQ` keeps the JAX rule's 1024."""
    g = torch.Generator("cuda").manual_seed(5)
    for b, heads, d, dtype_name in THRESHOLD_CASES:
        dtype = getattr(torch, dtype_name)
        for seq in THRESHOLD_SEQS:
            q, k, v = (torch.randn((b, seq, heads * d), generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            with torch.inference_mode():
                flash_ms = time_ms(lambda: ops.dot_product_attention(q, k, v, heads,
                                                                     use_flash=True))
                plain_ms = time_ms(lambda: ops.dot_product_attention(q, k, v, heads,
                                                                     use_flash=False))
            log(f"threshold: seq {seq}, (B={b}, heads={heads}, D={d}) {dtype_name}: flash "
                f"{flash_ms:.4f} ms, plain path {plain_ms:.4f} ms ({plain_ms / flash_ms:.2f}x)")


def check_fused_conv(torch, ops) -> dict:
    """Phase 2, kernel 5: the fused GroupNorm-SiLU-conv3d kernel against
    `fused_norm_silu_conv3d_reference`, with x, the residual and the output
    channels-first seen as NDHWC, as the UNet's fused route hands them over.
    Two launches must agree to the bit. The yardstick is F.conv3d alone on
    the same x and kernel: it computes neither the normalisation nor the
    SiLU nor the epilogue. Prints the sums over one 3D forward's 22
    launches (FUSED_FORWARD_LAUNCHES)."""
    import torch.nn.functional as F

    results = {}
    g = torch.Generator("cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (b, d, h, w), cin, cout, residual, dtype_name in FUSED_CASES + BRAIN_FUSED_CASES:
        dtype = getattr(torch, dtype_name)

        def rand(*shape, mul=1.0):
            return mul * torch.randn(shape, generator=g, device="cuda")

        x_cf = rand(b, cin, d, h, w).to(dtype)
        x = x_cf.permute(0, 2, 3, 4, 1)
        kernel = rand(3, 3, 3, cin, cout, mul=(27 * cin) ** -0.5).to(dtype)
        groups = 8 if cin % 32 else 32
        scale, shift = ops.fold_groupnorm_affine(x, 1.0 + rand(cin, mul=0.1),
                                                 rand(cin, mul=0.1), groups)
        bias = rand(cout, mul=0.1)
        res = rand(b, cout, d, h, w).to(dtype).permute(0, 2, 3, 4, 1) if residual else None

        def run_kernel():
            return ops.FUSED_CONV(x, kernel, scale, shift, bias, res)

        def run_plain():
            return ops.fused_norm_silu_conv3d_reference(x, kernel, scale, shift, bias, res)

        got, again, want = run_kernel(), run_kernel(), run_plain()
        torch.cuda.synchronize()
        ref_max = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got.float()).all())
        differ = int((got != again).sum().item())
        del got, again, want
        ms, plain_ms = time_ms(run_kernel), time_ms(run_plain)
        w_oidhw = kernel.permute(4, 3, 0, 1, 2).contiguous()
        library_ms = time_ms(lambda: F.conv3d(x_cf, w_oidhw, bias.to(dtype), padding=1))
        voxels = b * d * h * w
        esize = x.element_size()
        nbytes = (voxels * (cin + cout * (2 if residual else 1)) * esize
                  + kernel.numel() * esize + 4 * (2 * b * cin + cout))
        lim = bound(2 * voxels * 27 * cin * cout, nbytes, dtype_name)
        tol = FUSED_TOLERANCE[dtype_name]
        ok = finite and err <= tol * ref_max and differ == 0
        tile = ""
        if dtype_name == "bfloat16":
            bn, rd, grid = ops.fused_conv.conv_tiles(b, d, h, w, cout, sms)
            tile = f" BN {bn}, R {rd}, grid {grid};"
        log(f"fused_conv {name}: (B={b}, D={d}, H={h}, W={w}) {cin}->{cout}"
            f"{' +residual' if residual else ''} {dtype_name}{tile} max|diff|={err:.3e} "
            f"(max|ref| {ref_max:.3e}, tol {tol:g} of it), {differ} elements differ over two "
            f"launches; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, F.conv3d alone {library_ms:.4f} ms, bound "
            f"{lim['bound_ms']:.4f} ms ({lim['bound_by']}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_conv case {name} out of tolerance or not deterministic")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             **lim)
        del x_cf, x, res
        torch.cuda.empty_cache()
    for what, weights in (("3D", FUSED_FORWARD_LAUNCHES), ("brain LDM", BRAIN_FUSED_LAUNCHES)):
        sums = {key: sum(results[name][key] * n for name, n in weights.items())
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"fused_conv over one {what} forward ({sum(weights.values())} launches): kernel "
            f"{sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, F.conv3d alone "
            f"{sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms")
    return results


def randomize(torch, model, seed: int = 1234) -> None:
    """Fill every parameter from a seeded generator: a fresh UNet returns
    exactly 0 (zero-initialised out conv), which would make the checks empty.

    Weights are drawn at 1/sqrt(fan_in), and the attention's to_q and to_k
    at half that. At full scale the random DDIM chain drives natural
    attention logits to ~68, past the kernel contract's clamp (log2 score 80,
    natural ~55), where the clamped softmax departs from the exact one by
    design; at half scale they stay inside it, as in a trained model."""
    g = torch.Generator("cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.ndim >= 2:
                r = r / p[0].numel() ** 0.5
                if name.endswith(("to_q.weight", "to_k.weight")):
                    r = 0.5 * r
            elif name.endswith("weight"):  # GroupNorm scale
                r = 1.0 + 0.1 * r
            else:
                r = 0.1 * r
            p.copy_(r)


# loopback only: never route the requests through a proxy from the environment
_http = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def post_sample(port: int, seed: int, n: int) -> np.ndarray:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sample", data=json.dumps({"n": n, "seed": seed}).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with _http.open(req, timeout=600) as resp:
        body = json.loads(resp.read())
    return np.load(io.BytesIO(base64.b64decode(body["data_b64"])))


def chain_step_diff(scheduler, model_a, model_b, noise) -> float:
    """Run model_a's DDIM chain; at every step also step model_b from the
    same x_t. Returns the largest difference of the two steps' outputs."""
    x, worst = noise, 0.0
    for t in scheduler.timesteps:
        tt = t.expand(x.shape[0])
        xa, _ = scheduler.step(model_a(x, tt), t, x)
        xb, _ = scheduler.step(model_b(x, tt), t, x)
        worst = max(worst, (xa - xb).abs().max().item())
        x = xa
    return worst


def run_slice(torch, ops, serve, nets) -> dict:
    """Phase 3: the serving path over HTTP, then kernel path vs plain path."""
    t0 = time.perf_counter()
    sampler, shape = serve.build_sampler(device=DEVICE, **SERVE)
    randomize(torch, sampler.model)
    log(f"slice: built sampler {shape} DDIM-{SERVE['ddim_steps']} in "
        f"{time.perf_counter() - t0:.2f} s")

    state = serve._SamplerState(sampler, shape)
    httpd = serve.start_server(state, port=0)
    try:
        with _http.open(f"http://127.0.0.1:{httpd.server_port}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        log(f"slice: /healthz -> {health}")
        if health["status"] != "ok" or health["shape"] != list(shape):
            raise AssertionError(f"bad /healthz answer {health}")

        ops.FLASH_FWD.launches = 0
        images, seconds = [], []
        for seed in SEEDS:
            t0 = time.perf_counter()
            images.append(post_sample(httpd.server_port, seed, shape[0]))
            seconds.append(time.perf_counter() - t0)
        launches = ops.FLASH_FWD.launches
    finally:
        httpd.shutdown()
        httpd.server_close()

    for seed, img, s in zip(SEEDS, images, seconds):
        log(f"slice: POST /sample seed={seed} -> {img.shape} {img.dtype} in {s:.3f} s "
            f"(range {img.min():.4f} .. {img.max():.4f})")
    expected = LAUNCHES_PER_FORWARD * SERVE["ddim_steps"] * len(SEEDS)
    log(f"slice: flash_fwd launches over {len(SEEDS)} DDIM-{SERVE['ddim_steps']} batches: "
        f"{launches} (expected {expected}, {LAUNCHES_PER_FORWARD * SERVE['ddim_steps']} a batch)")
    for img in images:
        if img.shape != shape or not np.isfinite(img).all():
            raise AssertionError(f"bad image batch: shape {img.shape}, finite {np.isfinite(img).all()}")
    if not np.array_equal(images[0], images[2]):
        raise AssertionError("seed 0 gave different images on two requests")
    if np.array_equal(images[0], images[1]):
        raise AssertionError("seeds 0 and 1 gave identical images")
    if launches != expected:
        raise AssertionError(f"flash_fwd launched {launches} times, expected {expected}")

    # the same weights on the plain attention path
    plain = nets.DiffusionModelUNet(
        spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
        num_channels=SERVE["channels"], attention_levels=(False, True, True),
        num_head_channels=SERVE["channels"][-1], norm_num_groups=SERVE["norm_groups"],
        use_flash_attention=False,
    )
    plain.load_state_dict(sampler.model.state_dict(), strict=True)
    plain = plain.to(DEVICE).eval()
    g = torch.Generator(DEVICE).manual_seed(7)
    x = torch.randn(shape, generator=g, device=DEVICE)
    t = torch.tensor([999, 500, 250, 10], device=DEVICE)
    with torch.inference_mode():
        a, b = sampler.model(x, t), plain(x, t)
        fwd_rel = ((a - b).abs().max() / b.abs().max()).item()
        noise = torch.randn(shape, generator=g, device=DEVICE)
        step_abs = chain_step_diff(sampler.inferer.scheduler, sampler.model, plain, noise)
        chain_plain = sampler.inferer.sample(noise, plain)
        free_abs = (sampler.inferer.sample(noise, sampler.model) - chain_plain).abs().max().item()
        # the plain path against itself from noise moved by 1e-6: how far the
        # chain itself spreads a difference of the forward's size
        nudged = noise + 1e-6 * torch.randn(shape, generator=g, device=DEVICE)
        spread_abs = (sampler.inferer.sample(nudged, plain) - chain_plain).abs().max().item()
    log(f"slice: kernel path vs plain path, one UNet forward: max|diff|/max|out| = "
        f"{fwd_rel:.3e} (tol {FORWARD_RTOL:g})")
    log(f"slice: kernel path vs plain path, every step of a DDIM-{SERVE['ddim_steps']} chain "
        f"from the same x_t: max|diff| = {step_abs:.3e} (tol {CHAIN_ATOL:g})")
    log(f"slice: kernel path vs plain path, two free-running DDIM-{SERVE['ddim_steps']} chains: "
        f"max|diff| = {free_abs:.3e}; plain path from noise moved by 1e-6: max|diff| = "
        f"{spread_abs:.3e} (not checked: it measures how the random-weight chain spreads "
        f"small differences, not the kernel)")
    if not fwd_rel <= FORWARD_RTOL:
        raise AssertionError("UNet forward: kernel path disagrees with the plain path")
    if not step_abs <= CHAIN_ATOL:
        raise AssertionError("DDIM chain: kernel path disagrees with the plain path")
    return dict(launches=launches, seconds_per_request=seconds)


def reset_launches(ops) -> None:
    for launcher, _, _ in KERNELS.values():
        getattr(ops, launcher).launches = 0


def read_launches(ops) -> dict:
    return {name: getattr(ops, launcher).launches for name, (launcher, _, _) in KERNELS.items()}


def expected_launches(steps: int = 1, **per_step) -> dict:
    """Launch counts of every kernel in KERNELS: `per_step` times `steps`, 0 for the rest."""
    return {name: per_step.get(name, 0) * steps for name in KERNELS}


def check_launches(counts: dict, expected: dict, what: str) -> None:
    log(f"train: {what}: launches {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"{what}: kernel launches {counts}, expected {expected}")


def train_recipe(torch, ops, recipe) -> dict:
    """Phase 4 (a): the recipe's main at its defaults for TRAIN_STEPS steps.
    Its attention runs at (64, 1024, 1024, 256) f32: kernels 1, 2 and 3 on
    their TF32 bodies streamed over D."""
    reset_launches(ops)
    t0 = time.perf_counter()
    out = recipe.main(["--steps", str(TRAIN_STEPS), "--device", DEVICE])
    seconds = time.perf_counter() - t0
    counts = read_launches(ops)
    losses, sps = out["losses"], out["steps_per_sec"]
    log(f"train: recipe main, defaults (f32, UNet (128, 256, 256), 64x64, batch 64, lr 2.5e-5), "
        f"{TRAIN_STEPS} steps in {seconds:.2f} s (first steps include cuDNN set-up); "
        f"{sps:.3f} steps/s over steps 3-{TRAIN_STEPS}; losses "
        + ", ".join(f"{x:.5f}" for x in losses))
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"recipe losses not finite: {losses}")
    # 2D: no kernel 5, and the split backward (GMTPU_FLASH_FUSED_BWD unset)
    check_launches(counts, expected_launches(TRAIN_STEPS, flash_fwd=3, flash_bwd_dq=3,
                                             flash_bwd_dkv=3), "recipe main")
    log("train: recipe main bodies (its 256-wide heads in f32): " + ", ".join(
        f"{kernel} {route_name(ops, torch.float32, 256, False, kernel)}"
        for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")))
    return dict(launches=counts, steps_per_sec=sps)


def train_bench(torch, ops, nets, parallel, schedulers, steps: int = TRAIN_STEPS,
                flag: str = "0") -> dict:
    """Phase 4 (b): bench.py's config (bf16 compute, batch 128) through
    make_diffusion_train_step with GMTPU_FLASH_FUSED_BWD `flag`; returns the
    launches (counted from 0 over its `steps` steps), steps/s over the steps
    after two and the losses. Its attention runs at (128, 1024, 1024, 256)
    bf16: kernels 1, 2 and 3, or 1 and 4 under the flag, on their D = 256
    wgmma bodies."""
    fused = flag == "1"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = nets.DiffusionModelUNet(
            spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=BENCH["channels"], attention_levels=(False, True, True),
            num_head_channels=BENCH["channels"][-1], dtype=torch.bfloat16,
        )
    model = model.to(DEVICE).train()
    step = parallel.make_diffusion_train_step(
        schedulers.DDPMScheduler(num_train_timesteps=1000, device=DEVICE)
    )
    state = parallel.init_train_state(model, torch.optim.Adam(model.parameters(), lr=BENCH["lr"]))
    g = torch.Generator(DEVICE).manual_seed(2)
    images = torch.rand((BENCH["batch"], 1, BENCH["size"], BENCH["size"]), generator=g,
                        device=DEVICE)
    reset_launches(ops)
    losses = []
    with fused_backward(flag):
        for i in range(steps):
            state, loss = step(state, images, g)
            losses.append(loss)
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
    sps = (steps - 2) / (time.perf_counter() - t0)
    counts = read_launches(ops)
    losses = [float(x) for x in losses]
    what = "bench config" + (" (fused backward)" if fused else "")
    log(f"train: bench.py config (bf16 compute, batch {BENCH['batch']}, 64x64) through "
        f"make_diffusion_train_step{' under GMTPU_FLASH_FUSED_BWD=1' if fused else ''}: "
        f"{sps:.3f} steps/s over steps 3-{steps}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
        + ", ".join(f"{x:.5f}" for x in losses))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what} losses not finite: {losses}")
    backward = dict(flash_bwd_fused=3) if fused else dict(flash_bwd_dq=3, flash_bwd_dkv=3)
    check_launches(counts, expected_launches(steps, flash_fwd=3, **backward), what)
    log(f"train: {what} bodies: " + ", ".join(
        f"{kernel} {route_name(ops, torch.bfloat16, BENCH['channels'][-1], False, kernel)}"
        for kernel in ("flash_fwd", *backward)))
    del state, model
    torch.cuda.empty_cache()
    return dict(launches=counts, steps_per_sec=sps, losses=losses)


def train_bench_fused(torch, ops, nets, parallel, schedulers, split: dict) -> dict:
    """Phase 4 (b), again: bench.py's config for BENCH_FUSED_STEPS steps under
    GMTPU_FLASH_FUSED_BWD=1 (kernel 4 on its D = 256 wgmma body, 3 launches a
    step, no kernel 2 or 3), from the same weights, images and draws as the
    split run; each step's loss within the bf16 backward tolerance (relative)
    of the split run's (the first step's forward is the same; the updates
    differ in the order of dq's f32 sums)."""
    fused = train_bench(torch, ops, nets, parallel, schedulers, BENCH_FUSED_STEPS, "1")
    pairs = list(zip(fused["losses"], split["losses"]))
    rel = max(abs(a - b) / abs(b) for a, b in pairs)
    tol = BACKWARD_TOLERANCE["bfloat16"]
    log(f"train: bench config, fused against split backward over {len(pairs)} steps: losses "
        + ", ".join(f"{a:.5f} / {b:.5f}" for a, b in pairs)
        + f"; max relative difference {rel:.3e} (tol {tol:g}) -> {'ok' if rel <= tol else 'FAIL'}")
    if rel > tol:
        raise AssertionError("bench config: the fused backward's losses depart from the split's")
    return fused


def max_grad_diff(got: dict, want: dict) -> tuple[float, str]:
    """The worst max|diff| / max|grad| over the parameters and its name. Each
    parameter's largest gradient is taken no smaller than 1e-3 of the
    model's largest: the to_k biases' gradient is zero in exact arithmetic
    (softmax ignores a shift shared by all keys)."""
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    worst, worst_name = 0.0, ""
    for n, w in want.items():
        rel = (got[n].float() - w.float()).abs().max().item() / max(w.abs().max().item(), floor)
        if rel > worst:
            worst, worst_name = rel, n
    return worst, worst_name


def grad_norm_diff(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over all parameters' gradients together."""
    num = sum(((got[n].float() - w.float()) ** 2).sum() for n, w in want.items())
    den = sum((w.float() ** 2).sum() for w in want.values())
    return (num / den).sqrt().item()


def check_gradients(torch, ops, nets, parallel, schedulers, recipe) -> None:
    """Phase 4 (c): one step's parameter gradients with seeded random weights,
    the kernel path (without and with use_checkpointing) against the plain
    attention path, from the same images, noise and timesteps."""
    cfg = dict(
        spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
        num_channels=BENCH["channels"], attention_levels=(False, True, True),
        num_head_channels=BENCH["channels"][-1], norm_num_groups=32,
    )
    kernel_model = nets.DiffusionModelUNet(**cfg).to(DEVICE)
    randomize(torch, kernel_model)
    models = {}
    for label, extra in (("plain", dict(use_flash_attention=False)),
                         ("checkpointed", dict(use_checkpointing=True))):
        m = nets.DiffusionModelUNet(**cfg, **extra)
        m.load_state_dict(kernel_model.state_dict(), strict=True)
        models[label] = m.to(DEVICE)
    step = parallel.make_diffusion_train_step(
        schedulers.DDPMScheduler(num_train_timesteps=1000, device=DEVICE)
    )
    g = torch.Generator(DEVICE).manual_seed(3)
    images = recipe.synthetic_batch(g, GRAD_BATCH, BENCH["size"], DEVICE) * 2 - 1
    noise = torch.randn(images.shape, generator=g, device=DEVICE)
    timesteps = torch.randint(0, 1000, (GRAD_BATCH,), generator=g, device=DEVICE)

    def grads(model):
        model.zero_grad(set_to_none=True)
        step.loss_fn(model, images, noise, timesteps).backward()
        torch.cuda.synchronize()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    want = grads(models["plain"])
    for label, model, fwd in (("kernel path", kernel_model, 3),
                              ("kernel path, use_checkpointing", models["checkpointed"], 6)):
        reset_launches(ops)
        got = grads(model)
        counts = read_launches(ops)
        worst, worst_name = max_grad_diff(got, want)
        log(f"train: gradients at batch {GRAD_BATCH}, {label} vs plain path: worst "
            f"max|diff|/max|grad| = {worst:.3e} at {worst_name} (tol {GRAD_RTOL:g})")
        check_launches(counts, expected_launches(flash_fwd=fwd, flash_bwd_dq=3, flash_bwd_dkv=3),
                       f"one step, {label}")
        if not worst <= GRAD_RTOL:
            raise AssertionError(f"{label}: gradients disagree with the plain path")


def model_3d(torch, nets, dtype=None, use_flash_attention=None):
    """bench.py's 3D UNet config on the card (random weights set by the caller)."""
    return nets.DiffusionModelUNet(
        spatial_dims=3, in_channels=1, out_channels=1, num_res_blocks=1,
        num_channels=THREE_D["channels"], attention_levels=(False, False, True),
        num_head_channels=THREE_D["head_channels"], norm_num_groups=THREE_D["norm_groups"],
        use_flash_attention=use_flash_attention, dtype=dtype,
    ).to(DEVICE).eval()


class Unfused:
    """A model called with GMTPU_FUSED_RESBLOCK=0: its ResnetBlocks take the
    unfused route (the variable is read at each call)."""

    def __init__(self, model):
        self.model = model

    def __call__(self, *args, **kwargs):
        os.environ["GMTPU_FUSED_RESBLOCK"] = "0"
        try:
            return self.model(*args, **kwargs)
        finally:
            os.environ["GMTPU_FUSED_RESBLOCK"] = "1"


def expected_launches_3d(model) -> dict:
    """One forward's launches, counted from the model: two fused convs for
    each ResnetBlock that neither up- nor downsamples, one flash forward for
    each attention block (all at the 32^3 level: 32768 tokens, 64-wide heads,
    over the dispatcher's 1024-token threshold)."""
    from generativemodels_tpu_torch.networks.blocks.attention_blocks import AttentionBlock
    from generativemodels_tpu_torch.networks.nets.diffusion_model_unet import ResnetBlock

    blocks = [m for m in model.modules() if isinstance(m, ResnetBlock)]
    attn = [m for m in model.modules() if isinstance(m, AttentionBlock)]
    return dict(fused_conv=2 * sum(not (m.up or m.down) for m in blocks), flash_fwd=len(attn))


def dpm_chain_step_diffs(scheduler, models, noise) -> list[float]:
    """Run models[0]'s DPM-Solver++ chain; at every step also step the other
    models from the same x_t and the same solver state. Returns, for each
    pair of neighbours in `models`, the largest difference of their steps'
    outputs over the chain."""
    state = scheduler.init_state(noise.shape, noise.dtype)
    x, worst = noise, [0.0] * (len(models) - 1)
    for t in scheduler.timesteps:
        tt = t.expand(x.shape[0])
        steps = [scheduler.step(state, model(x, tt), t, x) for model in models]
        for i, ((xa, _), (xb, _)) in enumerate(zip(steps, steps[1:])):
            worst[i] = max(worst[i], (xa - xb).abs().max().item())
        x, state = steps[0]
    return worst


def sample_3d(torch, inferers, scheduler, model, seed: int):
    """One sample through DiffusionInferer.sample; (image, seconds on the host
    clock ending in a synchronize)."""
    shape = (THREE_D["batch"], 1) + (THREE_D["size"],) * 3
    g = torch.Generator(DEVICE).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        noise = torch.randn(shape, generator=g, device=DEVICE)
        image = inferers.DiffusionInferer(scheduler).sample(noise, model, generator=g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if image.shape != shape or not bool(torch.isfinite(image).all()):
        raise AssertionError(f"bad 3D sample: shape {tuple(image.shape)}")
    return image, seconds


def counts_3d(ops) -> dict:
    """The launches of the 3D path's kernels, 5 and 1."""
    return {n: c for n, c in read_launches(ops).items() if n in ("fused_conv", "flash_fwd")}


def check_3d_counts(counts: dict, per_forward: dict, forwards: int, what: str) -> None:
    expected = {n: c * forwards for n, c in per_forward.items()}
    log(f"3d: {what}: launches {counts} (expected {expected}: {per_forward} a forward)")
    if counts != expected:
        raise AssertionError(f"{what}: launches {counts}, expected {expected}")


def run_3d(torch, ops, nets, schedulers, inferers):
    """Phase 5: the 3D 128^3 sampling slice with the fused ResnetBlock route.
    Returns the model and the fused-conv launches of the DDIM-50 sample."""
    os.environ["GMTPU_FUSED_RESBLOCK"] = "1"
    model = model_3d(torch, nets, dtype=torch.bfloat16)
    randomize(torch, model)
    per_forward = expected_launches_3d(model)
    weighted = sum(FUSED_FORWARD_LAUNCHES.values())
    if per_forward["fused_conv"] != weighted:
        raise AssertionError(f"a forward launches kernel 5 {per_forward['fused_conv']} times, "
                             f"FUSED_FORWARD_LAUNCHES counts {weighted}")
    torch.cuda.reset_peak_memory_stats()
    ddim = schedulers.DDIMScheduler(num_train_timesteps=1000, device=DEVICE)
    ddim.set_timesteps(DDIM_STEPS_3D)
    reset_launches(ops)
    _, seconds = sample_3d(torch, inferers, ddim, model, seed=0)
    check_3d_counts(counts_3d(ops), per_forward, DDIM_STEPS_3D, f"DDIM-{DDIM_STEPS_3D} sample")
    launches = read_launches(ops)["fused_conv"]
    log(f"3d: DDIM-{DDIM_STEPS_3D} sample at {THREE_D['size']}^3, batch {THREE_D['batch']}, "
        f"bf16: {seconds:.3f} s")
    dpm = schedulers.DPMSolverMultistepScheduler(num_train_timesteps=1000, device=DEVICE)
    dpm.set_timesteps(DPM_STEPS)
    dpm_seconds = []
    reset_launches(ops)
    for seed in DPM_SEEDS:
        _, sec = sample_3d(torch, inferers, dpm, model, seed=seed)
        dpm_seconds.append(sec)
    check_3d_counts(counts_3d(ops), per_forward, DPM_STEPS * len(DPM_SEEDS),
                    f"{len(DPM_SEEDS)} DPM-Solver++(2M)-{DPM_STEPS} samples")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"3d: DPM-Solver++(2M)-{DPM_STEPS} samples: "
        + ", ".join(f"{x:.3f}" for x in dpm_seconds) + f" s; peak memory {peak:.2f} GiB")
    return model, launches


def compare_3d(torch, ops, nets, schedulers, kernel_bf16) -> None:
    """Phase 5: the kernel path (fused route, flash kernel) against the
    unfused, plain-attention path with the same weights: one forward in f32
    and in bf16, and every step of a bf16 DPM-10 chain. The bf16 checks are
    held to the plain path's own bf16 rounding, measured against its f32
    run on the same inputs."""
    shape = (THREE_D["batch"], 1) + (THREE_D["size"],) * 3
    state = kernel_bf16.state_dict()
    g = torch.Generator(DEVICE).manual_seed(9)
    x = torch.randn(shape, generator=g, device=DEVICE)
    t = torch.tensor([500], device=DEVICE)
    plain = {}
    with torch.inference_mode():
        outs = {}
        for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            plain[label] = model_3d(torch, nets, dtype=dtype, use_flash_attention=False)
            plain[label].load_state_dict(state, strict=True)
            if dtype is None:
                kernel = model_3d(torch, nets)
                kernel.load_state_dict(state, strict=True)
            else:
                kernel = kernel_bf16
            reset_launches(ops)
            outs[label, "kernel"] = kernel(x, t)
            kernel_counts = read_launches(ops)
            # the kernel path really ran kernels 5 and 1, or the check below
            # would hold the plain path against itself
            check_3d_counts(counts_3d(ops), expected_launches_3d(kernel), 1,
                            f"{label} forward, kernel path")
            outs[label, "plain"] = Unfused(plain[label])(x, t)
            if read_launches(ops) != kernel_counts:
                raise AssertionError("the plain path launched a kernel")
            del kernel
        ref = outs["f32", "plain"]
        scale = ref.abs().max().item()

        def rel(a, b):
            return (outs[a] - outs[b]).abs().max().item() / scale

        fwd_f32 = rel(("f32", "kernel"), ("f32", "plain"))
        fwd_bf16 = rel(("bf16", "kernel"), ("bf16", "plain"))
        own_bf16 = rel(("bf16", "plain"), ("f32", "plain"))
        kernel_bf16_err = rel(("bf16", "kernel"), ("f32", "plain"))
        del outs, ref
        noise = torch.randn(shape, generator=g, device=DEVICE)
        dpm = schedulers.DPMSolverMultistepScheduler(num_train_timesteps=1000, device=DEVICE)
        dpm.set_timesteps(DPM_STEPS)
        step_kp, step_own = dpm_chain_step_diffs(
            dpm, [kernel_bf16, Unfused(plain["bf16"]), Unfused(plain["f32"])], noise)
    del plain
    torch.cuda.empty_cache()
    log(f"3d: one forward at t=500, max|diff|/max|out of the plain f32 path| "
        f"({scale:.3e}): kernel vs plain path in f32 {fwd_f32:.3e} (tol {FORWARD_RTOL_3D:g}); "
        f"in bf16 {fwd_bf16:.3e} (tol {BF16_RATIO_3D:g} x the plain bf16 path's own rounding, "
        f"{own_bf16:.3e} against the plain f32 path; the kernel path's bf16 run is "
        f"{kernel_bf16_err:.3e} from it)")
    log(f"3d: every step of a bf16 DPM-{DPM_STEPS} chain from the same x_t and state: kernel "
        f"vs plain path max|diff| = {step_kp:.3e} (tol {BF16_RATIO_3D:g} x {step_own:.3e}, the "
        f"plain bf16 step's own distance from the plain f32 step)")
    if not fwd_f32 <= FORWARD_RTOL_3D:
        raise AssertionError("3D forward (f32): kernel path disagrees with the plain path")
    if not fwd_bf16 <= BF16_RATIO_3D * own_bf16:
        raise AssertionError("3D forward (bf16): kernel path disagrees with the plain path")
    if not step_kp <= BF16_RATIO_3D * step_own:
        raise AssertionError("DPM chain: kernel path disagrees with the plain path")


def profile_3d(torch, model) -> None:
    """Phase 5: device time of one kernel-path bf16 forward by kernel and by
    group, from torch.profiler (CUDA activity), and the device's busy share
    of the forward's wall time (host clock, ending in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    shape = (THREE_D["batch"], 1) + (THREE_D["size"],) * 3
    x = torch.randn(shape, device=DEVICE)
    t = torch.tensor([500], device=DEVICE)
    with torch.inference_mode():
        model(x, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x, t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    report_profile(prof, wall, PROFILE_GROUPS, "3d: profile of one bf16 forward")


def report_profile(prof, wall: float, profile_groups, what: str) -> tuple[float, int]:
    """Log the device time of a profiled window by group and by kernel, and
    the device's busy share of its wall time (host clock); return its device
    milliseconds and kernel count."""
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    total = sum(e.device_time_total for e in events)
    if total == 0:
        raise AssertionError("the profiler saw no device time")
    log(f"{what}: {total / 1e3:.3f} ms of device time in {sum(e.count for e in events)} "
        f"kernels, {wall * 1e3:.3f} ms of wall time (busy share {total / 1e6 / wall:.3f})")
    groups = dict.fromkeys((name for name, _ in profile_groups), 0.0)
    for e in events:
        name = next(n for n, keys in profile_groups if any(k in e.key for k in keys))
        groups[name] += e.device_time_total
    for name, us in groups.items():
        log(f"  group {name}: {us / 1e3:.3f} ms ({100 * us / total:.1f}%)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:14]:
        log(f"  {e.device_time_total / 1e3:9.3f} ms {100 * e.device_time_total / total:5.1f}% "
            f"x{e.count:<4d} {e.key[:110]}")
    return total / 1e3, sum(e.count for e in events)


def serve_dpmsolver(torch, ops, serve) -> float:
    """Phase 5: one POST /sample to the DPM-Solver++ sampler on the 2D serving config."""
    config = dict(SERVE, ddim_steps=DPM_STEPS)
    sampler, shape = serve.build_sampler(device=DEVICE, solver="dpmsolver", **config)
    randomize(torch, sampler.model)
    httpd = serve.start_server(serve._SamplerState(sampler, shape), port=0)
    try:
        ops.FLASH_FWD.launches = 0
        t0 = time.perf_counter()
        img = post_sample(httpd.server_port, 0, shape[0])
        seconds = time.perf_counter() - t0
        launches = ops.FLASH_FWD.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
    expected = LAUNCHES_PER_FORWARD * DPM_STEPS
    log(f"serve --solver dpmsolver: POST /sample -> {img.shape} in {seconds:.3f} s, flash_fwd "
        f"launches {launches} (expected {expected})")
    if img.shape != shape or not np.isfinite(img).all():
        raise AssertionError("bad DPM-Solver++ image batch")
    if launches != expected:
        raise AssertionError(f"flash_fwd launched {launches} times, expected {expected}")
    return seconds


@contextlib.contextmanager
def fused_backward(flag: str):
    """Within the block, GMTPU_FLASH_FUSED_BWD is `flag` (read at each
    backward); afterwards it is unset, so the split backward runs."""
    os.environ["GMTPU_FLASH_FUSED_BWD"] = flag
    try:
        yield
    finally:
        os.environ.pop("GMTPU_FLASH_FUSED_BWD", None)


BACKWARDS = (("split", "0"), ("fused", "1"))


def train_3d_recipe(torch, ops, recipe3d) -> dict:
    """Phase 6 (a): `recipes.train_3d_ddpm.main` at bench.py's 3D training
    config for TRAIN_STEPS steps, once with each backward. Returns, for each,
    the launches, steps/s (over the steps after two) and peak memory."""
    results = {}
    for label, flag in BACKWARDS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(ops)
        t0 = time.perf_counter()
        with fused_backward(flag):
            out = recipe3d.main([*TRAIN_3D_ARGS, "--steps", str(TRAIN_STEPS), "--device", DEVICE])
        seconds = time.perf_counter() - t0
        counts = read_launches(ops)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses, sps = out["losses"], out["steps_per_sec"]
        log(f"train3d: recipe main, bench.py's 3D config (UNet (32, 64, 128), bf16, 128^3, "
            f"batch 1, no remat, lr 2.5e-5), {label} backward: {TRAIN_STEPS} steps in "
            f"{seconds:.2f} s; {sps:.4f} steps/s over steps 3-{TRAIN_STEPS} "
            f"({1e3 / sps:.2f} ms a step); peak memory {peak:.2f} GiB; losses "
            + ", ".join(f"{x:.5f}" for x in losses))
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"3D recipe losses not finite: {losses}")
        check_launches(counts, expected_launches(TRAIN_STEPS, **TRAIN_3D_LAUNCHES[label]),
                       f"3D recipe main, {label} backward")
        results[label] = dict(launches=counts, steps_per_sec=sps, peak_gib=peak, losses=losses)
        del out
    return results


def check_gradients_3d(torch, ops, nets, parallel, schedulers, recipe3d) -> None:
    """Phase 6 (b): one step's parameter gradients of bench.py's 3D UNet with
    seeded random weights, every path from the same volume, noise and
    timestep: in f32 at GRAD_SIZE_3D^3 the split-kernel and the fused-kernel
    paths against the plain attention path; in bf16 at 128^3 the fused path
    against the split path, and against itself (the spread of dq's atomics)."""
    step = parallel.make_diffusion_train_step(
        schedulers.DDPMScheduler(num_train_timesteps=1000, device=DEVICE)
    )

    def draws(size: int, seed: int):
        g = torch.Generator(DEVICE).manual_seed(seed)
        images = recipe3d.synthetic_volume(g, 1, size, DEVICE) * 2 - 1
        noise = torch.randn(images.shape, generator=g, device=DEVICE)
        return images, noise, torch.randint(0, 1000, (1,), generator=g, device=DEVICE)

    def grads(model, data, flag: str, expected: dict, what: str) -> dict:
        model.zero_grad(set_to_none=True)
        reset_launches(ops)
        with fused_backward(flag):
            step.loss_fn(model, *data).backward()
        torch.cuda.synchronize()
        check_launches(read_launches(ops), expected_launches(**expected), what)
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    data = draws(GRAD_SIZE_3D, 5)
    kernel_model = model_3d(torch, nets)
    randomize(torch, kernel_model)
    plain = model_3d(torch, nets, use_flash_attention=False)
    plain.load_state_dict(kernel_model.state_dict(), strict=True)
    want = grads(plain, data, "0", {}, f"3D f32 step at {GRAD_SIZE_3D}^3, plain path")
    for label, flag in BACKWARDS:
        got = grads(kernel_model, data, flag, TRAIN_3D_LAUNCHES[label],
                    f"3D f32 step at {GRAD_SIZE_3D}^3, {label} backward")
        worst, worst_name = max_grad_diff(got, want)
        log(f"train3d: gradients in f32 at {GRAD_SIZE_3D}^3, {label}-kernel path vs plain path: "
            f"worst max|diff|/max|grad| = {worst:.3e} at {worst_name} (tol {GRAD_RTOL:g})")
        if not worst <= GRAD_RTOL:
            raise AssertionError(f"3D f32 gradients, {label} backward, disagree with the plain path")
    del kernel_model, plain, want, got

    data = draws(THREE_D["size"], 6)
    model = model_3d(torch, nets, dtype=torch.bfloat16)
    randomize(torch, model)
    what = f"3D bf16 step at {THREE_D['size']}^3"
    split = grads(model, data, "0", TRAIN_3D_LAUNCHES["split"], f"{what}, split backward")
    fused = grads(model, data, "1", TRAIN_3D_LAUNCHES["fused"], f"{what}, fused backward")
    again = grads(model, data, "1", TRAIN_3D_LAUNCHES["fused"], f"{what}, fused backward")
    norm, worst = grad_norm_diff(fused, split), max_grad_diff(fused, split)
    spread_norm, spread = grad_norm_diff(again, fused), max_grad_diff(again, fused)
    log(f"train3d: gradients in bf16 at {THREE_D['size']}^3, fused path vs split path: "
        f"||diff||/||grad|| = {norm:.3e} (tol {BF16_GRAD_RTOL_3D:g}), worst max|diff|/max|grad| "
        f"= {worst[0]:.3e} at {worst[1]}; the fused path against itself: {spread_norm:.3e}, "
        f"worst {spread[0]:.3e} at {spread[1]}")
    if not norm <= BF16_GRAD_RTOL_3D:
        raise AssertionError("3D bf16 gradients: the fused path disagrees with the split path")
    del model, split, fused, again
    torch.cuda.empty_cache()


def profile_train_3d(torch) -> None:
    """Phase 6 (c): device time of one bench.py 3D training step (bf16,
    128^3, batch 1, Adam) with each backward, by group and by kernel, and the
    busy share of the step's wall time (host clock, ending in a synchronize):
    `probes/train_profile.py`'s `bench3d_bf16` step, which that probe also
    runs in turns against another checkout."""
    from generativemodels_tpu_torch.probes import train_profile

    for label, flag in BACKWARDS:
        with fused_backward(flag):
            line = train_profile.profile_step(torch, "bench3d_bf16")
        total = line["device_ms"]
        log(f"train3d: profile of one bf16 training step, {label} backward: {total:.3f} ms of "
            f"device time in {line['kernels']} kernels, {line['wall_ms']:.3f} ms of wall time "
            f"(busy share {line['busy_share']:.3f})")
        for group, ms in line["groups_ms"].items():
            log(f"  group {group}: {ms:.3f} ms ({100 * ms / total:.1f}%)")
        for e in line["top"]:
            log(f"  {e['ms']:9.3f} ms {100 * e['ms'] / total:5.1f}% x{e['count']:<4d} "
                f"{e['kernel'][:110]}")
        torch.cuda.empty_cache()


def probe_calls(ops, scale: float) -> list:
    """(kernel name, variant, kernel call, plain call) of the ten kernel
    variants of phase 7; a plain call returns O and, for mxu_only, the row
    sums its rows are held by."""
    calls = []
    for variant in ops.OVERLAP_VARIANTS:
        def fn(q, k, v, variant=variant):
            return ops.flash_overlap(q, k, v, scale=scale, variant=variant)

        def plain(q, k, v, variant=variant):
            out, l = ops.flash_overlap_reference(q, k, v, scale=scale, variant=variant,
                                                 with_l=True)
            return out, (l if variant == "mxu_only" else None)

        calls.append(("flash_probe_overlap", variant, fn, plain))
    for variant, (prescaled, bf16_p) in ops.VPU_VARIANTS.items():
        opts = dict(scale=scale, prescaled=prescaled, bf16_p=bf16_p)
        calls.append(("flash_probe_vpu", variant,
                      lambda q, k, v, opts=opts: ops.flash_vpu(q, k, v, **opts),
                      lambda q, k, v, opts=opts: (ops.flash_vpu_reference(q, k, v, **opts), None)))
    return calls


def check_probes(torch, ops) -> dict:
    """Phase 7 (a): each kernel variant against its plain version at
    PROBE_CASES; returns {(case, variant): max|diff|} (None for mxu_only)."""
    from generativemodels_tpu_torch.ops.flash_probes import nearest_shape, relative_error

    errors = {}
    g = torch.Generator("cuda").manual_seed(7)
    for case, (bh, sq, sk, d), rows in PROBE_CASES:
        inputs = {}
        for kernel, variant, fn, plain in probe_calls(ops, d**-0.5):
            shape = nearest_shape(variant, sq, sk)
            if shape not in inputs:
                inputs[shape] = tuple(
                    torch.randn((bh, n, d), generator=g, device="cuda").to(torch.bfloat16)
                    for n in (shape[0], shape[1], shape[1]))
            q, k, v = inputs[shape]
            held_q = q if rows is None else q[:, :rows].contiguous()
            got = fn(q, k, v)[:, :held_q.shape[1]]
            want, l = plain(held_q, k, v)
            torch.cuda.synchronize()
            rel, held = relative_error(got, want, l)
            # mxu_only's held rows include those with l <= -1, whose output
            # divides by the 1e-30 floor: no absolute error is read there
            abs_err = (got.float() - want.float()).abs().max().item() if l is None else None
            ok = rel <= PROBE_TOLERANCE and bool(torch.isfinite(got.float()).all())
            log(f"probe {case} (BH={bh}, Sq={shape[0]}, Sk={shape[1]}, D={d}) {kernel} "
                f"{variant}: relative error {rel:.3e} (tol {PROBE_TOLERANCE:g}) over {held} of "
                f"{bh * held_q.shape[1]} rows, max|diff| {abs_err} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"probe case {case} {variant} out of tolerance")
            errors[(case, variant)] = abs_err
            del got, want, l, held_q
        del inputs
        torch.cuda.empty_cache()
    return errors


def run_probes(torch, ops, probes, kernel1_ms: float, errors: dict) -> tuple[dict, dict]:
    """Phase 7 (b): both entry points at their defaults, the launches of
    kernels 1, 6 and 7 counted over the two runs; each variant's time beside
    its TFLOP/s, its share of the bound, its plain version's time, and its
    ratio to kernel 1 (the VPU probe's `base`, the same inputs in this call;
    phase 2's time is `kernel1_ms`) and to flash SDPA. Returns the kernels
    line's numbers and launches of the two probe kernels."""
    from generativemodels_tpu_torch.probes import probe_attn_vpu, probe_overlap

    reset_launches(ops)
    results = {"flash_probe_overlap": probe_overlap.main([]),
               "flash_probe_vpu": probe_attn_vpu.main([])}
    torch.cuda.synchronize()
    counts = read_launches(ops)
    calls = 1 + probes.WARMUP + probes.ITERS  # a variant: the slice check, then timing
    expected = expected_launches(
        flash_fwd=calls, flash_probe_overlap=calls * len(ops.OVERLAP_VARIANTS),
        flash_probe_vpu=calls * len(ops.VPU_VARIANTS))
    log(f"probes: launches {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"probe entry points: kernel launches {counts}, expected {expected}")

    bh, seq, d = probe_overlap.BH, probe_overlap.SEQ, probe_overlap.D
    scale = d**-0.5
    q, k, v = probes.random_inputs(bh, seq, d, torch.device("cuda"))
    flop = 4 * bh * seq * seq * d
    lim = bound(flop, 2 * bh * seq * d * 4, "bfloat16")  # q, k, v read, o written
    library_ms, backend = library_attention_ms(torch, q, k, v, scale, False)
    base_ms = next(e["ms"] for e in results["flash_probe_vpu"] if e["variant"] == "base")
    log(f"probes: kernel 1 {base_ms:.4f} ms in this phase ({kernel1_ms:.4f} ms in phase 2), "
        f"SDPA ({backend}) {library_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms "
        f"({lim['bound_by']})")
    plains = {variant: plain for _, variant, _, plain in probe_calls(ops, scale)}
    plains["base"] = lambda q, k, v: (ops.flash_attention_reference(q, k, v, scale=scale)[0],
                                      None)
    numbers = {}
    for kernel, entries in results.items():
        for entry in entries:
            variant, ms = entry["variant"], entry["ms"]
            plain_ms = time_ms(lambda: plains[variant](q, k, v), iters=PLAIN_PROBE_ITERS)
            log(f"probe {kernel} {variant}: {ms:.4f} ms, {flop / ms / 1e9:.1f} TFLOP/s, "
                f"{lim['bound_ms'] / ms:.1%} of the bound, {ms / base_ms:.3f}x kernel 1, "
                f"{ms / library_ms:.3f}x SDPA, plain {plain_ms:.4f} ms; vs exact softmax "
                f"{entry['maxdiff_vs_einsum']}, vs plain {entry['maxdiff_vs_plain']:.3e} "
                f"({entry['rows_vs_plain']} rows)")
            if not ms >= lim["bound_ms"]:
                raise AssertionError(f"probe {variant}: {ms} ms is below the bound")
            if variant == PROBE_MAIN_VARIANT.get(kernel):
                numbers[kernel] = dict(max_abs_err=errors[("3d_level2", variant)], ms=ms,
                                       plain_ms=plain_ms, library_ms=library_ms, **lim)
    del q, k, v
    torch.cuda.empty_cache()
    return numbers, {name: counts[name] for name in PROBE_MAIN_VARIANT}


def ldm_unet(torch, nets, bench_ldm, dtype=None, use_flash_attention=None):
    """The latent UNet of bench.py's config on the card (weights set by the caller)."""
    return nets.DiffusionModelUNet(
        **bench_ldm.UNET_CONFIG, use_flash_attention=use_flash_attention, dtype=dtype,
    ).to(DEVICE).eval()


def ldm_fused_per_forward(model) -> int:
    """Kernel 5's launches in one forward under GMTPU_FUSED_RESBLOCK=1: two
    for each ResnetBlock that neither up- nor downsamples."""
    from generativemodels_tpu_torch.networks.nets.diffusion_model_unet import ResnetBlock

    return 2 * sum(not (m.up or m.down) for m in model.modules() if isinstance(m, ResnetBlock))


def check_ldm_counts(counts: dict, expected: dict, what: str) -> None:
    log(f"ldm: {what}: launches {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"{what}: launches {counts}, expected {expected}")


def ldm_training_forward(torch, ops, schedulers, inferers, bench_ldm, aekl, unet) -> None:
    """Phase 8 (a): LatentDiffusionInferer.__call__ on a 1x1x128^3 volume:
    the encode at full size, add_noise and one UNet forward."""
    g = torch.Generator(DEVICE).manual_seed(11)
    x = torch.randn((1, 1) + (bench_ldm.SIZE,) * 3, generator=g, device=DEVICE)
    noise = torch.randn(bench_ldm.latent_shape(), generator=g, device=DEVICE)
    ddpm = schedulers.DDPMScheduler(num_train_timesteps=1000, device=DEVICE)
    inferer = inferers.LatentDiffusionInferer(ddpm, scale_factor=bench_ldm.SCALE_FACTOR)
    reset_launches(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        pred = inferer(x, aekl, unet, noise, torch.tensor([500], device=DEVICE), generator=g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_ldm_counts(counts_3d(ops), dict(fused_conv=0, flash_fwd=LDM_FLASH_PER_FORWARD),
                     "training forward (encode at 128^3, one UNet forward)")
    log(f"ldm: training forward -> {tuple(pred.shape)} {pred.dtype} in {seconds:.3f} s "
        f"(first call, cuDNN set-up among it)")
    if tuple(pred.shape) != bench_ldm.latent_shape() or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"bad latent prediction: shape {tuple(pred.shape)}")


def ldm_compare(torch, ops, nets, schedulers, bench_ldm, unet_bf16) -> None:
    """Phase 8 (b) and (d): the kernel path against the plain path with the
    same weights, one UNet forward at 32^3 in f32 and bf16, every step of
    an f32 DDIM-50 chain from the same x_t, and the fused route's bf16
    forward (GMTPU_FUSED_RESBLOCK=1) against the plain bf16 path."""
    state = unet_bf16.state_dict()
    g = torch.Generator(DEVICE).manual_seed(12)
    x = torch.randn(bench_ldm.latent_shape(), generator=g, device=DEVICE)
    t = torch.tensor([500], device=DEVICE)
    models = {}
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        for path, flash in (("kernel", None), ("plain", False)):
            model = ldm_unet(torch, nets, bench_ldm, dtype=dtype, use_flash_attention=flash)
            model.load_state_dict(state, strict=True)
            models[label, path] = model
    outs = {}
    with torch.inference_mode():
        for key, model in models.items():
            reset_launches(ops)
            outs[key] = model(x, t)
            expected = LDM_FLASH_PER_FORWARD if key[1] == "kernel" else 0
            check_ldm_counts(counts_3d(ops), dict(fused_conv=0, flash_fwd=expected),
                             f"{key[0]} forward, {key[1]} path")
        os.environ["GMTPU_FUSED_RESBLOCK"] = "1"
        try:
            reset_launches(ops)
            fused = models["bf16", "kernel"](x, t)
            check_ldm_counts(
                counts_3d(ops), dict(fused_conv=ldm_fused_per_forward(unet_bf16),
                                      flash_fwd=LDM_FLASH_PER_FORWARD),
                "bf16 forward, fused route")
        finally:
            os.environ["GMTPU_FUSED_RESBLOCK"] = "0"
        ref = outs["f32", "plain"]
        scale = ref.abs().max().item()

        def rel(a, b):
            return (a - b).abs().max().item() / scale

        fwd_f32 = rel(outs["f32", "kernel"], ref)
        own_bf16 = rel(outs["bf16", "plain"], ref)
        fwd_bf16 = rel(outs["bf16", "kernel"], outs["bf16", "plain"])
        fused_bf16 = rel(fused, outs["bf16", "plain"])
        ddim = schedulers.DDIMScheduler(num_train_timesteps=1000, device=DEVICE)
        ddim.set_timesteps(50)
        noise = torch.randn(bench_ldm.latent_shape(), generator=g, device=DEVICE)
        step_abs = chain_step_diff(ddim, models["f32", "kernel"], models["f32", "plain"], noise)
    del models, outs
    torch.cuda.empty_cache()
    log(f"ldm: one latent UNet forward at t=500, max|diff|/max|out of the plain f32 path| "
        f"({scale:.3e}): kernel vs plain path in f32 {fwd_f32:.3e} (tol {FORWARD_RTOL:g}); in "
        f"bf16 {fwd_bf16:.3e}, fused route (GMTPU_FUSED_RESBLOCK=1) vs plain bf16 path "
        f"{fused_bf16:.3e} (tol {BF16_RATIO_3D:g} x the plain bf16 path's own rounding, "
        f"{own_bf16:.3e})")
    log(f"ldm: every step of an f32 DDIM-50 latent chain from the same x_t: kernel vs plain "
        f"path max|diff| = {step_abs:.3e} (tol {CHAIN_ATOL:g})")
    if not fwd_f32 <= FORWARD_RTOL:
        raise AssertionError("latent forward (f32): kernel path disagrees with the plain path")
    if not fwd_bf16 <= BF16_RATIO_3D * own_bf16:
        raise AssertionError("latent forward (bf16): kernel path disagrees with the plain path")
    if not fused_bf16 <= BF16_RATIO_3D * own_bf16:
        raise AssertionError("latent forward (bf16): the fused route disagrees with the plain path")
    if not step_abs <= CHAIN_ATOL:
        raise AssertionError("latent DDIM chain: kernel path disagrees with the plain path")


def ldm_timings(torch, ops, inferers, bench_ldm, aekl, unet, label: str) -> dict:
    """Phase 8 (c): seconds per DDIM-50 and DPM-Solver++-10 sample, noise to
    decoded volume, through `probes/bench_3d_ldm.run` (one warm-up, then
    LDM_RUNS), the launches counted over each run, and the chain/decode
    split of one more sample by CUDA events."""
    fused = os.environ.get("GMTPU_FUSED_RESBLOCK", "0") == "1"
    results = {}
    for solver in ("ddim", "dpm"):
        reset_launches(ops)
        result = bench_ldm.run(solver, DEVICE, runs=LDM_RUNS, models=(aekl, unet))
        forwards = bench_ldm.SOLVER_STEPS[solver] * (LDM_RUNS + 1)
        check_ldm_counts(
            counts_3d(ops),
            dict(fused_conv=ldm_fused_per_forward(unet) * forwards if fused else 0,
                 flash_fwd=LDM_FLASH_PER_FORWARD * forwards),
            f"{label}: {LDM_RUNS + 1} {result['config']} samples")
        inferer = inferers.LatentDiffusionInferer(bench_ldm.make_scheduler(solver, DEVICE),
                                                  scale_factor=bench_ldm.SCALE_FACTOR)
        chain_ms, decode_ms = bench_ldm.split_ms(inferer, aekl, unet, seed=20)
        log(f"ldm: {label}: {result['config']}: "
            + ", ".join(f"{s:.4f}" for s in result["seconds"])
            + f" s a sample (warm-up {result['first_s']:.3f} s); one more sample by CUDA "
            f"events: chain {chain_ms:.2f} ms, decode {decode_ms:.2f} ms; "
            f"{json.dumps(result)}")
        if result["out_shape"] != [1, 1] + [bench_ldm.SIZE] * 3:
            raise AssertionError(f"bad decoded shape {result['out_shape']}")
        results[solver] = dict(result, chain_ms=chain_ms, decode_ms=decode_ms)
    return results


def ldm_likelihood_and_pndm(torch, ops, schedulers, inferers, bench_ldm, aekl, unet) -> None:
    """Phase 8 (e): get_likelihood (DDPM-50, the KL maps resampled to 128^3
    trilinearly), sample(save_intermediates=True) with DDIM-50, and a
    PNDM-50 latent sample."""
    size = bench_ldm.SIZE
    g = torch.Generator(DEVICE).manual_seed(13)
    x = torch.tanh(torch.randn((1, 1) + (size,) * 3, generator=g, device=DEVICE))
    ddpm = schedulers.DDPMScheduler(num_train_timesteps=1000, device=DEVICE)
    ddpm.set_timesteps(LDM_LIKELIHOOD_STEPS)
    inferer = inferers.LatentDiffusionInferer(ddpm, scale_factor=bench_ldm.SCALE_FACTOR)
    reset_launches(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        total, maps = inferer.get_likelihood(
            x, aekl, unet, save_intermediates=True, resample_latent_likelihoods=True,
            resample_interpolation_mode="trilinear", generator=g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_ldm_counts(counts_3d(ops), dict(fused_conv=0,
                                           flash_fwd=LDM_FLASH_PER_FORWARD * LDM_LIKELIHOOD_STEPS),
                     f"get_likelihood, DDPM-{LDM_LIKELIHOOD_STEPS}")
    finite = bool(torch.isfinite(total).all()) and all(bool(torch.isfinite(m).all())
                                                       for m in maps)
    log(f"ldm: get_likelihood DDPM-{LDM_LIKELIHOOD_STEPS} in {seconds:.3f} s: total "
        f"{total.tolist()}, {len(maps)} KL maps of {tuple(maps[0].shape)}, finite {finite}")
    if (total.shape != (1,) or len(maps) != LDM_LIKELIHOOD_STEPS or not finite
            or tuple(maps[0].shape) != (1, 3) + (size,) * 3):
        raise AssertionError("bad latent likelihood")
    del maps

    ddim = inferers.LatentDiffusionInferer(bench_ldm.make_scheduler("ddim", DEVICE),
                                           scale_factor=bench_ldm.SCALE_FACTOR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image, mids = bench_ldm.sample(ddim, aekl, unet, seed=14, save_intermediates=True,
                                   intermediate_steps=LDM_INTERMEDIATE_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    finite = bool(torch.isfinite(image).all()) and all(bool(torch.isfinite(m).all())
                                                       for m in mids)
    log(f"ldm: DDIM-50 sample with save_intermediates (every {LDM_INTERMEDIATE_STEPS} "
        f"timesteps): {len(mids)} decoded intermediates of {tuple(mids[0].shape)} in "
        f"{seconds:.3f} s, finite {finite}")
    if len(mids) != 10 or not finite or tuple(image.shape) != (1, 1) + (size,) * 3:
        raise AssertionError("bad latent sample with intermediates")
    del mids

    pndm = schedulers.PNDMScheduler(num_train_timesteps=1000, device=DEVICE)
    pndm.set_timesteps(LDM_PNDM_STEPS)
    pndm_inferer = inferers.LatentDiffusionInferer(pndm, scale_factor=bench_ldm.SCALE_FACTOR)
    reset_launches(ops)
    image, seconds = bench_ldm.timed_sample(pndm_inferer, aekl, unet, seed=15)
    steps = len(pndm.timesteps)
    check_ldm_counts(counts_3d(ops), dict(fused_conv=0, flash_fwd=LDM_FLASH_PER_FORWARD * steps),
                     f"PNDM-{LDM_PNDM_STEPS} sample ({steps} steps)")
    log(f"ldm: PNDM-{LDM_PNDM_STEPS} latent sample ({steps} steps with the Runge-Kutta "
        f"warm-up) in {seconds:.3f} s (first PNDM call)")
    if tuple(image.shape) != (1, 1) + (size,) * 3 or not bool(torch.isfinite(image).all()):
        raise AssertionError("bad PNDM latent sample")


def ldm_profile(torch, bench_ldm, aekl, unet) -> None:
    """Phase 8 (f): device time by group and busy share of one warm latent
    UNet forward, one decode and one encode, as `profile_3d`."""
    from torch.profiler import ProfilerActivity, profile

    z = torch.randn(bench_ldm.latent_shape(), device=DEVICE)
    x = torch.randn((1, 1) + (bench_ldm.SIZE,) * 3, device=DEVICE)
    t = torch.tensor([500], device=DEVICE)
    calls = (("one bf16 latent UNet forward at 32^3", lambda: unet(z, t)),
             ("one bf16 decode to 128^3", lambda: aekl.decode_stage_2_outputs(z)),
             ("one bf16 encode from 128^3", lambda: aekl.encode(x)))
    with torch.inference_mode():
        for what, call in calls:
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report_profile(prof, wall, LDM_PROFILE_GROUPS, f"ldm: profile of {what}")
        # the encoder's (0, 1) pad before each stride-2 conv is a fill and a
        # copy, not told apart by name in the profile: timed alone here
        for c, n in ((32, bench_ldm.SIZE), (64, bench_ldm.SIZE // 2)):
            h = torch.randn((1, c) + (n,) * 3, device=DEVICE).to(torch.bfloat16)
            log(f"ldm: the (0, 1) pad copy of a (1, {c}, {n}, {n}, {n}) bf16 volume: "
                f"{time_ms(lambda: torch.nn.functional.pad(h, (0, 1) * 3)):.4f} ms")


def run_ldm(torch, ops, nets, schedulers, inferers, bench_ldm) -> dict:
    """Phase 8: the latent 128^3 route at bench.py's config through
    LatentDiffusionInferer and probes/bench_3d_ldm.py, random weights."""
    os.environ["GMTPU_FUSED_RESBLOCK"] = "0"
    aekl, unet = bench_ldm.build_models(DEVICE)
    randomize(torch, aekl)
    randomize(torch, unet)
    ldm_training_forward(torch, ops, schedulers, inferers, bench_ldm, aekl, unet)
    ldm_compare(torch, ops, nets, schedulers, bench_ldm, unet)
    torch.cuda.reset_peak_memory_stats()
    timings = ldm_timings(torch, ops, inferers, bench_ldm, aekl, unet, "unfused")
    peak = torch.cuda.max_memory_allocated() / 2**30
    os.environ["GMTPU_FUSED_RESBLOCK"] = "1"
    try:
        fused = ldm_timings(torch, ops, inferers, bench_ldm, aekl, unet,
                            "GMTPU_FUSED_RESBLOCK=1")
    finally:
        os.environ["GMTPU_FUSED_RESBLOCK"] = "0"
    log("ldm: seconds per sample, noise to decoded 128^3 volume (host clock): "
        + "; ".join(f"{solver} {sum(r['seconds']) / len(r['seconds']):.4f} unfused, "
                    f"{sum(f['seconds']) / len(f['seconds']):.4f} fused"
                    for (solver, r), f in zip(timings.items(), fused.values()))
        + f"; peak memory {peak:.2f} GiB")
    ldm_likelihood_and_pndm(torch, ops, schedulers, inferers, bench_ldm, aekl, unet)
    ldm_profile(torch, bench_ldm, aekl, unet)
    return timings


def contract_unet_forwards(torch, ops, nets) -> dict:
    """Phase 2 (d), on a model: one forward of (b)'s UNet under
    GMTPU_FLASH_NOMAX=0, and one of it with the brain bundle's conditioning
    and upcast_attention, each kernel path against the plain path with the
    same weights, in f32 (FORWARD_RTOL) and bf16 (BF16_RATIO_3D x the plain
    bf16 path's own distance from f32). Returns kernel 1's launches a
    forward for each contract."""
    cfg = CONTROLNET
    base = dict(spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
                num_channels=cfg["channels"], attention_levels=(False, True, True),
                num_head_channels=cfg["channels"][-1], norm_num_groups=cfg["norm_groups"])
    variants = {"running_max": {},
                "upcast": dict(with_conditioning=True, cross_attention_dim=4,
                               upcast_attention=True)}
    g = torch.Generator(DEVICE).manual_seed(22)
    x = torch.randn((cfg["batch"], 1, cfg["size"], cfg["size"]), generator=g, device=DEVICE)
    t = torch.tensor([999, 500, 250, 10], device=DEVICE)
    context = torch.rand((cfg["batch"], 1, 4), generator=g, device=DEVICE)
    launches = {}
    for contract, extra in variants.items():
        models = {}
        for dtype_label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            for path, flash in (("kernel", None), ("plain", False)):
                models[dtype_label, path] = nets.DiffusionModelUNet(
                    **base, **extra, use_flash_attention=flash, dtype=dtype).to(DEVICE).eval()
        randomize(torch, models["f32", "kernel"])
        state = models["f32", "kernel"].state_dict()
        for model in models.values():
            model.load_state_dict(state, strict=True)
        kwargs = dict(context=context) if extra else {}
        outs = {}
        if contract == "running_max":
            os.environ["GMTPU_FLASH_NOMAX"] = "0"
        try:
            with torch.inference_mode():
                for key, model in models.items():
                    reset_launches(ops)
                    outs[key] = model(x, t, **kwargs)
                    torch.cuda.synchronize()
                    count = ops.FLASH_FWD.launches
                    want = CONTRACT_UNET_LAUNCHES[contract] if key[1] == "kernel" else 0
                    if count != want:
                        raise AssertionError(f"{contract} {key}: kernel 1 launched {count} times, "
                                             f"expected {want}")
        finally:
            os.environ.pop("GMTPU_FLASH_NOMAX", None)
        ref = outs["f32", "plain"]
        scale = ref.abs().max().item()
        fwd_f32 = (outs["f32", "kernel"] - ref).abs().max().item() / scale
        own_bf16 = (outs["bf16", "plain"] - ref).abs().max().item() / scale
        fwd_bf16 = (outs["bf16", "kernel"] - outs["bf16", "plain"]).abs().max().item() / scale
        log(f"contract {contract}: (b)'s UNet{' with conditioning' if extra else ''}, one forward "
            f"({CONTRACT_UNET_LAUNCHES[contract]} kernel-1 launches): kernel vs plain path "
            f"max|diff|/max|out| in f32 {fwd_f32:.3e} (tol {FORWARD_RTOL:g}), in bf16 "
            f"{fwd_bf16:.3e} (tol {BF16_RATIO_3D:g} x the plain bf16 path's own {own_bf16:.3e})")
        if not (fwd_f32 <= FORWARD_RTOL and fwd_bf16 <= BF16_RATIO_3D * own_bf16):
            raise AssertionError(f"{contract}: the UNet's kernel path disagrees with the plain "
                                 "path")
        launches[contract] = CONTRACT_UNET_LAUNCHES[contract]
        del models, outs
        torch.cuda.empty_cache()
    return launches


def run_brain(torch, ops, nets, schedulers, inferers, brain) -> dict:
    """Phase 9 (a): the brain 3D LDM bundle through `sample_brain_ldm`, DDIM-50
    from the 20x28x20 latent to the 160x224x160 volume, with and without
    GMTPU_FUSED_RESBLOCK=1 (kernel 5, 34 launches a forward; no attention
    of this path reaches kernel 1: D = 512 and 768); per setting, seconds
    per sample by the host clock, the chain and the decode by CUDA events,
    the busy share of a profiled forward and the peak memory; then the
    fused route against the unfused one: an f32 forward, a bf16 forward and
    every step of an f32 DDIM-50 chain."""
    unet = brain.brain_unet(dtype=torch.bfloat16).to(DEVICE).eval()
    aekl = brain.brain_autoencoder(dtype=torch.bfloat16).to(DEVICE).eval()
    randomize(torch, unet)
    randomize(torch, aekl)
    per_forward = ldm_fused_per_forward(unet)
    g = torch.Generator(DEVICE)

    def scheduler():
        return schedulers.DDIMScheduler(num_train_timesteps=1000, schedule="scaled_linear_beta",
                                        beta_start=0.0015, beta_end=0.0205, clip_sample=False)

    def sample(seed):
        g.manual_seed(seed)
        return brain.sample_brain_ldm(unet, aekl, scheduler(), BRAIN_LATENT,
                                      num_inference_steps=BRAIN_STEPS, generator=g,
                                      device=DEVICE, **BRAIN_COVARIATES)

    results = {}
    out_shape = (1, 1) + tuple(8 * s for s in BRAIN_LATENT[2:])
    for flag in ("0", "1"):
        os.environ["GMTPU_FUSED_RESBLOCK"] = flag
        label = "fused route" if flag == "1" else "unfused"
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        with torch.inference_mode():
            for run in range(BRAIN_RUNS + 1):
                reset_launches(ops)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                image = sample(30 + run)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                counts = read_launches(ops)
                want = expected_launches(BRAIN_STEPS, fused_conv=per_forward if flag == "1" else 0)
                if counts != want:
                    raise AssertionError(f"brain {label}: launches {counts}, expected {want}")
                if tuple(image.shape) != out_shape or not bool(torch.isfinite(image).all()):
                    raise AssertionError(f"bad brain volume {tuple(image.shape)}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            # the chain and the decode by CUDA events
            sched = scheduler()
            sched.set_timesteps(BRAIN_STEPS, device=DEVICE)
            ctx = brain.make_conditioning(**BRAIN_COVARIATES, device=DEVICE)
            noise = torch.randn(BRAIN_LATENT, generator=g.manual_seed(40), device=DEVICE)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
            latent = inferers.DiffusionInferer(sched).sample(noise, unet, conditioning=ctx)
            events[1].record()
            decoded = aekl.decode_stage_2_outputs(latent)
            events[2].record()
            torch.cuda.synchronize()
            chain_ms, decode_ms = (events[0].elapsed_time(events[1]),
                                   events[1].elapsed_time(events[2]))
            del decoded, latent
        log(f"brain: {label}: DDIM-{BRAIN_STEPS} samples {BRAIN_LATENT} -> {out_shape}: "
            + ", ".join(f"{x:.4f}" for x in seconds[1:]) + f" s a sample (warm-up "
            f"{seconds[0]:.3f} s); kernel-5 launches {per_forward if flag == '1' else 0} a "
            f"forward; one more sample by CUDA events: chain {chain_ms:.2f} ms, decode "
            f"{decode_ms:.2f} ms; peak memory {peak:.2f} GiB")
        profile_call(torch, lambda: unet(noise, torch.tensor([500], device=DEVICE), context=ctx),
                     f"brain: profile of one bf16 UNet forward, {label}")
        results[label] = dict(seconds=seconds[1:], chain_ms=chain_ms, decode_ms=decode_ms,
                              peak_gib=peak)
    os.environ["GMTPU_FUSED_RESBLOCK"] = "0"
    brain_compare(torch, ops, schedulers, brain, unet)
    del unet, aekl
    torch.cuda.empty_cache()
    return results


def profile_call(torch, call, what: str) -> None:
    """Device time by group and busy share of one warm call, as `profile_3d`."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    report_profile(prof, wall, LDM_PROFILE_GROUPS, what)


def brain_compare(torch, ops, schedulers, brain, unet_bf16) -> None:
    """Phase 9 (a): the fused route (kernel 5) against the unfused one with
    the same weights: one f32 forward (FORWARD_RTOL), one bf16 forward
    (BF16_RATIO_3D x the unfused bf16 path's own distance from f32) and
    every step of an f32 DDIM-50 chain from the same x_t (CHAIN_ATOL)."""
    state = unet_bf16.state_dict()
    unet_f32 = brain.brain_unet().to(DEVICE).eval()
    unet_f32.load_state_dict(state, strict=True)
    g = torch.Generator(DEVICE).manual_seed(41)
    x = torch.randn(BRAIN_LATENT, generator=g, device=DEVICE)
    t = torch.tensor([500], device=DEVICE)
    ctx = brain.make_conditioning(**BRAIN_COVARIATES, device=DEVICE)

    def route(model, flag):
        def call(xx, tt, context=ctx):
            os.environ["GMTPU_FUSED_RESBLOCK"] = flag
            try:
                return model(xx, tt, context=context)
            finally:
                os.environ["GMTPU_FUSED_RESBLOCK"] = "0"
        return call

    with torch.inference_mode():
        outs = {(label, flag): route(model, flag)(x, t)
                for label, model in (("f32", unet_f32), ("bf16", unet_bf16))
                for flag in ("0", "1")}
        ref = outs["f32", "0"]
        scale = ref.abs().max().item()
        fwd_f32 = (outs["f32", "1"] - ref).abs().max().item() / scale
        own_bf16 = (outs["bf16", "0"] - ref).abs().max().item() / scale
        fwd_bf16 = (outs["bf16", "1"] - outs["bf16", "0"]).abs().max().item() / scale
        ddim = schedulers.DDIMScheduler(num_train_timesteps=1000, schedule="scaled_linear_beta",
                                        beta_start=0.0015, beta_end=0.0205, clip_sample=False)
        ddim.set_timesteps(BRAIN_STEPS, device=DEVICE)
        noise = torch.randn(BRAIN_LATENT, generator=g, device=DEVICE)
        reset_launches(ops)
        step_abs = chain_step_diff(ddim, route(unet_f32, "1"), route(unet_f32, "0"), noise)
        fused_launches = ops.FUSED_CONV.launches
    per_forward = ldm_fused_per_forward(unet_f32)
    del unet_f32, outs
    torch.cuda.empty_cache()
    log(f"brain: fused route vs unfused, one UNet forward at t=500, max|diff|/max|out| "
        f"({scale:.3e}): f32 {fwd_f32:.3e} (tol {FORWARD_RTOL:g}); bf16 {fwd_bf16:.3e} (tol "
        f"{BF16_RATIO_3D:g} x the unfused bf16 path's own {own_bf16:.3e}); every step of an "
        f"f32 DDIM-{BRAIN_STEPS} chain from the same x_t: max|diff| {step_abs:.3e} (tol "
        f"{CHAIN_ATOL:g}), {fused_launches} kernel-5 launches ({per_forward} a forward)")
    if fused_launches != per_forward * BRAIN_STEPS:
        raise AssertionError("brain chain: the fused route did not run kernel 5 at every step")
    if not (fwd_f32 <= FORWARD_RTOL and fwd_bf16 <= BF16_RATIO_3D * own_bf16
            and step_abs <= CHAIN_ATOL):
        raise AssertionError("brain: the fused route disagrees with the unfused one")


def run_controlnet(torch, ops, nets, schedulers, inferers) -> dict:
    """Phase 9 (b): the JAX ControlNet recipe's UNet and ControlNet (seeded by
    `copy_weights_to_controlnet` from the UNet; its own keys, the zero convs
    among them, random), `ControlNetDiffusionInferer.sample` at batch 4 with
    DDIM-50 (4 kernel-1 launches a step), one warm-up and two timed
    requests; then the kernel path against the plain path: one forward of
    the ControlNet and the UNet together and every step of a DDIM-50 chain."""
    from generativemodels_tpu_torch.inferers.controlnet import _wrap_with_controlnet

    cfg = CONTROLNET
    kwargs = dict(spatial_dims=2, in_channels=1, num_res_blocks=1, num_channels=cfg["channels"],
                  attention_levels=(False, True, True), num_head_channels=cfg["channels"][-1],
                  norm_num_groups=cfg["norm_groups"])

    def build(flash):
        unet = nets.DiffusionModelUNet(out_channels=1, use_flash_attention=flash, **kwargs)
        cn = nets.ControlNet(conditioning_embedding_num_channels=(16,),
                             use_flash_attention=flash, **kwargs)
        return unet.to(DEVICE).eval(), cn.to(DEVICE).eval()

    unet, cn = build(None)
    randomize(torch, unet)
    randomize(torch, cn, seed=4321)
    nets.copy_weights_to_controlnet(cn, unet)
    g = torch.Generator(DEVICE).manual_seed(50)
    shape = (cfg["batch"], 1, cfg["size"], cfg["size"])
    masks = (torch.rand(shape, generator=g, device=DEVICE) > 0.5).float()
    scheduler = schedulers.DDIMScheduler(num_train_timesteps=1000)
    scheduler.set_timesteps(cfg["steps"], device=DEVICE)
    inferer = inferers.ControlNetDiffusionInferer(scheduler)
    seconds = []
    with torch.inference_mode():
        for run in range(3):
            noise = torch.randn(shape, generator=g, device=DEVICE)
            reset_launches(ops)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            image = inferer.sample(noise, unet, cn, masks)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            counts = read_launches(ops)
            want = expected_launches(cfg["steps"], flash_fwd=CN_FLASH_PER_FORWARD)
            if counts != want:
                raise AssertionError(f"controlnet sample: launches {counts}, expected {want}")
            if tuple(image.shape) != shape or not bool(torch.isfinite(image).all()):
                raise AssertionError(f"bad ControlNet sample {tuple(image.shape)}")
    log(f"controlnet: ControlNetDiffusionInferer.sample, batch {cfg['batch']}, DDIM-"
        f"{cfg['steps']}: " + ", ".join(f"{x:.4f}" for x in seconds[1:])
        + f" s a request (warm-up {seconds[0]:.3f} s); kernel-1 launches "
        f"{CN_FLASH_PER_FORWARD} a step at (4, 1024, 1024, 128) f32")
    plain_unet, plain_cn = build(False)
    plain_unet.load_state_dict(unet.state_dict(), strict=True)
    plain_cn.load_state_dict(cn.state_dict(), strict=True)
    kernel_fn = _wrap_with_controlnet(unet, cn, masks)
    plain_fn = _wrap_with_controlnet(plain_unet, plain_cn, masks)
    x = torch.randn(shape, generator=g, device=DEVICE)
    t = torch.tensor([999, 500, 250, 10], device=DEVICE)
    with torch.inference_mode():
        a, b = kernel_fn(x, t), plain_fn(x, t)
        fwd_rel = ((a - b).abs().max() / b.abs().max()).item()
        step_abs = chain_step_diff(scheduler, kernel_fn, plain_fn, x)
    log(f"controlnet: kernel vs plain path, one ControlNet + UNet forward: max|diff|/max|out| "
        f"{fwd_rel:.3e} (tol {FORWARD_RTOL:g}); every step of a DDIM-{cfg['steps']} chain from "
        f"the same x_t: max|diff| {step_abs:.3e} (tol {CHAIN_ATOL:g})")
    if not (fwd_rel <= FORWARD_RTOL and step_abs <= CHAIN_ATOL):
        raise AssertionError("controlnet: kernel path disagrees with the plain path")
    del unet, cn, plain_unet, plain_cn
    torch.cuda.empty_cache()
    return dict(seconds=seconds[1:])


def run_cfg(torch, ops, nets, schedulers) -> dict:
    """Phase 9 (c): `sample_with_guidance` on the CXR LDM's UNet at full width
    (bf16), DDIM-50 and DPM-Solver++-10, each one warm-up and one timed
    chain, no kernel launched (every attention is at D = 512 or 768); then
    one guided prediction of an f32 copy held against uncond + g (cond -
    uncond) from two separate forwards (FORWARD_RTOL)."""
    from generativemodels_tpu_torch.recipes import guidance

    cfg = CXR

    def build(dtype):
        return nets.DiffusionModelUNet(
            spatial_dims=2, in_channels=3, out_channels=3, num_res_blocks=2,
            num_channels=cfg["channels"], attention_levels=(False, True, True),
            num_head_channels=cfg["heads"], with_conditioning=True, cross_attention_dim=1024,
            dtype=dtype,
        ).to(DEVICE).eval()

    model = build(torch.bfloat16)
    randomize(torch, model)
    g = torch.Generator(DEVICE).manual_seed(60)
    cond = torch.randn(cfg["context"], generator=g, device=DEVICE)
    uncond = torch.zeros(cfg["context"], device=DEVICE)
    schedule = dict(num_train_timesteps=1000, schedule="scaled_linear_beta", beta_start=0.0015,
                    beta_end=0.0205)

    def model_fn(x, t, context):
        return model(x, t, context=context)

    results = {}
    for name, sched, steps in (
            ("DDIM", schedulers.DDIMScheduler(clip_sample=False, **schedule), cfg["ddim_steps"]),
            ("DPM-Solver++", schedulers.DPMSolverMultistepScheduler(**schedule),
             cfg["dpm_steps"])):
        sched.set_timesteps(steps, device=DEVICE)
        seconds = []
        with torch.inference_mode():
            for _ in range(2):
                noise = torch.randn(cfg["latent"], generator=g, device=DEVICE)
                reset_launches(ops)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                image = guidance.sample_with_guidance(model_fn, sched, noise, cond, uncond,
                                                      guidance_scale=cfg["guidance"])
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                counts = read_launches(ops)
                if any(counts.values()):
                    raise AssertionError(f"CFG launched kernels: {counts}")
                if tuple(image.shape) != cfg["latent"] or not bool(torch.isfinite(image).all()):
                    raise AssertionError(f"bad guided sample {tuple(image.shape)}")
        log(f"cfg: sample_with_guidance, CXR UNet bf16 at {cfg['latent']}, context "
            f"{cfg['context']}, g={cfg['guidance']}, {name}-{steps}: {seconds[1]:.4f} s a chain "
            f"(warm-up {seconds[0]:.3f} s), 0 kernel launches")
        results[f"{name}-{steps}"] = seconds[1]
    model_f32 = build(None)
    model_f32.load_state_dict(model.state_dict(), strict=True)
    x = torch.randn(cfg["latent"], generator=g, device=DEVICE)
    t = torch.tensor(500, device=DEVICE)
    with torch.inference_mode():
        guided = guidance.guided_prediction(lambda a, b, c: model_f32(a, b, context=c), x, t,
                                            cond, uncond, cfg["guidance"])
        c = model_f32(x, t.expand(1), context=cond)
        u = model_f32(x, t.expand(1), context=uncond)
        want = u + cfg["guidance"] * (c - u)
        rel = ((guided - want).abs().max() / want.abs().max()).item()
    log(f"cfg: one guided prediction (doubled batch) vs uncond + g (cond - uncond) from two "
        f"forwards, f32: max|diff|/max {rel:.3e} (tol {FORWARD_RTOL:g})")
    if not rel <= FORWARD_RTOL:
        raise AssertionError("cfg: the guided prediction disagrees with its two forwards")
    del model, model_f32
    torch.cuda.empty_cache()
    return results


def ldm3d_expected(label: str) -> dict:
    """Every kernel's launches over one run of LDM3D_ARGS with `label`'s backward."""
    stage1, stage2 = LDM3D_LAUNCHES[label]
    n = LDM3D_STEPS
    total = {k: n["stage1"] * v for k, v in stage1.items()}
    for k, v in stage2.items():
        total[k] = total.get(k, 0) + n["stage2"] * v
    total["flash_fwd"] += 1 + 3 * n["sample"] + 1  # scale factor, sample steps, decode
    return expected_launches(**total)


def mean(xs) -> float:
    return sum(xs) / len(xs)


def run_ldm3d(torch, ops, ldm3d) -> dict:
    """Phase 10 (a): `recipes.train_3d_ldm.main` at 128^3 with each backward
    in f32, then in bf16 with the split backward: seconds per stage-1 step
    (the adversarial steps after the warm-up ones) and per stage-2 step (all
    but the first), host clock ending in a synchronize; peak memory; the
    launches of kernels 1-4 against what the attention blocks imply."""
    results = {}
    for label, flag, dtype in LDM3D_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(ops)
        t0 = time.perf_counter()
        with fused_backward(flag):
            out = ldm3d.main([*LDM3D_ARGS, "--dtype", dtype, "--device", DEVICE])
        seconds = time.perf_counter() - t0
        counts = read_launches(ops)
        peak = torch.cuda.max_memory_allocated() / 2**30
        s1 = out["stage1_seconds"][LDM3D_STEPS["warmup"]:]
        s2 = out["stage2_seconds"][1:]
        losses = [v for step in out["stage1_losses"] for v in step.values()]
        losses += out["stage2_losses"]
        log(f"ldm3d: recipe main at 128^3, batch 2, {dtype}, {label} backward: "
            f"{seconds:.2f} s in all; stage 1 {mean(s1):.4f} s a step (adversarial steps "
            + ", ".join(f"{x:.4f}" for x in s1) + f"; first step "
            f"{out['stage1_seconds'][0]:.4f}); stage 2 {mean(s2):.4f} s a step ("
            + ", ".join(f"{x:.4f}" for x in s2) + f"); scale factor {out['scale_factor']:.4f}; "
            f"peak memory {peak:.2f} GiB; stage-1 losses "
            + "; ".join(", ".join(f"{v:.4f}" for v in step.values())
                        for step in out["stage1_losses"])
            + "; stage-2 losses " + ", ".join(f"{x:.4f}" for x in out["stage2_losses"]))
        sample = out["sample"]
        if (not all(np.isfinite(losses)) or sample is None
                or tuple(sample.shape) != (1, 1, 128, 128, 128)
                or not bool(torch.isfinite(sample).all())):
            raise AssertionError(f"3D LDM recipe ({dtype}, {label}): losses or sample not finite")
        check_launches(counts, ldm3d_expected(label), f"3D LDM recipe, {dtype}, {label} backward")
        kernels = ("flash_bwd_fused",) if label == "fused" else ("flash_bwd_dq", "flash_bwd_dkv")
        attention_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
        log(f"ldm3d: {dtype}, {label} backward: bodies " + ", ".join(
            f"{kernel} {route_name(ops, attention_dtype, LDM3D_HEAD, False, kernel)}"
            for kernel in ("flash_fwd", *kernels)))
        results[f"{dtype}_{label}"] = dict(launches=counts, stage1_s=mean(s1), stage2_s=mean(s2),
                                           peak_gib=peak)
        del out, sample
    return results


def ldm3d_gradients(torch, ops, ldm3d, ldm2d, engines) -> None:
    """Phase 10 (b): one stage-1 generator step's parameter gradients at
    LDM3D_GRAD_SIZE^3 in f32, the recipe's models with the same weights,
    volume and latent draw: the split- and the fused-kernel paths against the
    plain attention path. The step runs whole (its D phase too) under SGD at
    lr 0; G's gradients stay in .grad after it."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        aekl, disc, _ = ldm3d.build_models()
        plain = ldm3d.build_models(use_flash_attention=False)[0]
    plain.load_state_dict(aekl.state_dict(), strict=True)
    aekl, plain, disc = (m.to(DEVICE).train() for m in (aekl, plain, disc))
    g = torch.Generator(DEVICE).manual_seed(9)
    x = ldm3d.synthetic_volume(g, 2, LDM3D_GRAD_SIZE, DEVICE)
    _, step = ldm2d.make_stage1_steps(1e-6, 0.01)

    def grads(model, flag: str, expected: dict, what: str) -> dict:
        state = engines.init_adversarial_state(
            model, torch.optim.SGD(model.parameters(), lr=0.0),
            disc, torch.optim.SGD(disc.parameters(), lr=0.0))
        reset_launches(ops)
        with fused_backward(flag):
            step(state, x, x, torch.Generator(DEVICE).manual_seed(10))
        torch.cuda.synchronize()
        check_launches(read_launches(ops), expected_launches(**expected), what)
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    what = f"3D LDM stage-1 step at {LDM3D_GRAD_SIZE}^3, f32"
    want = grads(plain, "0", {}, f"{what}, plain path")
    for label, flag in BACKWARDS:
        got = grads(aekl, flag, LDM3D_LAUNCHES[label][0], f"{what}, {label} backward")
        worst, worst_name = max_grad_diff(got, want)
        log(f"ldm3d: G gradients in f32 at {LDM3D_GRAD_SIZE}^3, {label}-kernel path vs plain "
            f"path: worst max|diff|/max|grad| = {worst:.3e} at {worst_name} (tol {GRAD_RTOL:g})")
        if not worst <= GRAD_RTOL:
            raise AssertionError(f"3D LDM G gradients, {label} backward, disagree with the plain "
                                 "path")
    del aekl, plain, disc, want, got
    torch.cuda.empty_cache()


def run_2d_stage1(torch, ops, vqgan, ldm2d) -> dict:
    """Phase 10 (c), (d): the VQ-GAN and 2D LDM recipes at their defaults;
    seconds a step after the first two, codebook usage; no kernel launch."""
    reset_launches(ops)
    out = vqgan.main([*VQGAN_ARGS, "--device", DEVICE])
    check_launches(read_launches(ops), expected_launches(), "VQ-GAN recipe")
    hist = out["outputs"]
    vq_s = mean(out["seconds"][2:])
    log(f"vqgan: recipe main at its defaults (VQ-VAE (128, 256), 256 codes of 32, batch 16, "
        f"64x64), {len(hist)} steps: {vq_s:.4f} s a step over steps 3-{len(hist)} (first "
        f"{out['seconds'][0]:.4f}); codebook usage {out['codebook_usage']} of 256 codes in the "
        f"last batch; last losses " + ", ".join(f"{k} {v:.4f}" for k, v in hist[-1].items()))
    if not all(np.isfinite(v) for h in hist for v in h.values()) or not out["codebook_usage"]:
        raise AssertionError("VQ-GAN recipe: losses not finite or no code used")
    reset_launches(ops)
    out = ldm2d.main([*LDM2D_ARGS, "--device", DEVICE])
    check_launches(read_launches(ops), expected_launches(), "2D LDM recipe")
    s1, s2 = mean(out["stage1_seconds"][2:]), mean(out["stage2_seconds"][1:])
    log(f"ldm2d: recipe main at its defaults (batch 16, 64x64): stage 1 {s1:.4f} s a step, "
        f"stage 2 {s2:.4f} s a step; scale factor {out['scale_factor']:.4f}; stage-2 losses "
        + ", ".join(f"{x:.4f}" for x in out["stage2_losses"]))
    losses = [v for step in out["stage1_losses"] for v in step.values()] + out["stage2_losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError("2D LDM recipe: losses not finite")
    return dict(vqgan_s=vq_s, ldm2d_stage1_s=s1, ldm2d_stage2_s=s2)


def profile_ldm3d(torch, ldm3d, ldm2d, engines) -> None:
    """Phase 10 (e): device time of one stage-1 G+D step at 128^3 in f32
    (split backward, Adam), by group and by kernel, the busy share of its
    wall time and its kernel count."""
    from torch.profiler import ProfilerActivity, profile

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        aekl, disc, _ = ldm3d.build_models()
    aekl, disc = aekl.to(DEVICE).train(), disc.to(DEVICE).train()
    state = engines.init_adversarial_state(aekl, torch.optim.Adam(aekl.parameters(), lr=1e-4),
                                           disc, torch.optim.Adam(disc.parameters(), lr=1e-4))
    _, step = ldm2d.make_stage1_steps(1e-6, 0.01)
    g = torch.Generator(DEVICE).manual_seed(11)
    x = ldm3d.synthetic_volume(g, 2, 128, DEVICE)
    for _ in range(2):
        state, _ = step(state, x, x, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, x, x, g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, LDM3D_PROFILE_GROUPS,
                   "ldm3d: profile of one stage-1 G+D step at 128^3, f32, split backward")
    del state, aekl, disc
    torch.cuda.empty_cache()


class TokenGrid:
    """A VQ-VAE stand-in for the greedy-chain check: its decode returns the
    sampled tokens themselves."""

    def __init__(self, num_embeddings: int) -> None:
        self.num_embeddings = num_embeddings

    def decode_samples(self, latent):
        return latent


def ar_tutorial_models(torch, nets, max_seq_len: int, seed: int = 0):
    """The tutorial's VQ-VAE and transformer on the card: weights from a
    seed, the transformer's drawn by `randomize`, BOS's logit bias -1e4 (a
    trained model never predicts BOS; with top_k=1 a leading BOS would leave
    nothing to draw)."""
    c = AR_TUTORIAL
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        vq = nets.VQVAE(
            spatial_dims=2, in_channels=1, out_channels=1, num_channels=c["vq_channels"],
            num_res_layers=2, num_res_channels=c["vq_channels"],
            downsample_parameters=((2, 4, 1, 1), (2, 4, 1, 1)),
            upsample_parameters=((2, 4, 1, 1, 0), (2, 4, 1, 1, 0)),
            num_embeddings=c["num_embeddings"], embedding_dim=32,
        )
        tr = nets.DecoderOnlyTransformer(
            num_tokens=c["num_embeddings"] + 1, max_seq_len=max_seq_len,
            attn_layers_dim=c["dim"], attn_layers_depth=c["depth"], attn_layers_heads=c["heads"],
        )
    randomize(torch, tr, seed + 1)
    with torch.no_grad():
        tr.to_logits.bias[c["num_embeddings"]] = -1e4
    return vq.to(DEVICE).eval(), tr.to(DEVICE).eval()


def ar_sample(torch, inferers, utils, vq, tr, grid: int, batch: int, seed: int, use_cache,
              top_k=None):
    """`VQVAETransformerInferer.sample` of a grid x grid token map from BOS."""
    ordering = utils.Ordering("raster_scan", 2, (1, grid, grid))
    start = torch.full((batch, 1), AR_TUTORIAL["num_embeddings"], device=DEVICE)
    return inferers.VQVAETransformerInferer().sample(
        (grid, grid), start, vq, tr, ordering, top_k=top_k,
        generator=torch.Generator(DEVICE).manual_seed(seed), use_cache=use_cache)


def timed_call(torch, call) -> tuple:
    """(output, host seconds, CUDA-event seconds) of one call, from and to an
    idle device."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = call()
    stop.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(stop) / 1e3


def greedy_chains_agree(torch, tr, a, b) -> tuple[bool, str]:
    """Two greedy token maps (raster order, so sampling order): equal, or
    first apart at a near-tie (top-2 logit gap of the windowed forward on
    the common prefix under 1e-4), which f32 rounding may break either way."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    if torch.equal(a, b):
        return True, "equal tokens"
    j = int((a != b).any(0).nonzero()[0])
    bos = torch.full((a.shape[0], 1), AR_TUTORIAL["num_embeddings"], device=a.device)
    with torch.no_grad():
        logits = tr(torch.cat([bos, a[:, :j]], 1))[:, -1, :AR_TUTORIAL["num_embeddings"]]
    top2 = logits.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1])[(a[:, j] != b[:, j])].min().item()
    return gap <= 1e-4, f"first apart at token {j}, top-2 gap {gap:.3e} there"


def run_ar_serving(torch, ops, nets, inferers, utils) -> dict:
    """Phase 11 (a): the tutorial config through `VQVAETransformerInferer.sample`:
    seconds a sample (host clock and CUDA events) on the windowed and the
    KV-cache paths at 256 tokens (batch 1 and 16) and 1024 tokens (batch 1),
    the over-length case (1024 tokens through max_seq_len 256, the windowed
    path by force), what `resolve_use_cache` picks at each, profiles of a
    256-token sample on each path (busy share), and a greedy windowed chain
    against a greedy cached chain. No kernel launches: head width 12."""
    from generativemodels_tpu_torch.inferers.vqvae_transformer import resolve_use_cache
    from torch.profiler import ProfilerActivity, profile

    results = {}
    reset_launches(ops)
    for grid, batch, warm in AR_TIMINGS:
        seq = grid * grid
        models = {"windowed": ar_tutorial_models(torch, nets, seq),
                  "cached": ar_tutorial_models(torch, nets, seq + 1)}
        runs = {path: [] for path in models}
        for rep in range(AR_REPEATS):
            order = ("windowed", "cached") if rep % 2 == 0 else ("cached", "windowed")
            for path in order:
                vq, tr = models[path]
                use_cache = path == "cached"
                with torch.inference_mode():
                    if warm and rep == 0:
                        ar_sample(torch, inferers, utils, vq, tr, grid, batch, 0, use_cache)
                    images, host, event = timed_call(torch, lambda: ar_sample(
                        torch, inferers, utils, vq, tr, grid, batch, 1 + rep, use_cache))
                if (tuple(images.shape) != (batch, 1, 4 * grid, 4 * grid)
                        or not bool(torch.isfinite(images).all())):
                    raise AssertionError(f"AR sample ({path}, {seq} tokens): bad output")
                runs[path].append((host, event))
                del images
        auto = resolve_use_cache(seq + 1, seq + 1, 1, models["cached"][1])
        for path, timed in runs.items():
            host, event = min(timed)
            results[(seq, batch, path)] = dict(host_s=host, event_s=event)
            log(f"ar: {path} path, {seq} tokens, batch {batch}, max_seq_len "
                f"{seq + (path == 'cached')}: best of {AR_REPEATS} {host:.4f} s a sample (host "
                f"clock; runs " + ", ".join(f"{h:.4f}" for h, _ in timed) + f"), {event:.4f} s "
                f"by CUDA events, {host / seq * 1e3:.3f} ms a token, {batch * 60 / host:.2f} "
                f"samples a minute; resolve_use_cache with the sequence fitting -> "
                f"{'cached' if auto else 'windowed'}")
        del models
    grid, batch, max_len = AR_OVERLENGTH
    vq, tr = ar_tutorial_models(torch, nets, max_len)
    seq = grid * grid
    if resolve_use_cache(seq + 1, max_len, 1, tr):
        raise AssertionError("resolve_use_cache takes the cache for an over-length sequence")
    with torch.inference_mode():
        images, host, event = timed_call(torch, lambda: ar_sample(
            torch, inferers, utils, vq, tr, grid, batch, 1, None))
    if not bool(torch.isfinite(images).all()):
        raise AssertionError("AR over-length sample not finite")
    results[(seq, batch, "overlength")] = dict(host_s=host, event_s=event)
    log(f"ar: over-length, {seq} tokens through max_seq_len {max_len} (auto: windowed, a "
        f"{max_len}-token window): {host:.4f} s a sample (host clock), {event:.4f} s by CUDA "
        f"events, {host / seq * 1e3:.3f} ms a token")
    check_launches(read_launches(ops), expected_launches(), "AR sampling, tutorial config")

    # the greedy chains, on one model (max_seq_len 257: the windowed path
    # re-forwards the growing prefix, the cached path decodes it)
    vq, tr = ar_tutorial_models(torch, nets, 257)
    stub = TokenGrid(AR_TUTORIAL["num_embeddings"])
    with torch.inference_mode():
        chains = [ar_sample(torch, inferers, utils, stub, tr, 16, 16, 0, c, top_k=1)
                  for c in (False, True)]
    ok, how = greedy_chains_agree(torch, tr, *chains)
    log(f"ar: greedy (top_k=1) chains, 256 tokens, batch 16, windowed against cached: {how}; "
        f"{int(torch.unique(chains[0]).numel())} distinct tokens -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("greedy windowed and cached chains disagree off a near-tie")

    device = {}
    for path, use_cache in (("windowed", False), ("cached", True)):
        with torch.inference_mode():  # warm: the greedy chains ran these shapes
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ar_sample(torch, inferers, utils, vq, tr, 16, 1, 1, use_cache)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        device[path] = report_profile(prof, wall, AR_PROFILE_GROUPS,
                                      f"ar: profile of one 256-token sample, batch 1, {path} path")
    pairs = [(results[(g * g, b, "windowed")]["host_s"], results[(g * g, b, "cached")]["host_s"],
              g * g, b) for g, b, _ in AR_TIMINGS]
    log("ar: resolve_use_cache on CUDA takes the cache whenever the sequence fits; windowed / "
        f"cached best seconds a sample of {AR_REPEATS}: " + ", ".join(
            f"{seq} tokens b{b} {w:.4f} / {c:.4f} ({w / c:.3f}x)" for w, c, seq, b in pairs)
        + "; a 256-token sample's device ms / kernels, windowed / cached: "
        f"{device['windowed'][0]:.3f} / {device['cached'][0]:.3f}, "
        f"{device['windowed'][1]} / {device['cached'][1]}")
    if any(c >= w for w, c in zip(device["windowed"], device["cached"])):
        raise AssertionError("a cached sample took no less device time or kernels than a "
                             "windowed one: resolve_use_cache's rule no longer holds on this card")
    del vq, tr, chains
    torch.cuda.empty_cache()
    return results


def run_ar_training(torch, ops, ar_recipe) -> dict:
    """Phase 11 (b): `recipes.train_vqvae_transformer.main` at its widths
    with --size 128 (1024 tokens of head width 32), with the split and the
    fused backward: seconds a step, peak memory, kernels 1-4 counted."""
    results = {}
    for label, flag in BACKWARDS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(ops)
        t0 = time.perf_counter()
        with fused_backward(flag):
            out = ar_recipe.main([*AR_RECIPE_ARGS, "--device", DEVICE])
        seconds = time.perf_counter() - t0
        counts = read_launches(ops)
        peak = torch.cuda.max_memory_allocated() / 2**30
        s1, s2 = mean(out["stage1_seconds"][1:]), mean(out["stage2_seconds"][1:])
        ll = out["likelihood"]
        log(f"ar: recipe main at --size 128 (1024 tokens), batch 16, f32, {label} backward: "
            f"{seconds:.2f} s in all; stage 1 {s1:.4f} s a step, stage 2 {s2:.4f} s a step ("
            + ", ".join(f"{x:.4f}" for x in out["stage2_seconds"]) + f"); peak memory "
            f"{peak:.2f} GiB; perplexity {out['perplexities'][-1]:.1f}; stage-2 NLL "
            + ", ".join(f"{x:.4f}" for x in out["stage2_losses"])
            + f"; likelihood map {tuple(ll.shape)} mean {float(ll.mean()):.4f}")
        losses = out["stage1_losses"] + out["stage2_losses"]
        grid = int(AR_RECIPE_ARGS[AR_RECIPE_ARGS.index("--size") + 1]) // 4
        if (not all(np.isfinite(losses)) or tuple(ll.shape) != (2, grid, grid)
                or not bool(torch.isfinite(ll).all()) or float(ll.max()) > 0):
            raise AssertionError(f"AR recipe ({label}): losses or likelihood map wrong")
        check_launches(counts, expected_launches(**AR_LAUNCHES[label]),
                       f"AR recipe, {label} backward")
        if not (counts["flash_fwd"] > 0 and counts["flash_bwd_dq" if label == "split"
                                                    else "flash_bwd_fused"] > 0):
            raise AssertionError("the AR recipe ran no causal flash kernel")
        results[label] = dict(launches=counts, stage1_s=s1, stage2_s=s2, peak_gib=peak)
        del out, ll
    return results


def ar_gradients_and_likelihood(torch, ops, ar_recipe, inferers, utils, ddpm) -> None:
    """Phase 11 (c), (d): one stage-2 step's parameter gradients at 1024
    tokens (seeded weights, batch AR_GRAD_BATCH) on the split- and the
    fused-kernel paths against the plain attention path; `get_likelihood` at
    1024 tokens, the kernel path against the plain path."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        vq, tr = ar_recipe.build_models(128)
        plain = ar_recipe.build_models(128, use_flash_attention=False)[1]
    randomize(torch, tr, 5)
    plain.load_state_dict(tr.state_dict(), strict=True)
    vq, tr, plain = vq.to(DEVICE).eval(), tr.to(DEVICE).train(), plain.to(DEVICE).train()
    x = ddpm.synthetic_batch(torch.Generator(DEVICE).manual_seed(3), AR_GRAD_BATCH, 128, DEVICE)
    ordering = utils.Ordering("raster_scan", 2, (1, 32, 32))
    inferer = inferers.VQVAETransformerInferer()

    def grads(model, flag: str, expected: dict, what: str) -> dict:
        model.zero_grad(set_to_none=True)
        reset_launches(ops)
        with fused_backward(flag):
            ar_recipe.stage2_loss(inferer, vq, model, ordering, x, None).backward()
        torch.cuda.synchronize()
        check_launches(read_launches(ops), expected_launches(**expected), what)
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    what = f"AR stage-2 step at 1024 tokens, batch {AR_GRAD_BATCH}, f32"
    want = grads(plain, "0", {}, f"{what}, plain path")
    per_step = {"split": dict(flash_fwd=4, flash_bwd_dq=4, flash_bwd_dkv=4),
                "fused": dict(flash_fwd=4, flash_bwd_fused=4)}
    for label, flag in BACKWARDS:
        got = grads(tr, flag, per_step[label], f"{what}, {label} backward")
        worst, worst_name = max_grad_diff(got, want)
        log(f"ar: stage-2 gradients at 1024 tokens, {label}-kernel path vs plain path: worst "
            f"max|diff|/max|grad| = {worst:.3e} at {worst_name} (tol {GRAD_RTOL:g}); "
            f"relative norm {grad_norm_diff(got, want):.3e}")
        if not worst <= GRAD_RTOL:
            raise AssertionError(f"AR stage-2 gradients, {label} backward, disagree with the "
                                 "plain path")
    tr.eval(), plain.eval()
    reset_launches(ops)
    got = inferer.get_likelihood(x, vq, tr, ordering)
    torch.cuda.synchronize()
    check_launches(read_launches(ops), expected_launches(flash_fwd=4), "AR likelihood")
    want = inferer.get_likelihood(x, vq, plain, ordering)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"ar: get_likelihood at 1024 tokens, batch {AR_GRAD_BATCH}, kernel path vs plain path: "
        f"max|diff|/max|ll| = {rel:.3e} (tol {LIKELIHOOD_RTOL:g}); mean log-prob "
        f"{float(want.mean()):.4f}")
    if not rel <= LIKELIHOOD_RTOL:
        raise AssertionError("AR likelihood on the kernels disagrees with the plain path")
    del vq, tr, plain, want, got
    torch.cuda.empty_cache()


def run_spade(torch, ops, spade_vae, spade_ldm) -> dict:
    """Phase 12: `recipes.train_spade_vae.main` and `train_spade_ldm.main`
    (with --sample) at their defaults for a few steps: seconds a step, peak
    memory, no kernel launch; then one forward of the LDM recipe's SPADE UNet
    (seeded weights) on the card against the same forward on the CPU."""
    results = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    out = spade_vae.main([*SPADE_VAE_ARGS, "--device", DEVICE])
    check_launches(read_launches(ops), expected_launches(), "SPADE VAE-GAN recipe")
    hist, sample = out["outputs"], out["sample"]
    results["vae_s"] = mean(out["seconds"][2:])
    results["vae_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"spade: VAE-GAN recipe main at its defaults (SPADENet (16, 32, 64), z 32, two-scale "
        f"PatchGAN, batch 8, 64x64), {len(hist)} steps: {results['vae_s']:.4f} s a step over "
        f"steps 3-{len(hist)} (first {out['seconds'][0]:.4f}); peak memory "
        f"{results['vae_peak_gib']:.2f} GiB; last losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in hist[-1].items()))
    if (not all(np.isfinite(v) for h in hist for v in h.values()) or sample is None
            or tuple(sample.shape) != (2, 1, 64, 64) or not bool(torch.isfinite(sample).all())):
        raise AssertionError("SPADE VAE-GAN recipe: losses or synthesis not finite")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    t0 = time.perf_counter()
    out = spade_ldm.main([*SPADE_LDM_ARGS, "--device", DEVICE])
    seconds = time.perf_counter() - t0
    check_launches(read_launches(ops), expected_launches(), "SPADE LDM recipe")
    warm = int(SPADE_LDM_ARGS[SPADE_LDM_ARGS.index("--warmup-steps") + 1])
    results["ldm_stage1_s"] = mean(out["stage1_seconds"][warm:])
    results["ldm_stage2_s"] = mean(out["stage2_seconds"][1:])
    results["ldm_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    sample = out["sample"]
    log(f"spade: LDM recipe main at its defaults (SPADE AEKL (32, 64, 64), PatchGAN 32, SPADE "
        f"UNet (64, 128), batch 8, 64x64) with --sample (DDPM, 1000 steps, batch 2): "
        f"{seconds:.2f} s in all; stage 1 {results['ldm_stage1_s']:.4f} s an adversarial step, "
        f"stage 2 {results['ldm_stage2_s']:.4f} s a step; scale factor "
        f"{out['scale_factor']:.4f}; peak memory {results['ldm_peak_gib']:.2f} GiB; stage-2 "
        f"losses " + ", ".join(f"{x:.4f}" for x in out["stage2_losses"]))
    losses = [v for step in out["stage1_losses"] for v in step.values()] + out["stage2_losses"]
    if (not all(np.isfinite(losses)) or sample is None or tuple(sample.shape) != (2, 1, 64, 64)
            or not bool(torch.isfinite(sample).all())):
        raise AssertionError("SPADE LDM recipe: losses or sample not finite")
    del out, sample

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        unet = spade_ldm.build_models()[2]
    randomize(torch, unet, 7)
    g = torch.Generator("cpu").manual_seed(8)
    z = torch.randn((8, 3, 16, 16), generator=g)
    _, seg = spade_ldm.synthetic_seg_batch(g, 8, 64)
    t = torch.randint(0, 1000, (8,), generator=g)
    with torch.no_grad():
        want = unet.eval()(z, t, seg)
        got = unet.to(DEVICE)(z.to(DEVICE), t.to(DEVICE), seg.to(DEVICE)).cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"spade: SPADE UNet forward (the LDM recipe's, seeded weights, batch 8, 16x16 latent, "
        f"64x64 seg), card vs CPU, f32: max|diff|/max|out| = {rel:.3e} (tol {SPADE_RTOL:g})")
    if not rel <= SPADE_RTOL:
        raise AssertionError("SPADE UNet forward on the card disagrees with the CPU")
    return results


def write_png(path: str, image: np.ndarray) -> None:
    """A grey PNG, 16-bit for a uint16 array and 8-bit otherwise, written with
    the standard library's zlib (the card has no image library to rely on)."""
    import struct
    import zlib

    height, width = image.shape
    depth = 16 if image.dtype == np.uint16 else 8
    rows = image.astype(">u2" if depth == 16 else np.uint8)
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(height))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def write_nifti_gz(native, path: str, array: np.ndarray) -> None:
    """`native.write_nifti`'s file at `path` (ending in .gz), gzipped."""
    import gzip
    import shutil

    plain = path[: -len(".gz")]
    native.write_nifti(plain, array)
    with open(plain, "rb") as f, gzip.open(path, "wb", compresslevel=1) as g:
        shutil.copyfileobj(f, g)
    os.remove(plain)


def first_values(data, directory: str, **kwargs) -> list[int]:
    """The first voxel of each sample of one pass of `file_dataset`, in the order it yields them."""
    return [int(round(float(a.flat[0]))) for a in
            data.file_dataset(directory, loop=False, num_workers=LOADER_WORKERS, **kwargs)]


def run_loader(torch, data, native, root: str) -> dict:
    """Phase 13 (a): build the port's loader, then read LOADER_FILES files with
    LOADER_WORKERS workers LOADER_EPOCHS times in file order, the seeded
    shuffle order, .npy and PNG files, and the brain bundle's volumes for
    volumes a second. Returns the volumes' directory."""
    t0 = time.perf_counter()
    lib_path = native.build_library()
    decoders = native.load_library().gmtpu_decoders()
    log(f"loader: built {lib_path.name} with g++ in {time.perf_counter() - t0:.2f} s; decoders: "
        f"PNG {'yes' if decoders & 1 else 'no (png.h missing)'}, "
        f"JPEG {'yes' if decoders & 2 else 'no (jpeglib.h missing)'}")

    order_dir = os.path.join(root, "order")
    os.makedirs(order_dir)
    for i in range(LOADER_FILES):
        native.write_nifti(os.path.join(order_dir, f"v{i:03d}.nii"),
                           np.full(LOADER_SHAPE, i, np.float32))
    want = list(range(LOADER_FILES))
    t0 = time.perf_counter()
    for epoch in range(LOADER_EPOCHS):
        got = first_values(data, order_dir)
        if got != want:
            raise AssertionError(f"loader epoch {epoch}: files out of order: {got}")
    seconds = time.perf_counter() - t0
    stream = data.file_dataset(order_dir, shuffle=True, seed=5, num_workers=LOADER_WORKERS)
    for epoch in range(3):
        order = list(range(LOADER_FILES))
        np.random.RandomState(5 + epoch).shuffle(order)
        got = [int(round(float(next(stream).flat[0]))) for _ in range(LOADER_FILES)]
        if got != order:
            raise AssertionError(f"loader, shuffled epoch {epoch}: not the seeded order: {got}")
    stream.close()
    log(f"loader: {LOADER_FILES} NIfTI files {LOADER_SHAPE} x {LOADER_EPOCHS} epochs with "
        f"{LOADER_WORKERS} workers in file order every time ({seconds:.3f} s), and 3 shuffled "
        f"epochs in RandomState(5 + epoch)'s order")

    npy_dir = os.path.join(root, "npy")
    os.makedirs(npy_dir)
    for i in range(LOADER_FILES):
        np.save(os.path.join(npy_dir, f"x{i:03d}.npy"), np.full((8, 8), i, np.float32))
    if first_values(data, npy_dir) != want:
        raise AssertionError(".npy files out of order")

    png_dir = os.path.join(root, "png")
    os.makedirs(png_dir)
    for i in range(LOADER_FILES):
        write_png(os.path.join(png_dir, f"a{i:03d}.png"), np.full((8, 8), i, np.uint8))
        write_png(os.path.join(png_dir, f"b{i:03d}.png"), np.full((8, 8), 1000 * i, np.uint16))
    # a family whose decoder was not built reads through PIL with the native
    # decoder's scaling: the same values either way
    route = native.decoder_routes()["png"]
    got = [float(a.flat[0]) for a in data.file_dataset(png_dir, loop=False,
                                                      num_workers=LOADER_WORKERS)]
    expect = [np.float32(i) * np.float32(1 / 255) for i in want] + [
        np.float32(1000 * i) * np.float32(1 / 65535) for i in want]
    if got != expect:
        raise AssertionError(f"8- and 16-bit PNGs decoded out of order or wrong ({route})")
    log(f"loader: {2 * LOADER_FILES} 8- and 16-bit grey PNGs decoded in file order through the "
        f"{route} route")

    # smooth volumes (a product of cosines, a phase per volume) with the
    # volume's index in the first voxel: cheap to make, and they compress
    # as MR volumes do, unlike noise
    axes = np.meshgrid(*(np.linspace(0, 6, n, dtype=np.float32) for n in BRAIN_VOLUME),
                       indexing="ij", sparse=True)
    dirs = {kind: os.path.join(root, f"brain_{kind}") for kind in ("nii", "nii.gz")}
    t0 = time.perf_counter()
    for kind, directory in dirs.items():
        os.makedirs(directory)
        for i in range(BRAIN_VOLUMES):
            volume = np.round(
                512 * (1 + np.cos(axes[0] + i) * np.cos(axes[1]) * np.cos(axes[2] - i)))
            volume.flat[0] = i
            path = os.path.join(directory, f"brain{i:02d}.{kind}")
            if kind == "nii":
                native.write_nifti(path, volume)
            else:
                write_nifti_gz(native, path, volume)
    log(f"loader: wrote {BRAIN_VOLUMES} volumes {BRAIN_VOLUME} float32 as .nii and .nii.gz "
        f"in {time.perf_counter() - t0:.2f} s")
    rates = {}
    for kind, directory in dirs.items():
        t0 = time.perf_counter()
        for _ in range(THROUGHPUT_EPOCHS):
            if first_values(data, directory) != list(range(BRAIN_VOLUMES)):
                raise AssertionError(f"brain volumes ({kind}) out of order")
        seconds = time.perf_counter() - t0
        rates[kind] = THROUGHPUT_EPOCHS * BRAIN_VOLUMES / seconds
        log(f"loader: {THROUGHPUT_EPOCHS} epochs of {BRAIN_VOLUMES} {kind} volumes {BRAIN_VOLUME} "
            f"with {LOADER_WORKERS} workers in {seconds:.3f} s: {rates[kind]:.2f} volumes a "
            f"second ({rates[kind] * np.prod(BRAIN_VOLUME) * 4 / 1e9:.3f} GB/s of float32 out)")
    return dict(volumes=dirs["nii"], rates=rates)


def profiled_run(torch, fn) -> tuple:
    """(fn(), wall seconds, the device's busy share of them): fn under
    torch.profiler (CUDA activity), host clock ending in a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_s = sum(e.device_time_total for e in prof.key_averages()) / 1e6
    if device_s == 0:
        raise AssertionError("the profiler saw no device time")
    return out, wall, device_s / wall


def write_slices(native, root: str) -> str:
    """DISK_FILES gzipped NIfTI slices of DISK_EDGE^2 in `root`/slices, whose path
    it returns."""
    image_dir = os.path.join(root, "slices")
    os.makedirs(image_dir)
    rng = np.random.default_rng(14)
    t0 = time.perf_counter()
    for i in range(DISK_FILES):
        write_nifti_gz(native, os.path.join(image_dir, f"slice{i:03d}.nii.gz"),
                       rng.integers(0, 4096, (DISK_EDGE, DISK_EDGE)).astype(np.float32))
    log(f"disk: wrote {DISK_FILES} gzipped NIfTI slices {DISK_EDGE}x{DISK_EDGE} in "
        f"{time.perf_counter() - t0:.2f} s")
    return image_dir


def run_disk_training(torch, ops, native, recipe, utils, root: str, synthetic_sps: float) -> dict:
    """Phase 13 (b): `recipes.train_2d_ddpm.main` at its defaults from gzipped
    NIfTI slices on disk (--fit crop_pad --augment --cache --checkpoint-dir),
    kernels 1-3 counted; the same run on synthetic blobs; steps/s and the
    busy share of each; the checkpoint's save and restore timed."""
    image_dir = write_slices(native, root)
    ckpt = os.path.join(root, "ckpt")
    runs = {}
    for label, argv in (("disk", [*DISK_ARGS, "--data-dir", image_dir, "--checkpoint-dir", ckpt]),
                        ("synthetic", ["--steps", str(DISK_STEPS)])):
        torch.cuda.empty_cache()
        reset_launches(ops)
        out, wall, busy = profiled_run(torch, lambda: recipe.main([*argv, "--device", DEVICE]))
        check_launches(read_launches(ops), expected_launches(
            DISK_STEPS, flash_fwd=3, flash_bwd_dq=3, flash_bwd_dkv=3), f"2D recipe, {label} data")
        if not all(np.isfinite(out["losses"])):
            raise AssertionError(f"2D recipe on {label} data: losses not finite")
        runs[label] = dict(out=out, sps=out["steps_per_sec"], busy=busy, wall=wall)
    log(f"disk: 2D recipe at its defaults (f32, UNet (128, 256, 256), 64x64, batch 64), "
        f"{DISK_STEPS} steps each, profiled: from disk ({' '.join(DISK_ARGS[2:])}) "
        f"{runs['disk']['sps']:.3f} steps/s over steps 3-{DISK_STEPS}, busy share "
        f"{runs['disk']['busy']:.3f} of the run's {runs['disk']['wall']:.2f} s (the cache's "
        f"decode included); synthetic blobs {runs['synthetic']['sps']:.3f} steps/s, busy "
        f"{runs['synthetic']['busy']:.3f} of {runs['synthetic']['wall']:.2f} s; phase 4's "
        f"unprofiled synthetic run {synthetic_sps:.3f} steps/s")
    del runs["synthetic"]

    mgr = utils.CheckpointManager(ckpt)
    if mgr.all_steps() != [DISK_STEPS]:
        raise AssertionError(f"checkpoint steps {mgr.all_steps()}, expected [{DISK_STEPS}]")
    model = runs["disk"]["out"]["state"].model
    timing = utils.CheckpointManager(os.path.join(root, "ckpt_timing"))
    params = model.state_dict()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timing.save(1, {"params": params, "step": 1})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = timing.restore(template={"params": params, "step": 0})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(timing.directory, "step_1.pt"))
    if restored["step"] != 1 or any(not torch.equal(restored["params"][k], v)
                                    for k, v in params.items()):
        raise AssertionError("checkpoint restore differs from what was saved")
    log(f"disk: checkpoint of the UNet ({nbytes / 2**20:.1f} MiB): save {save_s:.3f} s (card to "
        f"file), restore {restore_s:.3f} s (file to card), equal to the bit")
    return dict(ckpt=ckpt, image_dir=image_dir, model=model, sps=runs["disk"]["sps"],
                busy=runs["disk"]["busy"], save_s=save_s, restore_s=restore_s)


def run_checkpoint_serving(torch, ops, serve, inferers, schedulers, ckpt: str, model) -> dict:
    """Phase 13 (c): `serve.build_sampler(checkpoint_dir=...)` behind the HTTP
    server, one DDIM-50 request of SERVE's batch for each of CKPT_SEEDS,
    kernel 1 counted; each request's images equal to an in-process sample
    of the trained model from the same noise."""
    sampler, shape = serve.build_sampler(device=DEVICE, checkpoint_dir=ckpt, **SERVE)
    state = serve._SamplerState(sampler, shape)
    httpd = serve.start_server(state, port=0)
    try:
        reset_launches(ops)
        served, seconds = [], []
        for seed in CKPT_SEEDS:
            t0 = time.perf_counter()
            served.append(post_sample(httpd.server_port, seed, shape[0]))
            seconds.append(time.perf_counter() - t0)
        counts = read_launches(ops)
    finally:
        httpd.shutdown()
        httpd.server_close()
    check_launches(counts, expected_launches(
        len(CKPT_SEEDS), flash_fwd=LAUNCHES_PER_FORWARD * SERVE["ddim_steps"]),
        "serving the checkpoint")
    ddim = schedulers.DDIMScheduler(num_train_timesteps=1000, device=DEVICE)
    ddim.set_timesteps(SERVE["ddim_steps"])
    inferer = inferers.DiffusionInferer(ddim)
    model.eval()
    for seed, img in zip(CKPT_SEEDS, served):
        g = torch.Generator(DEVICE).manual_seed(seed)
        noise = torch.randn(shape, generator=g, device=DEVICE)
        with torch.inference_mode():
            want = inferer.sample(noise, model, generator=g).cpu().numpy()
        if img.shape != shape or not np.isfinite(img).all() or not np.array_equal(img, want):
            raise AssertionError(f"served images (seed {seed}) differ from the in-process "
                                 f"sample: max|diff| {np.abs(img - want).max():.3e}")
    log(f"serve: checkpoint served over HTTP, {len(CKPT_SEEDS)} DDIM-{SERVE['ddim_steps']} "
        f"requests of batch {shape[0]} in " + ", ".join(f"{s:.3f}" for s in seconds)
        + " s; each equal to the bit to an in-process sample of the trained weights")
    return dict(seconds=seconds, launches=counts)


def run_eval_quality(torch, ops, eval_quality, metrics, image_dir: str, root: str) -> dict:
    """Phase 13 (d): `recipes.eval_quality.main` at its defaults with
    EVAL_TRAIN_STEPS train steps on (b)'s slices, kernels 1-3 counted; its FID
    and MS-SSIM computed on the card and on the CPU from the same features
    and images."""
    import warnings

    reset_launches(ops)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the trunk's random weights, known
        out = eval_quality.main([*EVAL_QUALITY_ARGS, "--data-dir", image_dir, "--out",
                                 os.path.join(root, "quality.json"), "--device", DEVICE])
        seconds = time.perf_counter() - t0
        counts = read_launches(ops)
        sample_forwards = -(-EVAL_SAMPLE["count"] // EVAL_SAMPLE["batch"]) * EVAL_SAMPLE["steps"]
        per = LAUNCHES_PER_FORWARD
        check_launches(counts, expected_launches(
            flash_fwd=per * (EVAL_TRAIN_STEPS + sample_forwards),
            flash_bwd_dq=per * EVAL_TRAIN_STEPS, flash_bwd_dkv=per * EVAL_TRAIN_STEPS),
            "eval_quality")
        real, samples = out["real"], out["samples"]
        if (tuple(samples.shape) != (EVAL_SAMPLE["count"], 1, 64, 64)
                or not bool(torch.isfinite(samples).all()) or not np.isfinite(out["fid"])):
            raise AssertionError("eval_quality: samples or FID not finite, or wrong shape")
        features = eval_quality.make_feature_extractor(device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_samples, f_real = features(samples), features(real)
    torch.cuda.synchronize()
    features_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid_card = float(metrics.FIDMetric()(f_samples, f_real))
    fid_s = time.perf_counter() - t0
    fid_cpu = float(metrics.FIDMetric()(f_samples.cpu(), f_real.cpu()))
    torch.backends.cuda.matmul.allow_tf32 = True  # the limit's yardstick, printed only
    try:
        fid_tf32 = float(metrics.FIDMetric()(f_samples, f_real))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ms_card = float(eval_quality.diversity_ms_ssim(samples))
    ms_s = time.perf_counter() - t0
    ms_cpu = float(eval_quality.diversity_ms_ssim(samples.cpu()))
    fid_rel = abs(fid_card - fid_cpu) / abs(fid_cpu)
    tf32_rel = abs(fid_tf32 - fid_cpu) / abs(fid_cpu)
    log(f"eval_quality: defaults (UNet (64, 128, 128) bf16, 64x64, batch 64), "
        f"{EVAL_TRAIN_STEPS} train steps from disk, {EVAL_SAMPLE['count']} DDIM-"
        f"{EVAL_SAMPLE['steps']} samples: {seconds:.2f} s in all (train {out['train_seconds']} s, "
        f"sample {out['sample_seconds']} s); result fid {out['fid']:.6f}, ms_ssim_diversity "
        f"{out['ms_ssim_diversity']:.6f}; ResNet50 features of both sets {features_s:.3f} s, FID "
        f"{fid_s:.3f} s, MS-SSIM {ms_s:.3f} s on the card; card vs CPU on the same "
        f"(64, 2048) features: FID {fid_card:.6f} vs {fid_cpu:.6f} (rel {fid_rel:.2e}, tol "
        f"{FID_RTOL:g}; with TF32 matmuls on the card {fid_tf32:.6f}, rel {tf32_rel:.2e}); "
        f"on the same images: MS-SSIM {ms_card:.7f} vs {ms_cpu:.7f} (|diff| "
        f"{abs(ms_card - ms_cpu):.2e}, tol {MSSSIM_ATOL:g})")
    if not fid_rel <= FID_RTOL:
        raise AssertionError("FID on the card disagrees with the CPU's")
    if not abs(ms_card - ms_cpu) <= MSSSIM_ATOL:
        raise AssertionError("MS-SSIM on the card disagrees with the CPU's")
    return dict(seconds=seconds, fid_s=fid_s, ms_s=ms_s, fid_rel=fid_rel, tf32_rel=tf32_rel,
                ms_diff=abs(ms_card - ms_cpu))


def run_eval_brain(torch, ops, eval_brain, volume_dir: str, root: str) -> dict:
    """Phase 13 (e): `recipes.eval_brain_ldm.main` at full width (the preset's
    UNet (256, 512, 768) and AEKL, bf16), DDIM-50 to 160x224x160, FID on
    (a)'s volumes: seconds a sample, the metrics' seconds, peak memory; no
    kernel on its path (head widths 512 and 768, kernel 5 off)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    t0 = time.perf_counter()
    out = eval_brain.main([*EVAL_BRAIN_ARGS, "--data-dir", volume_dir, "--out",
                           os.path.join(root, "brain.json"), "--device", DEVICE])
    seconds = time.perf_counter() - t0
    check_launches(read_launches(ops), expected_launches(), "eval_brain_ldm")
    peak = torch.cuda.max_memory_allocated() / 2**30
    timing = out["seconds"]
    log(f"eval_brain_ldm: full width, bf16, {out['sample_count']} + 2 x "
        f"{out['same_cond_pairs']} samples DDIM-{out['ddim_steps']} to {out['out_shape'][2:]}: "
        f"{seconds:.2f} s in all, {timing['sample']:.3f} s a sample, 3D MS-SSIM "
        f"{timing['msssim']:.3f} s, FID (ResNet10 features of 4 + 4 volumes) {timing['fid']:.3f} "
        f"s; peak memory {peak:.2f} GiB; msssim {out['msssim']:.6f}, msssim_4g "
        f"{out['msssim_4g']:.6f}, fid {out['fid']:.6f}")
    values = (out["msssim"], out["msssim_4g"], out["fid"])
    if (out["out_shape"] != [4, 1, *BRAIN_VOLUME] or not all(np.isfinite(values))
            or not -1 <= out["msssim"] <= 1 or not -1 <= out["msssim_4g"] <= 1
            or not bool(torch.isfinite(out["diverse"]).all())):
        raise AssertionError("eval_brain_ldm: wrong shape or metrics out of range")
    return dict(seconds=seconds, sample_s=timing["sample"], peak_gib=peak)


def run_data_path(torch, ops, recipe, serve, inferers, schedulers, synthetic_sps: float) -> dict:
    """Phase 13: the loader (a), training from disk with a checkpoint (b),
    serving that checkpoint (c), and the two eval recipes (d, e), in a
    temporary directory removed afterwards."""
    import shutil
    import tempfile

    from generativemodels_tpu_torch import data, metrics, utils
    from generativemodels_tpu_torch.data import native
    from generativemodels_tpu_torch.recipes import eval_brain_ldm as eval_brain
    from generativemodels_tpu_torch.recipes import eval_quality

    os.environ["GMTPU_FUSED_RESBLOCK"] = "0"  # kernel 5 off, as the recipes' default
    os.environ.pop("GMTPU_FLASH_FUSED_BWD", None)
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        loaded = run_loader(torch, data, native, root)
        disk = run_disk_training(torch, ops, native, recipe, utils, root, synthetic_sps)
        served = run_checkpoint_serving(torch, ops, serve, inferers, schedulers, disk["ckpt"],
                                        disk["model"])
        del disk["model"]
        quality = run_eval_quality(torch, ops, eval_quality, metrics, disk["image_dir"], root)
        brain = run_eval_brain(torch, ops, eval_brain, loaded["volumes"], root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(loader=loaded["rates"], disk=disk, served=served, quality=quality, brain=brain)


def opcheck_ops(torch, ops) -> None:
    """Phase 2 (h): kernels 1-5 as `gmtpu_torch` custom ops, each through
    `torch.library.opcheck` on CUDA tensors (schema, fake implementation,
    autograd registration, a traced run against the kernel's own output)."""
    g = torch.Generator().manual_seed(60)

    def qkv(dtype, sq=256, sk=192, d=64):
        return tuple(torch.randn(2, s, d, generator=g).to(DEVICE, dtype).requires_grad_()
                     for s in (sq, sk, sk))

    checked = 0
    for dtype, causal, upcast, no_max in ((torch.float32, False, False, True),
                                          (torch.bfloat16, True, False, True),
                                          (torch.float32, False, False, False),
                                          (torch.bfloat16, False, True, False)):
        q, k, v = qkv(dtype)
        torch.library.opcheck(ops.flash_fwd, (q, k, v, 0.125, causal, upcast, no_max,
                                              not upcast))
        checked += 1
    from generativemodels_tpu_torch.ops.flash_attention import _backward_rows, _prescaled

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.detach() for t in qkv(dtype))
        out, lse = ops.flash_fwd(q, k, v, 0.125, False, False, True, True)
        dout, delta = _backward_rows(out, torch.randn(out.shape, generator=g).to(DEVICE, dtype))
        args = (_prescaled(q, 0.125), k, v, dout, lse, delta, False, False, True, 1.0)
        for op in (ops.flash_bwd_dq, ops.flash_bwd_dkv, ops.flash_bwd_fused):
            torch.library.opcheck(op, args)
            checked += 1
    for channels_first in (False, True):
        x = torch.randn((1, 32, 8, 8, 16) if channels_first else (1, 8, 8, 16, 32), generator=g)
        x = x.to(DEVICE, torch.bfloat16)
        x = x.permute(0, 2, 3, 4, 1) if channels_first else x
        w = (0.05 * torch.randn(3, 3, 3, 32, 48, generator=g)).to(DEVICE)
        affine = [torch.randn(1, 32, generator=g).to(DEVICE) for _ in range(2)]
        bias = torch.randn(48, generator=g).to(DEVICE)
        res = torch.randn(1, 8, 8, 16, 48, generator=g).to(DEVICE, torch.bfloat16)
        args = [t.requires_grad_() for t in (x, w, *affine, bias, res)]
        # the traced run is held to the bf16 output's rounding
        torch.library.opcheck(ops.fused_conv3d, (*args, True), atol=2e-2, rtol=2e-2)
        checked += 1
    log(f"kernels: {checked} opcheck cases passed on CUDA for the gmtpu_torch ops "
        f"(flash_fwd in four contracts, flash_bwd_dq/dkv/fused in f32 and bf16, fused_conv3d "
        f"channels-last and channels-first)")


def export_2d(torch, ops, serve, root: str) -> dict:
    """Phase 14 (b): the 2D serving sampler at full width exported to a .pt2
    file and served in process, with the in-process sampler's images to the
    bit and its kernel-1 launches; then `recipes.serve --export-path
    --oneshot` started on the file in a separate process (checked by
    `check_served_export`)."""
    sampler, shape = serve.build_sampler(device=DEVICE, **dict(SERVE, ddim_steps=EXPORT_DDIM_2D))
    randomize(torch, sampler.model)
    reset_launches(ops)
    want = sampler(EXPORT_SEED)
    torch.cuda.synchronize()
    in_process = read_launches(ops)["flash_fwd"]
    path = os.path.join(root, "sampler_2d.pt2")
    t0 = time.perf_counter()
    exported = serve.export_sampler(sampler, path)
    export_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    reset_launches(ops)
    got = exported(EXPORT_SEED)
    torch.cuda.synchronize()
    served = read_launches(ops)["flash_fwd"]
    seconds = {"in-process": [], "exported": []}
    for _ in range(2):
        for label, fn in (("in-process", sampler), ("exported", exported)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(EXPORT_SEED)
            torch.cuda.synchronize()
            seconds[label].append(time.perf_counter() - t0)
    expected = LAUNCHES_PER_FORWARD * EXPORT_DDIM_2D
    log(f"export: 2D sampler {shape} DDIM-{EXPORT_DDIM_2D} exported in {export_s:.1f} s "
        f"to {size} bytes ({len(exported.fn.program.graph.nodes)} graph nodes); kernel-1 "
        f"launches a request: in process {in_process}, exported {served} (expected {expected}); "
        f"seconds a request, best of 2: in process {min(seconds['in-process']):.4f}, exported "
        f"{min(seconds['exported']):.4f}")
    if not torch.equal(got, want):
        raise AssertionError(f"exported 2D sampler: images differ from the in-process sampler's "
                             f"by {(got - want).abs().max().item():.3e}")
    if in_process != expected or served != expected:
        raise AssertionError(f"export 2D: kernel-1 launches {in_process} / {served}, "
                             f"expected {expected}")
    # a separate process serves the file (it must build no network); it
    # loads the file while the phase goes on, and `check_served_export` waits
    out = os.path.join(root, "served.npy")
    code = (
        "import sys\n"
        "from generativemodels_tpu_torch.networks.nets import diffusion_model_unet as d\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a network was built')\n"
        "d.DiffusionModelUNet.__init__ = refuse\n"
        "from generativemodels_tpu_torch import ops\n"
        "from generativemodels_tpu_torch.recipes import serve\n"
        "serve.main(sys.argv[1:])\n"
        "print('flash_fwd launches', ops.FLASH_FWD.launches)\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--export-path", path, "--oneshot", "--out", out,
         "--seed", str(EXPORT_SEED)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return dict(sampler=sampler, export_s=export_s, size=size, launches=served,
                seconds={k: min(v) for k, v in seconds.items()},
                served=dict(proc=proc, out=out, want=want.cpu().numpy(), expected=expected,
                            t0=time.perf_counter()))


def check_served_export(served: dict) -> float:
    """Phase 14 (b), end: the serving process's images equal the in-process
    sampler's to the bit, with its kernel-1 launches; returns its seconds."""
    proc = served["proc"]
    try:
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        proc.kill()
    process_s = time.perf_counter() - served["t0"]
    if proc.returncode != 0:
        raise AssertionError(f"serve --export-path failed:\n{stdout[-2000:]}\n{stderr[-4000:]}")
    lines = stdout.strip().splitlines()
    for line in lines:
        log(f"export: serve --export-path: {line}")
    launches = int(lines[-1].split()[-1])
    if "no model build" not in stdout or launches != served["expected"]:
        raise AssertionError(f"serve --export-path: launches {launches}, expected "
                             f"{served['expected']}")
    if not np.array_equal(np.load(served["out"]), served["want"]):
        raise AssertionError("serve --export-path: images differ from the in-process sampler's")
    log(f"export: the served export equals the in-process images to the bit; the serving "
        f"process took {process_s:.1f} s (start, load, one request, beside the rest of the "
        f"phase)")
    return process_s


def export_3d(torch, ops, nets, serve, inferers, schedulers, root: str) -> dict:
    """Phase 14 (c): phase 5's 3D sampler (UNet (32, 64, 128) bf16 at 128^3,
    GMTPU_FUSED_RESBLOCK=1) with DDIM-EXPORT_DDIM_3D exported and served from
    its program: equal bits, and 22 kernel-5 and 4 kernel-1 launches a
    forward both ways."""
    os.environ["GMTPU_FUSED_RESBLOCK"] = "1"
    model = model_3d(torch, nets, dtype=torch.bfloat16)
    randomize(torch, model)
    per_forward = expected_launches_3d(model)
    ddim = schedulers.DDIMScheduler(num_train_timesteps=1000, device=DEVICE)
    ddim.set_timesteps(EXPORT_DDIM_3D)
    shape = (THREE_D["batch"], 1) + (THREE_D["size"],) * 3
    sampler = serve.Sampler(model, inferers.DiffusionInferer(ddim), shape, torch.device(DEVICE))
    reset_launches(ops)
    want = sampler(EXPORT_SEED)
    torch.cuda.synchronize()
    check_3d_counts(counts_3d(ops), per_forward, EXPORT_DDIM_3D, "in-process sample")
    path = os.path.join(root, "sampler_3d.pt2")
    t0 = time.perf_counter()
    exported = serve.export_sampler(sampler, path)
    export_s = time.perf_counter() - t0
    reset_launches(ops)
    got = exported(EXPORT_SEED)
    torch.cuda.synchronize()
    check_3d_counts(counts_3d(ops), per_forward, EXPORT_DDIM_3D, "exported sample")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exported(EXPORT_SEED)
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    log(f"export: 3D sampler {shape} bf16 fused DDIM-{EXPORT_DDIM_3D} exported in "
        f"{export_s:.1f} s to {os.path.getsize(path)} bytes; an exported request "
        f"{request_s:.4f} s")
    if not torch.equal(got, want):
        raise AssertionError(f"exported 3D sampler: images differ by "
                             f"{(got.float() - want.float()).abs().max().item():.3e}")
    os.environ["GMTPU_FUSED_RESBLOCK"] = "0"
    del model, sampler, exported
    torch.cuda.empty_cache()
    return dict(export_s=export_s, request_s=request_s)


def trace_request(torch, utils, sampler, root: str) -> None:
    """Phase 14 (d): one 2D request of phase 14 (b)'s sampler (DDIM-
    EXPORT_DDIM_2D) inside `utils.trace` and an `annotate` span; the Chrome
    trace names the span, the op and its CUDA kernel."""
    log_dir = os.path.join(root, "trace")
    with utils.trace(log_dir) as prof:
        with utils.annotate("serve_request"):
            sampler(EXPORT_SEED)
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    ops_named = sum(name == "gmtpu_torch::flash_fwd" for name in names)
    kernels = sum("flash_fwd" in name and e.get("cat") == "kernel"
                  for name, e in zip(names, events))
    device_ms = sum(e.device_time_total for e in prof.key_averages()
                    if "flash_fwd" in e.key and "gmtpu" not in e.key) / 1e3
    log(f"trace: {len(events)} events, {os.path.getsize(path)} bytes; 'serve_request' span "
        f"{'present' if 'serve_request' in names else 'MISSING'}; gmtpu_torch::flash_fwd "
        f"op events {ops_named}; flash_fwd CUDA kernel events {kernels} ({device_ms:.3f} ms "
        f"of device time)")
    expected = LAUNCHES_PER_FORWARD * EXPORT_DDIM_2D
    if "serve_request" not in names or ops_named < expected or kernels != expected:
        raise AssertionError(f"the trace lacks the span, the op's events or the kernel's "
                             f"({ops_named} op and {kernels} kernel events for {expected} "
                             f"launches)")


def serving_unet_pair(torch, nets, cls=None, **overrides):
    """A network of the 2D serving UNet's widths with seeded random weights on
    the kernel path, and its copy on the plain attention path."""
    import copy

    cls = cls or nets.DiffusionModelUNet
    cfg = dict(spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
               num_channels=SERVE["channels"], attention_levels=(False, True, True),
               num_head_channels=SERVE["channels"][-1], norm_num_groups=SERVE["norm_groups"])
    cfg.update(overrides)
    kernel = cls(**cfg).to(DEVICE).eval()
    if cls is nets.DiffusionModelEncoder:  # materialise the LazyLinear head
        with torch.no_grad():
            kernel(torch.zeros((1, cfg["in_channels"], SERVE["size"], SERVE["size"]),
                               device=DEVICE), torch.zeros((1,), dtype=torch.long, device=DEVICE))
    randomize(torch, kernel)
    plain = copy.deepcopy(kernel)
    for m in plain.modules():
        if hasattr(m, "use_flash_attention"):
            m.use_flash_attention = False
    return kernel, plain


def run_library_recipes(torch, ops, nets, schedulers) -> dict:
    """Phase 14 (e), the five library recipes at the 2D serving widths and
    64x64 (kernel 1 at (4, 1024, 1024, 256)), each on the kernel path
    against the plain path with the same draws, held at phase 3's chain
    gate."""
    from generativemodels_tpu_torch.recipes import (
        anomaly,
        classifier_guidance,
        diffusion_autoencoder,
        inpaint,
        super_resolution,
    )
    from generativemodels_tpu_torch.recipes.train_2d_ddpm import synthetic_batch

    b, size = SERVE["batch"], SERVE["size"]
    g = torch.Generator(DEVICE).manual_seed(70)
    images = synthetic_batch(g, b, size, DEVICE) * 2 - 1

    def draws(*shapes):
        return [torch.randn(s, generator=g, device=DEVICE) for s in shapes]

    def sched(cls, steps):
        s = cls(num_train_timesteps=1000, device=DEVICE)
        s.set_timesteps(steps)
        return s

    shape = images.shape
    unet, plain = serving_unet_pair(torch, nets)
    cases = {
        "anomaly": lambda m: anomaly.anomaly_map(m, sched(schedulers.DDIMScheduler, 50), images,
                                                 encode_steps=2)[0],
        "inpaint": (lambda m, noise=draws(*[shape] * 4): inpaint.inpaint(
            m, sched(schedulers.DDPMScheduler, 1), images, (images > 0).float(),
            num_resample_steps=1, noise=noise)),
    }
    sr_unet, sr_plain = serving_unet_pair(torch, nets, in_channels=2, num_class_embeds=1000)
    low = images[:, :, ::2, ::2].contiguous()
    sr_noise = draws(shape, low.shape, shape, shape)
    encoder, encoder_plain = serving_unet_pair(torch, nets, nets.DiffusionModelEncoder,
                                               out_channels=3)
    target = torch.arange(b, device=DEVICE) % 3
    cg_noise = draws(shape, shape, shape)
    dae_unet, dae_plain = serving_unet_pair(torch, nets, with_conditioning=True,
                                            cross_attention_dim=64)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(71)
        semantic = diffusion_autoencoder.SemanticEncoder(2, 1, emb_dim=64).to(DEVICE).eval()
    dae_noise = draws(shape, shape, shape)
    pairs = dict(
        anomaly=(unet, plain), inpaint=(unet, plain),
        super_resolution=(sr_unet, sr_plain),
        classifier_guidance=((unet, encoder), (plain, encoder_plain)),
        diffusion_autoencoder=(dae_unet, dae_plain),
    )
    cases["super_resolution"] = lambda m: super_resolution.sample_super_resolution(
        lambda x, t, c: m(x, t, class_labels=c), sched(schedulers.DDPMScheduler, 2), low, 2,
        noise=sr_noise)
    cases["classifier_guidance"] = lambda m: classifier_guidance.sample_with_classifier_guidance(
        m[0], m[1], sched(schedulers.DDIMScheduler, 2), cg_noise[0], target, eta=0.5,
        noise=cg_noise[1:])
    cases["diffusion_autoencoder"] = lambda m: diffusion_autoencoder.reconstruct(
        lambda x, t, c: m(x, t, context=c), semantic, sched(schedulers.DDPMScheduler, 2), images,
        noise=dae_noise)
    results = {}
    for name, run in cases.items():
        kernel_model, plain_model = pairs[name]
        with torch.no_grad():
            reset_launches(ops)
            got = run(kernel_model)
            torch.cuda.synchronize()
            counts = {k: v for k, v in read_launches(ops).items() if v}
            want = run(plain_model)
        diff = (got - want).abs().max().item()
        log(f"recipes: {name} at the serving widths, 64x64, batch {b}: kernel vs plain path "
            f"max|diff| {diff:.3e} (tol {CHAIN_ATOL:g}); launches {counts}")
        if not (bool(torch.isfinite(got).all()) and diff <= CHAIN_ATOL):
            raise AssertionError(f"{name}: kernel path disagrees with the plain path")
        if not counts.get("flash_fwd"):
            raise AssertionError(f"{name}: no kernel-1 launch")
        if name == "classifier_guidance" and not (counts.get("flash_bwd_dq")
                                                  and counts.get("flash_bwd_dkv")):
            raise AssertionError("classifier guidance: no backward kernels for the x gradient")
        results[name] = dict(diff=diff, launches=counts)
    del unet, plain, sr_unet, sr_plain, encoder, encoder_plain, dae_unet, dae_plain
    torch.cuda.empty_cache()
    return results


def run_controlnet_training(torch, ops, schedulers) -> dict:
    """Phase 14 (e): `recipes.train_controlnet.main` at its defaults for a few
    steps (UNet and ControlNet (64, 128, 128), 64x64, batch 16, f32: kernels
    1-3 at 1024 tokens, head width 128), then one ControlNet step's gradients
    on the kernel path against the plain path with seeded random weights."""
    import copy

    from generativemodels_tpu_torch.recipes import train_controlnet as tc

    reset_launches(ops)
    t0 = time.perf_counter()
    out = tc.main([*CN_TRAIN_ARGS, "--device", DEVICE])
    seconds = time.perf_counter() - t0
    counts = read_launches(ops)
    pre, steps = CN_TRAIN_STEPS
    expected = expected_launches(flash_fwd=3 * pre + CN_FLASH_PER_FORWARD * steps,
                                 flash_bwd_dq=3 * pre + 3 * steps,
                                 flash_bwd_dkv=3 * pre + 3 * steps)
    check_launches(counts, expected, f"train_controlnet main, {pre} UNet + {steps} ControlNet "
                                     f"steps in {seconds:.1f} s")
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"train_controlnet losses {out['losses']}")
    del out
    unet, cn = tc.build_models()
    unet, cn = unet.to(DEVICE), cn.to(DEVICE)
    randomize(torch, unet)
    randomize(torch, cn, seed=4321)
    plain_unet, plain_cn = copy.deepcopy(unet), copy.deepcopy(cn)
    for m in (*plain_unet.modules(), *plain_cn.modules()):
        if hasattr(m, "use_flash_attention"):
            m.use_flash_attention = False
    g = torch.Generator(DEVICE).manual_seed(72)
    images, masks = tc.synthetic_masked_batch(g, GRAD_BATCH, 64, DEVICE)
    noise = torch.randn(images.shape, generator=g, device=DEVICE)
    timesteps = torch.randint(0, 1000, (GRAD_BATCH,), generator=g, device=DEVICE)
    ddpm = schedulers.DDPMScheduler(num_train_timesteps=1000, device=DEVICE)

    def grads(frozen, model):
        step = tc.make_controlnet_train_step(frozen, ddpm)
        model.zero_grad(set_to_none=True)
        step.loss_fn(model, images, masks, noise, timesteps).backward()
        torch.cuda.synchronize()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    want = grads(plain_unet, plain_cn)
    reset_launches(ops)
    got = grads(unet, cn)
    step_counts = read_launches(ops)
    worst, worst_name = max_grad_diff(got, want)
    log(f"recipes: ControlNet step gradients at batch {GRAD_BATCH}, kernel vs plain path: worst "
        f"max|diff|/max|grad| = {worst:.3e} at {worst_name} (tol {GRAD_RTOL:g})")
    check_launches(step_counts, expected_launches(flash_fwd=CN_FLASH_PER_FORWARD,
                                                  flash_bwd_dq=3, flash_bwd_dkv=3),
                   "one ControlNet step")
    if not worst <= GRAD_RTOL:
        raise AssertionError("ControlNet step: gradients disagree with the plain path")
    return dict(launches=counts, seconds=seconds)


def run_training_recipes(torch, ops, root: str) -> dict:
    """Phase 14 (e): `recipes.compare_schedulers.main` (a few training steps,
    step counts 10 and 25, the DDPM-1000 reference) and
    `recipes.segmentation_ddpm.main` at its defaults (256 tokens: no kernel)."""
    from generativemodels_tpu_torch.networks import schedulers
    from generativemodels_tpu_torch.recipes import compare_schedulers, segmentation_ddpm

    reset_launches(ops)
    t0 = time.perf_counter()
    records = compare_schedulers.main([*CMP_ARGS, "--device", DEVICE,
                                       "--out", os.path.join(root, "cmp.json")])
    seconds = time.perf_counter() - t0
    forwards = 1000
    for steps in CMP_STEP_COUNTS:
        for _, cls, kwargs in compare_schedulers.SCHEDULERS:
            s = cls(num_train_timesteps=1000, **kwargs)
            s.set_timesteps(steps)
            forwards += len(s.timesteps)
    train = CMP_TRAIN_STEPS
    check_launches(read_launches(ops), expected_launches(
        flash_fwd=3 * (train + forwards), flash_bwd_dq=3 * train, flash_bwd_dkv=3 * train),
        f"compare_schedulers main ({train} steps, {forwards} sampling forwards, {seconds:.1f} s)")
    log("recipes: compare_schedulers: " + "; ".join(
        f"{r['scheduler']}-{r['steps']} {r['seconds']:.3f} s (MS-SSIM {r['ms_ssim_vs_ref']})"
        for r in records))
    reset_launches(ops)
    t0 = time.perf_counter()
    seg = segmentation_ddpm.main(["--device", DEVICE])
    seg_s = time.perf_counter() - t0
    counts = read_launches(ops)
    log(f"recipes: segmentation_ddpm main at its defaults: {len(seg['losses'])} steps in "
        f"{seg_s:.1f} s, last loss {seg['losses'][-1]:.4f}; launches {counts} (its attention "
        f"is at 16x16 = 256 tokens, under the flash threshold)")
    if any(counts.values()) or not all(np.isfinite(seg["losses"])):
        raise AssertionError("segmentation_ddpm: a kernel launched or a loss is not finite")
    return dict(compare_s=seconds, segmentation_s=seg_s)


def run_export_and_recipes(torch, ops, nets, serve, inferers, schedulers, utils) -> dict:
    """Phase 14: (b) the 2D export, (c) the 3D export, (d) a traced request,
    (e) the A10 recipes; in a temporary directory removed afterwards ((a),
    the ops' opcheck, runs in phase 2)."""
    import shutil
    import tempfile

    os.environ["GMTPU_FUSED_RESBLOCK"] = "0"
    os.environ.pop("GMTPU_FLASH_FUSED_BWD", None)
    root = tempfile.mkdtemp(prefix="chip_smoke_export_")
    served = None
    try:
        two_d = export_2d(torch, ops, serve, root)
        served = two_d.pop("served")
        trace_request(torch, utils, two_d.pop("sampler"), root)
        torch.cuda.empty_cache()
        three_d = export_3d(torch, ops, nets, serve, inferers, schedulers, root)
        library = run_library_recipes(torch, ops, nets, schedulers)
        controlnet = run_controlnet_training(torch, ops, schedulers)
        training = run_training_recipes(torch, ops, root)
        two_d["process_s"] = check_served_export(served)
    finally:
        if served is not None:
            served["proc"].kill()
            served["proc"].wait()
        shutil.rmtree(root, ignore_errors=True)
    return dict(export_2d=two_d, export_3d=three_d, library=library, controlnet=controlnet,
                training=training)


# phase 15 (b): the sequence-parallel pieces at the 3D attention shape, bf16,
# for a sequence cut in n blocks; kernel 5's halo slab at FUSED_MAIN_CASE
P15_SHAPE = (2, 32768, 32768, 64)
P15_CUTS = (2, 4)
# the ring's merged rows against the unsharded kernel 1's O, relative to
# max|O|: each chunk's O is rounded to bf16 before the f32 merge, then the
# merge is rounded once more, a few bf16 ulps at most; 2e-2 of max|O| is 2.5
# to 5 ulps there (one ulp, 2.44e-4 at max|O| ~0.05, on the H100); the
# allgather's rows must equal the unsharded kernel's to the bit (each query
# row walks the same keys in the same order), as must kernel 2's dq rows and
# kernel 5's cropped slabs; dk, dv are the n blocks' bf16 parts summed in f32
# (BACKWARD_TOLERANCE)
RING_TOLERANCE = 2e-2
# phase 15 (c)'s two-rank runs on the one card, through probes/multi_card.py
P15_SAME_CARD_CHECKS = ("cut_space", "attention")
# phase 15 (d)'s: the 3D LDM stage-1 G+D step at 128^3 (batch 2) and the
# VQ-GAN step at 64x64 (batch 16), each cut on {"space": 2}; the probe
# counts kernels 1-3 (the AEKL's attention through the allgather) on each
# rank over the cut f32 stage-1 step
P15_ADVERSARIAL_CHECKS = ("ldm_stage1", "vqgan")
P15_KERNELS = {"flash_fwd": "FLASH_FWD", "flash_bwd_dq": "FLASH_BWD_DQ",
               "flash_bwd_dkv": "FLASH_BWD_DKV"}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_data_parallel_3d(torch, ops, recipe3d, trained_3d) -> dict:
    """Phase 15 (a): the 3D recipe with --data-parallel on an nccl group of
    one rank (GMTPU_COORD / GMTPU_NPROC / GMTPU_RANK), split backward; its
    losses must equal phase 6 (a)'s split run to the bit: the world-1
    all-reduces copy, and every draw is the non-parallel run's."""
    env = dict(GMTPU_COORD=f"localhost:{free_port()}", GMTPU_NPROC="1", GMTPU_RANK="0")
    os.environ.update(env)
    torch.cuda.empty_cache()
    reset_launches(ops)
    t0 = time.perf_counter()
    try:
        out = recipe3d.main([*TRAIN_3D_ARGS, "--steps", str(TRAIN_STEPS), "--device", DEVICE,
                             "--data-parallel"])
    finally:
        for key in env:
            os.environ.pop(key, None)
    seconds = time.perf_counter() - t0
    counts = read_launches(ops)
    losses, sps = out["losses"], out["steps_per_sec"]
    want = trained_3d["split"]["losses"]
    same = losses == want
    log(f"parallel: (a) train_3d_ddpm --data-parallel on an nccl group of one rank, "
        f"{TRAIN_STEPS} steps in {seconds:.2f} s, {sps:.4f} steps/s over steps 3-{TRAIN_STEPS} "
        f"(phase 6 (a) split {trained_3d['split']['steps_per_sec']:.4f}); losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + f"; equal to phase 6 (a)'s to the bit: {same}")
    if not same:
        raise AssertionError(f"--data-parallel losses {losses} differ from phase 6's {want}")
    check_launches(counts, expected_launches(TRAIN_STEPS, **TRAIN_3D_LAUNCHES["split"]),
                   "3D recipe main --data-parallel")
    return dict(launches=counts, steps_per_sec=sps)


def check_sequence_chunks(torch, ops) -> dict:
    """Phase 15 (b): for each n, every rank's pieces against the unsharded
    kernels, and the times of rank 0's (all ranks' calls have one shape)."""
    from generativemodels_tpu_torch.ops.flash_attention import _backward_rows, _prescaled
    from generativemodels_tpu_torch.ops.sharded_attention import _combine_chunks

    bh, s, _, d = P15_SHAPE
    dtype = torch.bfloat16
    scale = d**-0.5
    g = torch.Generator("cuda").manual_seed(15)
    q, k, v, dout = (torch.randn((bh, s, d), generator=g, device="cuda").to(dtype)
                     for _ in range(4))
    out, lse2 = ops.FLASH_FWD(q, k, v, scale=scale, log2_lse=True)
    qp = _prescaled(q, scale)
    do2, delta = _backward_rows(out, dout)
    dq = ops.FLASH_BWD_DQ(qp, k, v, do2, lse2, delta)
    dk, dv = ops.FLASH_BWD_DKV(qp, k, v, do2, lse2, delta)
    esize = q.element_size()
    results = {}
    for n in P15_CUTS:
        c = s // n
        rows = [slice(r * c, (r + 1) * c) for r in range(n)]
        blocks = [dict(q=q[:, sl].contiguous(), qp=qp[:, sl].contiguous(),
                       do2=do2[:, sl].contiguous(), lse2=lse2[:, sl].contiguous(),
                       delta=delta[:, sl].contiguous(), k=k[:, sl].contiguous(),
                       v=v[:, sl].contiguous()) for sl in rows]

        def gather_fwd(b):
            return ops.FLASH_FWD(b["q"], k, v, scale=scale)[0]

        def ring_chunk(b, j):
            return ops.flash_attention_with_lse(b["q"], blocks[j]["k"], blocks[j]["v"],
                                                scale=scale)

        def ring(b):
            acc, acc_lse = None, None
            for j in range(n):
                o, lse = ring_chunk(b, j)
                acc, acc_lse = ((o.float(), lse) if acc is None
                                else _combine_chunks(acc, acc_lse, o, lse))
            return acc.to(dtype)

        def local_dq(b):
            return ops.FLASH_BWD_DQ(b["qp"], k, v, b["do2"], b["lse2"], b["delta"])

        def local_dkv(b):
            return ops.FLASH_BWD_DKV(b["qp"], k, v, b["do2"], b["lse2"], b["delta"])

        gather_same = ring_err = dq_same = 0
        ring_tol = RING_TOLERANCE * out.float().abs().max().item()
        dk_sum = torch.zeros_like(dk, dtype=torch.float32)
        dv_sum = torch.zeros_like(dv, dtype=torch.float32)
        for sl, b in zip(rows, blocks):
            gather_same += int(torch.equal(gather_fwd(b), out[:, sl]))
            ring_err = max(ring_err, (ring(b).float() - out[:, sl].float()).abs().max().item())
            dq_same += int(torch.equal(local_dq(b), dq[:, sl]))
            dk_r, dv_r = local_dkv(b)
            dk_sum += dk_r.float()
            dv_sum += dv_r.float()
        dkv_err = max(((dk_sum - dk.float()).abs().max() / dk.float().abs().max()).item(),
                      ((dv_sum - dv.float()).abs().max() / dv.float().abs().max()).item())
        del dk_sum, dv_sum
        b0 = blocks[0]
        o0, l0 = ring_chunk(b0, 0)
        ms = dict(gather=time_ms(lambda: gather_fwd(b0)), chunk=time_ms(lambda: ring_chunk(b0, 0)),
                  merge=time_ms(lambda: _combine_chunks(o0.float(), l0, o0, l0)),
                  ring=time_ms(lambda: ring(b0)), dq=time_ms(lambda: local_dq(b0)),
                  dkv=time_ms(lambda: local_dkv(b0)))
        gather_lib, _ = library_attention_ms(torch, b0["q"], k, v, scale, False)
        chunk_lib, _ = library_attention_ms(torch, b0["q"], b0["k"], b0["v"], scale, False)
        # SDPA's backward (dq, dk, dv in one call) of the allgather's local
        # attention: the yardstick of kernels 2 and 3 at Sq = S/n
        bwd_lib, _ = library_attention_ms(torch, b0["q"], k, v, scale, False,
                                          dout=dout[:, rows[0]].contiguous())
        rows2 = 8 * bh * c
        lim = dict(
            gather=bound(4 * bh * c * s * d, bh * d * esize * (2 * c + 2 * s) + 4 * bh * c,
                         "bfloat16"),
            chunk=bound(4 * bh * c * c * d, bh * d * esize * 4 * c + 4 * bh * c, "bfloat16"),
            dq=bound(6 * bh * c * s * d, bh * d * esize * (3 * c + 2 * s) + rows2, "bfloat16"),
            dkv=bound(8 * bh * c * s * d, bh * d * esize * (2 * c + 4 * s) + rows2, "bfloat16"),
        )
        ok = (gather_same == n and dq_same == n and ring_err <= ring_tol
              and dkv_err <= BACKWARD_TOLERANCE["bfloat16"])
        log(f"parallel: (b) n={n}: allgather kernel 1 at (BH={bh}, Sq={c}, Sk={s}, D={d}) bf16: "
            f"{gather_same}/{n} blocks equal to the unsharded rows to the bit, {ms['gather']:.4f} "
            f"ms (bound {lim['gather']['bound_ms']:.4f}, SDPA {gather_lib:.4f}); ring: {n} "
            f"chunks of kernel 1 with lse at (BH={bh}, {c}, {c}, D={d}) {ms['chunk']:.4f} ms "
            f"each (bound {lim['chunk']['bound_ms']:.4f}, SDPA {chunk_lib:.4f}), a merge "
            f"{ms['merge']:.4f} ms, a rank's ring {ms['ring']:.4f} ms, merged max|dO| "
            f"{ring_err:.3e} (tol {ring_tol:.3e}, {RING_TOLERANCE:g} of max|O|); kernel 2 at "
            f"Sq={c}: {dq_same}/{n} dq blocks equal to the bit, {ms['dq']:.4f} ms (bound {lim['dq']['bound_ms']:.4f}); "
            f"kernel 3 at Sq={c}: dk, dv summed over the blocks max|d|/max {dkv_err:.3e} (tol "
            f"{BACKWARD_TOLERANCE['bfloat16']:g}), {ms['dkv']:.4f} ms (bound "
            f"{lim['dkv']['bound_ms']:.4f}); SDPA's backward at Sq={c} {bwd_lib:.4f} ms -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"sequence-parallel pieces at n={n} disagree with the kernels")
        results[n] = dict(
            flash_fwd=dict(allgather=dict(max_abs_err=0.0, ms=ms["gather"], library_ms=gather_lib,
                                          **lim["gather"]),
                           ring_chunk=dict(max_abs_err=ring_err, ms=ms["chunk"],
                                           merge_ms=ms["merge"], ring_ms=ms["ring"],
                                           library_ms=chunk_lib, **lim["chunk"])),
            flash_bwd_dq=dict(allgather=dict(max_abs_err=0.0, ms=ms["dq"], library_ms=bwd_lib,
                                             **lim["dq"])),
            flash_bwd_dkv=dict(allgather=dict(max_abs_err=dkv_err, ms=ms["dkv"],
                                              library_ms=bwd_lib, **lim["dkv"])),
        )
        del blocks, o0, l0
        torch.cuda.empty_cache()
    del q, k, v, dout, out, lse2, qp, do2, delta, dq, dk, dv
    torch.cuda.empty_cache()
    results["fused_conv"] = check_halo_slabs(torch, ops)
    return results


def check_halo_slabs(torch, ops) -> dict:
    """Phase 15 (b), kernel 5: the cut fused ResnetBlock's calls
    (`networks/nets/diffusion_model_unet.py::_fused_conv_cf`) at
    FUSED_MAIN_CASE: each rank's slab extended by one plane from each
    neighbour (none at the outer border), the kernel's output cropped to
    the slab; the crops must equal the unsharded output to the bit. An
    inner slab is timed beside the plain version and F.conv3d alone."""
    import torch.nn.functional as F

    name, (b, d, h, w), cin, cout, residual, dtype_name = next(
        case for case in FUSED_CASES if case[0] == FUSED_MAIN_CASE)
    g = torch.Generator("cuda").manual_seed(16)
    x_cf = torch.randn((b, cin, d, h, w), generator=g, device="cuda").to(torch.bfloat16)
    kernel = ((27 * cin) ** -0.5 * torch.randn((3, 3, 3, cin, cout), generator=g,
                                               device="cuda")).to(torch.bfloat16)
    scale, shift = ops.fold_groupnorm_affine(x_cf.permute(0, 2, 3, 4, 1),
                                             torch.ones(cin, device="cuda"),
                                             torch.zeros(cin, device="cuda"), 32)
    bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
    full = ops.FUSED_CONV(x_cf.permute(0, 2, 3, 4, 1), kernel, scale, shift, bias)
    w_oidhw = kernel.permute(4, 3, 0, 1, 2).contiguous()
    results = {}
    for n in P15_CUTS:
        c = d // n
        same, slabs = 0, []
        for r in range(n):
            lo, hi = max(0, r * c - 1), min(d, (r + 1) * c + 1)
            slab = x_cf[:, :, lo:hi].contiguous()
            slabs.append((slab, r * c - lo))
            got = ops.FUSED_CONV(slab.permute(0, 2, 3, 4, 1), kernel, scale, shift, bias)
            same += int(torch.equal(got[:, r * c - lo:r * c - lo + c], full[:, r * c:(r + 1) * c]))
        slab, _ = slabs[min(1, n - 1)]
        slab_cl = slab.permute(0, 2, 3, 4, 1)
        ms = time_ms(lambda: ops.FUSED_CONV(slab_cl, kernel, scale, shift, bias))
        plain_ms = time_ms(lambda: ops.fused_norm_silu_conv3d_reference(slab_cl, kernel, scale,
                                                                        shift, bias))
        library_ms = time_ms(lambda: F.conv3d(slab, w_oidhw, bias.to(slab.dtype), padding=1))
        # the work the cut needs: the slab's c output planes, from its planes
        # and their halo planes
        out_voxels, in_voxels = b * c * h * w, b * slab.shape[2] * h * w
        lim = bound(2 * out_voxels * 27 * cin * cout,
                    (in_voxels * cin + out_voxels * cout) * 2 + kernel.numel() * 2
                    + 4 * (2 * b * cin + cout), dtype_name)
        ok = same == n
        log(f"parallel: (b) n={n}: kernel 5 {name} on halo slabs of {c} + 2 planes (B={b}, "
            f"D={slab.shape[2]}, H={h}, W={w}): {same}/{n} cropped slabs equal to the unsharded "
            f"output to the bit; an inner slab {ms:.4f} ms (bound {lim['bound_ms']:.4f}, plain "
            f"{plain_ms:.4f}, F.conv3d alone {library_ms:.4f}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel 5's halo slabs at n={n} differ from the unsharded call")
        results[n] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          **lim)
    return results


def two_ranks_on_one_card(checks) -> dict:
    """probes/multi_card.py's `checks` on two gloo ranks on cuda:0 (nccl
    refuses two ranks on one card): rank 0's JSON line."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2", "--master_port",
         str(free_port()), "-m", "generativemodels_tpu_torch.probes.multi_card", "--backend",
         "gloo", "--device", "cuda:0", "--checks", *checks],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"two ranks on the one card failed ({proc.returncode}):\n"
                             f"{lines[-1] if lines else ''}\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1])


def run_same_card() -> dict:
    """Phase 15 (c): on two gloo ranks on cuda:0, the cut ("space": 2) 3D
    training step at 128^3 against the uncut step, and the allgather and ring
    attention at the 3D shape against the unsharded kernels (the script's
    checks and tolerances)."""
    t0 = time.perf_counter()
    runs = two_ranks_on_one_card(P15_SAME_CARD_CHECKS)
    cut, att = runs["cut_space"], runs["attention"]
    log(f"parallel: (c) two gloo ranks on cuda:0 ({time.perf_counter() - t0:.1f} s): cut "
        f"(\"space\": 2) 3D step at {THREE_D['size']}^3 against the uncut step: f32 loss "
        f"{cut['f32']['loss_rel']:.3e}, gradients {cut['f32']['grad_rel']:.3e} (tol "
        f"{cut['f32']['tol']:g}); bf16 gradients {cut['bf16']['grad_rel']:.3e} (tol twice the "
        f"uncut bf16 step's distance from f32, {cut['bf16']['uncut_bf16_vs_f32']:.3e}); a cut "
        f"bf16 step "
        f"{cut['bf16']['step_ms']:.1f} ms, uncut {cut['bf16']['uncut_step_ms']:.1f} ms (two "
        f"processes on one card, gloo staging through the host); attention {att['shape']}: "
        f"allgather rows and dq equal to the bit {att['allgather_equal']} {att['dq_equal']}, "
        f"dk, dv {att['dkv_rel']:.3e}, ring {att['ring_err']:.3e} (tol {att['ring_tol']:.3e}); "
        f"allgather {att['allgather_ms']:.2f} ms, ring {att['ring_ms']:.2f} ms a call")
    if not runs["ok"]:
        raise AssertionError(f"two ranks on the one card disagree with one rank: {runs}")
    return runs


def run_cut_adversarial() -> dict:
    """Phase 15 (d): on two gloo ranks on cuda:0, the 3D LDM recipe's stage-1
    G+D step (AEKL (32, 64, 64), PatchGAN 3D, 128^3, batch 2) cut on
    {"space": 2}, f32 and bf16, against the uncut step on one rank, and the
    VQ-GAN recipe's step (64x64, batch 16) the same way in f32. The f32
    stage-1 losses within 1e-5 (relative) of the uncut step's, its gradients
    within 1e-5 or twice the distance between two f32 summation orders of
    the uncut step, whichever is larger (its convolutions' weight gradients
    cancel: `probes/multi_card.py::check_ldm_stage1`), bf16 within twice
    the uncut bf16 step's own distance from f32; at 64^3 the float64 step
    cut against uncut, every gradient leaf within 1e-8 (its losses, f32 sums
    of the PatchGAN's f32 logits, within 1e-5), and the
    cut f32 step's gradients within 1e-5 or twice the uncut f32 step's
    distance of the float64 ones; kernels 1-3 launched on every
    rank by the cut f32 step (the AEKL's attention at (2, 16384, 32768, 64)
    f32 through the allgather; the probe zeroes the counts before that step
    and reads them after it)."""
    t0 = time.perf_counter()
    runs = two_ranks_on_one_card(P15_ADVERSARIAL_CHECKS)
    ldm, vq = runs["ldm_stage1"], runs["vqgan"]
    f32, bf16, w = ldm["f32"], ldm["bf16"], ldm["witness"]
    launches = {name: ldm["launches"][op] for name, op in P15_KERNELS.items()}
    log(f"parallel: (d) two gloo ranks on cuda:0 ({time.perf_counter() - t0:.1f} s): 3D LDM "
        f"stage-1 G+D step at {ldm['size']}^3, batch {ldm['batch']}, cut on {ldm['mesh']} "
        f"against the uncut step: f32 losses {f32['loss_rel']:.3e} (tol {f32['tol']:g}), G "
        f"gradients {f32['g_grad_rel']:.3e} (tol {f32['g_tol']:.3e}), D gradients "
        f"{f32['d_grad_rel']:.3e} (tol {f32['d_tol']:.3e}; two f32 orders of the uncut step "
        f"differ by {f32['uncut_orders']['g']:.3e}, {f32['uncut_orders']['d']:.3e}); at "
        f"{w['size']}^3 the float64 step cut against uncut: losses {w['f64']['loss_rel']:.3e} "
        f"(tol {w['f32_tol']:g}), the worst G leaf {w['f64']['g_leaf_rel']:.3e}, D leaf "
        f"{w['f64']['d_leaf_rel']:.3e} (tol {w['f64_tol']:g}); from its uncut float64 "
        f"gradients, the f32 G cut "
        f"{w['f32']['g']['cut_vs_f64']:.3e}, uncut {w['f32']['g']['uncut_vs_f64']:.3e}, D cut "
        f"{w['f32']['d']['cut_vs_f64']:.3e}, uncut {w['f32']['d']['uncut_vs_f64']:.3e} (f32 cut "
        f"against uncut G {w['f32']['g']['cut_vs_uncut']:.3e}, D "
        f"{w['f32']['d']['cut_vs_uncut']:.3e}); "
        f"bf16 G {bf16['g_grad_rel']:.3e}, D {bf16['d_grad_rel']:.3e} (tol twice "
        f"{bf16['uncut_bf16_vs_f32']:.3e}); a cut f32 step {f32['step_ms']:.1f} ms, uncut "
        f"{f32['uncut_step_ms']:.1f} ms; bf16 {bf16['step_ms']:.1f} / "
        f"{bf16['uncut_step_ms']:.1f} ms (two processes on one card); rank 0's launches over "
        f"the cut f32 step {launches}; VQ-GAN step at {vq['size']}x{vq['size']}, batch "
        f"{vq['batch']}, cut on {vq['mesh']}: losses {vq['loss_rel']:.3e}, G {vq['g_grad_rel']:.3e}, "
        f"D {vq['d_grad_rel']:.3e}, codebook {vq['codebook_rel']:.3e} (tol {vq['tol']:g}); "
        f"{vq['step_ms']:.1f} ms a cut step, uncut {vq['uncut_step_ms']:.1f}")
    if not runs["ok"] or not all(v > 0 for v in launches.values()):
        raise AssertionError(f"the cut adversarial steps disagree with one rank, or the cut "
                             f"stage-1 step launched no kernel 1-3: {runs}")
    return dict(runs=runs, launches=launches)


def run_parallel(torch, ops, recipe3d, trained_3d) -> dict:
    """Phase 15."""
    t0 = time.perf_counter()
    dp = run_data_parallel_3d(torch, ops, recipe3d, trained_3d)
    chunks = check_sequence_chunks(torch, ops)
    same_card = run_same_card()
    adversarial = run_cut_adversarial()
    log(f"parallel: phase 15 in {time.perf_counter() - t0:.1f} s")
    return dict(dp=dp, chunks=chunks, same_card=same_card, adversarial=adversarial)


def build_kernels(build_library, sources: tuple = SOURCES) -> None:
    """Phase 1: one nvcc for each of `sources`, all started together."""
    results = {}

    def build(name):
        t0 = time.perf_counter()
        try:
            lib, build_log = build_library(name)
            results[name] = (lib, build_log, time.perf_counter() - t0)
        except Exception as exc:  # reported and re-raised below, in this thread
            results[name] = exc

    threads = [threading.Thread(target=build, args=(name,)) for name in sources]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in sources:
        if isinstance(results[name], Exception):
            raise results[name]
        lib, build_log, seconds = results[name]
        log(f"build: {lib.name} in {seconds:.2f} s")
        serialized = []  # ptxas's notes (info lines) of wgmmas it made synchronous
        for line in build_log.splitlines():
            if "warning" in line or "Performance Loss" in line:
                log(f"  {line.strip()}")
            if "wgmma.mma_async instructions are serialized" in line:
                serialized.append(line.strip())
        if serialized:
            raise AssertionError(f"ptxas serialized the wgmmas of {name}: {serialized[0]}")
        entries = ptxas_entries(build_log)
        for entry in entries:
            log(f"  ptxas: {entry['name']}: {entry['registers']} registers, "
                f"{entry['stack']} bytes stack frame, {entry['spill_stores']} bytes spill "
                f"stores, {entry['spill_loads']} bytes spill loads")
        offenders, checked = stack_offenders(entries)
        if offenders:
            raise AssertionError(f"stack frame or spills in {', '.join(offenders)}")
        if checked != NO_STACK_INSTANCES.get(name, 0):
            raise AssertionError(f"the ptxas log of {name} reports {checked} instantiations of "
                                 f"{', '.join(NO_STACK_KERNELS)} with no stack frame, not "
                                 f"{NO_STACK_INSTANCES.get(name, 0)}")
        counts = kernel_instances(entries, KERNEL_INSTANCES.get(name, {}))
        if counts != KERNEL_INSTANCES.get(name, {}):
            raise AssertionError(f"the ptxas log of {name} reports the instantiations {counts}, "
                                 f"not {KERNEL_INSTANCES[name]}")


def stack_offenders(entries: list[dict]) -> tuple[list[str], int]:
    """The entries of NO_STACK_KERNELS with a stack frame or spills (or none
    reported), and how many of them have neither."""
    offenders, checked = [], 0
    for entry in entries:
        if any(kernel in entry["name"] for kernel in NO_STACK_KERNELS):
            spent = (None if entry["stack"] is None else
                     entry["stack"] + entry["spill_stores"] + entry["spill_loads"])
            if spent is None or spent > 0:
                offenders.append(entry["name"])
            else:
                checked += 1
    return offenders, checked


def kernel_instances(entries: list[dict], kernels) -> dict:
    """How many entry functions of a ptxas log instantiate each of `kernels`
    (a name matches itself and not a longer name that contains it: the
    mangled name holds its length)."""
    return {kernel: sum(f"{len(kernel)}{kernel}I" in entry["name"] for entry in entries)
            for kernel in kernels}


def ptxas_entries(build_log: str) -> list[dict]:
    """Each entry function of a `-Xptxas=-v` log with its registers, stack
    frame and spill bytes."""
    entries, current = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            current = dict(name=line.split("'")[1], registers=None, stack=None,
                           spill_stores=None, spill_loads=None)
            entries.append(current)
        elif current is not None and "bytes stack frame" in line:
            numbers = [int(word) for word in line.replace(",", " ").split() if word.isdigit()]
            current["stack"], current["spill_stores"], current["spill_loads"] = numbers[:3]
        elif current is not None and "Used" in line and "registers" in line:
            current["registers"] = int(line.split("Used")[1].split()[0])
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "generativemodels_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from generativemodels_tpu_torch import inferers, ops, parallel, probes
    from generativemodels_tpu_torch.networks import nets, schedulers
    from generativemodels_tpu_torch.ops.native import build_library
    from generativemodels_tpu_torch.probes import bench_3d_ldm as bench_ldm
    from generativemodels_tpu_torch.recipes import brain_ldm_sampler as brain
    from generativemodels_tpu_torch.recipes import serve
    from generativemodels_tpu_torch import engines
    from generativemodels_tpu_torch.recipes import train_2d_ddpm as recipe
    from generativemodels_tpu_torch.recipes import train_2d_ldm as ldm2d
    from generativemodels_tpu_torch.recipes import train_3d_ddpm as recipe3d
    from generativemodels_tpu_torch.recipes import train_3d_ldm as ldm3d
    from generativemodels_tpu_torch.recipes import train_vqgan as vqgan
    from generativemodels_tpu_torch.recipes import train_spade_ldm as spade_ldm
    from generativemodels_tpu_torch.recipes import train_spade_vae as spade_vae
    from generativemodels_tpu_torch.recipes import train_vqvae_transformer as ar_recipe
    from generativemodels_tpu_torch import utils

    t_start = time.perf_counter()
    # phase 1: card and build
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from generativemodels_tpu_torch.data import native as data_native

    log(host_line(data_native))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32} (full float32)")
    build_kernels(build_library)

    # phase 2: kernels against their plain versions
    forward = check_kernel(torch, ops)
    opcheck_ops(torch, ops)
    measure_threshold(torch, ops)
    backward = check_backward(torch, ops)
    contracts = check_contracts(torch, ops)
    contract_launches = contract_unet_forwards(torch, ops, nets)
    fused = check_fused_conv(torch, ops)

    # phase 3: serving through its entry points
    served = run_slice(torch, ops, serve, nets)
    log(f"slice: seconds per DDIM-{SERVE['ddim_steps']} request at batch {SERVE['batch']}: "
        + ", ".join(f"{s:.3f}" for s in served["seconds_per_request"]))

    # phase 4: training through its entry points
    trained = train_recipe(torch, ops, recipe)
    bench = train_bench(torch, ops, nets, parallel, schedulers)
    train_bench_fused(torch, ops, nets, parallel, schedulers, bench)
    check_gradients(torch, ops, nets, parallel, schedulers, recipe)

    # phase 5: 3D sampling through its entry points, then DPM-Solver++ serving
    model_3d_bf16, fused_launches = run_3d(torch, ops, nets, schedulers, inferers)
    compare_3d(torch, ops, nets, schedulers, model_3d_bf16)
    profile_3d(torch, model_3d_bf16)
    del model_3d_bf16
    torch.cuda.empty_cache()
    serve_dpmsolver(torch, ops, serve)

    # phase 6: 3D training through its entry points, with each backward; the
    # training route keeps the unfused ResnetBlock (phase 5 turned it on)
    os.environ["GMTPU_FUSED_RESBLOCK"] = "0"
    trained_3d = train_3d_recipe(torch, ops, recipe3d)
    check_gradients_3d(torch, ops, nets, parallel, schedulers, recipe3d)
    profile_train_3d(torch)

    # phase 7: the attention-forward probes (kernels 6 and 7), each kernel
    # variant against its plain version, then both entry points
    probe_errors = check_probes(torch, ops)
    probe_numbers, probe_launches = run_probes(torch, ops, probes,
                                               forward["3d_level2_bf16"]["ms"], probe_errors)

    # phase 8: the latent 128^3 route through LatentDiffusionInferer and
    # probes/bench_3d_ldm.py, kernel 1 at the latent shape (phase 2's
    # head64_bf16)
    run_ldm(torch, ops, nets, schedulers, inferers, bench_ldm)

    # phase 9: conditioning: (a) the brain 3D LDM bundle, kernel 5 under the
    # fused route; (b) ControlNet sampling, kernel 1; (c) classifier-free
    # guidance on the CXR UNet (no kernel on its path)
    brain_results = run_brain(torch, ops, nets, schedulers, inferers, brain)
    cn_results = run_controlnet(torch, ops, nets, schedulers, inferers)
    cfg_results = run_cfg(torch, ops, nets, schedulers)
    log("conditioning: seconds per brain LDM sample (DDIM-50, host clock): "
        + "; ".join(f"{label} {sum(r['seconds']) / len(r['seconds']):.4f} (chain "
                    f"{r['chain_ms']:.1f} ms, decode {r['decode_ms']:.1f} ms, peak "
                    f"{r['peak_gib']:.2f} GiB)" for label, r in brain_results.items())
        + f"; ControlNet request {sum(cn_results['seconds']) / len(cn_results['seconds']):.4f} s; "
        + "; ".join(f"CFG {name} {sec:.4f} s" for name, sec in cfg_results.items()))

    # phase 10: stage-1 and adversarial training: (a) the 3D LDM recipe at
    # 128^3 (kernels 1-3, or 1 and 4, in both stages), (b) its G gradients on
    # the kernel paths against the plain path, (c) the VQ-GAN and (d) the 2D
    # LDM recipes, (e) a profiled stage-1 step
    ldm3d_results = run_ldm3d(torch, ops, ldm3d)
    ldm3d_gradients(torch, ops, ldm3d, ldm2d, engines)
    two_d = run_2d_stage1(torch, ops, vqgan, ldm2d)
    profile_ldm3d(torch, ldm3d, ldm2d, engines)
    log("stage 1: seconds a step (host clock): 3D LDM at 128^3 "
        + "; ".join(f"{key} stage 1 {r['stage1_s']:.4f}, stage 2 {r['stage2_s']:.4f} (peak "
                    f"{r['peak_gib']:.2f} GiB)" for key, r in ldm3d_results.items())
        + f"; VQ-GAN {two_d['vqgan_s']:.4f}; 2D LDM stage 1 {two_d['ldm2d_stage1_s']:.4f}, "
        f"stage 2 {two_d['ldm2d_stage2_s']:.4f}")

    # phase 11: the autoregressive stack: (a) the tutorial config's sampling
    # on both paths, (b) the recipe at 1024 tokens on the causal kernels 1-3
    # (and 1 and 4), (c) its stage-2 gradients and (d) its likelihood on the
    # kernel path against the plain path
    t_ar = time.perf_counter()
    ar_serving = run_ar_serving(torch, ops, nets, inferers, utils)
    ar_trained = run_ar_training(torch, ops, ar_recipe)
    ar_gradients_and_likelihood(torch, ops, ar_recipe, inferers, utils, recipe)
    log(f"ar: phase 11 in {time.perf_counter() - t_ar:.1f} s; seconds a 256-token sample, batch "
        f"1: windowed {ar_serving[(256, 1, 'windowed')]['host_s']:.4f}, cached "
        f"{ar_serving[(256, 1, 'cached')]['host_s']:.4f}; recipe stage 2 at 1024 tokens "
        + "; ".join(f"{k} {r['stage2_s']:.4f} s a step (peak {r['peak_gib']:.2f} GiB)"
                    for k, r in ar_trained.items()))

    # phase 12: the SPADE recipes, and a SPADE UNet forward against the CPU
    t_spade = time.perf_counter()
    spade = run_spade(torch, ops, spade_vae, spade_ldm)
    log(f"spade: phase 12 in {time.perf_counter() - t_spade:.1f} s; VAE-GAN "
        f"{spade['vae_s']:.4f} s a step, LDM stage 1 {spade['ldm_stage1_s']:.4f}, stage 2 "
        f"{spade['ldm_stage2_s']:.4f} s a step")

    # phase 13: the host data path: the loader, the 2D recipe trained from
    # disk with a checkpoint, that checkpoint served, the two eval recipes
    t_data = time.perf_counter()
    data_path = run_data_path(torch, ops, recipe, serve, inferers, schedulers,
                              trained["steps_per_sec"])
    log(f"data: phase 13 in {time.perf_counter() - t_data:.1f} s; loader "
        + ", ".join(f"{k} {v:.2f}" for k, v in data_path["loader"].items())
        + f" volumes/s at {BRAIN_VOLUME}; 2D recipe from disk {data_path['disk']['sps']:.3f} "
        f"steps/s (busy {data_path['disk']['busy']:.3f}); checkpoint save "
        f"{data_path['disk']['save_s']:.3f} s, restore {data_path['disk']['restore_s']:.3f} s; "
        f"eval_brain_ldm {data_path['brain']['sample_s']:.3f} s a sample")

    # phase 14: export and tracing on the gmtpu_torch ops, and the A10 recipes
    t_export = time.perf_counter()
    exports = run_export_and_recipes(torch, ops, nets, serve, inferers, schedulers, utils)
    log(f"export: phase 14 in {time.perf_counter() - t_export:.1f} s; 2D export "
        f"{exports['export_2d']['export_s']:.1f} s, {exports['export_2d']['size']} bytes, a "
        f"request {exports['export_2d']['seconds']['exported']:.4f} s exported vs "
        f"{exports['export_2d']['seconds']['in-process']:.4f} s in process; 3D export "
        f"{exports['export_3d']['export_s']:.1f} s; train_controlnet "
        f"{exports['controlnet']['seconds']:.1f} s, compare_schedulers "
        f"{exports['training']['compare_s']:.1f} s, segmentation_ddpm "
        f"{exports['training']['segmentation_s']:.1f} s")

    # phase 15: multi-device: (a) the 3D recipe with --data-parallel on a
    # group of one rank, (b) the sequence-parallel pieces and kernel 5's halo
    # slabs at the 3D shapes, (c) two ranks on the one card, (d) the cut
    # adversarial steps on two ranks on the one card
    parallel_results = run_parallel(torch, ops, recipe3d, trained_3d)

    # the numbers of each kernel at its main path's shape: serving for the
    # forward, the recipe's batch 64 for the split backward, the 3D training
    # step's attention for the fused backward, the 128^3 96->32 call for
    # kernel 5, the probes' shape for kernels 6 and 7; launches from the 2D
    # recipe's run (kernels 1-3), the fused 3D recipe's run (kernel 4), the
    # DDIM-50 3D sample (kernel 5) and the probe entry points (kernels 6, 7)
    numbers = dict(
        flash_fwd=forward["serve_f32"],
        flash_bwd_dq=backward["train_recipe_f32"]["dq"],
        flash_bwd_dkv=backward["train_recipe_f32"]["dkv"],
        flash_bwd_fused=backward["3d_level2_bf16"]["fused"],
        fused_conv=fused[FUSED_MAIN_CASE],
        **probe_numbers,
    )
    launches = dict(trained["launches"], fused_conv=fused_launches,
                    flash_bwd_fused=trained_3d["fused"]["launches"]["flash_bwd_fused"],
                    **probe_launches)
    # kernels 1-4's numbers under the other two contracts (phase 2 (d)), with
    # kernel 1's launches in phase 2 (d)'s UNet forward of each; kernels
    # 2-4 run them on no main path yet
    extra = {name: dict(contracts=entry) for name, entry in contract_numbers(contracts).items()}
    for contract, count in contract_launches.items():
        extra["flash_fwd"]["contracts"][contract]["launches"] = count
    # kernels 1-4 at every phase-2 case, each with its body (`body`:
    # `attention_route`'s wgmma body for bf16 at D = 64, else mma.sync)
    extra["flash_fwd"]["forward_cases"] = forward
    for name, part in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv"),
                       ("flash_bwd_fused", "fused")):
        extra[name]["backward_cases"] = {case: entry[part] for case, entry in backward.items()}
    # kernels 1-3 on phase 4 (b)'s bench.py step (bf16, batch 128): phase 2's
    # numbers at its shape (kernels 2 and 3 on their D = 256 wgmma body),
    # with the step's launches
    for name, entry in (("flash_fwd", forward["train_bench_bf16"]),
                        ("flash_bwd_dq", backward["train_bench_bf16"]["dq"]),
                        ("flash_bwd_dkv", backward["train_bench_bf16"]["dkv"])):
        extra.setdefault(name, {})["bench_bf16"] = dict(entry, launches=bench["launches"][name])
    # kernels 1-4 on phase 10's f32 3D LDM path: phase 2's numbers at the
    # stage-1 AEKL's shape, with the launches of the f32 recipe run (kernel 4
    # from the fused run)
    stage1 = dict(flash_fwd=forward["aekl_3d_f32"],
                  flash_bwd_dq=backward["aekl_3d_f32"]["dq"],
                  flash_bwd_dkv=backward["aekl_3d_f32"]["dkv"],
                  flash_bwd_fused=backward["aekl_3d_f32"]["fused"])
    for name, entry in stage1.items():
        run = ldm3d_results["f32_fused" if name == "flash_bwd_fused" else "f32_split"]
        extra.setdefault(name, {})["ldm3d_f32"] = dict(entry, launches=run["launches"][name])
    # kernels 1-4 in the causal contract at head width 32 on phase 11's AR
    # training path: phase 2's numbers at the recipe's stage-2 shape, with the
    # launches of the recipe's run (kernel 4 from the fused run)
    ar = dict(flash_fwd=forward["ar_causal_f32"],
              flash_bwd_dq=backward["ar_causal_f32"]["dq"],
              flash_bwd_dkv=backward["ar_causal_f32"]["dkv"],
              flash_bwd_fused=backward["ar_causal_f32"]["fused"])
    for name, entry in ar.items():
        run = ar_trained["fused" if name == "flash_bwd_fused" else "split"]
        extra.setdefault(name, {})["ar_causal_f32"] = dict(entry, launches=run["launches"][name])
    # the phase-14 paths' launches: the 2D export served, train_controlnet's run
    extra["flash_fwd"]["export_2d_launches"] = exports["export_2d"]["launches"]
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        extra.setdefault(name, {})["train_controlnet_launches"] = (
            exports["controlnet"]["launches"][name])
    # phase 15's launches (the --data-parallel run; rank 0's over the cut
    # stage-1 step of (d)) and pieces, n ranks
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        extra.setdefault(name, {})["data_parallel_launches"] = (
            parallel_results["dp"]["launches"][name])
        extra[name]["cut_stage1_launches"] = parallel_results["adversarial"]["launches"][name]
        extra[name]["sequence_parallel"] = {
            f"n{n}": parallel_results["chunks"][n][name] for n in P15_CUTS}
    extra.setdefault("fused_conv", {})["halo_slab"] = {
        f"n{n}": entry for n, entry in parallel_results["chunks"]["fused_conv"].items()}
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=CSRC + source, replaces=replaces,
             launches=launches[name], **numbers[name], **extra.get(name, {}))
        for name, (_, source, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
