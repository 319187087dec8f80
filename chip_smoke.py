"""Checks of the PyTorch port (histogan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

The card's check gate: every phase holds a path of the port to a plain
version, to the CPU, to the JAX package's files or to itself, and raises on
the first failed check. Speed is measured by ``python -m benchmark.run``;
this script times only what no benchmark cell can show, a kernel alone
(phases 3, 6 and U). Phases, each printing its lines:
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
  2. build: compiles both histogram kernels from histogan_tpu_torch/csrc
     (one nvcc each, started together), prints their ptxas reports, holds
     both to no spills and counts the HMMA (tensor-core) instructions that
     cuobjdump -sass finds in each library, which must be some;
  3. kernel: K1 (forward) against its plain torch version at the shapes
     the paths give it, fp32 with TF32 off; per shape the wrapper's time
     (CUDA events), the kernels' device time (torch.profiler), the bound
     and its share, and library_ms, one fp32 torch.matmul of the same
     products on precomputed operands (a yardstick the port never calls);
  4. slice: HistoGAN sampling at 256 px, capacity 16, latent 512, style
     depth 8, batch 16: weights from seed 0 written as a reference-layout
     .pt and loaded back, one 384x512 target image, 8 x 8 tiles = 64
     samples through the CLI's per-target function (K1 and U1 launched);
  5. reference: two of those samples recomputed on the CPU with the same
     weights, latents and noise;
  6. backward: K2 against its plain version, timed and bounded as in
     phase 3;
  U. upsample: U1 and U2, the 2x bilinear upsample (csrc/upsample2x.cu),
     built and held to no spills, at the 12 upsample shapes of G's forward
     at 256 px capacity 16, batch 16: U1 equal to aten's forward bit for
     bit and within 2 fp32 ulps of its plain version, U2 equal to its plain
     version bit for bit and within 1e-6 relative of aten's backward; per
     shape the event time, the device time, the HBM bound and its share,
     the plain version's time and library_ms (aten's forward or backward,
     which the port no longer calls), and their sums over a G forward;
  7. loss gradient: d Hellinger / d images at (16, 256, 256, 3) through the
     kernels against the same on the CPU (the plain versions);
  8. train: Trainer.set_data_src on 64 written images and Trainer.train
     for steps 0-9 at 256 px, capacity 16, latent 512, style depth 8,
     batch 16, fp32, on the default device_dataset 'auto' (the batch source
     held to DeviceDataSource, as in every phase_train run): finite
     losses, one K1 and one K2 a step, U1 and U2 launched, S/H/G/D moved;
     then save, load into a new Trainer and one more step;
  F1. FID after phase 8's steps: Trainer.calculate_fid(256) with the seeded
     random-features extractor, its value with its provenance, again at the
     same step (the same value to FID_REPEAT_RTOL), and the card's pool3
     features against the CPU's on 2 images at 299 px;
  8b. the same in bf16 (precision, opt_state_dtype and ema_dtype 'bf16'),
     with one more step on the EMA schedule, whose stochastically rounded
     EMA is held to the exact fp32 EMA; the dtypes of the weights, the EMA
     and the optimizer state are checked before and after the resume;
  DD1. the loaders: phase 8's 10 steps on the streaming loader
     (device_dataset False: pinned batches, the next one copied on a side
     stream behind the step), and with sync_every 4 on each source; per run
     the steps that read their metrics back and exactly one K1 and one K2
     a step; then a NaN injected on the card is read at the next sync step
     and rolls the weights back to checkpoint 0;
  DD1r. reHistoGAN bf16 at 2 x 8 on both sources, each syncing every step
     and every 4th: K1 and K2 exactly 16 and 8 a step, the metrics read
     back on the sync steps;
  DD2. residency: a DeviceDataSource over a synthetic 4319 x 256 x 256 x 3
     uint8 cache and a 4319 x 3 x 64 x 64 pool (the reference's landscape
     set): torch.cuda.memory_allocated grows by their bytes; at 16 x 1, at
     2 x 8 with self_hist and include_g_images and with aug_prob 0.5 a
     batch behind queued device work does not wait for it, and each batch
     is held to numpy indexing of its draws and the on-card crop to the
     CPU's crop_resize_u8;
  D1. the discriminator's options: phase 8's 10 steps, save, load and one
     more step with aug_prob 0.25 (color, translation, cutout, offset),
     attention at layers 1-2 and a VQ codebook of 256 codes at layer 3,
     fp32; the codebook bit for bit across the save and load;
  D1b. the same in bf16 (precision, opt_state_dtype, ema_dtype) with VQ
     at layer 8, the last block: the only VQ placement the JAX package
     runs under bf16 (the port refuses the others);
  D1r. the recoloring step with attention at layers 1-2 and VQ at layer 3
     at the CLI's batch 2 x accumulation 8, 3 steps; a D phase moves the
     codebook and a G phase leaves it as it is;
  D1c. card vs CPU: phase 9's step-0 step (GP and PL) with D1's options
     and aug_prob 1 (every augmentation function runs), the CPU run
     replaying the card's kinks and VQ codes (the rows whose own code
     differs are counted) and held to phase 9's pinned gates in form, the
     codebook after the step to CODEBOOK_RTOL;
  9. card vs CPU: one step-0 train step (GP and PL) at full width and
     batch 2 on both devices from the same weights, batch and draws, and
     once more on the CPU with the kinks pinned: every leaky_relu and relu
     call takes the slope that its input's sign gave it on the card
     (``recorded_kinks``, ``pinned_kinks``), so its gradients are held far
     tighter (PINNED_GRAD_RTOL); then the same step without the gradient
     penalty;
  9b. the step-0 step (GP and PL) under precision='bf16' against fp32 on
     the card at full width and batch 2, and against bf16 on the CPU at
     BF16_CPU_SIZE px (bf16 on the CPU costs several times fp32);
  R1. recolor (reHistoGAN) at 256 px, capacity 16, latent 512, style depth
     8, skip connections to the GAN head: weights from seed 0 written as a
     reference-layout .pt; ``rehistogan-torch``'s train_from_folder
     (generate=True) toward a target JPEG, a target .npy and, with
     sampling, a pool .npy; RecoloringTrainer.evaluate at 16 images; the
     card's recolor against the CPU's;
  R2. recoloring training: RecoloringTrainer.set_data_src on 64 written
     images and steps 0-9 at batch 2 x accumulation 8, fp32, then save,
     load into a new trainer and one more step; K1 and K2 launches per
     step;
  R3. card vs CPU: the recoloring step-0 step at full width, batch 2,
     with and without the GP, in phase 9's gate forms (the GP step also
     pinned);
  R1b. the recolor under --precision bf16 through train_from_folder, and
     the bf16 recolor held to the fp32 one on the card;
  R4. full-resolution output: train_from_folder(generate=True) with
     --upsampling_output True --upsampling_method BGU on a 384x512 photo,
     then the CLI's process_image on that photo and a 200x180 one with the
     pyramid, BGU on the scipy and on the native backend, downscaling, and
     --post_recoloring, on a card and a CPU trainer whose recolors take one
     noise; each card file at the size JAX's evaluate writes, each mode's
     final image from the card's recolor held to the CPU's; BGU on the
     native solver held to BGU on scipy (BGU_NATIVE_TOL), with the native
     solver's iterations and residual per channel;
  H1. the pool CLIs: histogan-create-hist-data-torch on 8 photos (K1 8
     times at (1, 250^2)) and histogan-create-hist-sample-torch on one (K1
     once at (1, 150^2)), each held to the same command with --device cpu;
  R2b. R2's 10 + 1 steps under precision and opt_state_dtype 'bf16', the
     dtypes checked across the save and load;
  R3b. the recoloring step-0 step under bf16 against fp32 on the card (256
     px) and against bf16 on the CPU (BF16_CPU_SIZE px), in phase 9b's
     gates (each loss, each tensor's gradient cosine).
  P1. projection (GAN inversion) at 256 px, capacity 16, latent 512,
     style depth 8, seeded weights, VGG on (seeded weights at the real
     shapes behind VGG16_WEIGHTS), both modes, card vs CPU from the same
     photo and draws: the start render, the step-0 losses and gradients,
     also with the card's kinks pinned on the CPU; then 50 card steps
     lower the reconstruction loss;
  P3. histogan-projection-gaussian-torch and -to-latent-torch through
     main([...]) on a saved flagship checkpoint (20 steps, --save_every 10),
     then --generate toward a JPEG, a .npy and a folder, and (gaussian)
     with --post_recoloring and with --upsampling_output (pyramid): each
     file the JAX package writes, by name and size, the npz keys and shapes
     as JAX's; K1 counted on each path.
  RM. remat at the main path's width and batch (256 px, capacity 16,
     batch 16, fp32): a plain and a GP+PL step, each from the seed's
     weights, with remat and without, on the same pinned inputs: the metrics to 5e-5, the
     parameters after them and the gradients each phase of both steps
     hands to DiffGrad (G's also from its phase alone, against the seed's
     D) to a global-norm relative error of 1e-5 (the JAX
     package's gates), or 3 times what the same step without remat
     moves between runs (the card's atomics; the step without remat runs
     three times, and each gap and floor is a median), K1 and K2 launched
     alike;
     R5, one bf16 recoloring GP step at the CLI's defaults with remat and
     without (the bf16 cast's functional_call under the checkpoint): its
     metrics to 1e-2, its D and G gradients as RM's; R512, the JAX
     package's 512 px recipe (capacity 16, batch 8, bf16, bf16 DiffGrad
     state), a plain and a GP+PL step with and without remat, finite;
  ranks. tools/dp_step.py spawns 2 ranks on the one card over gloo (NCCL
     takes one rank a GPU), once, for the cases of DP, FS, FS512 and DS;
  DP. data parallel at a global batch of 8 (256 px, capacity 16): 3 pinned
     steps (GP+PL, plain, GP) against the same steps in this process: step
     0's D losses to 5e-5 and D's step-0 gradient to 1e-5 (before any
     update), the rest to bounds on the GAN's drift (DP_G_METRIC_RTOL,
     DP_DRIFT_*), the ranks' parameters bitwise equal, K1 and K2 on every
     rank;
  FS. DP's case with param_sharding='fsdp' (parallel/fsdp.py): DP's gates
     against DP's one-process runs, the gathered state bitwise equal on
     both ranks, K1 and K2 once a step on each, each rank's state under 0.6
     of DP's; then ``torchrun --nproc_per_node 1
     -m histogan_tpu_torch.cli.histogan ... --num_devices 1 --param_sharding
     fsdp`` over NCCL for 2 steps (capacity 4: its step-0 checkpoint stays
     small), whose model_0.pt loads into a one-process replicated Trainer;
  FS512. R512's recipe (512 px, capacity 16, bf16, bf16 DiffGrad state)
     with remat, sharded over the 2 ranks at a global batch of 8, a plain
     and a GP+PL step: finite metrics, the ranks' gathered state alike, K1
     and K2 on each;
  DS. the device dataset's "sharded" placement: DD2's cache and pool on
     the 2 ranks under a per-device budget of half their bytes plus 1 MiB,
     ceil(4319 / 2) rows a rank, the ranks' batches side by side bit for
     bit the replicated source's at DD2's three configurations;
  DB. checkify_step around a plain 256 px batch 16 step passes and sees the
     backward's ops (convolution_backward) on the card; with one D weight
     NaN it raises naming the op;
  PF. Trainer.enable_profiling(1, 2) on a 3-step run writes a Chrome trace
     of steps 1-2 holding K1's and K2's kernels.
DD1, DD2, D1, D1b, D1r, R1, R1b, R4, H1, R2, R2b, P3, RM, ranks, DP, FS,
FS512, DS, DB and PF run after phase 8b, before the phases that run steps
on the CPU; D1c runs after phase 9. Phases 3 and 6 hold K1 and K2 at the
recoloring shapes too: (1, 64^2), a recolor target; (2, 64^2), the loss;
K1 at (2, 64^2) on the hist-of-hist input, a histogram read as an image;
and K1 at (1, 250^2), a pool entry.
Each phase prints its seconds, and the run its total. Then one JSON line
with the kernels, and last the result line. Any failed check raises, so the
script exits non-zero and prints no result. The whole run, the kernels'
builds included, is to end within 1200 s.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
KERNEL_TOL_ABS = 1e-6  # normalised histogram, max |kernel - plain|
KERNEL_TOL_REL = 1e-5  # the same over max |plain|; K2: per column
# d(loss)/d(images), kernels vs plain, relative to the largest entry: the
# JAX package's gate for its Pallas kernels (tests/test_histogram_pallas.py)
GRAD_TOL_REL = 1e-4
# Card vs CPU at full width: 14 modulated convs of up to 2048 x 9 terms
# summed in other orders (cuDNN vs the CPU's algorithms), fp32 throughout.
SLICE_TOL = 1e-3
# Card vs CPU recolor (reHistoGAN) at full width. With weights drawn from a
# seed the recolor's output before its clip to [0, 1] reaches ~800 (0.2 %
# of it lies inside (0, 1)); there fp32 rounding alone puts the CPU and the
# card (cuDNN, some convolutions by FFT) ~2e-3 and ~5e-3 from a float64
# forward (phase R1 prints both; PERF.md). So the two are held to a share
# of the largest pre-clip entry, not to SLICE_TOL absolute.
RECOLOR_TOL_REL = 2e-5
STEP_LOSS_RTOL = 1e-3  # card vs CPU train step losses, the same reason
LR = 2e-4
# Card vs CPU gradients, per tensor, relative to its largest entry. A
# leaky-ReLU input within fp32 rounding of 0 takes the other slope on one
# side; in D's last blocks (4x4 and 2x2 positions) one such entry moves its
# channel's gradient by percents, and the gradient penalty differentiates
# through the same kinks twice. So the gradients agree far less closely
# than the losses (PERF.md, "Card vs CPU").
STEP_GRAD_RTOL = 5e-2
# Card vs CPU post-step parameters. DiffGrad's first update moves an entry
# by -lr * u(g), u(g) = sigmoid(|g|) * g / (|g| + eps / sqrt(1 - b2)).
# Where |g_cpu| exceeds its tensor's measured card-vs-CPU gradient gap the
# sign of g is settled on both sides; there the parameters may differ by
# lr * |u(g_card) - u(g_cpu)| (at most lr |dg| / 4 away from 0) and fp32
# rounding, STEP_PARAM_CLOSE. At least STEP_SETTLED_MIN of the live
# entries must be settled, so that the gate covers the bulk of them.
STEP_PARAM_CLOSE = 1e-6
STEP_SETTLED_MIN = 0.5
# Card vs CPU gradients with the kinks pinned (phase 9, R3, P1): the CPU
# step replays the sign mask that every leaky_relu and relu input had on
# the card (``recorded_kinks``, ``pinned_kinks``), so that no entry takes
# the other slope on one side and what is left is the rounding of fp32
# sums taken in other orders. Per tensor, relative to its largest entry.
# Measured (NVIDIA H100 80GB HBM3, 700 W, two runs of this script), the
# worst tensor: phase 9's GP+PL step 3.556e-5 and 4.169e-5 (8.243e-3
# unpinned, 48-51 leaky_relu entries flipped), its PL step 5.884e-5 and
# 5.853e-5 (4.005e-3 unpinned); R3's GP step 1.636e-4 and 1.659e-4
# (1.820e-2 unpinned), its plain step 3.384e-5 and 2.474e-5 (8.096e-2
# unpinned, D.blocks.6.net.0.bias: a kink, not the CPU's rounding); P1
# 1.222e-6 to 1.819e-6 (5.251e-4 unpinned; 8-9 leaky_relu and 14 relu
# entries flipped). Each gate allows about 3 times the largest gap of its
# phase (P1 about 5 times).
PINNED_GRAD_RTOL = 2e-4
REHISTO_PINNED_GRAD_RTOL = 5e-4
PROJECTION_PINNED_GRAD_RTOL = 1e-5
# A conv bias that feeds an InstanceNorm (reHistoGAN's encoder) has an
# exact gradient of 0; on either device it is rounding, held to this share
# of its weight's largest gradient entry.
NORMED_BIAS_RTOL = 1e-5
# Phase 9b: the step-0 step under bf16 on the card against fp32 on the
# card and against bf16 on the CPU. bf16 rounds G's images and D's
# activations to 8 bits, and any other order of summation rounds them
# elsewhere, so the losses move by percents, not by fp32 rounding: each
# loss relative (d_loss and g_loss, means of D's logits, relative to the
# larger of the two, since either may sit near 0), the gradients by their
# cosine per tensor. Measured on the card (NVIDIA H100 80GB HBM3, 700 W),
# against fp32 / against the CPU: d_loss 4.5e-3 / 8.4e-3, g_loss 3.7e-2 /
# 4.8e-2, gp_loss 6.4e-3 / 3.6e-3, h_loss 6.1e-4 / 1.1e-3, pl_mean
# 9.9e-4 / 2.8e-3; worst tensor's cosine 0.9715 / 0.9802. The gates allow
# about 2.5 times the larger loss error and 3.5 times the worst 1 - cosine.
BF16_LOSS_RTOL = {"d_loss": 2.5e-2, "g_loss": 1.2e-1, "gp_loss": 2e-2, "h_loss": 3e-3,
                  "pl_mean": 1e-2}
BF16_GRAD_COS = 0.9
BF16_CPU_SIZE = 64
BF16 = dict(precision="bf16", opt_state_dtype="bf16", ema_dtype="bf16")
# (B, N) of packed and its input, K1: "pixels" of random images, or
# "hist_of_hist", a histogram read as a 64x64 image (reHistoGAN's variance
# loss), whose pixels are ~1e-4: held by the relative gates alone
SHAPES = [(1, 150 * 150, "pixels"), (16, 64 * 64, "pixels"), (8, 250 * 250, "pixels"),
          (1, 250 * 250, "pixels"), (1, 64 * 64, "pixels"), (2, 64 * 64, "pixels"),
          (2, 64 * 64, "hist_of_hist")]
BWD_SHAPES = [(16, 64 * 64), (16, 150 * 150), (3, 4097), (2, 64 * 64)]  # (B, N) of packed, K2
MAIN_SHAPE = (16, 64 * 64)  # both kernels on the training path: the loss's histograms
# (channels, input side) of the 12 upsamples of G's forward at 256 px,
# capacity 16: six of x (blocks 1-6), six of the RGB (blocks 0-5); U1 and
# U2 are timed at batch 16. U1 is held to aten's forward bit for bit and to
# its plain version within 2 fp32 ulps of the largest value, U2 to its
# plain version bit for bit and to aten's backward within
# UPSAMPLE_BWD_RTOL of it (tests/test_torch_cuda.py's gates)
UPSAMPLE_SHAPES = [(2048, 4), (1024, 8), (512, 16), (256, 32), (128, 64), (64, 128),
                   (3, 4), (3, 8), (3, 16), (3, 32), (3, 64), (3, 128)]
UPSAMPLE_BATCH = 16
UPSAMPLE_BWD_RTOL = 1e-6
INV_SIGMA2 = 1.0 / (0.02 * 0.02)
FLAGSHIP = dict(image_size=256, network_capacity=16, latent_dim=512, style_depth=8)
# reHistoGAN at the rehistogan CLI's defaults (histogan_tpu/cli/rehistogan.py:261-347)
REHISTO = dict(FLAGSHIP, skip_conn_to_GAN=True, variance_loss=True, rec_loss="laplacian",
               internal_hist=False, hist_bin=64, hist_insz=150, hist_resizing="sampling")
REHISTO_HYPER = dict(alpha=32.0, beta=1.5, gamma=2.0)
REHISTO_ACCUM = 8
REHISTO_PARTS = ("ED", "H", "G", "D")
REHISTO_BF16 = dict(precision="bf16", opt_state_dtype="bf16")
# R1b: the bf16 recolor against the fp32 one on the card, relative to the
# largest pre-clip entry. bf16 keeps 8 bits (a relative spacing of 3.9e-3)
# and rounds after every layer; on the CPU at 32 px JAX's own bf16 recolor
# lies 1.5e-2 of the largest entry from its fp32 one
# (tests/test_torch_rehisto_bf16.py). Measured at 256 px, seeded weights
# (outputs to ~830): 3.332e-2 (NVIDIA H100 80GB HBM3, 700 W).
RECOLOR_BF16_TOL_REL = 5e-2
# R4: evaluate's file: save_image_grid's 2 px border on each side, and
# rehistogan's default --pyramid_levels
GRID_BORDER = 4
R4_PYRAMID_LEVELS = 6
# R4: the post-processed image from the card's recolor against the one from
# the CPU's recolor (the same weights and noise), as a multiple of the two
# recolors' gap after the clip (R1's measure): the pyramid swaps in the
# recolor's coarse level through bicubic resizing and pyrUp (max-norm gain
# about 1.3), MKL moves the photo by the recolor's mean and a 3x3 map of its
# covariance, BGU fits an affine grid to it by least squares. Each map is
# smooth in the recolor; the factor allows several times the largest gain.
# Measured (NVIDIA H100 80GB HBM3, 700 W): at most 1.00 times (downscaling,
# whose image is the recolor itself), BGU 0.09, the pyramid and MKL ~0.
POST_FACTOR = 10.0
# R4: BGU on the native solver against BGU on scipy's direct solve, the
# final image from the same recolor: the tests' gate (tests/test_torch_post.py,
# NATIVE_TOL). A native fit that does not reach its tol raises.
BGU_NATIVE_TOL = 5e-3
HIST_ATOL = 1e-6  # DD2: a gathered histogram against numpy's of the same draws
# R3b: the recoloring step-0 step under bf16 against fp32 on the card, in
# phase 9b's gate forms: each loss relative, each tensor's gradient cosine.
# Measured at 256 px (NVIDIA H100 80GB HBM3, 700 W): d_loss 1.0e-3, g_loss
# 1.9e-3, gp_loss 1.4e-3, h_loss 3.9e-3, r_loss 1.156e-1 (the Laplacian of
# G's bf16 output, which reaches ~800 where bf16's spacing is 4), var_loss
# 8.0e-3; the worst tensor's gradient cosine 0.9806 (an ED encoder conv),
# and at 64 px card bf16 against CPU bf16 0.9453 (ED.mapping.bias). As in
# phase 9b the loss gates allow about 3 times each error; the tensors are
# held to phase 9b's cosine, about 5 and 1.8 times the worst 1 - cosine.
REHISTO_BF16_LOSS_RTOL = {"d_loss": 5e-3, "g_loss": 1e-2, "gp_loss": 5e-3, "h_loss": 1.5e-2,
                          "r_loss": 0.35, "var_loss": 3e-2}
REHISTO_BF16_GRAD_COS = BF16_GRAD_COS
# R3b at BF16_CPU_SIZE px, card bf16 against CPU bf16: each gap within its
# gate above or this many times the gap between the card's bf16 and fp32
# steps (the rule of tests/test_torch_rehisto_bf16.py). Measured: at most
# 2.5 times (h_loss 5.2e-3 against bf16's own 2.1e-3).
NOISE_FACTOR = 3.0
# H1: the pools, card against CPU: the repo's histogram gate, L1 per histogram
HIST_L1 = 1e-5
# D1 / D1b: the discriminator's options at the flagship width. D1b keeps
# VQ at the last block, the only place the JAX package runs it under bf16
D_OPTIONS = dict(aug_prob=0.25, aug_types=("color", "translation", "cutout", "offset"),
                 attn_layers=(1, 2), fq_layers=(3,), fq_dict_size=256)
D_OPTIONS_BF16 = dict(D_OPTIONS, fq_layers=(8,), **BF16)
# D1's card vs CPU step runs every augmentation function (the gate always on)
D_OPTIONS_CMP = dict(D_OPTIONS, aug_prob=1.0)
# Card vs pinned CPU codebook after the step, relative to each buffer's
# largest entry: with the card's codes replayed, the EMA update sums the
# same rows of D's features, which differ by fp32 rounding. Measured
# (NVIDIA H100 80GB HBM3, 700 W, D1c): 8.177e-7 (embed_avg); about 6 times.
CODEBOOK_RTOL = 5e-6
# D1c's gradients with the kinks and codes pinned, per tensor relative to
# its largest entry (PINNED_GRAD_RTOL's form). The worst tensor is a
# Rezero gate g of the attention at layer 2: a scalar whose gradient is one
# sum over every activation of that layer, taken through the GP's double
# backward, so it is held relative to itself. Measured (NVIDIA H100 80GB
# HBM3, 700 W): 1.740e-4 (D.attn_blocks.1.0.fn.g; 44 leaky_relu entries
# flipped); about 3 times, as REHISTO_PINNED_GRAD_RTOL.
D_OPTIONS_PINNED_GRAD_RTOL = 5e-4
CARD = "cuda"  # the device under test
# DD2: the reference's landscape set (histogan_tpu/data/device_source.py:9-11)
# as a synthetic uint8 cache at 256 px and its 64-bin pool, and the batch
# shapes each trainer draws from it
RESIDENCY_IMAGES = 4319
RESIDENCY_DATA = (RESIDENCY_IMAGES, 256, 64, 0)  # tools/dp_step.py's synthetic_data
CROP_LEVELS, CROP_SHARE = 1, 1e-3  # on-card crop vs the CPU's: levels, share of entries
# DD2: a DeviceDataSource batch must not wait for the device. Behind
# torch.cuda._sleep of QUEUED_CYCLES (~0.1 s at the H100's 1.98 GHz) the
# host's call took 0.66 ms at 2 x 8 (NVIDIA H100 80GB HBM3, 700 W); a sync
# would take the whole ~100 ms
QUEUED_CYCLES, HOST_WAIT_MS = 200_000_000, 20.0
# F1: pool3 features, card vs CPU, on 2 images at 299 px through the seeded
# network (fp32, TF32 off on the card). Measured (NVIDIA H100 80GB HBM3,
# 700 W): max|d| 1.907e-6 on features up to 6.21 (3.071e-7 of the largest);
# the gate allows about 10 times that, 100 times under JAX's own oracle gate
# (atol 2e-4, rtol 1e-3; tests/test_inception.py)
FID_FEATURE_ATOL, FID_FEATURE_RTOL = 2e-5, 0.0
FID_REPEAT_RTOL = 1e-6  # calculate_fid twice at one step


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def timed(phase: str, fn, *args):
    """``fn(*args)``, then the phase's seconds (the run's 1200 s budget)."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"seconds: phase {phase} {time.perf_counter() - t0:.2f}")
    return out


def time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 50, kernel: str = "hist_") -> float:
    """Device time per call of the kernels whose names hold ``kernel``
    that ``fn`` launches once each, from torch.profiler's device events over ``reps``
    calls (the wrapper's host work left out). The profiler may drop an
    event now and then, so each kernel's time is averaged over the
    launches it recorded. A session may come back with no device events,
    or with most of them dropped: it is profiled again, up to 5 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and kernel in e.key]
        recorded = bool(events) and all(reps // 2 <= e.count <= reps for e in events)
        if recorded:
            break
        print(f"profiler: session {attempt + 1} recorded the {kernel} kernels "
              f"{[(e.key[:40], e.count) for e in events]} times of {reps}; profiling again")
    check(recorded,
          f"the profiler saw each {kernel} kernel up to {reps} times: "
          f"{[(e.key[:40], e.count) for e in events]}")
    return sum(e.self_device_time_total / e.count for e in events) / 1e3


def bin_operands(histogram_cuda, packed):
    """iy * ku and kv, (B, 3, N, 64) each, as the plain versions compute them."""
    centers = histogram_cuda._centers(packed.device)
    iy = packed[:, None, :, 6:7]
    u = packed[..., 0:6:2].transpose(1, 2)[..., None]
    v = packed[..., 1:6:2].transpose(1, 2)[..., None]
    ku = 1.0 / (1.0 + torch.square(u - centers) * INV_SIGMA2)
    kv = 1.0 / (1.0 + torch.square(v - centers) * INV_SIGMA2)
    return iy * ku, kv


def library_ms(a: torch.Tensor, b: torch.Tensor) -> float:
    """One fp32 torch.matmul(a, b) (TF32 off), timed like the kernels."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 off for the library yardstick")
    return time_ms(lambda: torch.matmul(a, b), 50)


def bound_row(histogram_cuda, name: str, b: int, n: int, dev_ms: float) -> dict:
    bms, by = histogram_cuda.bound_ms(histogram_cuda.kernel_work(name, b, n))
    return {"bound_ms": bms, "bound_by": by, "share": bms / dev_ms}


def alternate_ms(plain, kernel, reps: int = 50):
    """plain, kernel, kernel, plain; returns (kernel ms, plain ms, the four)."""
    p1, k1, k2, p2 = (time_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return min(k1, k2), min(p1, p2), (p1, k1, k2, p2)


def normalise(h: torch.Tensor) -> torch.Tensor:
    return h / (h.sum(dim=(1, 2, 3), keepdim=True) + 1e-6)


def reset_counts(histogram_cuda) -> None:
    from histogan_tpu_torch.ops import resize

    histogram_cuda.launches = 0
    histogram_cuda.bwd_launches = 0
    resize.launches = 0
    resize.bwd_launches = 0


def check_no_spills(name: str, lib: Path) -> None:
    """Prints the ptxas report kept beside ``lib`` and holds it to no spills."""
    spills = []
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {name} ptxas {line.strip()}")
        if "spill" in line:
            spills.append(line.strip())
    check(bool(spills) and all("0 bytes spill stores, 0 bytes spill loads" in line
                               for line in spills), f"{name} spills no registers: {spills}")


# ---------------------------------------------------------------- phases
def phase_build(histogram_cuda) -> dict:
    """Builds both kernels, holds both to no register spills; returns
    {name: the HMMA count of its library} (None where the toolkit has no
    cuobjdump)."""
    from histogan_tpu_torch.ops import cuda_build

    libs = cuda_build.build(("histogram_fwd", "histogram_bwd"))
    for name in libs:
        histogram_cuda._library(name)
    print(f"build: {', '.join(sorted(libs))}")
    hmma = {}
    cuobjdump = Path(cuda_build.nvcc()).with_name("cuobjdump")
    for name, lib in sorted(libs.items()):
        check_no_spills(name, lib)
        if not cuobjdump.is_file():
            print(f"build: no {cuobjdump}; HMMA count not taken")
            hmma[name] = None
            continue
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True, check=True).stdout
        hmma[name] = sum("HMMA" in line for line in sass.splitlines())
        print(f"build: {name} {hmma[name]} HMMA instructions (cuobjdump -sass)")
        check(hmma[name] > 0, f"{name} runs on the tensor cores (HMMA in its SASS)")
    return hmma


def hist_of_hist_pixels(b: int, seed: int) -> np.ndarray:
    """(b, 64 * 64, 3): relu of b images' histograms read as 64x64 images,
    as reHistoGAN's variance loss reads its target histograms (plain
    version, on the CPU)."""
    from histogan_tpu_torch.ops.histogram import histogram_feature

    x = torch.from_numpy(np.random.default_rng(seed).random((b, 256, 256, 3), dtype=np.float32))
    hists = histogram_feature(x, resizing="sampling")
    return torch.relu(hists).permute(0, 2, 3, 1).reshape(b, -1, 3).numpy()


def phase_forward(histogram_cuda, dev):
    max_err, rows = 0.0, []
    for b, n, kind in SHAPES:
        if kind == "hist_of_hist":
            x = hist_of_hist_pixels(b, seed=b * 7919 + n)
        else:
            x = np.random.default_rng(b * 7919 + n).random((b, n, 3), dtype=np.float32)
        packed = histogram_cuda.pack_pixels(torch.from_numpy(x).to(dev)).contiguous()
        got = histogram_cuda.hist_core(packed, INV_SIGMA2)
        want = histogram_cuda.hist_core_reference(packed, INV_SIGMA2)
        torch.cuda.synchronize()
        g, w = normalise(got), normalise(want)
        err = (g - w).abs().max().item()
        rel = err / w.abs().max().item()
        raw_rel = ((got - want).abs().max() / want.abs().max()).item()  # un-normalised
        check(bool(torch.isfinite(got).all()), f"kernel output finite at B={b} N={n} {kind}")
        if kind == "pixels":
            check(err <= KERNEL_TOL_ABS,
                  f"max|kernel-plain| {err:.3e} <= {KERNEL_TOL_ABS} at B={b} N={n}")
            max_err = max(max_err, err)
        check(rel <= KERNEL_TOL_REL, f"relative {rel:.3e} <= {KERNEL_TOL_REL} at B={b} N={n} {kind}")
        check(raw_rel <= KERNEL_TOL_REL,
              f"un-normalised relative {raw_rel:.3e} <= {KERNEL_TOL_REL} at B={b} N={n} {kind}")
        ms, plain_ms, (p1, k1, k2, p2) = alternate_ms(
            lambda: histogram_cuda.hist_core_reference(packed, INV_SIGMA2),
            lambda: histogram_cuda.hist_core(packed, INV_SIGMA2))
        dev_ms = device_ms(lambda: histogram_cuda.hist_core(packed, INV_SIGMA2))
        iy_ku, kv = bin_operands(histogram_cuda, packed)
        lib_ms = library_ms(iy_ku.transpose(-1, -2), kv)  # (iy ku)^T kv
        del iy_ku, kv
        chunk, n_chunks = histogram_cuda.split_pixels(
            b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
        row = {"B": b, "N": n, "input": kind, "max_abs_err": err, "rel_err": rel,
               "raw_rel_err": raw_rel, "max_plain": want.abs().max().item(),
               "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               **bound_row(histogram_cuda, "histogram_fwd", b, n, dev_ms),
               "chunks": n_chunks, "chunk": chunk}
        rows.append(row)
        print(f"kernel: B={b} N={n} {kind} max|d|={err:.3e} rel={rel:.3e} "
              f"un-normalised rel={raw_rel:.3e} (max|plain| {row['max_plain']:.3e}) "
              f"kernel {k1:.4f}/{k2:.4f} ms plain {p1:.4f}/{p2:.4f} ms "
              f"({n_chunks} chunks of {chunk} px); device {dev_ms:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), share {row['share']:.3f}, "
              f"library {lib_ms:.4f} ms")
    return max_err, rows


def phase_upsample(dev) -> list:
    """Phase U: builds U1 and U2 (no spills), holds them at G's 12
    upsample shapes at batch 16 to aten's and to their plain versions in
    the gates of UPSAMPLE_SHAPES, and times each: the
    wrapper's event time, the kernel's device time, the HBM bound (input
    and output each once) and its share, the plain version's time and
    library_ms, aten's F.interpolate (forward) or upsample_bilinear2d's
    backward, a yardstick the port no longer calls. Returns the rows."""
    import torch.nn.functional as F

    from histogan_tpu_torch.ops import cuda_build, resize

    t0 = time.perf_counter()
    lib = cuda_build.build(("upsample2x",))["upsample2x"]
    print(f"build: upsample2x in {time.perf_counter() - t0:.2f} s")
    check_no_spills("upsample2x", lib)
    hbm = 3.35e12  # bytes/s, H100 SXM at 700 W
    rows, b = [], UPSAMPLE_BATCH
    for c, h in UPSAMPLE_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(c * h)
        x = torch.randn((b, c, h, h), generator=gen, device=dev)
        g = torch.randn((b, c, 2 * h, 2 * h), generator=gen, device=dev)
        y, dx = resize.upsample2x_cuda(x), resize.upsample2x_bwd_cuda(g)
        aten_y = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        aten_dx = torch.ops.aten.upsample_bilinear2d_backward(
            g, [2 * h, 2 * h], [b, c, h, h], False, 2.0, 2.0)
        torch.cuda.synchronize()
        plain_y = resize.upsample2x_plain(x)
        ulp = 2.0 ** (math.floor(math.log2(plain_y.abs().max().item())) - 23)
        fwd_gap = (y - plain_y).abs().max().item()
        bwd_rel = ((dx - aten_dx).abs().max() / aten_dx.abs().max()).item()
        check(torch.equal(y, aten_y), f"U1 equals aten's forward at {c}x{h}^2")
        check(torch.equal(dx, resize.upsample2x_bwd_plain(g)),
              f"U2 equals its plain version at {c}x{h}^2")
        check(fwd_gap <= 2 * ulp, f"U1 within 2 ulps ({2 * ulp:.3e}) of its plain version at "
                                  f"{c}x{h}^2: {fwd_gap:.3e}")
        check(bwd_rel <= UPSAMPLE_BWD_RTOL,
              f"U2 within {UPSAMPLE_BWD_RTOL} of aten's backward at {c}x{h}^2: {bwd_rel:.3e}")
        row = {"C": c, "H": h, "B": b, "fwd_gap_ulps": fwd_gap / ulp, "bwd_rel": bwd_rel}
        for kind, kernel, plain, library in (
                ("fwd", lambda: resize.upsample2x_cuda(x), lambda: resize.upsample2x_plain(x),
                 lambda: F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)),
                ("bwd", lambda: resize.upsample2x_bwd_cuda(g),
                 lambda: resize.upsample2x_bwd_plain(g),
                 lambda: torch.ops.aten.upsample_bilinear2d_backward(
                     g, [2 * h, 2 * h], [b, c, h, h], False, 2.0, 2.0))):
            ms, plain_ms, _ = alternate_ms(plain, kernel, reps=20)
            dev_ms = device_ms(kernel, kernel=f"upsample2x_{kind}_kernel")
            bound = 1e3 * 5 * x.numel() * x.element_size() / hbm
            row[kind] = {"ms": ms, "device_ms": dev_ms, "bound_ms": bound,
                         "share": bound / dev_ms, "plain_ms": plain_ms,
                         "library_ms": time_ms(library, 20)}
            r = row[kind]
            print(f"upsample: U{1 if kind == 'fwd' else 2} ({b}, {c}, {h}^2) event {ms:.4f} ms, "
                  f"device {dev_ms:.4f} ms, bound {bound:.4f} ms (bytes), share "
                  f"{r['share']:.3f}, plain {plain_ms:.4f} ms, library {r['library_ms']:.4f} ms")
        print(f"upsample: ({b}, {c}, {h}^2) U1 equals aten's forward, max|d| vs plain "
              f"{row['fwd_gap_ulps']:.2f} ulps of the largest; U2 vs aten relative {bwd_rel:.3e}")
        rows.append(row)
        del x, g, y, dx, aten_y, aten_dx, plain_y
    for kind in ("fwd", "bwd"):
        print(f"upsample: a G forward of {b} (12 upsamples): U{1 if kind == 'fwd' else 2} "
              f"device {sum(r[kind]['device_ms'] for r in rows):.4f} ms, bound "
              f"{sum(r[kind]['bound_ms'] for r in rows):.4f} ms, library "
              f"{sum(r[kind]['library_ms'] for r in rows):.4f} ms")
    return rows


def phase_sampling(histogram_cuda, dev, smi):
    from histogan_tpu_torch.cli.histogan import sample_target, tile_double
    from histogan_tpu_torch.ops import resize
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock, resize_if_needed
    from histogan_tpu_torch.train.trainer import Trainer

    work = WORK / "sampling"
    cfg = dict(FLAGSHIP, batch_size=16, hist_resizing="interpolation", hist_insz=150,
               hist_bin=64, trunc_psi=0.75, seed=0)
    src = Trainer("chip_smoke", work / "results", work / "models", device="cpu", **cfg)
    src.init_GAN()
    pt = work / "weights.pt"
    src.export_pt(pt)
    model = Trainer("chip_smoke", work / "results", work / "models", device="cuda", **cfg)
    model.init_GAN()
    skipped = model.load_pt(pt)
    check(skipped == [], f"every key of the written .pt loads (skipped {skipped[:4]})")
    n_params = sum(p.numel() for m in model.models().values() for p in m.parameters())
    print(f"slice: weights seed 0, {n_params} parameters (S/H/G/D + EMA), "
          f".pt {pt.stat().st_size} bytes written and loaded")

    img = np.random.default_rng(1).random((384, 512, 3), dtype=np.float32)
    hist_block = RGBuvHistBlock(insz=150, h=64, resizing="interpolation",
                                method="inverse-quadratic", sigma=0.02)
    tiles = 8
    reset_counts(histogram_cuda)
    out = sample_target(model, hist_block, image=img, num_image_tiles=tiles)  # resolves av
    launches = histogram_cuda.launches
    up_launches = resize.launches
    check(out.shape == (tiles * tiles, 256, 256, 3), f"output shape {out.shape}")
    check(bool(np.isfinite(out).all()), "output finite")
    check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "output in [0, 1]")
    check(float(out.std()) > 0.0, "output not constant")
    check(launches >= 1, f"histogram kernel launched on the sampling path ({launches})")
    check(up_launches >= 1, f"U1 launched on the sampling path ({up_launches})")

    x = torch.from_numpy(img[None]).to(dev)
    with torch.inference_mode():
        hist_path = hist_block(x)
        packed = histogram_cuda.pack_pixels(
            resize_if_needed(x.clamp(0, 1), 150, 64, "interpolation").reshape(1, -1, 3))
        hist_plain = normalise(histogram_cuda.hist_core_reference(packed, INV_SIGMA2))
    herr = (hist_path - hist_plain).abs().max().item()
    check(herr <= KERNEL_TOL_ABS, f"target histogram max|kernel-plain| {herr:.3e} <= {KERNEL_TOL_ABS}")
    print(f"slice: {tiles * tiles} samples 256x256 (fp32, {tiles * tiles // cfg['batch_size']} "
          f"G chunks of {cfg['batch_size']}; histogram kernel launches {launches}, U1 "
          f"{up_launches}; target hist max|d| {herr:.3e}) on {smi}")

    # ---- 5. two samples against the CPU with the same weights and inputs
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 512), dtype=np.float32)
    noise = rng.random((2, 256, 256, 1), dtype=np.float32)
    h2 = tile_double(hist_plain.cpu().numpy(), 2)
    src.av = model.av.cpu()
    imgs = {}
    for t in (model, src):
        with torch.inference_mode():
            imgs[t.device.type] = t.generate_truncated(
                t._ema_params(), torch.from_numpy(h2).to(t.device),
                torch.from_numpy(z).to(t.device), torch.from_numpy(noise).to(t.device),
                trunc_psi=cfg["trunc_psi"]).cpu().numpy()
    serr = float(np.abs(imgs["cuda"] - imgs["cpu"]).max())
    check(serr <= SLICE_TOL, f"card vs CPU samples max|d| {serr:.3e} <= {SLICE_TOL}")
    print(f"reference: 2 samples, card vs CPU max|d| {serr:.3e} (tolerance {SLICE_TOL})")
    return launches, up_launches


def phase_backward(histogram_cuda, dev):
    max_err, rows = 0.0, []
    for b, n in BWD_SHAPES:
        rng = np.random.default_rng(b * 104729 + n)
        x = rng.random((b, n, 3), dtype=np.float32)
        packed = histogram_cuda.pack_pixels(torch.from_numpy(x).to(dev)).contiguous()
        g = torch.from_numpy(
            1e-3 * rng.standard_normal((b, 3, 64, 64), dtype=np.float32)).to(dev)
        got = histogram_cuda._launch_bwd(packed, g, INV_SIGMA2)
        want = histogram_cuda.hist_core_bwd_reference(packed, g, INV_SIGMA2)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K2 output finite at B={b} N={n}")
        check(bool((got[..., 7] == 0).all()), f"K2 column 7 exactly 0 at B={b} N={n}")
        col_rel = []
        for c in range(7):
            err = (got[..., c] - want[..., c]).abs().max().item()
            rel = err / want[..., c].abs().max().item()
            check(rel <= KERNEL_TOL_REL, f"K2 column {c} relative {rel:.3e} <= "
                                         f"{KERNEL_TOL_REL} at B={b} N={n}")
            col_rel.append(rel)
            max_err = max(max_err, err)
        err = (got - want).abs().max().item()
        ms, plain_ms, (p1, k1, k2, p2) = alternate_ms(
            lambda: histogram_cuda.hist_core_bwd_reference(packed, g, INV_SIGMA2),
            lambda: histogram_cuda._launch_bwd(packed, g, INV_SIGMA2))
        dev_ms = device_ms(lambda: histogram_cuda._launch_bwd(packed, g, INV_SIGMA2))
        iy_ku, kv = bin_operands(histogram_cuda, packed)
        # [kv, iy ku] against [g^T, g], the three planes, in one call
        lib_ms = library_ms(torch.stack([kv, iy_ku], dim=2),
                            torch.stack([g.transpose(-1, -2), g], dim=2).contiguous())
        del iy_ku, kv
        row = {"B": b, "N": n, "max_abs_err": err, "max_col_rel_err": max(col_rel),
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               **bound_row(histogram_cuda, "histogram_bwd", b, n, dev_ms)}
        rows.append(row)
        print(f"backward: B={b} N={n} max|d|={err:.3e} worst column rel={max(col_rel):.3e} "
              f"kernel {k1:.4f}/{k2:.4f} ms plain {p1:.4f}/{p2:.4f} ms; device "
              f"{dev_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), share "
              f"{row['share']:.3f}, library {lib_ms:.4f} ms")
    return max_err, rows


def phase_loss_gradient(dev) -> float:
    from histogan_tpu_torch.ops.histogram import histogram_feature
    from histogan_tpu_torch.ops.losses import hellinger_histogram_loss

    rng = np.random.default_rng(5)
    x = rng.random((16, 256, 256, 3), dtype=np.float32) * 1.2 - 0.1  # relu and clip bite
    target = histogram_feature(torch.from_numpy(rng.random((16, 256, 256, 3), dtype=np.float32)),
                               resizing="sampling")
    grads = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):  # the CPU runs the plain versions
        xt = torch.from_numpy(x).to(d).requires_grad_(True)
        loss = hellinger_histogram_loss(
            target.to(d), histogram_feature(torch.relu(xt), resizing="sampling"))
        loss.backward()
        grads[name] = xt.grad.cpu()
    want = grads["cpu"]
    rel = (grads["card"] - want).abs().max().item() / want.abs().max().item()
    check(bool(torch.isfinite(grads["card"]).all()), "loss gradient finite")
    check(rel < GRAD_TOL_REL, f"d loss / d images kernels vs plain relative {rel:.3e} < {GRAD_TOL_REL}")
    print(f"loss gradient: (16, 256, 256, 3) sampling, kernels vs plain relative max|d| {rel:.3e} "
          f"(tolerance {GRAD_TOL_REL})")
    return rel


def write_images(folder: Path, n: int = 64) -> None:
    from PIL import Image

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(6)
    for i in range(n):  # 288x320: the loader resizes the shorter side and crops
        base = rng.random((9, 10, 3)) * 255
        img = np.kron(base, np.ones((32, 32, 1))) + rng.normal(0, 12, (288, 320, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(folder / f"{i:03d}.jpg",
                                                                  quality=95)


def check_dtypes(t, policy: dict, masters=("S", "H", "G", "D"), emas=("SE", "HE", "GE")) -> None:
    """fp32 masters; the EMA and DiffGrad's state in the policy's dtypes.
    reHistoGAN's trainer: masters ED, H, G and D, and no EMA."""
    ema = torch.bfloat16 if policy.get("ema_dtype") == "bf16" else torch.float32
    opt = torch.bfloat16 if policy.get("opt_state_dtype") == "bf16" else torch.float32
    s = t.state
    check(all(p.dtype == torch.float32 for k in masters for p in getattr(s, k).parameters()),
          "fp32 master weights")
    check(all(p.dtype == ema for k in emas for p in getattr(s, k).parameters()),
          f"EMA in {ema}")
    states = [st for o in (s.opt_g, s.opt_d) for st in o.state.values()]
    check(bool(states) and all(st[k].dtype == opt for st in states
                               for k in ("exp_avg", "exp_avg_sq", "previous_grad")),
          f"optimizer state in {opt}")


def check_ema_step(t, tag: str) -> None:
    """One step on the EMA schedule (steps > 20000, every 10th; no GP, PL,
    save, evaluation or reset there): every stored EMA entry is the exact
    fp32 EMA or, in bf16, one of its two bf16 neighbours."""
    ema = [p for k in ("SE", "HE", "GE") for p in getattr(t.state, k).parameters()]
    pre = [e.float() for e in ema]
    t.steps = 20010
    m = t.train()
    check(all(math.isfinite(v) for v in m.values()), f"finite losses on the EMA step: {m}")
    tol = 2.0 ** -7 if ema[0].dtype == torch.bfloat16 else 1e-6
    worst, moved = 0.0, 0
    for e0, p, e in zip(pre, t.state.g_params(), ema):
        want = e0 * 0.995 + 0.005 * p.detach()
        worst = max(worst, ((e.float() - want).abs() / (want.abs() + 1e-30)).max().item())
        check(bool(((e.float() - want).abs() <= want.abs() * tol + 1e-6).all()),
              f"EMA within {tol} of the exact fp32 EMA")
        moved += int(not torch.equal(e.float(), e0))
    check(moved > 0, "the EMA moved")
    print(f"{tag}: EMA step (steps=20010): {moved} of {len(ema)} EMA tensors moved, worst "
          f"relative distance to the exact fp32 EMA {worst:.3e} (bound {tol:.3e}), "
          f"stored {ema[0].dtype}")


def phase_train(histogram_cuda, smi, policy: Optional[dict] = None, tag: Optional[str] = None):
    """Phase 8 (fp32) or, with ``policy`` (BF16), phase 8b; with the
    discriminator's options in ``policy`` (D_OPTIONS, D_OPTIONS_BF16) and
    a ``tag``, D1 and D1b, which also hold the codebook across the save
    and load. Returns {kernel: launches}."""
    from histogan_tpu_torch.ops import resize
    from histogan_tpu_torch.train.trainer import Trainer

    policy = policy or {}
    label = policy.get("precision", "fp32")
    tag = tag or ("train" if label == "fp32" else f"train {label}")
    work = WORK / f"train_{tag.replace(' ', '_')}"
    data = WORK / "images"  # phase 8's 64 JPEGs, written once
    if not data.is_dir():
        write_images(data)
    cfg = dict(FLAGSHIP, batch_size=16, gradient_accumulate_every=1, hist_resizing="sampling",
               seed=0, save_every=1000, **policy)
    t = Trainer("train", work / "results", work / "models", device=CARD, **cfg)
    t.init_GAN()
    before = {k: v.detach().clone() for k, v in t.reference_state_dict().items()}

    reset_counts(histogram_cuda)
    t.set_data_src(str(data))
    pool_launches = histogram_cuda.launches
    source = type(t.loader).__name__
    print(f"{tag}: batch source {source} (device_dataset {t.device_dataset!r})")
    check(source == "DeviceDataSource", f"{tag}: the default 'auto' holds the data on the card")
    for step in range(10):
        m = t.train()
        flags = [name for name, on in (("GP", step % 4 == 0), ("PL", step % 32 == 0),
                                       ("EMA reset", step % 1000 == 2),
                                       ("save+evaluate", step == 0)) if on]
        print(f"{tag}: step {step} [{', '.join(flags) or 'plain'}] "
              + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())))
        check(all(math.isfinite(v) for v in m.values()), f"finite losses at step {step}: {m}")
    counts = {"histogram_fwd": histogram_cuda.launches, "histogram_bwd": histogram_cuda.bwd_launches,
              "upsample2x_fwd": resize.launches, "upsample2x_bwd": resize.bwd_launches}
    check(counts["histogram_fwd"] - pool_launches == 10 and counts["histogram_bwd"] == 10,
          f"one K1 and one K2 a step on the {label} training path: {counts} with "
          f"{pool_launches} K1 in the pool build")
    check(counts["upsample2x_fwd"] >= 1 and counts["upsample2x_bwd"] >= 1,
          f"U1 and U2 on the {label} training path: {counts}")
    after = t.reference_state_dict()
    for prefix in ("S", "H", "G", "D"):
        keys = [k for k in after if k.split(".")[0] == prefix]
        check(any(not torch.equal(after[k], before[k]) for k in keys), f"{prefix} changed")
    del before
    check_dtypes(t, policy)
    print(f"{tag}: 10 steps at batch 16, {label}; K1 launches {pool_launches} in the pool "
          f"build, {counts['histogram_fwd'] - pool_launches} in the 10 steps; K2 launches "
          f"{counts['histogram_bwd']} in the 10 steps; launches {counts} on {smi}")
    if policy.get("attn_layers") or policy.get("fq_layers"):
        print(f"{tag}: options {json.dumps(d_keys(policy))}")
    if policy.get("ema_dtype") == "bf16":
        check_ema_step(t, tag)

    if tag == "train":  # F1: FID after phase 8's steps
        timed("F1", phase_fid, t, smi)

    # save, load into a new Trainer, one more step
    book = {k: v.detach().clone() for k, v in t.state.D.named_buffers()}
    t.save(1)
    print(f"{tag}: checkpoint model_1.pt {t.store.path(1).stat().st_size} bytes")
    pl_mean, opt_steps = t.state.pl_mean.item(), t.state.step
    t.close()
    del t
    torch.cuda.empty_cache()
    r = Trainer("train", work / "results", work / "models", device=CARD, **cfg)
    r.load(-1)
    check(r.state.step == opt_steps and r.steps == cfg["save_every"],
          f"step counters carried over ({r.state.step}, {r.steps})")
    loaded = dict(r.state.D.named_buffers())
    check(set(loaded) == set(book) and all(torch.equal(loaded[k], v) for k, v in book.items()),
          f"the codebook bit for bit across the save and load ({len(book)} buffers)")
    check(len(book) == 3 * len(policy.get("fq_layers", ())), "three buffers per VQ layer")
    del book
    check(r.state.pl_mean.item() == pl_mean, f"pl_mean carried over ({r.state.pl_mean.item()})")
    check_dtypes(r, policy)
    r.set_data_src(str(data))
    m = r.train()
    r.close()
    check(all(math.isfinite(v) for v in m.values()) and r.state.step == opt_steps + 1,
          "one finite step after the resume")
    check_dtypes(r, policy)
    print(f"{tag}: saved at step {opt_steps}, loaded (pl_mean {pl_mean:.6f}), one more step: "
          + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())))
    del r
    torch.cuda.empty_cache()
    return counts


def d_keys(policy: dict) -> dict:
    """The discriminator's options in ``policy``."""
    return {k: list(v) if isinstance(v, tuple) else v for k, v in policy.items()
            if k in D_OPTIONS}


def diffgrad_first_move(g: torch.Tensor) -> torch.Tensor:
    """u(g) of DiffGrad's first update (p -= lr * u(g)), in float64."""
    g = g.double()
    return torch.sigmoid(g.abs()) * g / (g.abs() + 1e-8 / math.sqrt(1.0 - 0.9))


def applied_grads(t, prefixes=("S", "H", "G", "D")) -> dict:
    """{reference name: (parameter, the gradient its optimizer last applied)}."""
    return {f"{p}.{n}": (w, (t.state.opt_d if p == "D" else t.state.opt_g).state[w]["previous_grad"])
            for p in prefixes for n, w in getattr(t.state, p).named_parameters()}


def step_batch(size: int, cfg):
    """The step-0 batch (batch 2) and draws of phases 9 and 9b."""
    from histogan_tpu_torch.train.steps import draw_step

    rng = np.random.default_rng(7)
    hists = rng.random((3, 1, 2, 3, 64, 64), dtype=np.float32)
    hists /= hists.sum(axis=(3, 4, 5), keepdims=True)
    batch = {"d_images": torch.from_numpy(rng.integers(0, 256, (1, 2, size, size, 3), dtype=np.uint8)),
             "d_hists": torch.from_numpy(hists[0]), "g_hists": torch.from_numpy(hists[1])}
    return batch, draw_step(torch.Generator().manual_seed(8), cfg, "cpu", apply_pl=True)


def card_vs_cpu_step(apply_gp: bool, apply_pl: bool, pin: bool = False,
                     options: Optional[dict] = None) -> dict:
    """One train step with the given flags at full width and batch 2 on the
    card and on the CPU, from the same weights, batch and draws; with
    ``pin``, on the CPU once more with the card's kinks (and VQ codes);
    with ``options``, the discriminator's (D1)."""
    from histogan_tpu_torch.train.steps import train_step
    from histogan_tpu_torch.train.trainer import Trainer
    from histogan_tpu_torch.tools.dp_step import to_device

    options = options or {}
    work = WORK / "card_vs_cpu"
    cfg = dict(FLAGSHIP, batch_size=2, gradient_accumulate_every=1, hist_resizing="sampling",
               seed=3, **options)
    tr = {name: Trainer("cmp", work / name / "r", work / name / "m", device=d, **cfg)
          for name, d in (("card", CARD), ("cpu", "cpu"))}
    # with the options the CPU run itself is the pinned one (pin_cpu)
    pinned = (Trainer("cmp", work / "pinned" / "r", work / "pinned" / "m", device="cpu", **cfg)
              if pin and not options else None)
    batch, draws = step_batch(cfg["image_size"], tr["cpu"].cfg)
    flags = "+".join(f for f, on in (("GP", apply_gp), ("PL", apply_pl)) if on) or "plain"
    names = ("d_loss", "g_loss", "h_loss") + (("gp_loss",) if apply_gp else ()) \
        + (("pl_mean",) if apply_pl else ()) + (("q_loss",) if options.get("fq_layers") else ())
    check(not options or all(a.apply for pair in draws.d_aug for a in pair),
          "every augmentation function runs")
    return compare_card_cpu_step(
        tr, lambda t: train_step(t.state, to_device(batch, t.device), to_device(draws, t.device),
                                 t.cfg, apply_gp=apply_gp, apply_pl=apply_pl),
        names, ("S", "H", "G", "D"), f"step 0 ({flags}) {cfg['image_size']} px batch 2"
        + (f" with {json.dumps(d_keys(options))}" if options else ""), pinned=pinned,
        pinned_rtol=D_OPTIONS_PINNED_GRAD_RTOL if options else PINNED_GRAD_RTOL,
        pin_cpu=bool(options))


def normed_bias(name: str) -> bool:
    """A conv bias that feeds an InstanceNorm (reHistoGAN's encoder
    blocks): its exact gradient is 0, so what either device computes is
    rounding."""
    return name.startswith("ED.encoder_blocks.") and name.endswith(("net.0.bias", "net.3.bias"))


KINKS = {"leaky_relu": lambda x, m, slope: torch.where(m, x, x * slope),
         "relu": lambda x, m, slope: torch.where(m, x, torch.zeros_like(x))}


@contextlib.contextmanager
def patched_kinks(wrap, kinds=(*KINKS, "vq")):
    """Within: torch.nn.functional.leaky_relu and relu, and the VQ layers'
    choice of code (``VectorQuantize.nearest``), replaced by ``wrap(kind,
    real)`` for each of ``kinds``; every caller looks them up there when it
    runs (models/layers.leaky_relu, nn.LeakyReLU, the losses, VGG, the VQ
    forward)."""
    from histogan_tpu_torch.models.vq import VectorQuantize

    owners = {kind: torch.nn.functional for kind in KINKS}
    owners["vq"] = VectorQuantize
    names = {"vq": "nearest"}
    real = {kind: getattr(owners[kind], names.get(kind, kind)) for kind in kinds}
    for kind in kinds:
        fn = wrap(kind, real[kind])
        setattr(owners[kind], names.get(kind, kind), staticmethod(fn) if kind == "vq" else fn)
    try:
        yield
    finally:
        for kind, fn in real.items():
            setattr(owners[kind], names.get(kind, kind), staticmethod(fn) if kind == "vq" else fn)


def recorded_kinks(masks: list, kinds=(*KINKS, "vq")):
    """Runs the activations and the VQ lookups as they are and appends
    (kind, input > 0) of each activation call, (kind, codes) of each
    lookup, in order, to ``masks``."""
    def wrap(kind, real):
        def fn(x, *args, **kwargs):
            out = real(x, *args, **kwargs)
            masks.append((kind, out.clone() if kind == "vq" else x > 0))
            return out
        return fn
    return patched_kinks(wrap, kinds)


def pinned_kinks(masks: list, flips: dict):
    """Runs each activation call with the slope that the same call took
    in the recorded run, and each VQ lookup with the codes it chose there
    (``recorded_kinks``'s ``masks``, consumed in order; a call of another
    kind or shape fails), and counts into ``flips`` the entries whose own
    sign, or the rows whose own nearest code, disagreed."""
    calls = iter(masks)

    def take(kind, shape):
        got_kind, m = next(calls, (None, None))
        check(got_kind == kind and m.shape == shape,
              f"the pinned run calls {kind} {tuple(shape)} where the recorded one called "
              f"{got_kind} {None if m is None else tuple(m.shape)}")
        return m

    def wrap(kind, real):
        if kind == "vq":
            def nearest(dist):
                codes = take(kind, dist.shape[:1]).to(dist.device)
                flips[kind] = flips.get(kind, 0) + int((codes != real(dist)).sum())
                return codes
            return nearest

        def fn(x, negative_slope=0.01, inplace=False):
            m = take(kind, x.shape).to(x.device)
            flips[kind] = flips.get(kind, 0) + int((m != (x > 0)).sum())
            return KINKS[kind](x, m, negative_slope)
        return fn
    return patched_kinks(wrap)


def worst_grad_gap(card: dict, cpu: dict) -> tuple:
    """{name: gradient} on each side -> (the worst tensor's max|d| over its
    largest entry, that tensor), biases before an InstanceNorm left out."""
    worst, name = 0.0, ""
    for k, g_cpu in cpu.items():
        if normed_bias(k):  # exact gradient 0: held by NORMED_BIAS_RTOL
            continue
        rel = (card[k] - g_cpu).abs().max().item() / max(g_cpu.abs().max().item(), 1e-30)
        if rel > worst:
            worst, name = rel, k
    return worst, name


def compare_card_cpu_step(tr: dict, step, names, prefixes, label: str,
                          exact_grads: Optional[dict] = None,
                          pinned: Optional[object] = None,
                          pinned_rtol: float = PINNED_GRAD_RTOL, pin_cpu: bool = False) -> dict:
    """Runs ``step(trainer)`` on tr['card'] and tr['cpu'] (the same
    weights, checked) and holds the card to the CPU: the losses ``names``
    to STEP_LOSS_RTOL relative, each tensor's applied gradient to
    STEP_GRAD_RTOL of its largest entry (a bias before an InstanceNorm, whose
    exact gradient is 0, to NORMED_BIAS_RTOL of its weight's), and the
    post-step parameters where the gradient's sign is settled. With
    ``exact_grads`` (the same step's gradients in float64), a tensor beyond
    STEP_GRAD_RTOL passes if the card is no farther from them than the CPU
    is: the gap is then the CPU's own rounding. With ``pinned`` (a third
    trainer, on the CPU) the card's step records its kinks and ``pinned``
    replays them; its losses are held to STEP_LOSS_RTOL, its gradients
    to ``pinned_rtol`` and D's codebook after the step to CODEBOOK_RTOL.
    The VQ codes are replayed too: where the CPU's own lookup takes another
    code for some row (``code_flips``, counted on the unpinned CPU run),
    its losses move by a whole code, so the unpinned gates are left to the
    pinned run, which replays the card's codes. With ``pin_cpu`` there is
    no third trainer: tr['cpu'] itself replays the card's kinks and codes
    and takes both the pinned gates and the others."""
    for t in (*tr.values(), *([pinned] if pinned is not None else [])):
        t.init_GAN()
    if pin_cpu:
        pinned = tr["cpu"]
    start = tr["card"].reference_state_dict()
    check(all(torch.equal(start[k].cpu(), v) for k, v in tr["cpu"].reference_state_dict().items()),
          "same weights on both")
    del start
    before = {f"{p}.{n}": w.detach().clone() for p in prefixes
              for n, w in getattr(tr["cpu"].state, p).named_parameters()}
    metrics, masks, cpu_codes, flips = {}, [], [], {}
    for name, t in tr.items():
        with (recorded_kinks(masks) if name == "card" and pinned is not None
              else pinned_kinks(masks, flips) if name == "cpu" and pin_cpu
              else recorded_kinks(cpu_codes, ("vq",)) if name == "cpu"
              else contextlib.nullcontext()):
            metrics[name] = {k: v.item() for k, v in step(t).items()}
    card_codes = [m for k, m in masks if k == "vq"]
    code_rows = sum(a.numel() for a in card_codes)
    if pin_cpu:  # the CPU's own lookups, counted while it replayed the card's
        code_flips = flips.get("vq", 0)
    else:
        check(len(card_codes) == len(cpu_codes), "as many VQ lookups on both")
        code_flips = sum(int((a.cpu() != b).sum()) for a, (_, b) in zip(card_codes, cpu_codes))
    del card_codes, cpu_codes
    if pinned is not None:
        if pin_cpu:
            m_pin = metrics["cpu"]
        else:
            with pinned_kinks(masks, flips):
                m_pin = {k: v.item() for k, v in step(pinned).items()}
        n_calls = len(masks)
        del masks
        pin_rel, pin_worst = worst_grad_gap(
            {k: g.detach().cpu() for k, (_, g) in applied_grads(tr["card"], prefixes).items()},
            {k: g.detach() for k, (_, g) in applied_grads(pinned, prefixes).items()})
        pin_loss = {k: abs(metrics["card"][k] - m_pin[k]) / abs(m_pin[k]) for k in names}
        book_rel = {k: (v.cpu() - pinned.state.D.get_buffer(k)).abs().max().item()
                    / max(v.abs().max().item(), 1e-30)
                    for k, v in tr["card"].state.D.named_buffers()}
        if not pin_cpu:
            pinned.close()
        print(f"card vs cpu: {label}, kinks pinned ({n_calls} activation calls; entries whose "
              f"CPU sign took the card's other slope: "
              + ", ".join(f"{k} {v}" for k, v in sorted(flips.items()))
              + "): " + " ".join(f"{k} rel {pin_loss[k]:.2e}" for k in names)
              + f"; gradients worst tensor rel {pin_rel:.3e} ({pin_worst}), gate "
              f"{pinned_rtol}"
              + (f"; codebook after the step worst buffer rel {max(book_rel.values()):.3e} "
                 f"({max(book_rel, key=book_rel.get)}), gate {CODEBOOK_RTOL}" if book_rel else ""))
        for k in names:
            check(pin_loss[k] <= STEP_LOSS_RTOL,
                  f"card vs pinned CPU {k} within {STEP_LOSS_RTOL} relative ({label})")
        check(pin_rel <= pinned_rtol, f"card vs pinned CPU gradients within "
                                      f"{pinned_rtol} of each tensor's largest ({label})")
        check(all(v <= CODEBOOK_RTOL for v in book_rel.values()),
              f"card vs pinned CPU codebook within {CODEBOOK_RTOL} of each buffer's largest "
              f"({label})")
    if code_rows:
        print(f"card vs cpu: {label}: {code_flips} of {code_rows} VQ rows took another code on "
              f"the CPU" + ("" if pin_cpu else "; the unpinned gates are left to the pinned run"
                            if code_flips else ""))
    check(not code_flips or pinned is not None, "code flips are held by a pinned run")
    loss_rel = {k: abs(metrics["card"][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
                for k in names}

    r = dict(grad_rel=0.0, grad_worst="", normed_rel=0.0, worst=0.0, off=0, total=0, settled=0,
             bad=0, flipped=0, flipped_rel=0.0, moved=0, beyond=[], card_exact=0.0,
             cpu_exact=0.0)
    card = applied_grads(tr["card"], prefixes)
    grads = applied_grads(tr["cpu"], prefixes)
    for k, (w_cpu, g_cpu) in grads.items():
        w_card, g_card = (x.detach().cpu() for x in card[k])
        w_cpu = w_cpu.detach()
        gap = (g_card - g_cpu).abs().max().item()
        scale = max(g_cpu.abs().max().item(), 1e-30)  # a tensor may take no gradient
        if normed_bias(k):
            w_scale = grads[k.replace("bias", "weight")][1].abs().max().item()
            r["normed_rel"] = max(r["normed_rel"], max(g_cpu.abs().max().item(),
                                                       g_card.abs().max().item()) / w_scale)
        else:
            if gap / scale > r["grad_rel"]:
                r["grad_rel"], r["grad_worst"] = gap / scale, k
            if exact_grads is not None:
                card_exact, cpu_exact = ((g.double() - exact_grads[k]).abs().max().item() / scale
                                         for g in (g_card, g_cpu))
                r["card_exact"] = max(r["card_exact"], card_exact)
                r["cpu_exact"] = max(r["cpu_exact"], cpu_exact)
                if gap / scale > STEP_GRAD_RTOL:
                    r["beyond"].append((k, gap / scale, card_exact, cpu_exact))
        diff = (w_card - w_cpu).abs()
        r["worst"] = max(r["worst"], diff.max().item())
        r["off"] += int((diff > STEP_PARAM_CLOSE).sum())
        r["total"] += w_cpu.numel()
        settled = g_cpu.abs() > gap  # the sign of g is the same on both sides
        allowed = STEP_PARAM_CLOSE + LR * (diffgrad_first_move(g_card)
                                           - diffgrad_first_move(g_cpu)).abs()
        r["settled"] += int(settled.sum())
        r["bad"] += int((settled & (diff.double() > allowed)).sum())
        flipped = (g_card * g_cpu) < 0
        r["flipped"] += int(flipped.sum())
        if flipped.any():
            r["flipped_rel"] = max(r["flipped_rel"], g_cpu[flipped].abs().max().item() / scale)
        r["moved"] += int(not torch.equal(w_cpu, before[k]))
    for t in tr.values():
        t.close()
    r["loss_rel"] = loss_rel
    print(f"card vs cpu: {label}: "
          + " ".join(f"{k} {metrics['card'][k]:.6f}/{metrics['cpu'][k]:.6f} (rel {loss_rel[k]:.2e})"
                     for k in names)
          + f"; gradients worst tensor rel {r['grad_rel']:.3e} ({r['grad_worst']}), "
          + (f"biases before an InstanceNorm {r['normed_rel']:.3e} of their weight's, "
             if any(normed_bias(k) for k in grads) else "")
          + f"{r['flipped']} entries of opposite sign, the largest {r['flipped_rel']:.3e} of its "
          f"tensor's largest; parameters max|d| {r['worst']:.3e}, {r['off']} of {r['total']} "
          f"live entries off by > {STEP_PARAM_CLOSE}, {r['settled']} settled, {r['bad']} of them "
          f"outside fp32 rounding plus the gradient gap through DiffGrad; {r['moved']} tensors "
          "moved")
    if exact_grads is not None:
        print(f"card vs cpu:   against the float64 step, the worst tensor's gap: card "
              f"{r['card_exact']:.3e}, CPU {r['cpu_exact']:.3e} of its largest entry")
    for k, rel, card_exact, cpu_exact in r["beyond"]:
        print(f"card vs cpu:   {k}: card vs CPU {rel:.3e}; against the float64 step card "
              f"{card_exact:.3e}, CPU {cpu_exact:.3e}")
    for k in names:
        check(math.isfinite(metrics["card"][k]), f"card {k} finite ({label})")
    r["code_flips"] = code_flips
    if code_flips and not pin_cpu:  # with pin_cpu the CPU took the card's codes
        return r
    for k in names:
        check(loss_rel[k] <= STEP_LOSS_RTOL,
              f"card vs CPU {k} within {STEP_LOSS_RTOL} relative ({label})")
    if exact_grads is None:
        check(r["grad_rel"] <= STEP_GRAD_RTOL,
              f"gradients within {STEP_GRAD_RTOL} of each tensor's largest ({label})")
    for k, rel, card_exact, cpu_exact in r["beyond"]:
        check(card_exact <= cpu_exact, f"{k}: the card ({card_exact:.3e}) no farther from the "
                                       f"float64 step than the CPU ({cpu_exact:.3e}) ({label})")
    check(r["normed_rel"] <= NORMED_BIAS_RTOL,
          f"biases before an InstanceNorm within {NORMED_BIAS_RTOL} of their weight's ({label})")
    check(r["bad"] == 0, f"post-step parameters on settled entries: {r['bad']} outside ({label})")
    check(r["settled"] >= STEP_SETTLED_MIN * r["total"],
          f"{r['settled']} of {r['total']} entries settled, >= {STEP_SETTLED_MIN} ({label})")
    check(r["moved"] > 0, f"the step moved the parameters ({label})")
    return r


def phase_card_vs_cpu() -> None:
    """The step-0 step (GP and PL), and as a witness of where the card and
    the CPU part, the same step without the gradient penalty; each also
    with the kinks pinned."""
    card_vs_cpu_step(apply_gp=True, apply_pl=True, pin=True)
    card_vs_cpu_step(apply_gp=False, apply_pl=True, pin=True)


def bf16_step_run(device: str, precision: str, size: int, rehisto: bool = False):
    """The step-0 step with the GP at capacity 16, latent 512, style depth
    8, batch 2, ``size`` px, from seed 3's weights: HistoGAN's (and PL) on
    phase 9's batch and draws, or with ``rehisto`` the recoloring step on
    R3's batch and noise. The optimizer's state is fp32, so it keeps the
    gradients as they were applied. Returns (metrics, {name: gradient on
    the CPU})."""
    from histogan_tpu_torch.tools.dp_step import to_device

    if rehisto:
        from histogan_tpu_torch.train import rehisto_steps
        from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer as trainer

        cfg, prefixes = dict(REHISTO), REHISTO_PARTS
    else:
        from histogan_tpu_torch.train.steps import train_step
        from histogan_tpu_torch.train.trainer import Trainer as trainer

        cfg, prefixes = dict(FLAGSHIP, hist_resizing="sampling"), ("S", "H", "G", "D")
    work = WORK / ("rehisto_bf16_step" if rehisto else "bf16_step") / f"{device}_{precision}_{size}"
    t = trainer("cmp", work / "r", work / "m", device=device, image_size=size, batch_size=2,
                gradient_accumulate_every=1, seed=3, precision=precision,
                **{k: v for k, v in cfg.items() if k != "image_size"})
    t.init_GAN()
    if rehisto:
        batch = rehisto_step_batch(size)
        draws = rehisto_steps.draw_step(torch.Generator().manual_seed(8), t.cfg, "cpu")
    else:
        batch, draws = step_batch(size, t.cfg)
    batch, draws = to_device(batch, t.device), to_device(draws, t.device)
    if rehisto:
        m = rehisto_steps.train_step(t.state, batch, draws, t.cfg, True, **REHISTO_HYPER)
    else:
        m = train_step(t.state, batch, draws, t.cfg, apply_gp=True, apply_pl=True)
    metrics = {k: v.item() for k, v in m.items()}
    grads = {k: g.detach().float().cpu() for k, (_, g) in applied_grads(t, prefixes).items()}
    t.close()
    return metrics, grads


def bf16_gaps(got, want, loss_keys) -> dict:
    """Run ``got`` against run ``want`` (each as bf16_step_run returns it):
    each loss of ``loss_keys`` relative (d_loss and g_loss, means of D's
    logits, to the larger of the two and 1, since either may sit near 0),
    each tensor's gradient as 1 - cosine (a bias before an InstanceNorm,
    whose exact gradient is 0, left out)."""
    (m, g), (mw, gw) = got, want
    logit_scale = max(abs(mw["d_loss"]), abs(mw["g_loss"]), 1.0)
    gaps = {k: abs(m[k] - mw[k]) / (logit_scale if k in ("d_loss", "g_loss") else abs(mw[k]))
            for k in loss_keys}
    for k in g:
        if not normed_bias(k):
            a, b = g[k].double(), gw[k].double()
            na, nb = a.norm().item(), b.norm().item()
            gaps[k] = 0.0 if na == nb == 0.0 else 1.0 - (a * b).sum().item() / max(na * nb, 1e-300)
    return gaps


def compare_bf16_step(tag: str, got, want, against: str, size: int, loss_rtol: dict,
                      grad_cos: float, floor: Optional[dict] = None) -> None:
    """Phase 9b's gates, card bf16 (``got``) against ``want``: each loss
    within ``loss_rtol`` and each tensor's gradient cosine at least
    ``grad_cos`` (``bf16_gaps``). With ``floor`` (``bf16_gaps`` of another
    pair of runs) each gate widens to NOISE_FACTOR times that gap where it
    is larger."""
    (m, g), (mw, gw) = got, want
    gaps = bf16_gaps(got, want, loss_rtol)
    tensors = [k for k in gaps if k not in loss_rtol]

    def gate(k):
        fixed = loss_rtol[k] if k in loss_rtol else 1.0 - grad_cos
        return fixed if floor is None else max(fixed, NOISE_FACTOR * floor[k])

    nearest = sorted(tensors, key=lambda k: gaps[k] - gate(k), reverse=True)[:5]
    flat = torch.nn.functional.cosine_similarity(
        torch.cat([g[k].flatten() for k in tensors]).double(),
        torch.cat([gw[k].flatten() for k in tensors]).double(), dim=0).item()
    print(f"{tag}: {size} px batch 2, card bf16 against {against}: "
          + " ".join(f"{k} {m[k]:.6f}/{mw[k]:.6f} ({gaps[k]:.3e}, gate {gate(k):.3e})"
                     for k in loss_rtol)
          + f"; gradient cosine, all tensors {flat:.6f}, median tensor "
          + f"{1.0 - float(np.median([gaps[k] for k in tensors])):.6f}, nearest their gates "
          + ", ".join(f"{k} {1.0 - gaps[k]:.6f} (gate {1.0 - gate(k):.6f})" for k in nearest))
    for k in loss_rtol:
        check(math.isfinite(m[k]) and gaps[k] <= gate(k),
              f"{tag} against {against}: {k} {m[k]:.6f} vs {mw[k]:.6f}")
    check(all(gaps[k] <= gate(k) for k in tensors),
          f"{tag} against {against}: every tensor's gradient cosine within its gate")


def phase_bf16_step() -> None:
    """9b: bf16 on the card against fp32 on the card at full width, and
    against bf16 on the CPU at BF16_CPU_SIZE px."""
    size = FLAGSHIP["image_size"]
    card = bf16_step_run(CARD, "bf16", size)
    compare_bf16_step("bf16 step", card, bf16_step_run(CARD, "fp32", size), "card fp32", size,
                      BF16_LOSS_RTOL, BF16_GRAD_COS)
    del card
    torch.cuda.empty_cache()
    compare_bf16_step("bf16 step", bf16_step_run(CARD, "bf16", BF16_CPU_SIZE),
                      bf16_step_run("cpu", "bf16", BF16_CPU_SIZE), "cpu bf16", BF16_CPU_SIZE,
                      BF16_LOSS_RTOL, BF16_GRAD_COS)


# ------------------------------------------------------------ reHistoGAN
def write_photo(path: Path, seed: int, size=(384, 512)) -> None:
    """A smooth random RGB JPEG (blocks of colour plus noise), H x W = size."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    base = rng.random((-(-h // 32), -(-w // 32), 3)) * 255
    img = np.kron(base, np.ones((32, 32, 1)))[:h, :w] + rng.normal(0, 12, (h, w, 3))
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=95)


def plain_hists(images: np.ndarray) -> np.ndarray:
    """(N, 3, 64, 64) histograms of (N, H, W, 3) images, plain version on
    the CPU, resized by sampling."""
    from histogan_tpu_torch.ops.histogram import histogram_feature

    return histogram_feature(torch.from_numpy(images), resizing="sampling").numpy()


def recolor_inputs(work: Path):
    """R1's photo resized to 256 px, (1, 256, 256, 3), and the target .npy."""
    from histogan_tpu_torch.data.dataset import load_rgb

    img = torch.from_numpy(np.asarray(load_rgb(work / "input.jpg"), np.float32)[None])
    img256 = torch.nn.functional.interpolate(img.permute(0, 3, 1, 2), size=(256, 256),
                                             mode="bilinear", align_corners=False)
    return img256.permute(0, 2, 3, 1).numpy(), np.load(work / "target_hist.npy")


def phase_recolor(histogram_cuda, dev, smi) -> dict:
    """R1: recoloring through rehistogan-torch's entry points; returns the
    K1 and K2 launches of the three --generate runs."""
    from histogan_tpu_torch.cli.rehistogan import train_from_folder
    from histogan_tpu_torch.data.dataset import load_rgb
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock, resize_if_needed
    from histogan_tpu_torch.train.rehisto_steps import RecolorModels, recolor_forward
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer

    work = WORK / "recolor"
    cfg = dict(REHISTO, batch_size=2, gradient_accumulate_every=REHISTO_ACCUM, seed=0)
    src = RecoloringTrainer("recolor", work / "cpu_r", work / "cpu_m", device="cpu", **cfg)
    src.init_GAN()
    pt = work / "weights.pt"
    n_tensors = src.export_pt(pt)
    n_params = sum(p.numel() for m in src.models().values() for p in m.parameters())
    print(f"recolor: weights seed 0, {n_params} parameters (ED/H/G/D), {n_tensors} tensors, "
          f".pt {pt.stat().st_size} bytes")

    inp, tgt = work / "input.jpg", work / "target.jpg"
    write_photo(inp, 11)
    write_photo(tgt, 12)
    rng = np.random.default_rng(13)
    np.save(work / "target_hist.npy", plain_hists(load_rgb(tgt)[None]))
    pool = plain_hists(rng.random((8, 256, 256, 3), dtype=np.float32))[:, None]
    np.save(work / "pool.npy", pool)  # (N, 1, 3, 64, 64), as create_hist_data writes it
    cli = dict(results_dir=str(work / "results"), models_dir=str(work / "models"),
               name="recolor", image_size=cfg["image_size"],
               network_capacity=cfg["network_capacity"], skip_conn_to_GAN=True,
               variance_loss=True, hist_resizing="sampling", load_histogan_weights=False,
               load_pt=str(pt), generate=True, input_image=str(inp), seed=0, device=CARD)
    out = work / "results" / "recolor"
    launches, counts = {}, {"histogram_fwd": 0, "histogram_bwd": 0}
    for what, kw in (("image", dict(target_hist=str(tgt))),
                     ("npy", dict(target_hist=str(work / "target_hist.npy"))),
                     ("sampling", dict(sampling=True, target_number=2,
                                       histogram_pool=str(work / "pool.npy")))):
        reset_counts(histogram_cuda)
        train_from_folder(**cli, **kw)
        launches[what] = histogram_cuda.launches
        counts["histogram_fwd"] += histogram_cuda.launches
        counts["histogram_bwd"] += histogram_cuda.bwd_launches
        print(f"recolor: --generate toward a target {what}: K1 launches {launches[what]}")
    files = sorted(p.name for p in out.glob("*-generated.jpg"))
    check(len(files) == 4, f"4 recolored images written (image, npy, 2 sampled): {files}")
    check(launches["image"] >= 1, f"K1 launched on the recolor path ({launches})")

    # evaluate at 16 images and 16 targets
    model = RecoloringTrainer("recolor", work / "results", work / "models", device=CARD, **cfg)
    model.init_GAN()
    model.load_pt(pt)
    hist_block = RGBuvHistBlock(insz=150, h=64, resizing="sampling")
    img256, h1 = recolor_inputs(work)
    imgs16 = np.random.default_rng(14).random((16, 256, 256, 3), dtype=np.float32)
    hists16 = plain_hists(np.random.default_rng(15).random((16, 128, 128, 3), dtype=np.float32))
    got16 = model.evaluate("eval16", image_batch=imgs16, hist_batch=hists16)
    check(got16.shape == (16, 256, 256, 3) and bool(np.isfinite(got16).all())
          and float(got16.std()) > 0.0, "evaluate at 16: finite, not constant")
    print(f"recolor: RecoloringTrainer.evaluate at 16 images and 16 targets: finite, not "
          f"constant on {smi}")

    # the target histogram through K1 against the plain version, and the
    # card's recolor against the CPU's
    x = torch.from_numpy(load_rgb(tgt)[None]).to(dev)
    with torch.inference_mode():
        hist_path = hist_block(x)
        packed = histogram_cuda.pack_pixels(
            resize_if_needed(x.clamp(0, 1), 150, 64, "sampling").reshape(1, -1, 3)).contiguous()
        hist_plain = normalise(histogram_cuda.hist_core_reference(packed, INV_SIGMA2))
    herr = (hist_path - hist_plain).abs().max().item()
    check(herr <= KERNEL_TOL_ABS, f"recolor target histogram max|kernel-plain| {herr:.3e}")
    noise = torch.from_numpy(np.random.default_rng(16).random((2, 256, 256, 1),
                                                              dtype=np.float32))
    pair = torch.from_numpy(np.concatenate([img256, imgs16[:1]])).permute(0, 3, 1, 2)
    hists = torch.from_numpy(np.concatenate([h1, hists16[:1]]))
    raw = {}
    for name, t in (("card", model), ("cpu", src)):
        with torch.inference_mode():
            raw[name] = recolor_forward(RecolorModels(t.ED, t.H, t.G, None), pair.to(t.device),
                                        hists.to(t.device), noise.to(t.device), t.cfg).cpu()
    exact_model = copy.deepcopy(RecolorModels(model.ED, model.H, model.G, None))
    with torch.inference_mode():
        exact = recolor_forward(RecolorModels(*(m.double() for m in exact_model[:3]), None),
                                pair.to(dev, torch.float64), hists.to(dev, torch.float64),
                                noise.to(dev, torch.float64), model.cfg).cpu()
    del exact_model
    scale = raw["cpu"].abs().max().item()
    rerr = (raw["card"] - raw["cpu"]).abs().max().item()
    card_exact, cpu_exact = ((raw[k].double() - exact).abs().max().item() for k in ("card", "cpu"))
    clipped = (raw["card"].clamp(0, 1) - raw["cpu"].clamp(0, 1)).abs().max().item()
    inside = ((raw["cpu"] > 0) & (raw["cpu"] < 1)).double().mean().item()
    check(rerr <= RECOLOR_TOL_REL * scale,
          f"card vs CPU recolor max|d| {rerr:.3e} <= {RECOLOR_TOL_REL} x {scale:.3e}")
    print(f"recolor: target histogram max|kernel-plain| {herr:.3e}; 2 recolors at "
          f"{cfg['image_size']} px, card vs CPU max|d| {rerr:.3e} before the clip to [0, 1], "
          f"{rerr / scale:.3e} of its largest entry {scale:.3e} (tolerance {RECOLOR_TOL_REL}); "
          f"after the clip {clipped:.3e}, with {inside:.4f} of the outputs inside (0, 1); "
          f"against a float64 recolor on the card: card {card_exact:.3e}, CPU {cpu_exact:.3e}")
    del model, src
    torch.cuda.empty_cache()
    return counts


def rehisto_steps_run(t, tag: str, n: int, histogram_cuda):
    """Steps 0..n-1 of ``t``, each with finite losses; returns the per-step
    K1 and K2 launches."""
    per_step = []
    for step in range(n):
        k1, k2 = histogram_cuda.launches, histogram_cuda.bwd_launches
        m = t.train(**REHISTO_HYPER)
        per_step.append((histogram_cuda.launches - k1, histogram_cuda.bwd_launches - k2))
        flags = [name for name, on in (("GP", step % 4 == 0),
                                       ("save+evaluate", step == 0)) if on]
        print(f"{tag}: step {step} [{', '.join(flags) or 'plain'}] "
              + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())))
        check(all(math.isfinite(v) for v in m.values()), f"finite losses at step {step}: {m}")
    return per_step


def phase_rehisto_train(histogram_cuda, smi, policy: Optional[dict] = None):
    """R2: recoloring training at batch 2 x accumulation 8; or R2b, with
    ``policy`` (REHISTO_BF16), the same 10 + 1 steps under it, the dtypes
    checked across the save and load. Returns {kernel: launches in the 10
    steps}."""
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer

    policy = policy or {}
    label = policy.get("precision", "fp32")
    tag = "rehisto train" if label == "fp32" else f"rehisto train {label}"
    work = WORK / f"rehisto_train_{label}"
    write_images(work / "data")
    cfg = dict(REHISTO, batch_size=2, gradient_accumulate_every=REHISTO_ACCUM, seed=0,
               save_every=1000, **policy)
    t = RecoloringTrainer("rt", work / "results", work / "models", device=CARD, **cfg)
    t.init_GAN()
    before = {k: v.detach().clone() for k, v in t.reference_state_dict().items()}
    reset_counts(histogram_cuda)
    t.set_data_src(str(work / "data"), sampling=True)
    pool_launches = histogram_cuda.launches
    print(f"{tag}: batch source {type(t.loader).__name__}")
    reset_counts(histogram_cuda)
    per_step = rehisto_steps_run(t, tag, 10, histogram_cuda)
    counts = {"histogram_fwd": histogram_cuda.launches,
              "histogram_bwd": histogram_cuda.bwd_launches}
    accum = cfg["gradient_accumulate_every"]
    # per micro-batch: K1 on G's output and on the hist-of-hist, K2 on G's output
    check(all(p == (2 * accum, accum) for p in per_step),
          f"K1 and K2 launched {2 * accum} and {accum} times a step: {per_step}")
    after = t.reference_state_dict()
    for prefix in REHISTO_PARTS:
        keys = [k for k in after if k.split(".")[0] == prefix]
        check(any(not torch.equal(after[k], before[k]) for k in keys), f"{prefix} changed")
    del before
    check_dtypes(t, policy, REHISTO_PARTS, ())
    print(f"{tag}: 10 steps at batch 2 x accumulation {accum}, {label}; K1 launches "
          f"{pool_launches} in the pool build; launches per step K1 {per_step[0][0]}, K2 "
          f"{per_step[0][1]}; in the 10 steps {counts} on {smi}")

    t.save(1)
    opt_steps = t.state.step
    t.close()
    del t
    torch.cuda.empty_cache()
    r = RecoloringTrainer("rt", work / "results", work / "models", device=CARD, **cfg)
    check(r.load(-1) == 0, "a checkpoint to load")
    check(r.state.step == opt_steps and r.steps == cfg["save_every"],
          f"step counters carried over ({r.state.step}, {r.steps})")
    check(r.cfg.precision == label, f"precision {label} after the load")
    check_dtypes(r, policy, REHISTO_PARTS, ())
    r.set_data_src(str(work / "data"), sampling=True)
    m = r.train(**REHISTO_HYPER)
    r.close()
    check(all(math.isfinite(v) for v in m.values()) and r.state.step == opt_steps + 1,
          "one finite step after the resume")
    check_dtypes(r, policy, REHISTO_PARTS, ())
    print(f"{tag}: saved at step {opt_steps}, loaded, one more step: "
          + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())))
    del r
    torch.cuda.empty_cache()
    return counts


def phase_rehisto_d_options(histogram_cuda, smi) -> dict:
    """D1r: the recoloring step with the discriminator's attention (layers
    1-2) and VQ (layer 3) at the CLI's batch 2 x accumulation 8: steps 0-2
    (GP, save and evaluate at 0), K1 and K2 per step as R2's; then one D
    phase moves the codebook and one G phase leaves it as it is (the
    recoloringTrainer's G phase does not update it). Returns {kernel:
    launches in the 3 steps}."""
    from histogan_tpu_torch.data.device_source import take_batch
    from histogan_tpu_torch.train import rehisto_steps
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer

    tag = "rehisto d options"
    work = WORK / "rehisto_d_options"
    data = WORK / "images"  # phase 8's 64 JPEGs
    if not data.is_dir():
        write_images(data)
    options = {k: v for k, v in D_OPTIONS.items() if not k.startswith("aug")}
    cfg = dict(REHISTO, batch_size=2, gradient_accumulate_every=REHISTO_ACCUM, seed=0,
               save_every=1000, **options)
    t = RecoloringTrainer("rt", work / "results", work / "models", device=CARD, **cfg)
    t.init_GAN()
    t.set_data_src(str(data), sampling=True)
    reset_counts(histogram_cuda)
    per_step = rehisto_steps_run(t, tag, 3, histogram_cuda)
    counts = {"histogram_fwd": histogram_cuda.launches,
              "histogram_bwd": histogram_cuda.bwd_launches}
    accum = cfg["gradient_accumulate_every"]
    check(all(p == (2 * accum, accum) for p in per_step),
          f"K1 and K2 launched {2 * accum} and {accum} times a step: {per_step}")
    batch = take_batch(t.loader, None, t.device)
    draws = rehisto_steps.draw_step(t.gen, t.cfg, t.device)
    book = {k: v.clone() for k, v in t.state.D.named_buffers()}
    rehisto_steps.d_phase(t.state, batch, draws, t.cfg, apply_gp=False)
    moved = {k: v.clone() for k, v in t.state.D.named_buffers()}
    rehisto_steps.g_phase(t.state, batch, draws, t.cfg, **REHISTO_HYPER)
    check(len(book) == 3 and any(not torch.equal(moved[k], v) for k, v in book.items()),
          "the D phase moves the codebook")
    check(all(torch.equal(v, moved[k]) for k, v in t.state.D.named_buffers()),
          "the G phase leaves the codebook as it is")
    t.close()
    print(f"{tag}: {json.dumps(options)}: 3 steps at batch 2 x accumulation {accum}, fp32; "
          f"the D phase moved the codebook, the G phase did not; launches {counts} on {smi}")
    del t
    torch.cuda.empty_cache()
    return counts


def rehisto_exact_grads(cfg, batch, draws, apply_gp, work) -> dict:
    """The recoloring step in float64 on the card (the histograms stay
    fp32): {reference name: the applied gradient, on the CPU}."""
    from histogan_tpu_torch.train import rehisto_steps
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer

    t = RecoloringTrainer("cmp", work / "f64" / "r", work / "f64" / "m", device=CARD, **cfg)
    t.init_GAN()
    for m in t.models().values():
        m.double()
    b = {k: (v.double() / 255.0 if v.dtype == torch.uint8 else v.double()).to(t.device)
         for k, v in batch.items()}
    d = rehisto_steps.ReHistoDraws([x.to(t.device, torch.float64) for x in draws.d],
                                   [x.to(t.device, torch.float64) for x in draws.g])
    rehisto_steps.train_step(t.state, b, d, t.cfg, apply_gp, **REHISTO_HYPER)
    return {k: g.detach().cpu() for k, (_, g) in applied_grads(t, REHISTO_PARTS).items()}


def rehisto_step_batch(size: int) -> dict:
    """The recoloring step-0 batch (batch 2) of R3 and R3b."""
    rng = np.random.default_rng(17)
    hists = rng.random((2, 1, 2, 3, 64, 64), dtype=np.float32)
    hists /= hists.sum(axis=(3, 4, 5), keepdims=True)
    return {"d_images": torch.from_numpy(rng.integers(0, 256, (1, 2, size, size, 3),
                                                      dtype=np.uint8)),
            "g_images": torch.from_numpy(rng.integers(0, 256, (1, 2, size, size, 3),
                                                      dtype=np.uint8)),
            "d_hists": torch.from_numpy(hists[0]), "g_hists": torch.from_numpy(hists[1])}


def phase_rehisto_card_vs_cpu() -> None:
    """R3: the recoloring step-0 step at full width, batch 2, accumulation
    1, on the card and the CPU from the same weights, batch and noise; with
    the GP, then without; each also with the kinks pinned. Its gradients reach 8e-2 of a tensor's largest
    entry card vs CPU, so a float64 run on the card says which side the
    gap is on (``compare_card_cpu_step``)."""
    from histogan_tpu_torch.train import rehisto_steps
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
    from histogan_tpu_torch.tools.dp_step import to_device

    work = WORK / "rehisto_card_vs_cpu"
    cfg = dict(REHISTO, batch_size=2, gradient_accumulate_every=1, seed=3)
    size = cfg["image_size"]
    batch = rehisto_step_batch(size)
    for apply_gp in (True, False):
        tr = {name: RecoloringTrainer("cmp", work / name / "r", work / name / "m", device=d, **cfg)
              for name, d in (("card", CARD), ("cpu", "cpu"))}
        pinned = RecoloringTrainer("cmp", work / "pinned" / "r", work / "pinned" / "m",
                                   device="cpu", **cfg)
        draws = rehisto_steps.draw_step(torch.Generator().manual_seed(8), tr["cpu"].cfg, "cpu")
        names = ("d_loss", "g_loss", "h_loss", "r_loss", "var_loss") \
            + (("gp_loss",) if apply_gp else ())
        exact = rehisto_exact_grads(cfg, batch, draws, apply_gp, work)
        compare_card_cpu_step(
            tr, lambda t: rehisto_steps.train_step(
                t.state, to_device(batch, t.device), to_device(draws, t.device), t.cfg,
                apply_gp, **REHISTO_HYPER),
            names, REHISTO_PARTS,
            f"reHistoGAN step 0 ({'GP' if apply_gp else 'plain'}) {size} px batch 2", exact,
            pinned=pinned, pinned_rtol=REHISTO_PINNED_GRAD_RTOL)
        del exact
        del tr, pinned
        torch.cuda.empty_cache()


# ------------------------------------- reHistoGAN: bf16, full resolution, pools
def phase_recolor_bf16(histogram_cuda, smi) -> dict:
    """R1b: the recolor under --precision bf16 through rehistogan-torch,
    and the bf16 recolor held to the fp32 one on the card on the same
    weights, image, histogram and noise. Returns the K1 and K2 launches of
    the --generate run."""
    from histogan_tpu_torch.cli.rehistogan import train_from_folder
    from histogan_tpu_torch.train.rehisto_steps import RecolorModels, recolor_forward
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
    from histogan_tpu_torch.train.steps import cast_models

    src, work = WORK / "recolor", WORK / "recolor_bf16"
    pt, inp, tgt = src / "weights.pt", src / "input.jpg", src / "target.jpg"
    reset_counts(histogram_cuda)
    train_from_folder(results_dir=str(work / "results"), models_dir=str(work / "models"),
                      name="recolor", image_size=256, network_capacity=16, skip_conn_to_GAN=True,
                      variance_loss=True, hist_resizing="sampling", load_histogan_weights=False,
                      load_pt=str(pt), generate=True, input_image=str(inp), target_hist=str(tgt),
                      seed=0, device=CARD, precision="bf16")
    counts = {"histogram_fwd": histogram_cuda.launches,
              "histogram_bwd": histogram_cuda.bwd_launches}
    files = list((work / "results" / "recolor").glob("output-target-*-generated.jpg"))
    check(len(files) == 1, f"one bf16 recolored image written: {files}")
    check(counts["histogram_fwd"] >= 1, f"K1 launched on the bf16 recolor path ({counts})")
    print(f"recolor bf16: --generate --precision bf16 toward a target image: "
          f"K1 launches {counts['histogram_fwd']}")

    cfg = dict(REHISTO, batch_size=2, gradient_accumulate_every=REHISTO_ACCUM, seed=0)
    models = {}
    for precision in ("bf16", "fp32"):
        t = RecoloringTrainer("recolor", work / "results", work / "models", device=CARD,
                              precision=precision, **cfg)
        t.init_GAN()
        t.load_pt(pt)
        models[precision] = t

    img256, h1 = recolor_inputs(src)
    imgs = torch.from_numpy(np.concatenate(
        [img256, np.random.default_rng(14).random((1, 256, 256, 3), dtype=np.float32)]))
    hists = torch.from_numpy(np.concatenate(
        [h1, plain_hists(np.random.default_rng(15).random((1, 128, 128, 3), dtype=np.float32))]))
    noise = torch.from_numpy(np.random.default_rng(16).random((2, 256, 256, 1), dtype=np.float32))
    raw = {}
    with torch.inference_mode():
        for precision, t in models.items():
            m = cast_models(RecolorModels(t.ED, t.H, t.G, None), torch.bfloat16
                            if precision == "bf16" else torch.float32)
            raw[precision] = recolor_forward(
                m, imgs.permute(0, 3, 1, 2).to(CARD), hists.to(CARD), noise.to(CARD), t.cfg)
        got = models["bf16"].recolor(imgs, hists, noise=noise.to(CARD))
    check(raw["bf16"].dtype == got.dtype == torch.bfloat16, "the bf16 recolor runs in bf16")
    same = (got.float() - raw["bf16"].float().clamp(0, 1).permute(0, 2, 3, 1)).abs().max().item()
    check(same <= 2.0 ** -8, f"the trainer's bf16 recolor is the bf16 forward, clipped "
                             f"(max|d| {same:.3e}, within a bf16 spacing)")
    a, b = raw["bf16"].float().cpu(), raw["fp32"].cpu()
    scale = b.abs().max().item()
    gap = (a - b).abs().max().item() / scale
    clipped = (a.clamp(0, 1) - b.clamp(0, 1)).abs()
    check(bool(torch.isfinite(a).all()), "bf16 recolor finite")
    check(gap <= RECOLOR_BF16_TOL_REL,
          f"bf16 vs fp32 recolor {gap:.3e} of the largest entry <= {RECOLOR_BF16_TOL_REL}")
    print(f"recolor bf16: 2 recolors at 256 px, bf16 vs fp32 on the card: max|d| {gap:.3e} of "
          f"the largest pre-clip entry {scale:.3e} (tolerance {RECOLOR_BF16_TOL_REL}); after the "
          f"clip max "
          f"{clipped.max().item():.3e}, mean {clipped.mean().item():.3e} on {smi}")
    del models
    torch.cuda.empty_cache()
    return counts


def grid_size(size_hw, mode: str, levels: int):
    """The (W, H) of the file RecoloringTrainer.evaluate writes for one photo
    of ``size_hw`` in ``mode``, as the JAX package's evaluate gives it: the
    pyramid pads each side up to a multiple of 2**levels; every grid has
    save_image_grid's 2 px border; the downscaled file is resized by PIL to
    the photo's size exactly."""
    h, w = size_hw
    if mode == "downscaling":
        return w, h
    if mode == "pyramid":
        m = 2 ** levels
        h, w = -(-h // m) * m, -(-w // m) * m
    return w + GRID_BORDER, h + GRID_BORDER


def phase_fullres(smi) -> None:
    """R4: full-resolution output on a 384x512 and a 200x180 photo. First
    rehistogan-torch's train_from_folder(generate=True) with the documented
    --upsampling_output True --upsampling_method BGU on the card. Then each
    mode (upscaling by the pyramid and by BGU on the scipy and on the native
    backend, downscaling, and post-recoloring) through the CLI's
    process_image on a card trainer and a CPU trainer whose recolors take
    one noise: the card's file has the size JAX's evaluate gives it, and the
    final image from the card's recolor is held to the CPU's."""
    from PIL import Image

    from histogan_tpu_torch.cli.rehistogan import process_image, train_from_folder
    from histogan_tpu_torch.post import bgu_native
    from histogan_tpu_torch.train import rehisto_trainer
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer

    src, work = WORK / "recolor", WORK / "fullres"
    pt, tgt = src / "weights.pt", src / "target.jpg"
    photos = {"384x512": (work / "large.jpg", (384, 512)), "200x180": (work / "small.jpg", (200, 180))}
    for seed, (path, size) in enumerate(photos.values()):
        write_photo(path, 21 + seed, size)
    modes = [("none", "384x512", {}),
             ("pyramid", "384x512", dict(upsampling_output=True, upsampling_method="pyramid")),
             ("BGU scipy", "384x512", dict(upsampling_output=True, upsampling_method="BGU")),
             ("BGU native", "384x512", dict(upsampling_output=True, upsampling_method="BGU")),
             ("downscaling", "200x180", dict(upsampling_output=True)),
             ("post_recoloring", "384x512", dict(post_recoloring=True))]
    backend = os.environ.get("HISTOGAN_BGU")

    def written(out_dir: Path):
        files = list((out_dir / "fullres").glob("output-target-*-generated.jpg"))
        check(len(files) == 1, f"R4: one file written in {out_dir} ({files})")
        return Image.open(files[0]).size

    # the entry point a user calls, as README documents it
    os.environ["HISTOGAN_BGU"] = "scipy"
    with contextlib.redirect_stdout(io.StringIO()):
        train_from_folder(results_dir=str(work / "cli"), models_dir=str(work / "models"),
                          name="fullres", image_size=REHISTO["image_size"],
                          network_capacity=REHISTO["network_capacity"],
                          skip_conn_to_GAN=True, variance_loss=True, hist_resizing="sampling",
                          load_histogan_weights=False, load_pt=str(pt), generate=True,
                          input_image=str(photos["384x512"][0]), target_hist=str(tgt), seed=0,
                          device=CARD, pyramid_levels=R4_PYRAMID_LEVELS, upsampling_output=True,
                          upsampling_method="BGU")
    got, want = written(work / "cli"), grid_size((384, 512), "full", R4_PYRAMID_LEVELS)
    check(got == want, f"R4 train_from_folder BGU: file {got}, JAX's evaluate writes {want}")
    print(f"R4 rehistogan-torch --generate --upsampling_output True --upsampling_method BGU: "
          f"384x512 photo, file {got[0]}x{got[1]} (W x H, JAX's size) on {smi}")

    cfg = dict(REHISTO, batch_size=2, gradient_accumulate_every=REHISTO_ACCUM, seed=0)
    trainers = {}
    # one noise for both devices: each trainer's recolor takes it
    size = REHISTO["image_size"]
    noise = torch.from_numpy(np.random.default_rng(23).random((1, size, size, 1), dtype=np.float32))
    for name, d in (("card", CARD), ("cpu", "cpu")):
        t = RecoloringTrainer("fullres", work / name, work / "models", device=d, **cfg)
        t.init_GAN()
        t.load_pt(pt)
        t.recolor = (lambda img, hist, _r=t.recolor, _n=noise.to(t.device): _r(img, hist, noise=_n))
        trainers[name] = t
    # the images evaluate writes, in memory: its first (the recolor) and last
    images = []
    real_save = rehisto_trainer.save_image_grid
    rehisto_trainer.save_image_grid = lambda x, path, nrow: (images.append(np.array(x)),
                                                             real_save(x, path, nrow))
    # the native solver's report of each native fit
    reports = []
    real_native = bgu_native.bgu_fit_native

    def native_fit(*args, **kwargs):
        gamma, report = bgu_native.bgu_fit_native_report(*args, **kwargs)
        reports.append(report)
        return gamma

    bgu_native.bgu_fit_native = native_fit
    card_finals = {}
    try:
        for i, (mode, photo, flags) in enumerate(modes):
            path, size_hw = photos[photo]
            if mode.startswith("BGU"):
                os.environ["HISTOGAN_BGU"] = mode.split()[1]
            recolored, finals = {}, {}
            for name, t in trainers.items():
                t.results_dir = work / name / f"{i}_{mode.replace(' ', '_')}"
                images.clear()
                with contextlib.redirect_stdout(io.StringIO()):
                    process_image(t, "fullres", str(path), str(tgt), image_size=size,
                                  pyramid_levels=R4_PYRAMID_LEVELS,
                                  results_dir=str(t.results_dir),
                                  rng=np.random.default_rng(0), **flags)
                recolored[name], finals[name] = images[0][0], images[-1][0]
            card_finals[mode] = finals["card"]
            kind = ("pyramid" if flags.get("upsampling_method") == "pyramid" else
                    "downscaling" if mode == "downscaling" else
                    "none" if mode == "none" else "full")
            want = grid_size(size_hw if kind != "none" else (size, size), kind, R4_PYRAMID_LEVELS)
            got = written(trainers["card"].results_dir)
            check(got == want, f"R4 {mode}: the {photo} photo's file is {got}, JAX's evaluate "
                               f"writes {want}")
            check(finals["card"].shape == finals["cpu"].shape
                  and bool(np.isfinite(finals["card"]).all()),
                  f"R4 {mode}: the final image {finals['card'].shape}, finite")
            rgap = float(np.abs(np.clip(recolored["card"], 0, 1)
                                - np.clip(recolored["cpu"], 0, 1)).max())
            gap = float(np.abs(np.clip(finals["card"], 0, 1) - np.clip(finals["cpu"], 0, 1)).max())
            check(gap <= POST_FACTOR * rgap,
                  f"R4 {mode}: card vs CPU final max|d| {gap:.3e} <= {POST_FACTOR} x the "
                  f"recolor's {rgap:.3e}")
            print(f"R4 {mode}: {photo} photo, file {got[0]}x{got[1]} (W x H, JAX's size); "
                  f"card vs CPU final image max|d| {gap:.3e}, the recolor's {rgap:.3e} (ratio "
                  f"{gap / rgap if rgap else 0.0:.2f}, gate {POST_FACTOR}) on {smi}")
        gap = float(np.abs(card_finals["BGU native"] - card_finals["BGU scipy"]).max())
        check(gap <= BGU_NATIVE_TOL, f"R4 BGU native vs scipy: max|d| {gap:.3e} <= "
                                     f"{BGU_NATIVE_TOL}")
        check(len(reports) == 2, f"R4 BGU native: one native fit per trainer ({len(reports)})")
        for report, dev_name in zip(reports, ["card", "cpu"]):
            print(f"R4 BGU native fit (the {dev_name} trainer's recolor, 256x256 to grid "
                  f"16x16x8): iterations per channel {list(report.iters)}, final relative "
                  f"residual " + "/".join(f"{r:.3e}" for r in report.residual))
        print(f"R4 BGU native vs scipy: the card's final images max|d| {gap:.3e} (gate "
              f"{BGU_NATIVE_TOL})")
    finally:
        bgu_native.bgu_fit_native = real_native
        rehisto_trainer.save_image_grid = real_save
        if backend is None:
            os.environ.pop("HISTOGAN_BGU", None)
        else:
            os.environ["HISTOGAN_BGU"] = backend
    del trainers
    torch.cuda.empty_cache()


def phase_rehisto_bf16_step() -> None:
    """R3b: the recoloring step-0 step (with the GP) under bf16 on the card
    against fp32 on the card at full width, and against bf16 on the CPU at
    BF16_CPU_SIZE px, in phase 9b's gates. The second is held as
    tests/test_torch_rehisto_bf16.py holds the port to JAX: each gap within
    its fixed gate or NOISE_FACTOR times the gap bf16 opens between the
    card's bf16 and fp32 steps there."""
    size = REHISTO["image_size"]
    card = bf16_step_run(CARD, "bf16", size, rehisto=True)
    compare_bf16_step("rehisto bf16 step", card,
                      bf16_step_run(CARD, "fp32", size, rehisto=True), "card fp32", size,
                      REHISTO_BF16_LOSS_RTOL, REHISTO_BF16_GRAD_COS)
    del card
    torch.cuda.empty_cache()
    small = BF16_CPU_SIZE
    card = bf16_step_run(CARD, "bf16", small, rehisto=True)
    floor = bf16_gaps(card, bf16_step_run(CARD, "fp32", small, rehisto=True),
                      REHISTO_BF16_LOSS_RTOL)
    compare_bf16_step("rehisto bf16 step", card, bf16_step_run("cpu", "bf16", small, rehisto=True),
                      "cpu bf16", small, REHISTO_BF16_LOSS_RTOL, REHISTO_BF16_GRAD_COS, floor)


def phase_pool_clis(histogram_cuda, smi) -> dict:
    """H1: histogan-create-hist-data-torch on 8 photos of 250x250 (K1 once
    each, at (1, 250^2)) and histogan-create-hist-sample-torch on one photo
    (K1 once, at (1, 150^2), interpolation), each held to the same command
    with --device cpu at the histogram gate. Returns {CLI: {kernel:
    launches}} of the card's runs."""
    from histogan_tpu_torch.cli import create_hist_data, create_hist_sample

    work = WORK / "pools"
    for i in range(8):
        write_photo(work / "histogram_data" / f"{i}.jpg", 30 + i, (250, 250))
    shapes = []
    real_launch = histogram_cuda._launch

    def launch(packed, inv_sigma2):
        shapes.append(tuple(packed.shape[:2]))
        return real_launch(packed, inv_sigma2)

    launches = {}
    outs = {}
    runs = (("create_hist_data", create_hist_data,
             ["--input_dir", str(work / "histogram_data")], "--output", (1, 250 * 250), 8),
            ("create_hist_sample", create_hist_sample,
             ["--image", str(WORK / "recolor" / "target.jpg")], "--output_dir", (1, 150 * 150), 1))
    histogram_cuda._launch = launch
    try:
        for name, cli, args, out_flag, shape, n in runs:
            for device in ("cuda", "cpu"):
                shapes.clear()
                reset_counts(histogram_cuda)
                target = work / f"{name}_{device}" / ("pool.npy" if out_flag == "--output" else "")
                with contextlib.redirect_stdout(io.StringIO()):
                    path = cli.main([*args, out_flag, str(target), "--device", device])
                outs[device] = np.load(path)
                if device == "cuda":
                    launches[name] = {"histogram_fwd": histogram_cuda.launches,
                                      "histogram_bwd": histogram_cuda.bwd_launches}
                    check(launches[name]["histogram_fwd"] == n and shapes == [shape] * n,
                          f"H1 {name}: K1 launched {n} times at {shape}: "
                          f"{launches[name]}, {shapes}")
            l1 = float(np.abs(outs["cuda"] - outs["cpu"]).sum(axis=(-3, -2, -1)).max())
            check(outs["cuda"].shape == outs["cpu"].shape and l1 < HIST_L1,
                  f"H1 {name}: card vs CPU L1 {l1:.3e} < {HIST_L1}")
            print(f"H1 {name}: {outs['cuda'].shape} card vs CPU L1 {l1:.3e} (gate {HIST_L1}); "
                  f"launches {launches[name]}, K1 at {shape} on {smi}")
    finally:
        histogram_cuda._launch = real_launch
    return launches


# ------------------------------------------------------ projection (GAN inversion)
# P1: the step-0 losses of a projection, card vs CPU, relative (the pixel
# L1 and the VGG term); the gradients by STEP_GRAD_RTOL and, kinks pinned,
# PROJECTION_PINNED_GRAD_RTOL; the start render by SLICE_TOL. The loop runs
# PROJECTION_STEPS on the card, whose last reconstruction loss must lie
# below the first.
PROJECTION_STEPS = 50
PROJECTION_LR = 0.1  # the CLIs' default
# P3's photo, H x W: the post-processed files take its size (MKL) or pad
# it to a multiple of 2**pyramid_levels (the pyramid, levels 6: 256 x 320)
PROJECTION_PHOTO = (200, 300)


@contextlib.contextmanager
def vgg_weights(work: Path):
    """VGG16_WEIGHTS set to seeded weights at the real shapes
    (random_vgg16_state(0), as the JAX bench writes them) for the
    duration; the repo holds no pretrained file."""
    from histogan_tpu_torch.ops.vgg import random_vgg16_state

    path = work / "vgg16_random.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **random_vgg16_state(0))
    before = os.environ.get("VGG16_WEIGHTS")
    os.environ["VGG16_WEIGHTS"] = str(path)
    try:
        yield path
    finally:
        if before is None:
            os.environ.pop("VGG16_WEIGHTS")
        else:
            os.environ["VGG16_WEIGHTS"] = before


def npz_names(v: dict) -> dict:
    """{npz key: tensor} of a projection's variables (the JAX package's
    keys)."""
    out = {}
    for k, x in v.items():
        if isinstance(x, list):
            out.update({f"{'torgb_style' if k == 'torgb' else k}_{i}": y for i, y in enumerate(x)})
        else:
            out[k] = x
    return out


@contextlib.contextmanager
def projection_probe(out: dict, first_step=contextlib.nullcontext):
    """Within, a project_* call records its start render (``render``, the
    first _forward), the aux of each logged step (``aux``) and step 0's
    gradients by npz key (``grads``); step 0's forward runs inside
    ``first_step()``."""
    from histogan_tpu_torch import projection

    real_run, real_forward = projection._run_optimization, projection._forward

    def forward(*args, **kwargs):
        rgb = real_forward(*args, **kwargs)
        out.setdefault("render", rgb.detach().cpu())
        return rgb

    def run(loss_fn, optimizer, variables, n, log_every, save_every, on_log, on_save):
        def loss(v):
            if "grads" in out:
                return loss_fn(v)
            with first_step():
                return loss_fn(v)

        def log(t, aux):
            if t == 0:
                out["grads"] = {k: x.grad.detach().cpu() for k, x in npz_names(variables).items()}
            out.setdefault("aux", []).append([float(a) for a in aux])
            on_log(t, aux)

        return real_run(loss, optimizer, variables, n, log_every, save_every, log, on_save)

    projection._run_optimization, projection._forward = run, forward
    try:
        yield out
    finally:
        projection._run_optimization, projection._forward = real_run, real_forward


def projection_trainer(device: str, work: Path):
    """The seeded flagship Trainer (seed 0) that the projection phases
    invert, on ``device``; the interpolation histogram at 150, as the
    CLIs default to."""
    from histogan_tpu_torch.train.trainer import Trainer

    t = Trainer("proj", work / "r", work / "m", device=device, hist_resizing="interpolation",
                hist_insz=150, hist_bin=64, seed=0, **FLAGSHIP)
    t.init_GAN()
    return t


def project(t, mode: str, photo: Path, results: Path, probe: dict, steps: int, first_step):
    """project_* (``mode``) of ``photo`` by ``t``, VGG on, ``steps`` steps
    logged each, inside ``projection_probe(probe, first_step)``; its lines
    go nowhere."""
    from histogan_tpu_torch import projection

    fn = projection.project_gaussian if mode == "gaussian" else projection.project_to_latent
    with projection_probe(probe, first_step), contextlib.redirect_stdout(io.StringIO()):
        return fn(t, str(photo), results_dir=str(results), num_train_steps=steps,
                  learning_rate=PROJECTION_LR, save_every=steps, log_every=1,
                  vgg_loss_weight=0.001, seed=0)


def phase_projection_card_vs_cpu(smi) -> None:
    """P1: both projections, VGG on, card vs CPU from the same weights,
    photo and draws: the start render, the step-0 losses and gradients
    (also with the card's kinks pinned on the CPU), then
    PROJECTION_STEPS steps on the card."""
    work = WORK / "projection_p1"
    photo = work / "photo.jpg"
    write_photo(photo, 21, PROJECTION_PHOTO)
    with vgg_weights(work):
        trainers = {"card": projection_trainer(CARD, work / "card"),
                    "cpu": projection_trainer("cpu", work / "cpu")}
        start = trainers["card"].reference_state_dict()
        check(all(torch.equal(start[k].cpu(), v)
                  for k, v in trainers["cpu"].reference_state_dict().items()),
              "P1: the same weights on both")
        del start
        for mode in ("gaussian", "latent"):
            masks, flips, runs = [], {}, {}
            for name, steps, first_step in (
                    ("card", PROJECTION_STEPS, lambda: recorded_kinks(masks)),
                    ("cpu", 1, contextlib.nullcontext),
                    ("pinned", 1, lambda: pinned_kinks(masks, flips))):
                t = trainers["card" if name == "card" else "cpu"]
                runs[name] = {}
                project(t, mode, photo, work / f"{mode}_{name}", runs[name], steps, first_step)
            n_calls = len(masks)
            del masks
            card, cpu, pin = runs["card"], runs["cpu"], runs["pinned"]
            render = (card["render"] - cpu["render"]).abs().max().item()
            loss_rel = [abs(a - b) / abs(b) for a, b in zip(card["aux"][0][:2], cpu["aux"][0][:2])]
            pin_loss = [abs(a - b) / abs(b) for a, b in zip(card["aux"][0][:2], pin["aux"][0][:2])]
            grad_rel, grad_worst = worst_grad_gap(card["grads"], cpu["grads"])
            pin_rel, pin_worst = worst_grad_gap(card["grads"], pin["grads"])
            rec = [a[0] for a in card["aux"]]
            print(f"P1 {mode}: {FLAGSHIP['image_size']} px, VGG on, card vs CPU: start render max|d| {render:.3e} "
                  f"(gate {SLICE_TOL}); step 0 rec {card['aux'][0][0]:.6f}/{cpu['aux'][0][0]:.6f} "
                  f"(rel {loss_rel[0]:.2e}), vgg {card['aux'][0][1]:.6f}/{cpu['aux'][0][1]:.6f} "
                  f"(rel {loss_rel[1]:.2e}; gate {STEP_LOSS_RTOL}); gradients worst variable "
                  f"rel {grad_rel:.3e} ({grad_worst}; gate {STEP_GRAD_RTOL}); kinks pinned "
                  f"({n_calls} activation calls; flipped "
                  + ", ".join(f"{k} {v}" for k, v in sorted(flips.items()))
                  + f"): losses rel {pin_loss[0]:.2e}/{pin_loss[1]:.2e}, gradients worst "
                  f"{pin_rel:.3e} ({pin_worst}; gate {PROJECTION_PINNED_GRAD_RTOL}); "
                  f"{PROJECTION_STEPS} card "
                  f"steps: rec {rec[0]:.6f} -> {rec[-1]:.6f} on {smi}")
            check(render <= SLICE_TOL, f"P1 {mode}: start render within {SLICE_TOL}")
            check(all(r <= STEP_LOSS_RTOL for r in loss_rel + pin_loss),
                  f"P1 {mode}: step-0 losses within {STEP_LOSS_RTOL}")
            check(grad_rel <= STEP_GRAD_RTOL, f"P1 {mode}: gradients within {STEP_GRAD_RTOL}")
            check(pin_rel <= PROJECTION_PINNED_GRAD_RTOL,
                  f"P1 {mode}: pinned gradients within {PROJECTION_PINNED_GRAD_RTOL}")
            check(len(rec) == PROJECTION_STEPS and all(map(math.isfinite, rec)) and rec[-1] < rec[0],
                  f"P1 {mode}: {PROJECTION_STEPS} finite steps lower the reconstruction loss")
        for t in trainers.values():
            t.close()
    del trainers
    torch.cuda.empty_cache()


def jax_npz_layout(mode: str, image_size: int, capacity: int, optimize_noise: bool) -> dict:
    """{key: shape} of the _final.npz that the JAX package's project_*
    writes without latent noise (histogan_tpu/projection.py:339-347,
    :488-500)."""
    from histogan_tpu_torch.models.generator import generator_filters

    pairs = generator_filters(image_size, capacity)
    nl = len(pairs)
    if mode == "gaussian":
        out = {"styles": (1, nl - 2, FLAGSHIP["latent_dim"])}
    else:
        out = {}
        for i in range(nl - 2):
            out.update({f"style1_{i}": (1, pairs[i][0]), f"style2_{i}": (1, pairs[i][1]),
                        f"torgb_style_{i}": (1, pairs[i][1])})
    if optimize_noise:
        out["in_noise"] = (1, image_size, image_size, 1)
    return out


def phase_projection_clis(histogram_cuda, smi) -> dict:
    """P3: histogan-projection-gaussian-torch and -to-latent-torch through
    main([...]) on a saved flagship checkpoint (20 steps, --save_every 10,
    VGG on), then --generate toward a JPEG, a .npy and a folder, and with
    --post_recoloring and --upsampling_output (pyramid). Each file the JAX
    package writes, by name and size; the _final.npz keys and shapes.
    Returns {path: K1 launches}."""
    from PIL import Image

    from histogan_tpu_torch.cli import projection_gaussian, projection_to_latent
    from histogan_tpu_torch.data.dataset import load_rgb

    work = WORK / "projection_p3"
    photo, target = work / "photo.jpg", work / "targets" / "target.jpg"
    write_photo(photo, 22, PROJECTION_PHOTO)
    write_photo(target, 23, (160, 200))
    np.save(work / "target.npy", plain_hists(load_rgb(target)[None]))
    np.save(work / "targets" / "pool_entry.npy", plain_hists(load_rgb(photo)[None]))
    t = projection_trainer(CARD, work)
    t.save(0)  # models/proj/model_0.pt and its .config.json
    t.close()
    del t
    size = FLAGSHIP["image_size"]
    common = ["--name", "proj", "--models_dir", str(work / "m"), "--input_image", str(photo),
              "--device", CARD]
    launches = {"projection_gaussian": 0, "projection_to_latent": 0, "projection_recolor": 0}
    with vgg_weights(work):
        for mode, cli in (("gaussian", projection_gaussian), ("latent", projection_to_latent)):
            path = f"projection_{'gaussian' if mode == 'gaussian' else 'to_latent'}"
            results = work / f"results_{mode}"
            out_dir = results / "proj" / "photo"
            args = [*common, "--results_dir", str(results)]
            reset_counts(histogram_cuda)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main([*args, "--num_train_steps", "20", "--save_every", "10"])
            launches[path] = histogram_cuda.launches
            logged = [l for l in buf.getvalue().splitlines() if l.startswith("Optimization step")]
            vgg = [float(l.split("vgg loss = ")[1].split(",")[0]) for l in logged]
            want = {f"photo_{k}.{e}" for k in ("10", "20", "final") for e in ("jpg", "npz")}
            want.add("photo_start.jpg")
            got = {p.name for p in out_dir.iterdir()}
            check(got == want, f"P3 {mode}: the files JAX writes {sorted(want)}, got {sorted(got)}")
            check(all(Image.open(out_dir / f).size == (size, size) for f in want
                      if f.endswith(".jpg")), f"P3 {mode}: every jpg {size}x{size}")
            layout = jax_npz_layout(mode, size, FLAGSHIP["network_capacity"], optimize_noise=False)
            for f in ("photo_10.npz", "photo_20.npz", "photo_final.npz"):
                with np.load(out_dir / f) as npz:
                    shapes = {k: npz[k].shape for k in npz.files}
                    finite = all(np.isfinite(npz[k]).all() for k in npz.files)
                check(shapes == layout and finite,
                      f"P3 {mode}: {f} keys and shapes as JAX's {layout}: {shapes}")
            check(len(logged) == 20 and all(v > 0 for v in vgg),
                  f"P3 {mode}: 20 logged steps with the VGG term on")
            print(f"P3 {path}: 20 steps (VGG on) through main(); files "
                  f"{sorted(got)}; _final.npz {layout}; K1 launches {launches[path]} on {smi}")

            runs = [("JPEG", target, {}), ("npy", work / "target.npy", {}),
                    ("folder", work / "targets", {})]
            if mode == "gaussian":
                runs += [("JPEG, --post_recoloring", target, {"--post_recoloring": "True"}),
                         ("JPEG, --upsampling_output pyramid", target,
                          {"--upsampling_output": "True", "--upsampling_method": "pyramid"})]
            for what, hist_src, extra in runs:
                for old in out_dir.glob("generated-*.jpg"):  # names stamped to the second
                    old.unlink()
                reset_counts(histogram_cuda)
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main([*args, "--generate", "True", "--target_hist", str(hist_src),
                              *[x for kv in extra.items() for x in kv]])
                k1 = histogram_cuda.launches
                launches["projection_recolor"] += k1
                made = sorted(out_dir.glob("generated-*.jpg"))
                sources = [hist_src] if what != "folder" else sorted(
                    p for p in hist_src.iterdir() if p.is_file())
                h, w = PROJECTION_PHOTO
                if "--post_recoloring" in extra:
                    want_size = (w, h)
                elif "--upsampling_output" in extra:
                    m = 2 ** 6  # the CLIs' default --pyramid_levels
                    want_size = (-(-w // m) * m, -(-h // m) * m)
                else:
                    want_size = (size, size)
                names = [f"generated-photo{Path(s).stem}-" for s in sources]
                check(len(made) == len(sources)
                      and sorted(any(p.name.startswith(n) for p in made) for n in names)
                      == [True] * len(names)
                      and all(Image.open(p).size == want_size for p in made),
                      f"P3 {mode} --generate toward a {what}: {[p.name for p in made]}, sizes "
                      f"{[Image.open(p).size for p in made]}, want {names} at {want_size}")
                check(k1 == sum(Path(s).suffix == ".jpg" for s in sources),
                      f"P3 {mode} --generate toward a {what}: K1 once per image target ({k1})")
                print(f"P3 {path} --generate toward a {what}: {[p.name for p in made]} at "
                      f"{want_size}; K1 launches {k1}")
    check(all(v >= 1 for v in launches.values()), f"P3: K1 on every projection path {launches}")
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- the data sources and FID
def loaders_run(histogram_cuda, smi, tag: str, **opts):
    """Phase 8's trainer with ``opts`` (device_dataset, sync_every): the
    pool and steps 0-9, the metrics read back on the sync steps only and
    finite there. Launches are counted over the pool build and steps 0-9,
    as phase 8 counts them, the steps' own held to exactly one K1 and one
    K2 a step. Step 0's checkpoint is not written: a flagship checkpoint
    is 3.45 GB of the card machine's disk, which the whole script must stay
    within (phase 8 saves and loads). Returns (trainer, source, {kernel:
    launches})."""
    from histogan_tpu_torch.train.trainer import Trainer

    work = WORK / f"loaders_{tag.replace(' ', '_')}"
    cfg = dict(FLAGSHIP, batch_size=16, gradient_accumulate_every=1, hist_resizing="sampling",
               seed=0, save_every=1000, **opts)
    t = Trainer("dd", work / "results", work / "models", device=CARD, **cfg)
    t.init_GAN()
    t.save = lambda num: None
    reset_counts(histogram_cuda)
    t.set_data_src(str(WORK / "images"))
    pool = histogram_cuda.launches
    source = type(t.loader).__name__
    out = [t.train() for _ in range(10)]
    counts = {"histogram_fwd": histogram_cuda.launches,
              "histogram_bwd": histogram_cuda.bwd_launches}
    sync = t.sync_every
    synced = [i for i, m in enumerate(out) if m is not None]
    check(synced == [i for i in range(10) if i % sync == 0],
          f"{tag}: metrics read back on steps {synced} (sync_every {sync})")
    check(all(math.isfinite(v) for i in synced for v in out[i].values()),
          f"{tag}: finite losses on the synced steps")
    steps_k1, steps_k2 = counts["histogram_fwd"] - pool, counts["histogram_bwd"]
    check(pool >= 1 and (steps_k1, steps_k2) == (10, 10),
          f"{tag}: K1 {pool} in the pool build; K1 {steps_k1} and K2 {steps_k2} in the 10 "
          f"steps, want 10 and 10")
    print(f"DD1 {tag}: source {source}, sync_every {sync}; metrics read back on steps "
          f"{synced}; K1 {pool} in the pool build, K1 {steps_k1} and K2 {steps_k2} in the 10 "
          f"steps on {smi}")
    return t, source, counts


def nan_rollback_on_the_card() -> None:
    """A trainer on the card at a small width (its checkpoint stays small)
    with sync_every 4 on the device source: step 0 saves checkpoint 0;
    then each step returns NaN losses and moves G (the CPU test's
    injection): the steps that do not sync go on, the next sync step raises
    NanException and reloads checkpoint 0."""
    from histogan_tpu_torch.train import trainer as trainer_mod

    work = WORK / "loaders_nan"
    t = trainer_mod.Trainer("nan", work / "results", work / "models", device=CARD, image_size=32,
                            network_capacity=2, latent_dim=32, style_depth=2, hist_bin=16,
                            batch_size=2, gradient_accumulate_every=1, seed=0, sync_every=4)
    t.init_GAN()
    t.set_data_src(str(WORK / "images"))
    check(type(t.loader).__name__ == "DeviceDataSource", "the NaN trainer's source")
    with contextlib.redirect_stdout(io.StringIO()):
        t.train()  # step 0: saves checkpoint 0
    saved = t.store.restore(0)["GAN"]
    real = trainer_mod.train_step

    def nan_step(state, *args, **kwargs):
        with torch.no_grad():
            for p in state.G.parameters():
                p.add_(1.0)
        nan = torch.tensor(float("nan"), device=t.device)
        return {k: nan for k in ("d_loss", "g_loss", "h_loss", "q_loss", "gp_loss", "pl_mean")}

    t.steps = 13
    trainer_mod.train_step = nan_step
    raised = False
    try:
        quiet = [t.train() for _ in range(3)]  # steps 13-15
        with contextlib.redirect_stdout(io.StringIO()):
            t.train()  # step 16 syncs
    except trainer_mod.NanException:
        raised = True
    finally:
        trainer_mod.train_step = real
        t.close()
    got = t.reference_state_dict()
    check(quiet == [None] * 3 and raised, "the NaN went unread on steps 13-15 and raised at 16")
    check(all(torch.equal(got[k].cpu(), v) for k, v in saved.items()),
          "the weights rolled back to checkpoint 0")
    print("DD1 NaN rollback on the card (32 px, capacity 2, sync_every 4, DeviceDataSource): "
          "steps 13-15 (no sync) went on, step 16 (sync) found the NaN and reloaded "
          "checkpoint 0 bit for bit")


def phase_loaders(histogram_cuda, smi) -> dict:
    """DD1: phase 8's 10 steps on the streaming loader (the staged pinned
    copy), and with sync_every 4 on each source; the NaN rollback on a
    sync step. Returns {path: {kernel: launches}}."""
    runs = {"training_streaming": dict(device_dataset=False),
            "training_streaming_sync4": dict(device_dataset=False, sync_every=4),
            "training_sync4": dict(sync_every=4)}
    launches = {}
    for path, opts in runs.items():
        t, source, launches[path] = loaders_run(histogram_cuda, smi, path.replace("_", " "),
                                                **opts)
        want = "TrainLoader" if opts.get("device_dataset") is False else "DeviceDataSource"
        check(source == want, f"DD1 {path}: source {source}, want {want}")
        t.close()
        del t
        torch.cuda.empty_cache()
    nan_rollback_on_the_card()
    return launches


def phase_loaders_rehisto(histogram_cuda, smi) -> dict:
    """DD1r: reHistoGAN bf16 at 2 x 8 (R2b's configuration) on both
    sources. One trainer per source takes step 0 (save and evaluate), then
    steps 1-4 syncing every step and steps 5-8 syncing every 4th: the
    metrics read back on the sync steps only, and K1 and K2 launched
    exactly 16 and 8 a step. Returns {path: {kernel: launches}} (the
    default's path is R2b's, rehisto_training_bf16)."""
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer

    cfg = dict(REHISTO, batch_size=2, gradient_accumulate_every=REHISTO_ACCUM, seed=0,
               save_every=1000, **REHISTO_BF16)
    per_step, steps = (2 * REHISTO_ACCUM, REHISTO_ACCUM), 4
    paths = {("DeviceDataSource", 1): "rehisto_training_bf16",
             ("TrainLoader", 1): "rehisto_training_bf16_streaming",
             ("TrainLoader", 4): "rehisto_training_bf16_streaming_sync4",
             ("DeviceDataSource", 4): "rehisto_training_bf16_sync4"}
    counts = {}
    for source, flag in (("DeviceDataSource", "auto"), ("TrainLoader", False)):
        work = WORK / f"loaders_rehisto_{source}"
        t = RecoloringTrainer("dd", work / "results", work / "models", device=CARD,
                              device_dataset=flag, **cfg)
        t.init_GAN()
        t.save = lambda num: None  # no checkpoint (loaders_run)
        reset_counts(histogram_cuda)
        t.set_data_src(str(WORK / "images"), sampling=True)
        check(type(t.loader).__name__ == source and histogram_cuda.launches >= 1,
              f"DD1r: source {type(t.loader).__name__}, want {source}; K1 "
              f"{histogram_cuda.launches} in the pool build")
        t.train(**REHISTO_HYPER)  # step 0: save (skipped) and evaluate
        for sync in (1, 4):
            key, first = (source, sync), t.steps
            t.sync_every = sync
            reset_counts(histogram_cuda)
            out = [t.train(**REHISTO_HYPER) for _ in range(steps)]
            counts[key] = {"histogram_fwd": histogram_cuda.launches,
                           "histogram_bwd": histogram_cuda.bwd_launches}
            synced = [first + i for i, m in enumerate(out) if m is not None]
            want_synced = [s for s in range(first, first + steps) if s % sync == 0]
            check(synced == want_synced,
                  f"DD1r {paths[key]}: metrics read back on steps {synced}, want {want_synced}")
            check(all(math.isfinite(v) for m in out if m is not None for v in m.values()),
                  f"DD1r {paths[key]}: finite losses on the synced steps")
            want = (steps * per_step[0], steps * per_step[1])
            got = (counts[key]["histogram_fwd"], counts[key]["histogram_bwd"])
            check(got == want, f"DD1r {paths[key]}: K1 and K2 {got} in {steps} steps, "
                               f"want {want}")
            print(f"DD1r {paths[key]}: source {source}, sync_every {sync}; steps "
                  f"{first}-{first + steps - 1} (batch 2 x accumulation {REHISTO_ACCUM}, bf16) "
                  f"read back on {synced}; K1 {got[0]} and K2 {got[1]} on {smi}")
        t.close()
        del t
        torch.cuda.empty_cache()
    return {paths[k]: c for k, c in counts.items() if k != ("DeviceDataSource", 1)}


def phase_residency(smi) -> None:
    """DD2: a DeviceDataSource over the reference's landscape set as a
    synthetic 4319 x 256 x 256 x 3 uint8 cache and a 4319 x 3 x 64 x 64
    fp32 pool: the device memory it takes; at HistoGAN's 16 x 1,
    reHistoGAN's 2 x 8 (self_hist, include_g_images) and with aug_prob
    0.5, a batch behind queued device work takes less than HOST_WAIT_MS of
    the host (no sync), and each batch is held to numpy indexing of its
    draws (images exact, histograms to HIST_ATOL) and the on-card crop to
    the CPU's."""
    from histogan_tpu_torch.data.device_source import DeviceDataSource, crop_resize_u8
    from histogan_tpu_torch.tools.dp_step import synthetic_data

    cache, pool = synthetic_data(*RESIDENCY_DATA)
    n, size, h = RESIDENCY_DATA[:3]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    first = DeviceDataSource(cache, pool, 16, 1, seed=3, device=CARD)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(after - before >= cache.nbytes + pool.nbytes,
          f"DD2: the cache and the pool on the card ({after - before} bytes)")
    print(f"DD2: {n} x {size} x {size} x 3 uint8 cache ({cache.nbytes} bytes) and {n} x 3 x {h} "
          f"x {h} fp32 pool ({pool.nbytes} bytes): torch.cuda.memory_allocated {before} -> "
          f"{after} (+{after - before}) on {smi}")
    configs = {"HistoGAN 16 x 1": {},
               "reHistoGAN 2 x 8 self_hist include_g_images": dict(
                   batch_size=2, accum=8, self_hist=True, include_g_images=True),
               "HistoGAN 16 x 1 aug_prob 0.5": dict(aug_prob=0.5)}
    for name, kw in configs.items():
        if first is not None:
            src, first = first, None
        else:
            kw = {"batch_size": 16, "accum": 1, **kw}
            with contextlib.redirect_stdout(io.StringIO()):  # the aug notice
                src = DeviceDataSource(cache, pool, seed=4, device=CARD, **kw)
        for _ in range(3):  # first-call set-up outside the host-wait check
            next(src)
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUED_CYCLES)
        t0 = time.perf_counter()
        next(src)
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        check(host_ms < HOST_WAIT_MS, f"DD2 {name}: a batch behind ~0.1 s of queued device work "
                                      f"took {host_ms:.3f} ms of the host (a sync?)")
        recorded, real = [], src._draws
        src._draws = lambda: recorded.append(real()) or recorded[-1]
        worst_h, crop_off, crop_worst = 0.0, 0.0, 0
        for _ in range(3):
            batch = {k: v.cpu() for k, v in next(src).items()}
            d, (a, b) = recorded[-1], (src.accum, src.batch_size)
            for part in ("d", "g") if src.include_g_images else ("d",):
                want = cache[d[f"{part}_idx"]]
                got = batch[f"{part}_images"].numpy().reshape(want.shape)
                if src.aug_prob > 0:
                    want = crop_resize_u8(torch.from_numpy(np.array(want)),
                                          torch.from_numpy(d[f"{part}_crop"])).numpy()
                    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
                    crop_worst = max(crop_worst, int(diff.max()))
                    crop_off = max(crop_off, float((diff > 0).mean()))
                else:
                    check(np.array_equal(got, want), f"DD2 {name}: {part}_images exact")
            for part in ("d", "g"):
                if src.self_hist and f"{part}_idx" in d:
                    want = pool[d[f"{part}_idx"]]
                else:
                    r = d[f"{part}_r"][:, None, None, None]
                    pair = d[f"{part}_pair"]
                    want = r * pool[pair[0]] + (1.0 - r) * pool[pair[1]]
                got = batch[f"{part}_hists"].numpy().reshape(want.shape)
                worst_h = max(worst_h, float(np.abs(got - want).max()))
            check(all(v.shape[:2] == (a, b) for v in batch.values()), f"DD2 {name}: shapes")
        check(worst_h <= HIST_ATOL, f"DD2 {name}: histograms max|d| {worst_h:.3e} <= {HIST_ATOL}")
        check(crop_worst <= CROP_LEVELS and crop_off <= CROP_SHARE,
              f"DD2 {name}: on-card crop vs the CPU's: {crop_worst} levels on {crop_off:.2e} "
              f"of the entries")
        crop = (f"; crop vs the CPU's crop_resize_u8 at most {crop_worst} level(s) on "
                f"{crop_off:.2e} of the entries" if src.aug_prob > 0 else "; images exact")
        print(f"DD2 {name}: {host_ms:.3f} ms of the host behind queued device work (gate "
              f"{HOST_WAIT_MS}); histograms vs numpy max|d| {worst_h:.3e}{crop}")
        del src
        torch.cuda.empty_cache()


def phase_fid(t, smi) -> None:
    """F1: Trainer.calculate_fid(256) on the card after phase 8's steps,
    with the seeded random-features extractor, twice at the same step;
    then card and CPU pool3 features on 2 images at 299 px."""
    from histogan_tpu_torch.metrics import inception

    n = 256
    weights = os.environ.pop("INCEPTION_WEIGHTS", None)
    try:
        fids = []
        for _ in range(2):
            t.calculate_fid(n)
            fids.append(t.last_fid)
    finally:
        if weights is not None:
            os.environ["INCEPTION_WEIGHTS"] = weights
    f1, f2 = fids
    rel = abs(f2 - f1) / abs(f1)
    check(math.isfinite(f1) and f1 > 0 and t.fid_provenance == "random-features",
          f"F1: FID {f1} [{t.fid_provenance}]")
    check(rel <= FID_REPEAT_RTOL, f"F1: the same step's FID twice, relative {rel:.3e}")
    params = inception.random_params(0)
    x = torch.from_numpy(np.random.default_rng(9).random((2, 299, 299, 3), dtype=np.float32)
                         * 2.0 - 1.0)
    with torch.inference_mode():
        card = inception.InceptionPool3(params).to(CARD)(x.to(CARD)).cpu()
        cpu = inception.InceptionPool3(params)(x)
    gap = (card - cpu).abs()
    excess = (gap - FID_FEATURE_ATOL - FID_FEATURE_RTOL * cpu.abs()).max().item()
    check(excess <= 0, f"F1: card vs CPU pool3 within atol {FID_FEATURE_ATOL} + rtol "
                       f"{FID_FEATURE_RTOL} (max|d| {gap.max().item():.3e})")
    worst, largest = gap.max().item(), cpu.abs().max().item()
    print(f"F1: calculate_fid({n}) at step {t.steps} (batch {t.cfg.batch_size}, {n} real + {n} "
          f"EMA samples at {t.cfg.image_size} px): {f1:.4f} [{t.fid_provenance}]; "
          f"again {f2:.4f} (the real features kept), relative {rel:.3e} (gate "
          f"{FID_REPEAT_RTOL}); pool3 card vs CPU on 2 images at 299 px: max|d| {worst:.3e} "
          f"(gate {FID_FEATURE_ATOL}) on features up to {largest:.3f} on {smi}")


# ---------------------------- remat, data parallel, the debug step, the profiler hook
# Remat against no remat, and 2 ranks against one process (the JAX
# package's gates, tests/test_parallel.py:400-450 and tests/test_remat.py):
# each metric to REMAT_METRIC_RTOL, the post-step parameters (S, H, G, D)
# and the gradients handed to DiffGrad to a global-norm relative error of
# REMAT_PARAM_REL. Remat recomputes the
# same kernels on the same inputs, and the ranks' all-reduce sums in
# another order; DiffGrad's sign-like first update turns a near-zero
# gradient's rounding into a full lr, which the global norm absorbs.
REMAT_METRIC_RTOL = 5e-5
REMAT_PARAM_REL = 1e-5
# On the card the same steps run twice are not bitwise equal: cuDNN's
# weight gradients and bilinear upsampling's backward add with atomics, and
# DiffGrad turns a near-zero gradient's sign into a full lr. The phases run
# the reference twice and allow this many times that floor where it is
# above the gates.
CARD_NOISE_FACTOR = 3.0
# R5's bf16 recoloring step, remat against no remat: bf16 rounds each layer
# to 8 bits, and the D update between the phases carries any reordering of
# the weight gradients' sums (atomics) into the G phase's losses
REMAT_BF16_LOSS_RTOL = 1e-2
DP_BATCH, DP_RANKS = 8, 2  # 2 ranks on the one card, 4 images each
DP_FLAGS = [(True, True), (False, False), (True, False)]  # DP's and FS's: GP+PL, plain, GP
# DP beyond D's first update. G's step-0 metrics come after it: DiffGrad's
# sign-like first update turns rounding in a near-zero gradient into a full
# lr, so they may move further than the JAX gate (measured on the card
# 1.4e-5, on the CPU at 128 px capacity 8 4.0e-5). Over the 3 steps that
# grows as the GAN's dynamics amplify it (measured 2.3e-2 in a metric and
# 6.0e-4 in the parameters, where one process run twice moves 1.8e-3 and
# 2.2e-4, and 2 CPU ranks at 128 px 1.3e-3 and 8.1e-5): those bounds catch
# ranks out of step or a loss taken over the local batch (the Hellinger
# loss's would be 41 % off), not rounding.
DP_G_METRIC_RTOL = 5e-4
DP_DRIFT_METRIC_RTOL = 0.25
DP_DRIFT_PARAM_REL = 1e-2
D_PHASE_METRICS = ("d_loss", "gp_loss", "q_loss")
# FS512: a plain step (DiffGrad's state is made in the first update), then
# the GP+PL step
FS512_FLAGS = [(False, False), (True, True)]
DS_BATCHES = 8  # DS: batches of each configuration, each held to the replicated source's
# the JAX package's 512 px recipe (its configuration only)
RECIPE_512 = dict(image_size=512, network_capacity=16, latent_dim=512, style_depth=8,
                  batch_size=8, gradient_accumulate_every=1, precision="bf16",
                  opt_state_dtype="bf16")
LIVE = ("S", "H", "G", "D")
K1_KERNELS, K2_KERNELS = ("hist_partial_kernel", "hist_reduce_kernel"), ("hist_bwd_kernel",)


def pinned_steps(cfg, flags, seed: int, rehisto: bool = False) -> list:
    """One pinned input per (gp, pl) of ``flags`` at ``cfg``'s (global)
    batch, made on the CPU from ``seed``: {"batch", "draws", "gp", "pl"},
    as ``tools/dp_step.py`` takes them."""
    from histogan_tpu_torch.train import rehisto_steps, steps

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    a, b, s = cfg.gradient_accumulate_every, cfg.batch_size, cfg.image_size
    out = []
    for gp, pl in flags:
        h = rng.random((2, a, b, 3, cfg.hist_bin, cfg.hist_bin), dtype=np.float32)
        h /= h.sum(axis=(3, 4, 5), keepdims=True)
        batch = {"d_images": rng.integers(0, 256, (a, b, s, s, 3), dtype=np.uint8),
                 "d_hists": h[0], "g_hists": h[1]}
        if rehisto:
            batch["g_images"] = rng.integers(0, 256, (a, b, s, s, 3), dtype=np.uint8)
        draws = (rehisto_steps.draw_step(gen, cfg, "cpu") if rehisto
                 else steps.draw_step(gen, cfg, "cpu", pl))
        out.append({"batch": {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in batch.items()},
                    "draws": draws, "gp": gp, "pl": pl})
    return out


def live_params(t) -> dict:
    """The trained parameters, copied to the CPU (off the card's memory)."""
    return {k: v.detach().cpu() for k, v in t.reference_state_dict().items()
            if k.split(".")[0] in LIVE + ("ED",)}


def param_rel_err(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every tensor of ``want``, float64."""
    num = den = 0.0
    for k, w in want.items():
        w, g = w.double(), got[k].to(w.device).double()
        num += (g - w).square().sum().item()
        den += w.square().sum().item()
    return math.sqrt(num) / (math.sqrt(den) + 1e-30)


def metric_gaps(got: list, want: list) -> float:
    """The largest relative gap of a metric over the steps."""
    return max(worst_metrics(got, want))


def worst_metrics(got: list, want: list) -> list:
    """Per step, the largest relative gap of a metric."""
    return [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in w) for g, w in zip(got, want)]


def against_floor(what: str, gap: float, floor: float, gate: float) -> None:
    """``gap`` within ``gate``, or within CARD_NOISE_FACTOR times the
    reference's own run-to-run ``floor`` where that is larger."""
    allowed = max(gate, CARD_NOISE_FACTOR * floor)
    check(gap <= allowed, f"{what}: {gap:.3e} within max({gate}, {CARD_NOISE_FACTOR} x the "
                          f"floor {floor:.3e})")


def median_gap(dist, got, refs: list) -> tuple:
    """(The median of ``dist(got, ref)`` over the runs ``refs`` of the
    reference, the median of ``dist`` over their pairs): a run held to the
    reference's spread between runs, each side from three samples: one
    floor sample of RM's gradients ranged over a factor of five across
    runs on the H100."""
    gap = statistics.median(dist(got, r) for r in refs)
    floor = statistics.median(dist(a, b) for a, b in itertools.combinations(refs, 2))
    return gap, floor


def median_rel_err(got: dict, refs: list) -> tuple:
    """``median_gap`` of ``param_rel_err`` on {name: tensor} dicts, computed
    on the card in float64 (on the host, six such sums over 190 M entries
    a tensor set cost a minute)."""
    def card(d):
        return {k: v.to(CARD, torch.float64) for k, v in d.items()}

    out = median_gap(param_rel_err, card(got), [card(r) for r in refs])
    torch.cuda.empty_cache()
    return out


def grad_gaps(what: str, got: dict, want: dict, again: dict) -> None:
    """Each phase's applied gradients of ``got`` ({(step, phase): grads},
    as remat_run's ``grads``) against ``want``'s, to REMAT_PARAM_REL or
    CARD_NOISE_FACTOR times ``again``'s (the reference run twice) gap;
    prints both."""
    check(bool(want) and set(got) == set(want) == set(again),
          f"{what}: gradients of {sorted(want)}")
    for key in sorted(want):
        gap, floor = (param_rel_err(r[key], want[key]) for r in (got, again))
        print(f"{what}: the {key[0]} step's {key[1]} gradient, global-norm relative error "
              f"{gap:.3e} (the reference twice: {floor:.3e})")
        against_floor(f"{what}: the {key[0]} step's {key[1]} gradient", gap, floor,
                      REMAT_PARAM_REL)


def remat_run(histogram_cuda, remat: bool, kw: dict, flags, seed: int,
              rehisto: bool = False, grads_steps: int = 0) -> dict:
    """A trainer (seed 0) with ``remat``, the pinned steps of ``flags`` on
    the card: per step the metrics, finite; the K1 and K2 launches of the
    steps; the live parameters after them; and for each of the first
    ``grads_steps`` steps the gradients each phase hands to DiffGrad (fp32,
    on the CPU, in ``grads[(step, "D" or "G")]``). With ``grads_steps``,
    G's phase first runs alone on step 0's input against the seed's D, and
    its gradients (summed over the micro-batches) are kept as
    ``grads[(0, "G alone")]`` and not applied: no D update's rounding
    reaches them."""
    from histogan_tpu_torch.tools.dp_step import to_device
    from histogan_tpu_torch.train import rehisto_steps, steps
    from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
    from histogan_tpu_torch.train.trainer import Trainer

    cls = RecoloringTrainer if rehisto else Trainer
    t = cls("remat", WORK / "remat" / "r", WORK / "remat" / "m", device=CARD, seed=0,
            remat=remat, **kw)
    t.init_GAN()
    check(t.G.remat == remat and t.D.remat == remat, f"remat={remat} reaches G and D")
    inputs = pinned_steps(t.cfg, flags, seed, rehisto)
    metrics, grads = [], {}
    update = steps._update
    if grads_steps:
        s = inputs[0]
        batch, draws = to_device(s["batch"], t.device), to_device(s["draws"], t.device)

        def kept(opt, params, g, accum):
            grads[(0, "G alone")] = {str(i): x.detach().float().cpu() for i, x in enumerate(g)}

        pl_mean = getattr(t.state, "pl_mean", None)
        steps._update = rehisto_steps._update = kept
        try:
            if rehisto:
                rehisto_steps.g_phase(t.state, batch, draws, t.cfg, **REHISTO_HYPER)
            else:
                steps.g_phase(t.state, batch, draws, t.cfg, s["pl"])
                t.state.pl_mean = pl_mean
        finally:
            steps._update = rehisto_steps._update = update
    reset_counts(histogram_cuda)

    def spied(*args):  # _update averaged the gradients in place: D's phase, then G's
        update(*args)
        if len(metrics) < grads_steps:
            phase = "D" if args[0] is t.state.opt_d else "G"
            grads[(len(metrics), phase)] = {str(i): g.detach().float().cpu()
                                            for i, g in enumerate(args[2])}

    steps._update = rehisto_steps._update = spied
    try:
        for s in inputs:
            batch, draws = to_device(s["batch"], t.device), to_device(s["draws"], t.device)
            if rehisto:
                m = rehisto_steps.train_step(t.state, batch, draws, t.cfg, s["gp"],
                                             **REHISTO_HYPER)
            else:
                m = steps.train_step(t.state, batch, draws, t.cfg, s["gp"], s["pl"])
            metrics.append({k: v.item() for k, v in m.items()})
            check(all(math.isfinite(v) for v in metrics[-1].values()),
                  f"remat={remat}: finite losses {metrics[-1]}")
    finally:
        steps._update = rehisto_steps._update = update
    counts = {"histogram_fwd": histogram_cuda.launches,
              "histogram_bwd": histogram_cuda.bwd_launches}
    out = {"metrics": metrics, "counts": counts, "params": live_params(t), "grads": grads}
    del t
    torch.cuda.empty_cache()
    return out


def phase_remat(histogram_cuda) -> dict:
    """RM: remat at the main path's width and batch (256 px, capacity 16,
    latent 512, batch 16, fp32): a plain step and a GP+PL step, each from
    the seed's weights (a step after an update would carry the card's
    run-to-run rounding through DiffGrad's sign-like first update), with
    remat and without (three times, for the floor: ``median_gap``), on the
    same pinned inputs: the metrics to REMAT_METRIC_RTOL, the parameters
    after each step and each phase's gradients (as handed to DiffGrad; G's
    also from its phase alone against the seed's D, which D's sign-like
    update cannot reach) to REMAT_PARAM_REL (or CARD_NOISE_FACTOR times the
    floor), the K1 and K2 launches equal.
    R5: a bf16 recoloring GP step at the CLI's defaults (batch 2 x
    accumulation 8) with remat and without (twice, for the floor): its
    metrics to REMAT_BF16_LOSS_RTOL, its D and G gradients as RM's. R512:
    the 512 px recipe (capacity 16, batch 8, bf16 with bf16 DiffGrad
    state), a plain and a GP+PL step each way, finite.
    Returns {kernel: launches} of the 256 px runs with remat."""
    kw = dict(FLAGSHIP, batch_size=16, gradient_accumulate_every=1)
    runs = {}
    for r in (False, True, "again", "again2"):
        one = remat_run(histogram_cuda, r is True, kw, [(False, False)], seed=31, grads_steps=1)
        two = remat_run(histogram_cuda, r is True, kw, [(True, True)], seed=32, grads_steps=1)
        runs[r] = {"metrics": [one["metrics"][0], two["metrics"][0]],
                   "params": {"plain": one["params"], "GP+PL": two["params"]},
                   "grads": {(step, phase): g for step, run in (("plain", one), ("GP+PL", two))
                             for (_, phase), g in run["grads"].items()},
                   "counts": {k: one["counts"][k] + two["counts"][k] for k in one["counts"]}}
    checked, refs = runs[True], [runs[r] for r in (False, "again", "again2")]
    plain = refs[0]
    gap, floor = median_gap(metric_gaps, checked["metrics"], [r["metrics"] for r in refs])
    print(f"RM: remat against none, a plain and a GP+PL step from the seed's weights: metric "
          f"gaps per step {worst_metrics(checked['metrics'], plain['metrics'])} (no remat "
          f"twice: {worst_metrics(refs[1]['metrics'], plain['metrics'])}); median over the 3 "
          f"runs without remat {gap:.3e}, their own {floor:.3e}")
    against_floor("RM: remat's metrics", gap, floor, REMAT_METRIC_RTOL)
    for step in plain["params"]:
        rel, rel_floor = median_rel_err(checked["params"][step], [r["params"][step] for r in refs])
        print(f"RM: the parameters after the {step} step, global-norm relative error {rel:.3e} "
              f"(median over the 3 runs without remat; theirs {rel_floor:.3e})")
        against_floor(f"RM: remat's parameters after the {step} step", rel, rel_floor,
                      REMAT_PARAM_REL)
    check(bool(plain["grads"]) and all(set(r["grads"]) == set(plain["grads"])
                                       for r in (checked, *refs)),
          f"RM: remat: gradients of {sorted(plain['grads'])}")
    for key in sorted(plain["grads"]):
        rel, rel_floor = median_rel_err(checked["grads"][key], [r["grads"][key] for r in refs])
        print(f"RM: remat: the {key[0]} step's {key[1]} gradient, global-norm relative error "
              f"{rel:.3e} (median over the 3 runs without remat; theirs {rel_floor:.3e})")
        against_floor(f"RM: remat: the {key[0]} step's {key[1]} gradient", rel, rel_floor,
                      REMAT_PARAM_REL)
    check(plain["counts"] == checked["counts"] and plain["counts"]["histogram_fwd"] == 2
          and plain["counts"]["histogram_bwd"] == 2,
          f"RM: one K1 and one K2 a step with and without remat: {plain['counts']}, "
          f"{checked['counts']}")
    counts = checked["counts"]
    del runs, plain, refs, checked
    torch.cuda.empty_cache()

    re_kw = dict(REHISTO, batch_size=2, gradient_accumulate_every=REHISTO_ACCUM, **REHISTO_BF16)
    re_runs = {r: remat_run(histogram_cuda, r is True, re_kw, [(True, False)], seed=32,
                            rehisto=True, grads_steps=1) for r in (False, True, "again")}
    re_gap = metric_gaps(re_runs[True]["metrics"], re_runs[False]["metrics"])
    check(re_gap <= REMAT_BF16_LOSS_RTOL,
          f"R5: bf16 recoloring step with remat within {REMAT_BF16_LOSS_RTOL} ({re_gap:.3e})")
    check(re_runs[True]["counts"] == re_runs[False]["counts"],
          f"R5: K1/K2 launches alike {re_runs[True]['counts']}, {re_runs[False]['counts']}")
    grad_gaps("R5: remat", *({("GP", phase): g for (_, phase), g in re_runs[r]["grads"].items()}
                             for r in (True, False, "again")))
    print(f"R5: worst metric gap remat against none {re_gap:.3e} (gate {REMAT_BF16_LOSS_RTOL})")
    del re_runs
    torch.cuda.empty_cache()

    for r in (False, True):
        run = remat_run(histogram_cuda, r, RECIPE_512, [(False, False), (True, True)], seed=33)
        print(f"R512: 512 px capacity 16 batch 8 bf16 (bf16 DiffGrad state) "
              f"{'with' if r else 'without'} remat: a plain and a GP+PL step, finite losses")
        del run
        torch.cuda.empty_cache()
    return counts


def hold_ranks_to_one(tag: str, two: list, one: dict, again: dict) -> None:
    """DP's gates for two ranks' results of the DP case against one
    process's (run twice, for the floor): the ranks' parameters bitwise
    equal and their metrics alike, step 0's D losses to REMAT_METRIC_RTOL
    and D's step-0 gradient to REMAT_PARAM_REL (before any update), step
    0's other metrics to DP_G_METRIC_RTOL, the steps to the drift
    bounds."""
    check(all(torch.equal(two[0]["state"][k], two[1]["state"][k]) for k in two[0]["state"]),
          f"{tag}: the two ranks' parameters bitwise equal after the steps")
    check(two[0]["metrics"] == two[1]["metrics"], f"{tag}: every rank reads the same metrics")
    d_gap = max(abs(two[0]["metrics"][0][k] - w) / max(abs(w), 1e-12)
                for k, w in one["metrics"][0].items() if k in D_PHASE_METRICS)
    g_gap = worst_metrics(two[0]["metrics"][:1], one["metrics"][:1])[0]
    d_grads = [k for k in one["grads"] if k.startswith("D.")]
    d_rel = param_rel_err(two[0]["grads"], {k: one["grads"][k] for k in d_grads})
    want = {k: v for k, v in one["state"].items() if k.split(".")[0] in LIVE}
    gap = metric_gaps(two[0]["metrics"], one["metrics"])
    rel, rel_floor = (param_rel_err(r["state"], want) for r in (two[0], again))
    print(f"{tag}: 2 ranks against one process: step 0's D losses {d_gap:.3e} (gate "
          f"{REMAT_METRIC_RTOL}), D's step-0 gradient global-norm relative error {d_rel:.3e} "
          f"(gate {REMAT_PARAM_REL}), step 0's metrics {g_gap:.3e} (gate {DP_G_METRIC_RTOL}); "
          f"metric gaps per step {worst_metrics(two[0]['metrics'], one['metrics'])} (one "
          f"process twice: {worst_metrics(again['metrics'], one['metrics'])}), parameters' "
          f"global-norm relative error {rel:.3e} (one process twice: {rel_floor:.3e}; gates "
          f"{DP_DRIFT_METRIC_RTOL} and {DP_DRIFT_PARAM_REL})")
    check(d_gap <= REMAT_METRIC_RTOL and d_rel <= REMAT_PARAM_REL and g_gap <= DP_G_METRIC_RTOL,
          f"{tag}: step 0 within the gates")
    check(gap <= DP_DRIFT_METRIC_RTOL and rel <= DP_DRIFT_PARAM_REL,
          f"{tag}: the steps within the drift bounds")


def dp_case(work: Path, **extra) -> dict:
    """DP's case: the pinned steps of DP_FLAGS at 256 px, capacity 16, a
    global batch of DP_BATCH, from the seed's weights; the live weights
    kept (the EMA does not move in these steps)."""
    from histogan_tpu_torch.utils.config import HistoGANConfig

    kw = dict(name="dp", results_dir=str(work / "r"), models_dir=str(work / "m"), seed=0,
              **FLAGSHIP, batch_size=DP_BATCH, gradient_accumulate_every=1, **extra)
    cfg = HistoGANConfig(**FLAGSHIP, batch_size=DP_BATCH, gradient_accumulate_every=1)
    return {"kind": "histogan", "trainer": kw, "state": None, "grads_step": 0, "keep": LIVE,
            "steps": pinned_steps(cfg, DP_FLAGS, seed=41)}


def fs512_case(work: Path) -> dict:
    """FS512's case: the JAX package's 512 px recipe as R512 runs it
    (capacity 16, bf16, bf16 DiffGrad state) with remat and
    param_sharding='fsdp', FS512_FLAGS' pinned steps; the state kept as a
    digest."""
    from histogan_tpu_torch.utils.config import HistoGANConfig

    shape = {k: RECIPE_512[k] for k in ("image_size", "batch_size", "gradient_accumulate_every")}
    cfg = HistoGANConfig(**FLAGSHIP | shape)
    kw = dict(name="fs512", results_dir=str(work / "r"), models_dir=str(work / "m"), seed=0,
              remat=True, param_sharding="fsdp", **FLAGSHIP | RECIPE_512)
    return {"kind": "histogan", "trainer": kw, "state": None, "grads_step": None,
            "digest": True, "steps": pinned_steps(cfg, FS512_FLAGS, seed=33)}


def ds_cases() -> dict:
    """DS's source cases, {DD2's configuration: case}: DD2's synthetic
    cache and pool under a per-device budget of half their bytes plus 1
    MiB (one rank cannot hold them, two can), DS_BATCHES batches each."""
    from histogan_tpu_torch.tools.dp_step import synthetic_data

    cache, pool = synthetic_data(*RESIDENCY_DATA)
    budget = (cache.nbytes + pool.nbytes) // 2 + (1 << 20)
    configs = {"HistoGAN 16 x 1": dict(batch_size=16, accum=1, flag="auto"),
               "reHistoGAN 2 x 8 self_hist include_g_images": dict(
                   batch_size=2, accum=8, flag="auto",
                   options=dict(self_hist=True, include_g_images=True)),
               "HistoGAN 16 x 1 aug_prob 0.5": dict(batch_size=16, accum=1, flag=True,
                                                    options=dict(aug_prob=0.5))}
    return {name: {"kind": "source", "data": RESIDENCY_DATA, "batches": DS_BATCHES,
                   "budget": budget, **c} for name, c in configs.items()}


def phase_ranks() -> dict:
    """The cases of DP, FS, FS512 and DS on DP_RANKS gloo ranks on cuda:0,
    in one spawn of ``tools/dp_step.py`` (one start-up of the ranks):
    {"dp", "fs", "fs512": each rank's results, "ds": {configuration: each
    rank's results}}."""
    from histogan_tpu_torch.tools import dp_step

    work = WORK / "ranks"
    work.mkdir(parents=True, exist_ok=True)
    sources = ds_cases()
    cases = [dp_case(work / "dp"), dp_case(work / "fs", param_sharding="fsdp"),
             fs512_case(work / "fs512"), *sources.values()]
    torch.save(cases, work / "cases.pt")
    ranks = dp_step.spawn(work / "cases.pt", work / "out", DP_RANKS, "gloo", "cuda:0",
                          timeout=900)
    shutil.rmtree(work / "out", ignore_errors=True)
    print(f"ranks: the {len(cases)} cases of DP, FS, FS512 and DS on {DP_RANKS} gloo ranks on "
          f"cuda:0 in one spawn")
    per_case = [[r[i] for r in ranks] for i in range(len(cases))]
    return {"dp": per_case[0], "fs": per_case[1], "fs512": per_case[2],
            "ds": dict(zip(sources, per_case[3:]))}


def torchrun_cli(tag: str, out: Path, *extra) -> list:
    """``torchrun --nproc_per_node 1`` over NCCL through the real CLI for 2
    steps at capacity 4 (a small step-0 checkpoint), with ``extra`` flags;
    returns the files it wrote under models/."""
    from histogan_tpu_torch.tools.dp_step import free_port

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
           "--master_addr", "localhost", "--master_port", str(free_port()),
           "-m", "histogan_tpu_torch.cli.histogan", "--data", str(WORK / "images"),
           "--name", "dp", "--new", "True", "--results_dir", str(out / "results"),
           "--models_dir", str(out / "models"), "--image_size", "256",
           "--network_capacity", "4", "--batch_size", str(DP_BATCH),
           "--gradient_accumulate_every", "1", "--num_train_steps", "2", "--num_devices", "1",
           *extra]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT),
                                                                   os.environ.get("PYTHONPATH")])),
           "NCCL_DEBUG": "INFO"}
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"{tag}: torchrun CLI exit {proc.returncode}:\n{log[-4000:]}")
    check("NCCL INFO" in log, f"{tag}: the CLI's process group runs over NCCL (NCCL_DEBUG lines)")
    made = sorted(p.name for p in (out / "models" / "dp").iterdir())
    check("model_0.pt" in made and (out / "results" / "dp" / "metrics.jsonl").is_file(),
          f"{tag}: the CLI under torchrun wrote its checkpoint and log ({made})")
    print(f"{tag}: torchrun --nproc_per_node 1 -m histogan_tpu_torch.cli.histogan --num_devices 1 "
          f"{' '.join(extra)} (NCCL; 256 px, capacity 4, batch {DP_BATCH}, 2 steps) exit 0; "
          f"wrote {made}")
    return made


def phase_data_parallel(histogram_cuda, smi, two: list) -> tuple:
    """DP: two ranks on the one card over gloo (NCCL puts one rank on a
    GPU), DP's case (``dp_case``) through ``tools/dp_step.py``
    (``phase_ranks``: ``two``), against the same steps in this one process
    (run twice, for the floor), in ``hold_ranks_to_one``'s gates; K1 and K2
    on every rank. Returns
    ({path: {kernel: launches}}, {"one", "again": the one-process runs,
    "two": the ranks' results}) for FS, which also runs the CLI under
    ``torchrun`` (one process: FSDP there is this replicated path)."""
    from histogan_tpu_torch.tools import dp_step

    case = dp_case(WORK / "dp")
    one, again = (dp_step.run_cases([case], CARD)[0] for _ in range(2))
    hold_ranks_to_one("DP", two, one, again)
    for r in (*two, one, again):
        check(r["launches"] == {"histogram_fwd": len(DP_FLAGS), "histogram_bwd": len(DP_FLAGS)},
              f"DP: one K1 and one K2 a step on every rank: {r['launches']}")
    print(f"DP: 2 gloo ranks on cuda:0 at global batch {DP_BATCH} (256 px, capacity 16, fp32), "
          f"steps GP+PL/plain/GP against one process at batch {DP_BATCH}; ranks bitwise equal; "
          f"launches per rank {two[0]['launches']} on {smi}")
    launches = {"dp_rank0": two[0]["launches"], "dp_rank1": two[1]["launches"]}
    for r in two:
        del r["grads"]
    torch.cuda.empty_cache()
    return launches, {"one": one, "again": again, "two": two}


def phase_fsdp(histogram_cuda, smi, dp: dict, two: list) -> dict:
    """FS: DP's case with param_sharding='fsdp' on the two gloo ranks
    (``phase_ranks``: ``two``): DP's
    gates against DP's one-process runs (``hold_ranks_to_one``), the
    gathered state bitwise equal on both ranks, K1 and K2 once a step on
    each, each rank's state under 0.6 of DP's rank's; whether FSDP's
    parameters are bitwise DP's. Then ``torchrun
    --nproc_per_node 1`` over NCCL through the real CLI for 2 steps with
    ``--param_sharding fsdp`` (capacity 4, so that its step-0 checkpoint
    stays small; at one process the replicated path), and its model_0.pt
    into a one-process replicated Trainer. Returns {path: {kernel:
    launches}}."""
    from histogan_tpu_torch.train.trainer import Trainer

    hold_ranks_to_one("FS", two, dp["one"], dp["again"])
    for r in two:
        check(r["launches"] == {"histogram_fwd": len(DP_FLAGS), "histogram_bwd": len(DP_FLAGS)},
              f"FS: one K1 and one K2 a step on every rank: {r['launches']}")
    dp_two = dp["two"]
    share = [f["state_bytes"] / d["state_bytes"] for f, d in zip(two, dp_two)]
    check(all(s < 0.6 for s in share), f"FS: each rank holds under 0.6 of DP's state ({share})")
    same = all(torch.equal(two[0]["state"][k], dp_two[0]["state"][k]) for k in two[0]["state"])
    print(f"FS: 2 gloo ranks on cuda:0, param_sharding='fsdp', global batch {DP_BATCH} (256 px, "
          f"capacity 16, fp32), steps GP+PL/plain/GP: state per rank {share[0]:.4f} and "
          f"{share[1]:.4f} of DP's; "
          f"parameters after the steps bitwise DP's: {same}; launches per rank "
          f"{two[0]['launches']}; collectives all_gather_into_tensor and reduce_scatter_tensor "
          f"(torch {torch.__version__}, staged through the host on gloo) on {smi}")
    launches = {"fsdp_rank0": two[0]["launches"], "fsdp_rank1": two[1]["launches"]}
    del two
    out = WORK / "fs_cli"
    made = torchrun_cli("FS", out, "--param_sharding", "fsdp")
    t = Trainer("dp", str(out / "results"), str(out / "models"), image_size=256,
                network_capacity=4, batch_size=DP_BATCH, device=CARD)
    t.load(0)
    saved = torch.load(out / "models" / "dp" / "model_0.pt", map_location="cpu",
                       weights_only=True)["GAN"]
    got = t.reference_state_dict()
    check(set(got) == set(saved) and all(torch.equal(got[k].cpu(), saved[k]) for k in saved),
          "FS: the CLI's FSDP checkpoint loads into a one-process replicated Trainer")
    print(f"FS: the CLI with --param_sharding fsdp wrote {made}; model_0.pt ({len(saved)} "
          f"tensors) loads into a one-process replicated Trainer on {smi}")
    del t
    torch.cuda.empty_cache()
    return launches


def phase_fsdp512(smi, two: list) -> dict:
    """FS512: ``fs512_case`` on the two gloo ranks at a global batch of 8
    (``phase_ranks``: ``two``), a plain step (DiffGrad's state is made in
    the first update) and the GP+PL step: finite metrics, the gathered
    state alike on both ranks (its digest), K1 and K2 on each rank.
    Returns {path: {kernel: launches}}."""
    flags = FS512_FLAGS
    check(all(math.isfinite(v) for r in two for m in r["metrics"] for v in m.values()),
          f"FS512: finite metrics {two[0]['metrics']}")
    check(two[0]["state"] == two[1]["state"], "FS512: the gathered state alike on both ranks")
    check(all(r["launches"] == {"histogram_fwd": len(flags), "histogram_bwd": len(flags)}
              for r in two), f"FS512: one K1 and one K2 a step on every rank "
                             f"{[r['launches'] for r in two]}")
    print(f"FS512: a plain and a GP+PL step, 512 px capacity 16 global batch 8 bf16 (bf16 "
          f"DiffGrad state) remat, FSDP over 2 gloo ranks: metrics {two[0]['metrics']} on {smi}")
    return {"fsdp512_rank0": two[0]["launches"], "fsdp512_rank1": two[1]["launches"]}


def phase_sharded_source(smi, ranks: dict) -> None:
    """DS: the device dataset's "sharded" placement over DD2's synthetic
    4319 x 256² cache and pool on the two gloo ranks (``ds_cases``, run in
    ``phase_ranks``: ``ranks``): each rank holds ceil(4319 / 2) rows, and
    the two ranks' batches side by side are bit for bit the replicated
    source's global batches of the same seed, at DD2's configurations."""
    from histogan_tpu_torch.data.device_source import DeviceDataSource
    from histogan_tpu_torch.tools.dp_step import synthetic_data

    cache, pool = synthetic_data(*RESIDENCY_DATA)
    total = cache.nbytes + pool.nbytes
    rows = -(-RESIDENCY_IMAGES // DP_RANKS)
    row_bytes = total // RESIDENCY_IMAGES
    configs = ds_cases()
    for name, c in configs.items():
        two = ranks[name]
        check(all(r["shard_cache"] and r["rows"] == rows and r["bytes"] == rows * row_bytes
                  for r in two), f"DS {name}: each rank holds {rows} rows "
                                 f"({[(r['shard_cache'], r['rows'], r['bytes']) for r in two]})")
        with contextlib.redirect_stdout(io.StringIO()):  # the aug notice
            src = DeviceDataSource(cache, pool, c["batch_size"], c["accum"], seed=3, device=CARD,
                                   **c.get("options", {}))
        for i in range(DS_BATCHES):
            want = next(src)
            check(all(torch.equal(torch.cat([r["batches"][i][k] for r in two], dim=1),
                                  v.cpu()) for k, v in want.items()),
                  f"DS {name}: batch {i} of the two ranks is the replicated source's")
        print(f"DS {name}: sharded over 2 gloo ranks on cuda:0 (budget {c['budget']} bytes a "
              f"device, {total} in all): {rows} rows and {two[0]['bytes']} bytes a rank; "
              f"{DS_BATCHES} batches bit for bit the replicated source's on {smi}")
        del src
    torch.cuda.empty_cache()


def phase_debug(smi) -> None:
    """DB: ``checkify_step`` around one plain 256 px step at batch 16 (fp32):
    it passes, and the mode saw the backward's ops, which the autograd
    engine runs on a thread of its own on a GPU. With one of D's weights
    NaN the same step raises a FloatCheckError that names an op."""
    from histogan_tpu_torch.train import steps
    from histogan_tpu_torch.train.trainer import Trainer
    from histogan_tpu_torch.utils.debug import FloatCheckError, checkify_step
    from histogan_tpu_torch.tools.dp_step import to_device

    t = Trainer("debug", WORK / "debug" / "r", WORK / "debug" / "m", device=CARD, seed=0,
                **FLAGSHIP, batch_size=16, gradient_accumulate_every=1)
    t.init_GAN()
    s = pinned_steps(t.cfg, [(False, False)], seed=51)[0]
    batch, draws = to_device(s["batch"], t.device), to_device(s["draws"], t.device)
    step = checkify_step(steps.train_step)
    m = step(t.state, batch, draws, t.cfg, False, False)
    check(all(math.isfinite(v.item()) for v in m.values()), "DB: a clean step")
    ops = step.checks.ops
    backward = {k: v for k, v in ops.items() if "backward" in k}
    check(ops["convolution_backward"] > 0,
          f"DB: the mode sees the backward's ops on the card ({sorted(backward)})")
    with torch.no_grad():
        t.state.D.blocks[0].conv_res.weight[0, 0, 0, 0] = float("nan")
    try:
        step(t.state, batch, draws, t.cfg, False, False)
        raise RuntimeError("check failed: DB: a NaN weight in D raises")
    except FloatCheckError as e:
        err = e
    check(err.op.startswith("aten."), f"DB: the error names an op ({err})")
    print(f"DB: checkify_step on a plain 256 px batch 16 step: passes, {sum(ops.values())} ops "
          f"checked ({sum(backward.values())} of the backward's, e.g. convolution_backward "
          f"{ops['convolution_backward']}); "
          f"with D.blocks.0.conv_res.weight[0, 0, 0, 0] = NaN: FloatCheckError '{err}' on {smi}")
    del t
    torch.cuda.empty_cache()


def phase_profiler(histogram_cuda, smi) -> dict:
    """PF: ``Trainer.enable_profiling(1, 2)`` on a 3-step run (256 px,
    capacity 16, batch 16, fp32, phase 8's images; step 0's checkpoint not
    written) writes a Chrome trace of steps 1-2 holding K1's and K2's
    kernels. Returns {kernel: launches} of the 3 steps."""
    from histogan_tpu_torch.train.trainer import Trainer

    t = Trainer("prof", WORK / "prof_hook" / "r", WORK / "prof_hook" / "m", device=CARD,
                seed=0, **FLAGSHIP, batch_size=16, gradient_accumulate_every=1)
    t.init_GAN()
    t.save = lambda num: None
    t.set_data_src(str(WORK / "images"))
    reset_counts(histogram_cuda)
    pool = histogram_cuda.launches
    t.enable_profiling(1, 2)
    try:
        for _ in range(3):
            t.train()
    finally:
        t.close()
    counts = {"histogram_fwd": histogram_cuda.launches - pool,
              "histogram_bwd": histogram_cuda.bwd_launches}
    path = t.profiler_hook.path
    check(path is not None and path.is_file(), f"PF: a trace was written ({path})")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in n for n in kernels) for k in K1_KERNELS + K2_KERNELS}
    check(all(v >= 2 for v in found.values()),
          f"PF: K1's and K2's kernels in the trace of 2 steps: {found}")
    print(f"PF: enable_profiling(1, 2) over 3 steps: {path.name}, "
          f"{path.stat().st_size} bytes, {len(kernels)} kernels, of them {found}; K1/K2 "
          f"launches {counts} in the 3 steps on {smi}")
    del t
    torch.cuda.empty_cache()
    return counts


def main(argv=None) -> int:
    argparse.ArgumentParser(description="Checks of the port on one GPU.").parse_args(argv)
    t_start = time.perf_counter()
    # ---- 1. device
    if not torch.cuda.is_available():
        print("device: torch.cuda.is_available() is False; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    from histogan_tpu_torch.ops import histogram_cuda
    from histogan_tpu_torch.utils.platform import setup_runtime

    dev = setup_runtime("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    shutil.rmtree(WORK, ignore_errors=True)

    hmma = timed("2", phase_build, histogram_cuda)
    fwd_err, fwd_rows = timed("3", phase_forward, histogram_cuda, dev)
    sampling_launches, sampling_u1 = timed("4-5", phase_sampling, histogram_cuda, dev, smi)
    bwd_err, bwd_rows = timed("6", phase_backward, histogram_cuda, dev)
    upsample_rows = timed("U", phase_upsample, dev)
    timed("7", phase_loss_gradient, dev)
    counts = timed("8", phase_train, histogram_cuda, smi)
    counts_bf16 = timed("8b", phase_train, histogram_cuda, smi, BF16)
    counts_loaders = timed("DD1", phase_loaders, histogram_cuda, smi)
    counts_loaders.update(timed("DD1r", phase_loaders_rehisto, histogram_cuda, smi))
    timed("DD2", phase_residency, smi)
    counts_d = timed("D1", phase_train, histogram_cuda, smi, D_OPTIONS, "train d options")
    counts_d_bf16 = timed("D1b", phase_train, histogram_cuda, smi, D_OPTIONS_BF16,
                          "train d options bf16")
    counts_d_re = timed("D1r", phase_rehisto_d_options, histogram_cuda, smi)
    counts_recolor = timed("R1", phase_recolor, histogram_cuda, dev, smi)
    counts_recolor_bf16 = timed("R1b", phase_recolor_bf16, histogram_cuda, smi)
    timed("R4", phase_fullres, smi)
    pools = timed("H1", phase_pool_clis, histogram_cuda, smi)
    counts_re = timed("R2", phase_rehisto_train, histogram_cuda, smi)
    counts_re_bf16 = timed("R2b", phase_rehisto_train, histogram_cuda, smi, REHISTO_BF16)
    counts_projection = timed("P3", phase_projection_clis, histogram_cuda, smi)
    counts_remat = timed("RM", phase_remat, histogram_cuda)
    ranks = timed("ranks", phase_ranks)
    counts_dp, dp = timed("DP", phase_data_parallel, histogram_cuda, smi, ranks["dp"])
    counts_dp.update(timed("FS", phase_fsdp, histogram_cuda, smi, dp, ranks["fs"]))
    del dp
    counts_dp.update(timed("FS512", phase_fsdp512, smi, ranks["fs512"]))
    timed("DS", phase_sharded_source, smi, ranks["ds"])
    del ranks
    timed("DB", phase_debug, smi)
    counts_profiler = timed("PF", phase_profiler, histogram_cuda, smi)
    timed("P1", phase_projection_card_vs_cpu, smi)
    timed("9", phase_card_vs_cpu)
    timed("D1c", card_vs_cpu_step, True, True, True, D_OPTIONS_CMP)
    timed("9b", phase_bf16_step)
    timed("R3", phase_rehisto_card_vs_cpu)
    timed("R3b", phase_rehisto_bf16_step)
    check(counts_recolor["histogram_fwd"] >= 1 and counts_re["histogram_fwd"] >= 1
          and counts_re["histogram_bwd"] >= 1 and counts_recolor_bf16["histogram_fwd"] >= 1
          and counts_re_bf16["histogram_fwd"] >= 1 and counts_re_bf16["histogram_bwd"] >= 1
          and all(c[k] >= 1 for c in (counts_d, counts_d_bf16, counts_d_re,
                                      *counts_loaders.values(), *counts_dp.values())
                  for k in ("histogram_fwd", "histogram_bwd")),
          f"K1 on the recolor paths ({counts_recolor}, bf16 {counts_recolor_bf16}), K1 and K2 "
          f"on the recoloring training paths ({counts_re}, bf16 {counts_re_bf16}), on the "
          f"paths with the D options ({counts_d}, bf16 {counts_d_bf16}, reHistoGAN "
          f"{counts_d_re}), on DD1's loader paths ({counts_loaders}) and on every rank of the "
          f"data-parallel and FSDP paths ({counts_dp})")
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"seconds: total {time.perf_counter() - t_start:.2f}")

    def main_row(rows):  # the training path's shape
        row = next(r for r in rows if (r["B"], r["N"]) == MAIN_SHAPE)
        return {k: row[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}

    print(json.dumps({"kernels": [
        {"name": "histogram_fwd", "route": "cuda",
         "source": "histogan_tpu_torch/csrc/histogram_fwd.cu",
         "replaces": "histogan_tpu/ops/histogram_pallas.py:39",
         "launches": counts["histogram_fwd"],
         "launches_by_path": {"sampling": sampling_launches, "training": counts["histogram_fwd"],
                              "training_bf16": counts_bf16["histogram_fwd"],
                              "recolor": counts_recolor["histogram_fwd"],
                              "rehisto_training": counts_re["histogram_fwd"],
                              "recolor_bf16": counts_recolor_bf16["histogram_fwd"],
                              "rehisto_training_bf16": counts_re_bf16["histogram_fwd"],
                              "training_d_options": counts_d["histogram_fwd"],
                              "training_d_options_bf16": counts_d_bf16["histogram_fwd"],
                              "rehisto_training_d_options": counts_d_re["histogram_fwd"],
                              **{k: c["histogram_fwd"] for k, c in counts_loaders.items()},
                              "create_hist_data": pools["create_hist_data"]["histogram_fwd"],
                              "create_hist_sample": pools["create_hist_sample"]["histogram_fwd"],
                              **counts_projection,
                              "training_remat": counts_remat["histogram_fwd"],
                              **{f"training_{k}": c["histogram_fwd"]
                                 for k, c in counts_dp.items()},
                              "training_profiled": counts_profiler["histogram_fwd"]},
         "max_abs_err": fwd_err, **main_row(fwd_rows), "hmma": hmma["histogram_fwd"],
         "shapes": fwd_rows},
        {"name": "histogram_bwd", "route": "cuda",
         "source": "histogan_tpu_torch/csrc/histogram_bwd.cu",
         "replaces": "histogan_tpu/ops/histogram_pallas.py:64",
         "launches": counts["histogram_bwd"],
         "launches_by_path": {"training": counts["histogram_bwd"],
                              "training_bf16": counts_bf16["histogram_bwd"],
                              "recolor": counts_recolor["histogram_bwd"],
                              "rehisto_training": counts_re["histogram_bwd"],
                              "recolor_bf16": counts_recolor_bf16["histogram_bwd"],
                              "rehisto_training_bf16": counts_re_bf16["histogram_bwd"],
                              "training_d_options": counts_d["histogram_bwd"],
                              "training_d_options_bf16": counts_d_bf16["histogram_bwd"],
                              "rehisto_training_d_options": counts_d_re["histogram_bwd"],
                              **{k: c["histogram_bwd"] for k, c in counts_loaders.items()},
                              "create_hist_data": pools["create_hist_data"]["histogram_bwd"],
                              "create_hist_sample": pools["create_hist_sample"]["histogram_bwd"],
                              "training_remat": counts_remat["histogram_bwd"],
                              **{f"training_{k}": c["histogram_bwd"]
                                 for k, c in counts_dp.items()},
                              "training_profiled": counts_profiler["histogram_bwd"]},
         "max_abs_err": bwd_err, **main_row(bwd_rows), "hmma": hmma["histogram_bwd"],
         "shapes": bwd_rows},
        *({"name": f"upsample2x_{kind}", "route": "cuda",
           "source": "histogan_tpu_torch/csrc/upsample2x.cu", "replaces": None,
           "launches_by_path": {**({"sampling": sampling_u1} if kind == "fwd" else {}),
                                "training": counts[f"upsample2x_{kind}"],
                                "training_bf16": counts_bf16[f"upsample2x_{kind}"]},
           "shapes": [{k: r[k] for k in ("B", "C", "H")} | r[kind] for r in upsample_rows]}
          for kind in ("fwd", "bwd")),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
