#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vmg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card name and power limit; build the CUDA kernels from
     vmg_tpu_torch/csrc (one nvcc per source, in parallel) and time it;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the paths that run it, in float32 (TF32 off) and bf16,
     each timed (CUDA events) next to its plain version and its bound
     (the MorphFC axis-branch kernel also next to the 'hybrid' form it
     replaces at stages 0/6, the conv chain next to the module form's
     cuDNN convolutions, the norm and the pin next to one PyTorch call);
     the LTAM backward at the training shape, and in bf16 the LTAM forward
     and backward at phase 8's batch (4x64x64 at K = 1..5, dpe against
     its terms over the batch); in float32 also at the
     evaluator's 1x16x128x128 tile shapes (EVAL_TILE_SHAPES: the axes
     kernel at stage 0/6, the reduce at stages 1/5, 2/4, 3, the combine at
     all four, the LTAM forward at 1x128x128 at K = 1..5; the FFN at all
     four in both dtypes); the conv chain at both
     path shapes run twice and held bit-equal (outputs and sums), with
     its TFLOP/s, share of the bound and ratio to the module form beside
     its times before the redesign (PERF.md); the FFN likewise at the four
     FULL_PRESET stage shapes and the few-levels shape (16x128x128x144,
     groups 1), next to its module form (cuDNN grouped conv, GELU,
     F.linear), in float32 (3xTF32 on the tensor cores) next to its module
     form with TF32 off and with cuDNN's default TF32, its 3xTF32 and f32
     bounds and the scalar kernel's time before the redesign; the axes
     kernel's float32 big form likewise (two runs bit-equal, the 'hybrid'
     form, its time before the redesign); the combine with each gate (tanh, sigmoid, relu), in bf16
     at the four FULL_PRESET stage shapes and the few-levels shape, in
     float32 (3xTF32) at stages 0 and 3 and the eval tile's four (tanh run
     twice and held bit-equal, its share of the bound beside its time
     before the redesign, the scalar kernel's in float32); the conv chain
     in float32 (3xTF32) also next to its module form with cuDNN's default
     TF32, with its f32 bound and the scalar kernel's time; the LTAM forward at the stage-0 shape at each
     slot count K = 1..5 with the sum over a clip's 60 launches, then
     forward (1x128x128) and backward (1x64x64) at head widths 36, 64 and
     144; the pin with its GB/s and
     share of the bound; the axis branches' token
     form, first driven through its op entry point (``form="token"``) at
     the stage-1/5 (16x92x160x224, chunk 16) and stage-3 (16x23x40x448,
     chunk 8) shapes, then checked there next to the 'hybrid' form those
     stages run (two runs bit-equal), and against the big form at the
     stage-0 shape;
     the reduce at every shape it runs (FULL_PRESET's stages 1/5, 2/4, 3
     and the few-levels 32x128x128 and 32x64x64 at C = 144) and at stages
     0/6, two runs bit-equal, with its sum over each preset's clip (14 and
     12 launches);
 2p. the probes: every probe of ``vmg_tpu_torch.tools.exp_probe`` and
     ``exp_probe2`` called directly (copies bit-exact, products within 1
     bf16 ulp of max|plain|, the tiles' copies on every SM bit-equal),
     each with its time, bound and one PyTorch call (the assembled tiles
     also beside ``torch.matmul`` of their patch), the three probe kernels
     beside an empty launch's time (the launch floor; every relayout probe
     as its ratio to it) and their times before the redesign; then both
     tools' command lines in-process (exit 0, one JSON line per probe);
  3. slice parity: FULL_PRESET in float32 at 1x2x64x64, kernel path on the
     card against the plain path (CPU tensors) with the same weights;
 3b. the same with the opt-in kernel forms: the RCAB and trajectory conv
     chains against phase 3's plain output, the barrier forms against the
     default forms on the card;
 3c. slice parity of FEW_LEVELS_PRESET (C = 144, LTAM head width 36, FFN
     groups 1), as phase 3;
  4. serving (main path 1): an SRServer on FULL_PRESET in bf16 (tanh GELU,
     bf16 SPyNet convs), seeded random init, 1x16x180x320 clips: one
     warm-up request, then 3 clips x 3 reps, each request timed; the
     output must be finite and (1,16,720,1280,3), every serving kernel's
     launch count over the run must be > 0, the FFN's one a TAB (22 a
     clip), and the opt-in forms' kernels must not launch;
 4b. serving in the kernel forms (main path 3): the same server, weights
     and clips with rcab_impl, traj_conv_impl and norm_impl "kernel": one
     warm-up request, then 3 clips; 968 conv-chain and 50 norm launches
     per clip; its bf16 error at 1x2x64x64 against phase 3's f32 plain
     output at most twice the default form's; then one request in each
     barrier form, which pins 64 times per clip;
 4c. serving the few-levels model (main path 4): FEW_LEVELS_PRESET with
     the eval preset's 32 frames and trajectory window, bf16, 1x32x128x128
     clips: one warm-up request, then 2 clips; finite output of the right
     shape, the LTAM, FFN (12 a clip), reduce and combine kernels launched;
     peak memory;
  5. train-step parity: one float32 FULL_PRESET training step (loss and
     gradients, drop_path 0, remat on) at 1x5x64x64, kernels on the card
     against the plain path on CPU tensors from the same weights;
  6. training (main path 2): the function of ``python -m
     vmg_tpu_torch.train`` on FULL_PRESET -- bf16 compute on float32
     masters, remat on, B=1, T=16, 64x64 crops, seeded data: one warm-up
     step, then timed steps; the losses must be finite and both LTAM
     kernels must have launched;
 6b. the same trainer with norm_impl="kernel": a warm-up step and 2 timed
     steps; finite losses, norm launches, the warm-up loss within 1e-2 of
     phase 6's;
 6c. the trainer on FEW_LEVELS_PRESET (main path 5), B=1, T=6, 64x64
     crops: a warm-up and a timed step; finite losses, the LTAM backward
     launched (head width 36);
 7a. the reference checkpoint (tests/fixtures/ref_tiny_mine.pth) through
     the port's converter: its float32 forward with the kernels on the card
     against the plain path on CPU tensors (phase 3's tolerance);
 7b. evaluation (main path 6): the function of ``python -m
     vmg_tpu_torch.eval`` with the Vid4 preset (FULL_PRESET, float32, erf
     GELU, seeded random weights) on a synthetic Vid4 tree the phase writes
     with the port's PNG writer -- one clip of 16 144x176 LR / 576x704 GT
     frames, 4 tiles of 1x16x128x128 -- host-tiled, then with the tile loop
     on the card: 16 PNGs of 576x704 read back, finite PSNR / SSIM, the two
     tilings within phase 3's tolerance, the LTAM, FFN, axes, reduce and
     combine kernels launched; FPS and seconds printed; then one
     1x16x128x128 tile through the evaluator's forward, kernels on the card
     against the plain path on CPU tensors (phase 3's tolerance, TF32 off);
 7c. the same protocol over SRServer (bf16, fast-math) on that clip: its
     error against 7b's float32 output at most KFORM_RATIO x phase 4's
     bf16 error at 1x2x64x64, its FPS;
  8. training from data (main path 7): a seeded synthetic packed REDS tree
     (2 clips x 100 frames of 720x1280 HR, LR by ``imresize_matlab`` on the
     card, ~560 MiB, under the checkout's ignored results/, removed after);
     the first loader batch from the native assembler bit-equal to the numpy
     path's; the loader alone (batches/s): 8 one-batch epochs at the
     preset's expand ratio, each a restart of its workers, then steady
     batches over a longer epoch; then the function of ``python -m
     vmg_tpu_torch.tools.train --config reds_full`` (FULL_PRESET, batch 4,
     T = 16, 256x256 HR crops, bf16 on f32 masters, remat) for 4 steps
     with a checkpoint at step 4 and no retries (one batch an epoch: the
     run crosses set_epoch), then ``--resume`` for 4 more: finite losses,
     each step's LTAM forward and backward launches equal to phase 6's per
     step (times grad_acc), assemble_batch called, the resumed run starting
     at step 4; step ms (median over each run's steps after its first),
     data-wait ms a batch, frames/s, peak memory.  An out-of-memory error
     fails the phase, naming the batch.
 8b. ``tools.train --multihost``'s function in a one-process NCCL group on
     phase 8's config and tree: its losses against phase 8's;
  9. export: FULL_PRESET bf16 at 1x16x180x320 through
     ``ckpt.export.export_program`` in the default forms at full depth and
     in the kernel forms at depth 1 a stage (EXPORT_KERNEL_DEPTH), saved,
     loaded and run against the eager forward;
 10. the other tails at full width (VARIANT: FULL_PRESET with trajectory
     tails at stages 0/6, the flow-guided DCN at 1/5, the 3D window
     attention at 2/4 and 3, linear bias-free axis FCs): f32 parity at
     1x2x64x64 against the plain path on CPU tensors (phase 3's tolerance),
     SRServer bf16 at 1x16x180x320 in the default and kernel forms (frames/s,
     peak memory, the LTAM, FFN, axes, reduce and combine kernels
     launched), one bf16 training step at phase 6's size; phase 2 holds the
     four axes instantiations in these forms (AXES_OPTIONS) to their plain
     versions;
 11. T-sharded serving (``parallel/seq.py``): FULL_PRESET bf16 (tanh GELU,
     fast flow), default forms, in two processes on the one card (a gloo
     group: NCCL refuses two ranks on one device, so the halos, carries,
     flows and sums cross through host memory while the compute stays on
     the card), built once here and loaded by both: 1x32x180x320 (16 frames
     a process, the trajectory windows aligned) and 1x16x180x320 (8, the
     window split, its carry handed over), each against the one-process
     forward of the clip (SEQ_TOLS: the split window bit for bit), with
     frames/s (both sides the model's forward on an input on the card, the
     output left there), each process's peak memory beside the one-process
     peak, the kernel launches a process (the LTAM, FFN, axes, reduce and
     combine kernels in both) and the bytes each exchange sent; then
     float32 at 1x8x64x64 (one trajectory window over both processes)
     against the plain path on CPU tensors (phase 3's tolerance); then the
     time means as modules (SEQ_MEANS) against one process's;
 12. tensor parallelism (``parallel/tp.py``): a (1, 2) mesh of two processes
     on the card at phase 6's size (lr 1e-4), 2 steps against one process's:
     the losses of both steps and the parameters after the first within
     tests/test_parallel_mesh.py:77-84's bounds (after the second reported),
     the first step's gradient leaf by leaf and its global norm
     (TP_GRAD_RTOL, TP_GRAD_ATOL, TP_GRAD_SPREAD: one process run twice
     gives the spread), the count of sharded leaves, each
     process's bytes of masters and AdamW moments beside one process's.
``python3 chip_smoke.py --nccl N`` runs phases 1, 11 and 12 alone with
their processes one a card on N cards in an NCCL group (phase 12 on a
(N / 2, 2) mesh, a batch of N / 2 clips).
Prints a {"train_loop": {...}} JSON line, a {"kernels": [...]} JSON line (each kernel with its launches on
the path that runs it -- the token form's and the probes' on their entry
points in phases 2/2p, none on the model paths -- its times, its bound and
the library call, if any), the nvidia-smi line, and last {"ok": true,
"device": {...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

T, H, W = 16, 180, 320  # bench protocol: REDS4 clip of 16 180x320 frames
# Outputs in the inputs' dtype, relative to the largest plain output.  f32:
# the kernels and plain versions sum in other orders (<= ~1700 terms);
# bf16: both round at the same places, so differences are a few output ulps.
REL_TOL = {torch.float32: 5e-5, torch.bfloat16: 1e-2}
# Outputs that are f32 whatever the inputs (LTAM attention) take the f32
# tolerance in both dtypes; f32 sums over a frame (the reweight sums) are
# held per element to SUM_TOL of the sum of their terms' magnitudes -- a
# sum missing one pixel of a 184x320 frame is off by ~1.7e-5 of it.
SUM_TOL = 1e-6
SLICE_TOL = 1e-3  # f32 full model, cuDNN and kernels vs CPU, output in ~[0, 1]
# The barrier forms run the default forms' arithmetic plus identity copies:
# the same outputs up to cuDNN's run-to-run choices, held at 1e-6 of max|out|.
BARRIER_TOL = 1e-6
# bf16 kernel-form serving: its error against the f32 plain output at most
# KFORM_RATIO x the default bf16 form's; its warm-up training loss within
# TRAIN_LOSS_TOL (relative) of the default form's.
KFORM_RATIO, TRAIN_LOSS_TOL = 2.0, 1e-2
# (width, rows of its first call) of every LayerNorm on the serving path of
# a 1x16x180x320 clip (padded to 184x320): the TABs of stages 0 and 1, the
# down resamplers 0 and 1 (4C), the up resampler 1 (C/4)
NORM_SHAPES = [(112, 16 * 184 * 320), (448, 16 * 92 * 160), (224, 16 * 92 * 160),
               (896, 16 * 46 * 80), (56, 16 * 92 * 160)]
CHAIN_PER_CLIP, NORM_PER_CLIP, PIN_PER_CLIP = 968, 50, 64
# FFN kernel launches a clip, one a TAB at every width: FULL_PRESET's 22,
# the few-levels preset's 12
FFN_PER_CLIP, FEW_FFN_PER_CLIP = 22, 12
# the few-levels serving run: the eval preset's network fields
# (vmg_tpu/configs/presets/vmg_eval_reds4_few_levels.yml: 32 frames, one
# trajectory window over them, no flow freeze) on FEW_LEVELS_PRESET, its
# 128x128 LR tile ('wins'); training at the train preset's 6 frames
FEW_EVAL = dict(num_frames=32, traj_win=(32, None), flow_fix=None)
FEW_T, FEW_HW, FEW_TRAIN_T = 32, 128, 6
# the kernels the few-levels serving path must launch ('hybrid' mixers at
# C = 144: the reduce, then the combine)
FEW_PATH = ("ltam_attention_2x2", "fused_group_ffn", "fused_morphfc_reduce",
            "fused_morphfc_combine")
# the bf16 chain's and the pin's times before their redesign, printed
# beside this run's: PERF.md's, from vmg_tpu_torch/tools/time_chain_pin.py
# with the timer this script uses (H100 80GB HBM3, 700 W); (frames, dtype)
# -> ms
CHAIN_BEFORE_MS = {(1, torch.bfloat16): 0.463, (16, torch.bfloat16): 6.552}
PIN_BEFORE_MS = 0.0187
# the FFN's path shapes: ((N, H, W, C), groups, hidden ratio) of FULL_PRESET's
# stages 0/6, 1/5, 2/4 and 3 (16 frames of a 180x320 clip padded to 184x320)
# and of the few-levels preset (a 128x128 tile, groups 1, mlp_ratio 2)
# the evaluator's 128x128 LR tiles of 16 frames (N, H, W, C) at FULL_PRESET's
# stages 0/6, 1/5, 2/4 and 3: the FFN's shapes there in both dtypes, the
# axes kernel's (stage 0/6, chunk 8), the reduce's (stages 1/5, 2/4, 3), the
# combine's and the LTAM forward's (1x128x128, d = 28) in float32, the eval
# command line's dtype
EVAL_TILE_SHAPES = [(16, 128, 128, 112), (16, 64, 64, 224), (16, 32, 32, 224),
                    (16, 16, 16, 448)]
FFN_SHAPES = [((16, 184, 320, 112), 4, 6), ((16, 92, 160, 224), 4, 6),
              ((16, 46, 80, 224), 4, 6), ((16, 23, 40, 448), 4, 6),
              ((16, 128, 128, 144), 1, 2)] + [(s, 4, 6) for s in EVAL_TILE_SHAPES]
# the bf16 FFN's times before its redesign (the wmma kernel it replaced), printed
# beside this run's: PERF.md's, medians of vmg_tpu_torch/tools/
# time_chain_pin.py --other (that tree and this one in one call, one
# timer; H100 80GB HBM3, 700 W); shape -> ms
FFN_BEFORE_MS = {(16, 184, 320, 112): 11.129, (16, 92, 160, 224): 10.560,
                 (16, 46, 80, 224): 2.886, (16, 23, 40, 448): 3.503,
                 (16, 128, 128, 144): 4.535}
# the FFN before its narrow-image redesign (one-row tiles above C = 224, no
# packing; commit 8f75654): PERF.md's step 0 of that redesign
# (time_chain_pin.py --side on that tree, the timer this script uses; H100
# 80GB HBM3, 700 W); shape -> ms
FFN_ROW_TILES_MS = {(16, 184, 320, 112): 2.1780, (16, 92, 160, 224): 1.9400,
               (16, 46, 80, 224): 0.7083, (16, 23, 40, 448): 1.2056,
               (16, 128, 128, 112): 0.6359, (16, 64, 64, 224): 0.4752,
               (16, 32, 32, 224): 0.2425, (16, 16, 16, 448): 0.7988}
# the f32 FFN's and axes kernel's times before their 3xTF32 redesign (the
# scalar kernels they replaced), printed beside this run's: PERF.md's (the
# previous tree's chip_smoke.py phase 2, tanh, TF32 off; H100 80GB HBM3, 700
# W); shape -> ms
FFN_F32_BEFORE_MS = {(16, 128, 128, 112): 10.739, (16, 64, 64, 224): 15.831,
                     (16, 32, 32, 224): 5.048, (16, 16, 16, 448): 14.799,
                     (16, 184, 320, 112): 37.667, (16, 92, 160, 224): 52.800,
                     (16, 46, 80, 224): 13.752, (16, 23, 40, 448): 41.277,
                     (16, 128, 128, 144): 23.631}
AXES_F32_BEFORE_MS = {(16, 128, 128, 112): 1.974, (16, 184, 320, 112): 6.862}
# the f32 token form's times before its 3xTF32 redesign (the scalar kernel
# it replaced), printed beside this run's: PERF.md row 4bf (the previous
# tree's chip_smoke.py phase 2, TF32 off; H100 80GB HBM3, 700 W); shape -> ms
TOKEN_F32_BEFORE_MS = {(16, 92, 160, 224): 9.162, (16, 23, 40, 448): 3.138}
# the combine's path shapes (N, H, W, C): FULL_PRESET's stages 0/6, 1/5, 2/4
# and 3, and the few-levels preset's (a 128x128 tile, C = 144)
COMBINE_SHAPES = [(16, 184, 320, 112), (16, 92, 160, 224), (16, 46, 80, 224),
                  (16, 23, 40, 448), (16, 128, 128, 144)]
# the bf16 combine's and LTAM forward's times before their redesign, printed
# beside this run's: PERF.md's, medians of vmg_tpu_torch/tools/
# time_chain_pin.py --other (that tree and this one in one call, one timer;
# H100 80GB HBM3, 700 W); shape -> ms
COMBINE_BEFORE_MS = {(16, 184, 320, 112): 1.1593, (16, 92, 160, 224): 0.8297,
                     (16, 46, 80, 224): 0.2186, (16, 23, 40, 448): 0.3164,
                     (16, 128, 128, 144): 0.4507}
# the f32 combine's (tanh) and conv chain's times before their 3xTF32
# redesign (the scalar kernels they replaced), printed beside this run's:
# PERF.md rows 6f and 8f (the previous tree's chip_smoke.py phase 2, TF32
# off; H100 80GB HBM3, 700 W); shape -> ms, (frames, dtype) -> ms
COMBINE_F32_BEFORE_MS = {(16, 128, 128, 112): 0.638, (16, 64, 64, 224): 1.112,
                         (16, 32, 32, 224): 0.278, (16, 16, 16, 448): 0.828,
                         (16, 184, 320, 112): 2.134}
CHAIN_BEFORE_MS.update({(1, torch.float32): 5.301, (16, torch.float32): 82.072})
LTAM_BEFORE_MS = 0.2964  # 1x184x320x112, K = 5
# the LTAM backward's (1x64x64x112, K = 5) and the bf16 axes kernel's
# (16x184x320x112, chunk 8) times before their redesign: PERF.md's kernel
# table (chip_smoke.py phase 2 of the tree before; H100 80GB HBM3, 700 W)
LTAM_BWD_BEFORE_MS = 0.2213
AXES_BEFORE_MS = 1.3472
# LTAM launches of a FULL_PRESET clip at each slot count K = 1..5: 3 steps
# x 2 directions x 2 trajectory stages
LTAM_STEPS_PER_K = 12
# LTAM head widths d = C / heads beyond the full preset's 28: (C, heads, K) --
# the few-levels preset's 36, 64, and one head of 144 -- at the few-levels
# serving shape (1x128x128) and training crop (1x64x64), ragged slot counts
LTAM_WIDTHS = [(144, 4, 3), (128, 2, 4), (144, 1, 5)]
# the axes kernels' run-time options checked in phase 2 ((non_linear, bias):
# linear with biases, relu without, linear without -- phase 10's form) and
# the path shape each instantiation runs them at: the big form at stage 0/6
# (bf16 serving) and the eval tile's stage 0/6 (f32), the token form at
# stage 3 (bf16: its compile-time shape) and stage 1/5 (f32)
AXES_OPTIONS = [(False, True), (True, False), (False, False)]
AXES_OPTION_SHAPES = {
    torch.bfloat16: [((16, 184, 320, 112), 8, "big"), ((16, 23, 40, 448), 8, "token")],
    torch.float32: [((16, 128, 128, 112), 8, "big"), ((16, 92, 160, 224), 16, "token")]}
# the axis branches' token form: (N, H, W, C) and chunk of stages 1/5 and 3
TOKEN_SHAPES = [((16, 92, 160, 224), 16), ((16, 23, 40, 448), 8)]
# the reduce's shapes (N, H, W, C) and launches per clip: FULL_PRESET's
# stages 1/5, 2/4 and 3 ('hybrid' mixers), the few-levels preset's two
# resolutions of a 32-frame clip (C = 144), and stages 0/6 (the 'full' form
# runs there: the kernel table's continuity row)
REDUCE_SHAPES = [((16, 92, 160, 224), 8), ((16, 46, 80, 224), 4), ((16, 23, 40, 448), 2),
                 ((32, 128, 128, 144), 8), ((32, 64, 64, 144), 4), ((16, 184, 320, 112), 0)]
REDUCE_FEW = ((32, 128, 128, 144), (32, 64, 64, 144))
# the reduce's and the token form's times before their redesign, printed
# beside this run's: PERF.md's step 0 (vmg_tpu_torch/tools/time_chain_pin.py
# on the tree before, the timer this script uses; H100 80GB HBM3, 700 W)
REDUCE_BEFORE_MS = {(16, 92, 160, 224): 0.2156, (16, 46, 80, 224): 0.0638,
                    (16, 23, 40, 448): 0.0841, (32, 128, 128, 144): 0.3060,
                    (32, 64, 64, 144): 0.0806, (16, 184, 320, 112): 0.4759}
TOKEN_BEFORE_MS = {(16, 92, 160, 224): 1.2431, (16, 23, 40, 448): 0.3689}
# the probe kernels before their redesign, at their primary probes (PERF.md,
# the step 0 of each redesign: time_chain_pin on the previous tree; same
# timer; the relayout at lane_store_cg28)
PROBE_BEFORE_MS = {"slab_copy": 0.0036, "tile_gemm": 0.0464, "smem_relayout": 0.0043}
# Train-step parity, f32: the loss within LOSS_TOL relative; each
# parameter's gradient within GRAD_LIMIT of max(its max|plain|, GRAD_FLOOR x
# the largest max|plain| of any parameter).  GRAD_TOL of its own max is
# reported, not held: the plain path misses it against itself -- two CPU
# thread counts (summation orders) differ by up to ~2e-2 of their own max
# on gradients ~1e-8 of the largest, and by ~4e-3 on gradients 1e-3 of it
# (see PERF.md); the phase measures that spread too.
LOSS_TOL, GRAD_TOL, GRAD_LIMIT, GRAD_FLOOR = 1e-5, 1e-3, 1e-2, 1e-3

def bound(inputs, outputs, flops, peak):
    """{bound_ms, bound_by, ...} for a call that reads ``inputs`` once,
    writes ``outputs`` once and does ``flops`` operations at ``peak``: the
    least time the card could take (NVIDIA H100 SXM data sheet rates)."""
    from vmg_tpu_torch.utils.profiling import bound as least_time

    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    return {**least_time(nbytes, flops, peak), "bound_bytes": nbytes, "bound_flops": flops,
            "bound_peak": peak}


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip()


def cuda_ms(fn, iters=10) -> float:
    """Device ms per call of ``fn`` after one warm-up call (CUDA events)."""
    from vmg_tpu_torch.utils.profiling import timed

    return timed(fn, iters=iters, warmup=1) * 1e3


def within_max(got, want, rel, label=""):
    """Check against rel * max|want|: (label, max_abs_err, ok, text)."""
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    return (label, err, err <= rel * ref,
            f"max_rel_err={err / max(ref, 1e-30):.3e} (tol {rel:g} of max|plain|)")


def within_sum(got, want, terms, label=""):
    """Check f32 sums per element against SUM_TOL * ``terms``, the sum of
    the summed terms' magnitudes: (label, max_abs_err, ok, text)."""
    diff = (got - want).abs()
    rel = (diff / terms).max().item()
    return (label, diff.max().item(), rel <= SUM_TOL,
            f"max_rel_err={rel:.3e} (tol {SUM_TOL:g} of sum|terms|)")


def ltam_dpe_terms(q, kv, pe, g, K, heads):
    """Per entry of the LTAM backward's dpe (K, 4, 4, heads), the sum of its
    terms' magnitudes: over the pixels at that query position,
    exp(logit) (|g.v| + |g.out|) / den, plain PyTorch."""
    from vmg_tpu_torch.ops.ltam_attention import _tap, ltam_attention_plain

    N, H, W, C = q.shape
    d = C // heads
    kv6 = kv.reshape(N, H, W, K, 2, C)
    qh, gh = q.reshape(N, H, W, heads, d), g.reshape(N, H, W, heads, d)
    out = ltam_attention_plain(q, kv, pe, K=K, heads=heads).reshape(N, H, W, heads, d)
    s = (gh * out).sum(-1).abs()
    pos = (2 * (torch.arange(H, device=q.device) % 2)[:, None]
           + (torch.arange(W, device=q.device) % 2)[None, :])
    den, mags = 0.0, {}
    for k in range(K):
        for t in range(4):
            val = _tap(kv6[:, :, :, k, 0], *divmod(t, 2)).float().reshape(N, H, W, heads, d)
            key = _tap(kv6[:, :, :, k, 1], *divmod(t, 2)).float().reshape(N, H, W, heads, d)
            ex = torch.exp((qh * key).sum(-1))
            den = den + ex * pe[k, t][pos]
            mags[k, t] = ex * ((gh * val).sum(-1).abs() + s)
    terms = torch.empty_like(pe)
    for (k, t), m in mags.items():
        m = m / den.clamp_min(1e-30)
        for p in range(4):
            terms[k, t, p] = m[:, pos == p].sum(dim=(0, 1))
    return terms


def ffn_f64_sums(x, w1, b1, w2, b2, groups, act):
    """The FFN's per-(frame, channel) output sums (N, C) in float64 from the
    unpacked weights, and the sum of their terms' magnitudes: H W |b2| +
    sum over hidden features f of (sum over pixels of |gelu(conv)_f|) |w2_f|."""
    import torch.nn.functional as F

    from vmg_tpu_torch.ops.group_conv import gelu

    N, H, W, C = x.shape
    y = F.conv2d(x.double().permute(0, 3, 1, 2), w1.double(), b1.double(), padding=1,
                 groups=groups)
    y = gelu(y, act).flatten(2)  # (N, F, H W)
    w2d = w2.double()
    sums = y.sum(-1) @ w2d.t() + H * W * b2.double()
    terms = y.abs().sum(-1) @ w2d.abs().t() + H * W * b2.double().abs()
    return sums, terms


def sum_errors(got_sums, sums, terms):
    """A kernel's per-(frame, channel) sums (N, C) against the float64
    ``sums``: (max |error| / terms, mean signed error / terms, mean error
    toward zero / terms -- positive where the kernel's sums are smaller in
    magnitude than the exact ones)."""
    err = got_sums.double() - sums
    rel = err / terms
    return (rel.abs().max().item(), rel.mean().item(),
            (-torch.sign(sums) * err / terms).mean().item())


def axes_f64_sums(x, c, kh, bh, kw, bw, ck):
    """The axes op's per-(frame, channel) sums of h + w + c (N, C) in
    float64 (the plain function's arithmetic, relu and biases), and the sum
    of their terms' magnitudes."""
    from vmg_tpu_torch.ops.morphfc_fused import axis_tokens, axis_untokens

    C = x.shape[-1]
    cd = c.double()
    sums, terms = cd.sum(dim=(1, 2)), cd.abs().sum(dim=(1, 2))
    for k, b, axis in ((kh, bh, 1), (kw, bw, 2)):
        y = torch.relu(axis_tokens(x.double(), ck, axis) @ k.double() + b.double()) / C
        y = axis_untokens(y, x.shape, ck, axis)
        sums, terms = sums + y.sum(dim=(1, 2)), terms + y.abs().sum(dim=(1, 2))
        del y
    return sums, terms


# the FFN's output-sum check (phase 2): the f32 kernel at the eval tile's
# four shapes and at stage 0 of a served clip, the bf16 kernel (a record, not
# held) at FULL_PRESET's four serving shapes; groups 4, hidden 6C
FFN_SUM_SHAPES = {torch.float32: EVAL_TILE_SHAPES + [(16, 184, 320, 112)],
                  torch.bfloat16: [s for s, _, _ in FFN_SHAPES[:4]]}


def ffn_sums_check(report):
    """Phase 2's FFN sums: each kernel output's per-(frame, channel) sums
    against a float64 version, erf and tanh; f32 held to SUM_TOL of the sum
    of |terms|.  Returns {dtype shape act: (max, mean signed, toward zero)}."""
    from vmg_tpu_torch.ops import group_conv

    gen = torch.Generator(device="cuda").manual_seed(3)
    dev, G, out = torch.device("cuda"), 4, {}
    for dtype, shapes in FFN_SUM_SHAPES.items():
        for shape in shapes:
            N, h, w, C = shape
            Fh = 6 * C

            def rn(*s, scale=1.0):
                return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

            x = rn(N, h, w, C)
            w1 = rn(Fh, C // G, 3, 3, scale=(9 * C / G) ** -0.5)
            b1, b2, w2 = rn(Fh, scale=0.1), rn(C, scale=0.1), rn(C, Fh, scale=0.02)
            packed = group_conv.pack_ffn_weights(w1, b1, w2, G)
            for act in ("erf", "tanh"):
                got = group_conv.fused_group_ffn(x, *packed, b2, groups=G, act=act)
                sums, terms = ffn_f64_sums(x, w1, b1, w2, b2, G, act)
                worst, signed, toward = sum_errors(got.double().sum(dim=(1, 2)), sums, terms)
                held = dtype == torch.float32
                ok = worst <= SUM_TOL or not held
                report(f"  fused_group_ffn sums {str(dtype):15s} {str(shape):22s} {act:4s}: "
                       f"max {worst:.3e}, mean signed {signed:+.3e}, toward zero "
                       f"{toward:+.3e} of sum|terms| "
                       f"({f'tol {SUM_TOL:g}' if held else 'record only'}) "
                       f"{'ok' if ok else 'FAIL'}")
                out[f"{dtype} {shape} {act}"] = (worst, signed, toward)
                if not ok:
                    raise AssertionError(f"the f32 FFN's output sums drift at {shape} {act}")
                del got, sums, terms
            del x, w1, packed
    torch.cuda.empty_cache()
    return out


def spynet_ms(model, T_, H_, W_, reps=5) -> float:
    """Device ms of the model's flow pyramid (``_compute_flows``, SPyNet and
    its pooling) on a seeded 1 x T x H x W clip already padded to the
    model's multiple: median of ``reps`` after a warm-up (CUDA events)."""
    s = model.cfg.scale_factor
    Hp, Wp = -(-H_ // s) * s, -(-W_ // s) * s
    xp = torch.rand((1, T_, Hp, Wp, 3), generator=torch.Generator().manual_seed(4)).cuda()
    times = []
    with torch.inference_mode():
        model._compute_flows(xp, False)
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model._compute_flows(xp, False)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    return float(np.median(times))


# phase 9: the eager kernel counter of each vmg:: operator node an exported
# program holds (the axes node counts both forms' launches)
EXPORT_NODES = {"group_ffn": ("fused_group_ffn",),
                "morphfc_axes": ("fused_morphfc_axes", "fused_morphfc_axes_token"),
                "morphfc_reduce": ("fused_morphfc_reduce",),
                "morphfc_combine": ("fused_morphfc_combine",),
                "ltam_fwd": ("ltam_attention_2x2",), "conv_chain": ("fused_conv_chain",),
                "fused_norm": ("fused_norm",), "layout_pin": ("layout_pin",)}


def export_phase(report, sd, smi, kind):
    """Phase 9: FULL_PRESET bf16 served at 1x16x180x320, exported
    (``ckpt.export.export_program``) in the default forms at full depth and
    in the kernel forms at EXPORT_KERNEL_DEPTH (its own seeded weights),
    saved, loaded and run: its output against the eager forward's, its
    vmg:: nodes against the eager launch counts, its own launches, the
    export's wall time and the loaded program's frames/s beside the eager
    model's (host clock, device-resident clip, 3 calls after a warm-up)."""
    import shutil

    from vmg_tpu_torch.ckpt.export import export_program, load_program, operator_counts
    from vmg_tpu_torch.configs import FULL_PRESET
    from vmg_tpu_torch.models.vmg import KERNEL_FORMS, create_model
    from vmg_tpu_torch.serve import SRServer

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results",
                        "chip_smoke_export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    clip = torch.from_numpy(np.random.default_rng(9).random((1, T, H, W, 3),
                                                            dtype=np.float32)).cuda()

    def fps_of(fn):
        fn(clip)
        torch.cuda.synchronize()
        t1 = time.time()
        for _ in range(3):
            fn(clip)
        torch.cuda.synchronize()
        return 3 * T / (time.time() - t1)

    out = {}
    try:
        shallow = dataclasses.replace(FULL_PRESET, **EXPORT_KERNEL_DEPTH)
        sd_shallow = create_model(shallow, device="cpu",
                                  generator=torch.Generator().manual_seed(0)).state_dict()
        for label, cfg, weights, forms in (("default", FULL_PRESET, sd, {}),
                                           ("kernel", shallow, sd_shallow, KERNEL_FORMS)):
            server = SRServer(cfg, weights, "cuda", torch.bfloat16, gelu="tanh",
                              fast_flow=True, **forms)
            zero_counts()
            with torch.no_grad():
                eager = server.model(clip)
            torch.cuda.synchronize()
            eager_counts = read_counts()
            path = os.path.join(root, f"vmg_{label}.pt2")
            t1 = time.time()
            program = export_program(server, tuple(clip.shape), path)
            t_export = time.time() - t1
            nodes = operator_counts(program)
            t1 = time.time()
            fn = load_program(path)
            t_load = time.time() - t1
            zero_counts()
            with torch.no_grad():
                got = fn(clip)
            torch.cuda.synchronize()
            loaded_counts = read_counts()
            diff = (got.float() - eager.float()).abs().max().item()
            bit_equal = bool(torch.equal(got, eager))
            with torch.no_grad():
                fps_loaded, fps_eager = fps_of(fn), fps_of(server.model)
            want_nodes = {op: sum(eager_counts[k] for k in names)
                          for op, names in EXPORT_NODES.items()
                          if sum(eager_counts[k] for k in names)}
            report(f"    {label} forms: export {t_export:.1f} s, load {t_load:.1f} s, "
                   f"{os.path.getsize(path) / 2**20:.1f} MiB; output vs eager: bit-equal "
                   f"{bit_equal}, max_abs_diff={diff:.3e}; vmg:: nodes {dict(nodes)} (eager "
                   f"launches {want_nodes}); the loaded program's launches {loaded_counts}; "
                   f"{fps_loaded:.3f} frames/s loaded, {fps_eager:.3f} eager (device-resident "
                   f"clip, host clock); {kind}; card {smi}")
            if got.shape != eager.shape or not torch.isfinite(got).all():
                raise AssertionError(f"the exported {label} program gave {tuple(got.shape)}")
            if dict(nodes) != want_nodes:
                raise AssertionError(f"the {label} program's vmg:: nodes {dict(nodes)} differ "
                                     f"from the eager launches {want_nodes}")
            if loaded_counts != eager_counts:
                raise AssertionError(f"the loaded {label} program launched {loaded_counts}, "
                                     f"eager {eager_counts}")
            # the same kernels and library calls on the same weights: bit-equal
            # unless a library picks other algorithms for the loaded weights'
            # layout; held at the bf16 tolerance, the difference reported
            if diff > REL_TOL[torch.bfloat16] * eager.float().abs().max().item():
                raise AssertionError(f"the exported {label} program differs from eager by "
                                     f"{diff}")
            out[label] = {"depths": cfg.depths, "traj_res_n": cfg.traj_res_n,
                          "export_s": t_export, "load_s": t_load, "bit_equal": bit_equal,
                          "max_abs_diff": diff, "nodes": dict(nodes),
                          "frames_per_s_loaded": fps_loaded, "frames_per_s_eager": fps_eager,
                          "bytes": os.path.getsize(path)}
            del server, program, fn, eager, got
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# phase 9's kernel-form export at depth 1 a stage and 5 residual blocks a
# trajectory step (FULL_PRESET: 4/4/2/2/2/4/4 and 15): the export's time
# grows with the graph, and the run keeps its margin under its time limit
EXPORT_KERNEL_DEPTH = dict(depths=(1,) * 7, traj_res_n=(5, 0, 0, 0, 0, 0, 5))

# phase 10: FULL_PRESET's widths and depths with every tail -- trajectory at
# stages 0/6, DCN at 1/5, 3D window attention at 2/4 and 3 -- and the axis
# FCs linear and bias-free; the kernels its serving path must launch
VARIANT = dict(temporal_type=(False, True, None, None), temporal_empty=False,
               non_linear=False, qkv_bias=False)
VARIANT_PATH = ("ltam_attention_2x2", "fused_group_ffn", "fused_morphfc_axes",
                "fused_morphfc_reduce", "fused_morphfc_combine")


# Phase 11: the T-sharded serving forward (parallel/seq.py) in two processes
# on the one card.  Clips (T, H, W): 16 frames a process, the trajectory
# windows (16) aligned with the shards, and 8, a window split so its carry
# crosses; then float32 at 1x8x64x64 against the plain path on CPU tensors.
SEQ_CLIPS = ((32, 180, 320), (16, 180, 320))
SEQ_F32 = (8, 64, 64)
# each clip's output against the one-process forward: the split window
# (1x16) runs the same kernels at the same shapes and batch in both, so it
# is held bit for bit; the aligned clip's one-process forward batches its
# two windows, each process here one, so cuDNN may pick other algorithms:
# one bf16 rounding step of an output below 0.5 (2**-9; the first card run
# measured 2**-12)
SEQ_TOLS = (2.0 ** -9, 0.0)
# the time means over (T, H, W) on the card: the MorphFC-decay mixer in
# its two kernel forms at the path's shapes (stage 0: axes + combine, at
# 1x16x64x64 as phase 3's stage 0; stage 1: reduce + combine), plain
# MorphFC and the shift FFN; float32, torch-initialised with the reweight
# MLPs at 10x, on a clip whose second half is 4x brighter; against the
# same module on the whole clip in this process at
# tests/test_torch_seq.py's tolerance (atol 2e-5, rtol 1e-4), as an error
# ratio to it; each process's own mean must move the output past 10x that
# tolerance, or the check could not see a wrong sum
SEQ_MEANS = (("MorphFCDecay", (112, 8, 8), (1, 16, 64, 64, 112)),
             ("MorphFCDecay", (224, 16, 16), (1, 16, 32, 32, 224)),
             ("MorphFC", (112, 8, 8), (1, 16, 64, 64, 112)),
             ("MlpCnnShift", (112,), (1, 16, 64, 64, 112)))
SEQ_MEAN_ATOL, SEQ_MEAN_RTOL, SEQ_MEAN_SEEN = 2e-5, 1e-4, 10.0
# Phase 12: tensor parallelism (parallel/tp.py) on a (1, 2) mesh of two
# processes at phase 6's size, two steps, against one process's; lr 1e-4 as
# tests/test_parallel_mesh.py, whose bounds (:77-84) hold the losses of both
# steps and the parameters after the first (the bound's premise: one AdamW
# step moves a parameter by ~lr, so a near-zero gradient whose sign a
# reassociated sum flips moves it by up to 2 lr; after the second step the
# difference is reported).  Since one step moves every parameter by about
# lr whatever its gradient, the first step's gradient is held too, leaf by
# leaf (each rank's slice of a sharded leaf against the same slice of one
# process's): |g - g1| <= TP_GRAD_RTOL |g1| + TP_GRAD_ATOL G +
# TP_GRAD_SPREAD |g1' - g1|, norms over the leaf, G one process's global
# norm (a typical leaf's is G / 29 of the 824), g1' one process's first
# gradient again from the same state: atomic sums in the backward (cuDNN's
# weight gradients, the warps' grid_sample) may make two runs differ, and
# the bound takes that spread in -- a slice zeroed, doubled or swapped
# moves a leaf by its own norm
TP_STEPS, TP_LR = 2, 1e-4
TP_LOSS_RTOL, TP_LOSS_ATOL, TP_PARAM_TOL = 2e-5, 1e-6, 2.5e-4
TP_GRAD_RTOL, TP_GRAD_ATOL, TP_GRAD_SPREAD = 5e-2, 1e-3, 3.0
PARALLEL_TIMEOUT = 600  # seconds a phase's processes may take


def _join_group(rank, world, port, backend):
    """A child of phases 11/12: under gloo every process on card 0 (NCCL
    refuses two ranks on one device), under NCCL process r on card r; the
    kernels loaded from the parent's build."""
    import torch.distributed as dist

    from vmg_tpu_torch import _build

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    _build.load_library()


def _seq_child(rank, world, port, backend, src, out):
    import torch.distributed as dist

    from vmg_tpu_torch.configs import FULL_PRESET
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.parallel import make_mesh, make_seq_sharded_forward, shard_clip_over_time
    from vmg_tpu_torch.parallel.exchange import BYTES, SeqShard, seq_sharded, zero_bytes
    from vmg_tpu_torch.serve import SRServer

    _join_group(rank, world, port, backend)
    try:
        data = torch.load(src, weights_only=False)
        mesh = make_mesh((0, 1))
        model = SRServer(FULL_PRESET, data["sd"], "cuda", torch.bfloat16, gelu="tanh",
                         fast_flow=True).model
        fwd = make_seq_sharded_forward(model, mesh)
        res = {"clips": []}
        for clip in data["clips"]:
            x = shard_clip_over_time(mesh, torch.from_numpy(clip)).cuda()
            with torch.inference_mode():
                fwd(x)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                zero_bytes()
                times = []
                for _ in range(2):  # on-device input and output, as the one-process timing
                    dist.barrier()
                    t0 = time.perf_counter()
                    y = fwd(x)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            counts = {k: v // 2 for k, v in read_counts().items()}
            res["clips"].append({"y": y.cpu().numpy(), "s": times, "launches": counts,
                                 "bytes": {k: v // 2 for k, v in BYTES.items()},
                                 "peak": torch.cuda.max_memory_allocated()})
        del model, fwd
        f32 = create_model(FULL_PRESET, device="cuda")
        f32.load_state_dict(data["sd"])
        zero_bytes()
        with torch.inference_mode():
            y = make_seq_sharded_forward(f32, mesh)(
                shard_clip_over_time(mesh, torch.from_numpy(data["f32"])).cuda())
        res["f32"] = {"y": y.cpu().numpy(), "bytes": dict(BYTES)}
        res["means"] = []
        for module, clip in data["means"]:
            module = module.cuda()
            shard = SeqShard(mesh.data_group, mesh.data_ranks(), mesh.data_index, clip.shape[1])
            with torch.inference_mode(), seq_sharded(shard):
                y = module(shard_clip_over_time(mesh, torch.from_numpy(clip)).cuda())
            res["means"].append(y.cpu().numpy())
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _tp_child(rank, world, port, backend, src, out):
    import torch.distributed as dist

    from vmg_tpu_torch.ckpt.io import trainer_state
    from vmg_tpu_torch.parallel import (gather_state, make_mesh, make_sharded_train_step,
                                        param_shardings, process_local_batch_slice,
                                        shard_params)
    from vmg_tpu_torch.parallel.exchange import BYTES, zero_bytes

    _join_group(rank, world, port, backend)
    try:
        data = torch.load(src, weights_only=False)
        model, tcfg, batch, gen = _tp_setup(data)
        mesh = make_mesh((0, 2))
        rule = param_shardings(mesh, model)
        shard_params(mesh, model)
        step = make_sharded_train_step(model, tcfg, mesh, flow_fix=0)
        local, first = process_local_batch_slice(batch["LRs"].shape[0], mesh)
        batch = {k: v[first:first + local] for k, v in batch.items()}
        def params():  # the whole parameters, gathered (every rank takes part)
            state = gather_state(mesh, trainer_state(model, step), model)
            return {k: v.cpu() for k, v in state["params"].items()} if rank == 0 else None

        zero_bytes()
        res = _tp_steps(step, batch, gen, params)
        res["bytes"] = {k: v // TP_STEPS for k, v in BYTES.items()}
        res.update(held=_tp_bytes(model), sharded=sum(v is not None for v in rule.values()),
                   rule=rule, params=params())
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _tp_setup(data):
    """Phase 6's training size (FULL_PRESET, bf16 on f32 masters, remat,
    T=16, 64x64 crops; B=1 a data index) at lr 1e-4, from ``data``'s
    weights and batch."""
    from vmg_tpu_torch.configs import FULL_PRESET, TrainConfig
    from vmg_tpu_torch.models.vmg import create_model

    model = create_model(dataclasses.replace(FULL_PRESET, remat=True), is_train=True,
                         device="cuda")
    model.load_state_dict(data["sd"])
    tcfg = TrainConfig(lr=TP_LR, T_period=(400000,), if_aux=True, amp=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data["batch"].items()}
    return model, tcfg, batch, torch.Generator(device="cuda").manual_seed(1)


def _record_grads(step):
    """Wrap ``step``'s optimizer so that its first update keeps the
    gradients it is given (after the data-axis mean), on the CPU, by plain
    state-dict name -- a sharded leaf's as this rank's slice -- and their
    global norm."""
    opt = step.optimizer
    names = {id(p): n.replace("parametrizations.", "").replace(".original", "")
             for n, p in step.model.named_parameters()}
    rec, update = {}, opt.step

    def first(grads, norm=None):
        if not rec:
            rec["grads"] = {names[id(p)]: g.detach().float().cpu()
                            for p, g in zip(opt.params, grads)}
            rec["norm"] = float(norm)
        return update(grads, norm)

    opt.step = first
    return rec


def _tp_steps(step, batch, gen, params):
    """TP_STEPS timed steps (the first keeps its gradients on the host:
    :func:`_record_grads`); ``params()`` after the first, untimed and out
    of the peak of allocated memory."""
    rec = _record_grads(step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, first, peak = [], [], None, 0
    for i in range(TP_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(batch, gen)["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated())
        if i == 0:
            first = params()
            torch.cuda.reset_peak_memory_stats()
    return {"losses": losses, "ms": ms, "peak": peak, "first": first, "grads": rec["grads"],
            "grad_norm": rec["norm"]}


def _tp_bytes(model):
    """Bytes of the float32 masters and their AdamW m and v."""
    return 3 * sum(p.numel() * 4 for p in model.parameters())


def _spawn(target, world, backend, src, root):
    """Run ``target(rank, world, port, backend, src, out)`` in ``world``
    spawned processes, each killed past PARALLEL_TIMEOUT; returns their
    results."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(root, f"rank{r}.pt") for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, port, backend, src, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + PARALLEL_TIMEOUT
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{target.__name__}: process exit codes {codes}")
    return [torch.load(o, weights_only=False) for o in outs]


def _exchange_note(world, backend):
    if backend == "gloo":
        return (f"gloo between {world} processes on card 0, through host memory (NCCL "
                "refuses two ranks on one device); compute on the card")
    return f"NCCL between {world} processes, one card each"


def _seq_means(world):
    """SEQ_MEANS's modules (on the CPU) and their clips, each module's
    output on the whole clip on the card, and its ratio to the tolerance
    when each of ``world`` shards takes its own mean."""
    from vmg_tpu_torch.models import blocks

    cases, want, own = [], [], []
    rng = np.random.default_rng(13)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for i, (name, args, shape) in enumerate(SEQ_MEANS):
            torch.manual_seed(i)
            module = getattr(blocks, name)(*args).eval()
            with torch.no_grad():
                for pname, p in module.named_parameters():
                    if "reweight" in pname:
                        p.mul_(10.0)
            clip = rng.random(shape, dtype=np.float32)
            clip[:, shape[1] // 2:] = 4.0 * (1.0 + clip[:, shape[1] // 2:])
            m, x = module.cuda(), torch.from_numpy(clip).cuda()
            with torch.inference_mode():
                y = m(x)
                alone = torch.cat([m(part) for part in x.chunk(world, dim=1)], dim=1)
            want.append(y.cpu().numpy())
            own.append(_mean_ratio(alone.cpu().numpy(), want[-1]))
            cases.append((module.cpu(), clip))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return cases, want, own


def _mean_ratio(got, want):
    return float((np.abs(got - want) / (SEQ_MEAN_ATOL + SEQ_MEAN_RTOL * np.abs(want))).max())


def seq_phase(report, sd, smi, kind, world=2, backend="gloo"):
    """Phase 11 (see the module docstring); with ``backend`` "nccl",
    ``world`` processes on as many cards."""
    from vmg_tpu_torch.configs import FULL_PRESET
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.serve import SRServer

    t_start = time.time()
    rng = np.random.default_rng(11)
    clips = [rng.random((1, *s, 3), dtype=np.float32) for s in SEQ_CLIPS]
    x32 = rng.random((1, *SEQ_F32, 3), dtype=np.float32)
    model = SRServer(FULL_PRESET, sd, "cuda", torch.bfloat16, gelu="tanh", fast_flow=True).model
    one = []
    for c in clips:  # timed as the processes are: input and output on the card
        x = torch.from_numpy(c).cuda()
        with torch.inference_mode():
            model(x)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                y = model(x)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        one.append({"y": y.cpu().numpy(), "s": min(times),
                    "peak": torch.cuda.max_memory_allocated()})
        del x, y
    del model
    torch.cuda.empty_cache()
    cpu_model = create_model(FULL_PRESET, device="cpu")
    cpu_model.load_state_dict(sd)
    with torch.inference_mode():
        want32 = cpu_model(torch.from_numpy(x32)).numpy()
    del cpu_model
    means, want_means, own_means = _seq_means(world)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", "chip_smoke_11")
    os.makedirs(root, exist_ok=True)
    src = os.path.join(root, "inputs.pt")
    torch.save({"sd": sd, "clips": clips, "f32": x32, "means": means}, src)
    ranks = _spawn(_seq_child, world, backend, src, root)
    out = {"clips": [], "exchange": _exchange_note(world, backend)}
    report(f"    exchange: {out['exchange']}")
    for i, (shape, c, tol) in enumerate(zip(SEQ_CLIPS, one, SEQ_TOLS)):
        got = np.concatenate([r["clips"][i]["y"] for r in ranks], axis=1)
        err = float(np.abs(got - c["y"]).max())
        # a run's time: its slower process; the clip's: the better of 2 runs
        s = min(max(r["clips"][i]["s"][k] for r in ranks) for k in range(2))
        per = [{"peak": r["clips"][i]["peak"], "launches": r["clips"][i]["launches"],
                "bytes": r["clips"][i]["bytes"]} for r in ranks]
        rec = {"shape": (1, *shape, 3), "max_abs_err": err, "tol": tol,
               "frames_per_s": shape[0] / s, "one_process_frames_per_s": shape[0] / c["s"],
               "one_process_peak": c["peak"], "processes": per}
        out["clips"].append(rec)
        report(f"    1x{shape[0]}x{shape[1]}x{shape[2]} ({shape[0] // world} frames a process): "
               f"max_abs_err vs one process {err:.3e} (tol {tol:.3e}); "
               f"{rec['frames_per_s']:.3f} frames/s (one process "
               f"{rec['one_process_frames_per_s']:.3f}; both: model forward, input and output on "
               f"the card, host clock, the better of 2 runs, a run timed by its slower process); "
               f"peak allocated per process {[round(p['peak'] / 2**30, 2) for p in per]} GiB, "
               f"one process {c['peak'] / 2**30:.2f} GiB; {kind}; card {smi}")
        for r, p in enumerate(per):
            report(f"      process {r}: launches a clip {p['launches']}; bytes sent {p['bytes']}")
        if got.shape != c["y"].shape or not np.isfinite(got).all() or err > tol:
            raise AssertionError(f"T-sharded serving at {shape} failed: err {err:.3e}")
        missing = [(r, k) for r, p in enumerate(per) for k in VARIANT_PATH if p["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"T-sharded serving: kernels never launched {missing}")
    got32 = np.concatenate([r["f32"]["y"] for r in ranks], axis=1)
    err32 = float(np.abs(got32 - want32).max())
    out["f32"] = {"shape": (1, *SEQ_F32, 3), "max_abs_err": err32, "tol": SLICE_TOL,
                  "bytes": [r["f32"]["bytes"] for r in ranks]}
    report(f"    f32 1x{SEQ_F32[0]}x{SEQ_F32[1]}x{SEQ_F32[2]} (one trajectory window over both "
           f"processes) vs the one-process plain path on CPU tensors: max_abs_err={err32:.3e} "
           f"(tol {SLICE_TOL}); bytes sent {[r['f32']['bytes'] for r in ranks]}")
    if not (np.isfinite(got32).all() and err32 <= SLICE_TOL):
        raise AssertionError("T-sharded f32 parity failed")
    out["means"] = []
    for i, ((name, args, shape), want, own) in enumerate(zip(SEQ_MEANS, want_means, own_means)):
        got = np.concatenate([r["means"][i] for r in ranks], axis=1)
        ratio = _mean_ratio(got, want)
        out["means"].append({"module": name, "args": args, "shape": shape,
                             "err_ratio": ratio, "own_mean_ratio": own})
        report(f"    time mean {name}{args} f32 at {shape}: error / tolerance {ratio:.3g} "
               f"(atol {SEQ_MEAN_ATOL:g}, rtol {SEQ_MEAN_RTOL:g}; must be <= 1); each process's "
               f"own mean would give {own:.3g} (must be > {SEQ_MEAN_SEEN:g})")
        if not (np.isfinite(got).all() and ratio <= 1.0 and own > SEQ_MEAN_SEEN):
            raise AssertionError(f"T-sharded time mean of {name}{args} failed")
    out["seconds"] = time.time() - t_start
    report(f"    phase 11 took {out['seconds']:.1f} s")
    return out


def tp_phase(report, smi, kind, world=2, backend="gloo"):
    """Phase 12 (see the module docstring); with ``backend`` "nccl", a
    (world / 2, 2) mesh of processes on as many cards, a batch of world / 2
    clips."""
    from vmg_tpu_torch.configs import FULL_PRESET
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.train.train_step import make_train_step

    t_start = time.time()
    sd = create_model(dataclasses.replace(FULL_PRESET, remat=True), is_train=True, device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(12)
    B = world // 2
    data = {"sd": sd, "batch": {"LRs": rng.random((B, T, 64, 64, 3), dtype=np.float32),
                                "HRs": rng.random((B, T, 256, 256, 3), dtype=np.float32)}}
    model, tcfg, batch, gen = _tp_setup(data)
    step = make_train_step(model, tcfg, flow_fix=0)
    one = _tp_steps(step, batch, gen,
                    lambda: {k: v.cpu() for k, v in model.state_dict().items()})
    one["held"] = _tp_bytes(model)
    want = {k: v.cpu() for k, v in model.state_dict().items()}
    del model, step, batch
    torch.cuda.empty_cache()
    model, tcfg, batch, gen = _tp_setup(data)  # the first step again, same state
    step = make_train_step(model, tcfg, flow_fix=0)
    again = _record_grads(step)
    step(batch, gen)
    del model, step, batch
    torch.cuda.empty_cache()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", "chip_smoke_12")
    os.makedirs(root, exist_ok=True)
    src = os.path.join(root, "inputs.pt")
    torch.save(data, src)
    ranks = _spawn(_tp_child, world, backend, src, root)
    report(f"    exchange: {_exchange_note(world, backend)}; mesh ({world // 2}, 2), batch {B}")
    def worst(got, want):
        return max(float((got[k] - v).abs().max()) for k, v in want.items())

    diff1, diff = worst(ranks[0]["first"], one["first"]), worst(ranks[0]["params"], want)
    loss_ok = all(abs(a - b) <= TP_LOSS_ATOL + TP_LOSS_RTOL * abs(b)
                  for r in ranks for a, b in zip(r["losses"], one["losses"]))
    # the first gradient, leaf by leaf, over the tensor group of data index 0
    # (ranks 0 and 1; the data axis's mean leaves every data index the same)
    G, ratios, spread = one["grad_norm"], {}, {}
    for name, g1 in one["grads"].items():
        dim = ranks[0]["rule"][name]
        parts = [(ranks[0]["grads"][name], g1)] if dim is None else \
            [(ranks[j]["grads"][name], g1.chunk(2, dim)[j]) for j in range(2)]
        err = float(sum(((g - w) ** 2).sum() for g, w in parts)) ** 0.5
        floor = TP_GRAD_RTOL * float(g1.norm()) + TP_GRAD_ATOL * G
        self_err = float((again["grads"][name] - g1).norm())
        ratios[name] = err / (floor + TP_GRAD_SPREAD * self_err)
        spread[name] = (err / floor, self_err / floor)
    worst_leaf = max(ratios, key=ratios.get)
    worst_tp = max(spread, key=lambda k: spread[k][0])
    worst_self = max(spread, key=lambda k: spread[k][1])
    norms = [r["grad_norm"] for r in ranks]
    grad_ok = (len(ratios) == len(ranks[0]["rule"]) and ratios[worst_leaf] <= 1.0
               and all(abs(n - G) <= TP_GRAD_RTOL * G for n in norms))
    out = {"losses_one": one["losses"], "losses": [r["losses"] for r in ranks],
           "max_param_diff_step1": diff1, "max_param_diff": diff,
           "grad_norm_one": G, "grad_norm_one_again": again["norm"], "grad_norm": norms,
           "grad_worst_leaf": worst_leaf, "grad_worst_ratio": ratios[worst_leaf],
           "grad_worst_floor_ratio": [worst_tp, spread[worst_tp][0]],
           "grad_worst_floor_ratio_one_again": [worst_self, spread[worst_self][1]],
           "sharded_leaves": ranks[0]["sharded"],
           "held_bytes": [r["held"] for r in ranks], "one_process_held_bytes": one["held"],
           "step_ms": [r["ms"] for r in ranks], "one_process_step_ms": one["ms"],
           "peak": [r["peak"] for r in ranks], "one_process_peak": one["peak"],
           "bytes": [r["bytes"] for r in ranks]}
    report(f"    losses {[[round(v, 7) for v in r['losses']] for r in ranks]} vs one process "
           f"{[round(v, 7) for v in one['losses']]} (rtol {TP_LOSS_RTOL:g}, atol "
           f"{TP_LOSS_ATOL:g}); max |param diff| after step 1 {diff1:.3e} (tol "
           f"{TP_PARAM_TOL:g}), after step {TP_STEPS} {diff:.3e}")
    report(f"    first gradient: global norm {[round(n, 6) for n in norms]} vs one process "
           f"{G:.6f} (again {again['norm']:.6f}); leaf by leaf |g - g1| / ({TP_GRAD_RTOL:g} "
           f"|g1| + {TP_GRAD_ATOL:g} G + {TP_GRAD_SPREAD:g} |g1' - g1|) at most "
           f"{ratios[worst_leaf]:.3g} ({worst_leaf}; must be <= 1) over {len(ratios)} leaves; "
           f"without the spread term {spread[worst_tp][0]:.3g} ({worst_tp}), one process "
           f"again against itself {spread[worst_self][1]:.3g} ({worst_self})")
    report(f"    {out['sharded_leaves']} sharded leaves; masters + AdamW m, v per process "
           f"{[round(b / 2**20, 2) for b in out['held_bytes']]} MiB vs one process "
           f"{one['held'] / 2**20:.2f} MiB; step ms {out['step_ms']} (one process "
           f"{[round(v, 1) for v in one['ms']]}); peak allocated "
           f"{[round(p / 2**30, 2) for p in out['peak']]} GiB (one process "
           f"{one['peak'] / 2**30:.2f}); bytes sent a step {out['bytes']}; {kind}; card {smi}")
    if not (loss_ok and grad_ok and diff1 < TP_PARAM_TOL and out["sharded_leaves"] > 0
            and all(b < one["held"] for b in out["held_bytes"])):
        raise AssertionError("tensor-parallel training failed its bounds")
    out["seconds"] = time.time() - t_start
    report(f"    phase 12 took {out['seconds']:.1f} s")
    return out


def variant_phase(report, smi, kind):
    """Phase 10: the VARIANT configuration at FULL_PRESET's widths and
    depths.  f32 parity at 1x2x64x64 (kernels on the card against the plain
    path on CPU tensors, phase 3's tolerance; the DCN's zero-initialised
    offset head perturbed so that its offsets and masks vary); SRServer in
    bf16 at 1x16x180x320 in the default and kernel forms (a warm-up request,
    then 2 clips: frames/s, peak memory, launches); one bf16 training step
    at phase 6's size (B=1, T=16, 64x64 crops) after a warm-up step."""
    from vmg_tpu_torch.configs import FULL_PRESET
    from vmg_tpu_torch.models.vmg import KERNEL_FORMS, create_model
    from vmg_tpu_torch.serve import SRServer
    from vmg_tpu_torch.train.__main__ import run as train_run

    cfg = dataclasses.replace(FULL_PRESET, **VARIANT)
    cpu_model = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if "pa_deform.conv_offset.6" in name:
                p.copy_(0.01 * torch.randn(p.shape, generator=gen))
    sd = cpu_model.state_dict()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(np.random.default_rng(1).random((1, 2, 64, 64, 3), dtype=np.float32))
    zero_counts()
    with torch.inference_mode():
        t1 = time.time()
        want = cpu_model(x)
        t_cpu = time.time() - t1
        got = gpu_model(x.cuda()).cpu()
    parity_launches = read_counts()
    err = (got - want).abs().max().item()
    report(f"    f32 1x2x64x64: max_abs_err={err:.3e} (tol {SLICE_TOL}); CPU plain path "
           f"{t_cpu:.1f} s; launches {parity_launches}")
    if not (torch.isfinite(got).all() and err <= SLICE_TOL):
        raise AssertionError("phase 10 slice parity failed")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()

    rng = np.random.default_rng(10)
    warm = rng.random((1, T, H, W, 3), dtype=np.float32)
    clips = [rng.random((1, T, H, W, 3), dtype=np.float32) for _ in range(2)]
    out = {"slice_max_abs_err": err}
    for label, forms in (("default", {}), ("kernel", KERNEL_FORMS)):
        server = SRServer(cfg, sd, "cuda", torch.bfloat16, gelu="tanh", fast_flow=True,
                          **forms)
        t1 = time.time()
        res = server(warm)
        t_warm = time.time() - t1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        per_request = []
        t1 = time.time()
        for c in clips:
            t2 = time.time()
            res = server(c)
            per_request.append(T / (time.time() - t2))
        fps = T * len(clips) / (time.time() - t1)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        report(f"    {label} forms: {fps:.3f} frames/s (host clock, numpy in/out; per request "
               f"{[round(v, 3) for v in per_request]}; warm-up {t_warm:.2f} s); peak allocated "
               f"{peak / 2**30:.2f} GiB; {kind}; card {smi}")
        report(f"    launches over the {len(clips)} clips: {launches}")
        if res.shape != (1, T, 4 * H, 4 * W, 3) or not np.isfinite(res).all():
            raise AssertionError(f"bad phase 10 serving output {res.shape}")
        missing = [k for k in VARIANT_PATH if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched serving phase 10's model: {missing}")
        if (not forms and any(launches[k] for k in OPT_IN)) or off_path_launched(launches):
            raise AssertionError(f"phase 10 {label} serving launched an opt-in or off-path "
                                 "kernel")
        out[label] = {"frames_per_s": fps, "per_request_frames_per_s": per_request,
                      "peak_bytes": peak, "launches": launches}
        del server
        torch.cuda.empty_cache()

    zero_counts()
    rec = train_run(batch=1, frames=16, crop=64, iters=1, grad_acc=1, remat=True,
                    device="cuda", network=cfg)
    train_launches = read_counts()
    losses = [rec["loss_first"], *rec["losses"]]
    report(f"    training (bf16 on f32 masters, B=1 T=16 64x64, remat): step "
           f"{rec['step_ms_median']:.1f} ms, peak allocated {rec['peak_bytes'] / 2**30:.2f} "
           f"GiB, losses {[round(v, 6) for v in losses]}; launches {train_launches}")
    if not all(np.isfinite(v) for v in losses) or train_launches["ltam_attention_2x2_bwd"] <= 0:
        raise AssertionError(f"phase 10 training failed: losses {losses}")
    out["training"] = {**rec, "launches": train_launches}
    out["launches"] = out["default"]["launches"]
    return out


# phase 8b: losses of the one-process NCCL run against phase 8's, relative:
# the same seeds, data and arithmetic (an all_reduce over one process is
# exact); the tolerance only covers cuDNN's run-to-run backward orders
MULTIHOST_LOSS_TOL = 1e-3


def multihost_phase(report, cfg, root, want, smi, kind):
    """Phase 8b: ``python -m vmg_tpu_torch.tools.train --multihost``'s
    function on phase 8's config and tree, in a one-process NCCL group
    (``tools.train.join_process_group``, from the usual environment), for
    as many steps as phase 8's first run; its losses against those."""
    import socket

    import torch.distributed as dist

    from vmg_tpu_torch.tools.train import join_process_group, train

    cfg = copy.deepcopy(cfg)
    cfg.path.experiments_root = os.path.join(root, "experiments_multihost")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": "1",
           "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        join_process_group(cfg, "cuda")
        backend = dist.get_backend()
        rec = train(cfg, max_steps=len(want), max_retries=0, device="cuda")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    losses = rec["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    report(f"    {backend} group of {rec['processes']} process(es), mesh {cfg.mesh_shape}: losses "
           f"{[round(v, 6) for v in losses]}; phase 8's {[round(v, 6) for v in want]}: "
           f"bit-equal {losses == want}, max relative difference {rel:.3e} (tol "
           f"{MULTIHOST_LOSS_TOL:g}); step ms {[round(v, 1) for v in rec['step_ms']]}; {kind}; "
           f"card {smi}")
    if backend != "nccl" or rec["processes"] != 1 or len(losses) != len(want) or not (
            rel <= MULTIHOST_LOSS_TOL):
        raise AssertionError(f"--multihost training differs from phase 8: {losses} vs {want}")
    return {"backend": backend, "losses": losses, "bit_equal": losses == want,
            "max_rel_diff": rel, "step_ms": rec["step_ms"]}


def check_kernels(report):
    """Phase 2.  Returns one dict per kernel for the JSON line."""
    import torch.nn.functional as F

    from vmg_tpu_torch.configs import TRAIN_PRESETS
    from vmg_tpu_torch.models.blocks import _axis_mix
    from vmg_tpu_torch.ops import conv_chain, fused_norm, group_conv, ltam_attention, morphfc_fused
    from vmg_tpu_torch.ops.decay import morphfc_decay_np

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    def rn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    entries = {
        "fused_group_ffn": dict(source="vmg_tpu_torch/csrc/group_ffn.cu",
                                replaces="vmg_tpu/ops/group_conv.py:187"),
        "fused_morphfc_axes": dict(source="vmg_tpu_torch/csrc/morphfc.cu",
                                   replaces="vmg_tpu/ops/morphfc_fused.py:175"),
        "fused_morphfc_reduce": dict(source="vmg_tpu_torch/csrc/morphfc.cu",
                                     replaces="vmg_tpu/ops/morphfc_fused.py:359"),
        "fused_morphfc_combine": dict(source="vmg_tpu_torch/csrc/morphfc.cu",
                                      replaces="vmg_tpu/ops/morphfc_fused.py:421"),
        "ltam_attention_2x2": dict(source="vmg_tpu_torch/csrc/ltam.cu",
                                   replaces="vmg_tpu/ops/ltam_attention.py:282"),
        "ltam_attention_2x2_bwd": dict(source="vmg_tpu_torch/csrc/ltam.cu",
                                       replaces="vmg_tpu/ops/ltam_attention.py:308"),
        "fused_conv_chain": dict(source="vmg_tpu_torch/csrc/conv_chain.cu",
                                 replaces="vmg_tpu/ops/conv_chain.py:183"),
        "fused_norm": dict(source="vmg_tpu_torch/csrc/fused_norm.cu",
                           replaces="vmg_tpu/ops/fused_norm.py:102"),
        "layout_pin": dict(source="vmg_tpu_torch/csrc/conv_chain.cu",
                           replaces="vmg_tpu/ops/conv_chain.py:164"),
        "fused_morphfc_axes_token": dict(source="vmg_tpu_torch/csrc/morphfc.cu",
                                         replaces="vmg_tpu/ops/morphfc_fused.py:257"),
        "slab_copy": dict(source="vmg_tpu_torch/csrc/probes.cu",
                          replaces="tools/exp_mosaic_probe.py:51"),
        "smem_relayout": dict(source="vmg_tpu_torch/csrc/probes.cu",
                              replaces="tools/exp_mosaic_probe2.py:46"),
        "tile_gemm": dict(source="vmg_tpu_torch/csrc/probes.cu",
                          replaces="tools/exp_mosaic_probe2.py:97"),
    }
    # No single PyTorch call computes the first seven functions (each needs
    # layout changes or several ops around a library call), so no library
    # time is taken for them; the norm's is F.layer_norm / F.rms_norm, the
    # pin's x.clone().
    for e in entries.values():
        e.update(route="cuda", max_abs_err=0.0, library_ms=None)
    for name in ("fused_morphfc_axes", "fused_morphfc_axes_token"):
        entries[name]["options"] = {}

    def compare(name, shape, dtype, kernel, plain, check, primary, work, extra="",
                library=None, keys=None):
        """Check and time one kernel call.  ``check(got, want)`` gives one
        (label, max_abs_err, ok, text) per output; ``primary``: the call at
        the main path's shape and dtype whose times go into the JSON line;
        ``work``: (inputs, operations, peak) for its bound; ``library``: one
        PyTorch call computing the same function, timed beside it; ``keys``:
        more numbers for the JSON line of a primary call."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        results = check(got, want)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        text = "; ".join(f"{lbl}max_abs_err={err:.3e} {txt}" for lbl, err, _, txt in results)
        if not (finite and all(ok for _, _, ok, _ in results)):
            report(f"  {name} {dtype} {shape}: finite={finite}; {text} FAIL")
            raise AssertionError(f"{name} disagrees with its plain version")
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, iters=3)
        library_ms = None if library is None else cuda_ms(library)
        b = bound(work[0], got, work[1], work[2])
        lib_text = "" if library_ms is None else f"  library {library_ms:.3f} ms"
        report(f"  {name:22s} {str(dtype):15s} {str(shape):26s} {text} ok  "
               f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms{lib_text}  bound "
               f"{b['bound_ms']:.4f} ms ({b['bound_by']}){extra}")
        e = entries[name]
        e["max_abs_err"] = max([e["max_abs_err"]] + [err for _, err, _, _ in results])
        if primary:
            e.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     at=f"{dtype} {shape}", **b, **(keys or {}))
        return ms, b, got

    def dtype_check(dtype):
        return lambda got, want: [within_max(got[0], want[0], REL_TOL[dtype])]

    def peak_ffn_axes(dtype):  # f32 as three TF32 products on the tensor cores
        return "bf16 tensor cores" if dtype == torch.bfloat16 else "3xTF32 tensor cores"

    def axes_args(shape, ck, dtype):
        """x, c and the decay-folded axis weights and biases of a mixer."""
        N, h, w, C = shape
        x, xc = rn(N, h, w, C, dtype=dtype), rn(N, h, w, C, scale=0.01, dtype=dtype)
        gamma = torch.from_numpy(morphfc_decay_np(ck, C // ck)).to(dev, dtype)
        kh, kw = ((rn(C, C, scale=0.02, dtype=dtype) * gamma).contiguous() for _ in range(2))
        return x, xc, kh, rn(C, scale=0.1), kw, rn(C, scale=0.1)

    def axes_check(xc, dtype):
        def check(got, want):
            terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (want[0], want[1], xc))
            return [within_max(got[0], want[0], REL_TOL[dtype], "h "),
                    within_max(got[1], want[1], REL_TOL[dtype], "w "),
                    within_sum(got[2], want[2], terms, "psum ")]
        return check

    # the token form's path: its op entry point at the wide stages' shapes,
    # in the serving dtype, counted from zero
    zero_counts()
    for shape, ck in TOKEN_SHAPES:
        args = axes_args(shape, ck, torch.bfloat16)
        morphfc_fused.fused_morphfc_axes(*args, chunk_h=ck, chunk_w=ck, form="token")
        del args
    torch.cuda.synchronize()
    token_path = read_counts()
    report(f"  token form's entry point at {TOKEN_SHAPES}: launches {token_path}")
    if token_path["fused_morphfc_axes_token"] != len(TOKEN_SHAPES):
        raise AssertionError("the token form's entry point did not launch its kernel")
    entries["fused_morphfc_axes_token"]["path_launches"] = token_path

    for dtype in (torch.float32, torch.bfloat16):
        # the FFN at the four stage shapes of FULL_PRESET (N = 16 frames,
        # groups 4, 6C hidden) and the few-levels shape (groups 1, 2C)
        for (N, h, w, C), G, ratio in FFN_SHAPES:
            Fh = ratio * C
            x = rn(N, h, w, C, dtype=dtype)
            w1 = rn(Fh, C // G, 3, 3, scale=(9 * C / G) ** -0.5, dtype=dtype)
            b1, b2 = rn(Fh, scale=0.1, dtype=dtype), rn(C, scale=0.1, dtype=dtype)
            w2 = rn(C, Fh, scale=0.02, dtype=dtype)
            args = (x, *group_conv.pack_ffn_weights(w1, b1, w2, G), b2)
            # grouped 3x3 conv (C/G inputs per output) and the C x ratio*C fc2
            flops = 2 * N * h * w * Fh * (9 * C // G + C)
            shape = (N, h, w, C)
            bf16 = dtype == torch.bfloat16
            # the module form: cuDNN grouped conv, GELU, fc2 (what training
            # runs); in f32 with TF32 off and with cuDNN's default TF32 on,
            # as the evaluation command runs its convolutions
            xc = x.permute(0, 3, 1, 2)  # NHWC memory: a channels-last view
            w1c = w1.contiguous(memory_format=torch.channels_last)

            def module():
                y = F.conv2d(xc, w1c, b1, padding=1, groups=G).permute(0, 2, 3, 1)
                return F.linear(group_conv.gelu(y, "tanh"), w2, b2)

            module_ms = cuda_ms(module, iters=5)
            extra, keys = f"  module form {module_ms:.3f} ms", {"module_ms": module_ms}
            if not bf16:
                torch.backends.cudnn.allow_tf32 = True
                module_tf32_ms = cuda_ms(module, iters=5)
                torch.backends.cudnn.allow_tf32 = False
                extra += (f" (TF32 convs {module_tf32_ms:.3f} ms), f32 bound "
                          f"{flops / 67e9:.3f} ms")
            ms, b, got = compare(
                "fused_group_ffn", shape, dtype,
                lambda: group_conv.fused_group_ffn(*args, groups=G, act="tanh"),
                lambda: group_conv.group_ffn_plain(*args, groups=G, act="tanh"),
                dtype_check(dtype), primary=bf16 and shape == FFN_SHAPES[0][0],
                work=((x, w1, b1, w2, b2), flops, peak_ffn_axes(dtype)), extra=extra, keys=keys)
            # the result must not depend on which block took which tile
            again = group_conv.fused_group_ffn(*args, groups=G, act="tanh")
            torch.cuda.synchronize()
            if not torch.equal(again, got[0]):
                raise AssertionError(f"two runs of the FFN differ at {shape}")
            if bf16:
                report(f"    {flops / ms / 1e9:.1f} TFLOP/s, {b['bound_ms'] / ms:.3f} of the "
                       f"bound, kernel / module form {ms / module_ms:.3f}; two runs bit-equal; "
                       f"before the redesigns: wmma {FFN_BEFORE_MS.get(shape)} ms, one-row "
                       f"tiles {FFN_ROW_TILES_MS.get(shape)} ms (PERF.md, same timer)")
                entries["fused_group_ffn"][f"groups{G}_" + "x".join(map(str, shape))] = {
                    "ms": ms, "module_ms": module_ms, "bound_ms": b["bound_ms"],
                    "tflop_s": flops / ms / 1e9}
            else:
                report(f"    {flops / ms / 1e9:.1f} TFLOP/s, {b['bound_ms'] / ms:.3f} of the "
                       f"3xTF32 bound, kernel / module form {ms / module_ms:.3f} (TF32 off), "
                       f"{ms / module_tf32_ms:.3f} (TF32 convs); two runs bit-equal; before "
                       f"the redesign: scalar {FFN_F32_BEFORE_MS.get(shape)} ms (PERF.md)")
                entries["fused_group_ffn"][f"f32_groups{G}_" + "x".join(map(str, shape))] = {
                    "ms": ms, "module_ms": module_ms, "module_tf32_ms": module_tf32_ms,
                    "bound_ms": b["bound_ms"], "tflop_s": flops / ms / 1e9}
            del x, w1, args, got, again

        # the axis-branch kernel at stages 0/6: chunk 8 along H and W; its
        # token form at stages 1/5 and 3, next to the 'hybrid' form they run
        # (XLA-form axis FCs + the reduce kernel), and against the big form
        eval_axes = [] if dtype == torch.bfloat16 else [(EVAL_TILE_SHAPES[0], 8, "big")]
        for shape, ck, form in [((16, 184, 320, 112), 8, "big")] + [
                (shape, ck, "token") for shape, ck in TOKEN_SHAPES] + eval_axes:
            N, h, w, C = shape
            args = axes_args(shape, ck, dtype)
            x, xc, kh, bh, kw, bw = args
            name = "fused_morphfc_axes" if form == "big" else "fused_morphfc_axes_token"

            def hybrid():
                hh = _axis_mix(x, kh, bh.to(dtype), ck, 1).contiguous()
                ww = _axis_mix(x, kw, bw.to(dtype), ck, 2).contiguous()
                return morphfc_fused.fused_morphfc_reduce(hh, ww, xc)

            hybrid_ms = cuda_ms(hybrid, iters=3)
            ms, b, got = compare(
                name, (N, h, w, C, ck), dtype,
                lambda: morphfc_fused.fused_morphfc_axes(*args, chunk_h=ck, chunk_w=ck,
                                                         form=form),
                lambda: morphfc_fused.morphfc_axes_plain(*args, chunk_h=ck, chunk_w=ck),
                axes_check(xc, dtype), primary=dtype == torch.bfloat16 and C in (112, 224),
                # two C x C FCs (f32: three TF32 products each)
                work=(args, 2 * 2 * N * h * w * C * C, peak_ffn_axes(dtype)),
                extra=f"  hybrid form {hybrid_ms:.3f} ms", keys={"hybrid_ms": hybrid_ms})
            # the result must not depend on which warpgroup took which tile
            again = morphfc_fused.fused_morphfc_axes(*args, chunk_h=ck, chunk_w=ck, form=form)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in zip(again, got)):
                raise AssertionError(f"two runs of the axes kernel ({form}) differ at {shape}")
            del again
            if dtype == torch.bfloat16:
                before = AXES_BEFORE_MS if form == "big" else TOKEN_BEFORE_MS[shape]
                report(f"    {b['bound_ms'] / ms:.3f} of the bound "
                       f"({b['bound_bytes'] / ms / 1e9:.2f} TB/s); two runs bit-equal; "
                       f"before the redesign {before} ms (PERF.md)")
                if form == "token":
                    entries[name]["x".join(map(str, shape))] = {
                        "ms": ms, "bound_ms": b["bound_ms"], "hybrid_ms": hybrid_ms}
            else:
                before = (AXES_F32_BEFORE_MS if form == "big" else TOKEN_F32_BEFORE_MS).get(shape)
                report(f"    {b['bound_ms'] / ms:.3f} of the 3xTF32 bound "
                       f"({b['bound_by']}; {b['bound_bytes'] / ms / 1e9:.2f} TB/s), kernel / "
                       f"hybrid form {ms / hybrid_ms:.3f}; two runs bit-equal; before the "
                       f"redesign: scalar {before} ms (PERF.md)")
                key = "f32_" + "x".join(map(str, shape))
                entries[name][key] = {"ms": ms, "bound_ms": b["bound_ms"],
                                      "hybrid_ms": hybrid_ms}
                if form == "token":  # the 3xTF32 chains' drift, as the FFN's (SUM_TOL)
                    sums, terms = axes_f64_sums(*args, ck)
                    own = (got[0].double() + got[1].double() + xc.double()).sum(dim=(1, 2))
                    for label, v in (("psum", got[2]), ("outputs", own)):
                        worst, signed, toward = sum_errors(v, sums, terms)
                        ok = worst <= SUM_TOL
                        report(f"    sums ({label}) against float64: max {worst:.3e}, mean "
                               f"signed {signed:+.3e}, toward zero {toward:+.3e} of sum|terms| "
                               f"(tol {SUM_TOL:g}) {'ok' if ok else 'FAIL'}")
                        entries[name][key][f"{label}_sums"] = (worst, signed, toward)
                        if not ok:
                            raise AssertionError(f"the f32 token form's sums drift at {shape}")
                    del sums, terms
            del got
            if form == "big":  # the token form on the big form's domain
                big = morphfc_fused.fused_morphfc_axes(*args, chunk_h=ck, chunk_w=ck)
                token = morphfc_fused.fused_morphfc_axes(*args, chunk_h=ck, chunk_w=ck,
                                                         form="token")
                torch.cuda.synchronize()
                results = axes_check(xc, dtype)(token, big)
                text = "; ".join(f"{lbl}max_abs_err={err:.3e} {txt}"
                                 for lbl, err, _, txt in results)
                ok = all(r[2] for r in results)
                report(f"  token form vs big form {dtype} {(N, h, w, C, ck)}: {text} "
                       f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("the token form disagrees with the big form")
                del big, token
            del x, xc, args

        # the axes kernels' linear and bias-free forms (non_linear off, no
        # biases: phase 10's mixers), each instantiation at one path shape,
        # against the plain version (the sums to SUM_TOL of their terms),
        # timed beside the default form
        for shape, ck, form in AXES_OPTION_SHAPES[dtype]:
            N, h, w, C = shape
            x, xc, kh, bh, kw, bw = axes_args(shape, ck, dtype)
            name = "fused_morphfc_axes" if form == "big" else "fused_morphfc_axes_token"
            default_ms = cuda_ms(lambda: morphfc_fused.fused_morphfc_axes(
                x, xc, kh, bh, kw, bw, chunk_h=ck, chunk_w=ck, form=form), iters=5)
            for nl, bias in AXES_OPTIONS:
                b1, b2 = (bh, bw) if bias else (None, None)
                ms, b, got = compare(
                    name, (N, h, w, C, ck, f"non_linear={nl}", f"bias={bias}"), dtype,
                    lambda: morphfc_fused.fused_morphfc_axes(
                        x, xc, kh, b1, kw, b2, chunk_h=ck, chunk_w=ck, form=form,
                        non_linear=nl),
                    lambda: morphfc_fused.morphfc_axes_plain(
                        x, xc, kh, b1, kw, b2, chunk_h=ck, chunk_w=ck, non_linear=nl),
                    axes_check(xc, dtype), primary=False,
                    work=((x, xc, kh, kw), 2 * 2 * N * h * w * C * C, peak_ffn_axes(dtype)),
                    extra=f"  default form {default_ms:.3f} ms")
                if bool((got[0] < 0).any()) == nl:  # the relu ran, or did not
                    raise AssertionError(f"the axes kernel ({form}, {dtype}) took "
                                         f"non_linear={nl} as {not nl}")
                entries[name]["options"][f"{dtype} {shape} non_linear={nl} bias={bias}"] = {
                    "ms": ms, "default_ms": default_ms, "bound_ms": b["bound_ms"]}
                del got
            del x, xc, kh, kw

        # the reduce at every shape it runs (bf16), at stages 0 and 3 and the
        # eval tile's stages 1/5, 2/4 and 3 (f32), two runs bit-equal; its
        # sum over a clip of each preset
        clip = {False: [0.0, 0.0], True: [0.0, 0.0]}  # few-levels? -> ms, bound
        for shape, per_clip in (REDUCE_SHAPES if bf16 else
                                [(REDUCE_SHAPES[-1][0], 0), (REDUCE_SHAPES[2][0], 0)]
                                + [(s, 0) for s in EVAL_TILE_SHAPES[1:]]):
            N, h, w, C = shape
            xh, xw, xc = (rn(*shape, dtype=dtype) for _ in range(3))
            terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (xh, xw, xc))
            ms, b, got = compare("fused_morphfc_reduce", shape, dtype,
                                 lambda: morphfc_fused.fused_morphfc_reduce(xh, xw, xc),
                                 lambda: morphfc_fused.morphfc_reduce_plain(xh, xw, xc),
                                 lambda got, want: [within_sum(got[0], want[0], terms)],
                                 bf16 and shape == REDUCE_SHAPES[0][0],
                                 work=((xh, xw, xc), 3 * xh.numel(), "f32"))
            again = morphfc_fused.fused_morphfc_reduce(xh, xw, xc)
            torch.cuda.synchronize()
            if not torch.equal(again, got[0]):
                raise AssertionError(f"two runs of the reduce differ at {shape}")
            if bf16:
                few = shape in REDUCE_FEW
                clip[few][0] += per_clip * ms
                clip[few][1] += per_clip * b["bound_ms"]
                report(f"    {b['bound_ms'] / ms:.3f} of the bound "
                       f"({b['bound_bytes'] / ms / 1e9:.2f} TB/s), {per_clip} launches a "
                       f"{'few-levels' if few else 'FULL_PRESET'} clip; two runs bit-equal; "
                       f"before the redesign {REDUCE_BEFORE_MS[shape]} ms (PERF.md)")
                entries["fused_morphfc_reduce"]["x".join(map(str, shape))] = {
                    "ms": ms, "bound_ms": b["bound_ms"], "launches_per_clip": per_clip}
            del xh, xw, xc, got, again
        if bf16:
            for few, (label, n) in ((False, ("FULL_PRESET", 14)), (True, ("few-levels", 12))):
                c_ms, c_bound = clip[few]
                report(f"    reduce per {label} clip ({n} launches): {c_ms:.4f} ms against a "
                       f"bound of {c_bound:.4f} ms ({c_bound / c_ms:.3f})")
                entries["fused_morphfc_reduce"]["per_clip_few" if few else "per_clip"] = {
                    "ms": c_ms, "bound_ms": c_bound}

        # the combine: the kernel's B image of Pk; bf16 at every path shape,
        # f32 (3xTF32) at stages 0 and 3 and the eval tile's four; each gate
        # (tanh on every preset's path)
        bf16 = dtype == torch.bfloat16
        for shape in (COMBINE_SHAPES if bf16 else
                      [COMBINE_SHAPES[0], COMBINE_SHAPES[3]] + EVAL_TILE_SHAPES):
            N, h, w, C = shape
            xh, xw, xc, x, res = (rn(*shape, dtype=dtype) for _ in range(5))
            a = torch.softmax(rn(N, 3, C), dim=1).to(dtype)
            pk, pb = rn(C, C, scale=0.02, dtype=dtype), rn(C, scale=0.1)
            pkk = morphfc_fused.pack_combine_weight(pk)
            args, pargs = (x, xh, xw, xc, a, pkk, pb), (x, xh, xw, xc, a, pk, pb)
            for act in ("tanh", "sigmoid", "relu"):
                # the C x C projection; the weighted sum and gate are elementwise
                ms, b, got = compare(
                    "fused_morphfc_combine", (*shape, act), dtype,
                    lambda: morphfc_fused.fused_morphfc_combine(*args, act=act, residual=res),
                    lambda: morphfc_fused.morphfc_combine_plain(*pargs, act=act, residual=res),
                    dtype_check(dtype), bf16 and shape == COMBINE_SHAPES[0] and act == "tanh",
                    work=((x, xh, xw, xc, a, pk, pb, res), 2 * x.numel() * C,
                          peak_ffn_axes(dtype)))
                if act == "tanh":
                    # the result must not depend on which warpgroup took which tile
                    again = morphfc_fused.fused_morphfc_combine(*args, act=act, residual=res)
                    torch.cuda.synchronize()
                    if not torch.equal(again, got[0]):
                        raise AssertionError(f"two runs of the combine differ at {shape}")
                    before = (COMBINE_BEFORE_MS if bf16 else COMBINE_F32_BEFORE_MS).get(shape)
                    report(f"    {b['bound_ms'] / ms:.3f} of the {'' if bf16 else '3xTF32 '}"
                           f"bound ({b['bound_by']}; {b['bound_bytes'] / ms / 1e9:.2f} TB/s); "
                           "two runs bit-equal"
                           + ("" if before is None else
                              f"; before the redesign{'' if bf16 else ': scalar'} {before} ms "
                              "(PERF.md)"))
                    entries["fused_morphfc_combine"][
                        ("" if bf16 else "f32_") + "x".join(map(str, shape))] = {
                        "ms": ms, "bound_ms": b["bound_ms"], "share": b["bound_ms"] / ms}
                del got
            del xh, xw, xc, x, res, args, pargs

        # LTAM forward at the serving shape (stage 0 of a 1x16x180x320
        # clip) at every slot count a clip's steps see (a slot every third
        # step: K = 1, 1, 1, 2, ..., 5, 5, 5 in each direction of stages 0
        # and 6), in f32 also at the eval tile's stage 0 (1x128x128) at every
        # slot count; f32 arithmetic on the CUDA cores: per pixel, slot and
        # tap a C-long logit and a C-long value sum
        C, heads = 112, 4
        clip_ms = clip_bound = 0.0
        sites = [((1, 184, 320), K) for K in ((1, 2, 3, 4, 5) if bf16 else (5,))]
        if not bf16:
            sites += [((1, 128, 128), K) for K in (1, 2, 3, 4, 5)]
        for (N, h, w), K in sites:
            q = torch.nn.functional.normalize(rn(N, h, w, C), dim=-1) * (C // heads) ** -0.5
            kv = rn(N, h, w, K * 2 * C, dtype=dtype)
            pe = torch.exp(rn(K, 4, 4, heads, scale=0.02))
            ms, b, _ = compare(
                "ltam_attention_2x2", (N, h, w, C, K), dtype,
                lambda: ltam_attention.ltam_attention_2x2(q, kv, pe, K=K, heads=heads),
                lambda: ltam_attention.ltam_attention_plain(q, kv, pe, K=K, heads=heads),
                dtype_check(torch.float32),  # f32 output: f32 tolerance
                primary=bf16 and K == 5,
                work=((q, kv, pe), N * h * w * K * 4 * 4 * C, "f32"))
            if bf16:
                report(f"    {b['bound_ms'] / ms:.3f} of the bound"
                       + (f"; before the redesign {LTAM_BEFORE_MS} ms (PERF.md)" if K == 5
                          else ""))
                entries["ltam_attention_2x2"][f"k{K}"] = {"ms": ms, "bound_ms": b["bound_ms"]}
                clip_ms += LTAM_STEPS_PER_K * ms
                clip_bound += LTAM_STEPS_PER_K * b["bound_ms"]
            del q, kv
        if bf16:
            report(f"    per FULL_PRESET clip ({5 * LTAM_STEPS_PER_K} launches, "
                   f"{LTAM_STEPS_PER_K} at each K): {clip_ms:.3f} ms against a bound of "
                   f"{clip_bound:.3f} ms ({clip_bound / clip_ms:.3f})")
            entries["ltam_attention_2x2"]["per_clip"] = {"ms": clip_ms, "bound_ms": clip_bound}

        # LTAM backward at the training shape (stage 0 of a 64x64 crop) at
        # every slot count a step's backward sees (12 launches at each K = 1..5,
        # as the forward's), from the forward kernel's saved out and
        # denominator; two runs bit-equal
        N, h, w = 1, 64, 64
        step_ms = step_bound = 0.0

        def bwd_check(got, want):
            return [within_max(got[0], want[0], REL_TOL[torch.float32], "dq "),
                    within_max(got[1], want[1], REL_TOL[dtype], "dkv "),
                    within_sum(got[2], want[2], dpe_terms, "dpe ")]

        for K in (1, 2, 3, 4, 5) if bf16 else (5,):
            q = torch.nn.functional.normalize(rn(N, h, w, C), dim=-1) * (C // heads) ** -0.5
            kv = rn(N, h, w, K * 2 * C, dtype=dtype)
            pe = torch.exp(rn(K, 4, 4, heads, scale=0.02))
            g = rn(N, h, w, C)
            out, den = ltam_attention.ltam_fwd(q, kv, pe, K=K, heads=heads, with_den=True)
            dpe_terms = ltam_dpe_terms(q, kv, pe, g, K, heads)
            # per pixel, slot and tap: logit, g.v and dq, C-long each; dval
            # and dkey, C-long each
            ms, b, got = compare(
                "ltam_attention_2x2_bwd", (N, h, w, C, K), dtype,
                lambda: ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, out, g,
                                                              K=K, heads=heads),
                lambda: ltam_attention.ltam_attention_bwd_plain(q, kv, pe, g, K=K,
                                                                heads=heads),
                bwd_check, primary=bf16 and K == 5,
                work=((q, kv, pe, den, out, g), N * h * w * K * 4 * 10 * C, "f32"))
            again = ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, out, g, K=K,
                                                          heads=heads)
            torch.cuda.synchronize()
            if got[1].dtype != kv.dtype or not all(torch.equal(a, b_) for a, b_ in zip(again, got)):
                raise AssertionError(f"the LTAM backward at K={K}: dkv not in kv's dtype, or "
                                     "two runs differ")
            if bf16:
                report(f"    {b['bound_ms'] / ms:.3f} of the bound; two runs bit-equal"
                       + (f"; before the redesign {LTAM_BWD_BEFORE_MS} ms (PERF.md)" if K == 5
                          else ""))
                entries["ltam_attention_2x2_bwd"][f"k{K}"] = {"ms": ms, "bound_ms": b["bound_ms"]}
                step_ms += LTAM_STEPS_PER_K * ms
                step_bound += LTAM_STEPS_PER_K * b["bound_ms"]
            del q, kv, out, den, g, got, again
        if bf16:
            report(f"    per FULL_PRESET training step ({5 * LTAM_STEPS_PER_K} launches, "
                   f"{LTAM_STEPS_PER_K} at each K): {step_ms:.3f} ms against a bound of "
                   f"{step_bound:.3f} ms ({step_bound / step_ms:.3f})")
            entries["ltam_attention_2x2_bwd"]["per_step"] = {"ms": step_ms,
                                                             "bound_ms": step_bound}

            # both LTAM kernels at the training loop's batch (phase 8: the
            # reds_full preset's clips go into N), 64x64 at K = 1..5: the
            # forward, then the backward from its out and denominator, dpe
            # against the sum of its terms over all N clips
            N = TRAIN_PRESETS["reds_full"].dataset.batch_size
            for K in (1, 2, 3, 4, 5):
                q = torch.nn.functional.normalize(rn(N, h, w, C), dim=-1) * (C // heads) ** -0.5
                kv = rn(N, h, w, K * 2 * C, dtype=dtype)
                pe = torch.exp(rn(K, 4, 4, heads, scale=0.02))
                g = rn(N, h, w, C)
                compare("ltam_attention_2x2", (N, h, w, C, K), dtype,
                        lambda: ltam_attention.ltam_attention_2x2(q, kv, pe, K=K, heads=heads),
                        lambda: ltam_attention.ltam_attention_plain(q, kv, pe, K=K, heads=heads),
                        dtype_check(torch.float32), primary=False,
                        work=((q, kv, pe), N * h * w * K * 4 * 4 * C, "f32"))
                out, den = ltam_attention.ltam_fwd(q, kv, pe, K=K, heads=heads, with_den=True)
                dpe_terms = ltam_dpe_terms(q, kv, pe, g, K, heads)
                compare("ltam_attention_2x2_bwd", (N, h, w, C, K), dtype,
                        lambda: ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, out, g,
                                                                      K=K, heads=heads),
                        lambda: ltam_attention.ltam_attention_bwd_plain(q, kv, pe, g, K=K,
                                                                        heads=heads),
                        bwd_check, primary=False,
                        work=((q, kv, pe, den, out, g), N * h * w * K * 4 * 10 * C, "f32"))
                del q, kv, out, den, g

        # LTAM at the wider heads: the forward at the few-levels serving
        # shape, the backward at its training crop
        for C, heads, K in LTAM_WIDTHS:
            d = C // heads
            for N, h, w in ((1, 128, 128), (1, 64, 64)):
                q = torch.nn.functional.normalize(rn(N, h, w, C), dim=-1) * d ** -0.5
                kv = rn(N, h, w, K * 2 * C, dtype=dtype)
                pe = torch.exp(rn(K, 4, 4, heads, scale=0.02))
                if h == 128:
                    ms, _, _ = compare(
                        "ltam_attention_2x2", (N, h, w, C, K, f"d={d}"), dtype,
                        lambda: ltam_attention.ltam_attention_2x2(q, kv, pe, K=K, heads=heads),
                        lambda: ltam_attention.ltam_attention_plain(q, kv, pe, K=K, heads=heads),
                        dtype_check(torch.float32), primary=False,
                        work=((q, kv, pe), N * h * w * K * 4 * 4 * C, "f32"))
                else:
                    g = rn(N, h, w, C)
                    out, den = ltam_attention.ltam_fwd(q, kv, pe, K=K, heads=heads, with_den=True)
                    dpe_terms = ltam_dpe_terms(q, kv, pe, g, K, heads)
                    ms, _, _ = compare(
                        "ltam_attention_2x2_bwd", (N, h, w, C, K, f"d={d}"), dtype,
                        lambda: ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, out, g,
                                                                      K=K, heads=heads),
                        lambda: ltam_attention.ltam_attention_bwd_plain(q, kv, pe, g, K=K,
                                                                        heads=heads),
                        bwd_check, primary=False,
                        work=((q, kv, pe, den, out, g), N * h * w * K * 4 * 10 * C, "f32"))
                    del g, out, den
                if dtype == torch.bfloat16:
                    name = "ltam_attention_2x2" if h == 128 else "ltam_attention_2x2_bwd"
                    entries[name][f"d{d}"] = {"ms": ms, "at": f"{N}x{h}x{w}x{C} K={K}"}
                del q, kv

        # the conv chain: a trajectory resblock (one frame, residual 0.1;
        # the serving path's shape) and the RCAB branch of a stage-0/6
        # mixer (16 frames, the pool sums), each next to the module form's
        # cuDNN convolutions
        C = 112
        for N, kw in ((1, dict(res_scale=0.1)), (16, dict(emit_psum=True))):
            h, w = 184, 320
            x = rn(N, h, w, C, dtype=dtype)
            wc = [rn(C, C, 3, 3, scale=(9 * C) ** -0.5, dtype=dtype) for _ in range(2)]
            bc = [rn(C, scale=0.1, dtype=dtype) for _ in range(2)]
            ops = (*conv_chain.pack_conv_taps(wc[0], bc[0]),
                   *conv_chain.pack_conv_taps(wc[1], bc[1]))
            wcl = [t.contiguous(memory_format=torch.channels_last) for t in wc]
            xc = x.permute(0, 3, 1, 2)  # NHWC memory: a channels-last view

            def module():  # ResidualBlockNoBN / RCAB's convs in the module form
                y = F.conv2d(F.relu(F.conv2d(xc, wcl[0], bc[0], padding=1)), wcl[1], bc[1],
                             padding=1).permute(0, 2, 3, 1)
                return x + 0.1 * y if "res_scale" in kw else y

            def chain_check(got, want):
                res = [within_max(got[0], want[0], REL_TOL[dtype])]
                if len(got) > 1:  # the sums of the kernel's own (rounded) output
                    own = got[0].float().sum(dim=(1, 2))
                    terms = got[0].float().abs().sum(dim=(1, 2))
                    res.append(within_sum(got[1], own, terms, "psum "))
                    if dtype == torch.float32:
                        res.append(within_sum(got[1], want[1], terms, "psum vs plain "))
                return res

            module_ms = cuda_ms(module, iters=5)
            extra = f"  module form {module_ms:.3f} ms"
            # two 3x3 convs, C x C, per pixel
            flops = 2 * 2 * N * h * w * 9 * C * C
            if dtype == torch.float32:  # the module form as the eval command runs it
                torch.backends.cudnn.allow_tf32 = True
                module_tf32_ms = cuda_ms(module, iters=5)
                torch.backends.cudnn.allow_tf32 = False
                extra += f" (TF32 convs {module_tf32_ms:.3f} ms), f32 bound {flops / 67e9:.3f} ms"
            ms, b, got = compare(
                "fused_conv_chain", (N, h, w, C), dtype,
                lambda: conv_chain.fused_conv_chain(x, *ops, **kw),
                lambda: conv_chain.conv_chain_plain(x, *ops, **kw),
                chain_check, primary=dtype == torch.bfloat16 and N == 1,
                work=((x, *ops), flops, peak_ffn_axes(dtype)), extra=extra,
                keys={"module_ms": module_ms})
            # the result must not depend on which block took which tile
            again = conv_chain.fused_conv_chain(x, *ops, **kw)
            again = again if isinstance(again, tuple) else (again,)
            torch.cuda.synchronize()
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError("two runs of the conv chain differ")
            before = CHAIN_BEFORE_MS.get((N, dtype))
            bf16 = dtype == torch.bfloat16
            report(f"    {flops / ms / 1e9:.1f} TFLOP/s, {b['bound_ms'] / ms:.3f} of the "
                   f"{'' if bf16 else '3xTF32 '}bound, {ms / module_ms:.3f} x the module form"
                   + ("" if bf16 else f" (TF32 off), {ms / module_tf32_ms:.3f} x (TF32 convs)")
                   + "; two runs bit-equal"
                   + ("" if before is None else
                      f"; before the redesign{'' if bf16 else ': scalar'} {before} ms (PERF.md)"))
            entries["fused_conv_chain"][("" if bf16 else "f32_") + f"n{N}"] = {
                "ms": ms, "module_ms": module_ms, "bound_ms": b["bound_ms"],
                "tflop_s": flops / ms / 1e9,
                **({} if bf16 else {"module_tf32_ms": module_tf32_ms})}
            del x, xc, ops, wc, wcl, got, again

        # the norm at every LayerNorm width of the serving path, each at the
        # rows of its first call, and RMS at 112; weights in the model dtype
        for C, rows, rms in [(C, rows, False) for C, rows in NORM_SHAPES] + [
                (*NORM_SHAPES[0], True)]:
            x = (rn(rows, C) * 1.5 + 0.5).to(dtype)
            g = (1.0 + rn(C, scale=0.2)).to(dtype)
            b = None if rms else rn(C, scale=0.1, dtype=dtype)
            eps = 1e-6 if rms else 1e-5
            lib = ((lambda: F.rms_norm(x, (C,), g, eps)) if rms else
                   (lambda: F.layer_norm(x, (C,), g, b, eps)))
            compare("fused_norm", ("rms" if rms else "ln", rows, C), dtype,
                    lambda: fused_norm.fused_norm(x, g, b, eps=eps, rms=rms),
                    lambda: fused_norm.fused_norm_plain(x, g, b, eps=eps, rms=rms),
                    dtype_check(dtype),
                    primary=dtype == torch.bfloat16 and (C, rows) == NORM_SHAPES[0] and not rms,
                    work=((x, g) + (() if b is None else (b,)), 8 * x.numel(), "f32"),
                    library=lib)
            del x

        # the pin: the trajectory step's resblock input (2C channels)
        x = rn(1, 184, 320, 224, dtype=dtype)

        def exact(got, want):
            return [within_max(got[0], want[0], 0.0)]

        ms, b, _ = compare("layout_pin", tuple(x.shape), dtype, lambda: conv_chain.layout_pin(x),
                           lambda: conv_chain.layout_pin_plain(x), exact,
                           primary=dtype == torch.bfloat16, work=((x,), 0, "f32"),
                           library=lambda: x.clone())
        report(f"    {2 * x.numel() * x.element_size() / ms / 1e6:.0f} GB/s, "
               f"{b['bound_ms'] / ms:.3f} of the bound"
               + (f"; before the redesign {PIN_BEFORE_MS} ms (PERF.md, same timer)"
                  if dtype == torch.bfloat16 else ""))
        del x
    torch.cuda.empty_cache()
    return entries


def check_probes(report, entries):
    """Phase 2p: every probe of both probe tools, called directly, counted
    from zero; then the tools' command lines.  Fills the three probe
    kernels' entries."""
    from vmg_tpu_torch.tools import exp_probe, exp_probe2
    from vmg_tpu_torch.utils.profiling import timed

    dev = torch.device("cuda")
    floor = timed(lambda: torch.cuda._sleep(0), iters=20) * 1e3
    report(f"  empty launch (torch.cuda._sleep(0)): {floor:.4f} ms, the floor under these kernels")
    primary = {"slab_copy": "exp_probe.dma_sub328_lane112",
               "smem_relayout": "exp_probe2.lane_store_cg28",
               "tile_gemm": "exp_probe2.tile_assembled_s28"}
    for name in primary:
        entries[name].update(route="cuda", max_abs_err=0.0, probes={})
    zero_counts()
    for tool in (exp_probe, exp_probe2):
        rng = np.random.default_rng(0)  # the command line's stream
        short = tool.__name__.rsplit(".", 1)[-1]
        for name, probe in tool.PROBES.items():
            r = probe(dev, rng)
            kernel = ("slab_copy" if name.startswith("dma") else
                      "tile_gemm" if name.startswith(("mm_", "tile_")) else "smem_relayout")
            e = entries[kernel]
            e["max_abs_err"] = max(e["max_abs_err"], r["maxdiff"])
            e["probes"][f"{short}.{name}"] = r
            primary_call = primary[kernel] == f"{short}.{name}"
            lib = "" if r["library_ms"] is None else f"  library {r['library_ms']:.4f} ms"
            if r.get("matmul_ms") is not None:
                lib += f" (matmul of the patch {r['matmul_ms']:.4f} ms)"
            rate = "" if r.get("tf_s") is None else f"  {r['tf_s']:.1f} TFLOP/s"
            sms = ("" if "ms_all_sms" not in r else
                   f"  on all {r['sms']} SMs {r['ms_all_sms']:.4f} ms "
                   f"({r['tf_s_all_sms']:.1f} TFLOP/s)")
            report(f"  {short}.{name:20s} {kernel:13s} maxdiff {r['maxdiff']:.3e} ok  kernel "
                   f"{r['ms']:.4f} ms{rate}  plain {r['plain_ms']:.4f} ms{lib}  bound "
                   f"{r['bound_ms']:.5f} ms ({r['bound_by']}){sms}")
            if primary_call and kernel in PROBE_BEFORE_MS:
                report(f"    {kernel}: before the redesign {PROBE_BEFORE_MS[kernel]} ms (PERF.md, "
                       f"same timer); {r['ms'] / floor:.2f} x the empty launch")
            elif kernel == "smem_relayout":
                report(f"    {r['ms'] / floor:.2f} x the empty launch")
            if primary_call:
                e.update(ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                         at=f"{short}.{name}", bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         bound_bytes=r["bytes"], bound_flops=r["flops"],
                         bound_peak="bf16 tensor cores" if r["flops"] else None)
    probe_path = read_counts()
    report(f"  launches over the probes: {probe_path}")
    missing = [k for k in primary if probe_path[k] <= 0]
    if missing:
        raise AssertionError(f"probe kernels never launched: {missing}")
    for name in primary:
        entries[name]["path_launches"] = probe_path
    for tool in (exp_probe, exp_probe2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tool.main([])
        names = [next(iter(json.loads(line))) for line in out.getvalue().splitlines()]
        report(f"  python -m {tool.__name__}: exit {rc}, {len(names)} JSON lines")
        if rc != 0 or names != list(tool.PROBES):
            raise AssertionError(f"{tool.__name__} failed: exit {rc}, lines {names}")


def launch_counts():
    """Kernel name -> (object, attribute) of its launch counter."""
    from vmg_tpu_torch.ops import (conv_chain, fused_norm, group_conv, ltam_attention,
                                   morphfc_fused, probes)
    ltam = ltam_attention.ltam_attention_2x2
    return {"fused_group_ffn": (group_conv.fused_group_ffn, "launches"),
            "fused_morphfc_axes": (morphfc_fused.fused_morphfc_axes, "launches"),
            "fused_morphfc_axes_token": (morphfc_fused.fused_morphfc_axes, "token_launches"),
            "slab_copy": (probes.slab_copy, "launches"),
            "smem_relayout": (probes.smem_relayout, "launches"),
            "tile_gemm": (probes.tile_gemm, "launches"),
            "fused_morphfc_reduce": (morphfc_fused.fused_morphfc_reduce, "launches"),
            "fused_morphfc_combine": (morphfc_fused.fused_morphfc_combine, "launches"),
            "ltam_attention_2x2": (ltam, "launches"),
            "ltam_attention_2x2_bwd": (ltam, "bwd_launches"),
            "fused_conv_chain": (conv_chain.fused_conv_chain, "launches"),
            "fused_norm": (fused_norm.fused_norm, "launches"),
            "layout_pin": (conv_chain.layout_pin, "launches")}


# the kernels of the opt-in forms: none launches in the default forms
OPT_IN = ("fused_conv_chain", "fused_norm", "layout_pin")
# the kernels on no model path: their entry points only (phases 2, 2p)
OFF_PATH = ("fused_morphfc_axes_token", "slab_copy", "smem_relayout", "tile_gemm")


def off_path_launched(counts):
    return [k for k in OFF_PATH if counts[k]]


def zero_counts():
    for obj, attr in launch_counts().values():
        setattr(obj, attr, 0)


def read_counts():
    return {name: getattr(obj, attr) for name, (obj, attr) in launch_counts().items()}


def grad_errors(grads, want, names):
    """Per parameter, max|grads - want| over max(max|want|, GRAD_FLOOR x the
    largest max|want|), and over max|want| alone: (worst floored, worst
    own, the parameter of the worst own and its max|want|, the largest
    max|want|, count over GRAD_TOL of own)."""
    peaks = [w.abs().max().item() for w in want]
    floor = GRAD_FLOOR * max(peaks)
    floored, own = [], []
    for a, w, m in zip(grads, want, peaks):
        err = (a.cpu() - w).abs().max().item()
        floored.append(err / max(m, floor))
        own.append(err / m if m > 0 else (0.0 if err == 0 else float("inf")))
    i = int(np.argmax(own))
    return (max(floored), own[i], names[i], peaks[i], max(peaks),
            sum(e > GRAD_TOL for e in own))


def train_parity(report, preset, device="cuda", frames=5):
    """Phase 5: one f32 training step's loss and gradients, on ``device``
    (kernels on the card) against the plain path on CPU tensors, and the
    plain path against itself at another CPU thread count.  Returns a dict
    of the errors."""
    from vmg_tpu_torch.configs import TrainConfig
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.train.train_step import loss_and_grads

    cfg = dataclasses.replace(preset, drop_path_rate=0.0)
    cpu_model = create_model(cfg, is_train=True, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(device)
    rng = np.random.default_rng(3)
    lrs = torch.from_numpy(rng.random((1, frames, 64, 64, 3), dtype=np.float32))
    hrs = torch.from_numpy(rng.random((1, frames, 256, 256, 3), dtype=np.float32))
    tcfg = TrainConfig(if_aux=True)
    t1 = time.time()
    loss_cpu, g_cpu = loss_and_grads(cpu_model, lrs, hrs, tcfg)
    t_cpu = time.time() - t1
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    loss_cpu2, g_cpu2 = loss_and_grads(cpu_model, lrs, hrs, tcfg)
    torch.set_num_threads(threads)
    zero_counts()
    loss_gpu, g_gpu = loss_and_grads(gpu_model, lrs.to(device), hrs.to(device), tcfg)
    counts = read_counts()
    names = [n for n, _ in cpu_model.named_parameters()]
    finite = all(bool(torch.isfinite(g).all()) for g in g_gpu)
    res = {}
    for label, loss, grads in (("kernels", loss_gpu, g_gpu), ("plain_self", loss_cpu2, g_cpu2)):
        floored, own, own_name, own_peak, peak, n_over = grad_errors(grads, g_cpu, names)
        res[label] = {"loss_rel_err": abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu)),
                      "grad_err": floored, "grad_err_own_max": own,
                      "grad_err_own_max_param": own_name, "its_max_grad": own_peak,
                      "largest_max_grad": peak, "params_over_target": n_over}
    for label, text in (("kernels", "kernels on the card"),
                        ("plain_self", f"plain at {max(1, threads // 2)} CPU threads")):
        r = res[label]
        report(f"    {text} vs plain at {threads}: loss rel err {r['loss_rel_err']:.3e}; "
               f"worst gradient error {r['grad_err']:.3e} of max(own, {GRAD_FLOOR:g} x "
               f"largest) max|plain|; of its own max {r['grad_err_own_max']:.3e} in "
               f"{r['grad_err_own_max_param']} (its max|plain| {r['its_max_grad']:.3e}, the "
               f"largest {r['largest_max_grad']:.3e}); {r['params_over_target']} of "
               f"{len(names)} parameters over {GRAD_TOL:g} of their own max")
    report(f"    tol: loss {LOSS_TOL:g}, gradients {GRAD_LIMIT:g}; LTAM launches fwd "
           f"{counts['ltam_attention_2x2']} bwd {counts['ltam_attention_2x2_bwd']}; "
           f"CPU plain step {t_cpu:.1f} s")
    k = res["kernels"]
    if not (finite and k["loss_rel_err"] <= LOSS_TOL and k["grad_err"] <= GRAD_LIMIT):
        raise AssertionError("train-step parity failed")
    if counts["ltam_attention_2x2_bwd"] <= 0:
        raise AssertionError("the parity step did not reach the LTAM backward kernel")
    del gpu_model, cpu_model
    if device != "cpu":
        torch.cuda.empty_cache()
    return res


# the evaluation phase's synthetic Vid4 clip: frames, LR size (4 tiles of
# 128 with the preset's 20-pixel overlap), under the checkout's ignored
# results/
EVAL_T, EVAL_HW = 16, (144, 176)
EVAL_PATH = ("fused_group_ffn", "fused_morphfc_axes", "fused_morphfc_reduce",
             "fused_morphfc_combine", "ltam_attention_2x2")


def eval_phases(report, err_bf16):
    """Phases 7a-7c; returns the record for the JSON line."""
    import shutil

    from vmg_tpu_torch.configs import EVAL_PRESETS, TINY_TEST_PRESET
    from vmg_tpu_torch.ckpt import load_reference_checkpoint, reference_state_dict
    from vmg_tpu_torch.eval import load_model, make_forwards, run_eval
    from vmg_tpu_torch.eval.eval_utils import read_image
    from vmg_tpu_torch.eval.inference import SlidingEvaluator
    from vmg_tpu_torch.eval.png import write_png
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.serve import SRServer

    root = os.path.dirname(os.path.abspath(__file__))
    report("[7a] reference checkpoint tests/fixtures/ref_tiny_mine.pth through the port's "
           "converter: f32 forward 1x4x64x64, kernels on the card vs plain versions on CPU "
           f"tensors (tol {SLICE_TOL})")
    sd = reference_state_dict(load_reference_checkpoint(
        os.path.join(root, "tests", "fixtures", "ref_tiny_mine.pth")))
    cpu_model = create_model(TINY_TEST_PRESET, device="cpu")
    cpu_model.load_state_dict(sd, strict=True)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(np.random.default_rng(11).random((1, 4, 64, 64, 3), dtype=np.float32))
    zero_counts()
    with torch.inference_mode():
        want, got = cpu_model(x), gpu_model(x.cuda()).cpu()
    counts = read_counts()
    err_7a = (got - want).abs().max().item()
    report(f"    {len(sd)} tensors; max_abs_err={err_7a:.3e}; launches {counts}")
    if not (torch.isfinite(got).all() and err_7a <= SLICE_TOL and counts["fused_group_ffn"] > 0
            and counts["ltam_attention_2x2"] > 0):
        raise AssertionError("the reference checkpoint's forward on the card failed")
    del cpu_model, gpu_model

    cfg = copy.deepcopy(EVAL_PRESETS["vid4"])
    h, w = EVAL_HW
    tree = os.path.join(root, "results", "chip_smoke_eval")
    shutil.rmtree(tree, ignore_errors=True)
    lr_root = os.path.join(tree, "Vid4", "LR", "X4")
    rng = np.random.default_rng(3)
    gt = rng.integers(30, 226, (EVAL_T, 4 * h, 4 * w, 3)).astype(np.uint8)
    lr = gt.reshape(EVAL_T, h, 4, w, 4, 3).mean(axis=(2, 4)).round().astype(np.uint8)
    for sub, frames in ((lr_root, lr), (os.path.join(tree, "Vid4", "GT"), gt)):
        os.makedirs(os.path.join(sub, "clip000"))
        for i, f in enumerate(frames):
            write_png(os.path.join(sub, "clip000", f"{i:08d}.png"), f)
    cfg.dataset.gt_root = None  # the name dispatch: LR/X4 -> GT
    model = load_model(cfg, "random", "cuda")
    results = {}
    for tiles in ("host", "device"):
        cfg.path.output_dir = os.path.join(tree, f"out_{tiles}")
        report(f"[7b] eval: Vid4 preset, FULL_PRESET f32 erf "
               f"GELU, seeded random weights, 1 clip of {EVAL_T} x {h}x{w} LR -> "
               f"{4 * h}x{4 * w}, 4 tiles of 1x{EVAL_T}x128x128, {tiles}-tiled")
        zero_counts()
        t1 = time.time()
        res = run_eval(cfg, model=model, lr_root=lr_root, device_tiles=tiles == "device")
        dt = time.time() - t1
        counts = read_counts()
        pngs = sorted(os.listdir(os.path.join(cfg.path.output_dir, "clip000")))
        outs = np.stack([read_image(os.path.join(cfg.path.output_dir, "clip000", f))
                         for f in pngs if f.endswith(".png")])
        psnr, psnr_y, ssim, ssim_y, fps = res["dataset"]
        report(f"    PSNR {psnr:.4f} PSNR-Y {psnr_y:.4f} SSIM {ssim:.5f} SSIM-Y {ssim_y:.5f}; "
               f"FPS {fps:.3f} (evaluate_fps: one timed forward of the clip); {dt:.1f} s in "
               f"all; {outs.shape[0]} PNGs {outs.shape[1:]}; launches {counts}")
        if outs.shape != (EVAL_T, 4 * h, 4 * w, 3) or not all(
                np.isfinite(v) for v in res["dataset"][:4]):
            raise AssertionError(f"eval ({tiles} tiles): bad outputs {outs.shape} or scores")
        missing = [k for k in EVAL_PATH if counts[k] <= 0]
        if missing:
            raise AssertionError(f"eval ({tiles} tiles) never launched {missing}")
        results[tiles] = {"outs": outs, "res": res, "s": dt, "launches": counts}
    diff = np.abs(results["host"]["outs"].astype(int) - results["device"]["outs"].astype(int))
    forward_fn, device_tiled_fn = make_forwards(model, cfg, device_tiles=True)
    clip = lr.astype(np.float32)[None] / 255.0

    # one tile of the clip at the evaluator's own shape: the model's
    # forward as the evaluator calls it, kernels on the card (TF32 off, as
    # phase 3) against the plain versions on CPU tensors, same weights
    th, tw = cfg.dataset.wins
    tile = clip[:, :, :th, :tw]
    cpu_model = load_model(cfg, "random", "cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_fn, _ = make_forwards(cpu_model, cfg)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    zero_counts()
    got_tile = forward_fn(tile)
    tile_counts = read_counts()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    t1 = time.time()
    want_tile = cpu_fn(tile)
    t_cpu = time.time() - t1
    err_tile = float(np.abs(got_tile - want_tile).max())
    report(f"    one tile 1x{EVAL_T}x{th}x{tw} (f32, TF32 off), kernels on the card vs plain "
           f"versions on CPU tensors: max_abs_err={err_tile:.3e} (tol {SLICE_TOL}); CPU plain "
           f"path {t_cpu:.1f} s; launches {tile_counts}")
    missing = [k for k in EVAL_PATH if tile_counts[k] <= 0]
    if not (np.isfinite(got_tile).all() and got_tile.shape == want_tile.shape
            and err_tile <= SLICE_TOL) or missing:
        raise AssertionError(f"the eval tile's forward on the card failed (never launched "
                             f"{missing})")
    del cpu_model, cpu_fn
    host = SlidingEvaluator(forward_fn, spatial_wins=cfg.dataset.wins,
                            overlapped_spatial_length=cfg.dataset.overlapped_spatial_length)
    f32_out = host.test_image(clip)
    err_tiles = np.abs(device_tiled_fn(clip) - f32_out).max()
    report(f"    host vs device tiles: float max_abs_err={err_tiles:.3e} (tol {SLICE_TOL}), "
           f"PNGs at most {diff.max()} LSB apart")
    if not (err_tiles <= SLICE_TOL and diff.max() <= 1):
        raise AssertionError("the device-tiled eval differs from the host-tiled one")

    report("[7c] the same clip and protocol over SRServer (bf16, tanh GELU, fast flow)")
    sd_eval = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    server = SRServer(cfg.network, sd_eval, "cuda", torch.bfloat16, gelu="tanh", fast_flow=True)
    ev = SlidingEvaluator(server, spatial_wins=cfg.dataset.wins,
                          overlapped_spatial_length=cfg.dataset.overlapped_spatial_length,
                          dataset_name=cfg.dataset.name, test_num_frames=cfg.dataset.num_frames)
    zero_counts()
    bf16_out = ev.test_image(clip)
    err_7c = np.abs(bf16_out - f32_out).max()
    _, fps_bf16 = ev.evaluate_fps(lr, gt)
    counts = read_counts()
    report(f"    bf16 vs 7b's f32 output: max_abs_err={err_7c:.3e} (tol {KFORM_RATIO:g} x phase "
           f"4's bf16 error at 1x2x64x64, {err_bf16:.3e}); FPS {fps_bf16:.3f}; launches {counts}")
    if not (np.isfinite(bf16_out).all() and err_7c <= KFORM_RATIO * err_bf16):
        raise AssertionError("bf16 eval is further from the f32 eval than phase 4 allows")
    del server
    torch.cuda.empty_cache()
    shutil.rmtree(tree, ignore_errors=True)
    return {"eval_f32": {k: {"dataset": v["res"]["dataset"], "s": v["s"]}
                         for k, v in results.items()},
            "eval_tiles_max_abs_err": float(err_tiles), "eval_bf16_err": float(err_7c),
            "eval_bf16_fps": fps_bf16, "fixture_max_abs_err": err_7a,
            "eval_tile_max_abs_err": err_tile, "eval_tile_cpu_s": t_cpu,
            "launches": results["host"]["launches"]}


# phase 8: the synthetic packed REDS tree -- clips x frames of 720x1280
# HR (REDS's frame size), LR by the port's imresize_matlab on the card --
# under the checkout's ignored results/, removed after the phase; the
# trainer's steps a run (the first a warm-up, outside the step median); the
# loader alone: its one-batch epochs at the preset's expand ratio (a
# restart each), then one epoch of LOADER_STEADY_RATIO x the clips
TRAIN_CLIPS, TRAIN_CLIP_FRAMES, REDS_HW = 2, 100, (720, 1280)
TRAIN_STEPS, LOADER_EPOCHS, LOADER_STEADY_RATIO = 4, 8, 16


class _StepCounts:
    """A trainer hook: the LTAM launches of every update, from the counters."""

    def __init__(self):
        self.per_step = []
        self._last = (0, 0)

    def after_iter(self, step, state, extras):
        now = read_counts()
        now = (now["ltam_attention_2x2"], now["ltam_attention_2x2_bwd"])
        self.per_step.append((now[0] - self._last[0], now[1] - self._last[1]))
        self._last = now


def write_reds_tree(root):
    """The seeded synthetic packed tree (HR uint8 noise on the card, LR =
    imresize_matlab(HR / 255, 1/4) rounded to uint8); returns (hr, lr)."""
    from vmg_tpu_torch.data.storage import PackedWriter
    from vmg_tpu_torch.ops.resize import imresize_matlab

    hr_root, lr_root = os.path.join(root, "hr.pack"), os.path.join(root, "lr.pack")
    Hh, Wh = REDS_HW
    hw = PackedWriter(hr_root, (Hh, Wh, 3))
    lw = PackedWriter(lr_root, (Hh // 4, Wh // 4, 3))
    gen = torch.Generator(device="cuda").manual_seed(8)
    for c in range(TRAIN_CLIPS):
        key = f"{c:03d}"
        for f0 in range(0, TRAIN_CLIP_FRAMES, 25):
            hr = torch.randint(0, 256, (25, Hh, Wh, 3), generator=gen, device="cuda",
                               dtype=torch.uint8)
            lr = imresize_matlab(hr.float() / 255.0, 0.25)
            lr = (lr * 255.0).round().clamp(0, 255).to(torch.uint8)
            for i, (h, l) in enumerate(zip(hr.cpu().numpy(), lr.cpu().numpy())):
                hw.add(f"{key}_{f0 + i}", h, clip_key=key)
                lw.add(f"{key}_{f0 + i}", l, clip_key=key)
    hw.close()
    lw.close()
    return hr_root, lr_root


def train_loop_phase(report, smi, kind, phase6):
    """Phase 8 (main path 7): ``python -m vmg_tpu_torch.tools.train --config
    reds_full``'s function on a synthetic packed tree; returns (record,
    the kernel launches of its first run)."""
    import shutil

    from vmg_tpu_torch.configs import TRAIN_PRESETS
    from vmg_tpu_torch.data import native
    from vmg_tpu_torch.data.clip_dataset import create_dataset
    from vmg_tpu_torch.data.loader import create_dataloader
    from vmg_tpu_torch.data.sampler import IterSampler
    from vmg_tpu_torch.tools.train import train

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results",
                        "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t1 = time.time()
        hr_root, lr_root = write_reds_tree(root)
        nbytes = sum(os.path.getsize(os.path.join(d, "data.bin")) for d in (hr_root, lr_root))
        report(f"    tree: {TRAIN_CLIPS} clips x {TRAIN_CLIP_FRAMES} frames, HR {REDS_HW[0]}x"
               f"{REDS_HW[1]}, LR by imresize_matlab on the card, {nbytes / 2**20:.0f} MiB, "
               f"written in {time.time() - t1:.1f} s")
        cfg = copy.deepcopy(TRAIN_PRESETS["reds_full"])
        cfg.dataset.dataroot_HR, cfg.dataset.dataroot_LR = hr_root, lr_root
        cfg.dataset.cache_keys = None
        cfg.path.experiments_root = os.path.join(root, "experiments")
        cfg.logger.save_checkpoint_freq = TRAIN_STEPS
        T_ = cfg.dataset.num_frames

        # the first loader batch: native assembly bit-equal to the numpy path
        dataset = create_dataset(cfg.dataset, cfg.scale)
        loader = create_dataloader(dataset, cfg.dataset)
        first = list(iter(loader.sampler))[: cfg.dataset.batch_size]
        nat = dataset.get_batch(first)
        dataset.use_native = False
        plain = [dataset[i] for i in first]
        bit_equal = all(np.array_equal(nat[k], np.stack([p[k] for p in plain]))
                        for k in ("LRs", "HRs"))
        report(f"    first batch {first}: native assembly bit-equal to the numpy path: "
               f"{bit_equal}; LRs {nat['LRs'].shape}, HRs {nat['HRs'].shape}")
        if not bit_equal:
            raise AssertionError("the native batch differs from the numpy path's")
        # the loader alone (pinned, as the trainer runs it): the preset's
        # one-batch epochs, each a restart of its workers, then steady
        # batches -- one epoch of LOADER_STEADY_RATIO x the clips, timed
        # from its first batch on
        loader = create_dataloader(create_dataset(cfg.dataset, cfg.scale), cfg.dataset,
                                   pin_memory=True)
        t1 = time.perf_counter()
        n_batches = 0
        for epoch in range(LOADER_EPOCHS):
            loader.dataset.set_epoch(epoch)
            loader.sampler.set_epoch(epoch)
            n_batches += sum(1 for _ in loader)
        restart_bps = n_batches / (time.perf_counter() - t1)
        steady = create_dataloader(loader.dataset, cfg.dataset, pin_memory=True, sampler=IterSampler(
            len(loader.dataset), ratio=LOADER_STEADY_RATIO, seed=cfg.dataset.pre_seed or 0))
        n_steady = -1
        for _ in steady:
            if n_steady < 0:
                t1 = time.perf_counter()
            n_steady += 1
        steady_bps = n_steady / (time.perf_counter() - t1)
        report(f"    loader alone: {n_batches} one-batch epochs of {cfg.dataset.batch_size} clips "
               f"(a restart each) {restart_bps:.2f} batches/s; steady, {n_steady} batches after "
               f"the first of a {n_steady + 1}-batch epoch: {steady_bps:.2f} batches/s (pinned)")

        batch = cfg.dataset.batch_size
        shutil.rmtree(cfg.path.experiments_root, ignore_errors=True)
        hook = _StepCounts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.calls = 0
        zero_counts()
        try:
            rec = train(cfg, max_steps=TRAIN_STEPS, max_retries=0, device="cuda", hooks=[hook])
        except torch.OutOfMemoryError as e:
            raise AssertionError(f"reds_full's batch {batch} does not fit the card") from e
        launches = read_counts()
        assembled = native.calls
        peak = torch.cuda.max_memory_allocated()
        zero_counts()
        hook2 = _StepCounts()
        rec2 = train(cfg, resume=True, max_steps=2 * TRAIN_STEPS, max_retries=0, device="cuda",
                     hooks=[hook2])
        losses = rec["losses"] + rec2["losses"]
        steps_ms = rec["step_ms"] + rec2["step_ms"]
        timed_ms = rec["step_ms"][1:] + rec2["step_ms"][1:]  # each run's first: a warm-up
        waits = [w * 1e3 for w in rec["data_wait_s"] + rec2["data_wait_s"]]
        grad_acc = rec["grad_acc"]
        per_step = hook.per_step + hook2.per_step
        want = (phase6["ltam_fwd_launches_per_step"] * grad_acc,
                phase6["ltam_bwd_launches_per_step"] * grad_acc)
        med = float(np.median(timed_ms))
        frames = batch * grad_acc * T_
        out = {"preset": "reds_full", "batch": batch, "grad_acc": grad_acc,
               "frames": T_, "crop": cfg.dataset.crop_size, "steps": rec["steps"] + rec2["steps"],
               "losses": losses, "resumed_from": rec2["start_step"],
               "epochs": [rec["epochs"], rec2["epochs"]],
               "step_ms_median": med, "step_ms_min": min(timed_ms),
               "step_ms_max": max(timed_ms), "step_ms": steps_ms,
               "warmup_step_ms": [rec["step_ms"][0], rec2["step_ms"][0]],
               "data_wait_ms_median": float(np.median(waits)), "data_wait_ms_max": max(waits),
               "data_wait_ms": waits, "frames_per_s": frames / (med / 1e3),
               "peak_bytes": peak, "loader_restart_batches_per_s": restart_bps,
               "loader_steady_batches_per_s": steady_bps,
               "assemble_batch_calls": assembled, "ltam_launches_per_step": per_step,
               "card": smi}
        report(f"    batch {batch}, grad_acc {grad_acc}, T={T_}, {cfg.dataset.crop_size}x"
               f"{cfg.dataset.crop_size} HR crops: steps {out['steps']}, resumed from step "
               f"{rec2['start_step']}; losses {[round(v, 6) for v in losses]}")
        report(f"    step {med:.1f} ms median ({min(timed_ms):.1f}-{max(timed_ms):.1f}) over "
               f"{len(timed_ms)} steps after each run's warm-up step ({rec['step_ms'][0]:.1f}, "
               f"{rec2['step_ms'][0]:.1f}), data wait {out['data_wait_ms_median']:.3f} ms "
               f"median (max {max(waits):.3f}) a batch, {out['frames_per_s']:.3f} frames/s, "
               f"peak allocated {peak / 2**30:.2f} GiB; assemble_batch calls {assembled}; LTAM "
               f"launches a step {per_step} (phase 6 x grad_acc: {want}); {kind}; card {smi}")
        if not all(np.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite training-loop loss: {losses}")
        if any(s != want for s in per_step) or len(per_step) != 2 * TRAIN_STEPS:
            raise AssertionError(f"LTAM launches a step {per_step}, expected {want} on each")
        if assembled <= 0:
            raise AssertionError("the training loop never called assemble_batch")
        if rec2["start_step"] != TRAIN_STEPS or rec2["end_step"] != 2 * TRAIN_STEPS:
            raise AssertionError(f"resume: started at {rec2['start_step']}, ended at "
                                 f"{rec2['end_step']}")
        if rec["epochs"] < 2:
            raise AssertionError("the first run did not cross an epoch")
        report(f"[8b] python -m vmg_tpu_torch.tools.train --multihost's function: phase 8's "
               f"first {TRAIN_STEPS} steps in a one-process NCCL group")
        out["multihost"] = multihost_phase(report, cfg, root, rec["losses"], smi, kind)
        return out, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's kernels need one",
              file=sys.stderr)
        return 1
    from vmg_tpu_torch import _build
    from vmg_tpu_torch.configs import FEW_LEVELS_PRESET, FULL_PRESET
    from vmg_tpu_torch.models.blocks import MlpCnn
    from vmg_tpu_torch.models.vmg import KERNEL_FORMS, create_model
    from vmg_tpu_torch.ops.resize import upsample_trilinear_frames
    from vmg_tpu_torch.serve import SRServer
    from vmg_tpu_torch.train.__main__ import run as train_run

    def report(msg):
        print(msg, flush=True)

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    report(f"[1] card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    _build.load_library()
    report(f"[1] kernels built and loaded in {time.time() - t0:.1f} s")

    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report("[2] kernels vs plain versions on the card (tol: f32 "
           f"{REL_TOL[torch.float32]}, bf16 {REL_TOL[torch.bfloat16]} of max|plain|; "
           f"f32 sums {SUM_TOL:g} of the sum of |terms|)")
    entries = check_kernels(report)
    report(f"[2] the FFN's per-(frame, channel) output sums vs float64 (f32 held to {SUM_TOL:g} "
           "of sum|terms|; bf16 a record)")
    entries["fused_group_ffn"]["output_sums"] = ffn_sums_check(report)
    report("[2p] probes: both probe tools' kernels vs plain versions on the card (copies "
           "bit-exact, products within 1 bf16 ulp of max|plain|)")
    check_probes(report, entries)

    report("[3] slice parity: FULL_PRESET f32 1x2x64x64, kernels on the card vs "
           "plain versions on CPU tensors, same weights")
    sd = create_model(FULL_PRESET, device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()
    cpu_model = create_model(FULL_PRESET, device="cpu")
    cpu_model.load_state_dict(sd)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(np.random.default_rng(1).random((1, 2, 64, 64, 3), dtype=np.float32))
    with torch.inference_mode():
        t1 = time.time()
        want = cpu_model(x)
        t_cpu = time.time() - t1
        got = gpu_model(x.cuda()).cpu()
    err = (got - want).abs().max().item()
    net = (want - upsample_trilinear_frames(x, 4)).abs().max().item()
    report(f"    max_abs_err={err:.3e} (tol {SLICE_TOL}); network part max |out - "
           f"trilinear| = {net:.3e}; CPU plain path {t_cpu:.1f} s")
    if not (torch.isfinite(got).all() and err <= SLICE_TOL):
        raise AssertionError("slice parity failed")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()

    report("[3b] kernel forms, FULL_PRESET f32 1x2x64x64 on the card: rcab/traj conv "
           f"'kernel' vs phase 3's plain output (tol {SLICE_TOL}); 'barrier' and "
           f"'barrier_out' vs the default forms (tol {BARRIER_TOL:g} of max|out|)")
    for forms in (KERNEL_FORMS, dict(traj_conv_impl="barrier"),
                  dict(traj_conv_impl="barrier_out")):
        model = create_model(FULL_PRESET, device="cuda", **forms)
        model.load_state_dict(sd)
        zero_counts()
        with torch.inference_mode():
            out_k = model(x.cuda()).cpu()
        counts = {k: v for k, v in read_counts().items() if k in OPT_IN}
        barrier = "traj_conv_impl" in forms and len(forms) == 1
        ref, tol = (got, BARRIER_TOL * got.abs().max().item()) if barrier else (want, SLICE_TOL)
        e = (out_k - ref).abs().max().item()
        report(f"    {forms}: max_abs_err={e:.3e} (tol {tol:.3e}); launches {counts}")
        need = "layout_pin" if barrier else "fused_conv_chain"
        if not (torch.isfinite(out_k).all() and e <= tol and counts[need] > 0):
            raise AssertionError(f"kernel-form slice parity failed for {forms}")
        del model
    torch.cuda.empty_cache()

    report("[3c] slice parity: FEW_LEVELS_PRESET f32 1x2x64x64, kernels on the card vs "
           "plain versions on CPU tensors, same weights")
    sd_few = create_model(FEW_LEVELS_PRESET, device="cpu",
                          generator=torch.Generator().manual_seed(0)).state_dict()
    cpu_model = create_model(FEW_LEVELS_PRESET, device="cpu")
    cpu_model.load_state_dict(sd_few)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    zero_counts()
    with torch.inference_mode():
        t1 = time.time()
        want_few = cpu_model(x)
        t_cpu = time.time() - t1
        got_few = gpu_model(x.cuda()).cpu()
    counts = read_counts()
    err_few = (got_few - want_few).abs().max().item()
    report(f"    max_abs_err={err_few:.3e} (tol {SLICE_TOL}); CPU plain path {t_cpu:.1f} s; "
           f"launches {counts}")
    if not (torch.isfinite(got_few).all() and err_few <= SLICE_TOL):
        raise AssertionError("few-levels slice parity failed")
    if min(counts[k] for k in FEW_PATH) <= 0:
        raise AssertionError(f"the few-levels slice missed a kernel of {FEW_PATH}")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()

    report("[4] serving: SRServer FULL_PRESET bf16 (tanh GELU, fast flow), "
           f"1x{T}x{H}x{W}")
    server = SRServer(FULL_PRESET, sd, "cuda", torch.bfloat16, gelu="tanh",
                      fast_flow=True)
    small = server(x.numpy())
    err_bf16 = float(np.abs(small - got.numpy()).max())
    report(f"    bf16 vs f32 at 1x2x64x64: max_abs_diff={err_bf16:.3e} (informational; "
           "phase 7c's yardstick)")
    rng = np.random.default_rng(0)
    warm = rng.random((1, T, H, W, 3), dtype=np.float32)
    clips = [rng.random((1, T, H, W, 3), dtype=np.float32) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.time()
    out = server(warm)
    report(f"    warm-up request {time.time() - t1:.2f} s")
    reps = 3
    per_request = []
    t1 = time.time()
    for _ in range(reps):
        for c in clips:
            t2 = time.time()
            out = server(c)
            per_request.append(T / (time.time() - t2))
    dt = time.time() - t1
    serving_launches = read_counts()
    fps = T * reps * len(clips) / dt
    peak = torch.cuda.max_memory_allocated()
    report(f"    {fps:.3f} frames/s ({dt / (reps * len(clips)):.3f} s per clip, host "
           f"clock, numpy in/out); per request median {np.median(per_request):.3f}, "
           f"range {min(per_request):.3f}-{max(per_request):.3f} frames/s; peak "
           f"allocated {peak / 2**30:.2f} GiB; {kind}; card {smi}")
    report(f"    launches over the serving run: {serving_launches}")
    ffns = [m.fc2.out_features for m in server.model.modules() if isinstance(m, MlpCnn)]
    clips_run = 1 + reps * len(clips)
    report(f"    FFN: {len(ffns)} a clip at C in {sorted(set(ffns))}, "
           f"{serving_launches['fused_group_ffn'] / clips_run:g} kernel launches a clip")
    if len(ffns) != FFN_PER_CLIP or serving_launches["fused_group_ffn"] != FFN_PER_CLIP * clips_run:
        raise AssertionError(f"FFN kernel launches {serving_launches['fused_group_ffn']} over "
                             f"{clips_run} clips, expected {FFN_PER_CLIP} a clip")
    if out.shape != (1, T, 4 * H, 4 * W, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad serving output {out.shape}")
    missing = [k for k, v in serving_launches.items()
               if v <= 0 and k != "ltam_attention_2x2_bwd" and k not in OPT_IN + OFF_PATH]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    if any(serving_launches[k] for k in OPT_IN) or off_path_launched(serving_launches):
        raise AssertionError("the default serving forms launched an opt-in or off-path kernel")
    spynet_per_level = spynet_ms(server.model, T, H, W)
    del server
    torch.cuda.empty_cache()

    report("[4d] serving with flow_levels='shared' (SPyNet at level 0 only, its flow pooled "
           f"down): phase 3's f32 1x2x64x64 parity (tol {SLICE_TOL}), then SRServer FULL_PRESET "
           f"bf16 at 1x{T}x{H}x{W} beside phase 4")
    shared_cfg = dataclasses.replace(FULL_PRESET, flow_levels="shared")
    cpu_model = create_model(shared_cfg, device="cpu")
    cpu_model.load_state_dict(sd)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    with torch.inference_mode():
        want_sh = cpu_model(x)
        got_sh = gpu_model(x.cuda()).cpu()
    err_sh = (got_sh - want_sh).abs().max().item()
    report(f"    f32 1x2x64x64 kernels on the card vs the plain path on CPU tensors: "
           f"max_abs_err={err_sh:.3e} (tol {SLICE_TOL}); per_level's phase 3 {err:.3e}")
    if not (torch.isfinite(got_sh).all() and err_sh <= SLICE_TOL):
        raise AssertionError("flow_levels='shared' slice parity failed")
    del cpu_model, gpu_model
    server = SRServer(FULL_PRESET, sd, "cuda", torch.bfloat16, gelu="tanh", fast_flow=True,
                      flow_levels="shared")
    out = server(warm)
    zero_counts()
    per_request_sh = []
    t1 = time.time()
    for c in clips:
        t2 = time.time()
        out = server(c)
        per_request_sh.append(T / (time.time() - t2))
    dt_sh = time.time() - t1
    shared_launches = read_counts()
    fps_sh = T * len(clips) / dt_sh
    spynet_shared = spynet_ms(server.model, T, H, W)
    report(f"    {fps_sh:.3f} frames/s ({dt_sh / len(clips):.3f} s per clip, host clock, numpy "
           f"in/out; per_level {fps:.3f}); per request {[round(v, 3) for v in per_request_sh]}; "
           f"flow pyramid device ms: shared {spynet_shared:.3f}, per_level {spynet_per_level:.3f} "
           f"(CUDA events, median of 5); launches {shared_launches}; {kind}; card {smi}")
    if out.shape != (1, T, 4 * H, 4 * W, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad flow_levels='shared' serving output {out.shape}")
    missing = [k for k, v in shared_launches.items()
               if v <= 0 and k != "ltam_attention_2x2_bwd" and k not in OPT_IN + OFF_PATH]
    if missing:
        raise AssertionError(f"kernels never launched serving flow_levels='shared': {missing}")
    del server
    torch.cuda.empty_cache()

    report("[4b] serving in the kernel forms (rcab, traj conv, norm 'kernel'): same "
           f"weights and clips, 1x{T}x{H}x{W}")
    server = SRServer(FULL_PRESET, sd, "cuda", torch.bfloat16, gelu="tanh",
                      fast_flow=True, **KERNEL_FORMS)
    small_k = server(x.numpy())
    err_default = np.abs(small - want.numpy()).max()
    err_kernel = np.abs(small_k - want.numpy()).max()
    report(f"    bf16 vs phase 3's f32 plain output at 1x2x64x64: kernel forms "
           f"max_abs_err={err_kernel:.3e}, default forms {err_default:.3e} (tol: kernel <= "
           f"{KFORM_RATIO:g} x default)")
    if not (np.isfinite(small_k).all() and err_kernel <= KFORM_RATIO * err_default):
        raise AssertionError("kernel-form bf16 serving is further from the f32 output")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.time()
    out = server(warm)
    warm_counts = read_counts()
    report(f"    warm-up request {time.time() - t1:.2f} s; launches {warm_counts}")
    per_clip = {"fused_conv_chain": CHAIN_PER_CLIP, "fused_norm": NORM_PER_CLIP,
                "layout_pin": 0}
    if any(warm_counts[k] != v for k, v in per_clip.items()):
        raise AssertionError(f"kernel-form launches per clip {warm_counts}, expected {per_clip}")
    zero_counts()
    per_request_k = []
    t1 = time.time()
    for c in clips:
        t2 = time.time()
        out = server(c)
        per_request_k.append(T / (time.time() - t2))
    dt_k = time.time() - t1
    kernel_launches = read_counts()
    fps_k = T * len(clips) / dt_k
    peak_k = torch.cuda.max_memory_allocated()
    report(f"    {fps_k:.3f} frames/s ({dt_k / len(clips):.3f} s per clip, host clock, numpy "
           f"in/out; default forms {fps:.3f}); per request median "
           f"{np.median(per_request_k):.3f}, range {min(per_request_k):.3f}-"
           f"{max(per_request_k):.3f} frames/s; peak allocated {peak_k / 2**30:.2f} GiB "
           f"(default {peak / 2**30:.2f}); {kind}; card {smi}")
    report(f"    launches over the {len(clips)} clips: {kernel_launches}")
    if out.shape != (1, T, 4 * H, 4 * W, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad kernel-form serving output {out.shape}")
    if off_path_launched(warm_counts) or off_path_launched(kernel_launches):
        raise AssertionError("kernel-form serving launched an off-path kernel")
    del server
    barrier_launches = {}
    for impl in ("barrier", "barrier_out"):
        server = SRServer(FULL_PRESET, sd, "cuda", torch.bfloat16, gelu="tanh",
                          fast_flow=True, traj_conv_impl=impl)
        zero_counts()
        t1 = time.time()
        out = server(clips[0])
        barrier_launches[impl] = read_counts()
        report(f"    traj_conv_impl={impl!r}: one request {time.time() - t1:.2f} s (its first); "
               f"launches {barrier_launches[impl]}")
        pins = barrier_launches[impl]["layout_pin"]
        if not np.isfinite(out).all() or pins != PIN_PER_CLIP or \
                off_path_launched(barrier_launches[impl]):
            raise AssertionError(f"{impl}: {pins} pins per clip, expected {PIN_PER_CLIP}")
        del server
    torch.cuda.empty_cache()

    few_eval = dataclasses.replace(FEW_LEVELS_PRESET, **FEW_EVAL)
    d_few = few_eval.embed_dim[0] // few_eval.traj_heads[0]
    report(f"[4c] serving the few-levels model: SRServer FEW_LEVELS_PRESET with the eval "
           f"preset's {FEW_EVAL}, bf16, 1x{FEW_T}x{FEW_HW}x{FEW_HW} clips (LTAM head width "
           f"{d_few}, FFN groups {few_eval.n_groups})")
    server = SRServer(few_eval, sd_few, "cuda", torch.bfloat16, gelu="tanh", fast_flow=True)
    few_clips = [rng.random((1, FEW_T, FEW_HW, FEW_HW, 3), dtype=np.float32) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    out = server(few_clips[0])
    report(f"    warm-up request {time.time() - t1:.2f} s")
    zero_counts()
    per_request_few = []
    t1 = time.time()
    for c in few_clips[1:]:
        t2 = time.time()
        out = server(c)
        per_request_few.append(FEW_T / (time.time() - t2))
    dt_few = time.time() - t1
    few_launches = read_counts()
    fps_few = FEW_T * (len(few_clips) - 1) / dt_few
    peak_few = torch.cuda.max_memory_allocated()
    report(f"    {fps_few:.3f} frames/s ({dt_few / (len(few_clips) - 1):.3f} s per clip, host "
           f"clock, numpy in/out); per request {[round(v, 3) for v in per_request_few]} "
           f"frames/s; peak allocated {peak_few / 2**30:.2f} GiB; {kind}; card {smi}")
    report(f"    launches over the {len(few_clips) - 1} clips: {few_launches}")
    if out.shape != (1, FEW_T, 4 * FEW_HW, 4 * FEW_HW, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad few-levels serving output {out.shape}")
    missing = [k for k in FEW_PATH if few_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched serving the few-levels model: {missing}")
    if few_launches["fused_group_ffn"] != FEW_FFN_PER_CLIP * (len(few_clips) - 1):
        raise AssertionError(f"few-levels FFN kernel launches {few_launches['fused_group_ffn']}, "
                             f"expected {FEW_FFN_PER_CLIP} a clip")
    del server
    torch.cuda.empty_cache()

    report(f"[5] train-step parity: FULL_PRESET f32 1x5x64x64, drop_path 0, TF32 off, "
           f"kernels on the card vs plain versions on CPU tensors, same weights")
    parity = train_parity(report, FULL_PRESET)

    # the trainer as a user runs it: PyTorch's default TF32 settings
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    iters = 6
    report(f"[6] training: FULL_PRESET bf16 + f32 masters, remat, B=1 T=16 64x64 "
           f"crops, if_aux, seeded data; 1 warm-up + {iters} timed steps")
    zero_counts()
    rec = train_run(preset="full", batch=1, frames=16, crop=64, iters=iters,
                    grad_acc=1, remat=True, device="cuda")
    train_launches = read_counts()
    report(f"    step {rec['step_ms_median']:.1f} ms median ({rec['step_ms_min']:.1f}-"
           f"{rec['step_ms_max']:.1f}), {rec['frames_per_s']:.3f} frames/s, peak "
           f"allocated {rec['peak_bytes'] / 2**30:.2f} GiB, losses "
           f"{rec['loss_first']:.6f} (warm-up) .. {rec['loss_last']:.6f}; {kind}; card {smi}")
    report(f"    launches over the {iters} timed steps: {train_launches}")
    losses = [rec["loss_first"], *rec["losses"]]
    if not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    missing = [k for k in ("ltam_attention_2x2", "ltam_attention_2x2_bwd")
               if train_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the training path: {missing}")
    if any(train_launches[k] for k in OPT_IN) or off_path_launched(train_launches):
        raise AssertionError("the default training forms launched an opt-in or off-path kernel")

    iters_k = 2
    report(f"[6b] training with norm_impl='kernel': as phase 6, 1 warm-up + {iters_k} "
           "timed steps")
    zero_counts()
    rec_k = train_run(preset="full", batch=1, frames=16, crop=64, iters=iters_k,
                      grad_acc=1, remat=True, device="cuda", norm_impl="kernel")
    norm_counts = read_counts()
    norm_train = norm_counts["fused_norm"]
    rel = abs(rec_k["loss_first"] - rec["loss_first"]) / abs(rec["loss_first"])
    report(f"    step {rec_k['step_ms_median']:.1f} ms median ({rec_k['step_ms_min']:.1f}-"
           f"{rec_k['step_ms_max']:.1f}), peak allocated {rec_k['peak_bytes'] / 2**30:.2f} "
           f"GiB, losses {rec_k['loss_first']:.6f} (warm-up; phase 6 {rec['loss_first']:.6f}, "
           f"rel diff {rel:.3e}, tol {TRAIN_LOSS_TOL:g}) .. {rec_k['loss_last']:.6f}; norm "
           f"launches {norm_train} over {iters_k} steps")
    losses_k = [rec_k["loss_first"], *rec_k["losses"]]
    if not all(np.isfinite(v) for v in losses_k) or rel > TRAIN_LOSS_TOL or norm_train <= 0 \
            or off_path_launched(norm_counts):
        raise AssertionError(f"kernel-norm training failed: losses {losses_k}, "
                             f"norm launches {norm_train}")

    report("[6c] training the few-levels model: as phase 6 on FEW_LEVELS_PRESET, B=1 "
           f"T={FEW_TRAIN_T} (its num_frames) 64x64 crops, 1 warm-up + 1 timed step")
    zero_counts()
    rec_few = train_run(preset="few_levels", batch=1, frames=FEW_TRAIN_T, crop=64, iters=1,
                        grad_acc=1, remat=True, device="cuda")
    few_train = read_counts()
    report(f"    step {rec_few['step_ms_median']:.1f} ms, {rec_few['frames_per_s']:.3f} frames/s, "
           f"peak allocated {rec_few['peak_bytes'] / 2**30:.2f} GiB, losses "
           f"{rec_few['loss_first']:.6f} (warm-up) .. {rec_few['loss_last']:.6f}; LTAM head "
           f"width {FEW_LEVELS_PRESET.embed_dim[0] // FEW_LEVELS_PRESET.traj_heads[0]}; "
           f"launches over the timed step {few_train}")
    losses_few = [rec_few["loss_first"], *rec_few["losses"]]
    if not all(np.isfinite(v) for v in losses_few) or few_train["ltam_attention_2x2_bwd"] <= 0:
        raise AssertionError(f"few-levels training failed: losses {losses_few}, "
                             f"LTAM backward launches {few_train['ltam_attention_2x2_bwd']}")

    ev = eval_phases(report, err_bf16)

    report(f"[8] training from data (main path 7): python -m vmg_tpu_torch.tools.train "
           f"--config reds_full's function, FULL_PRESET bf16 + f32 masters, on a synthetic "
           f"packed REDS tree; {TRAIN_STEPS} steps (a checkpoint at step {TRAIN_STEPS}, "
           f"max_retries 0), then --resume for {TRAIN_STEPS} more")
    loop, loop_launches = train_loop_phase(report, smi, kind, rec)

    report(f"[9] export: FULL_PRESET bf16 served at 1x{T}x{H}x{W}, torch.export of the serving "
           "forward (ckpt.export.export_program) in the default forms and in the kernel forms "
           f"at {EXPORT_KERNEL_DEPTH}, saved, loaded and run against the eager forward")
    exported = export_phase(report, sd, smi, kind)

    report(f"[10] the other tails at full width: FULL_PRESET with {VARIANT} (trajectory at "
           "stages 0/6, DCN at 1/5, 3D window attention at 2/4 and 3; linear, bias-free axis "
           f"FCs): f32 parity at 1x2x64x64, bf16 serving at 1x{T}x{H}x{W} in both forms, one "
           "bf16 training step")
    variant = variant_phase(report, smi, kind)

    report(f"[11] T-sharded serving (parallel/seq.py): FULL_PRESET bf16 (tanh GELU, fast flow) "
           f"in two processes on the one card, clips {SEQ_CLIPS} (T, H, W), against one "
           f"process; f32 1x{SEQ_F32[0]}x{SEQ_F32[1]}x{SEQ_F32[2]} against the plain path on CPU "
           "tensors")
    seq = seq_phase(report, sd, smi, kind)

    report(f"[12] tensor parallelism (parallel/tp.py): a (1, 2) mesh of two processes on the "
           f"card, FULL_PRESET bf16 on f32 masters, remat, B=1 T={T} 64x64, lr {TP_LR:g}, "
           f"{TP_STEPS} steps, against one process's")
    tp = tp_phase(report, smi, kind)

    # each kernel's launches on the path that runs it: the LTAM backward in
    # training (phase 6), the conv chain and the norm in kernel-form serving
    # (phase 4b, 3 clips), the pin in the barrier form (phase 4b, 1 clip),
    # the token form at its op entry point (phase 2), the probe kernels at
    # the probes' (phase 2p), the others in serving (phase 4)
    paths = {"ltam_attention_2x2_bwd": ("training", train_launches),
             "fused_conv_chain": ("kernel-form serving", kernel_launches),
             "fused_norm": ("kernel-form serving", kernel_launches),
             "layout_pin": ("barrier-form serving", barrier_launches["barrier"])}
    for name in OFF_PATH:
        paths[name] = ("op entry point" if name == "fused_morphfc_axes_token"
                       else "probe entry points", entries[name]["path_launches"])
    kernels = []
    for name, e in entries.items():
        path, counts = paths.get(name, ("serving", serving_launches))
        extra = {k: v for k, v in e.items()
                 if k in ("module_ms", "hybrid_ms", "n1", "n16", "options")
                 or k.startswith(("groups", "d"))}
        kernels.append({"name": name, "route": e["route"], "source": e["source"],
                        "replaces": e["replaces"], "launches": counts[name],
                        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                        "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                        "at": e["at"], "launches_path": path,
                        "launches_serving": serving_launches[name],
                        "launches_kernel_forms": kernel_launches[name],
                        "launches_barrier": barrier_launches["barrier"][name],
                        "launches_training": train_launches[name],
                        "launches_training_norm_kernel": norm_train if name == "fused_norm"
                        else None,
                        "launches_few_levels_serving": few_launches[name],
                        "launches_few_levels_training": few_train[name],
                        "launches_eval": ev["launches"][name],
                        "launches_train_loop": loop_launches[name],
                        "launches_phase10": variant["launches"][name],
                        "launches_phase11_per_process": [
                            p["launches"][name] for p in seq["clips"][0]["processes"]],
                        "bound_bytes": e["bound_bytes"], "bound_flops": e["bound_flops"],
                        "bound_peak": e["bound_peak"], **extra})
    print(json.dumps({"serving": {"frames_per_s": fps, "per_request_frames_per_s": per_request,
                                  "peak_bytes": peak, "slice_max_abs_err": err},
                      "serving_kernel_forms": {
                          "frames_per_s": fps_k, "per_request_frames_per_s": per_request_k,
                          "peak_bytes": peak_k, "bf16_err_64": float(err_kernel),
                          "bf16_err_64_default": float(err_default)},
                      "serving_flow_levels_shared": {
                          "frames_per_s": fps_sh, "per_request_frames_per_s": per_request_sh,
                          "slice_max_abs_err": err_sh, "spynet_ms_shared": spynet_shared,
                          "spynet_ms_per_level": spynet_per_level},
                      "serving_few_levels": {
                          "frames_per_s": fps_few, "per_request_frames_per_s": per_request_few,
                          "peak_bytes": peak_few, "slice_max_abs_err": err_few}}))
    print(json.dumps({"training": {**rec, "parity": parity},
                      "training_norm_kernel": rec_k, "training_few_levels": rec_few}))
    print(json.dumps({"probes": {k: entries[k]["probes"] for k in OFF_PATH[1:]}}))
    print(json.dumps({"eval": {k: v for k, v in ev.items() if k != "launches"}}))
    print(json.dumps({"train_loop": loop}))
    print(json.dumps({"export": exported}))
    print(json.dumps({"phase10": {k: v for k, v in variant.items() if k != "launches"}}))
    print(json.dumps({"phase11_seq": seq, "phase12_tp": tp}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def parallel_main(n: int) -> int:
    """``python3 chip_smoke.py --nccl N``: phases 1, 11 and 12 alone, their
    processes one a card on N cards in an NCCL group (the one-process
    references on card 0)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke --nccl {n}: needs {n} CUDA devices", file=sys.stderr)
        return 1
    from vmg_tpu_torch import _build
    from vmg_tpu_torch.configs import FULL_PRESET
    from vmg_tpu_torch.models.vmg import create_model

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] cards: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.time()
    _build.load_library()
    print(f"[1] kernels built and loaded in {time.time() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = create_model(FULL_PRESET, device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()
    print(f"[11] T-sharded serving over {n} cards (NCCL), clips {SEQ_CLIPS}", flush=True)
    seq = seq_phase(print, sd, smi, kind, world=n, backend="nccl")
    print(f"[12] tensor parallelism over {n} cards (NCCL)", flush=True)
    tp = tp_phase(print, smi, kind, world=n, backend="nccl")
    print(json.dumps({"phase11_seq": seq, "phase12_tp": tp}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--nccl":
        sys.exit(parallel_main(int(sys.argv[2])))
    sys.exit(main())
