#!/usr/bin/env python3
"""Drive the port's main paths on one NVIDIA GPU: the 5-ref CUFED5 eval
forward, the stage-3 training step with both alignments, in f32 and in the
shipped bf16 mixed precision, StyleGAN2 sampling and training, video SR
inference (BasicVSR++, EDVR, BasicVSR) and training (EDVR-M, BasicVSR,
BasicVSR++, MSRResNet through ``SRModel`` and the CLIs), stage-3 training,
validation and the sharded patch match over two ranks, the WGAN-GP phase
after the pixel steps (one process and two ranks), the single-ref model,
and the training and test CLIs on the shipped YAMLs with the data loader
in the loop.

    python3 chip_smoke.py        # from the root of a checkout
    python3 chip_smoke.py --repeat-grads 20   # only the whole-net gradient
                                              # comparisons, 21 times a path
    python3 chip_smoke.py --ddp  # only the two-rank phase (17)
    python3 chip_smoke.py --bf16 # only the bf16 phases (11a-11e)
    python3 chip_smoke.py --dcn  # only K3, K5 and their module path (7)
    python3 chip_smoke.py --k2   # K2 (4, 5, the weight split), the video
                                 # scatter, then --dcn's phases
    python3 chip_smoke.py --cli  # only the CLI phase (11f)
    python3 chip_smoke.py --gan  # only the GAN phases (11g)
    python3 chip_smoke.py --ref  # only the single-ref phases (11h)
    python3 chip_smoke.py --video  # only the video training phases (16b)
    python3 chip_smoke.py --zoo    # only the video zoo's phases (16b)
    python3 chip_smoke.py --sr-zoo # only the SR zoo's phases (16c)
    python3 chip_smoke.py --realesrgan  # only Real-ESRGAN's phases (16d)
    python3 chip_smoke.py --face   # only the face family's phases (16e)
    python3 chip_smoke.py --last   # only C5's check, eval_parity and the
                                   # ddp phase with RealESRNet (10b, 17)

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or
``/usr/local/cuda``). Phases, one JSON line each (one per shape where a
phase runs several):

1. device: the card's name and count, and its power limit from
   ``nvidia-smi``;
2. build: the CUDA sources built with ``nvcc`` from this checkout, with
   ``-Xptxas -v``'s registers, shared memory and spills; the profiler's
   first start (seconds of CUPTI's set-up) and the packed-shard library
   (``data/csrc/packio.cpp``, host code, built with ``g++`` and held to a
   written and read shard) in threads beside it;
3. feature_match_prologue (K1's unfold and norms, one kernel) against its
   plain PyTorch version: f32 within ``PROLOGUE_F32_TOL``; then
   feature_match (kernel K1, 3xTF32) against the plain match behind the
   same prologue outputs, and the function end to end against its plain
   version, at the eval shape, 5 pairs of (125, 125, 256) f32, and at the
   training shape, 30 pairs of (40, 40, 256); planted exact ties; the
   library yardstick also at n padded to a multiple of 8;
4. mdcn (kernel K2, forward: ``mdcn_fused_fwd`` of ``mdcn_fused.cu``,
   the columns gathered into shared memory and contracted there as
   3xTF32) against its plain version at the three eval shapes, the
   training shapes and the video nets' (BasicVSR++'s 128 -> 64 channels
   at 180x320, 16 deform groups; EDVR-M's L1); the kernel alone timed
   beside the function;
5. mdcn_backward (K2's backward: the fused ``mdcn_fused_dgrad``,
   ``mdcn_fused_wgrad`` and the ordered sum of its partials) against
   autograd through the plain version at the three training shapes
   (N = 30), every gradient, x's through dgrad's scatter variant; again
   as the training step runs it (x frozen), two such calls bit-equal in
   grad offset, mask, weight and bias; each entry point launched alone
   with its own outputs checked, the scatter variant also under offsets
   uniform on [-SCATTER_NEAR, SCATTER_NEAR]; with integer offsets and
   samples on the border;
6. deform_sample (kernel K4, forward and backward) against its plain
   version at the three training shapes, and bit for bit against ``x``
   indexed at the shifted positions for integer flows;
7. mdcn_groups (K3, DCNv2 with conv groups 2 and 8) and dcn_v1 (K5, DCNv1
   at padding 0, groups 1 and 8) on the fused kernels, in f32 and then in
   bf16 (``*_bf16``), against their plain versions, forward and every
   gradient, at EDVR-M's L1 shape (5, 180, 320, 64), deform groups 8
   (``DCN_VARIANT_TOL``, at bf16 ``K2_BF16_TOL``), and again with grad x
   under offsets uniform on [-SCATTER_NEAR, SCATTER_NEAR]; the backward as a
   training step asks it run twice, bit-equal, launching the variant's own
   entry points of the type and no scatter; K3 at groups 2 against two K2
   calls on the channel slices; then dcn_modules: ``DCNv2Pack`` and
   ``DynAgg`` with groups 2 at bf16 (cast as the models cast a net) on
   EDVR-M L1 features, forward and backward through the kernels against
   the plain versions, K3's bf16 entry points only;
8. upfirdn2d (kernel K7: the tile kernel for StyleGAN2's 4x4 cases, the
   gather kernel for any other) against its plain version, forward,
   backward and double backward, at every shape of a 1024x1024 16-sample
   generator forward (there the plain double backward in closed form,
   twice the plain forward of the plain gradient: the op is linear) and
   of a 256x256 B = 8 generator and discriminator
   forward (the smoothing filter after a transposed conv and before a
   strided conv, the x2 upsampling of the RGB skip), at two odd cases (a
   stride; the gather: a negative pad, a 3x5 filter, a non-square map),
   and at the tile kernel's edges (``K7_EDGE_CASES``: outputs one below,
   at and one above a tile's columns and rows, odd pads at up 2, many
   small planes a block);
9. fused_act (kernel K8) the same, at the 4-D and 2-D shapes of those
   forwards, with and without bias, NCHW and channels-last, with exact
   zeros planted (the derivative there must be 1); the backward with the
   bias taking a gradient (grad bias from the kernel's ordered partials)
   run twice at every shape, bit-equal, and the double backward with
   gg_bias held against the plain version;
10. slice: ``MultiRefRestorationModel`` at full width (ngf 64, 16 blocks,
    8 deform groups) with seeded weights answers 2 requests of B = 1,
    T = 5 on a 500x500 canvas; the kernels' launch counts over them; then
    one request through the kernels and through the plain versions,
    compared; profile: one more request under ``torch.profiler``, device
    time by kernel and the device's idle share;
10b. adaptive_pool_grad (ROADMAP C5): ``nn.AdaptiveAvgPool2d(1)``'s
    input gradient on a channels-last input, card against CPU, at
    ``ImageDiscriminator``'s and RCAN's shapes (``POOL_GRAD_CASES``);
    eval_parity: the port's CUFED5 gate script
    (``mrefsr_tpu_torch.scripts.eval_parity``) in this process on a
    synthetic CUFED5 folder (two inputs near 480 x 480, 5 refs each, padded
    to the 500 canvas) and seeded full-width checkpoints in the reference
    ``.pth`` layout, at f32 and with ``--bf16``: the launches of each run
    (exactly 1 prologue, 1 match and 3 K2 a request), every output through
    the kernels against the plain versions (slice's tolerances), the plain
    run passing the script's gate at the kernels' metrics (exit 0), a gate
    0.2 dB off failing (exit 2);
11. train_dcn and train_flow: the same model built for training
    (``alignment`` dcn, then flow) takes one warm-up and five timed
    steps at B = 6, gt 160, T = 5, f32 on one repeated batch; the launch
    counts over the timed steps (no launch may scatter a grad x: the
    sampled features are frozen); at B = 1, from the fresh and from the
    trained weights, every parameter's gradient through the kernels
    against the plain versions behind the same forward (see
    ``TRAIN_GRAD_REL_TOL``), and the two outputs; then a profile of one
    step;
11g. gan_dcn, gan_flow, gan_dcn_percep: ``options/ab/ab_dcn_gan.yml``'s
    and ``ab_flow_gan.yml``'s nets at full width (MRAPA ngf 64, 16
    blocks, 8 deform groups; ``ImageDiscriminator`` ndf 32), B 8, gt 160,
    5 refs, the alternation cut to ``net_g_pretrain_steps`` 2,
    ``net_d_steps`` 2, ``net_d_init_steps`` 1 (the last with SRNTT-form
    perceptual and style losses on seeded VGG19 weights): both nets'
    gradients of a GAN step through the kernels against the plain
    versions behind the same forward (B 2), then 2 bf16 pixel steps (bf16
    entry points only) and 6 f32 GAN steps (f32 entry points only), the
    discriminator's norms written exactly twice a GAN step, the logs;
    step ms by kind, peak memory, a profile of each kind of GAN step;
    ddp_gan (its ranks are the ``ddp`` phase's processes, after their
    own parts, and its lines follow that phase's): two ranks (as ``ddp``)
    of B 4 against one process of B 8,
    one GAN step: the norms' statistics and the losses within 1e-5, the
    generator's gradients within 1e-4, the discriminator's by a two-part
    rule (``DDP_GAN_D_MEDIAN``);
11h. ref_train, ref_train_bf16: ``RefRestorationModel`` with
    ``RestorationNet`` (ngf 64, 16 blocks, 8 deform groups) and one ref,
    B 6, gt 160: the gradients against the plain versions, a warm-up and
    three timed steps, a profile; ref_eval, ref_eval_bf16: two single-ref
    500x500 requests, one against the plain versions;
11a. feature_match_prologue_bf16 and feature_match_bf16: phase 3 in bf16
    (the prologue bit for bit but for norms near a bf16 rounding midpoint,
    counted; the match kernel on wgmma and TMA), the f32 kernel timed
    beside it on the same values;
11b. mdcn_bf16 and mdcn_backward_bf16: K2 at bf16 (x, mask, weight, bias
    bf16, the offset f32) through the fused kernels of ``mdcn_bf16.cu``
    at the eval and training shapes, forward and every gradient, against
    the plain version (``K2_BF16_TOL``), the integer-offset case too, the
    backward with x's gradient (dgrad's scatter variant) and as the
    training step runs it (dgrad, wgrad, the sum); two such backward calls
    bit-equal in grad offset, grad mask, grad weight and grad bias; each
    fused entry point launched and timed alone, what it wrote held against
    the plain version (forward; dgrad; its scatter variant; wgrad; the
    sum of the grad-weight and grad-bias partials);
11c. deform_sample_bf16: K4 the same at the training shapes;
11d. slice_bf16: phase 10 with ``val.mixed_precision: bfloat16``: the
    output f32, the request through the kernels against the plain
    versions (``SLICE_BF16_TOL``) and against the same weights' f32
    request (max 0.1, mean 0.02), launches of the bf16 entry points only;
    a profile;
11e. train_dcn_bf16 and train_flow_bf16: phase 11 with
    ``train.mixed_precision: bfloat16``: no launch of an f32 entry point
    or a grad-x scatter; f32 master parameters, gradients and Adam
    state; the gradients behind the same forward within
    ``TRAIN_GRAD_BF16_TOL``; a profile of each;
11f. cli: the port's CLIs on synthetic images (``make_synthetic_megadepth
    .py``'s 88 JPEGs, written by a process started beside the build, 4
    CUFED5-layout sets near 500x332, in temporary directories).
    ``cli_prefetch``: the shipped YAML's first loader batch
    through the ``device`` prefetcher, bit for bit the host's ``astype(
    float32) / 255`` on the card (and how many elements ``x.float() / 255``
    on the card would change); ``cli``: ``train_pipeline`` in this process
    on ``options/train/stage3_5ref_restoration_mse.yml`` as shipped (bf16,
    B 6, gt 160, 6 loader threads, ``prefetch_mode: device``, uint8, the
    decode cache) but for the dataroots, no pretrained extractor, 60
    iterations, logs every 10, saves at 30 and 60, validates at 60: img/s
    over iterations 11-60 from the host times of the log lines, the
    logger's time and data time, peak memory, K1 and K2 launched at bf16
    only in the training iterations and at f32 only in validation, a
    finite PSNR; the CLI's profiler window over iterations 3 and 4
    (``logger.profile_start_iter``, before the timed ones), its Chrome
    trace read back, K1's and K2's kernels among its device events; then
    the same model's step on one repeated batch;
    ``cli_test``: ``python -m mrefsr_tpu_torch.test`` on
    ``options/test/test_5ref_cufed5.yml`` with the run's
    ``net_g_latest.pth``, its saved outputs bit for bit this process's from
    the same file and loader, so every image's PSNR equal, and the logged
    mean; ms a request; ``cli_serving``: ``test_5ref_cufed5_serving.yml``
    (``pad_to`` buckets, bf16) through ``test_pipeline`` in this process,
    then a bf16 request at the 500x332 bucket against one on the 500x500
    canvas, second requests, with K1's device ms of each;
    ``cli_preemption``: the training CLI in a process of its own, SIGTERM
    after iteration 10: exit 0 and a saved ``.state``; ``--auto_resume``
    goes on from it to iteration 30;
    ``cli_lp``: ten bf16 iterations of
    ``stage3_5ref_restoration_mse_lp.yml`` (gt 300, B 3) through
    ``train_pipeline``, timed over iterations 6-10; ``cli_gan``:
    ``options/ab/ab_dcn_gan.yml`` for 24 iterations, the pixel -> GAN
    boundary at 8, a checkpoint at 16, then ``--auto_resume`` from it:
    ``net_d`` and both optimizers back bit for bit;
12. stylegan2_serve: the FFHQ config-f generator at full width (1024,
    512 style features, 8 MLP layers, channel multiplier 2) with seeded
    weights, through the inference module: the mean latent of 4096 codes,
    two grids of 16 samples at truncation 0.7; launch counts per grid;
    one grid through the kernels and through the plain versions,
    compared; a profile of one grid;
13. stylegan2_train: ``StyleGAN2Model`` at 256x256, channel multiplier 2,
    B = 8 (wgan_softplus, R1 every 16, path-length penalty every 4): from
    fresh weights every net_d gradient of the D loss with R1 and every
    net_g gradient of the G loss with the path penalty (by a two-part
    rule, see ``SG2_PATH_GRAD_TOL``) through the kernels against the
    plain versions, and the losses; a warm-up step of each kind, then
    two timed steps of each kind (plain, path penalty, iteration 16 with
    both penalties); launch counts per kind of step, forward, backward and
    double backward; a save and reload of both nets, the EMA and both
    optimizers; a profile of one step of each kind;
14. basicvsrpp_serve: the BasicVSR++ REDS configuration of
    ``inference/inference_basicvsrpp.py`` (mid 64, 7 blocks, residue 10)
    with seeded weights and live offset convs, through the port's
    ``inference``: a warm-up and two timed 15-frame chunks of 180x320
    frames (exactly 56 K2 launches a chunk, nothing else); the chunk
    through the kernels against the plain versions; a profile;
15. edvr: EDVR-M x4 (64 features, 5 frames, 8 deform groups, 5 + 10
    blocks, TSA) on one 5-frame 180x320 window -> one 720x1280 frame, the
    frames folded into the batch for the alignment: a warm-up and three
    timed windows, launches, kernels against plain, a profile;
16. basicvsr_serve: BasicVSR (64 features, 30 blocks) through
    ``inference`` on one 15-frame chunk: time only (no kernel of this
    repository on its path);
16b. the video training phases, on a synthetic REDS (two clips of 100
    frames, LQ 180x320, GT 720x1280, written to a temporary directory)
    and seeded weights at the widths of BasicSR's training YAMLs
    (``YAML_SOURCES``; each cut in the line's ``reduced``).
    ``video_train``: EDVR-M woTSA (f32, bf16), EDVR-M with TSA across
    ``tsa_iter`` 2, BasicVSR (64, 30 blocks) and BasicVSR++ (the REDS
    configuration; f32, bf16) through ``SRModel``'s step at B 4, gt 256,
    5 or 15 frames: the gradients through the kernels against the plain
    versions behind the same forward at B 1 (``TRAIN_GRAD_REL_TOL``, at
    bf16 ``TRAIN_GRAD_BF16_TOL``), from fresh weights and again after the
    timed steps, two warm-ups (the frozen parameters, of which there must
    be some, bit-equal through iteration 1, then moving), three timed
    steps (IconVSR two) that launch exactly K2's forward, scatter dgrad,
    wgrad and sum at the
    step's type (BasicVSR none), peak memory, a profile with the scatter
    apart (``k2_dgrad_scatter_ms``); ``video_scatter``: the scatter dgrad
    alone at those steps' shapes under ``randn * 4`` offsets and offsets
    uniform on [-SCATTER_NEAR, SCATTER_NEAR], what one launch writes held
    to the plain version (``_k2_tol``), timed beside the dgrad without
    grad x and cuDNN's grad input; ``sr_train``: MSRResNet (64, 16 blocks) at gt 128,
    B 16, f32 and bf16, no kernel of this repository; ``cli_video``: the
    EDVR-M woTSA YAML through ``train_pipeline`` for 60 iterations (3
    loader threads, the device prefetcher, validation at 20, 40, 60 on a
    20-frame clip), SIGTERM and ``--auto_resume`` in processes of their
    own, beside them ``python -m mrefsr_tpu_torch.test`` with BasicVSR on
    a 100-frame folder, its saved frames bit for bit this process's;
16c. the SR zoo (RRDBNet, EDSR, RCAN, SRVGGNetCompact, ECBSR, RIDNet,
    SwinIR; ``ESRGANModel``, ``SwinIRModel``; the SISR datasets and the
    three SR inference scripts), seeded weights and synthetic images at the
    widths of ``SR_ZOO_YAMLS``, none of it launching a kernel of this
    repository (checked). ``sr_zoo_serve``: each net through the registry
    and ``SRModel.test`` / ``SwinIRModel.test`` on one 256x256 LQ (SwinIR
    253x251, reflect-padded to its window), f32 and ``val.mixed_precision:
    bfloat16``, ms a forward and peak memory, the f32 output on a 64x64 LQ
    against the same net on the CPU (``SR_ZOO_CPU_TOL``);
    ``esrgan_train``: ``train_ESRGAN_x4.yml``'s nets and losses at B 16,
    gt 160 (this repository's ``VGGStyleDiscriminator`` takes 160 or
    256), one step at B 1 against the CPU's (both nets' gradients within
    ``TRAIN_GRAD_REL_TOL`` for the pixel loss's, the logged terms, the
    parameters and statistics after it), two warm-ups and
    ``SR_ZOO_STEPS`` timed steps,
    a profile; ``swinir_train``: the P48W8 YAML at gt 192, B 4, drop path
    0.1, f32 and bf16: two models from one seed give one first loss,
    another drop-path seed another; timed steps, peak memory, one step's
    device time split among attention, linears, layer norm and cuDNN;
    ``cli_sisr``: an ``ESRGANModel`` YAML through ``train_pipeline`` for
    ``CLI_SISR_ITERS`` iterations on ``SISRMegaDepthDataset``, validating
    on ``SISRSun80Set`` and ``SISRCUFEDDataset``, beside it
    ``mrefsr_tpu_torch.inference.inference_esrgan``, ``_swinir`` and
    ``_ridnet`` as processes on seeded reference-layout ``.pth`` files,
    every PNG they write bit for bit this process's output;
16d. Real-ESRGAN: the synthesis on the card (``realesrgan_synth``), the
    RealESRNet and RealESRGAN steps (``realesr*_train``) and
    ``cli_realesrgan`` at the published YAMLs' widths (``REALESR_*``);
16e. the face family and the learned metrics, seeded weights, no kernel
    of this repository on their paths but StyleGAN2's (checked):
    ``hifacegan_serve`` (``HiFaceGAN`` at the JAX package's defaults, a
    512x512 face through ``SRModel.test``, f32 and bf16; the card against
    the CPU at ``HIFACEGAN_SMALL``), ``hifacegan_train``
    (``HiFaceGANModel`` with ``HiFaceGANDiscriminator``, B ``FACE_B`` at
    512, a skipped G turn, timed steps; one step against the CPU at a
    small width: losses, gradients by name, ``u`` / ``v``),
    ``dfdnet_serve`` (``mrefsr_tpu_torch.inference.inference_dfdnet`` on
    a face, its landmark file and a seeded dictionary; the card against
    the CPU), ``cli_stylegan2`` (the FFHQ-256 recipe through
    ``train_pipeline`` on ``FFHQDataset``, a sample grid, a checkpoint and
    ``--auto_resume``; every K7 and K8 entry launched, counted by the
    wrappers and by a profile), ``metrics_cli`` (the metric CLIs on its
    faces: ``calculate_fid_stats_from_datasets``;
    ``calculate_stylegan2_fid`` at its defaults, size 256, channel
    multiplier 2, batch 64, 128 samples at truncation 1 and 0.7, from a
    seeded ``params_ema`` checkpoint, K7 and K8 launches for one batch and
    for the run, no plain version called; the first batch's images and
    Inception features against the same codes and noise through the plain
    versions, the FID against the plain run's; ``calculate_psnr_ssim``,
    ``calculate_niqe``, ``calculate_lpips`` on seeded weight files and
    ``calculate_fid_folder``) and ``face_metrics`` (FID's Inception
    features, LPIPS, each against the CPU; NIQE on the host);
17. ddp: two ranks started with ``torch.multiprocessing`` (spawn) under
    the torchrun env contract, each joining through the port's
    ``init_dist('pytorch')``: NCCL with a card a rank where there are two
    cards or more, else gloo with both ranks on the one card (printed).
    Each rank runs sharded_match (K6 at K1's eval shape, the ref's rows
    split unevenly with the 2-row halo, against single-rank K1 on the
    whole ref, against its plain version (at bf16 leaving out the rows a
    norm rounded apart by the prologue touches) and against the plain
    match behind the same prologue; the band's prologue against its plain
    version at ref strides 1 and 2; a tie planted across the boundary;
    times), ddp_train (``_train_opt('dcn')``
    with ``dist: true``, B 6 a rank: from fresh weights the DDP gradient of
    one sample a rank against the mean of the per-sample gradients; a
    warm-up step whose logged loss must be the mean of the ranks' own,
    three timed steps, parameters bit-equal across ranks, a profile of
    rank 0's next
    step), dist_val (four seeded 500x500 requests, one padded, through
    ``validation``: the ranks' sums against rank 0's unsharded ones) and
    ddp_resume (a save from rank 0 only, a fresh model resumed on every
    rank takes a step, the ``.pth`` loads strictly into a model of one
    process); the parent prints one line for each. sharded_match runs
    again at bf16 (K6 through the bf16 kernel's sharded entry point); the
    training and validation of this phase are f32. Then the same ranks
    take ddp_gan's step (11g), and the parent checks it; then
    ddp_realesrnet (ROADMAP A13): ``RealESRNetModel`` with ``dist: true``
    at the x4plus width (RRDBNet 64 / 23), f32, B 4 a rank, gt 256, a
    pool of 8 a rank, three steps: the ranks' parameters bit-equal after
    them, and each rank's pairs bit for bit those of a model of one
    process seeded ``manual_seed`` plus the rank fed the same batches;
18. the ``kernels`` line.

Then the card's name and power limit as ``nvidia-smi`` prints them, and
last ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without the last line. Times come from CUDA events,
the median of a pair of events around each run (phases 3, 11a and K6's;
K1's and its prologue's over ``K1_REPS`` rounds after 3 warm-ups, the
function, the kernel alone and the library yardsticks in turn within each
round), for K2 to K5, K7 and K8 (phases 4 to 9, 11b, 11c) the device time
a call (``device_ms_each``: torch.profiler's device events over
``DEVICE_RUNS`` calls, ``PLAIN_DEVICE_RUNS`` for a plain version, a
profile a call; ``ms``, ``plain_ms`` and ``library_ms`` of their
``kernels`` entries, with the events' times beside as ``*call_ms``),
the host clock around
``torch.cuda.synchronize()`` (phases 10 to 17) and the profiler's device
times. Bounds use the H100 SXM's published 67 TFLOP/s f32 (CUDA cores),
495 TFLOP/s TF32 and 989 TFLOP/s dense bf16 (tensor cores) and 3.35 TB/s;
K1, K6 and K2 at f32 take three TF32 products a multiply-add (3xTF32), and
their records give the f32 CUDA-core bound beside.
"""
import contextlib
import copy
import gc
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12               # dense, tensor cores
PEAK_BYTES = 3.35e12
BF16 = torch.bfloat16
EPS_BF16 = 2.0 ** -7                   # bf16's machine epsilon
CANVAS, T, SEED = 500, 5, 0
EVAL_SHAPES = tuple((c, CANVAS // d) for c, d in ((256, 4), (128, 2),
                                                  (64, 1)))
K1_IDX_GAP, K1_VAL_TOL = 1e-4, 1e-5   # index may differ only on near-ties
K2_REL_TOL = 1e-4                     # max |kernel - plain| / max |plain|
SLICE_TOL = 1e-4                      # output is about [0, 1]


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries ``at_s``, the seconds since
    the script started (the whole run has a time limit)."""
    if 'phase' in obj:
        obj = dict(obj, at_s=round(time.perf_counter() - _T0, 1))
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'check failed: {msg}')


def cuda_ms_each(fns, reps=3, warmup=1):
    """The median ms of each of ``fns`` over ``reps`` rounds, each run timed
    by its own pair of CUDA events. A round runs every fn once, in turn, so
    that the card's clocks and heat fall alike on all of them."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    events = [[(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
              for _ in fns]
    torch.cuda.synchronize()
    for rnd in range(reps):
        for fn, runs in zip(fns, events):
            runs[rnd][0].record()
            fn()
            runs[rnd][1].record()
    torch.cuda.synchronize()
    return [statistics.median(start.elapsed_time(end) for start, end in runs)
            for runs in events]


def cuda_ms(fn, reps=3, warmup=1):
    """The median ms of ``fn`` over ``reps`` runs, from CUDA events."""
    return cuda_ms_each([fn], reps, warmup)[0]


# device times (device_ms_each): calls profiled a fn, the spin kernels
# (about a millisecond in all) that open and close a profile, profiles
# tried before giving up
DEVICE_RUNS = 20
SETTLE_NAME, SETTLE_CYCLES, SETTLE_KERNELS = 'spin_kernel', 100_000, 16
DEVICE_TRIES = 6
# device work a library launches on some calls and not on others (cuDNN's
# bf16 weight gradient, now and then, on the H100 machine): timed, but
# left out of the event count that tells a dropped event
VARYING_EVENTS = ('init_device_work',)


def device_ms_each(fns, runs=DEVICE_RUNS, warmup=1):
    """The device time (ms) of the work one call of each of ``fns`` puts
    on the card: the durations of the device events (kernels, memsets,
    copies) that ``torch.profiler`` records over ``runs`` calls, summed
    and divided by ``runs``, a profile a fn. It leaves out the host's time
    between launches, which the events of :func:`cuda_ms_each` around one
    small call mostly measure. On the H100 machine the profiler now and
    then misses device events at a profile's edges (a marker kernel, two
    kernels of twenty, every kernel of a short profile), and dates the
    kernels this repository launches through ctypes before PyTorch's own
    that ran ahead of them; so each profile holds one fn alone, opens and
    closes with :data:`SETTLE_KERNELS` spin kernels each
    (``torch.cuda._sleep``, left out of the sum), and is taken again, up
    to :data:`DEVICE_TRIES` times and with twice the spin kernels each
    time, where its event count is not a multiple of ``runs``
    (``VARYING_EVENTS`` left out of that count): once every event of a
    one-call profile went missing three times running."""

    def settle(tries):
        for _ in range(SETTLE_KERNELS << tries):
            torch.cuda._sleep(SETTLE_CYCLES)
        torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        for fn in fns:
            fn()
    out = []
    for fn in fns:
        for tries in range(DEVICE_TRIES):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                settle(tries)
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
                settle(tries)
            events = [(name, us) for name, us in device_events(prof)
                      if SETTLE_NAME not in name]
            steady = [name for name, _ in events
                      if not any(v in name for v in VARYING_EVENTS)]
            if steady and len(steady) % runs == 0:
                break
        check(steady and len(steady) % runs == 0,
              f'{len(steady)} device events profiled for {runs} calls, '
              f'{DEVICE_TRIES} times: '
              f'{sorted({name[:60] for name, _ in events})}')
        out.append(sum(us for _, us in events) / runs / 1e3)
    return out


def device_events(prof):
    """``(name, us)`` of each device event (kernel, memset, copy) that the
    finished profile ``prof`` recorded, user annotations left out. Read
    from the profiler's raw results: building torch.profiler's event tree
    (``events()``, ``key_averages()``) takes seconds for the tens of
    thousands of events of a video training step, this a fraction of
    one."""
    from torch.autograd import DeviceType
    out = []
    for event in prof.profiler.kineto_results.events():
        if (event.device_type() != DeviceType.CUDA
                or getattr(event, 'is_user_annotation', lambda: False)()
                or getattr(event, 'is_hidden_event', lambda: False)()):
            continue
        name = event.name()
        if name.startswith('_Z'):       # as torch.profiler names it
            name = torch._C._demangle(name)
        out.append((name, event.duration_ns() / 1e3))
    return out


def device_time_by_name(prof):
    """``[(ms, calls, name)]`` of the device events of :func:`device_events`
    summed by name, the largest first."""
    by_name = {}
    for name, us in device_events(prof):
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + us / 1e3, calls + 1)
    return sorted(((ms, calls, name) for name, (ms, calls) in by_name.items()),
                  reverse=True)


# the plain versions' calls profiled a fn (device_ms_each): each takes tens
# to hundreds of ms; K7's and K8's serving cases time their plain and
# library versions so too (PLAIN_TIMING: one call between CUDA events,
# then PLAIN_DEVICE_RUNS profiled), to keep the whole script inside its
# time limit
PLAIN_DEVICE_RUNS = 3
PLAIN_TIMING = {'reps': 1, 'runs': PLAIN_DEVICE_RUNS}


def timed(fns, reps=3):
    """Each ``key: fn`` of ``fns`` (keys ending in ``ms``) timed two ways:
    ``key``, the device time a call (:func:`device_ms_each` over
    ``DEVICE_RUNS`` calls, ``PLAIN_DEVICE_RUNS`` for a ``plain`` key), and
    ``key`` with ``ms`` made ``call_ms``, a pair of CUDA events around one
    call, host time included (:func:`cuda_ms`, the median of ``reps``, of
    one for the plain version)."""
    out = {}
    for key, fn in fns.items():
        plain = key.startswith('plain')
        out[key[:-2] + 'call_ms'] = cuda_ms(fn, reps=1 if plain else reps)
        out[key] = device_ms_each(
            [fn], runs=PLAIN_DEVICE_RUNS if plain else DEVICE_RUNS)[0]
    return out


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    """The least time (ms) for ``flops`` operations at ``peak`` and
    ``nbytes`` at the memory rate, and which of the two it is; ``flops``
    may be a list of ``(operations, peak)`` pairs of several types."""
    pairs = flops if isinstance(flops, list) else [(flops, peak)]
    t_ops = sum(f / p for f, p in pairs)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def phase_device():
    check(torch.cuda.is_available(), 'no CUDA device: this script measures '
          'the GPU and never runs on the CPU')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': torch.cuda.device_count()}
    emit({'phase': 'device', **device, 'nvidia_smi': smi,
          'torch': torch.__version__, 'cuda': torch.version.cuda})
    return device, smi


def _start_profiler_once():
    """One profile of one small kernel: the profiler's first start in a
    process (CUPTI's set-up) takes seconds on the H100 machine, and
    :func:`phase_build` has it run beside the build."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(SETTLE_CYCLES)
        torch.cuda.synchronize()


def phase_build(build):
    """``build()`` (nvcc in processes of its own) with, in threads beside
    it, the profiler's first start (:func:`_start_profiler_once`) and the
    packed-shard library's ``g++`` build (``data/packio.py``, host code),
    which must load and round-trip a shard."""
    import threading
    from mrefsr_tpu_torch.data import packio
    t0 = time.perf_counter()
    started, packed = {}, {}

    def start_profiler():
        _start_profiler_once()
        started['s'] = time.perf_counter() - t0

    def build_packio():
        path, built = packio.build()
        shard = os.path.join(tempfile.mkdtemp(prefix='packio_'), 'a.pack')
        try:
            writer = packio.PackWriter(shard)
            writer.put('key', b'value')
            writer.close()
            reader = packio.PackReader(shard)
            packed.update(s=time.perf_counter() - t0, built=built,
                          library=os.path.basename(path),
                          read_back=reader.get('key') == b'value')
            reader.close()
        finally:
            shutil.rmtree(os.path.dirname(shard), ignore_errors=True)

    threads = [threading.Thread(target=fn)
               for fn in (start_profiler, build_packio)]
    for thread in threads:
        thread.start()
    try:
        info = build()
    finally:
        for thread in threads:
            thread.join()
    check('s' in started, 'the profiler did not start (see the thread\'s '
          'error above)')
    check(packed.get('read_back'), f'the packio library did not build or '
          f'read back a shard (see the thread\'s error above): {packed}')
    ptxas = {}
    for stem, rec in info.items():
        ptxas[stem] = [line.split(':', 1)[1].strip()
                       for line in rec['log'].splitlines()
                       if line.startswith('ptxas info') and (
                           'registers' in line or 'spill' in line)]
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'profiler_started_s': started['s'], 'built': sorted(info),
          'packio': packed, 'ptxas': ptxas})


# K1's prologue against its plain version on the same features: at f32 the
# patches and norms within PROLOGUE_F32_TOL (the f32 sum of squares in
# another order); at bf16 bit for bit, except where the plain f32 sum of
# squares lies within PROLOGUE_MID_ULPS f32 ulps of a bf16 rounding
# midpoint, which the kernel's sum, in another order, may round the other
# way: such a norm must be one bf16 ulp off, and such a ref patch the
# quotients of the neighbouring divisor. 16 ulps bounds the disagreement
# of two f32 sums of up to 2304 non-negative terms taken in tree-like
# orders (a few ulps apart in practice); the count and the worst distance
# are printed.
PROLOGUE_F32_TOL = 1e-6
PROLOGUE_MID_ULPS = 16
# K1's and its prologue's times: the median of K1_REPS rounds (a 3-run mean
# could not tell K1's kernel alone from the function around it)
K1_REPS = 20
K1_PROLOGUE_TPU = 'mrefsr_tpu/ops/correlation.py:20'
PEAK_TF32_FLOPS = 495e12               # dense, tensor cores


def _midpoint_ulps(sums):
    """The distance, in f32 ulps, of each f32 ``sums`` to the nearest bf16
    rounding midpoint (an f32 whose low 16 bits are 0x8000)."""
    low = sums.float().contiguous().view(torch.int32) & 0xFFFF
    return (low - 0x8000).abs()


def _bf16_neighbours(x):
    """The bf16 values one ulp below and above each positive ``x``."""
    bits = x.contiguous().view(torch.int16)
    return (bits - 1).view(BF16), (bits + 1).view(BF16)


def phase_prologue(correlation, fin, fref, shape, ref_stride=1, timed=True):
    """The prologue kernel against its plain version on ``fin``, ``fref``
    (the ``shape`` named) at ``ref_stride``. Timed, it prints the phase
    line and returns the kernels line's record; untimed, it returns the
    phase line's record. Either way also, at bf16, the input rows and ref
    patches whose norms the two round apart (at f32, none)."""
    bf16 = fin.dtype == BF16
    name = 'feature_match_prologue_bf16' if bf16 else \
        'feature_match_prologue'
    args = (fin, fref, 3, 1, ref_stride, True)
    pin_k, pref_k, norm_k = correlation._prologue_cuda(*args)
    pin_p, pref_p, norm_p = correlation._prologue_ref(*args)
    check(torch.equal(pin_k, pin_p), f'{name}: input patches differ')
    check(bool((pin_k.stride(1) % 8 == 0) and pin_k.stride(2) == 1),
          f'{name}: rows of {pin_k.stride()} are not 16-byte rows')
    rec = {'phase': name, 'shape': shape, 'ref_stride': ref_stride,
           'pairs': pin_k.shape[0],
           'n_in': pin_k.shape[1],
           'n_ref': pref_k.shape[1], 'd': pin_k.shape[2],
           'ld': pin_k.stride(1)}
    pad = torch.as_strided(pin_k, pin_k.shape[:2] + (pin_k.stride(1),),
                           pin_k.stride()[:2] + (1,))[..., pin_k.shape[2]:]
    check(not bool(pad.any()), f'{name}: padding not zero')
    in_flip = torch.zeros(norm_k.shape, dtype=torch.bool, device=fin.device)
    ref_flip = torch.zeros(pref_k.shape[:2], dtype=torch.bool,
                           device=fin.device)
    if not bf16:
        err_ref = float((pref_k - pref_p).abs().max())
        err_norm = float(((norm_k - norm_p).abs() / norm_p).max())
        check(err_ref <= PROLOGUE_F32_TOL and err_norm <= PROLOGUE_F32_TOL,
              f'{name}: ref patches off by {err_ref}, norms by {err_norm}')
        rec.update(max_abs_err=err_ref, norm_rel_err=err_norm,
                   tolerance=PROLOGUE_F32_TOL)
    else:
        # input norms: only near a midpoint, and one ulp off
        in_flip = norm_k != norm_p
        sq_in = pin_p.float().square().sum(-1)
        lo, hi = _bf16_neighbours(norm_p)
        check(bool(((norm_k == lo) | (norm_k == hi))[in_flip].all()),
              f'{name}: an input norm is more than one bf16 ulp off')
        # ref patches: the quotients of a neighbouring divisor, near a
        # midpoint
        raw = correlation.sample_patches(fref, 3, ref_stride).reshape(
            pref_p.shape)
        sq_ref = raw.float().square().sum(-1)
        ref_flip = (pref_k != pref_p).any(-1)
        rows = raw[ref_flip].float()
        denom = correlation.add_scalar(correlation.l2_norm(
            raw, 2, keepdim=True), 1e-5)[ref_flip]
        explained = torch.zeros(rows.shape[0], dtype=torch.bool,
                                device=fin.device)
        for nb in _bf16_neighbours(denom):
            explained |= ((rows / nb.float()).to(BF16)
                          == pref_k[ref_flip]).all(-1)
        check(bool(explained.all()), f'{name}: a ref patch differs by more '
              'than a neighbouring norm explains')
        dist_ulps = torch.cat([_midpoint_ulps(sq_in)[in_flip],
                               _midpoint_ulps(sq_ref)[ref_flip]])
        worst = int(dist_ulps.max()) if dist_ulps.numel() else 0
        check(worst <= PROLOGUE_MID_ULPS, f'{name}: a norm differs whose '
              f'f32 sum lies {worst} ulps from a bf16 midpoint')
        rec.update(max_abs_err=float((pref_k.float() - pref_p.float())
                                     .abs().max()),
                   in_norms_rounded_apart=int(in_flip.sum()),
                   ref_norms_rounded_apart=int(ref_flip.sum()),
                   rounded_apart_worst_midpoint_ulps=worst,
                   midpoint_ulps_tolerance=PROLOGUE_MID_ULPS)
    del pin_p, pref_p, norm_p
    if not timed:
        return rec, in_flip, ref_flip
    ms, plain_ms = cuda_ms_each([lambda: correlation._prologue_cuda(*args),
                                 lambda: correlation._prologue_ref(*args)],
                                K1_REPS, warmup=3)
    out_bytes = fin.element_size() * (pin_k.shape[0] * pin_k.stride(1)
                                      * (pin_k.shape[1] + pref_k.shape[1])
                                      + norm_k.numel())
    bound_ms, bound_by = bound(
        2.0 * (pin_k.numel() + pref_k.numel()),
        fin.element_size() * (fin.numel() + fref.numel()) + out_bytes)
    rec.update(name=name, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               library_call=None)
    emit(rec)
    return ({k: rec[k] for k in ('name', 'max_abs_err', 'ms', 'plain_ms',
                                 'bound_ms', 'bound_by', 'library_ms')},
            in_flip, ref_flip)


def phase_feature_match(correlation, pairs=T, h=CANVAS // 4, ties=True,
                        dtype=torch.float32):
    """K1 against its plain version on ``pairs`` pairs of (h, h, 256)
    maps: the eval shape by default; f32 (3xTF32) or bf16 (wgmma). First
    the prologue against its plain version; then the match kernel against
    the plain match behind the same prologue outputs; then the function
    end to end against its plain version (at bf16 leaving out the rows a
    norm rounded apart by the prologue touches). Returns the K1 record and
    the prologue's."""
    T = pairs  # noqa: N806 (the pair count, whatever the module's T)
    bf16 = dtype == BF16
    name = 'feature_match_bf16' if bf16 else 'feature_match'
    gen = torch.Generator().manual_seed(SEED)
    feats = torch.randn((2, T, h, h, 256), generator=gen).cuda()
    feats = (feats / (feats.norm(dim=-1, keepdim=True) + 1e-12)).to(dtype)
    fin, fref = feats[0], feats[1]
    del feats
    kw = dict(is_norm=True, norm_input=True)
    shape = 'eval' if h == CANVAS // 4 else 'train'
    prologue, in_flip, ref_flip = phase_prologue(correlation, fin, fref,
                                                 shape)

    # the match behind the same prologue outputs
    pin, pref, norm = correlation._prologue_cuda(fin, fref, 3, 1, 1, True)
    denom = norm.float() + float(torch.tensor(1e-5, dtype=dtype))
    idx_m, val_m = correlation._match_patches_cuda(pin, pref)
    idx_r, val_r = correlation._match_patches_ref(pin, pref, 2048)
    match_err = float(((val_m - val_r) / denom).abs().max())
    m_differ, m_gap = _index_gap(pin.float(), pref.float(), idx_m, idx_r)
    check(m_gap <= K1_IDX_GAP, f'{name} kernel index differs from the plain '
          f'match where the scores differ by {m_gap}')
    check(match_err <= K1_VAL_TOL, f'{name} kernel val error {match_err} '
          'behind the same prologue')
    del idx_m, val_m, idx_r, val_r

    # the function end to end
    idx_k, val_k = correlation.feature_match_index(fin, fref, **kw)
    idx_p, val_p = correlation.feature_match_index_ref(fin, fref, **kw)
    check(val_k.dtype == torch.float32, f'{name} val is {val_k.dtype}')
    flat_k, flat_p = idx_k.reshape(T, -1).long(), idx_p.reshape(T, -1).long()
    keep = ~(in_flip | ref_flip.gather(1, flat_k)
             | ref_flip.gather(1, flat_p))
    pin_p, pref_p = _normed_patches(correlation, fin, fref)
    differ, worst_gap = _index_gap(pin_p, pref_p, idx_k, idx_p, keep)
    del pin_p, pref_p
    val_err = float((val_k - val_p).reshape(T, -1).abs()[keep].max())
    check(worst_gap <= K1_IDX_GAP, f'{name} index differs where the '
          f'plain scores differ by {worst_gap}')
    check(val_err <= K1_VAL_TOL, f'{name} val error {val_err}')

    ties = _feature_match_ties(correlation, dtype) if ties else None

    n_in, d = pin.shape[1:]
    n_ref = pref.shape[1]
    # the library's product also with n padded to a multiple of 8 (15129
    # is odd); the function, the kernel alone and the library in turn
    n8_in, n8_ref = -(-n_in // 8) * 8, -(-n_ref // 8) * 8
    pin8 = pin.new_zeros((T, n8_in, d))
    pref8 = pref.new_zeros((T, n8_ref, d))
    pin8[:, :n_in], pref8[:, :n_ref] = pin, pref
    timed = {'ms': lambda: correlation.feature_match_index(fin, fref, **kw),
             'kernel_only_ms': lambda: correlation._match_patches_cuda(
                 pin, pref),
             'library_ms': lambda: torch.matmul(pin, pref.transpose(1, 2)),
             'library_padded_ms': lambda: torch.matmul(
                 pin8, pref8.transpose(1, 2))}
    if bf16:    # the f32 kernel on the same values
        timed['f32_kernel_same_values_ms'] = (
            lambda a=pin.float(), b=pref.float():
            correlation._match_patches_cuda(a, b))
    times = dict(zip(timed, cuda_ms_each(list(timed.values()), K1_REPS,
                                         warmup=3)))
    del timed, pin8, pref8
    ms, kernel_ms = times.pop('ms'), times.pop('kernel_only_ms')
    library_ms = times.pop('library_ms')
    library_padded_ms = times.pop('library_padded_ms')
    extra = times
    plain_ms = cuda_ms(
        lambda: correlation.feature_match_index_ref(fin, fref, **kw), reps=2)
    flops = 2.0 * T * n_in * n_ref * d
    nbytes = fin.element_size() * 2 * fin.numel() + 8.0 * T * n_in
    if bf16:
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    else:   # the three TF32 products the kernel runs; and f32 SIMT
        bound_ms, bound_by = bound([(3 * flops, PEAK_TF32_FLOPS)], nbytes)
        extra['bound_f32_cuda_cores_ms'] = bound(flops, nbytes)[0]
    rec = {'name': name, 'max_abs_err': val_err,
           'match_max_abs_err': match_err, 'ms': ms,
           'kernel_only_ms': kernel_ms, 'prologue_ms': prologue['ms'],
           **extra, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
           'bound_by': bound_by,
           'bound_note': 'dense bf16 tensor cores' if bf16 else
                         '3 x the FLOPs at the TF32 tensor-core rate',
           'library_ms': library_ms,
           'library_padded_ms': library_padded_ms,
           'library_call': f'torch.matmul of the ({T}, {n_in}, {d}) x '
                           f'({T}, {d}, {n_ref}) score product alone'
                           + (' (bf16 scores)' if bf16 else '')
                           + f'; padded: n {n8_in} x {n8_ref}'}
    emit({'phase': name, 'shape': shape, 'pairs': T, 'n_in': n_in,
          'n_ref': n_ref, 'd': d, 'index_disagreements': int(differ.sum()),
          'worst_disagreement_gap': worst_gap,
          'rows_left_out_rounded_apart': int((~keep).sum()),
          'match_index_disagreements': int(m_differ.sum()),
          'match_worst_disagreement_gap': m_gap, 'exact_ties': ties,
          'val_tolerance': K1_VAL_TOL, 'index_gap_tolerance': K1_IDX_GAP,
          **rec})
    return rec, prologue


def _normed_patches(correlation, fin, fref):
    """The input patches and the ref patches over their norms, as K1's
    plain version scores them: ``(pairs, n, d)`` each, the norms rounded
    as the port rounds them at bf16, widened to f32."""
    pin = correlation.sample_patches(fin)
    pref = correlation.sample_patches(fref)
    pin = pin.reshape((-1,) + pin.shape[-2:])
    pref = pref.reshape((-1,) + pref.shape[-2:])
    pref = pref / correlation.add_scalar(
        correlation.l2_norm(pref, 2, keepdim=True), 1e-5)
    return pin.float(), pref.float()


def _index_gap(pin, pref, idx_a, idx_b, keep=None):
    """Where two matches of the same patches pick other ref patches: the
    mask, and the largest difference of the two picks' plain scores (over
    the input rows ``keep`` holds, if given)."""
    pairs = pin.shape[0]

    def score(idx):
        rows = pref.gather(1, idx.reshape(pairs, -1, 1).long().expand(
            -1, -1, pref.shape[2]))
        return (pin * rows).sum(2)

    differ = idx_a.reshape(pairs, -1) != idx_b.reshape(pairs, -1)
    if keep is not None:
        differ &= keep
    gap = (score(idx_b) - score(idx_a)).abs()[differ]
    return differ, float(gap.max()) if gap.numel() else 0.0


def _feature_match_ties(correlation, dtype=torch.float32):
    """Exact ties on the card: features in {-1, 0, 1}, C = 1 (d = 9, not a
    multiple of the kernel's d slice, nor of the bf16 kernel's 16-byte
    loads), 40x40 maps, so equal ref patches are common, across threads,
    tiles and blocks, and every score is an exact integer. The kernel must
    return the lowest index of each max."""
    gen = torch.Generator().manual_seed(SEED + 3)
    feats = torch.randint(-1, 2, (2, 2, 40, 40, 1), generator=gen)
    fin, fref = feats.to(dtype).cuda()
    idx, val = correlation.feature_match_index(fin, fref, is_norm=False)
    pin = correlation.sample_patches(fin).float()
    pref = correlation.sample_patches(fref).float()
    scores = torch.matmul(pin, pref.transpose(1, 2))
    best = scores.max(dim=2).values
    cols = torch.arange(scores.shape[2], device=scores.device)
    lowest = torch.where(scores == best[..., None], cols,
                         scores.shape[2]).min(dim=2).values
    tied = int(((scores == best[..., None]).sum(2) > 1).sum())
    check(torch.equal(idx.reshape(best.shape).long(), lowest),
          'feature_match does not take the lowest index among equal maxima')
    check(torch.equal(val.reshape(best.shape), best),
          'feature_match scores differ from the exact integer scores')
    check(tied > 0, 'the tie case holds no tie')
    return {'patches': int(best.numel()), 'tied': tied}


def _mdcn_inputs(gen, c, h, dg=8, n=T, dtype=torch.float32, w=None,
                 cout=None):
    """x, offset, mask, weight, bias on the card for an ``h`` x ``w`` map
    (square by default) and ``cout`` outputs (C by default); all but the
    offset (f32, as the bf16 path's promotion makes it) in ``dtype``."""
    k = 9
    w = h if w is None else w
    cout = c if cout is None else cout
    x = torch.randn((n, h, w, c), generator=gen)
    offset = torch.randn((n, h, w, dg, k, 2), generator=gen) * 4
    mask = torch.rand((n, h, w, dg, k), generator=gen)
    weight = torch.randn((3, 3, c, cout), generator=gen) * 0.02
    bias = torch.randn((cout,), generator=gen) * 0.1
    return [t.cuda() if t is offset else t.to(dtype).cuda()
            for t in (x, offset, mask, weight, bias)]


# K2 and K4 at bf16, kernel against plain version: both sample in f32 and
# round each result to bf16 once, so a value whose two f32 sums straddle a
# rounding boundary differs by one bf16 ulp, at most EPS_BF16 of the
# largest magnitude; a result derived from such values (the conv output,
# grad weight, grad x) by two. Every gradient included. Measured (H100,
# the first run of these phases): 0.95 EPS_BF16 at most (grad x of K2 at
# C 128), grad offset and grad flow within 1.6e-7.
K2_BF16_TOL = 2 * EPS_BF16


def _k2_tol(dtype):
    return K2_BF16_TOL if dtype == BF16 else K2_REL_TOL


# K2's products: 3xTF32 at f32 (three TF32 products a multiply-add, at the
# tensor cores' TF32 rate) and one bf16 product at bf16; the bound of an f32
# record is the 3xTF32 one, the CUDA-core bound beside it
def _k2_products(macs, dtype):
    """The ``(operations, peak)`` of ``macs`` multiply-adds of K2's
    contraction at ``dtype``."""
    if dtype == BF16:
        return (2.0 * macs, PEAK_BF16_FLOPS)
    return (3 * 2.0 * macs, PEAK_TF32_FLOPS)


def _k2_cores_bound(macs, other, nbytes):
    """The f32 CUDA-core bound of the same work, ms."""
    return bound([(2.0 * macs, PEAK_F32_FLOPS), *other], nbytes)[0]


# the video nets' K2 shapes, f32: (case, N, C, Cout, H, W, deform groups):
# BasicVSR++'s SecondOrderDeformableAlignment on the REDS config (one
# 180x320 frame a call, 2 x 64 channels in, 16 groups) and EDVR-M's L1
# DCNv2Pack (5 frames folded into the batch)
VIDEO_K2_SHAPES = (('basicvsrpp', 1, 128, 64, 180, 320, 16),
                   ('edvr_l1', T, 64, 64, 180, 320, 8))


def phase_mdcn(dcn, n=T, shapes=EVAL_SHAPES, dtype=torch.float32,
               video=False):
    """K2's forward, the fused kernel ``mdcn_fused_fwd`` (f32, 3xTF32) or
    ``mdcn_fused_fwd_bf16``, against its plain version on ``n`` maps per
    shape: the eval shapes by default, or with ``video`` the video nets'
    (``VIDEO_K2_SHAPES``); ``kernel_only_ms`` is the kernel's launch
    alone."""
    gen = torch.Generator().manual_seed(SEED + 1)
    total = {key: 0.0 for key in (
        'ms', 'call_ms', 'kernel_only_ms', 'kernel_only_call_ms', 'plain_ms',
        'plain_call_ms', 'library_ms', 'library_call_ms', 'bound_ms',
        'bound_f32_cuda_cores_ms', 'flops', 'bytes')}
    worst, ops_s = 0.0, 0.0
    size = torch.finfo(dtype).bits // 8
    tol = _k2_tol(dtype)
    cases = (VIDEO_K2_SHAPES if video else
             tuple((None, n, c, c, h, h, 8) for c, h in shapes))
    for case, n_maps, c, cout, h, w, dg in cases:
        x, offset, mask, weight, bias = _mdcn_inputs(
            gen, c, h, dg=dg, n=n_maps, dtype=dtype, w=w, cout=cout)
        args = (x, offset, mask, weight, bias)
        kw = dict(deform_groups=dg)
        out_k = dcn.modulated_deform_conv2d(*args, **kw)
        out_p = dcn.modulated_deform_conv2d_ref(*args, **kw)
        check(out_k.dtype == dtype, f'mdcn output is {out_k.dtype}')
        err = float((out_k - out_p).abs().max())
        scale = float(out_p.abs().max())
        check(err <= tol * scale, f'mdcn {case or ""} C={c} {dtype}: error '
              f'{err} against max |out| {scale}')
        worst = max(worst, err)
        del out_k, out_p

        rows = n_maps * h * w
        geom = ((3, 3), (1, 1), (1, 1), (1, 1), (h, w))
        # the operand the kernel reads: at f32 the weight's TF32 planes
        wt = dcn._weight_operand(weight.reshape(9 * c, cout).t()
                                 .contiguous())
        out_buf = torch.empty((rows, cout), dtype=dtype, device='cuda')
        fused = dcn._fused_args(x, offset, weight, geom)

        def kernel_only():
            dcn._fused_kernels(dtype)[0](
                x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                wt.data_ptr(), bias.data_ptr(), out_buf.data_ptr(), *fused)

        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = weight.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        # the contraction at the dtype's rate, the sampling on CUDA cores
        macs = rows * 9.0 * c * cout
        sampling = [(9.0 * rows * 9 * c, PEAK_F32_FLOPS)]
        flops = [_k2_products(macs, dtype), *sampling]
        nbytes = size * (x.numel() + mask.numel() + weight.numel()
                         + bias.numel() + rows * cout) \
            + 4.0 * offset.numel()
        ops_s += sum(f / p for f, p in flops)
        shape = timed({
            'ms': lambda: dcn.modulated_deform_conv2d(*args, **kw),
            'kernel_only_ms': kernel_only,
            'plain_ms': lambda: dcn.modulated_deform_conv2d_ref(*args, **kw),
            'library_ms': lambda: torch.nn.functional.conv2d(
                x_nchw, w_oihw, bias, padding=1)})
        shape.update(bound_ms=bound(flops, nbytes)[0],
                     bound_f32_cuda_cores_ms=_k2_cores_bound(macs, sampling,
                                                             nbytes),
                     flops=sum(f for f, _ in flops), bytes=nbytes)
        bf16 = dtype == BF16
        emit({'phase': 'mdcn_bf16' if bf16 else 'mdcn',
              **({'case': case} if case else {}), 'n': n_maps, 'c': c,
              'cout': cout, 'h': h, 'w': w, 'deform_groups': dg,
              'dtype': str(dtype), 'max_abs_err': err, 'max_abs_out': scale,
              'tolerance': tol, 'bound_by': bound(flops, nbytes)[1],
              **shape})
        for key in total:
            total[key] += shape[key]
        del x, offset, mask, weight, bias, args, x_nchw, w_oihw, wt
        del out_buf, kernel_only
        torch.cuda.empty_cache()
    flops, nbytes = total.pop('flops'), total.pop('bytes')
    return {'name': 'mdcn_fused_fwd_bf16' if dtype == BF16
            else 'mdcn_fused_fwd',
            'max_abs_err': worst, **total,
            'bound_by': ('operations' if ops_s >= nbytes / PEAK_BYTES
                         else 'bytes'),
            'library_call': f'F.conv2d (cuDNN) of the same shapes in '
                            f'{dtype}: the same conv with zero offsets and '
                            'unit mask, a lower bound (no gather)',
            'timing': TIMING_NOTE}


TRAIN_B, TRAIN_GT = 6, 160              # options/train/stage3_5ref_*.yml
TRAIN_SHAPES = tuple((c, TRAIN_GT // d) for c, d in ((256, 4), (128, 2),
                                                     (64, 1)))
# max |kernel - plain| / max |plain| of each gradient: f32 sums over a
# group's channels (and, for grad x, atomic adds) in another order
GRAD_REL_TOL = 1e-4
# the inputs whose gradients a training step takes from K2: offset, mask,
# weight, bias (x is a frozen feature)
STEP_WRT = (1, 2, 3, 4)


def _rel_err(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _sum_records(name, shapes, extra):
    """One ``kernels`` entry out of a kernel's per-shape records; a
    record's ``ops_s``, where it has one, is its operations' least time
    (operations of several types), else its ``flops`` count at f32."""
    keys = ('ms', 'call_ms', 'kernel_only_ms', 'kernel_only_call_ms',
            'kernel_only_with_grad_x_ms', 'kernel_only_with_grad_x_call_ms',
            'with_grad_x_ms', 'with_grad_x_call_ms', 'plain_ms',
            'plain_call_ms', 'library_ms', 'library_call_ms', 'bound_ms',
            'bound_f32_cuda_cores_ms', 'bound_with_atomics_ms', 'dgrad_ms',
            'near_offsets_ms', 'near_offsets_call_ms',
            'with_grad_x_near_offsets_ms',
            'with_grad_x_near_offsets_call_ms')
    total = {k: sum(rec[k] for rec in shapes) for k in keys
             if k in shapes[0]}
    ops_s = sum(rec.get('ops_s', rec['flops'] / PEAK_F32_FLOPS)
                for rec in shapes)
    nbytes = sum(rec['bytes'] for rec in shapes)
    return {'name': name,
            'max_abs_err': max(rec['max_abs_err'] for rec in shapes),
            'max_rel_err': max(rec['max_rel_err'] for rec in shapes),
            **total, 'bound_by': ('operations' if ops_s >= nbytes / PEAK_BYTES
                                  else 'bytes'), **extra}


def _mdcn_grads(fn, args, cot, wrt):
    inputs = [a.detach().requires_grad_(i in wrt)
              for i, a in enumerate(args)]
    out = fn(*inputs, deform_groups=8)
    return torch.autograd.grad(out, [inputs[i] for i in wrt], cot)


def _mdcn_backward_integer_case(dcn, gen, dtype=torch.float32):
    """Integer offsets on a 40x40 map, as a fresh net has them: every
    sample sits on a pixel, many of them exactly on row or column -1 or
    H - 1, where one corner row lies outside."""
    c, h = 256, TRAIN_GT // 4
    x, offset, mask, weight, bias = _mdcn_inputs(gen, c, h, dtype=dtype)
    offset = torch.randint(-3, 4, offset.shape, generator=gen).float().cuda()
    cot = torch.randn((T, h, h, c), generator=gen).to(dtype).cuda()
    base = torch.arange(h, device='cuda').view(1, h, 1, 1, 1) - 1 \
        + (torch.arange(9, device='cuda') // 3).view(1, 1, 1, 1, 9)
    fy = base + offset[..., 0]
    on_edge = int(((fy == -1) | (fy == h - 1)).sum())
    check(on_edge > 0, 'the integer case holds no sample on row -1 or H - 1')
    args = (x, offset, mask, weight, bias)
    got = _mdcn_grads(dcn.modulated_deform_conv2d, args, cot, range(5))
    want = _mdcn_grads(dcn.modulated_deform_conv2d_ref, args, cot, range(5))
    # and as the training step runs it: no grad x, so no scatter
    step = _mdcn_grads(dcn.modulated_deform_conv2d, args, cot, STEP_WRT)
    names = ('x', 'offset', 'mask', 'weight', 'bias')
    errs, step_errs = {}, {}
    tol = GRAD_REL_TOL if dtype == torch.float32 else K2_BF16_TOL
    for name, g, w in zip(names, got, want):
        errs[name] = _rel_err(g.float(), w.float())
    for i, g in zip(STEP_WRT, step):
        step_errs[names[i]] = _rel_err(g.float(), want[i].float())
    for label, found in (('', errs), (' as the step runs it', step_errs)):
        for name, err in found.items():
            check(err <= tol, f'mdcn backward, integer offsets{label}, '
                  f'{dtype}: grad {name} differs by {err} of its max')
    check(float(got[1].abs().max()) > 0, 'grad offset is zero at integer '
          'offsets')
    return {'samples_on_edge_rows': on_edge, 'rel_err': errs,
            'step_rel_err': step_errs}


def _fused_backward_parts(dcn, x, offset, mask, weight, cot, want):
    """The fused backward's entry points alone at one shape, at x's type:
    dgrad and wgrad with the ordered sum of its partials (the ones the
    training step launches), and dgrad's grad-x scatter variant, each with
    its bound, plain version and library call. Each entry point's record
    carries the errors of what its own launch wrote against ``want``, the
    plain version's gradients by name: dgrad grad offset and grad mask, the
    scatter variant also grad x, wgrad and the sum grad weight and grad
    bias. The scatter's record also carries the dgrad's ms and its own
    under offsets uniform on [-SCATTER_NEAR, SCATTER_NEAR] (``near_offsets_*``,
    held to the plain version first)."""
    n, h, _, c = x.shape
    dtype = x.dtype
    size = x.element_size()
    rows = n * h * h
    geom = ((3, 3), (1, 1), (1, 1), (1, 1), (h, h))
    fused = dcn._fused_args(x, offset, weight, geom)
    splits, split_patches = dcn._wgrad_slices(n, h, h, 9, c, c, dtype)
    _, k_dgrad, k_scatter, k_wgrad, k_sum = dcn._fused_kernels(dtype)
    g_off, g_mask = torch.empty_like(offset), torch.empty_like(mask)
    g_x = torch.zeros_like(x, dtype=torch.float32)
    partial = torch.empty((splits, 9 * c + 1, c), device='cuda')
    total = torch.empty((9 * c + 1, c), device='cuda')
    head = (cot.data_ptr(), x.data_ptr(), offset.data_ptr(), mask.data_ptr())
    w_op = dcn._weight_operand(weight)  # at f32 its TF32 planes
    dgrad = (*head, w_op.data_ptr(), g_off.data_ptr(), g_mask.data_ptr())
    launch = {
        'dgrad': lambda: k_dgrad(*dgrad, *fused),
        'dgrad_scatter': lambda: k_scatter(*dgrad, g_x.data_ptr(), *fused),
        'wgrad': lambda: k_wgrad(*head, partial.data_ptr(), splits,
                                 split_patches, *fused),
        'wgrad_sum': lambda: k_sum(partial.data_ptr(), total.data_ptr(),
                                   splits, total.numel(), fused[-1])}

    def written(part):
        """What one launch of ``part`` writes, by name, as the Function
        hands it on: wgrad's partials through the sum; the sum's from
        wgrad's last launch."""
        for buf in ((total,) if part == 'wgrad_sum'
                    else (g_off, g_mask, partial, total)):
            buf.fill_(float('nan'))     # what no launch writes shows
        g_x.zero_()
        launch[part]()
        if part == 'wgrad':
            launch['wgrad_sum']()
        if part.startswith('wgrad'):
            return {'weight': total[:-1].reshape(weight.shape).to(
                        dtype, copy=True),
                    'bias': total[-1].to(dtype, copy=True)}
        got = {'offset': g_off.clone(), 'mask': g_mask.clone()}
        if part == 'dgrad_scatter':
            got['x'] = g_x.to(dtype, copy=True)
        return got

    outs = {part: written(part) for part in launch}

    def plain(wrt):
        inputs = [a.detach().requires_grad_(i in wrt) for i, a in
                  enumerate((x, offset, mask, weight))]
        out = dcn.modulated_deform_conv2d_ref(*inputs, deform_groups=8)
        return lambda: torch.autograd.grad(
            out, [inputs[i] for i in wrt], cot, retain_graph=True)

    x_nchw = x.permute(0, 3, 1, 2).requires_grad_()
    w_oihw = weight.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    out_l = torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1)
    cot_l = cot.permute(0, 3, 1, 2)

    def library(wrt):
        return lambda: torch.autograd.grad(out_l, wrt, cot_l,
                                           retain_graph=True)

    ordered = lambda: sum(partial[i] for i in range(1, splits))  # noqa: E731
    macs = rows * 9.0 * c * c
    mm = _k2_products(macs, dtype)
    col2im = (20.0 * rows * 9 * c, PEAK_F32_FLOPS)
    sample = (9.0 * rows * 9 * c, PEAK_F32_FLOPS)
    # every input read once, every output written once: grad offset (f32)
    # and mask, grad x at x's type (as the Function returns it), the f32
    # partials of grad weight and bias
    ins = size * (cot.numel() + x.numel() + mask.numel()) \
        + 4.0 * offset.numel()
    outs_bytes = size * mask.numel() + 4.0 * offset.numel()
    spec = {
        'dgrad': ([mm, col2im], ins + size * weight.numel() + outs_bytes,
                  lambda: plain((1, 2)), lambda: library(x_nchw)),
        'dgrad_scatter': ([mm, col2im], ins + size * weight.numel()
                          + outs_bytes + size * x.numel(),
                          lambda: plain((0, 1, 2)), lambda: library(x_nchw)),
        'wgrad': ([mm, sample], ins + 4.0 * partial.numel(),
                  lambda: plain((3,)), lambda: library(w_oihw)),
        'wgrad_sum': ([(float(partial.numel()), PEAK_F32_FLOPS)],
                      4.0 * (partial.numel() + total.numel()),
                      lambda: lambda: partial[0] + ordered(),
                      lambda: lambda: partial.sum(0))}
    recs = {}
    for part, fn in launch.items():
        flops, nbytes, plain_fn, library_fn = spec[part]
        if part == 'dgrad_scatter':
            g_x.zero_()
        times = timed({'ms': fn, 'plain_ms': plain_fn(),
                       'library_ms': library_fn()})
        got = outs[part]
        errs = {name: _rel_err(g.float(), want[name].float())
                for name, g in got.items()}
        tol = K2_BF16_TOL if dtype == BF16 else GRAD_REL_TOL
        for name, err in errs.items():
            check(err <= tol, f'{part} alone, C={c} {dtype}: grad {name} '
                  f'differs by {err} of its max')
        products = part in ('dgrad', 'dgrad_scatter', 'wgrad')
        recs[part] = {
            **times, 'kernel_only_ms': times['ms'],
            'kernel_only_call_ms': times['call_ms'],
            'bound_ms': bound(flops, nbytes)[0],
            'bound_f32_cuda_cores_ms': (
                _k2_cores_bound(macs, flops[1:], nbytes) if products
                else bound(flops, nbytes)[0]),
            'flops': sum(f for f, _ in flops),
            'ops_s': sum(f / p for f, p in flops), 'bytes': nbytes,
            'max_abs_err': max(float((g.float() - want[name].float())
                                     .abs().max())
                               for name, g in got.items()),
            'max_rel_err': max(errs.values()), 'rel_err': errs}
    scatter = recs['dgrad_scatter']
    scatter['bound_with_atomics_ms'] = scatter_atomics_bound(
        spec['dgrad_scatter'][0], spec['dgrad_scatter'][1], x)
    scatter['dgrad_ms'] = recs['dgrad']['ms']
    # the scatter again under offsets uniform on [-SCATTER_NEAR,
    # SCATTER_NEAR], held to the plain version first
    near = _near_offsets(torch.Generator().manual_seed(SEED + 35), offset)
    fused_near = dcn._fused_args(x, near, weight, geom)
    head_near = (cot.data_ptr(), x.data_ptr(), near.data_ptr(),
                 mask.data_ptr(), w_op.data_ptr(), g_off.data_ptr(),
                 g_mask.data_ptr())

    def scatter_near():
        k_scatter(*head_near, g_x.data_ptr(), *fused_near)

    errs, abs_err = _scatter_vs_plain(
        dcn, scatter_near, cot, x, near, mask, weight, 8, g_off, g_mask, g_x,
        K2_BF16_TOL if dtype == BF16 else GRAD_REL_TOL,
        f'dgrad_scatter alone, near offsets, C={c} {dtype}')
    times = timed({'ms': scatter_near})
    scatter.update(near_offsets_ms=times['ms'],
                   near_offsets_call_ms=times['call_ms'],
                   near_offsets_rel_err=errs,
                   near_offsets_max_abs_err=abs_err)
    del near
    return recs


def weight_split_record(dcn):
    """K2's f32 weight split, ``mdcn_fused_split`` (one launch before each
    f32 forward and dgrad, of K3 and K5 too), against its plain version
    ``dcn._split_tf32_ref``, bit for bit (and hi + lo == w exactly), and
    timed, at the weights of the eval and training shapes (9 C x Cout, C =
    Cout = 64, 128, 256: wt for the forward, the HWIO weight for dgrad, the
    same size). Returns its record of the ``kernels`` line; no phase line of
    its own."""
    gen = torch.Generator().manual_seed(SEED + 61)
    keys = ('ms', 'call_ms', 'plain_ms', 'plain_call_ms', 'bound_ms')
    total = {key: 0.0 for key in keys}
    shapes = []
    for c in sorted({c for c, _ in EVAL_SHAPES + TRAIN_SHAPES}):
        w = (torch.randn((9 * c, c), generator=gen) * 0.02).cuda()
        planes = torch.empty((2, *w.shape), device='cuda')

        def kernel():
            dcn.mdcn_fused_split_kernel(
                w.data_ptr(), planes.data_ptr(), w.numel(),
                torch.cuda.current_stream().cuda_stream)

        kernel()
        want = dcn._split_tf32_ref(w)
        check(torch.equal(planes.view(torch.int32), want.view(torch.int32)),
              f'mdcn_fused_split differs from its plain version at C={c}')
        check(torch.equal(planes[0] + planes[1], w),
              f'mdcn_fused_split: hi + lo != w at C={c}')
        times = timed({'ms': kernel,
                       'plain_ms': lambda: dcn._split_tf32_ref(w)})
        # w read once, both planes written once; three operations an
        # element
        b_ms = bound([(3.0 * w.numel(), PEAK_F32_FLOPS)],
                     12.0 * w.numel())[0]
        shapes.append({'c': c, 'cout': c, 'elements': w.numel(), **times,
                       'bound_ms': b_ms})
        for key in keys:
            total[key] += shapes[-1][key]
        del w, planes, want
    return {'name': 'mdcn_fused_split', 'max_abs_err': 0.0, **total,
            'bound_by': 'bytes', 'library_ms': None,
            'library_call': 'none (no one PyTorch call splits to TF32)',
            'shapes': shapes, 'timing': TIMING_NOTE}


def scatter_atomics_bound(flops, nbytes, x):
    """The bound of K2's scatter dgrad with what its atomics cost beside
    the work: grad x read and written in f32 (8 bytes an element) where
    the work writes it once at x's type. Reported beside ``bound_ms``,
    never in its place."""
    return bound(flops, nbytes + (8.0 - x.element_size()) * x.numel())[0]


def phase_mdcn_backward(dcn, dtype=torch.float32):
    """K2's backward against autograd through the plain version, at the
    three training shapes, every gradient (x's too, through dgrad's scatter
    variant): the fused kernels, f32 (3xTF32) or bf16, then again as the
    training step runs them, x frozen: dgrad, wgrad and the sum, every
    gradient checked and two calls bit-equal in grad offset, grad mask,
    grad weight and grad bias; the offset f32 either way. Returns the
    records of the ``kernels`` line, one for each fused backward entry
    point, alone, with the errors of what it wrote."""
    gen = torch.Generator().manual_seed(SEED + 4)
    n = TRAIN_B * T
    names = ('x', 'offset', 'mask', 'weight', 'bias')
    bf16 = dtype == BF16
    tol = K2_BF16_TOL if bf16 else GRAD_REL_TOL
    size = torch.finfo(dtype).bits // 8
    shapes, parts = [], []
    for c, h in TRAIN_SHAPES:
        args = [t.repeat(TRAIN_B, *[1] * (t.dim() - 1)) if i < 3 else t
                for i, t in enumerate(_mdcn_inputs(gen, c, h, dtype=dtype))]
        args[1] = args[1] * 0.5 + torch.randn(args[1].shape, generator=gen,
                                              device='cpu').cuda()
        x, offset, mask, weight, bias = args
        cot = torch.randn((n, h, h, c), generator=gen).to(dtype).cuda()
        got = _mdcn_grads(dcn.modulated_deform_conv2d, args, cot, range(5))
        want = _mdcn_grads(dcn.modulated_deform_conv2d_ref, args, cot,
                           range(5))
        errs, abs_err = {}, 0.0
        for name, g, w in zip(names, got, want):
            check(g.dtype == w.dtype, f'grad {name} is {g.dtype}, the plain '
                  f'version\'s {w.dtype}')
            errs[name] = _rel_err(g.float(), w.float())
            abs_err = max(abs_err, float((g.float() - w.float()).abs().max()))
            check(errs[name] <= tol, f'mdcn backward C={c} {dtype}: grad '
                  f'{name} differs by {errs[name]} of its max')
        # as the training step runs it (x a frozen feature: dgrad without
        # its scatter, wgrad, the sum); fixed-order sums, so a second call
        # gives the same bits
        step = _mdcn_grads(dcn.modulated_deform_conv2d, args, cot, STEP_WRT)
        again = _mdcn_grads(dcn.modulated_deform_conv2d, args, cot, STEP_WRT)
        extra = {'step_rel_err': {names[i]: _rel_err(g.float(),
                                                     want[i].float())
                                  for i, g in zip(STEP_WRT, step)}}
        for name, err in extra['step_rel_err'].items():
            check(err <= tol, f'mdcn backward C={c} {dtype} as the step runs '
                  f'it: grad {name} differs by {err} of its max')
        abs_err = max(abs_err, *(float((g.float() - want[i].float())
                                       .abs().max())
                                 for i, g in zip(STEP_WRT, step)))
        extra['bit_equal_rerun'] = {
            names[i]: bool(torch.equal(g, g2))
            for i, g, g2 in zip(STEP_WRT, step, again)}
        check(all(extra['bit_equal_rerun'].values()), f'mdcn backward '
              f'C={c} {dtype}: two calls differ: {extra["bit_equal_rerun"]}')
        del step, again
        parts.append(_fused_backward_parts(
            dcn, x, offset, mask, weight, cot, dict(zip(names, want))))
        del got, want

        # the step's backward through the Function, timed
        inputs = [a.detach().requires_grad_(i in STEP_WRT)
                  for i, a in enumerate(args)]
        out_k = dcn.modulated_deform_conv2d(*inputs, deform_groups=8)
        grad_k = lambda: torch.autograd.grad(  # noqa: E731
            out_k, inputs[1:], cot, retain_graph=True)
        rows = n * h * h
        out_p = dcn.modulated_deform_conv2d_ref(*inputs, deform_groups=8)
        x_nchw = x.permute(0, 3, 1, 2).requires_grad_()
        w_oihw = weight.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        b_lib = bias.detach().requires_grad_()
        out_l = torch.nn.functional.conv2d(x_nchw, w_oihw, b_lib, padding=1)
        cot_l = cot.permute(0, 3, 1, 2)
        times = timed({
            'ms': grad_k,
            'plain_ms': lambda: torch.autograd.grad(
                out_p, inputs[1:], cot, retain_graph=True),
            'library_ms': lambda: torch.autograd.grad(
                out_l, (x_nchw, w_oihw, b_lib), cot_l, retain_graph=True)})
        # the kernels the step launches here, alone
        kernel = {key: sum(rec[key] for part, rec in parts[-1].items()
                           if part != 'dgrad_scatter')
                  for key in ('ms', 'call_ms')}
        scatter = parts[-1]['dgrad_scatter']
        extra.update(chunks=0, **{f'{part}_ms': rec['ms']
                                  for part, rec in parts[-1].items()})
        del out_k, out_p, out_l
        torch.cuda.empty_cache()
        # two products (grad weight, grad columns) at the dtype's rate and
        # the bilinear derivative per column element on CUDA cores; bytes
        # without grad x (the offset and its gradient f32)
        macs = 2.0 * rows * 9 * c * c
        other = [(20.0 * rows * 9 * c, PEAK_F32_FLOPS)]
        flops = [_k2_products(macs, dtype), *other]
        nbytes = size * (cot.numel() + x.numel() + 2 * mask.numel()
                         + 2 * weight.numel() + bias.numel()) \
            + 4.0 * 2 * offset.numel()
        rec = {**times, 'kernel_only_ms': kernel['ms'],
               'kernel_only_call_ms': kernel['call_ms'],
               'kernel_only_with_grad_x_ms': scatter['ms'],
               'kernel_only_with_grad_x_call_ms': scatter['call_ms'],
               'bound_ms': bound(flops, nbytes)[0],
               'bound_f32_cuda_cores_ms': _k2_cores_bound(macs, other,
                                                          nbytes),
               'flops': sum(f for f, _ in flops),
               'ops_s': sum(f / p for f, p in flops),
               'bytes': nbytes, 'max_abs_err': abs_err,
               'max_rel_err': max(*errs.values(),
                                  *extra.get('step_rel_err', {}).values())}
        emit({'phase': 'mdcn_backward_bf16' if bf16 else 'mdcn_backward',
              'n': n, 'c': c, 'h': h, 'w': h, 'deform_groups': 8,
              'dtype': str(dtype), 'rel_err': errs, 'tolerance': tol,
              'bound_by': bound(flops, nbytes)[1], **extra, **rec})
        shapes.append(rec)
        del args, inputs, x, offset, mask, weight, bias, cot, cot_l
        del x_nchw, w_oihw, b_lib
        torch.cuda.empty_cache()
    emit({'phase': 'mdcn_backward_bf16' if bf16 else 'mdcn_backward',
          'case': 'integer offsets', 'tolerance': tol,
          **_mdcn_backward_integer_case(dcn, gen, dtype)})
    tag = '_bf16' if bf16 else ''
    whole = _sum_records(f'mdcn_backward{tag}', shapes, {})
    emit({'phase': f'mdcn_backward{tag}', 'case': 'the training shapes summed',
          **{k: whole[k] for k in ('ms', 'call_ms', 'kernel_only_ms',
                                   'kernel_only_call_ms', 'plain_ms',
                                   'plain_call_ms', 'library_ms',
                                   'library_call_ms', 'bound_ms',
                                   'bound_f32_cuda_cores_ms', 'bound_by')},
          'ms_is': 'the whole backward through the Function; '
                   'kernel_only_ms: its fused kernels alone',
          'timing': TIMING_NOTE})
    calls = {'dgrad': 'autograd of F.conv2d (cuDNN): grad input',
             'dgrad_scatter': 'autograd of F.conv2d (cuDNN): grad input',
             'wgrad': 'autograd of F.conv2d (cuDNN): grad weight; its '
                      'partials hold grad bias too',
             'wgrad_sum': 'torch.sum of the partials over the slices'}
    return [_sum_records(f'mdcn_fused_{part}{tag}',
                         [shape[part] for shape in parts],
                         {'library_call': call + '; at the training shapes '
                          'where the step launches it',
                          'timing': TIMING_NOTE})
            for part, call in calls.items()]


def _grid_for(flow):
    """``F.grid_sample``'s grid for ``flow (N, H, W, dg, 2)`` on the
    ``(N * dg, cg, H, W)`` view, ``align_corners=True``."""
    n, h, w, dg, _ = flow.shape
    ys = torch.arange(h, device=flow.device).view(1, h, 1, 1)
    xs = torch.arange(w, device=flow.device).view(1, 1, w, 1)
    gy = (ys + flow[..., 0]) * (2.0 / (h - 1)) - 1
    gx = (xs + flow[..., 1]) * (2.0 / (w - 1)) - 1
    return torch.stack([gx, gy], -1).permute(0, 3, 1, 2, 4).reshape(
        n * dg, h, w, 2).contiguous()


def _gather_at_integer_flow(x, flow):
    """``x`` indexed at ``(y, x) + flow`` for an integer-valued flow, zero
    outside: the row gather ``out[s, m] = table[s, idx[s, m]]``."""
    n, h, w, c = x.shape
    dg = flow.shape[3]
    ys = torch.arange(h, device=x.device).view(1, h, 1, 1) \
        + flow[..., 0].long()
    xs = torch.arange(w, device=x.device).view(1, 1, w, 1) \
        + flow[..., 1].long()
    inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)    # (N, H, W, dg)
    rows = (torch.arange(n, device=x.device).view(n, 1, 1, 1) * h
            + ys.clamp(0, h - 1)) * w + xs.clamp(0, w - 1)
    table = x.reshape(n * h * w, dg, c // dg)
    g = torch.arange(dg, device=x.device).expand_as(rows)
    out = table[rows.reshape(-1), g.reshape(-1)].reshape(n, h, w, dg, c // dg)
    return (out * inside[..., None]).reshape(n, h, w, c)


def phase_deform_sample(dcn, dtype=torch.float32):
    """K4 (deform_sample forward and backward kernels) against its plain
    version at the three training shapes, and its gather (the Pallas
    experiment's row gather) bit for bit with integer flows; x in f32 or
    bf16, the flow f32."""
    gen = torch.Generator().manual_seed(SEED + 5)
    n, dg = TRAIN_B * T, 8
    bf16 = dtype == BF16
    fwd_tol = K2_BF16_TOL if bf16 else 1e-5
    grad_tol = K2_BF16_TOL if bf16 else GRAD_REL_TOL
    size = torch.finfo(dtype).bits // 8
    fwd, bwd = [], []
    for c, h in TRAIN_SHAPES:
        x = torch.randn((n, h, h, c), generator=gen).to(dtype).cuda()
        flow = (torch.randn((n, h, h, dg, 2), generator=gen) * 3).cuda()
        cot = torch.randn((n, h, h, c), generator=gen).to(dtype).cuda()

        def grads(fn, wrt=(0, 1)):
            inputs = [x.detach().requires_grad_(0 in wrt),
                      flow.detach().requires_grad_(1 in wrt)]
            out = fn(*inputs)
            return out, inputs, torch.autograd.grad(
                out, [inputs[i] for i in wrt], cot, retain_graph=True)

        out_k, _, (gx_k, gf_k) = grads(dcn.deform_sample)
        out_p, _, (gx_p, gf_p) = grads(dcn.deform_sample_ref)
        check(out_k.dtype == gx_k.dtype == dtype and gf_k.dtype ==
              torch.float32, f'deform_sample {dtype}: out {out_k.dtype}, '
              f'grads {gx_k.dtype} {gf_k.dtype}')
        err_out = float((out_k - out_p).detach().float().abs().max())
        rel_out = err_out / float(out_p.detach().float().abs().max())
        check(rel_out <= fwd_tol, f'deform_sample C={c} {dtype}: forward '
              f'error {err_out}, {rel_out} of max |out|')
        errs = {'x': _rel_err(gx_k.float(), gx_p.float()),
                'flow': _rel_err(gf_k, gf_p)}
        for name, e in errs.items():
            check(e <= grad_tol, f'deform_sample C={c} {dtype}: grad {name} '
                  f'differs by {e} of its max')
        err_grad = max(float((gx_k - gx_p).float().abs().max()),
                       float((gf_k - gf_p).abs().max()))
        del out_k, out_p, gx_k, gx_p, gf_k, gf_p

        iflow = torch.randint(-4, 5, flow.shape, generator=gen).float().cuda()
        with torch.no_grad():
            exact = torch.equal(dcn.deform_sample(x, iflow),
                                _gather_at_integer_flow(x, iflow))
        check(exact, f'deform_sample C={c}: integer flows do not copy x '
              f'bit for bit')

        # as the training step runs it: x is a frozen feature, no grad x
        out_k, inp_k, _ = grads(dcn.deform_sample, wrt=(1,))
        out_kx, inp_kx, _ = grads(dcn.deform_sample)
        out_p, inp_p, _ = grads(dcn.deform_sample_ref, wrt=(1,))
        # grid_sample takes its grid in x's dtype
        grid = _grid_for(flow).to(dtype).requires_grad_()
        x_lib = x.reshape(n, h, h, dg, c // dg).permute(0, 3, 4, 1, 2) \
            .reshape(n * dg, c // dg, h, h).contiguous()
        cot_lib = cot.reshape(n, h, h, dg, c // dg).permute(0, 3, 4, 1, 2) \
            .reshape(n * dg, c // dg, h, h).contiguous()

        def library():
            return torch.nn.functional.grid_sample(
                x_lib, grid, mode='bilinear', padding_mode='zeros',
                align_corners=True)

        out_l = library()
        lib_err = float((out_l.detach() - out_p.detach().reshape(
            n, h, h, dg, c // dg).permute(0, 3, 4, 1, 2).reshape(
                out_l.shape)).float().abs().max())
        numel = float(x.numel())
        # some 30 operations per 4 output values, forward and backward
        rec_f = timed({
            'ms': _no_grad(lambda: dcn.deform_sample(x, flow)),
            'plain_ms': _no_grad(lambda: dcn.deform_sample_ref(x, flow)),
            'library_ms': _no_grad(library)})
        rec_f.update({
            'flops': 8.0 * numel,
            'bytes': size * 2 * numel + 4.0 * flow.numel(),
            'max_abs_err': err_out, 'max_rel_err': rel_out})
        rec_b = timed({
            'ms': lambda: torch.autograd.grad(
                out_k, inp_k[1], cot, retain_graph=True),
            'with_grad_x_ms': lambda: torch.autograd.grad(
                out_kx, inp_kx, cot, retain_graph=True),
            'plain_ms': lambda: torch.autograd.grad(
                out_p, inp_p[1], cot, retain_graph=True),
            'library_ms': lambda: torch.autograd.grad(
                out_l, grid, cot_lib, retain_graph=True)})
        rec_b.update({
            'flops': 12.0 * numel,
            'bytes': size * 2 * numel + 4.0 * 2 * flow.numel(),
            'max_abs_err': err_grad, 'max_rel_err': max(errs.values())})
        for rec in (rec_f, rec_b):
            rec['kernel_only_ms'] = rec['ms']
            rec['kernel_only_call_ms'] = rec['call_ms']
            rec['bound_ms'], rec['bound_by'] = bound(rec['flops'],
                                                     rec['bytes'])
        emit({'phase': 'deform_sample_bf16' if bf16 else 'deform_sample',
              'n': n, 'c': c, 'h': h, 'w': h, 'dtype': str(dtype),
              'deform_groups': dg, 'integer_flow_bit_exact': exact,
              'grad_rel_err': errs, 'tolerance': grad_tol,
              'forward_tolerance': fwd_tol,
              'library_vs_plain_max_abs_diff': lib_err,
              'forward': rec_f, 'backward': rec_b, 'timing': TIMING_NOTE})
        fwd.append(rec_f)
        bwd.append(rec_b)
        del x, flow, cot, iflow, out_k, out_kx, out_p, out_l, inp_k, inp_kx
        del inp_p, grid, x_lib, cot_lib
        torch.cuda.empty_cache()
    call = (f'F.grid_sample on the (N * dg, cg, H, W) view in {dtype}, '
            'bilinear, zeros, align_corners=True')
    tag = '_bf16' if bf16 else ''
    return (_sum_records(f'deform_sample_fwd{tag}', fwd,
                         {'library_call': call, 'timing': TIMING_NOTE}),
            _sum_records(f'deform_sample_bwd{tag}', bwd, {
                'library_call': call + ': its autograd in the grid',
                'timing': TIMING_NOTE}))


# ------------------------------------ K3 (conv groups > 1) and K5 (DCNv1)
EDVR_L1 = (T, 180, 320, 64)   # EDVR-M's L1 features of a 5-frame REDS window
DCN_VARIANT_TOL = 1e-4        # max |kernel - plain| / max |plain|, forward
#                               and every gradient (K2_REL_TOL, GRAD_REL_TOL)
K3_TPU = 'mrefsr_tpu/ops/dcn.py:214'
K5_TPU = 'mrefsr_tpu/ops/dcn.py:345'


def _grads_all(fn, args, cot):
    inputs = [a.detach().requires_grad_() for a in args]
    out = fn(*inputs)
    return [out.detach(), *torch.autograd.grad(out, inputs, cot)]


def _no_grad(fn):
    def call():
        with torch.no_grad():
            return fn()
    return call


def _variant_entries(dcn, variant, dtype):
    """The names of ``variant``'s fused entry points at ``dtype``: those a
    call with x frozen launches, and the grad-x scatter."""
    tag = '_bf16' if dtype == BF16 else ''
    prefix = dcn.VARIANTS[variant]
    return ([f'{prefix}_{part}{tag}'
             for part in ('fwd', 'dgrad', 'wgrad', 'wgrad_sum')],
            f'{prefix}_dgrad_scatter{tag}')



def _dcn_variant(dcn, kernels, gen, groups, masked, padding, dtype):
    """One K3 (``masked``, ``groups > 1``) or K5 (not ``masked``) case at
    EDVR-M's L1 shape, deform groups 8, at ``dtype`` (the offset f32):
    forward and every gradient through the fused kernels against the plain
    version, and again with the offsets uniform on [-SCATTER_NEAR,
    SCATTER_NEAR]; the backward as a training step asks it (x frozen) run
    twice, bit-equal, launching the variant's own entry points of the type
    and no other (no scatter); then the device time a call (``ms``) and the
    events around one (``call_ms``) of the forward, of that backward and of
    the backward with grad x (under both offset cases), beside the plain
    version and the library
    yardstick (grouped ``F.conv2d`` and its autograd at the same type: no
    gather, a lower bound). The bound is the grouped work's (MACs / G):
    the kernels run the block-diagonal weight, G times the products.
    Returns the forward and backward records."""
    n, h, w, c = EDVR_L1
    dg, cout = 8, 64
    bf16 = dtype == BF16
    tol = K2_BF16_TOL if bf16 else DCN_VARIANT_TOL
    size = torch.finfo(dtype).bits // 8
    ho, wo = h + 2 * padding - 2, w + 2 * padding - 2
    x = torch.randn((n, h, w, c), generator=gen).to(dtype).cuda()
    offset = (torch.randn((n, ho, wo, dg, 9, 2), generator=gen) * 4).cuda()
    mask = torch.rand((n, ho, wo, dg, 9), generator=gen).to(dtype).cuda()
    weight = (torch.randn((3, 3, c // groups, cout), generator=gen)
              * 0.05).to(dtype).cuda()
    bias = torch.randn((cout,), generator=gen).to(dtype).cuda()
    cot = torch.randn((n, ho, wo, cout), generator=gen).to(dtype).cuda()
    kw = dict(padding=padding, groups=groups, deform_groups=dg)
    variant = 'k3' if masked else 'k5'
    entries, scatter = _variant_entries(dcn, variant, dtype)
    if masked:
        args, names = (x, offset, mask, weight, bias), ('out', 'x', 'offset',
                                                        'mask', 'weight',
                                                        'bias')

        def kernel(*a):
            return dcn.modulated_deform_conv2d(*a, **kw)

        def plain(*a):
            return dcn.modulated_deform_conv2d_ref(*a, **kw)
    else:
        args, names = (x, offset, weight), ('out', 'x', 'offset', 'weight')

        def kernel(*a):
            return dcn.deform_conv2d(*a, **kw)

        def plain(*a):
            return dcn.deform_conv2d_ref(*a, **kw)
    got, want = _grads_all(kernel, args, cot), _grads_all(plain, args, cot)
    errs = {name: _rel_err(g.float(), wt.float())
            for name, g, wt in zip(names, got, want)}
    abs_err = max(float((g.float() - wt.float()).abs().max())
                  for g, wt in zip(got, want))
    label = (f'{"mdcn" if masked else "deform_conv2d"} groups={groups} '
             f'padding={padding} {dtype}')
    check(got[0].dtype == dtype, f'{label}: output is {got[0].dtype}')
    for name, e in errs.items():
        check(e <= tol, f'{label}: {name} differs by {e} of its max')
    del got

    # as a training step asks it: x frozen, so no scatter; twice, bit-equal
    reset_counts(kernels)
    wrt = [a.detach().requires_grad_(i > 0) for i, a in enumerate(args)]
    step = torch.autograd.grad(kernel(*wrt), wrt[1:], cot)
    again = torch.autograd.grad(kernel(*wrt), wrt[1:], cot)
    launches = read_counts(kernels, entries, (scatter,))
    _only(kernels, launches, entries)
    step_errs = {name: _rel_err(g.float(), wt.float())
                 for name, g, wt in zip(names[2:], step, want[2:])}
    for name, e in step_errs.items():
        check(e <= tol, f'{label} as the step runs it: {name} differs by '
              f'{e} of its max')
    bit_equal = {name: bool(torch.equal(g, g2))
                 for name, g, g2 in zip(names[2:], step, again)}
    check(all(bit_equal.values()), f'{label}: two step backward calls '
          f'differ: {bit_equal}')
    del step, again, want

    # with grad x under offsets uniform on [-SCATTER_NEAR, SCATTER_NEAR]:
    # every gradient held to the plain version before it is timed
    near = _near_offsets(torch.Generator().manual_seed(SEED + 36), offset)
    args_near = (x, near, *args[2:])
    got, want = (_grads_all(kernel, args_near, cot),
                 _grads_all(plain, args_near, cot))
    near_errs = {name: _rel_err(g.float(), wt.float())
                 for name, g, wt in zip(names, got, want)}
    for name, e in near_errs.items():
        check(e <= tol, f'{label}, near offsets: {name} differs by {e} of '
              f'its max')
    abs_err = max(abs_err, *(float((g.float() - wt.float()).abs().max())
                             for g, wt in zip(got, want)))
    del got, want
    wrt_near = [a.detach().requires_grad_() for a in args_near]

    wrt_x = [a.detach().requires_grad_() for a in args]
    out_k, out_kx, out_p = kernel(*wrt), kernel(*wrt_x), plain(*wrt)
    out_kn = kernel(*wrt_near)
    x_nchw = x.permute(0, 3, 1, 2).requires_grad_()
    w_oihw = weight.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    b_lib = bias.detach().requires_grad_() if masked else None
    lib_in = [t for t in (x_nchw, w_oihw, b_lib) if t is not None]

    def library():
        return torch.nn.functional.conv2d(x_nchw, w_oihw, b_lib,
                                          padding=padding, groups=groups)

    out_l = library()
    cot_l = cot.permute(0, 3, 1, 2)
    fwd = timed({'ms': _no_grad(lambda: kernel(*args)),
                 'plain_ms': _no_grad(lambda: plain(*args)),
                 'library_ms': _no_grad(library)})
    bwd = timed({'ms': lambda: torch.autograd.grad(
                     out_k, wrt[1:], cot, retain_graph=True),
                 'with_grad_x_ms': lambda: torch.autograd.grad(
                     out_kx, wrt_x, cot, retain_graph=True),
                 'with_grad_x_near_offsets_ms': lambda: torch.autograd.grad(
                     out_kn, wrt_near, cot, retain_graph=True),
                 'plain_ms': lambda: torch.autograd.grad(
                     out_p, wrt[1:], cot, retain_graph=True),
                 'library_ms': lambda: torch.autograd.grad(
                     out_l, lib_in, cot_l, retain_graph=True)})
    rows = n * ho * wo
    macs = rows * 9.0 * c * cout / groups       # the grouped work
    n_mask = mask.numel() if masked else 0
    n_bias = bias.numel() if masked else 0
    for rec, products, other, nbytes in (
            (fwd, macs, (9.0 * rows * 9 * c, PEAK_F32_FLOPS),
             size * (x.numel() + n_mask + weight.numel() + n_bias
                     + rows * cout) + 4.0 * offset.numel()),
            (bwd, 2 * macs, (20.0 * rows * 9 * c, PEAK_F32_FLOPS),
             size * (cot.numel() + x.numel() + 2 * n_mask
                     + 2 * weight.numel() + n_bias)
             + 4.0 * 2 * offset.numel())):
        flops = [_k2_products(products, dtype), other]
        rec.update(flops=sum(f for f, _ in flops),
                   ops_s=sum(f / p for f, p in flops), bytes=nbytes,
                   bound_f32_cuda_cores_ms=_k2_cores_bound(products, [other],
                                                           nbytes),
                   macs_run=products * groups, macs_grouped=products,
                   max_abs_err=abs_err,
                   max_rel_err=max(*errs.values(), *step_errs.values(),
                                   *near_errs.values()))
        rec['bound_ms'], rec['bound_by'] = bound(flops, nbytes)
    emit({'phase': f'{"mdcn_groups" if masked else "dcn_v1"}'
                   f'{"_bf16" if bf16 else ""}',
          'n': n, 'h': h, 'w': w, 'c': c, 'cout': cout, 'deform_groups': dg,
          'groups': groups, 'padding': padding, 'dtype': str(dtype),
          'rel_err': errs, 'step_rel_err': step_errs,
          'near_offsets_rel_err': near_errs, 'bit_equal_rerun': bit_equal,
          'launches': {k: v for k, v in launches.items() if v},
          'tolerance': tol, 'forward': fwd, 'backward': bwd,
          'timing': TIMING_NOTE})
    del out_k, out_kx, out_kn, out_p, out_l, near, args_near, wrt_near
    torch.cuda.empty_cache()
    return fwd, bwd


def _k3_against_k2_slices(dcn, gen, dtype):
    """K3 at conv groups 2 against two K2 calls on the channel slices, on
    the card: x's and the weight's channels of each group, the deform
    groups (8) split with them, the bias's and grad out's output channels;
    the output and every gradient, within K2's tolerances."""
    n, h, w, c = EDVR_L1
    groups, dg, cout = 2, 8, 64
    x = torch.randn((n, h, w, c), generator=gen).to(dtype).cuda()
    offset = (torch.randn((n, h, w, dg, 9, 2), generator=gen) * 4).cuda()
    mask = torch.rand((n, h, w, dg, 9), generator=gen).to(dtype).cuda()
    weight = (torch.randn((3, 3, c // groups, cout), generator=gen)
              * 0.05).to(dtype).cuda()
    bias = torch.randn((cout,), generator=gen).to(dtype).cuda()
    cot = torch.randn((n, h, w, cout), generator=gen).to(dtype).cuda()
    whole = _grads_all(
        lambda *a: dcn.modulated_deform_conv2d(*a, groups=groups,
                                               deform_groups=dg),
        (x, offset, mask, weight, bias), cot)
    parts = []
    for q in range(groups):
        ch = slice(q * c // groups, (q + 1) * c // groups)
        dgs = slice(q * dg // groups, (q + 1) * dg // groups)
        outs = slice(q * cout // groups, (q + 1) * cout // groups)
        parts.append(_grads_all(
            lambda *a: dcn.modulated_deform_conv2d(
                *a, deform_groups=dg // groups),
            (x[..., ch], offset[..., dgs, :, :], mask[..., dgs, :],
             weight[..., outs], bias[outs]),
            cot[..., outs].contiguous()))
    tol = K2_BF16_TOL if dtype == BF16 else K2_REL_TOL
    errs = {}
    for i, (name, dim) in enumerate((('out', -1), ('x', -1), ('offset', 3),
                                     ('mask', 3), ('weight', -1),
                                     ('bias', -1))):
        errs[name] = _rel_err(whole[i].float(), torch.cat(
            [p[i] for p in parts], dim).float())
        check(errs[name] <= tol, f'K3 at groups 2 against K2 on the channel '
              f'slices, {dtype}: {name} differs by {errs[name]} of its max')
    emit({'phase': 'mdcn_groups_bf16' if dtype == BF16 else 'mdcn_groups',
          'case': 'K3 at groups 2 against two K2 calls on the channel '
                  'slices', 'dtype': str(dtype), 'rel_err': errs,
          'tolerance': tol})


def phase_mdcn_groups(dcn, kernels, dtype=torch.float32):
    """K3: DCNv2 with conv groups 2 and 8 at EDVR-M's L1 shape on the fused
    kernels against its plain version, forward and every gradient; and K3
    at groups 2 against K2 on the channel slices. Returns the ``kernels``
    line's forward and backward records."""
    gen = torch.Generator().manual_seed(SEED + 16)
    recs = [_dcn_variant(dcn, kernels, gen, g, True, 1, dtype)
            for g in (2, 8)]
    _k3_against_k2_slices(dcn, gen, dtype)
    torch.cuda.empty_cache()
    return _variant_records(dcn, 'k3', dtype, recs, 'with groups={2, 8}',
                            'groups 2 and 8 at (5, 180, 320, 64), deform '
                            'groups 8')


def phase_dcn_v1(dcn, kernels, dtype=torch.float32):
    """K5: DCNv1 (no mask, no bias) at its default padding 0 with groups 1
    and 8 at EDVR-M's L1 shape on the fused kernels against its plain
    version, forward and every gradient."""
    gen = torch.Generator().manual_seed(SEED + 17)
    recs = [_dcn_variant(dcn, kernels, gen, g, False, 0, dtype)
            for g in (1, 8)]
    return _variant_records(dcn, 'k5', dtype, recs,
                            'no bias, padding 0, groups={1, 8}',
                            'groups 1 and 8 at (5, 180, 320, 64), deform '
                            'groups 8, padding 0')


def _variant_records(dcn, variant, dtype, recs, conv, shapes):
    """The ``kernels`` line's records of K3 or K5 at ``dtype``: the forward
    (its ``fwd`` entry point) and the backward (dgrad, its scatter, wgrad
    and the sum, whose launches it counts together)."""
    tag = '_bf16' if dtype == BF16 else ''
    prefix = dcn.VARIANTS[variant]
    entries, scatter = _variant_entries(dcn, variant, dtype)
    call = (f'F.conv2d (cuDNN) in {dtype} {conv}: the same conv with zero '
            'offsets and unit mask, a lower bound (no gather)')
    return (_sum_records(f'{prefix}_fwd{tag}', [r[0] for r in recs], {
                'library_call': call, 'shapes': shapes,
                'timing': TIMING_NOTE}),
            _sum_records(f'{prefix}_bwd{tag}', [r[1] for r in recs], {
                'entries': [*entries[1:], scatter],
                'library_call': 'autograd of ' + call, 'shapes': shapes,
                'ms_is': 'the backward as a training step asks it (x '
                         'frozen); with_grad_x_ms with grad x (dgrad\'s '
                         'scatter)', 'timing': TIMING_NOTE}))


def phase_dcn_modules(arch_util, mrapa_arch, dcn, kernels):
    """The module path of K3 at bf16: ``DCNv2Pack(64, 64, 3, padding=1,
    groups=2, deformable_groups=8)`` and ``DynAgg(64, 64, groups=2)``,
    seeded weights with live offset convs, cast to bf16 as the models cast
    a net (``cast_tensors`` through ``torch.func.functional_call``), take
    EDVR-M L1 features (bf16; DynAgg's pre-offsets f32), forward and
    backward through the kernels and through the plain versions: the
    output within ``SLICE_BF16_TOL`` and every parameter's and input's
    gradient within ``TRAIN_GRAD_BF16_TOL`` of its max; only K3's bf16
    entry points launched (x takes a gradient: dgrad's scatter variant,
    not dgrad). Returns
    the launch counts of the kernels' runs."""
    from mrefsr_tpu_torch.models.base_model import cast_tensors
    n, h, w, c = EDVR_L1
    gen = torch.Generator().manual_seed(SEED + 18)
    with torch.device('meta'):
        nets = {'DCNv2Pack': arch_util.DCNv2Pack(c, c, 3, padding=1, groups=2,
                                                 deformable_groups=8),
                'DynAgg': mrapa_arch.DynAgg(c, c, 3, groups=2,
                                            deform_groups=8)}
    feats = [torch.randn((n, c, h, w), generator=gen).to(BF16).cuda()
             for _ in range(2)]
    pre_offset = (torch.randn((n, h, w, 9, 2), generator=gen) * 2).cuda()
    entries, scatter = _variant_entries(dcn, 'k3', BF16)
    total = {}
    for name, net in nets.items():
        net.to_empty(device='cuda')
        with torch.no_grad():
            for pname, p in net.named_parameters():
                scale = (0.01 if 'offset' in pname else 0.05) \
                    if p.dim() > 1 else 0.5
                p.copy_(torch.randn(p.shape, generator=gen) * scale)
        extra = () if name == 'DCNv2Pack' else (pre_offset,)
        cot = torch.randn((n, c, h, w), generator=gen).to(BF16).cuda()

        def step(plain=False):
            with contextlib.ExitStack() as stack:
                if plain:
                    for module in (arch_util, mrapa_arch):
                        stack.enter_context(mock.patch.object(
                            module, 'modulated_deform_conv2d',
                            dcn.modulated_deform_conv2d_ref))
                net.zero_grad(set_to_none=True)
                ins = [f.detach().requires_grad_() for f in feats]
                out = torch.func.functional_call(
                    net, cast_tensors(net, BF16), (*ins, *extra))
            out.backward(cot)
            return out.detach(), {
                **{pname: p.grad.clone()
                   for pname, p in net.named_parameters()},
                'x': ins[0].grad, 'feat': ins[1].grad}

        # x takes a gradient: dgrad's scatter variant, not dgrad
        expect = [entries[0], scatter, *entries[2:]]
        reset_counts(kernels)
        out_k, grads_k = step()
        launches = read_counts(kernels, expect)
        _only(kernels, launches, expect)
        out_p, grads_p = step(plain=True)
        check(out_k.dtype == BF16 and out_k.shape == (n, c, h, w)
              and bool(torch.isfinite(out_k).all()),
              f'{name}: output {out_k.dtype} {tuple(out_k.shape)}')
        out_err = _rel_err(out_k.float(), out_p.float())
        check(out_err <= SLICE_BF16_TOL, f'{name} at bf16: kernels and plain '
              f'versions differ by {out_err} of max |out|')
        errs = {key: _rel_err(g.float(), grads_p[key].float())
                for key, g in grads_k.items()}
        for key, e in errs.items():
            check(e <= TRAIN_GRAD_BF16_TOL, f'{name} at bf16: grad {key} '
                  f'differs by {e} of its max')
        ms = cuda_ms(step)
        plain_ms = cuda_ms(lambda: step(plain=True), reps=1)
        emit({'phase': 'dcn_modules', 'module': name, 'groups': 2,
              'deform_groups': 8, 'n': n, 'c': c, 'h': h, 'w': w,
              'dtype': 'torch.bfloat16', 'out_rel_err': out_err,
              'grad_rel_err': errs, 'tolerance': SLICE_BF16_TOL,
              'grad_tolerance': TRAIN_GRAD_BF16_TOL,
              'launches': {k: v for k, v in launches.items() if v},
              'step_ms': ms, 'plain_step_ms': plain_ms,
              'step_is': 'forward and backward, events around one call'})
        for key, count in launches.items():
            total[key] = total.get(key, 0) + count
        del out_k, out_p, grads_k, grads_p
    del nets, feats
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------- StyleGAN2 ops
SG2_FIR = (1, 3, 3, 1)
SG2_SERVE = {'out_size': 1024, 'num_style_feat': 512, 'num_mlp': 8,
             'channel_multiplier': 2}
SG2_SERVE_SAMPLES = 16
SG2_TRAIN_SIZE, SG2_TRAIN_B = 256, 8
K7_REL_TOL = 1e-5    # max |kernel - plain| / max |plain|: f32 sums of at
#                      most 16 taps in another order than cuDNN's
K8_REL_TOL = 1e-6    # one rounding apart at most; the forward is bit-equal


def _sg2_channels(cmul=2):
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cmul,
            128: 128 * cmul, 256: 64 * cmul, 512: 32 * cmul,
            1024: 16 * cmul}


def _resolutions(size, low=8):
    return [2 ** i for i in range(int(math.log2(low)),
                                  int(math.log2(size)) + 1)]


def _k7_generator_cases(size, batch):
    """upfirdn2d's calls in one generator forward: per resolution the
    smoothing of the transposed conv's (2H + 1)-wide output and the x2
    upsampling of the RGB skip. (n, c, h, up, down, pad, FIR gain)."""
    ch = _sg2_channels()
    for res in _resolutions(size):
        yield (batch, ch[res], res + 1, 1, 1, (1, 1), 4.0)
        yield (batch, 3, res // 2, 2, 1, (2, 1), 4.0)


def _k7_discriminator_cases(size, batch):
    """upfirdn2d's calls in one discriminator forward: per ResBlock the
    smoothing before the 3x3 and before the 1x1 stride-2 conv."""
    ch = _sg2_channels()
    for res in reversed(_resolutions(size)):
        yield (batch, ch[res], res, 1, 1, (2, 2), 1.0)
        yield (batch, ch[res], res, 1, 1, (1, 1), 1.0)


def _k8_generator_cases(size, batch):
    """The shapes fused_leaky_relu sees in one generator forward: the 8
    mapping layers, then one style conv at 4x4 and two per resolution
    above."""
    ch = _sg2_channels()
    for _ in range(8):
        yield (batch, 512)
    yield (batch, ch[4], 4, 4)
    for res in _resolutions(size):
        for _ in range(2):
            yield (batch, ch[res], res, res)


def _k8_discriminator_cases(size, batch):
    """The shapes fused_leaky_relu sees in one discriminator forward."""
    ch = _sg2_channels()
    yield (batch, ch[size], size, size)
    for res in reversed(_resolutions(size)):
        yield (batch, ch[res], res, res)
        yield (batch, ch[res // 2], res // 2, res // 2)
    yield (batch, ch[4], 4, 4)
    yield (batch, ch[4])


def _counted(cases):
    """``[(case, how often)]`` in first-seen order."""
    counts = {}
    for case in cases:
        counts[case] = counts.get(case, 0) + 1
    return list(counts.items())


def _three_orders(fn, x, extra=()):
    """``fn``'s output on ``x`` (and ``extra`` inputs that take a
    gradient), its gradient for a fixed cotangent, and the gradient of
    ``sum(gradient ** 2)`` in the cotangent: forward, backward and double
    backward. The cotangent comes from the output's shape alone, so two
    implementations get the same one."""
    inputs = [t.detach().requires_grad_() for t in (x, *extra)]
    out = fn(*inputs)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 9)
    cot = torch.randn(out.shape, generator=gen,
                      device='cuda').requires_grad_()
    grads = torch.autograd.grad(out, inputs, cot, create_graph=True)
    second, = torch.autograd.grad(sum((g ** 2).sum() for g in grads), cot)
    return [out.detach(), *(g.detach() for g in grads), second]


def _three_orders_linear(fn, x):
    """:func:`_three_orders` of ``fn`` linear in ``x``, its one input, with
    the double backward in closed form: for the gradient ``g = J^T cot``,
    the gradient of ``sum(g ** 2)`` in ``cot`` is ``2 J g = 2 fn(g)``. The
    same cotangent; no graph through the backward, whose autograd runs
    through cuDNN's depthwise double backward, slow at K7's serving
    shapes."""
    xg = x.detach().requires_grad_()
    out = fn(xg)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 9)
    cot = torch.randn(out.shape, generator=gen, device='cuda')
    grad, = torch.autograd.grad(out, xg, cot)
    with torch.no_grad():
        second = 2 * fn(grad)
    return [out.detach(), grad, second]


def _order_calls(fn, x, orders, bias=None):
    """One call of each of ``orders``: ``fwd``, ``fn`` on ``x`` without a
    graph; ``bwd``, its gradient in ``x``; ``bwd_bias``, its gradients in
    ``x`` and in ``bias``, a second input that takes one (``fn(x,
    bias)``); ``bwd2``, the gradient of the gradient in ``x`` in the
    cotangent. The graphs they run through are built here, once."""
    extra = () if bias is None else (bias,)
    with torch.no_grad():
        cot = torch.randn_like(fn(x, *extra))
    calls = {}
    if 'fwd' in orders:
        def fwd():
            with torch.no_grad():
                return fn(x, *extra)
        calls['fwd'] = fwd
    xg = x.detach().requires_grad_()
    if 'bwd' in orders:
        out = fn(xg, *extra)
        calls['bwd'] = lambda: torch.autograd.grad(out, xg, cot,
                                                   retain_graph=True)
    if 'bwd_with_bias' in orders:
        bg = bias.detach().requires_grad_()
        out_b = fn(xg, bg)
        calls['bwd_with_bias'] = lambda: torch.autograd.grad(
            out_b, (xg, bg), cot, retain_graph=True)
    if 'bwd2' in orders:
        cotg = cot.clone().requires_grad_()
        grad, = torch.autograd.grad(fn(xg, *extra), xg, cotg,
                                    create_graph=True)
        seed = torch.randn_like(grad)
        calls['bwd2'] = lambda: torch.autograd.grad(grad, cotg, seed,
                                                    retain_graph=True)
    return calls


def _time_orders(fn, x, orders=('fwd', 'bwd', 'bwd2'), reps=3, runs=None,
                 bias=None, warmup=1, once=()):
    """Each order of :func:`_order_calls` timed two ways: ``call``, the
    median ms of ``reps`` calls after ``warmup`` more, each between its own
    pair of CUDA events (host time included: a small call's is mostly the
    host's), and ``device``, the ms of device work a call, over ``runs``
    calls (:func:`device_ms_each`). The orders in ``once`` are timed both
    ways on one call and no warm-up (:func:`_one_call_ms`)."""
    calls = _order_calls(fn, x, orders, bias)
    many = {o: c for o, c in calls.items() if o not in once}
    call = {o: cuda_ms(c, reps=reps, warmup=warmup) for o, c in many.items()}
    device = dict(zip(many, device_ms_each(
        list(many.values()), runs=DEVICE_RUNS if runs is None else runs,
        warmup=0)))
    for order in once:
        call[order], device[order] = _one_call_ms(calls[order])
    return {'call': {o: call[o] for o in calls},
            'device': {o: device[o] for o in calls}}


def _one_call_ms(fn):
    """``(call ms, device ms)`` of one call of ``fn``: the CUDA events
    around it and the device events of the profile that
    :func:`device_ms_each` takes of that call, for a call of seconds."""
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))

    def between_events():
        start.record()
        fn()
        end.record()

    device, = device_ms_each([between_events], runs=1, warmup=0)
    return start.elapsed_time(end), device


def _upfirdn2d_library(x, fir, up, down, pad):
    """The same function in PyTorch's own convolutions: ``F.pad``
    (negative pads crop) and one depthwise ``F.conv2d`` for ``up == 1``;
    for ``up > 1`` one depthwise ``F.conv_transpose2d``, which convolves
    the zero-stuffed map in full, cut to the op's window."""
    func = torch.nn.functional
    c = x.shape[1]
    kh, kw = fir.shape
    if up == 1:
        weight = torch.flip(fir, [0, 1]).to(x).expand(c, 1, kh, kw)
        return func.conv2d(func.pad(x, [pad[0], pad[1], pad[0], pad[1]]),
                           weight, groups=c, stride=down)
    full = func.conv_transpose2d(x, fir.to(x).expand(c, 1, kh, kw),
                                 stride=up, groups=c)
    out_h = (x.shape[2] * up + pad[0] + pad[1] - kh) // down + 1
    out_w = (x.shape[3] * up + pad[0] + pad[1] - kw) // down + 1
    y0, x0 = kh - 1 - pad[0], kw - 1 - pad[0]
    check(y0 >= 0 and y0 + (out_h - 1) * down < full.shape[2]
          and x0 >= 0 and x0 + (out_w - 1) * down < full.shape[3],
          'the library composition does not cover this upfirdn2d case')
    return full[:, :, y0:y0 + (out_h - 1) * down + 1:down,
                x0:x0 + (out_w - 1) * down + 1:down]


TIMING_NOTE = ('ms, plain_ms, library_ms: device time a call '
               '(torch.profiler over DEVICE_RUNS calls, device_ms_each); '
               '*call_ms: CUDA events around one call, host time included')


def _sum_orders(name, rows, order, note):
    """One ``kernels`` entry for ``order`` out of per-case rows: each row
    holds device and call times per order for the kernel, the plain and
    the library version, its multiplicity on the path, bytes and
    operations."""
    total = {}
    for impl, key in (('kernel', ''), ('plain', 'plain_'),
                      ('library', 'library_')):
        for kind, suffix in (('device', 'ms'), ('call', 'call_ms')):
            total[key + suffix] = sum(row['times'][impl][kind][order]
                                      * row['count'] for row in rows)
    nbytes = sum(row['bytes'][order] * row['count'] for row in rows)
    flops = sum(row['flops'][order] * row['count'] for row in rows)
    bound_ms, bound_by = bound(flops, nbytes)
    return {'name': name, **total, 'device_ms': total['ms'],
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'launches_summed': sum(row['count'] for row in rows),
            'library_call': note, 'timing': TIMING_NOTE}


def _case_times(times):
    """A case line's times: device ``ms`` and ``call_ms`` per order, for
    the kernel, the plain and the library version."""
    return {f'{key}{suffix}': times[impl][kind]
            for impl, key in (('kernel', ''), ('plain', 'plain_'),
                              ('library', 'library_'))
            for kind, suffix in (('device', 'ms'), ('call', 'call_ms'))}


def _k7_edge_case(h, w, up, down):
    """An x shape and pads whose output is ``h`` x ``w``."""
    if up == 2:
        return ((h + 1) // 2, (w + 1) // 2), (2, 1 - h % 2, 2, 1 - w % 2)
    return ((h - 1) * down + 2, (w - 1) * down + 2), (1, 1, 1, 1)


# the tile kernel at its edges (label, x shape, up, down, pad): outputs one
# below, at and one above a tile's columns (128 at (1, 1) and up 2, 63 at
# down 2) and rows (32: two strips of 16), odd pads at up 2, many small
# planes a block
K7_EDGE_CASES = (
    *((f'out_{up}{down}_{h}x{w}', (2, 4, *_k7_edge_case(h, w, up, down)[0]),
       up, down, _k7_edge_case(h, w, up, down)[1])
      for (h, w), (up, down) in (
          ((63, 127), (1, 1)), ((64, 128), (1, 1)), ((65, 129), (1, 1)),
          ((63, 62), (1, 2)), ((64, 63), (1, 2)), ((65, 64), (1, 2)),
          ((63, 127), (2, 1)), ((64, 128), (2, 1)), ((65, 129), (2, 1)))),
    ('up2_odd_pads', (2, 4, 9, 7), 2, 1, (1, 2, 3, 0)),
    ('small_planes', (5, 60, 4, 5), 1, 1, (2, 2, 2, 2)),
    ('small_planes_down2', (3, 40, 8, 8), 1, 2, (1, 1, 1, 1)))


def phase_upfirdn2d(ops_upfirdn2d):
    """K7 against its plain version on the card, to second order, at every
    shape of the serving and the training path."""
    from mrefsr_tpu_torch.archs.stylegan2_arch import make_resample_kernel
    upfirdn2d = ops_upfirdn2d.upfirdn2d
    upfirdn2d_ref = ops_upfirdn2d.upfirdn2d_ref
    base = make_resample_kernel(SG2_FIR)
    gen = torch.Generator().manual_seed(SEED + 7)
    paths = {
        'serve': _counted(_k7_generator_cases(SG2_SERVE['out_size'],
                                              SG2_SERVE_SAMPLES)),
        'train': _counted([
            *_k7_generator_cases(SG2_TRAIN_SIZE, SG2_TRAIN_B),
            *_k7_discriminator_cases(SG2_TRAIN_SIZE, SG2_TRAIN_B)]),
    }
    worst_abs, rows = 0.0, {'serve': [], 'train': []}
    for path, cases in paths.items():
        for (n, c, h, up, down, pad, gain), count in cases:
            fir = base * gain
            x = torch.randn((n, c, h, h), generator=gen).cuda()

            def kernel(t):
                return upfirdn2d(t, fir, up, down, pad)

            def plain(t):
                return upfirdn2d_ref(t, fir, up, down, pad)

            def library(t):
                return _upfirdn2d_library(t, fir, up, down, pad)

            errs = {}
            # serving runs the forward alone: the plain version's double
            # backward at its shapes in closed form
            got = _three_orders(kernel, x)
            want = (_three_orders_linear(plain, x) if path == 'serve'
                    else _three_orders(plain, x))
            for order, g, w in zip(('fwd', 'bwd', 'bwd2'), got, want):
                errs[order] = _rel_err(g, w)
                worst_abs = max(worst_abs, float((g - w).abs().max()))
                check(errs[order] <= K7_REL_TOL, f'upfirdn2d {order} at '
                      f'{(n, c, h, up, down, pad)}: {errs[order]} of max')
            with torch.no_grad():
                lib_err = _rel_err(library(x), want[0])
            check(lib_err <= K7_REL_TOL, f'the library composition differs '
                  f'from the plain version by {lib_err}')
            del got, want
            if path == 'serve':      # no gradient runs when serving
                # the plain and the library forward over PLAIN_DEVICE_RUNS
                # calls: one takes up to hundreds of ms at 1025 x 1025
                times = {key: _time_orders(f, x, ('fwd',), **(
                    {} if key == 'kernel' else PLAIN_TIMING))
                         for key, f in (('kernel', kernel), ('plain', plain),
                                        ('library', library))}
            else:
                # one run each of the plain and the library version: cuDNN
                # takes seconds for some of their double backwards, timed
                # both ways on one call; the plain version's three orders
                # ran just above (its warm-up)
                times = {'kernel': _time_orders(kernel, x),
                         'plain': _time_orders(plain, x, reps=1, runs=1,
                                               warmup=0, once=('bwd2',)),
                         'library': _time_orders(library, x, reps=1,
                                                 runs=1, once=('bwd2',))}
            side = (h * up + sum(pad) - 4) // down + 1
            out_numel = float(n * c) * side ** 2
            moved = 4.0 * (x.numel() + out_numel)
            # multiply-adds: the taps that fall on a sample, per output of
            # the forward (and of the double backward), per input of the
            # backward
            macs = {'fwd': 16.0 / up ** 2 * out_numel,
                    'bwd': 16.0 / down ** 2 * x.numel(),
                    'bwd2': 16.0 / up ** 2 * out_numel}
            row = {'count': count, 'times': times,
                   'bytes': {o: moved for o in macs},
                   'flops': {o: 2 * m for o, m in macs.items()}}
            rows[path].append(row)
            emit({'phase': 'upfirdn2d', 'path': path, 'n': n, 'c': c,
                  'h': h, 'w': h, 'up': up, 'down': down, 'pad': pad,
                  'route': ops_upfirdn2d.route(fir, up, down),
                  'tile_geometry': ops_upfirdn2d.tile_geometry(
                      n * c, side, side, up, down),
                  'launches_per_pass': count, 'rel_err': errs,
                  'tolerance': K7_REL_TOL, **_case_times(times),
                  'bound_ms': moved / PEAK_BYTES * 1e3, 'bound_by': 'bytes'})
            del x
            torch.cuda.empty_cache()

    # the other code paths of the kernel: a stride with the 4x4 filter,
    # and the general loop (3x5 filter, non-square map, a negative pad)
    odd = {}
    for label, fir, shape, up, down, pad in (
            ('down2', base, (2, 8, 33, 31), 1, 2, (1, 1)),
            ('general', torch.randn((3, 5), generator=gen), (2, 3, 17, 22),
             3, 2, (2, -1))):
        x = torch.randn(shape, generator=gen).cuda()
        got = _three_orders(lambda t: upfirdn2d(t, fir, up, down, pad), x)
        want = _three_orders(lambda t: upfirdn2d_ref(t, fir, up, down, pad),
                             x)
        odd[label] = [_rel_err(g, w) for g, w in zip(got, want)]
        check(max(odd[label]) <= K7_REL_TOL,
              f'upfirdn2d, case {label}: {odd[label]} of max')
    emit({'phase': 'upfirdn2d', 'case': 'odd', 'rel_err': odd,
          'tolerance': K7_REL_TOL})

    # the tile kernel at its edges: outputs one below, at and one above a
    # tile's columns and rows, odd pads at up 2, many small planes a block
    edges = {}
    for label, shape, up, down, pad in K7_EDGE_CASES:
        fir = base * (4.0 if up == 2 else 1.0)
        check(ops_upfirdn2d.route(fir, up, down) == 'tile',
              f'upfirdn2d, case {label}: not a tile case')
        x = torch.randn(shape, generator=gen).cuda()
        got = _three_orders(lambda t: upfirdn2d(t, fir, up, down, pad), x)
        want = _three_orders(lambda t: upfirdn2d_ref(t, fir, up, down, pad),
                             x)
        edges[label] = [_rel_err(g, w) for g, w in zip(got, want)]
        check(max(edges[label]) <= K7_REL_TOL,
              f'upfirdn2d, case {label}: {edges[label]} of max')
    emit({'phase': 'upfirdn2d', 'case': 'tile_edges', 'rel_err': edges,
          'tolerance': K7_REL_TOL})

    note = ('F.pad + one depthwise F.conv2d (up 1) or one depthwise '
            'F.conv_transpose2d cut to the window (up 2), and autograd '
            'through them')
    recs = []
    for order in ('fwd', 'bwd', 'bwd2'):
        path = 'serve' if order == 'fwd' else 'train'
        rec = _sum_orders(f'upfirdn2d_{order}', rows[path], order, note)
        rec.update(max_abs_err=worst_abs, shapes=(
            'one 1024x1024 generator forward of 16 samples'
            if path == 'serve' else 'one 256x256 B 8 generator pass and '
            'one discriminator pass'))
        if order == 'fwd':
            rec['train_shape'] = _sum_orders('upfirdn2d_fwd', rows['train'],
                                             order, note)
        recs.append(rec)
    return recs


def phase_fused_act(fused_act):
    """K8 against its plain version on the card, to second order: the
    shapes of the serving and the training path, with a bias; then
    without a bias, channels-last, and with exact zeros planted."""
    fused = fused_act.fused_leaky_relu
    fused_ref = fused_act.fused_leaky_relu_ref
    func = torch.nn.functional
    gen = torch.Generator().manual_seed(SEED + 8)
    size, b = SG2_SERVE['out_size'], SG2_SERVE_SAMPLES
    paths = {
        'serve': _counted(_k8_generator_cases(size, b)),
        'train': _counted([
            *_k8_generator_cases(SG2_TRAIN_SIZE, SG2_TRAIN_B),
            *_k8_discriminator_cases(SG2_TRAIN_SIZE, SG2_TRAIN_B)]),
    }
    worst_abs, rows = 0.0, {'serve': [], 'train': []}
    orders = ('fwd', 'bwd', 'bwd_bias', 'bwd2')

    def compare(label, x, bias, tol=K8_REL_TOL):
        nonlocal worst_abs
        extra = () if bias is None else (bias,)
        got = _three_orders(lambda t, *bb: fused(t, *bb), x, extra)
        want = _three_orders(lambda t, *bb: fused_ref(t, *bb), x, extra)
        names = [o for o in orders if bias is not None or o != 'bwd_bias']
        errs = {}
        for order, g, w in zip(names, got, want):
            errs[order] = _rel_err(g, w)
            worst_abs = max(worst_abs, float((g - w).abs().max()))
            # grad bias sums up to 16 M terms in another order
            limit = 1e-4 if order == 'bwd_bias' else tol
            check(errs[order] <= limit,
                  f'fused_leaky_relu {order}, {label}: {errs[order]} of max')
        errs['fwd_bit_equal'] = bool(torch.equal(got[0], want[0]))
        check(errs['fwd_bit_equal'], f'fused_leaky_relu forward, {label}: '
              f'not bit-equal to the plain version')
        if bias is not None:
            # the backward with grad bias (the ordered partials) again
            errs['grads_bit_equal_on_rerun'] = all(
                torch.equal(a, b) for a, b in zip(
                    _three_orders(lambda t, *bb: fused(t, *bb), x, extra)[1:3],
                    got[1:3]))
            check(errs['grads_bit_equal_on_rerun'], f'fused_leaky_relu '
                  f'backward, {label}: grad x or grad bias differ on a rerun')
        return errs

    for path, cases in paths.items():
        for shape, count in cases:
            x = torch.randn(shape, generator=gen).cuda()
            bias = (torch.randn((shape[1],), generator=gen) * 0.5).cuda()
            errs = compare(str(shape), x, bias)
            rest = (1, -1) + (1,) * (len(shape) - 2)

            def kernel(t, b):
                return fused(t, b)

            def plain(t, b):
                return fused_ref(t, b)

            def library(t, b):
                return func.leaky_relu(t + b.view(rest), 0.2) * 2 ** 0.5

            impls = (('kernel', kernel), ('plain', plain),
                     ('library', library))
            if path == 'serve':
                times = {key: _time_orders(f, x, ('fwd',), bias=bias, **(
                    {} if key == 'kernel' else PLAIN_TIMING))
                         for key, f in impls}
            else:
                # the backward as the path runs it, the bias taking a
                # gradient, and without (`bwd`)
                times = {key: _time_orders(
                    f, x, ('fwd', 'bwd', 'bwd_with_bias', 'bwd2'),
                    bias=bias) for key, f in impls}
            numel = float(x.numel())
            # forward: x in, out out; backward and double backward: the
            # incoming gradient and the saved output in, one gradient out
            # (and grad bias, C floats, summed)
            row = {'count': count, 'times': times,
                   'bytes': {'fwd': 8.0 * numel, 'bwd': 12.0 * numel,
                             'bwd_with_bias': 12.0 * numel + 4 * shape[1],
                             'bwd2': 12.0 * numel},
                   'flops': {'fwd': 3.0 * numel, 'bwd': 2.0 * numel,
                             'bwd_with_bias': 3.0 * numel,
                             'bwd2': 2.0 * numel}}
            rows[path].append(row)
            emit({'phase': 'fused_act', 'path': path, 'shape': shape,
                  'launches_per_pass': count, 'rel_err': errs,
                  'tolerance': K8_REL_TOL, **_case_times(times),
                  'bound_ms': {o: v / PEAK_BYTES * 1e3
                               for o, v in row['bytes'].items()},
                  'bound_by': 'bytes'})
            del x, bias
            torch.cuda.empty_cache()

    # without a bias; channels-last memory; exact zeros (zero bias on a
    # tensor with planted zeros): the derivative there is 1, not the slope
    x = torch.randn((4, 64, 33, 31), generator=gen).cuda()
    bias = (torch.randn((64,), generator=gen) * 0.5).cuda()
    special = {'no_bias_4d': compare('no bias, 4-D', x, None),
               'no_bias_2d': compare('no bias, 2-D', x[:, :, 0, 0], None),
               'channels_last': compare(
                   'channels-last',
                   x.contiguous(memory_format=torch.channels_last), bias)}
    planted = x.clone()
    planted[:, ::2, ::3] = 0.0
    zero_bias = torch.zeros_like(bias)
    special['planted_zeros'] = compare('planted zeros', planted, zero_bias)
    pg = planted.detach().requires_grad_()
    grad, = torch.autograd.grad(fused(pg, zero_bias).sum(), pg)
    at_zero = grad[planted == 0]
    check(at_zero.numel() > 0 and bool((at_zero == grad.max()).all()),
          'fused_leaky_relu: the derivative at exactly 0 is not 1 * scale')
    lib_grad, = torch.autograd.grad((func.leaky_relu(pg, 0.2)
                                     * 2 ** 0.5).sum(), pg)
    special['planted_zeros']['zeros'] = int(at_zero.numel())
    special['planted_zeros']['grad_at_zero'] = float(at_zero[0])
    special['planted_zeros']['F_leaky_relu_grad_at_zero'] = float(
        lib_grad[planted == 0][0])
    emit({'phase': 'fused_act', 'case': 'special', **special,
          'tolerance': K8_REL_TOL})

    note = 'F.leaky_relu(x + bias, 0.2) * 2 ** 0.5 in eager, and its autograd'
    recs = []
    # the backward's entry as the path runs it, with grad bias
    for name, order in (('fwd', 'fwd'), ('bwd', 'bwd_with_bias'),
                        ('bwd2', 'bwd2')):
        path = 'serve' if order == 'fwd' else 'train'
        rec = _sum_orders(f'fused_leaky_relu_{name}', rows[path], order,
                          note)
        rec.update(max_abs_err=worst_abs, shapes=(
            'one 1024x1024 generator forward of 16 samples'
            if path == 'serve' else 'one 256x256 B 8 generator pass and '
            'one discriminator pass'))
        if order == 'fwd':
            rec['train_shape'] = _sum_orders('fused_leaky_relu_fwd',
                                             rows['train'], order, note)
        if name == 'bwd':
            rec['with_bias_grad'] = True
            rec['no_bias_grad'] = _sum_orders('fused_leaky_relu_bwd',
                                              rows['train'], 'bwd', note)
        recs.append(rec)
    return recs


def _cufed5_opt():
    """The network blocks of options/test/test_5ref_cufed5.yml."""
    return {
        'model_type': 'MultiRefRestorationModel', 'manual_seed': 10,
        'network_g': {'type': 'MRAPARestorationNet', 'ngf': 64,
                      'n_blocks': 16, 'groups': 8},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'patch_size': 3, 'stride': 1,
                        'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                        'vgg_type': 'vgg19'},
        'network_extractor': {'type': 'ContrasMultiExtractorSep'},
        'path': {},
    }


def _train_opt(alignment):
    """The network and train blocks of
    options/train/stage3_5ref_restoration_mse.yml (``dcn``) and
    stage3_5ref_restoration_mse_flow.yml (``flow``), without
    ``mixed_precision``: the port's step is f32."""
    opt = _cufed5_opt()
    opt['is_train'] = True
    opt['network_g']['alignment'] = alignment
    if alignment == 'flow':
        opt['network_g']['ref_unroll'] = 5
    opt['train'] = {
        'lr_g': 1e-4, 'lr_offset': 1e-4, 'lr_relu2_offset': 1e-5,
        'lr_relu3_offset': 1e-6, 'weight_decay_g': 0,
        'beta_g': [0.9, 0.999],
        'scheduler': {'type': 'MultiStepLR',
                      'milestones': [300000, 400000], 'gamma': 0.5},
        'total_iter': 255000, 'warmup_iter': -1, 'net_g_pretrain_steps': 0,
        'steps_per_dispatch': 16, 'pixel_criterion': 'L1Loss',
        'pixel_weight': 1.0}
    return opt


def _train_batch(rng, b):
    gt, lq = TRAIN_GT, TRAIN_GT // 4
    return {
        'img_in': rng.rand(b, gt, gt, 3).astype(np.float32),
        'img_in_lq': rng.rand(b, lq, lq, 3).astype(np.float32),
        'img_in_up': rng.rand(b, gt, gt, 3).astype(np.float32),
        'img_ref_list': rng.rand(b, T, gt, gt, 3).astype(np.float32),
    }


def kernel_objects(correlation, dcn, ops_upfirdn2d, fused_act):
    """Every kernel entry point of the port by name, with its count."""
    return {'feature_match_prologue':
                correlation.feature_match_prologue_kernel,
            'feature_match_prologue_bf16':
                correlation.feature_match_prologue_bf16_kernel,
            'feature_match': correlation.feature_match_kernel,
            'feature_match_sharded': correlation.feature_match_sharded_kernel,
            # K2, K3 and K5 at f32 and bf16, e.g. 'mdcn_fused_fwd',
            # 'mdcn_groups_fused_dgrad_bf16', 'deform_conv_fused_wgrad'
            **dcn.FUSED_KERNELS,
            # their f32 weight's TF32 split, one launch before each f32
            # forward and dgrad
            'mdcn_fused_split': dcn.mdcn_fused_split_kernel,
            'deform_sample_fwd': dcn.deform_sample_fwd_kernel,
            'deform_sample_bwd': dcn.deform_sample_bwd_kernel,
            'deform_sample_bwd_scatter': dcn.deform_sample_bwd_scatter_kernel,
            'upfirdn2d_fwd': ops_upfirdn2d.upfirdn2d_fwd_kernel,
            'upfirdn2d_bwd': ops_upfirdn2d.upfirdn2d_bwd_kernel,
            'upfirdn2d_bwd2': ops_upfirdn2d.upfirdn2d_bwd2_kernel,
            'fused_leaky_relu_fwd': fused_act.fused_leaky_relu_fwd_kernel,
            'fused_leaky_relu_bwd': fused_act.fused_leaky_relu_bwd_kernel,
            'fused_leaky_relu_bwd2': fused_act.fused_leaky_relu_bwd2_kernel,
            'feature_match_bf16': correlation.feature_match_bf16_kernel,
            'feature_match_sharded_bf16':
                correlation.feature_match_sharded_bf16_kernel,
            'deform_sample_fwd_bf16': dcn.deform_sample_fwd_bf16_kernel,
            'deform_sample_bwd_bf16': dcn.deform_sample_bwd_bf16_kernel,
            'deform_sample_bwd_scatter_bf16':
                dcn.deform_sample_bwd_scatter_bf16_kernel}


def reset_counts(kernels):
    for kernel in kernels.values():
        kernel.launches = 0


def read_counts(kernels, expect, forbid=()):
    """The launch counts since :func:`reset_counts`; every kernel of
    ``expect`` must have been launched and none of ``forbid`` (a grad-x
    scatter where the features are frozen, an f32 entry point on a bf16
    path)."""
    launches = {name: k.launches for name, k in kernels.items()}
    for name in expect:
        check(launches[name] > 0,
              f'kernel {name} was not launched on the main path')
    for name in forbid:
        check(launches[name] == 0,
              f'kernel {name} was launched {launches[name]} times on a '
              f'path that must not launch it')
    return launches


# the entry points a path launches and those it must not, by dtype: K1,
# K2's forward, K2's backward, K4's forward and backward
ENTRIES = {
    torch.float32: {'match': ('feature_match_prologue', 'feature_match'),
                    'k2': ('mdcn_fused_fwd',),
                    'k2_bwd': ('mdcn_fused_dgrad', 'mdcn_fused_wgrad',
                               'mdcn_fused_wgrad_sum'),
                    'k4': ('deform_sample_fwd',),
                    'k4_bwd': ('deform_sample_bwd',)},
    BF16: {'match': ('feature_match_prologue_bf16', 'feature_match_bf16'),
           'k2': ('mdcn_fused_fwd_bf16',),
           'k2_bwd': ('mdcn_fused_dgrad_bf16', 'mdcn_fused_wgrad_bf16',
                      'mdcn_fused_wgrad_sum_bf16'),
           'k4': ('deform_sample_fwd_bf16',),
           'k4_bwd': ('deform_sample_bwd_bf16',)}}
F32_ENTRIES = sum(ENTRIES[torch.float32].values(), ())
SCATTERS = ('mdcn_fused_dgrad_scatter', 'deform_sample_bwd_scatter',
            'mdcn_fused_dgrad_scatter_bf16', 'deform_sample_bwd_scatter_bf16')


def _entries(parts, dtype):
    return sum((ENTRIES[dtype][part] for part in parts), ())


def _forbidden(dtype):
    """A bf16 path launches no f32 entry point; no path a grad-x scatter
    (the sampled features are frozen)."""
    return SCATTERS + (F32_ENTRIES if dtype == BF16 else ())


def _request(rng):
    lq = CANVAS // 4
    return {
        'img_in': rng.rand(1, CANVAS, CANVAS, 3).astype(np.float32),
        'img_in_lq': rng.rand(1, lq, lq, 3).astype(np.float32),
        'img_in_up': rng.rand(1, CANVAS, CANVAS, 3).astype(np.float32),
        'img_ref_list': rng.rand(1, T, CANVAS, CANVAS, 3).astype(np.float32),
    }


# a bf16 request through the kernels against the same request through the
# plain versions (the kernel's match fed to both): a K2 column element that
# straddles a rounding boundary differs by one bf16 ulp, and the net's
# every later bf16 rounding can pass such a difference on (measured, H100:
# 0.0039, half an ulp of the output's range; the same for a training
# step's output); and against the f32 request: the JAX package's gate of
# bf16 against f32 eval (tests/test_models/test_multi_ref_model.py:446-447;
# measured 0.0056 max, 0.0011 mean).
SLICE_BF16_TOL = 4 * EPS_BF16
BF16_VS_F32_MAX, BF16_VS_F32_MEAN = 0.1, 0.02


def _request_vs_plain(model, correlation, dcn, request, dtype):
    """One request through the kernels and through the plain versions; the
    plain run takes the kernel's match so both align with the same
    correspondences, and the match itself is checked on near-ties.
    Returns the kernels' output and the comparison's record."""
    record = {}
    match_cuda = correlation._match_patches_cuda

    def match_recorded(pin, pref, chunk=None):
        record['match'] = match_cuda(pin, pref)
        return record['match']

    def match_plain(pin, pref, chunk=None):
        idx_p, _ = correlation._match_patches_ref(pin, pref, 2048)
        idx_k = record['match'][0]
        differ = idx_k != idx_p
        rows_k = pref.gather(1, idx_k.long()[..., None].expand(
            -1, -1, pref.shape[2])).float()
        rows_p = pref.gather(1, idx_p.long()[..., None].expand(
            -1, -1, pref.shape[2])).float()
        pin_f = pin.float()
        gap = ((pin_f * rows_p).sum(2)
               - (pin_f * rows_k).sum(2)).abs()[differ]
        record['disagree'] = int(differ.sum())
        record['gap'] = float(gap.max()) if gap.numel() else 0.0
        return record['match']

    model.feed_data(request)
    with mock.patch.object(correlation, '_match_patches_cuda',
                           match_recorded):
        model.test()
    out_k = model.output.clone()
    with mock.patch.object(correlation, '_match_patches_cuda', match_plain), \
            mock.patch.object(dcn, '_mdcn_fused_forward_cuda',
                              dcn._mdcn_fused_forward_ref):
        model.test()
    diff = float((model.output - out_k).abs().max())
    tol = SLICE_BF16_TOL if dtype == BF16 else SLICE_TOL
    check(record['gap'] <= K1_IDX_GAP, f'the match differs where the plain '
          f'scores differ by {record["gap"]}')
    check(diff <= tol, f'request output {dtype}: kernels vs plain differ by '
          f'{diff}')
    return out_k, {'plain_vs_kernel_max_abs_diff': diff, 'tolerance': tol,
                   'match_disagreements': record['disagree'],
                   'worst_disagreement_gap': record['gap']}


def phase_slice(build_model, dyn_agg_cls, correlation, dcn, kernels,
                dtype=torch.float32):
    """Two full-width requests through ``build_model`` / ``test``, in f32
    or (``val.mixed_precision: bfloat16``) bf16; launch counts, latency,
    peak memory, and one request through the kernels against the plain
    versions (and, at bf16, against the f32 request)."""
    bf16 = dtype == BF16
    opt = _cufed5_opt()
    if bf16:
        opt['val'] = {'mixed_precision': 'bfloat16'}
    model = build_model(opt)
    check(model.device.type == 'cuda', f'model built on {model.device}')
    check(model.eval_dtype == dtype, f'eval dtype {model.eval_dtype}')
    gen = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():  # fractional sampling: non-zero offset convs
        for m in model.net_g.modules():
            if isinstance(m, dyn_agg_cls):
                w = m.conv_offset_mask.weight
                w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
                b = m.conv_offset_mask.bias
                b.copy_(torch.rand(b.shape, generator=gen) * 2 - 1)
    rng = np.random.RandomState(SEED)
    requests = [_request(rng) for _ in range(2)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    request_ms = []
    for batch in requests:
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.test()
        rlt = model.get_current_visuals()['rlt']
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        check(rlt.shape == (1, CANVAS, CANVAS, 3), f'output {rlt.shape}')
        check(rlt.dtype == np.float32, f'output {rlt.dtype}')
        check(bool(np.isfinite(rlt).all()), 'non-finite output')
    launches = read_counts(kernels, _entries(('match', 'k2'), dtype),
                           _forbidden(dtype))
    peak = torch.cuda.max_memory_allocated()

    out_k, cmp = _request_vs_plain(model, correlation, dcn, requests[0],
                                   dtype)
    rec = {'phase': 'slice_bf16' if bf16 else 'slice', 'canvas': CANVAS,
           'refs': T, 'batch': 1, 'ngf': 64, 'n_blocks': 16, 'groups': 8,
           'dtype': str(dtype), 'request_ms': request_ms,
           'peak_mem_bytes': peak, 'launches': launches, **cmp}
    if bf16:    # the same weights and request in f32
        model.eval_dtype = torch.float32
        model.test()
        model.eval_dtype = dtype
        vs = (out_k - model.output).abs()
        rec['vs_f32'] = {'max_abs_diff': float(vs.max()),
                         'mean_abs_diff': float(vs.mean()),
                         'tolerance': [BF16_VS_F32_MAX, BF16_VS_F32_MEAN]}
        check(rec['vs_f32']['max_abs_diff'] < BF16_VS_F32_MAX
              and rec['vs_f32']['mean_abs_diff'] < BF16_VS_F32_MEAN,
              f'bf16 request against f32: {rec["vs_f32"]}')
    emit(rec)
    return launches, model, requests[1]


# max |kernel - plain| / max |plain| of each parameter's gradient after a
# whole backward of a net. Two numerically different forwards cannot be
# held to a tolerance this way: where they differ in the last bit, here and
# there a ReLU gate falls on the other side, one gate moves the gradient of
# the conv before it by about 1 / sqrt(positions) of its size (1 % at
# 40x40), and a gate late in the net moves every tensor before it: in 21
# comparisons a path (``--repeat-grads 20``, H100) the worst tensor was
# off by up to 2 % and the median one by up to 8e-4, and an earlier run
# of this script found 62 % of its tensors beyond 1e-3. So the backward
# kernels are held against the plain versions behind THE SAME FORWARD: the
# autograd Functions of the CUDA path run with the plain versions' values
# in their forward, the gates agree bit for bit, every backward launch is
# the kernel's, and every tensor must agree within TRAIN_GRAD_REL_TOL (2.2e-5
# at most in those comparisons; cuDNN's weight gradients alone move by
# about 2e-5 of a tensor's max from run to run). The forward kernels in
# the net are held by the outputs. A one-element gradient (a PReLU slope,
# a noise strength) is a sum over every position of terms of both signs
# that may cancel to next to nothing, and has no other element to lend it
# a scale (up to 7e-4 behind the same forward, 13 % behind the kernels'
# own): these are held by their median. The gradients behind the kernels'
# own forward are reported beside, and held too where the two forwards
# agree bit for bit (fresh weights sample on whole pixels).
TRAIN_GRAD_REL_TOL = 1e-3
# The same comparison of a bf16 step (``train.mixed_precision: bfloat16``):
# behind the same forward the backward kernels differ from autograd through
# the plain versions only where a value is rounded to bf16 once in the
# kernel and at another point (or in another order) by autograd: grad mask
# and the column gradients, and through them every gradient before the
# DCN, by a bf16 ulp or so of a tensor's entries. Measured (H100, the first
# run of these phases): worst tensor 0.0066 (0.84 EPS_BF16) after 6 steps,
# median 0; from fresh weights 0.0011. The video steps (video_train) hold
# the same rule: there grad x goes through K2's scatter, whose f32 atomics
# add in an order that varies from run to run, and at bf16 it is rounded
# after the sum, so an order that moves a sum across a rounding boundary
# moves grad x by one bf16 ulp and every gradient upstream with it.
# Measured (H100, their first run, fresh weights): f32 worst tensor 1.4e-6
# (EDVR-M) and 1.2e-6 (BasicVSR++); bf16 0.0067 (0.86 EPS_BF16, EDVR-M) and
# 0.0114 (1.45 EPS_BF16, BasicVSR++, SpyNet's first conv).
TRAIN_GRAD_BF16_TOL = 4 * EPS_BF16


def _rel_grad_errors(got, want):
    """Each tensor's error as a share of the plain gradient's max, those
    of one element apart."""
    rel, rel_one = {}, []
    for name, ref in want.items():
        scale = float(ref.abs().max())
        err = float((got[name] - ref).abs().max())
        err = err / scale if scale else float(err > 0)
        if ref.numel() == 1:
            rel_one.append(err)
        else:
            rel[name] = err
    worst = max(rel, key=rel.get)
    return {'tensors': len(rel), 'worst': rel[worst], 'worst_name': worst,
            'median': float(np.median(list(rel.values()))),
            'one_element_tensors': len(rel_one),
            'one_element_worst': max(rel_one, default=0.),
            'one_element_median': float(np.median(rel_one or [0.]))}


def _check_grad_errors(label, errors, tol=TRAIN_GRAD_REL_TOL,
                       median_tol=None):
    median_tol = tol if median_tol is None else median_tol
    check(errors['worst'] <= tol and errors['median'] <= median_tol
          and errors['one_element_median'] <= median_tol,
          f'{label}: kernels and plain versions give other gradients: '
          f'{errors}')


def _compare_grads(model, arch, dcn, batch):
    """One backward of net_g's pixel loss from the current weights on
    fixed reference inputs, three times: through the kernels, through the
    kernels' Functions with the plain forward values (the forward kernel
    launches replaced, the backward ones not), and through the plain
    versions. Every parameter's gradient of the first two against the
    third, and the first output against the third."""
    model.feed_data(batch)
    dtype = model.train_dtype
    with torch.no_grad():
        pre_offset, img_ref_feat = model._ref_inputs(model.match_img_in,
                                                     model.img_ref_list,
                                                     dtype)

    def backward(plain_ops=False, plain_forward=False):
        model.net_g.zero_grad(set_to_none=True)
        with contextlib.ExitStack() as stack:
            if plain_ops:
                stack.enter_context(mock.patch.object(
                    arch, 'modulated_deform_conv2d',
                    dcn.modulated_deform_conv2d_ref))
                stack.enter_context(mock.patch.object(
                    arch, 'deform_sample', dcn.deform_sample_ref))
            if plain_forward:
                stack.enter_context(mock.patch.object(
                    dcn, '_mdcn_fused_forward_cuda',
                    dcn._mdcn_fused_forward_ref))
                stack.enter_context(mock.patch.object(
                    dcn, '_deform_sample_fwd_cuda', dcn.deform_sample_ref))
            rlt = model._net_g_forward(model.img_in_lq, pre_offset,
                                       img_ref_feat)
            loss = model.cri_pix(rlt, model.gt)
        loss.backward()          # outside: the backward kernels all launch
        return rlt.detach(), {name: p.grad.clone() for name, p
                              in model.net_g.named_parameters()}

    out_k, own = backward()
    out_s, same = backward(plain_forward=True)
    out_p, plain = backward(plain_ops=True)
    model.net_g.zero_grad(set_to_none=True)
    return {'same_forward': _rel_grad_errors(same, plain),
            'same_forward_bit_equal': bool(torch.equal(out_s, out_p)),
            'own_forward': _rel_grad_errors(own, plain),
            'own_forward_bit_equal': bool(torch.equal(out_k, out_p)),
            'out_max_abs_diff': float((out_k - out_p).abs().max())}


def _check_grads(label, cmp, dtype=torch.float32):
    tol = TRAIN_GRAD_BF16_TOL if dtype == BF16 else TRAIN_GRAD_REL_TOL
    _check_grad_errors(f'{label}, behind the same forward',
                       cmp['same_forward'], tol)
    check(cmp['same_forward_bit_equal'], f'{label}: the plain forward values '
          'did not give the plain forward')
    out_tol = SLICE_BF16_TOL if dtype == BF16 else SLICE_TOL
    check(cmp['out_max_abs_diff'] <= out_tol,
          f'{label}: kernels and plain versions give other outputs: {cmp}')
    if cmp['own_forward_bit_equal']:
        _check_grad_errors(label, cmp['own_forward'], tol)


def phase_train(alignment, build_model, arch, dcn, kernels,
                dtype=torch.float32):
    """Five timed training steps of the full-width model at B = 6,
    gt 160, T = 5 on one repeated batch, through ``feed_data`` ->
    ``optimize_parameters`` -> ``get_current_log``, in f32 or
    (``train.mixed_precision: bfloat16``) bf16; before and after them,
    at B = 1, one backward through the kernels against one through the
    plain versions."""
    bf16 = dtype == BF16
    expect = _entries(('match',) + (('k2', 'k2_bwd') if alignment == 'dcn'
                                    else ('k4', 'k4_bwd')), dtype)
    opt = _train_opt(alignment)
    if bf16:
        opt['train']['mixed_precision'] = 'bfloat16'
    model = build_model(opt)
    check(model.device.type == 'cuda', f'model built on {model.device}')
    check(model.train_dtype == dtype, f'train dtype {model.train_dtype}')
    rng = np.random.RandomState(SEED + 6)
    batch, small = _train_batch(rng, TRAIN_B), _train_batch(rng, 1)
    fresh = _compare_grads(model, arch, dcn, small)
    _check_grads(f'{alignment} {dtype}, fresh weights', fresh, dtype)
    model.feed_data(batch)
    model.optimize_parameters(1)                           # warm-up
    warmup_loss = model.get_current_log()['l_pix']

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    step_ms, losses = [], []
    for step in range(2, 7):
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.optimize_parameters(step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(model.get_current_log()['l_pix'])
    launches = read_counts(kernels, expect, _forbidden(dtype))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(v) for v in [warmup_loss] + losses),
          f'non-finite loss: {[warmup_loss] + losses}')
    check(losses[-1] < losses[0], f'the loss did not fall: {losses}')
    lrs = model.get_current_learning_rate()
    check(lrs == [1e-4, 1e-4, 1e-6, 1e-5], f'learning rates {lrs}')

    for p in model.net_g.parameters():
        state = model.optimizer_g.state[p]
        check(p.dtype == p.grad.dtype == state['exp_avg'].dtype
              == state['exp_avg_sq'].dtype == torch.float32,
              'master parameters, gradients and Adam state must be f32')
    trained = _compare_grads(model, arch, dcn, small)
    _check_grads(f'{alignment} {dtype}, after 6 steps', trained, dtype)
    mean_ms = sum(step_ms) / len(step_ms)
    tag = f'train_{alignment}' + ('_bf16' if bf16 else '')
    emit({'phase': tag, 'batch': TRAIN_B, 'gt': TRAIN_GT,
          'refs': T, 'network_g': opt['network_g'], 'dtype': str(dtype),
          'step_ms': step_ms, 'mean_step_ms': mean_ms,
          'img_per_s': TRAIN_B / mean_ms * 1e3, 'peak_mem_bytes': peak,
          'warmup_loss': warmup_loss, 'losses': losses,
          'learning_rates': lrs, 'launches_5_steps': launches,
          'grads_fresh_weights': fresh, 'grads_after_6_steps': trained,
          'grad_tolerance': TRAIN_GRAD_BF16_TOL if bf16
          else TRAIN_GRAD_REL_TOL,
          'out_tolerance': SLICE_BF16_TOL if bf16 else SLICE_TOL})

    def one_step():
        model.feed_data(batch)
        model.optimize_parameters(7)

    phase_profile(tag, one_step)
    return launches, mean_ms


# ------------------------------------------------------------ video paths
VSR_T, VSR_H, VSR_W = 15, 180, 320     # one --interval chunk of REDS frames
VIDEO_TOL = 1e-4                       # max |kernel - plain| / max |out|
EDVR_M = {'num_feat': 64, 'num_frame': 5, 'deformable_groups': 8,
          'num_extract_block': 5, 'num_reconstruct_block': 10,
          'with_tsa': True}            # EDVR_M_x4_SR_REDS


def _video_frames(seed, t, h, w):
    """``t`` frames ``(T, H, W, 3)`` float32 in [0, 1] of one smooth scene
    moving by 1 pixel down and 2 right a frame, so that SpyNet has motion
    to find."""
    gen = torch.Generator().manual_seed(seed)
    ch, cw = h // 8 + 4, w // 8 + 4
    base = torch.nn.functional.interpolate(
        torch.rand((1, 3, ch, cw), generator=gen), size=(ch * 8, cw * 8),
        mode='bicubic', align_corners=False).clamp(0, 1)[0]
    return torch.stack([base[:, i:i + h, 2 * i:2 * i + w] for i in range(t)]
                       ).permute(0, 2, 3, 1).contiguous().numpy()


def _splits_first(name):
    """Whether the fused entry point ``name`` is an f32 forward or dgrad of
    K2, K3 or K5, which the weight's TF32 split (``mdcn_fused_split``)
    precedes at every call."""
    return (name.startswith(('mdcn_fused_', 'mdcn_groups_fused_',
                             'deform_conv_fused_'))
            and not name.endswith('_bf16')
            and ('_fwd' in name or '_dgrad' in name))


def _only(kernels, launches, expect):
    """Every kernel of ``expect`` launched, and no other: serving runs no
    backward, scatter or other variant. An f32 forward or dgrad of the
    fused walk brings the weight's split with it."""
    expect = list(expect)
    if any(_splits_first(name) for name in expect):
        expect.append('mdcn_fused_split')
    others = {k: v for k, v in launches.items() if k not in expect and v}
    check(all(launches[k] > 0 for k in expect) and not others,
          f'expected launches of {expect} only, got {launches}')


def _kernel_vs_plain(run, dcn):
    """``run()``'s output through the kernels and with the plain K2 forward
    in their place; returns both and the largest difference."""
    with torch.inference_mode():
        out_k = run()
        with mock.patch.object(dcn, '_mdcn_fused_forward_cuda',
                               dcn._mdcn_fused_forward_ref):
            out_p = run()
    return out_k, out_p, float((out_k - out_p).abs().max())


def phase_basicvsrpp_serve(infer, infer_pp, dcn, kernels):
    """The port's ``inference`` of the repo's BasicVSR++ REDS configuration
    (mid 64, 7 blocks, residue 10, low-resolution input) on one 15-frame
    chunk of 180x320 frames, seeded weights with live offset convs: time
    per chunk, launches, the kernels against the plain version, a
    profile."""
    from mrefsr_tpu_torch.archs.basicvsrpp_arch import BasicVSRPlusPlus
    model = infer.build_model(BasicVSRPlusPlus, infer_pp.REDS_KWARGS, '',
                              torch.device('cuda'))
    gen = torch.Generator().manual_seed(SEED + 13)
    with torch.no_grad():       # offsets and masks that leave the flows
        for align in model.deform_align.values():
            last = align.conv_offset[-1]
            last.weight.copy_(torch.randn(last.weight.shape, generator=gen)
                              * 0.01)
            last.bias.copy_(torch.randn(last.bias.shape, generator=gen) * 0.1)
    imgs = _video_frames(SEED + 14, VSR_T, VSR_H, VSR_W)
    infer.inference(imgs, model)                  # warm-up: cuDNN's set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk_ms = []
    for _ in range(2):
        reset_counts(kernels)
        t0 = time.perf_counter()
        frames = infer.inference(imgs, model)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_counts(kernels, ('mdcn_fused_fwd',))
        _only(kernels, launches, ('mdcn_fused_fwd',))
    peak = torch.cuda.max_memory_allocated()
    # 4 branches x 14 aligned frames, one launch each
    check(launches['mdcn_fused_fwd'] == 4 * (VSR_T - 1),
          f'a chunk launched K2 {launches["mdcn_fused_fwd"]} times, expected '
          '56')
    check(len(frames) == VSR_T and all(
        f.shape == (4 * VSR_H, 4 * VSR_W, 3) and f.dtype == np.uint8
        for f in frames) and float(np.std(frames[7])) > 0, 'output frames')

    x = torch.from_numpy(imgs).cuda().permute(0, 3, 1, 2)[None]
    out_k, out_p, diff = _kernel_vs_plain(lambda: model(x), dcn)
    scale = float(out_p.abs().max())
    check(bool(torch.isfinite(out_k).all()), 'non-finite output')
    check(diff <= VIDEO_TOL * scale, f'basicvsrpp: kernels vs plain differ '
          f'by {diff} against max |out| {scale}')
    del out_k, out_p
    mean_ms = sum(chunk_ms) / len(chunk_ms)
    emit({'phase': 'basicvsrpp_serve', 'network_g': infer_pp.REDS_KWARGS,
          'frames': VSR_T, 'h': VSR_H, 'w': VSR_W, 'dtype': 'float32',
          'chunk_ms': chunk_ms, 'frame_ms': mean_ms / VSR_T,
          'frames_per_s': VSR_T / mean_ms * 1e3, 'peak_mem_bytes': peak,
          'launches_per_chunk': launches,
          'plain_vs_kernel_max_abs_diff': diff, 'max_abs_out': scale,
          'tolerance': VIDEO_TOL})
    phase_profile('basicvsrpp_serve', lambda: infer.inference(imgs, model))
    return launches


def phase_edvr(edvr_arch, arch_util, dcn, kernels):
    """EDVR-M x4 (REDS) on one window of 5 frames of 180x320 -> one
    720x1280 frame: seeded weights with live offset convs; times,
    launches, the kernels against the plain version, a profile."""
    with torch.device('meta'):
        net = edvr_arch.EDVR(**EDVR_M)
    net.to_empty(device='cuda')
    net.init_weights(torch.Generator().manual_seed(SEED))
    net.eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(SEED + 15)
    with torch.no_grad():       # fractional sampling: non-zero offset convs
        for m in net.modules():
            if isinstance(m, arch_util.DCNv2Pack):
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
                b = m.conv_offset.bias
                b.copy_(torch.rand(b.shape, generator=gen) * 2 - 1)
    x = torch.from_numpy(_video_frames(SEED + 16, 5, VSR_H, VSR_W)).cuda() \
        .permute(0, 3, 1, 2)[None]

    def window():
        with torch.inference_mode():
            return net(x)

    window()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    window_ms = []
    for _ in range(3):
        reset_counts(kernels)
        t0 = time.perf_counter()
        out = window()
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_counts(kernels, ('mdcn_fused_fwd',))
        _only(kernels, launches, ('mdcn_fused_fwd',))
    peak = torch.cuda.max_memory_allocated()
    check(out.shape == (1, 3, 4 * VSR_H, 4 * VSR_W)
          and bool(torch.isfinite(out).all()), f'output {tuple(out.shape)}')
    out_k, out_p, diff = _kernel_vs_plain(window, dcn)
    scale = float(out_p.abs().max())
    check(diff <= VIDEO_TOL * scale, f'edvr: kernels vs plain differ by '
          f'{diff} against max |out| {scale}')
    del out_k, out_p, out
    emit({'phase': 'edvr', 'network_g': EDVR_M, 'frames': 5, 'h': VSR_H,
          'w': VSR_W, 'dtype': 'float32', 'window_ms': window_ms,
          'peak_mem_bytes': peak, 'launches_per_window': launches,
          'plain_vs_kernel_max_abs_diff': diff, 'max_abs_out': scale,
          'tolerance': VIDEO_TOL})
    phase_profile('edvr', window)
    return launches


def phase_basicvsr_serve(infer, kernels):
    """The port's ``inference`` of BasicVSR (64 features, 30 blocks) on one
    15-frame chunk: time only; it runs no kernel of this repository."""
    from mrefsr_tpu_torch.archs.basicvsr_arch import BasicVSR
    model = infer.build_model(BasicVSR, {'num_feat': 64, 'num_block': 30},
                              '', torch.device('cuda'))
    imgs = _video_frames(SEED + 17, VSR_T, VSR_H, VSR_W)
    infer.inference(imgs, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    chunk_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        frames = infer.inference(imgs, model)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts(kernels, ())
    check(not any(launches.values()), f'BasicVSR launched {launches}')
    check(len(frames) == VSR_T and frames[0].shape == (4 * VSR_H, 4 * VSR_W,
                                                       3), 'output frames')
    mean_ms = sum(chunk_ms) / len(chunk_ms)
    emit({'phase': 'basicvsr_serve', 'num_feat': 64, 'num_block': 30,
          'frames': VSR_T, 'h': VSR_H, 'w': VSR_W, 'dtype': 'float32',
          'chunk_ms': chunk_ms, 'frame_ms': mean_ms / VSR_T,
          'peak_mem_bytes': torch.cuda.max_memory_allocated()})
    return launches


# ------------------------------------------------------- StyleGAN2 paths
SG2_TOL = 1e-4                # max |kernel - plain| / max |plain out|
SG2_KERNELS = ('upfirdn2d_fwd', 'upfirdn2d_bwd', 'upfirdn2d_bwd2',
               'fused_leaky_relu_fwd', 'fused_leaky_relu_bwd',
               'fused_leaky_relu_bwd2')


@contextlib.contextmanager
def _plain_ops(arch, ops_upfirdn2d, fused_act, plain=True):
    """While this is open (and ``plain``), the StyleGAN2 nets run through
    the plain versions of both ops."""
    if not plain:
        yield
        return
    with mock.patch.object(arch, 'upfirdn2d', ops_upfirdn2d.upfirdn2d_ref), \
            mock.patch.object(arch, 'fused_leaky_relu',
                              fused_act.fused_leaky_relu_ref):
        yield


def _liven(net, gen):
    """Seeded non-zero noise strengths and activation biases: a fresh net
    has zeros there, which would leave the injected noise and the bias add
    out of every comparison."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith('activate.bias') or (
                    p.shape == (1,) and name.endswith('.weight')):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)


def phase_stylegan2_serve(infer, arch, ops_upfirdn2d, fused_act, kernels):
    """The FFHQ config-f generator at full width through the inference
    module: mean latent, two grids, one grid against the plain versions."""
    size, samples = SG2_SERVE['out_size'], SG2_SERVE_SAMPLES
    args = infer.parse_args([
        '--size', str(size), '--sample', str(samples), '--pics', '1',
        '--truncation', '0.7', '--truncation_mean', '4096', '--seed',
        str(SEED), '--ckpt', '', '--channel_multiplier',
        str(SG2_SERVE['channel_multiplier'])])
    net = infer.build_generator(args, torch.device('cuda'))
    _liven(net, torch.Generator().manual_seed(SEED + 10))
    check(next(net.parameters()).is_cuda, 'generator not on the card')
    generator = torch.Generator(device='cuda').manual_seed(SEED)

    reset_counts(kernels)
    latent = infer.mean_latent(net, args, generator)
    torch.cuda.synchronize()
    launches_latent = read_counts(kernels, ('fused_leaky_relu_fwd',))
    check(launches_latent['fused_leaky_relu_fwd'] == 8
          and launches_latent['upfirdn2d_fwd'] == 0,
          f'mean latent launched {launches_latent}')
    check(latent.shape == (1, 512) and bool(torch.isfinite(latent).all()),
          'mean latent')

    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    grid_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        grid, = infer.generate(args, net, latent, generator, write=False)
        torch.cuda.synchronize()
        grid_ms.append((time.perf_counter() - t0) * 1e3)
        side = 4 * size + 3 * 2       # 4 x 4 images, 2 pixels between
        check(grid.shape == (side, side, 3) and grid.dtype == np.uint8,
              f'grid {grid.shape} {grid.dtype}')
        check(float(grid.std()) > 0, 'the grid is flat')
    launches = read_counts(kernels, ('upfirdn2d_fwd', 'fused_leaky_relu_fwd'))
    peak = torch.cuda.max_memory_allocated()
    check(launches['upfirdn2d_fwd'] == 2 * 16
          and launches['fused_leaky_relu_fwd'] == 2 * 25,
          f'two grids launched {launches}, expected 16 of K7 and 25 of K8 '
          f'a grid')
    check(all(launches[k] == 0 for k in SG2_KERNELS if 'bwd' in k),
          f'serving launched a backward kernel: {launches}')

    # one grid through the kernels and through the plain versions, with
    # the same codes and the same (stored) noise
    codes = torch.randn((samples, 512), generator=generator, device='cuda')

    def sample():
        with torch.inference_mode():
            return net([codes], truncation=args.truncation,
                       truncation_latent=latent, randomize_noise=False)[0]

    out_k = sample()
    with _plain_ops(arch, ops_upfirdn2d, fused_act):
        out_p = sample()
    check(out_k.shape == (samples, 3, size, size)
          and bool(torch.isfinite(out_k).all()), 'sampled images')
    scale = float(out_p.abs().max())
    diff = float((out_k - out_p).abs().max())
    check(diff <= SG2_TOL * scale, f'serve: kernels vs plain differ by '
          f'{diff} against max |out| {scale}')
    del out_k, out_p
    emit({'phase': 'stylegan2_serve', **SG2_SERVE, 'samples': samples,
          'truncation': 0.7, 'truncation_mean': 4096, 'dtype': 'float32',
          'grid_ms': grid_ms, 'peak_mem_bytes': peak,
          'launches_mean_latent': launches_latent,
          'launches_2_grids': launches,
          'plain_vs_kernel_max_abs_diff': diff, 'max_abs_out': scale,
          'tolerance': SG2_TOL})

    def one_grid():
        infer.generate(args, net, latent, generator, write=False)

    phase_profile('stylegan2_serve', one_grid)
    return {k: launches[k] + launches_latent[k] for k in launches}


def _sg2_train_opt(root):
    """The reference's FFHQ 256 recipe (its YAML is not in the repository;
    batch 8 is this script's choice)."""
    net = {'out_size': SG2_TRAIN_SIZE, 'channel_multiplier': 2}
    return {
        'name': 'stylegan2_256', 'model_type': 'StyleGAN2Model',
        'manual_seed': SEED, 'is_train': True,
        'network_g': {'type': 'StyleGAN2Generator', 'num_style_feat': 512,
                      'num_mlp': 8, **net},
        'network_d': {'type': 'StyleGAN2Discriminator', **net},
        'path': {'models': os.path.join(root, 'models'),
                 'training_states': os.path.join(root, 'training_states'),
                 'visualization': os.path.join(root, 'visualization')},
        'val': {'num_val_samples': 16},
        'train': {
            'optim_g': {'type': 'Adam', 'lr': 2e-3},
            'optim_d': {'type': 'Adam', 'lr': 2e-3},
            'scheduler': {'type': 'MultiStepLR', 'milestones': [600000],
                          'gamma': 0.5},
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'wgan_softplus',
                        'loss_weight': 1.0},
            'r1_reg_weight': 10, 'path_reg_weight': 2, 'net_g_reg_every': 4,
            'net_d_reg_every': 16, 'mixing_prob': 0.9,
            'path_batch_shrink': 2, 'total_iter': 800000,
            'warmup_iter': -1}}


# The path-length penalty differentiates twice a random projection of the
# image (``fake_img * noise``): every sum on the way is of terms of both
# signs, and in f32 the plain versions' own gradients move from run to run
# (cuDNN's atomics) by up to 1.8e-3 of a tensor's max, 3.7e-4 in the
# median and 7 % for a noise strength, and the kernels' differ from them
# by as much: 2.1e-3, 2.2e-4, 4 % (``--repeat-grads 20``, H100). So the
# G loss with the penalty gets a two-part rule (every tensor of more than
# one element, and the medians), and the plain versions' own spread is
# measured beside it; the D loss with R1 agrees to 2e-6 and gets
# TRAIN_GRAD_REL_TOL.
SG2_PATH_GRAD_TOL = 5e-2
SG2_PATH_GRAD_MEDIAN_TOL = 5e-3
SG2_LOSS_REL_TOL = 1e-3


def _sg2_compare_grads(model, arch, ops_upfirdn2d, fused_act, real,
                       seed=SEED + 11):
    """From the model's current weights, on fixed images, codes and noise,
    through the kernels and through the plain versions: every net_d
    gradient of the D loss with R1 and every net_g gradient of the G loss
    with the path penalty (the plain versions twice, for their own
    spread)."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    b = real.shape[0]
    net_g, net_d = model.net_g, model.net_d

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda')

    def noises(n):
        return [randn(n, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2))
                for i in range(net_g.num_layers)]

    styles, noise = [randn(b, 512), randn(b, 512)], noises(b)
    path = {'styles': [randn(b // 2, 512), randn(b // 2, 512)],
            'noise': noises(b // 2),
            'img_noise': randn(b // 2, 3, SG2_TRAIN_SIZE, SG2_TRAIN_SIZE)}
    with torch.no_grad():
        fake = net_g(styles, inject_index=5, noise=noise)[0]

    def grads_of(net, loss):
        net.zero_grad(set_to_none=True)
        loss.backward()
        grads = {name: p.grad.clone() for name, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    def backward(plain):
        with _plain_ops(arch, ops_upfirdn2d, fused_act, plain):
            net_d.requires_grad_(True)
            d = grads_of(net_d, model.d_loss(real, fake, do_r1=True)[0])
            net_d.requires_grad_(False)
            g = grads_of(net_g, model.g_loss(styles, 5, noise=noise,
                                             path=path)[0])
        return {'d_r1': d, 'g_path': g}

    kernels, plain, plain_again = backward(False), backward(True), \
        backward(True)
    out = {f'grads_{loss}': _rel_grad_errors(kernels[loss][1],
                                             plain[loss][1])
           for loss in plain}
    out['grads_g_path_plain_twice'] = _rel_grad_errors(
        plain_again['g_path'][1], plain['g_path'][1])
    out['losses_kernels'] = {loss: kernels[loss][0] for loss in plain}
    out['losses_plain'] = {loss: plain[loss][0] for loss in plain}
    return out


def _sg2_check_grads(label, cmp):
    _check_grad_errors(f'{label}, D loss with R1', cmp['grads_d_r1'])
    _check_grad_errors(f'{label}, G loss with the path penalty',
                       cmp['grads_g_path'], SG2_PATH_GRAD_TOL,
                       SG2_PATH_GRAD_MEDIAN_TOL)
    check(all(abs(cmp['losses_kernels'][loss] - want)
              <= SG2_LOSS_REL_TOL * abs(want)
              for loss, want in cmp['losses_plain'].items()),
          f'{label}: kernels and plain versions give other losses: {cmp}')


def _sg2_train_batch():
    rng = np.random.RandomState(SEED + 12)
    return {'gt': (rng.rand(SG2_TRAIN_B, SG2_TRAIN_SIZE, SG2_TRAIN_SIZE, 3)
                   * 2 - 1).astype(np.float32)}


def phase_stylegan2_train(build_model, arch, ops_upfirdn2d, fused_act,
                          kernels, root):
    """``StyleGAN2Model`` at 256x256, channel multiplier 2, B 8: the
    gradient comparison from fresh weights, then warm-up and timed steps
    of each kind, a save and a reload."""
    opt = _sg2_train_opt(root)
    model = build_model(opt)
    check(model.device.type == 'cuda', f'model built on {model.device}')
    batch = _sg2_train_batch()
    model.feed_data(batch)
    fresh = _sg2_compare_grads(model, arch, ops_upfirdn2d, fused_act,
                               model.real_img)
    _sg2_check_grads('stylegan2, fresh weights', fresh)
    kinds = {'plain': (1, 17, 18), 'path': (4, 20, 24), 'both': (16, 32, 48)}
    for iters in kinds.values():                            # warm-up
        model.feed_data(batch)
        model.optimize_parameters(iters[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, logs, launches = {}, {}, {}
    total = {name: 0 for name in kernels}
    for kind, iters in kinds.items():
        step_ms[kind] = []
        for it in iters[1:]:
            reset_counts(kernels)
            t0 = time.perf_counter()
            model.feed_data(batch)
            model.optimize_parameters(it)
            torch.cuda.synchronize()
            step_ms[kind].append((time.perf_counter() - t0) * 1e3)
            launches[kind] = read_counts(
                kernels, ('upfirdn2d_fwd', 'upfirdn2d_bwd',
                          'fused_leaky_relu_fwd', 'fused_leaky_relu_bwd'))
            for name, count in launches[kind].items():
                total[name] += count
            logs[it] = model.get_current_log()
            check(all(np.isfinite(v) for v in logs[it].values()),
                  f'iteration {it}: non-finite log {logs[it]}')
        mpl = float(model.mean_path_length)
        if kind != 'plain':
            check(np.isfinite(mpl) and mpl > 0, f'mean path length {mpl}')
    peak = torch.cuda.max_memory_allocated()
    # a plain step: G 12 + D 12 + D 12 launches of K7 forward in the D
    # update and G 12 + D 12 in the G update; as many backward launches
    # as forward ones with a graph (D twice, then D and G); no double
    # backward. The penalties, and only they, differentiate twice.
    check(launches['plain']['upfirdn2d_fwd'] == 60
          and launches['plain']['upfirdn2d_bwd'] == 48,
          f'a plain step launched {launches["plain"]}')
    check(all(launches['plain'][k] == 0 for k in SG2_KERNELS if 'bwd2' in k),
          f'a plain step launched a double backward: {launches["plain"]}')
    for kind in ('path', 'both'):
        check(all(launches[kind][k] > 0 for k in SG2_KERNELS),
              f'a {kind} step left a kernel out: {launches[kind]}')
    check('l_g_path' in logs[24] and 'l_g_path' in logs[48]
          and logs[48]['l_d_r1'] > 0 and logs[24]['l_d_r1'] == 0,
          f'the penalties did not fall on their iterations: {logs}')

    # save, then reload into a fresh model: both nets, the EMA, both Adams
    model.save(0, 48)
    opt2 = _sg2_train_opt(root)
    opt2['path'].update(
        pretrain_network_g=os.path.join(opt['path']['models'],
                                        'net_g_48.pth'),
        pretrain_network_d=os.path.join(opt['path']['models'],
                                        'net_d_48.pth'))
    other = build_model(opt2)
    other.resume_training(other.load_training_state(os.path.join(
        opt['path']['training_states'], '48.state')))
    for label in ('net_g', 'net_g_ema', 'net_d'):
        mine = getattr(model, label).state_dict()
        theirs = getattr(other, label).state_dict()
        check(mine.keys() == theirs.keys() and all(
            torch.equal(mine[k], theirs[k]) for k in mine),
            f'{label} changed over save and reload')
    check(not torch.equal(model.net_g.state_dict()['style_conv1.activate.bias'],
                          model.net_g_ema.state_dict()[
                              'style_conv1.activate.bias']),
          'the EMA generator equals the generator after 9 steps')
    for mine, theirs in zip(model.optimizers, other.optimizers):
        a, b = mine.state_dict()['state'], theirs.state_dict()['state']
        check(a.keys() == b.keys() and all(
            torch.equal(a[k]['exp_avg_sq'], b[k]['exp_avg_sq']) for k in a),
            'an optimizer changed over save and resume')
    del other

    mean_ms = {kind: sum(v) / len(v) for kind, v in step_ms.items()}
    emit({'phase': 'stylegan2_train', 'out_size': SG2_TRAIN_SIZE,
          'channel_multiplier': 2, 'batch': SG2_TRAIN_B, 'dtype': 'float32',
          'gan_type': 'wgan_softplus', 'net_g_reg_every': 4,
          'net_d_reg_every': 16, 'iterations': {k: v[1:] for k, v in
                                                kinds.items()},
          'step_ms': step_ms, 'mean_step_ms': mean_ms,
          'img_per_s': {k: SG2_TRAIN_B / v * 1e3
                        for k, v in mean_ms.items()},
          'peak_mem_bytes': peak, 'logs': logs, 'mean_path_length': mpl,
          'launches_per_step': launches, 'grads_fresh_weights': fresh,
          'grad_tolerance': TRAIN_GRAD_REL_TOL,
          'path_grad_tolerance': SG2_PATH_GRAD_TOL,
          'path_grad_median_tolerance': SG2_PATH_GRAD_MEDIAN_TOL,
          'loss_tolerance': SG2_LOSS_REL_TOL,
          'learning_rates': model.get_current_learning_rate()})

    for kind, it in (('plain', 49), ('path', 52), ('both', 64)):
        def one_step(it=it):
            model.feed_data(batch)
            model.optimize_parameters(it)

        phase_profile(f'stylegan2_train_{kind}', one_step)
    return total


# -------------------------------------------------------------- multi-rank
DDP_WORLD = 2
DDP_WAIT_S = 900               # the parent's wait for its ranks
# image rows of the 125-row eval ref a rank matches against: 62 and 61 of
# its 123 patch rows, with the 2-row halo (an uneven split)
SHARD_ROWS = ((0, 64), (62, 125))
# the planted tie: the ref patch at TIE_SRC (rank 1's band) copied to
# TIE_DST (rank 0's), and the input patch at TIE_IN equal to both
TIE_SRC, TIE_DST, TIE_IN = (100, 50), (10, 20), (40, 60)
# max |DDP - mean of per-sample gradients| / max |mean| of each parameter,
# from fresh weights, behind the same forwards (cuDNN held deterministic
# for the comparison): at most the order of two f32 sums differs. The
# first H100 run (gloo, one card) read 0 for every tensor: bit-equal
DDP_GRAD_REL_TOL = 1e-6
DIST_VAL_REL_TOL = 1e-9        # sharded metric sums against unsharded
DDP_LOSS_REL_TOL = 1e-6        # logged l_pix against the ranks' own mean


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _same_on_all_ranks(tensor):
    """Whether every rank holds ``tensor`` bit for bit: an element-wise
    MAX and MIN all-reduce of its bits."""
    bits = tensor.detach().reshape(-1).contiguous()
    if bits.dtype == torch.float32:
        bits = bits.view(torch.int32)
    high, low = bits.clone(), bits.clone()
    dist.all_reduce(high, op=dist.ReduceOp.MAX)
    dist.all_reduce(low, op=dist.ReduceOp.MIN)
    return bool(torch.equal(high, low))


def _gathered(value, rank, world, device):
    """Every rank's float ``value``, by rank, through a SUM all-reduce (no
    ``all_gather``: gloo has none for CUDA tensors)."""
    slots = torch.zeros(world, dtype=torch.float64, device=device)
    slots[rank] = value
    dist.all_reduce(slots)
    return slots.tolist()


class _MainPath:
    """The launch counts of the parts of the main path, summed: every
    count is set to 0 just before a part and read just after it. Launches
    between parts (the comparisons) are not counted."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.total = {name: 0 for name in kernels}

    @contextlib.contextmanager
    def part(self):
        """Count one part; yields the dict that then holds its counts."""
        reset_counts(self.kernels)
        counts = {}
        yield counts
        for name, kernel in self.kernels.items():
            counts[name] = kernel.launches
            self.total[name] += kernel.launches


def _ddp_sharded_match(correlation, main, rank, world, dtype=torch.float32):
    """K6 at K1's eval shape, the ref's rows split over the ranks: the
    band's prologue against its plain version at ref strides 1 and 2 (the
    band is the one shape where the two maps differ in size); K6 against
    single-rank K1 on the whole ref, against its plain version (at bf16
    leaving out the rows that a norm the prologue rounds apart, on any
    rank, touches, as K1's phase does) and against the plain match behind
    the same prologue (the plain per-rank match on the prologue kernel's
    patches, with the same collectives); ties planted across the band
    boundary; times. f32, or bf16 through the bf16 kernel's sharded entry
    point."""
    gen = torch.Generator().manual_seed(SEED + 20)
    h = CANVAS // 4
    feats = torch.randn((2, T, h, h, 256), generator=gen).cuda()
    feats = (feats / (feats.norm(dim=-1, keepdim=True) + 1e-12)).to(dtype)
    fin, fref = feats[0], feats[1]
    start, stop = SHARD_ROWS[rank]
    band = (fref[:, start:stop], start)
    kw = dict(is_norm=True, norm_input=True)
    # the band's prologue; where its norms round apart from the plain ones
    # at stride 1, as a mask over the whole ref's patches, on every rank
    band_prologue = []
    for ref_stride in (2, 1):
        line, in_flip, ref_flip = phase_prologue(
            correlation, fin, band[0], 'band', ref_stride, timed=False)
        band_prologue.append(line)
    pw = h - 2
    flips = torch.zeros((T, pw * pw), dtype=torch.int32, device=fin.device)
    flips[:, start * pw:start * pw + ref_flip.shape[1]] = ref_flip.int()
    dist.all_reduce(flips, op=dist.ReduceOp.MAX)
    with main.part():
        idx, val = correlation.feature_match_index_sharded(fin, band, **kw)
    idx_1, val_1 = correlation.feature_match_index(fin, fref, **kw)
    idx_p, val_p = correlation.feature_match_index_sharded_ref(fin, band,
                                                               **kw)
    flat, flat_p = idx.reshape(T, -1).long(), idx_p.reshape(T, -1).long()
    keep = ~(in_flip | flips.gather(1, flat).bool()
             | flips.gather(1, flat_p).bool())
    idx_m, val_m = correlation._feature_match_sharded(
        fin, band, None, 3, 1, 1, True, True, 2048,
        correlation._prologue_cuda, correlation._match_patches_ref)
    # the scores of either pick: from the patches the kernels match on, and
    # from the plain ones for the plain version
    kernel_patches = [p.float() for p in correlation._prologue_cuda(
        fin, fref, 3, 1, 1, True)[:2]]
    plain_patches = _normed_patches(correlation, fin, fref)
    rec = {'rank': rank, 'band_rows': [start, stop], 'dtype': str(dtype),
           'band_prologue': band_prologue,
           'plain_rows_left_out_rounded_apart': int((~keep).sum())}
    for label, other_idx, other_val, patches, rows in (
            ('k1', idx_1, val_1, kernel_patches, None),
            ('plain', idx_p, val_p, plain_patches, keep),
            ('plain_match', idx_m, val_m, kernel_patches, None)):
        differ, gap = _index_gap(*patches, idx, other_idx, rows)
        err = (val - other_val).reshape(T, -1).abs()
        err = float((err if rows is None else err[rows]).max())
        check(gap <= K1_IDX_GAP, f'rank {rank}: K6 index differs from '
              f'{label} where the plain scores differ by {gap}')
        check(err <= K1_VAL_TOL, f'rank {rank}: K6 val differs from '
              f'{label} by {err}')
        rec[f'vs_{label}'] = {'index_disagreements': int(differ.sum()),
                              'worst_disagreement_gap': gap,
                              'max_abs_err': err}
    del kernel_patches, plain_patches
    check(_same_on_all_ranks(idx) and _same_on_all_ranks(val),
          'the ranks hold other answers')

    # a ref patch of rank 1's band copied into rank 0's, and an input
    # patch equal to both: the tie must go to rank 0's lower index
    fin_t, fref_t = fin.clone(), fref.clone()
    (sy, sx), (dy, dx), (iy, ix) = TIE_SRC, TIE_DST, TIE_IN
    fref_t[:, dy:dy + 3, dx:dx + 3] = fref_t[:, sy:sy + 3, sx:sx + 3]
    fin_t[:, iy:iy + 3, ix:ix + 3] = fref_t[:, sy:sy + 3, sx:sx + 3]
    with main.part():
        idx_t, _ = correlation.feature_match_index_sharded(
            fin_t, (fref_t[:, start:stop], start), is_norm=True)
    idx_t1, _ = correlation.feature_match_index(fin_t, fref_t, is_norm=True)
    want = dy * pw + dx
    got = idx_t[:, iy, ix].tolist()
    check(got == [want] * T and idx_t1[:, iy, ix].tolist() == [want] * T,
          f'rank {rank}: a tie across the band boundary went to {got} and '
          f'{idx_t1[:, iy, ix].tolist()}, not to the lowest index {want}')
    rec['tie'] = {'lowest_index': want, 'got': got}

    # times: K6 as the path runs it (the ranks at once), K1 on the band
    # with each rank alone on the card, the fuse, the plain version, and
    # the library yardstick: the band's scores by chunked torch.matmul
    # and the same two all-reduces
    pin_b, pref_b, _ = correlation._prologue_cuda(fin, band[0], 3, 1, 1,
                                                  True)
    match_band = correlation._match_patches_sharded_cuda
    ms = cuda_ms(lambda: correlation.feature_match_index_sharded(
        fin, band, **kw))
    kernel_ms = None
    for turn in range(world):
        dist.barrier()
        if turn == rank:
            kernel_ms = cuda_ms(lambda: match_band(pin_b, pref_b))
    dist.barrier()
    local_idx, local_val = match_band(pin_b, pref_b)
    fuse = (band[0].shape[-2], start, 3, 1, None)
    collective_ms = cuda_ms(lambda: correlation._fuse_across_ranks(
        local_idx, local_val, *fuse))
    plain_ms = cuda_ms(lambda: correlation.feature_match_index_sharded_ref(
        fin, band, **kw), reps=2)

    def library():
        for base in range(0, pref_b.shape[1], 2048):
            torch.matmul(pin_b, pref_b[:, base:base + 2048].transpose(1, 2))
        correlation._fuse_across_ranks(local_idx, local_val, *fuse)

    library_ms = cuda_ms(library)
    pairs, n_in, d = pin_b.shape
    n_ref = pref_b.shape[1]
    flops = 2.0 * pairs * n_in * n_ref * d
    nbytes = (fin.element_size() * (fin.numel() + band[0].numel())
              + 8.0 * pairs * n_in)
    if dtype == BF16:
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    else:   # the three TF32 products the kernel runs; and f32 SIMT
        bound_ms, bound_by = bound([(3 * flops, PEAK_TF32_FLOPS)], nbytes)
        rec['bound_f32_cuda_cores_ms'] = bound(flops, nbytes)[0]
    rec.update(n_in=n_in, n_ref_band=n_ref, d=d, ms=ms,
               kernel_only_ms=kernel_ms, collective_ms=collective_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by,
               max_abs_err=max(rec['vs_plain']['max_abs_err'],
                               rec['vs_plain_match']['max_abs_err']))
    return rec


def _mean_bare_grads(model, batches):
    """Each parameter's gradient of the pixel loss, summed over
    ``batches`` one at a time through the bare net, over their count."""
    bare = model.get_bare_model(model.net_g)
    total = {}
    for sample in batches:
        model.feed_data(sample)
        bare.zero_grad(set_to_none=True)
        model.cri_pix(model._forward(model.match_img_in, model.img_ref_list,
                                     model.img_in_lq, bare),
                      model.gt).backward()
        for name, p in bare.named_parameters():
            total[name] = total.get(name, 0) + p.grad / len(batches)
    bare.zero_grad(set_to_none=True)
    return total


def _flat_params(model):
    return torch.cat([p.detach().reshape(-1) for p in
                      model.get_bare_model(model.net_g).parameters()])


def _ddp_train(build_model, main, rank, world):
    """The full-width stage-3 step with ``dist: true``: B 6 a rank, each
    rank its own seeded batch. From fresh weights the DDP gradient of one
    sample a rank against the mean of the per-sample gradients; then a
    warm-up step (its logged loss against the ranks' own) and three timed
    steps."""
    opt = _train_opt('dcn')
    opt.update(name='ddp', scale=4, crop_border=4, dist=True,
               datasets={'train': {'batch_size_per_gpu': TRAIN_B}})
    model = build_model(opt)
    check(model.device.type == 'cuda', f'model built on {model.device}')
    bare = model.get_bare_model(model.net_g)

    # DDP's gradient, one sample a rank, against every rank's sample
    # through the bare net, averaged; cuDNN deterministic meanwhile
    smalls = [_train_batch(np.random.RandomState(SEED + 30 + r), 1)
              for r in range(world)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model.feed_data(smalls[rank])
        model.net_g.zero_grad(set_to_none=True)
        model.cri_pix(model._forward(model.match_img_in, model.img_ref_list,
                                     model.img_in_lq), model.gt).backward()
        ddp_grads = {n: p.grad.clone() for n, p in bare.named_parameters()}
        mean_grads = _mean_bare_grads(model, smalls)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    grad_errors = _rel_grad_errors(ddp_grads, mean_grads)
    _check_grad_errors(f'rank {rank}: DDP gradient against the per-sample '
                       'mean', grad_errors, tol=DDP_GRAD_REL_TOL,
                       median_tol=DDP_GRAD_REL_TOL)
    del ddp_grads, mean_grads

    batch = _train_batch(np.random.RandomState(SEED + 40 + rank), TRAIN_B)
    model.feed_data(batch)
    with torch.no_grad():
        own = float(model.cri_pix(model._forward(
            model.match_img_in, model.img_ref_list, model.img_in_lq, bare),
            model.gt))
    owns = _gathered(own, rank, world, model.device)
    model.optimize_parameters(1)                            # warm-up
    logged = model.get_current_log()['l_pix']
    mean_own = sum(owns) / world
    check(abs(logged - mean_own) <= DDP_LOSS_REL_TOL * abs(mean_own),
          f'rank {rank}: logged l_pix {logged}, the ranks\' own {owns}')

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    with main.part() as launches:
        for step in range(2, 5):
            t0 = time.perf_counter()
            model.feed_data(batch)
            model.optimize_parameters(step)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(model.get_current_log()['l_pix'])
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(v) for v in [logged] + losses),
          f'non-finite loss: {[logged] + losses}')
    check(_same_on_all_ranks(_flat_params(model)),
          'net_g differs between the ranks after the steps')
    mean_ms = sum(step_ms) / len(step_ms)

    def one_step():
        model.feed_data(batch)
        model.optimize_parameters(5)

    # rank 0 profiles one more step, which the other ranks take with it
    # (the gradient all-reduce is collective); rank 0's own device time:
    # on one card the other rank's kernels are not in it
    profile = profile_record('ddp_train', one_step, top=16) if rank == 0 \
        else one_step()
    rec = {'rank': rank, 'device': str(model.device), 'batch': TRAIN_B,
           'gt': TRAIN_GT, 'refs': T, 'step_ms': step_ms,
           'mean_step_ms': mean_ms,
           'global_img_per_s': world * TRAIN_B / mean_ms * 1e3,
           'peak_mem_bytes': peak, 'warmup_loss': logged,
           'ranks_own_losses': owns, 'losses': losses,
           'launches_3_steps': launches, 'grads_fresh_weights': grad_errors,
           'grad_tolerance': DDP_GRAD_REL_TOL}
    if rank == 0:
        rec['profile'] = profile
    return model, batch, rec


class _SeededCUFED5:
    """Four CUFED5-style requests at the 500x500 canvas from a seed; the
    last carries ``padding`` and the 332x500 size of its gt, as a CUFED5
    image padded to the canvas does."""
    opt = {'name': 'cufed5_seeded'}
    original_size = (332, 500)

    def __len__(self):
        return 4

    def __getitem__(self, i):
        item = {k: v[0] for k, v in
                _request(np.random.RandomState(SEED + 50 + i)).items()}
        item['lq_path'] = f'seeded_{i:03d}_multi.png'
        if i == len(self) - 1:
            height, width = self.original_size
            item['img_in'] = item['img_in'][:height, :width].copy()
            item['padding'] = True
            item['original_size'] = self.original_size
        return item


class _ValLoader:
    """A validation loader: batch 1, no sampler."""
    sampler = None
    batch_size = 1

    def __init__(self, dataset, collate):
        self.dataset = dataset
        self.collate_fn = collate

    def __iter__(self):
        return (self.collate_fn([self.dataset[i]])
                for i in range(len(self.dataset)))


def _ddp_dist_val(model, main, rank, world):
    """``validation`` with ``dist: true``: each rank's sums, rank 0's
    unsharded sums, and every rank's ``metric_results``."""
    from mrefsr_tpu_torch.data import default_collate
    loader = _ValLoader(_SeededCUFED5(), default_collate)
    shard = []
    validate = model._validate_images

    def recorded(*args, **kwargs):
        shard.append(validate(*args, **kwargs))
        return shard[-1]

    dist.barrier()              # rank 0 may still be writing its profile
    t0 = time.perf_counter()
    with main.part(), mock.patch.object(model, '_validate_images', recorded):
        model.validation(loader, 0, None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = torch.tensor(shard[0], dtype=torch.float64, device=model.device)
    dist.all_reduce(total)
    total = total.cpu().numpy()
    rec = {'rank': rank, 'seconds': seconds, 'shard_sums': shard[0].tolist(),
           'metric_results': model.metric_results}
    if rank == 0:
        full = model._validate_images(loader, 0, False)
        rel = float(np.abs(total - full).max() / np.abs(full).max())
        check(rel <= DIST_VAL_REL_TOL, f'sharded sums {total.tolist()} '
              f'against unsharded {full.tolist()}')
        check(full[3] == len(loader.dataset) and np.isfinite(full).all(),
              f'unsharded sums {full.tolist()}')
        rec.update(full_sums=full.tolist(), rel_err=rel)
    dist.barrier()
    return rec


def _ddp_resume(build_model, model, batch, main, rank, root):
    """``save(0, 5)`` from rank 0 only; a fresh model on every rank
    resumes from the files and takes a step; the ``.pth`` loads strictly
    into a model of one process."""
    paths = {'models': os.path.join(root, 'models'),
             'training_states': os.path.join(root, 'training_states')}
    model.opt['path'] = dict(paths)
    written = []
    save = torch.save

    def recording(obj, path, *args, **kwargs):
        written.append(os.path.basename(str(path)))
        return save(obj, path, *args, **kwargs)

    with mock.patch.object(torch, 'save', recording):
        model.save(0, 5)
    dist.barrier()
    check(written == (['net_g_5.pth', '5.state'] if rank == 0 else []),
          f'rank {rank} wrote {written}')
    pth = os.path.join(paths['models'], 'net_g_5.pth')
    saved = torch.load(pth, map_location='cpu', weights_only=True)['params']
    check(not [k for k in saved if k.startswith('module.')],
          'the .pth carries DDP\'s module. prefix')
    opt = copy.deepcopy(model.opt)
    opt['path']['pretrain_network_g'] = pth
    del model
    torch.cuda.empty_cache()
    resumed = build_model(opt)
    state = resumed.load_training_state(
        os.path.join(paths['training_states'], '5.state'))
    resumed.resume_training(state)
    bare = resumed.get_bare_model(resumed.net_g).state_dict()
    check(all(torch.equal(bare[k].cpu(), v) for k, v in saved.items()),
          f'rank {rank}: the resumed net_g is not the saved one')
    resumed.feed_data(batch)
    with main.part():
        resumed.optimize_parameters(state['iter'] + 1)
    loss = resumed.get_current_log()['l_pix']
    check(np.isfinite(loss) and resumed.get_current_learning_rate()
          == [1e-4, 1e-4, 1e-6, 1e-5], f'resumed step: loss {loss}')
    check(_same_on_all_ranks(_flat_params(resumed)),
          'net_g differs between the ranks after the resumed step')
    rec = {'rank': rank, 'written': written, 'resumed_iter': state['iter'],
           'resumed_loss': loss}
    if rank == 0:
        single = _cufed5_opt()
        single['path'] = {'pretrain_network_g': pth}
        one = build_model(single)            # strict_load defaults to True
        got = one.net_g.state_dict()
        check(sorted(got) == sorted(saved) and all(
            torch.equal(got[k].cpu(), v) for k, v in saved.items()),
            'the .pth does not load into a model of one process')
        rec['single_process_strict_load'] = True
    dist.barrier()
    return rec


def _ddp_rank(rank, backend, root):
    """One rank of the ``ddp`` phase, a process of its own: joins the
    group under the torchrun env contract the parent set, runs the four
    parts, and writes its report to ``root/rank<r>.json``; then, where
    ``root/with_gan`` exists, ``ddp_gan``'s part (:func:`_ddp_gan_part`),
    and last A13's (:func:`_ddp_realesr_part`)."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank))
    import importlib

    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.ops import correlation, dcn, fused_act
    from mrefsr_tpu_torch.utils.dist_util import get_dist_info, init_dist
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')
    init_dist('pytorch', backend=backend)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rank, world = get_dist_info()
        main = _MainPath(kernel_objects(correlation, dcn, ops_upfirdn2d,
                                        fused_act))
        report = {'rank': rank,
                  'device': f'cuda:{torch.cuda.current_device()}',
                  'device_name': torch.cuda.get_device_name()}
        t0 = time.perf_counter()
        report['sharded_match'] = _ddp_sharded_match(correlation, main, rank,
                                                     world)
        report['sharded_match_bf16'] = _ddp_sharded_match(
            correlation, main, rank, world, BF16)
        torch.cuda.empty_cache()
        model, batch, report['ddp_train'] = _ddp_train(build_model, main,
                                                       rank, world)
        report['dist_val'] = _ddp_dist_val(model, main, rank, world)
        report['ddp_resume'] = _ddp_resume(build_model, model, batch, main,
                                           rank, root)
        report['seconds'] = time.perf_counter() - t0
        report['launches'] = main.total
        dist.barrier()
        with open(os.path.join(root, f'rank{rank}.json'), 'w') as f:
            json.dump(report, f)
        del model, batch
        if os.path.exists(os.path.join(root, 'with_gan')):
            gc.collect()
            torch.cuda.empty_cache()
            _ddp_gan_part(build_model, main.kernels, rank, root)
        gc.collect()
        torch.cuda.empty_cache()
        _ddp_realesr_part(build_model, main.kernels, rank, root)
    finally:
        dist.destroy_process_group()


def phase_ddp(gan_build_model=None):
    """Two ranks, each a process started with ``torch.multiprocessing``
    (spawn) under the torchrun env contract: NCCL with a card a rank where
    there are two cards or more, else gloo with both ranks on the one
    card (NCCL refuses two ranks on one device; gloo reduces CUDA tensors
    through the host). Given ``gan_build_model``, the ranks then take
    ``ddp_gan``'s step, checked by :func:`_ddp_gan_check`: two processes
    fewer to start. The ranks then train RealESRNet under DDP
    (``ddp_realesrnet``, :func:`_ddp_realesr_check`). Returns the
    launches of the main path summed over the ranks, K6's record, and
    ``ddp_gan``'s launches (or None)."""
    cards = torch.cuda.device_count()
    backend = 'nccl' if cards >= DDP_WORLD else 'gloo'
    emit({'phase': 'ddp', 'backend': backend, 'world': DDP_WORLD,
          'cards': cards,
          'rank_devices': [f'cuda:{r % cards}' for r in range(DDP_WORLD)]})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        if gan_build_model is not None:
            open(os.path.join(root, 'with_gan'), 'w').close()
        _spawn_ranks(_ddp_rank, backend, root, 'ddp')
        _ddp_realesr_check(root, backend)
        reports = []
        for rank in range(DDP_WORLD):
            with open(os.path.join(root, f'rank{rank}.json')) as f:
                reports.append(json.load(f))
        gan_ranks = (None if gan_build_model is None
                     else _ddp_gan_records(root))
    seconds = time.perf_counter() - t0

    shard = [r['sharded_match'] for r in reports]
    emit({'phase': 'sharded_match', 'pairs': T, 'canvas': CANVAS,
          'backend': backend, 'ranks': shard})
    shard_bf16 = [r['sharded_match_bf16'] for r in reports]
    emit({'phase': 'sharded_match_bf16', 'pairs': T, 'canvas': CANVAS,
          'backend': backend, 'ranks': shard_bf16})
    train = [r['ddp_train'] for r in reports]
    profile = train[0].pop('profile')
    emit({'phase': 'ddp_train', 'backend': backend, 'world': DDP_WORLD,
          'network_g': _train_opt('dcn')['network_g'],
          'global_batch': DDP_WORLD * TRAIN_B,
          'mean_step_ms': max(r['mean_step_ms'] for r in train),
          'global_img_per_s': min(r['global_img_per_s'] for r in train),
          'ranks': train})
    emit(dict(profile, rank=0, backend=backend))
    val = [r['dist_val'] for r in reports]
    check(all(r['metric_results'] == val[0]['metric_results'] for r in val),
          f'the ranks end validation with other metric_results: {val}')
    emit({'phase': 'dist_val', 'backend': backend, 'requests': 4,
          'ranks': val})
    emit({'phase': 'ddp_resume', 'backend': backend,
          'ranks': [r['ddp_resume'] for r in reports]})
    launches = {name: sum(r['launches'][name] for r in reports)
                for name in reports[0]['launches']}
    check(all(launches[k] > 0 for k in (
        'feature_match_sharded', 'feature_match_sharded_bf16',
        'feature_match_prologue', 'feature_match_prologue_bf16')) and all(
        r['ddp_train']['launches_3_steps'][k] > 0 for r in reports
        for k in ('feature_match_prologue', 'feature_match', 'mdcn_fused_fwd',
                  'mdcn_fused_dgrad', 'mdcn_fused_wgrad',
                  'mdcn_fused_wgrad_sum')),
          f'kernels not launched on the ddp path: {launches}')
    scatter = [k for k in launches if '_scatter' in k and launches[k]]
    check(not scatter, f'grad-x scatter launched on the ddp path: {scatter}')
    emit({'phase': 'ddp_summary', 'backend': backend, 'seconds': seconds,
          'seconds_are': 'the ranks\' processes' + (
              '' if gan_ranks is None else ', ddp_gan\'s part included') +
              ', ddp_realesrnet\'s part included',
          'launches': launches})
    gan_launches = None if gan_ranks is None else _ddp_gan_check(
        gan_build_model, gan_ranks, backend, {'ranks_s_with_ddp': seconds})
    k6 = [{'name': name,
           'max_abs_err': max(r['max_abs_err'] for r in recs),
           **{key: max(r[key] for r in recs)
              for key in ('ms', 'kernel_only_ms', 'collective_ms',
                          'plain_ms', 'bound_ms', 'library_ms',
                          'bound_f32_cuda_cores_ms') if key in recs[0]},
           'bound_by': recs[0]['bound_by'], 'backend': backend,
           'ms_note': 'per rank, the ranks at once; kernel_only_ms is K1 '
                      'on the band with the rank alone on the card',
           'library_call': f'chunked torch.matmul of the band\'s {dtype} '
                           'scores and the same MAX and MIN all-reduces',
           'plain_call': 'feature_match_index_sharded_ref: the plain '
                         'prologue and match, the same all-reduces'}
          for name, recs, dtype in (
              ('feature_match_sharded', shard, 'f32'),
              ('feature_match_sharded_bf16', shard_bf16, 'bf16'))]
    return launches, k6, gan_launches


# how the profile sorts device kernels: the hand-written ones by name,
# cuDNN's and cuBLAS's (convolutions, their layout changes and FFTs, and
# matmuls) by these marks, the rest (element-wise, reductions, copies,
# Adam) as other
OWN_KERNELS = ('prologue_kernel', 'split_tf32_kernel',
               '::Tf32x3>', '::Bf16>',     # fm::match_kernel<...>
               'mdcn_wgmma::fwd_kernel', 'mdcn_wgmma::dgrad_kernel',
               'mdcn_wgmma::split_kernel', 'mdcn_fused::wgrad_kernel',
               'mdcn_fused::wgrad_sum_kernel', 'deform_sample_fwd_kernel',
               'deform_sample_bwd_kernel', 'upfirdn2d_tile_kernel',
               'upfirdn2d_gather_kernel', 'fused_leaky_relu_fwd_kernel',
               'fused_leaky_relu_bwd_kernel',
               'fused_leaky_relu_bwd_rows_kernel',
               'fused_leaky_relu_bias_sum_kernel')
LIBRARY_MARKS = ('xmma', 'cudnn', 'cutlass', 'gemm', 'gemv', 'DSE::',
                 'fft', 'region_transform', 'cublas', 'wgrad', 'dgrad')


def phase_profile(path, run, top=12):
    """``run()`` once more under torch.profiler: device time by kernel,
    and the share of its wall time the device was busy."""
    emit(profile_record(path, run, top))


def _is_k2(name):
    """Whether a profiled kernel is one of K2's (K3's, K5's): the wgmma
    walk's forward, dgrad and f32 weight split, wgrad and its sum."""
    return 'mdcn_wgmma::' in name or 'mdcn_fused::' in name


def _is_k2_scatter(name):
    """Whether a profiled kernel is K2's dgrad with the grad-x scatter
    (``mdcn_wgmma::dgrad_kernel<T, BN, kScatter, kMask>``, kScatter
    true)."""
    import re
    m = re.search(r'mdcn_wgmma::dgrad_kernel<([^>]*)>', name)
    args = [a.strip() for a in m.group(1).split(',')] if m else []
    return len(args) >= 3 and args[2] in ('true', '1')


def profile_record(path, run, top=12):
    """:func:`phase_profile`'s line, returned rather than printed. Only the
    device is traced (its kernels are all the line reads): tracing the
    host's operators too would add to ``wall_ms`` and so to the idle
    share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: a record_function range (DDP's forward) also
    # shows on the device as a user annotation spanning its kernels
    kernels = device_time_by_name(prof)
    busy = sum(ms for ms, _, _ in kernels)
    own = {name: sum(ms for ms, _, key in kernels if name in key)
           for name in OWN_KERNELS}
    library = sum(ms for ms, _, key in kernels
                  if any(mark in key for mark in LIBRARY_MARKS)
                  and not any(name in key for name in OWN_KERNELS))
    scatter = sum(ms for ms, _, key in kernels if _is_k2_scatter(key))
    k2 = sum(ms for ms, _, key in kernels if _is_k2(key))
    return {'phase': 'profile', 'path': path, 'wall_ms': wall_ms,
            'device_busy_ms': busy,
            'device_idle_share': 1 - busy / wall_ms if busy else None,
            'hand_written_ms': own, 'k2_dgrad_scatter_ms': scatter,
            'k2_other_ms': k2 - scatter, 'cudnn_cublas_ms': library,
            'other_ms': busy - library - sum(own.values()),
            'top_kernels': [{'ms': ms, 'calls': n, 'name': name[:90]}
                            for ms, n, name in kernels[:top]]}


# ------------------------------------------------------------------ the CLI
# the shipped YAMLs the CLI phase runs, as shipped but for the keys of
# _cli_args (dataroots, the extractor's missing checkpoint, the length)
CLI_TRAIN_YML = 'options/train/stage3_5ref_restoration_mse.yml'
CLI_LP_YML = 'options/train/stage3_5ref_restoration_mse_lp.yml'
CLI_TEST_YML = 'options/test/test_5ref_cufed5.yml'
CLI_ITERS, CLI_PRINT, CLI_SAVE = 60, 10, 30
CLI_PREEMPT_ITERS, CLI_PREEMPT_AT = 30, 10
CLI_LP_ITERS, CLI_LP_PRINT = 10, 5
# CUFED5-layout validation images, (h, w): CUFED5's are about 500x332
CLI_CUFED_SIZES = ((332, 500), (500, 332), (328, 496), (336, 500))
CLI_WAIT_S = 600                        # a CLI subprocess's time limit
_ITER_LINE = r'iter:\s*([\d,]+), lr:.*time \(data\): ([\d.]+) \(([\d.]+)\)'


class _LmrImages:
    """``scripts/make_synthetic_megadepth.py`` (4 scenes, 64 samples,
    JPEGs of 640-1200 px, the script's defaults) writing the LMR layout
    into a directory of its own, in a process started at construction:
    the whole script starts it beside the build, whose time it shares."""

    def __init__(self):
        repo = os.path.dirname(os.path.abspath(__file__))
        script = os.path.join(repo, 'scripts', 'make_synthetic_megadepth.py')
        self.root = tempfile.mkdtemp(prefix='lmr_')
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, script, '--root', self.root, '--scenes', '4',
             '--samples', '64'], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def wait(self):
        """The script's output directory, once it has exited 0; the
        seconds from its start."""
        try:
            out, _ = self.proc.communicate(timeout=CLI_WAIT_S)
        finally:
            self.stop()
        check(self.proc.returncode == 0, f'make_synthetic_megadepth.py '
              f'exited {self.proc.returncode}:\n{out[-3000:]}')
        return self.root, time.perf_counter() - self.t0

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def close(self):
        """Stop the process and remove its directory."""
        self.stop()
        shutil.rmtree(self.root, ignore_errors=True)


def _cli_data(root, lmr):
    """The CLI phase's images: the LMR layout that ``lmr``
    (:class:`_LmrImages`) writes, and under ``root`` 4 CUFED5-layout sets
    of 6 PNGs (``*_0.png`` input, ``*_1..5.png`` refs) of smooth seeded
    images near 500x332. Returns ``(lmr folder, annotation CSV, CUFED5
    folder)`` and the LMR script's seconds from its start."""
    from PIL import Image
    lmr_root, lmr_s = lmr.wait()
    cufed = os.path.join(root, 'CUFED5')
    os.makedirs(cufed)
    gen = torch.Generator().manual_seed(SEED + 20)
    for i, (h, w) in enumerate(CLI_CUFED_SIZES):
        for j in range(6):
            img = torch.nn.functional.interpolate(
                torch.rand((1, 3, h // 16 + 2, w // 16 + 2), generator=gen),
                size=(h, w), mode='bicubic', align_corners=False)
            img = (img.clamp(0, 1)[0].permute(1, 2, 0) * 255).round()
            Image.fromarray(img.to(torch.uint8).numpy()).save(
                os.path.join(cufed, f'{i:03d}_{j}.png'))
    return (os.path.join(lmr_root, 'MegaDepth_v3_5ref'),
            os.path.join(lmr_root, 'meta_info_synth_5ref.csv'), cufed), lmr_s


def _cli_args(yml, data, experiments, iters, print_freq, save_freq,
              val_freq, *extra):
    """``-opt yml --force_yml ...``: the dataroots of ``data``, no
    pretrained extractor, the run's length and frequencies, and the
    experiments under ``experiments``."""
    lmr, ann, cufed = data
    return ['-opt', yml, '--force_yml',
            f'datasets:train:dataroot_in={lmr}',
            f'datasets:train:dataroot_ref={lmr}',
            f'datasets:train:ann_file={ann}',
            f'datasets:val:dataroot_in={cufed}',
            f'datasets:val:dataroot_ref={cufed}',
            'path:pretrain_network_feature_extractor=~',
            f'train:total_iter={iters}', f'logger:print_freq={print_freq}',
            f'logger:save_checkpoint_freq={save_freq}',
            f'val:val_freq={val_freq}',
            f'path:experiments_root={experiments}', *extra]


class _LogLines(logging.Handler):
    """The CLI logger's records, with their host times."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append((record.created, record.getMessage()))

    def iterations(self):
        """``{iter: (time, logged time, logged data time)}`` of the
        iteration lines."""
        import re
        out = {}
        for created, msg in self.records:
            m = re.search(_ITER_LINE, msg)
            if m:
                out[int(m.group(1).replace(',', ''))] = (
                    created, float(m.group(2)), float(m.group(3)))
        return out


def _cli_train(train_pipeline, root, args, kernels, batch, first, last,
               model_cls=None):
    """``train_pipeline(root, args)`` in this process, the launches counted
    and the model's validation seen: returns the model, the launches of
    the training iterations (those before the first validation) and of the
    whole run, and the timings of iterations ``first + 1`` to ``last``
    from the host times of their log lines (a log line reads the loss, so
    it waits for the step); peak memory before the first validation (the
    training's) and over the run (an f32 500x500 validation's)."""
    if model_cls is None:
        from mrefsr_tpu_torch.models.multi_ref_restoration_model import \
            MultiRefRestorationModel as model_cls
    lines = _LogLines()
    logger = logging.getLogger('mrefsr_tpu_torch')
    logger.addHandler(lines)
    at_validation, peak_train = {}, []
    validation = model_cls.validation

    def counted_validation(model, *args, **kwargs):
        if not at_validation:
            at_validation.update({n: k.launches for n, k in kernels.items()})
            peak_train.append(torch.cuda.max_memory_allocated())
        return validation(model, *args, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    try:
        with mock.patch.object(model_cls, 'validation', counted_validation):
            model = train_pipeline(root, args=args)
    finally:
        logger.removeHandler(lines)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {n: k.launches for n, k in kernels.items()}
    its = lines.iterations()
    check(first in its and last in its,
          f'no log line of iteration {first} or {last}: {sorted(its)}')
    seconds = its[last][0] - its[first][0]
    logged = [its[i] for i in sorted(its)]
    return model, at_validation or launches, launches, {
        'iterations_timed': [first + 1, last],
        'img_per_s': (last - first) * batch / seconds,
        'mean_iter_ms': seconds / (last - first) * 1e3,
        'logged_iters': sorted(its),
        'logged_time_s': [t for _, t, _ in logged],
        'logged_data_time_s': [d for _, _, d in logged],
        'data_time_share_at_last': its[last][2] / its[last][1],
        'losses_logged': [msg.split('l_pix: ')[1].strip()
                          for _, msg in lines.records if 'l_pix: ' in msg],
        'peak_mem_train_bytes': peak_train[0] if peak_train else peak,
        'peak_mem_bytes': peak, 'wall_s': wall_s}


def _cli_popen(args, log_path):
    """``python -m <args>`` from the checkout, its output into
    ``log_path``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    out = open(log_path, 'w')
    try:
        return subprocess.Popen([sys.executable, '-m', *args], cwd=repo,
                                stdout=out, stderr=subprocess.STDOUT,
                                text=True), out
    except BaseException:
        out.close()
        raise


def _cli_wait(proc, out, log_path, until=None, then=None):
    """Wait for ``proc`` (at most ``CLI_WAIT_S``), calling ``then()`` once
    when its log first matches the regex ``until``; returns its exit code
    and log. The process is killed if it outlives the wait."""
    import re
    t0 = time.perf_counter()
    try:
        while proc.poll() is None:
            check(time.perf_counter() - t0 < CLI_WAIT_S,
                  f'{proc.args} outlived {CLI_WAIT_S} s')
            if until is not None:
                with open(log_path) as f:
                    if re.search(until, f.read()):
                        then()
                        until = None
            time.sleep(0.2)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
    with open(log_path) as f:
        return proc.returncode, f.read()


def _cli_preemption(data, tmp):
    """The training CLI in a process of its own, stopped by SIGTERM once its
    log shows iteration ``CLI_PREEMPT_AT``, then resumed with
    ``--auto_resume`` to its end at ``CLI_PREEMPT_ITERS``."""
    import re
    import signal
    experiments = os.path.join(tmp, 'preempt')
    args = ['mrefsr_tpu_torch.train', *_cli_args(
        CLI_TRAIN_YML, data, experiments, CLI_PREEMPT_ITERS, CLI_PRINT,
        1000, 1000, 'logger:use_tb_logger=false')]
    log_path = os.path.join(tmp, 'preempt.log')
    proc, out = _cli_popen(args, log_path)
    t0 = time.perf_counter()
    rc, log = _cli_wait(proc, out, log_path,
                        until=rf'iter:\s*{CLI_PREEMPT_AT}, lr',
                        then=lambda: proc.send_signal(signal.SIGTERM))
    first_s = time.perf_counter() - t0
    check(rc == 0, f'the preempted run exited {rc}:\n{log[-3000:]}')
    m = re.search(r'saving state at iter (\d+) and stopping', log)
    check(m is not None, f'no preemption save in the log:\n{log[-3000:]}')
    stopped = int(m.group(1))
    states = os.path.join(experiments, 'stage3_5ref_mrapa_restoration_mse_'
                          'ps160_bs48', 'training_states')
    check(os.path.isfile(os.path.join(states, f'{stopped}.state')),
          f'no {stopped}.state after the preemption: '
          f'{os.listdir(states) if os.path.isdir(states) else None}')
    check(CLI_PREEMPT_AT <= stopped < CLI_PREEMPT_ITERS,
          f'stopped at iteration {stopped}')

    log_path = os.path.join(tmp, 'resume.log')
    proc, out = _cli_popen(args + ['--auto_resume'], log_path)
    t0 = time.perf_counter()
    rc, log = _cli_wait(proc, out, log_path)
    resume_s = time.perf_counter() - t0
    check(rc == 0, f'the resumed run exited {rc}:\n{log[-3000:]}')
    m = re.search(r'Resuming training from epoch: (\d+), iter: (\d+)\.', log)
    check(m is not None and int(m.group(2)) == stopped,
          f'the run did not resume at iteration {stopped}:\n{log[-3000:]}')
    iters = [int(v.replace(',', '')) for v in re.findall(
        r'iter:\s*([\d,]+), lr', log)]
    check(iters and iters[0] > stopped and iters[-1] == CLI_PREEMPT_ITERS
          and 'End of training' in log,
          f'the resumed run logged {iters} and did not end at '
          f'{CLI_PREEMPT_ITERS}:\n{log[-3000:]}')
    return {'sigterm_after_iter': CLI_PREEMPT_AT, 'stopped_at': stopped,
            'resumed_epoch': int(m.group(1)), 'resumed_logged': iters,
            'preempted_run_s': first_s, 'resumed_run_s': resume_s}


def _cli_test(data, tmp, latest):
    """``python -m mrefsr_tpu_torch.test`` on the CUFED5-layout set with
    ``latest``, against a model of this process built from the same
    options and file and run on the same loader: the saved outputs must be
    the in-process ones bit for bit, so every image's PSNR is equal."""
    import re
    import cv2
    from mrefsr_tpu_torch.data import build_dataloader, build_dataset
    from mrefsr_tpu_torch.metrics import calculate_psnr
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.utils import tensor2img
    from mrefsr_tpu_torch.utils.options import parse_options
    _, _, cufed = data
    results = os.path.join(tmp, 'results')
    args = ['-opt', CLI_TEST_YML, '--force_yml',
            f'datasets:test_1:dataroot_in={cufed}',
            f'datasets:test_1:dataroot_ref={cufed}',
            f'path:pretrain_network_g={latest}',
            'path:pretrain_network_feature_extractor=~',
            f'path:results_root={results}']
    log_path = os.path.join(tmp, 'test.log')
    proc, out = _cli_popen(['mrefsr_tpu_torch.test', *args], log_path)
    t0 = time.perf_counter()
    rc, log = _cli_wait(proc, out, log_path)
    test_s = time.perf_counter() - t0
    check(rc == 0, f'test.py exited {rc}:\n{log[-3000:]}')
    logged = re.search(r'# PSNR: (\S+) # PSNR_Y: (\S+) # SSIM_Y: (\S+)\.',
                       log)
    check(logged is not None, f'no PSNR in the test log:\n{log[-3000:]}')

    opt, _ = parse_options(tmp, is_train=False, args=args)
    model = build_model(opt)
    dataset_opt = opt['datasets']['test_1']
    loader = build_dataloader(build_dataset(dataset_opt), dataset_opt)
    saved = os.path.join(results, opt['name'], 'visualization',
                         dataset_opt['name'])
    psnr_cli, psnr_here, request_ms = [], [], []
    for i, val_data in enumerate(loader):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.feed_data(val_data)
        model.test()
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        visuals = model.get_current_visuals()
        height, width = np.asarray(val_data['original_size'])[0]
        sr = tensor2img(visuals['rlt'])[:height, :width]
        gt = tensor2img(visuals['gt'])
        name = os.path.splitext(os.path.basename(val_data['lq_path'][0]))[0]
        cli = cv2.imread(os.path.join(saved, f"{name}_{opt['name']}.png"))
        check(cli is not None and cli.shape == sr.shape
              and np.array_equal(cli, sr),
              f'test.py wrote another output for {name} than this process '
              f'computed')
        psnr_cli.append(calculate_psnr(cli, gt, crop_border=4))
        psnr_here.append(calculate_psnr(sr, gt, crop_border=4))
    check(psnr_cli == psnr_here and all(np.isfinite(psnr_here)),
          f'PSNR {psnr_cli} against {psnr_here}')
    model.validation(loader, opt['name'], None, save_img=False)
    mean = f"{model.metric_results['psnr']:.4e}"
    check(mean == logged.group(1),
          f'test.py logged PSNR {logged.group(1)}, this process {mean}')
    del model
    torch.cuda.empty_cache()
    return {'images': len(psnr_here), 'psnr_per_image': psnr_here,
            'psnr_logged': logged.group(1), 'psnr_y_logged': logged.group(2),
            'ssim_y_logged': logged.group(3), 'outputs_bit_equal': True,
            'request_ms': request_ms[1:],
            'mean_request_ms': statistics.mean(request_ms[1:]),
            'first_request_ms': request_ms[0], 'test_cli_s': test_s}


def _cli_prefetch_check(data, tmp, device):
    """The first batch of the shipped training loader through the
    ``device`` prefetcher: each of the model's input keys on ``device`` as
    float32, bit for bit the host formula ``astype(float32) / 255``; the
    other keys left on the host as uint8. Also counts the elements that
    ``x.float() / 255`` on the card would have put elsewhere. Then the
    loader and the prefetcher alone, as the training run builds them (a
    fresh dataset, its decode cache cold, the YAML's sampler): their img/s
    over batches 11-60, with no step to feed."""
    from mrefsr_tpu_torch.data import (BackgroundDevicePrefetcher,
                                       EnlargedSampler, build_dataloader,
                                       build_dataset)
    from mrefsr_tpu_torch.models.multi_ref_restoration_model import \
        MultiRefRestorationModel
    from mrefsr_tpu_torch.utils.options import parse_options
    opt, _ = parse_options(tmp, args=_cli_args(
        CLI_TRAIN_YML, data, os.path.join(tmp, 'unused'), 1, 1, 1, 1))
    dataset_opt = opt['datasets']['train']
    loader = build_dataloader(build_dataset(dataset_opt, seed=SEED),
                              dataset_opt, seed=SEED)
    batches = iter(loader)
    host = next(batches)
    batches.close()
    keys = MultiRefRestorationModel.device_input_keys
    prefetcher = BackgroundDevicePrefetcher([host], device, opt,
                                            device_keys=keys)
    try:
        got = prefetcher.next()
        torch.cuda.synchronize()
    finally:
        prefetcher.close()
    naive = {}
    for key, value in host.items():
        if key not in keys:
            check(isinstance(got[key], np.ndarray)
                  and got[key].dtype == np.uint8,
                  f'{key} left the host or its type')
            continue
        check(value.dtype == np.uint8, f'the loader shipped {key} as '
              f'{value.dtype}, not uint8')
        t = got[key]
        check(isinstance(t, torch.Tensor) and t.device == device
              and t.dtype == torch.float32,
              f'{key} is not float32 on {device}')
        want = torch.from_numpy(value.astype(np.float32) / 255.)
        check(torch.equal(t.cpu(), want),
              f'{key}: the prefetched batch is not the host formula')
        naive[key] = int((torch.from_numpy(value).to(device).float() / 255
                          ).cpu().ne(want).sum())

    dataset = build_dataset(dataset_opt, seed=SEED)
    sampler = EnlargedSampler(dataset, 1, 0,
                              dataset_opt['dataset_enlarge_ratio'])
    prefetcher = BackgroundDevicePrefetcher(
        build_dataloader(dataset, dataset_opt, sampler=sampler, seed=SEED),
        device, opt, device_keys=keys)
    stamps = []
    try:
        for _ in range(CLI_ITERS):
            check(prefetcher.next() is not None, 'the loader ran dry')
            torch.cuda.current_stream(device).synchronize()
            stamps.append(time.perf_counter())
    finally:
        prefetcher.close()
    emit({'phase': 'cli_prefetch', 'keys': list(keys),
          'shapes': {k: list(host[k].shape) for k in keys},
          'bit_equal_to_host_formula': True,
          'elements_float_div_255_on_card_would_change': naive,
          'loader_alone_batches_timed': [CLI_PRINT + 1, CLI_ITERS],
          'loader_alone_img_per_s': (CLI_ITERS - CLI_PRINT)
          * dataset_opt['batch_size_per_gpu']
          / (stamps[-1] - stamps[CLI_PRINT - 1]),
          'loader_alone_first_batches_s': stamps[CLI_PRINT - 1] - stamps[0]})


# the GAN YAML's CLI run: 24 iterations, the pixel -> GAN boundary at 8, a
# checkpoint at 16, then --auto_resume from it; and the serving YAML
CLI_GAN_YML = 'options/ab/ab_dcn_gan.yml'
CLI_GAN_ITERS, CLI_GAN_PRETRAIN, CLI_GAN_SAVE, CLI_GAN_PRINT = 24, 8, 16, 4
CLI_SERVING_YML = 'options/test/test_5ref_cufed5_serving.yml'


def _same_state(a, b):
    """Whether two state dicts (nested dicts and lists of tensors and
    plain values) are equal, tensors bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a, key=str) == sorted(
            b, key=str) and all(_same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same_state(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and torch.equal(a.cpu(), b.cpu())
    return a == b


def _cli_gan(train_pipeline, data, tmp, kernels):
    """``train_pipeline`` on ``options/ab/ab_dcn_gan.yml`` as shipped (bf16
    pixel steps, B 8, gt 160, ``ImageDiscriminator`` ndf 32) but for the
    dataroots and the validation canvas, 24 iterations with the boundary
    at 8 and a checkpoint at 16: bf16 entry points only before the
    boundary and f32 ones only after it, the GAN keys logged, ``net_d``
    saved; then ``--auto_resume``: the
    model resumed from iteration 16 holds ``net_d`` and both optimizers as
    saved, bit for bit, and trains on to 24. Returns the launches of the
    pixel and the GAN iterations, and the record."""
    from mrefsr_tpu_torch.models.multi_ref_restoration_model import \
        MultiRefRestorationModel as Model
    experiments = os.path.join(tmp, 'gan')
    # the YAML's validation canvas (160) suits the synthetic script's own
    # CUFED sets; the phase's are near 500x332, so their canvas is 500
    args = _cli_args(CLI_GAN_YML, data, experiments, CLI_GAN_ITERS,
                     CLI_GAN_PRINT, CLI_GAN_SAVE, 1000,
                     f'train:net_g_pretrain_steps={CLI_GAN_PRETRAIN}',
                     'datasets:val:pad_to=500')
    at_boundary = {}
    optimize_gan = Model._optimize_gan

    def counted_gan(model, step):
        if not at_boundary:
            at_boundary.update({n: k.launches for n, k in kernels.items()})
        return optimize_gan(model, step)

    with mock.patch.object(Model, '_optimize_gan', counted_gan):
        model, train_launches, _, rec = _cli_train(
            train_pipeline, tmp, args, kernels, GAN_B, CLI_GAN_PRETRAIN + 4,
            CLI_GAN_ITERS)
    pixel = dict(at_boundary)
    gan = {n: train_launches[n] - at_boundary[n] for n in train_launches}
    check(all(pixel[n] > 0 for n in _entries(('match', 'k2', 'k2_bwd'),
                                              BF16))
          and not any(pixel[n] for n in _forbidden(BF16)),
          f'the pixel iterations launched {pixel}')
    check(all(gan[n] > 0 for n in _entries(('match', 'k2', 'k2_bwd'),
                                            torch.float32))
          and not any(gan[n] for n in SCATTERS + BF16_ENTRIES),
          f'the GAN iterations launched {gan}')
    log = model.get_current_log()
    check({'l_d_real', 'l_d_fake', 'l_grad_penalty', 'l_g_gan'} <= set(log)
          and all(np.isfinite(v) for v in log.values()),
          f'the GAN run logged {log}')
    exp = os.path.join(experiments, model.opt['name'])
    models = sorted(os.listdir(os.path.join(exp, 'models')))
    check({f'net_d_{CLI_GAN_SAVE}.pth', 'net_d_latest.pth'} <= set(models),
          f'the GAN run saved {models}')
    del model
    torch.cuda.empty_cache()

    resumed = {}
    resume_training = Model.resume_training

    def recorded_resume(model, state):
        resume_training(model, state)
        resumed['iter'] = state['iter']
        resumed['optimizers'] = copy.deepcopy(
            [o.state_dict() for o in model.optimizers])
        resumed['net_d'] = {k: v.clone()
                            for k, v in model.net_d.state_dict().items()}

    with mock.patch.object(Model, 'resume_training', recorded_resume):
        model, _, _, rec_resumed = _cli_train(
            train_pipeline, tmp, args + ['--auto_resume'], kernels, GAN_B,
            CLI_GAN_SAVE + CLI_GAN_PRINT, CLI_GAN_ITERS)
    state = torch.load(os.path.join(exp, 'training_states',
                                    f'{CLI_GAN_SAVE}.state'),
                       map_location='cpu', weights_only=True)
    saved_d = torch.load(os.path.join(exp, 'models',
                                      f'net_d_{CLI_GAN_SAVE}.pth'),
                         map_location='cpu', weights_only=True)['params']
    check(resumed.get('iter') == CLI_GAN_SAVE,
          f'--auto_resume resumed from {resumed.get("iter")}')
    check(len(state['optimizers']) == len(state['schedulers']) == 2,
          'the .state holds G\'s and D\'s optimizers and schedulers')
    check(_same_state(resumed['optimizers'], state['optimizers']),
          'the resumed optimizers differ from the saved ones')
    check(_same_state(resumed['net_d'], saved_d),
          'the resumed net_d differs from the saved one')
    check(set(log) <= set(model.get_current_log()),
          f'the resumed run logged {model.get_current_log()}')
    del model
    torch.cuda.empty_cache()
    return pixel, gan, {
        **rec, 'yml': CLI_GAN_YML, 'batch': GAN_B, 'gt': TRAIN_GT,
        'iterations': CLI_GAN_ITERS, 'net_g_pretrain_steps': CLI_GAN_PRETRAIN,
        'checkpoint': CLI_GAN_SAVE, 'saved_models': models, 'last_log': log,
        'resumed_from': resumed['iter'], 'resumed_bit_equal': True,
        'resumed_run_wall_s': rec_resumed['wall_s'],
        'launches_pixel_iterations': {n: v for n, v in pixel.items() if v},
        'launches_gan_iterations': {n: v for n, v in gan.items() if v}}


def _cli_serving(data, tmp, latest, kernels):
    """``options/test/test_5ref_cufed5_serving.yml`` (per-dimension
    ``pad_to`` buckets, bf16) through ``test_pipeline`` in this process on
    the CUFED5-layout sets with ``latest``: bf16 entry points only, finite
    metrics, two buckets or more; then a bf16 request at the 500x332
    bucket against one on the 500x500 canvas (a ``pad_to`` of 500), each
    the second of two, and K1's device ms (prologue and match) in a
    profile of each. Returns the pipeline's launches and the record."""
    from mrefsr_tpu_torch.data import build_dataset, default_collate
    from mrefsr_tpu_torch.test import test_pipeline
    _, _, cufed = data
    args = ['-opt', CLI_SERVING_YML, '--force_yml',
            f'datasets:test_1:dataroot_in={cufed}',
            f'datasets:test_1:dataroot_ref={cufed}',
            f'path:pretrain_network_g={latest}',
            'path:pretrain_network_feature_extractor=~',
            f'path:results_root={os.path.join(tmp, "serving")}']
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    model = test_pipeline(tmp, args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts(kernels, _entries(('match', 'k2'), BF16),
                           _forbidden(BF16))
    check(model.eval_dtype == BF16, 'the serving YAML evaluates at bf16')
    check(all(np.isfinite(v) for v in model.metric_results.values()),
          f'serving metrics {model.metric_results}')
    dataset_opt = dict(model.opt['datasets']['test_1'])
    dataset = build_dataset(dataset_opt)
    canvases = [tuple(dataset[i]['img_in_up'].shape[:2])
                for i in range(len(dataset))]
    check(len(set(canvases)) >= 2, f'one bucket only: {canvases}')
    rec = {'cli_s': cli_s, 'metric_results': model.metric_results,
           'canvases': canvases,
           'launches': {n: v for n, v in launches.items() if v}}
    # CLI_CUFED_SIZES[1] is 500x332: its bucket, and the single canvas
    for name, pad_to in (('500x332', dataset_opt['pad_to']),
                         ('500x500', 500)):
        batch = default_collate([build_dataset(dict(
            dataset_opt, pad_to=pad_to))[1]])
        request_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model.feed_data(batch)
            model.test()
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t1) * 1e3)

        def one_request():
            model.feed_data(batch)
            model.test()

        prof = profile_record(f'serving_{name}', one_request)
        own = prof['hand_written_ms']
        rec[name] = {'canvas': list(batch['img_in_up'].shape[1:3]),
                     'request_ms': request_ms,
                     'second_request_ms': request_ms[1],
                     'k1_device_ms': own['prologue_kernel'] + own['::Bf16>'],
                     'device_busy_ms': prof['device_busy_ms'],
                     'device_idle_share': prof['device_idle_share']}
    small, full = rec['500x332'], rec['500x500']
    check(small['canvas'] == [500, 332] and full['canvas'] == [500, 500],
          f'canvases {small["canvas"]}, {full["canvas"]}')
    rec['area_ratio'] = 500 * 500 / (500 * 332)
    rec['request_ratio'] = full['second_request_ms'] \
        / small['second_request_ms']
    rec['k1_ratio'] = full['k1_device_ms'] / small['k1_device_ms']
    del model
    torch.cuda.empty_cache()
    return launches, rec


# the training CLI's profiler window (logger.profile_start_iter and
# profile_num_steps) in the cli run: iterations 3 and 4, before the timed
# ones (CLI_PRINT + 1 on)
CLI_PROFILE_WINDOW = (3, 2)


def _cli_profile_window(model):
    """The Chrome trace the ``cli`` run's profiler window wrote under
    ``<experiments_root>/tb_logger``, read back: its kernel events must
    name K1's and K2's kernels."""
    first, steps = CLI_PROFILE_WINDOW
    path = os.path.join(model.opt['path']['experiments_root'], 'tb_logger',
                        f'trace_iter{first}-{first + steps - 1}.json')
    check(os.path.isfile(path), f'the profiler window wrote no {path}')
    with open(path) as f:
        events = json.load(f)['traceEvents']
    kernels = [e['name'] for e in events if e.get('cat') == 'kernel']
    out = {'trace': os.path.basename(path),
           'trace_bytes': os.path.getsize(path),
           'kernel_events': len(kernels),
           'k1_match_events': sum('match_kernel' in n for n in kernels),
           'k1_prologue_events': sum('prologue_kernel' in n
                                     for n in kernels),
           'k2_events': sum(_is_k2(n) for n in kernels)}
    check(out['k1_match_events'] > 0 and out['k1_prologue_events'] > 0
          and out['k2_events'] > 0,
          f'the profiler window\'s trace names no K1 or K2 kernel: {out}')
    return out


def phase_cli(kernels, repeated_step_ms=None, lmr=None):
    """The shipped stage-3 bf16 YAML through the port's CLIs with the loader
    in the loop, on synthetic images: the device prefetcher's first batch;
    ``CLI_ITERS`` iterations of ``train_pipeline`` in this process
    (img/s over iterations 11-60 by the log lines' host times, the
    logger's time and data time, peak memory, K1 and K2 launched at bf16
    only in training and at f32 only in validation, a finite validation
    PSNR); the model's step on one repeated batch, beside
    ``repeated_step_ms`` (phase ``train_dcn_bf16``'s) where given;
    ``test.py`` against this process; SIGTERM and ``--auto_resume``; ten
    steps of the ``_lp`` YAML (gt 300, B 3). Returns the launches of the
    two in-process runs by path. ``lmr``: the :class:`_LmrImages` started
    beside the build (else started here); its directory is removed."""
    from mrefsr_tpu_torch.train import train_pipeline
    device = torch.device('cuda', torch.cuda.current_device())
    by_path = {}
    lmr = _LmrImages() if lmr is None else lmr
    with tempfile.TemporaryDirectory() as tmp, contextlib.closing(lmr):
        t0 = time.perf_counter()
        data, lmr_s = _cli_data(tmp, lmr)
        emit({'phase': 'cli_data', 'seconds': time.perf_counter() - t0,
              'lmr_script_s': lmr_s,
              'lmr_images': sum(len(files) for _, _, files
                                in os.walk(data[0])),
              'cufed_sets': len(CLI_CUFED_SIZES)})
        _cli_prefetch_check(data, tmp, device)

        experiments = os.path.join(tmp, 'experiments')
        first, steps = CLI_PROFILE_WINDOW
        model, train_launches, launches, rec = _cli_train(
            train_pipeline, tmp, _cli_args(
                CLI_TRAIN_YML, data, experiments, CLI_ITERS, CLI_PRINT,
                CLI_SAVE, CLI_ITERS, f'logger:profile_start_iter={first}',
                f'logger:profile_num_steps={steps}'), kernels, TRAIN_B,
            CLI_PRINT, CLI_ITERS)
        check(first + steps - 1 <= CLI_PRINT,
              'the profiled iterations must lie outside the timed ones')
        rec['profile_window'] = _cli_profile_window(model)
        by_path['cli'] = launches
        expect = _entries(('match', 'k2', 'k2_bwd'), BF16)
        val_launches = {n: launches[n] - train_launches[n] for n in launches}
        check(all(train_launches[n] > 0 for n in expect),
              f'the CLI run did not launch {expect}: {train_launches}')
        check(not any(train_launches[n] for n in _forbidden(BF16)),
              f'the bf16 CLI steps launched an f32 entry point or a '
              f'scatter: {train_launches}')
        val_expect = _entries(('match', 'k2'), torch.float32)
        check(all(val_launches[n] > 0 for n in val_expect)
              and not any(val_launches[n] for n in SCATTERS),
              f'validation launched {val_launches}')
        psnr = model.metric_results['psnr']
        check(np.isfinite(psnr), f'validation PSNR {psnr}')
        check(all(np.isfinite(float(v)) for v in rec['losses_logged']),
              f'non-finite losses {rec["losses_logged"]}')
        check(model.train_dtype == BF16 and model.eval_dtype == torch.float32,
              'the shipped YAML trains at bf16 and validates at f32')

        # the same model's step on one repeated batch (chip_smoke's
        # train_dcn_bf16 measure), for the loader's cost
        batch = _train_batch(np.random.RandomState(SEED + 21), TRAIN_B)
        step_ms = []
        for it in range(CLI_ITERS + 1, CLI_ITERS + 7):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model.feed_data(batch)
            model.optimize_parameters(it)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        repeated = statistics.mean(step_ms[1:])
        latest = os.path.join(experiments, model.opt['name'], 'models',
                              'net_g_latest.pth')
        check(os.path.isfile(latest), f'no {latest}')
        del model
        torch.cuda.empty_cache()
        emit({'phase': 'cli', 'yml': CLI_TRAIN_YML, 'batch': TRAIN_B,
              'gt': TRAIN_GT, 'iterations': CLI_ITERS, **rec,
              'validation_psnr': psnr,
              'repeated_batch_step_ms': step_ms[1:],
              'repeated_batch_img_per_s': TRAIN_B / repeated * 1e3,
              'train_dcn_bf16_mean_step_ms': repeated_step_ms,
              'train_dcn_bf16_img_per_s': None if repeated_step_ms is None
              else TRAIN_B / repeated_step_ms * 1e3,
              'launches_train': {n: v for n, v in train_launches.items()
                                 if v},
              'launches_validation': {n: v for n, v in val_launches.items()
                                      if v}})

        emit({'phase': 'cli_test', **_cli_test(data, tmp, latest)})
        by_path['cli_serving'], serving = _cli_serving(data, tmp, latest,
                                                       kernels)
        emit({'phase': 'cli_serving', 'yml': CLI_SERVING_YML, **serving})
        emit({'phase': 'cli_preemption', **_cli_preemption(data, tmp)})

        model, lp_launches, by_path['cli_lp'], lp = _cli_train(
            train_pipeline, tmp, _cli_args(
                CLI_LP_YML, data, os.path.join(tmp, 'lp'), CLI_LP_ITERS,
                CLI_LP_PRINT, 1000, 1000, 'path:pretrain_network_g=~',
                'path:resume_state=~'), kernels, 3, CLI_LP_PRINT,
            CLI_LP_ITERS)
        check(all(lp_launches[n] > 0 for n in expect)
              and not any(lp_launches[n] for n in _forbidden(BF16)),
              f'the _lp CLI steps launched {lp_launches}')
        check(model.opt['datasets']['train']['gt_size'] == 300
              and model.opt['datasets']['train']['batch_size_per_gpu'] == 3,
              'the _lp YAML is gt 300, B 3')
        check(np.isfinite(model.metric_results['psnr']),
              f"_lp validation PSNR {model.metric_results['psnr']}")
        del model
        torch.cuda.empty_cache()
        emit({'phase': 'cli_lp', 'yml': CLI_LP_YML, 'batch': 3, 'gt': 300,
              'iterations': CLI_LP_ITERS, **lp,
              'launches_train': {n: v for n, v in lp_launches.items() if v}})
        by_path['cli_gan_pixel'], by_path['cli_gan'], gan = _cli_gan(
            train_pipeline, data, tmp, kernels)
        emit({'phase': 'cli_gan', **gan})
        # the runs' log files lie in the directory about to go
        logger = logging.getLogger('mrefsr_tpu_torch')
        for handler in [h for h in logger.handlers
                        if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(handler)
            handler.close()
    return by_path


# the TPU kernels the bf16 records replace: K1, K2, K4
K1_TPU = 'mrefsr_tpu/ops/correlation.py:45'
K6_TPU = 'mrefsr_tpu/ops/correlation.py:140'
K2_TPU = 'mrefsr_tpu/ops/dcn.py:111'
K4_TPU = 'mrefsr_tpu/ops/dcn.py:296'


def bf16_phases(correlation, dcn, arch, build_model, kernels):
    """The shipped precision of the main path: K1, K2 (forward and
    backward) and K4 at bf16 against their plain versions, the bf16
    CUFED5 request and the bf16 stage-3 step of both alignments. Returns
    the kernels' ``(record, source, replaces)``, the paths' launch counts
    and the mean step ms of each alignment."""
    k1, k1p = phase_feature_match(correlation, dtype=BF16)
    k1['train_shape'], k1p['train_shape'] = phase_feature_match(
        correlation, pairs=TRAIN_B * T, h=TRAIN_GT // 4, ties=False,
        dtype=BF16)
    torch.cuda.empty_cache()
    k2 = phase_mdcn(dcn, dtype=BF16)
    k2['train_shape'] = phase_mdcn(dcn, n=TRAIN_B * T, shapes=TRAIN_SHAPES,
                                   dtype=BF16)
    k2b = phase_mdcn_backward(dcn, BF16)
    k4f, k4b = phase_deform_sample(dcn, BF16)
    torch.cuda.empty_cache()
    described = [(k1p, 'feature_match_prologue.cu', K1_PROLOGUE_TPU),
                 (k1, 'feature_match_bf16.cu', K1_TPU),
                 *((rec, 'mdcn_bf16.cu', K2_TPU) for rec in [k2, *k2b]),
                 (k4f, 'deform_sample.cu', K4_TPU),
                 (k4b, 'deform_sample.cu', K4_TPU)]
    by_path = {}
    by_path['slice_bf16'], model, batch = phase_slice(
        build_model, arch.DynAgg, correlation, dcn, kernels, BF16)

    def one_request():
        model.feed_data(batch)
        model.test()

    phase_profile('slice_bf16', one_request)
    del model
    torch.cuda.empty_cache()
    step_ms = {}
    for alignment in ('dcn', 'flow'):
        by_path[f'train_{alignment}_bf16'], step_ms[alignment] = phase_train(
            alignment, build_model, arch, dcn, kernels, BF16)
        torch.cuda.empty_cache()
    emit({'phase': 'train_ratio_bf16',
          'flow_steps_per_dcn_step': step_ms['dcn'] / step_ms['flow']})
    return described, by_path, step_ms


def dcn_phases(arch_util, mrapa_arch, dcn, kernels):
    """K3 and K5 on the fused kernels at f32 and at bf16, then the bf16
    module path of K3 (``dcn_modules``). Returns the kernels' ``(record,
    source, replaces)`` and ``{'dcn_modules': launch counts}``."""
    described = []
    for dtype, source in ((torch.float32, 'mdcn_fused.cu'),
                          (BF16, 'mdcn_bf16.cu')):
        for phase, replaces in ((phase_mdcn_groups, K3_TPU),
                                (phase_dcn_v1, K5_TPU)):
            described += [(rec, source, replaces)
                          for rec in phase(dcn, kernels, dtype)]
            torch.cuda.empty_cache()
    return described, {'dcn_modules': phase_dcn_modules(
        arch_util, mrapa_arch, dcn, kernels)}


# ---------------------------------------------------------- the GAN phase
# options/ab/ab_dcn_gan.yml's batch and crop; the alternation cut so that
# GAN_STEPS steps hold 2 bf16 pixel steps, then GAN steps with G updating
# every second one (a skipped G turn each time between)
GAN_B, GAN_PRETRAIN, GAN_STEPS = 8, 2, 8
BF16_ENTRIES = sum(ENTRIES[BF16].values(), ())
# SRNTT-form terms for the perceptual + style case: the Frobenius distance
# of relu5_1 features and of relu1_1-relu3_1 Gram matrices, on [0, 1]
# images, VGG19 from seeded weights (no pretrained file is in the repo)
GAN_PERCEPTUAL = {'layer_weights': {'relu5_1': 1.0}, 'vgg_type': 'vgg19',
                  'perceptual_weight': 1e-4, 'style_weight': 0.,
                  'norm_img': False, 'criterion': 'fro'}
GAN_STYLE = {'layer_weights': {'relu1_1': 1.0, 'relu2_1': 1.0,
                               'relu3_1': 1.0},
             'vgg_type': 'vgg19', 'perceptual_weight': 0.,
             'style_weight': 1e-3, 'norm_img': False, 'criterion': 'fro'}


def _gan_opt(alignment, percep=False):
    """The nets and train block of options/ab/ab_dcn_gan.yml (``dcn``) and
    ab_flow_gan.yml (``flow``): MRAPA at ngf 64, 16 blocks, 8 deform
    groups, ``ImageDiscriminator`` at ndf 32, wgan with ``gan_weight``
    1e-5 and the penalty at 10, bf16 pixel steps; the alternation cut to
    ``net_g_pretrain_steps`` 2, ``net_d_steps`` 2, ``net_d_init_steps`` 1;
    with ``percep`` also :data:`GAN_PERCEPTUAL` and :data:`GAN_STYLE`."""
    opt = _train_opt(alignment)
    opt['network_g'].pop('ref_unroll', None)
    if alignment == 'dcn':
        opt['network_g']['dcn_outer_remat'] = True
    opt['network_d'] = {'type': 'ImageDiscriminator', 'in_nc': 3, 'ndf': 32}
    opt['train'].update(
        lr_d=1e-4, weight_decay_d=0, beta_d=[0.9, 0.999], gan_type='wgan',
        gan_weight=1e-5, grad_penalty_weight=10.0, total_iter=3008,
        net_g_pretrain_steps=GAN_PRETRAIN, net_d_steps=2, net_d_init_steps=1,
        mixed_precision='bfloat16')
    if percep:
        opt['train'].update(perceptual_opt=dict(GAN_PERCEPTUAL),
                            style_opt=dict(GAN_STYLE))
    return opt


def _pre_norm_bias(name):
    """A discriminator conv bias feeding a train-mode norm: its gradient
    is exactly 0 (the norm takes any shift out), so each computation's is
    rounding noise."""
    parts = name.split('.')
    return parts[0].startswith('conv_block') and parts[1] in ('0', '3') \
        and parts[2] == 'bias'


def _gan_backward(model, arch, dcn, alpha, plain_ops=False,
                  plain_forward=False):
    """The discriminator's gradients of its step's loss (penalty at
    ``alpha``) and the generator's of its step's loss, at the model's
    current weights, on the batch of ``feed_data``, the norms writing
    nothing; through the kernels, through their Functions with the plain
    forward values, or through the plain versions (as
    :func:`_compare_grads`). Returns the output and both gradients."""
    from mrefsr_tpu_torch.parallel.batch_norm import frozen_stats
    net_d = model.net_d
    with contextlib.ExitStack() as stack:
        if plain_ops:
            stack.enter_context(mock.patch.object(
                arch, 'modulated_deform_conv2d',
                dcn.modulated_deform_conv2d_ref))
            stack.enter_context(mock.patch.object(
                arch, 'deform_sample', dcn.deform_sample_ref))
        if plain_forward:
            stack.enter_context(mock.patch.object(
                dcn, '_mdcn_fused_forward_cuda', dcn._mdcn_fused_forward_ref))
            stack.enter_context(mock.patch.object(
                dcn, '_deform_sample_fwd_cuda', dcn.deform_sample_ref))
        stack.enter_context(frozen_stats(net_d))
        model.net_g.zero_grad(set_to_none=True)
        net_d.zero_grad(set_to_none=True)
        output = model._forward(model.match_img_in, model.img_ref_list,
                                model.img_in_lq, dtype=torch.float32)
        net_d.requires_grad_(True)
        losses = model.d_losses(output.detach(), alpha)
        sum(v for k, v in losses.items() if k.startswith('l_')).backward()
        d_grads = {n: p.grad.clone() for n, p in net_d.named_parameters()}
        net_d.requires_grad_(False)
        sum(model.g_losses(output).values()).backward()
        g_grads = {n: p.grad.clone() for n, p in
                   model.net_g.named_parameters()}
    model.net_g.zero_grad(set_to_none=True)
    net_d.zero_grad(set_to_none=True)
    return output.detach(), d_grads, g_grads


def _compare_gan_grads(model, arch, dcn, batch):
    """:func:`_gan_backward` three ways on ``batch``: the discriminator's
    and the generator's gradients through the kernels and behind the same
    forward against the plain versions' (the discriminator's pre-norm conv
    biases held to noise against their conv's weight gradient instead),
    and the outputs."""
    model.feed_data(batch)
    alpha = model.penalty_alpha(batch['img_in'].shape[0], 1)
    out_k, d_own, g_own = _gan_backward(model, arch, dcn, alpha)
    out_s, d_same, g_same = _gan_backward(model, arch, dcn, alpha,
                                          plain_forward=True)
    out_p, d_plain, g_plain = _gan_backward(model, arch, dcn, alpha,
                                            plain_ops=True)
    noise = max(float(d_own[n].abs().max()
                      / d_own[n[:-len('bias')] + 'weight'].abs().max())
                for n in d_own if _pre_norm_bias(n))
    keep = [n for n in d_plain if not _pre_norm_bias(n)]

    def d_only(grads):
        return {n: grads[n] for n in keep}

    return {'d_same_forward': _rel_grad_errors(d_only(d_same),
                                               d_only(d_plain)),
            'd_own_forward': _rel_grad_errors(d_only(d_own),
                                              d_only(d_plain)),
            'd_pre_norm_bias_noise': noise,
            'g_same_forward': _rel_grad_errors(g_same, g_plain),
            'g_own_forward': _rel_grad_errors(g_own, g_plain),
            'same_forward_bit_equal': bool(torch.equal(out_s, out_p)),
            'own_forward_bit_equal': bool(torch.equal(out_k, out_p)),
            'out_max_abs_diff': float((out_k - out_p).abs().max())}


def _check_gan_grads(label, cmp):
    """The checks of :func:`_check_grads` on both nets' gradients (f32:
    a GAN step casts nothing)."""
    for net in ('d', 'g'):
        _check_grad_errors(f'{label}, {net}, behind the same forward',
                           cmp[f'{net}_same_forward'])
        if cmp['own_forward_bit_equal']:
            _check_grad_errors(f'{label}, {net}', cmp[f'{net}_own_forward'])
    check(cmp['d_pre_norm_bias_noise'] <= TRAIN_GRAD_REL_TOL,
          f'{label}: a pre-norm bias gradient is not noise: {cmp}')
    check(cmp['same_forward_bit_equal'], f'{label}: the plain forward values '
          'did not give the plain forward')
    check(cmp['out_max_abs_diff'] <= SLICE_TOL,
          f'{label}: kernels and plain versions give other outputs: {cmp}')


def _norm_writes(net_d):
    from mrefsr_tpu_torch.parallel.batch_norm import BatchNorm2d
    return {int(m.num_batches_tracked) for m in net_d.modules()
            if isinstance(m, BatchNorm2d)}


def phase_gan_train(alignment, build_model, arch, dcn, kernels,
                    percep=False):
    """``_gan_opt``'s model (B 8, gt 160, 5 refs) from seeded weights: the
    gradients of a GAN step's two losses through the kernels against the
    plain versions at B 2; then ``GAN_STEPS`` steps through
    ``optimize_parameters`` on one repeated batch: 2 bf16 pixel steps
    (bf16 entry points only), then GAN steps (f32 entry points only), the
    discriminator's norms written exactly twice a GAN step, every logged
    loss and the penalty finite, the zero G losses of a skipped turn; step
    ms (the GAN steps after the first), peak memory, a profile of a GAN
    step without G and of one with G. Returns the GAN steps' launches and
    their mean ms."""
    dtype_parts = ('match',) + (('k2', 'k2_bwd') if alignment == 'dcn'
                                else ('k4', 'k4_bwd'))
    opt = _gan_opt(alignment, percep)
    model = build_model(opt)
    check(model.device.type == 'cuda', f'model built on {model.device}')
    check(model.train_dtype == BF16, 'the GAN YAMLs train bf16 pixel steps')
    rng = np.random.RandomState(SEED + 30)
    batch = _train_batch(rng, GAN_B)
    cmp = _compare_gan_grads(model, arch, dcn, _train_batch(rng, 2))
    tag = f'gan_{alignment}' + ('_percep' if percep else '')
    _check_gan_grads(f'{tag}, fresh weights', cmp)

    torch.cuda.synchronize()
    reset_counts(kernels)
    for step in range(1, GAN_PRETRAIN + 1):
        model.feed_data(batch)
        model.optimize_parameters(step)
    pixel_launches = read_counts(kernels, _entries(dtype_parts, BF16),
                                 _forbidden(BF16))
    check(_norm_writes(model.net_d) == {0},
          'a pixel step wrote the discriminator\'s norms')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    step_ms, logs = [], []
    for step in range(GAN_PRETRAIN + 1, GAN_STEPS + 1):
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.optimize_parameters(step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logs.append(model.get_current_log())
    launches = read_counts(kernels, _entries(dtype_parts, torch.float32),
                           SCATTERS + BF16_ENTRIES)
    peak = torch.cuda.max_memory_allocated()
    gan_steps = GAN_STEPS - GAN_PRETRAIN
    check(_norm_writes(model.net_d) == {2 * gan_steps},
          f'the norms were written {_norm_writes(model.net_d)} times in '
          f'{gan_steps} GAN steps, not twice a step')
    want_keys = {'l_d_real', 'l_d_fake', 'out_d_real', 'out_d_fake',
                 'l_grad_penalty', 'l_g_pix', 'l_g_gan'}
    if percep:
        want_keys |= {'l_g_percep', 'l_g_style'}
    for k, log in enumerate(logs, 1):
        check(set(log) == want_keys, f'GAN log keys {sorted(log)}')
        check(all(np.isfinite(v) for v in log.values()),
              f'non-finite GAN losses {log}')
        g_turn = k % 2 == 0
        check((log['l_g_gan'] != 0) == g_turn,
              f'GAN step {k}: g_turn {g_turn} but l_g_gan {log["l_g_gan"]}')
    mean_ms = statistics.mean(step_ms[1:])
    emit({'phase': tag, 'batch': GAN_B, 'gt': TRAIN_GT, 'refs': T,
          'network_g': opt['network_g'], 'network_d': opt['network_d'],
          'pixel_steps': GAN_PRETRAIN, 'gan_steps': gan_steps,
          'pixel_dtype': str(BF16), 'gan_dtype': str(torch.float32),
          'step_ms': step_ms, 'mean_gan_step_ms': mean_ms,
          'mean_g_turn_step_ms': statistics.mean(step_ms[1::2]),
          'mean_d_only_step_ms': statistics.mean(step_ms[2::2]),
          'img_per_s': GAN_B / mean_ms * 1e3, 'peak_mem_bytes': peak,
          'logs': logs, 'grads_fresh_weights': cmp,
          'grad_tolerance': TRAIN_GRAD_REL_TOL, 'out_tolerance': SLICE_TOL,
          'launches_pixel_steps': {n: v for n, v in pixel_launches.items()
                                   if v},
          'launches_gan_steps': {n: v for n, v in launches.items() if v}})
    # one GAN step of each kind: D only (k odd), then with G (k even)
    for step, kind in ((GAN_STEPS + 1, 'd_only'), (GAN_STEPS + 2, 'g_turn')):
        def one_step(step=step):
            model.feed_data(batch)
            model.optimize_parameters(step)

        emit(dict(profile_record(tag, one_step), gan_step=kind))
    del model
    torch.cuda.empty_cache()
    return launches, mean_ms


# ``ddp_gan``: two ranks of DDP_GAN_B samples against one process of the
# global batch, one GAN step with G from the same seeded weights, cuDNN
# deterministic, the process's net_g run on the ranks' rows in turn (so
# the fakes agree bit for bit). The ranks and the process still sum in
# other orders (the norms' statistics over 2 x 4 samples or 8, the
# discriminator's convolutions at B 4 or 8). What a rounding apart moves
# little is held tight: the norms' running statistics and every logged
# loss, the penalty included, within DDP_GAN_TOL of the process's
# (measured, H100: 4.1e-7 and 8.2e-7), the generator's gradients within
# DDP_GAN_G_TOL of each tensor's max (measured 1.4e-5; its gradient of
# the GAN term crosses the discriminator). The discriminator's own
# gradients go through the penalty's double backward, which moves by up to
# 0.25 % of a tensor for an input a rounding apart (gan_train's
# own-forward comparison, 6e-8 of the fake); they are held by a two-part
# rule, the median tensor within DDP_GAN_D_MEDIAN and every one within
# DDP_GAN_D_WORST (measured: 1.4e-3 and 1.5e-2). The rank reduction itself
# is held to 1e-4 on the CPU (tests/test_torch_gan.py), where the
# discriminator's arithmetic does not depend on the batch split.
DDP_GAN_TOL, DDP_GAN_G_TOL = 1e-5, 1e-4
DDP_GAN_D_MEDIAN, DDP_GAN_D_WORST = 5e-3, 5e-2
DDP_GAN_B = GAN_B // DDP_WORLD


def _ddp_gan_opt(dist_on):
    opt = _gan_opt('dcn')
    opt['dist'] = dist_on
    opt['train'].update(net_g_pretrain_steps=0, net_d_steps=1,
                        net_d_init_steps=0)
    return opt


def _gan_step_record(model, batch):
    """One GAN step with G (iteration 1) on ``batch``: the gradients each
    optimizer steps with, the discriminator's state after, and the log."""
    grads = {}
    for key, optimizer, net in (
            ('d', model.optimizer_d, model.net_d),
            ('g', model.optimizer_g, model.get_bare_model(model.net_g))):
        stepper = optimizer.step

        def recording(*args, _net=net, _key=key, _step=stepper, **kwargs):
            grads[_key] = {n: p.grad.detach().clone()
                           for n, p in _net.named_parameters()}
            return _step(*args, **kwargs)

        optimizer.step = recording
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.optimize_parameters(1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.backends.cudnn.deterministic = False
    return {'d_grads': grads['d'], 'g_grads': grads['g'],
            'd_state': {k: v.detach().clone()
                        for k, v in model.net_d.state_dict().items()},
            'log': model.get_current_log(), 'step_ms': ms}


def _ddp_gan_batch():
    return _train_batch(np.random.RandomState(SEED + 31), GAN_B)


def _ddp_gan_part(build_model, kernels, rank, root):
    """``ddp_gan``'s part of a rank in a joined group: its rows of the
    global batch through one GAN step, :func:`_gan_step_record` saved to
    ``root/gan_rank<r>.pt``."""
    t0 = time.perf_counter()
    model = build_model(_ddp_gan_opt(True))
    rows = slice(rank * DDP_GAN_B, (rank + 1) * DDP_GAN_B)
    batch = {k: v[rows] for k, v in _ddp_gan_batch().items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    record = _gan_step_record(model, batch)
    record['launches'] = {n: k.launches for n, k in kernels.items()}
    record['peak_mem_bytes'] = torch.cuda.max_memory_allocated()
    record['part_s'] = time.perf_counter() - t0
    dist.barrier()
    torch.save(record, os.path.join(root, f'gan_rank{rank}.pt'))


def _ddp_gan_rank(rank, backend, root):
    """One rank of ``ddp_gan`` alone (``--gan``): joins the group as
    ``_ddp_rank`` does and runs :func:`_ddp_gan_part`."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank))
    import importlib

    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.ops import correlation, dcn, fused_act
    from mrefsr_tpu_torch.utils.dist_util import get_dist_info, init_dist
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')
    init_dist('pytorch', backend=backend)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rank, _ = get_dist_info()
        _ddp_gan_part(build_model, kernel_objects(
            correlation, dcn, ops_upfirdn2d, fused_act), rank, root)
    finally:
        dist.destroy_process_group()


def _spawn_ranks(fn, backend, root, label):
    """``fn(rank, backend, root)`` in ``DDP_WORLD`` processes (spawn)
    under the torchrun env contract; waits for them (at most
    ``DDP_WAIT_S``), and a failed rank raises here and ends the others."""
    t0 = time.perf_counter()
    os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(_free_port()),
                      WORLD_SIZE=str(DDP_WORLD))
    ctx = torch.multiprocessing.spawn(fn, args=(backend, root),
                                      nprocs=DDP_WORLD, join=False)
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() - t0 < DDP_WAIT_S,
                  f'the {label} ranks outlived {DDP_WAIT_S} s')
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(30)


def phase_ddp_gan(build_model):
    """``ddp_gan`` alone (``--gan``): its two ranks in processes of their
    own, then :func:`_ddp_gan_check`. The whole script runs the ranks'
    part in the ``ddp`` phase's processes instead."""
    cards = torch.cuda.device_count()
    backend = 'nccl' if cards >= DDP_WORLD else 'gloo'
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        _spawn_ranks(_ddp_gan_rank, backend, root, 'ddp_gan')
        ranks = _ddp_gan_records(root)
    return _ddp_gan_check(build_model, ranks, backend,
                          {'ranks_s': time.perf_counter() - t0})


def _ddp_gan_records(root):
    return [torch.load(os.path.join(root, f'gan_rank{r}.pt'),
                       map_location='cuda', weights_only=False)
            for r in range(DDP_WORLD)]


def _ddp_gan_check(build_model, ranks, backend, seconds):
    """``ddp_gan``: two ranks (as ``ddp``: NCCL with a card a rank, else
    gloo on the one card) of B 4, each ``ranks``' record, against this
    process on the global B 8, one GAN step of the full-width ``dcn``
    model with the discriminator's norms over the global batch. Returns
    the ranks' launches summed."""
    model = build_model(_ddp_gan_opt(False))
    forward = model._forward

    def in_rank_chunks(*args, **kwargs):
        # net_g on the ranks' rows in turn: cuDNN picks its algorithms by
        # shape, so a forward at B 8 is not the ranks' at B 4 bit for bit,
        # and a discriminator fed a fake a rounding apart flips leaky-ReLU
        # gates (gan_train's own-forward comparison: up to 0.25 % of D's
        # gradients, 1.8 % of G's)
        outs = [forward(*(a[r * DDP_GAN_B:(r + 1) * DDP_GAN_B]
                          for a in args), **kwargs)
                for r in range(DDP_WORLD)]
        return torch.cat(outs)

    model._forward = in_rank_chunks
    one = _gan_step_record(model, _ddp_gan_batch())
    del model
    torch.cuda.empty_cache()
    errors = []
    for rank in ranks:
        err = {}
        for net in ('d', 'g'):
            got, want = rank[f'{net}_grads'], one[f'{net}_grads']
            floor = 1e-6 * max(float(v.abs().max()) for v in want.values())
            rel = {n: float((got[n] - v).abs().max())
                   / max(float(v.abs().max()), floor)
                   for n, v in want.items()
                   if not (net == 'd' and _pre_norm_bias(n))}
            worst = max(rel, key=rel.get)
            err[net] = {'worst': rel[worst], 'worst_name': worst,
                        'median': float(np.median(list(rel.values())))}
        stats = {k: float((rank['d_state'][k] - v).abs().max())
                 / max(float(v.abs().max()), 1e-12)
                 for k, v in one['d_state'].items() if 'running_' in k}
        worst = max(stats, key=stats.get)
        err['running_stats'] = {'worst': stats[worst], 'worst_name': worst}
        err['log'] = {k: abs(rank['log'][k] - v) / max(abs(v), 1e-12)
                      for k, v in one['log'].items()}
        errors.append(err)
    emit({'phase': 'ddp_gan_errors', 'errors_by_rank': errors})
    for err in errors:
        check(err['running_stats']['worst'] <= DDP_GAN_TOL
              and max(err['log'].values()) <= DDP_GAN_TOL,
              f'ddp_gan: the norms or the losses differ from one process: '
              f'{err}')
        check(err['d']['median'] <= DDP_GAN_D_MEDIAN
              and err['d']['worst'] <= DDP_GAN_D_WORST,
              f'ddp_gan: the discriminator differs from one process: {err}')
        check(err['g']['worst'] <= DDP_GAN_G_TOL,
              f'ddp_gan: the generator differs from one process: {err}')
    for key, val in ranks[0]['d_state'].items():
        check(torch.equal(ranks[1]['d_state'][key], val),
              f'ddp_gan: the ranks hold other {key}')
    launches = {n: sum(r['launches'][n] for r in ranks)
                for n in ranks[0]['launches']}
    check(all(launches[n] > 0 for n in _entries(('match', 'k2', 'k2_bwd'),
                                                  torch.float32))
          and not any(launches[n] for n in SCATTERS + BF16_ENTRIES),
          f'ddp_gan launched {launches}')
    emit({'phase': 'ddp_gan', 'backend': backend, 'world': DDP_WORLD,
          'batch_a_rank': DDP_GAN_B, 'global_batch': GAN_B,
          'network_g': _gan_opt('dcn')['network_g'],
          'network_d': _gan_opt('dcn')['network_d'],
          'errors_by_rank': errors,
          'tolerances': {'stats_and_losses': DDP_GAN_TOL,
                         'g': DDP_GAN_G_TOL, 'd_median': DDP_GAN_D_MEDIAN,
                         'd_worst': DDP_GAN_D_WORST},
          'rank_step_ms': [r['step_ms'] for r in ranks],
          'one_process_step_ms': one['step_ms'],
          'rank_peak_mem_bytes': [r['peak_mem_bytes'] for r in ranks],
          'rank_part_s': [r['part_s'] for r in ranks], **seconds,
          'launches': {n: v for n, v in launches.items() if v}})
    return launches


# ------------------------------------------------------------ single ref
def _ref_opt(dtype=torch.float32, train=True):
    """``RefRestorationModel`` with ``RestorationNet`` at ngf 64, 16
    blocks, 8 deform groups, ``ContrasExtractorSep``, the stage-3 train
    block; ``dtype`` bf16 sets ``train`` and ``val.mixed_precision``."""
    opt = _train_opt('dcn') if train else _cufed5_opt()
    opt['model_type'] = 'RefRestorationModel'
    opt['network_g'] = {'type': 'RestorationNet', 'ngf': 64, 'n_blocks': 16,
                        'groups': 8}
    opt['network_extractor'] = {'type': 'ContrasExtractorSep'}
    if dtype == BF16:
        if train:
            opt['train']['mixed_precision'] = 'bfloat16'
        opt['val'] = {'mixed_precision': 'bfloat16'}
    return opt


def _single_ref(batch):
    """A 5-ref batch as a single-ref one: its first ref."""
    out = {k: v for k, v in batch.items() if k != 'img_ref_list'}
    out['img_ref'] = batch['img_ref_list'][:, 0]
    return out


def phase_ref_train(build_model, arch, dcn, kernels, dtype):
    """A stage-3-shaped pixel step of the single-ref model (B 6, gt 160),
    f32 or bf16: the gradients through the kernels against the plain
    versions at B 1 (``_compare_grads``), a warm-up and three timed steps,
    launches, peak memory, a profile. Returns the timed steps' launches."""
    bf16 = dtype == BF16
    model = build_model(_ref_opt(dtype))
    check(model.train_dtype == dtype, f'train dtype {model.train_dtype}')
    rng = np.random.RandomState(SEED + 32)
    batch = _single_ref(_train_batch(rng, TRAIN_B))
    cmp = _compare_grads(model, arch, dcn, _single_ref(_train_batch(rng, 1)))
    tag = 'ref_train' + ('_bf16' if bf16 else '')
    _check_grads(f'{tag}, fresh weights', cmp, dtype)
    model.feed_data(batch)
    model.optimize_parameters(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    step_ms, losses = [], []
    for step in range(2, 5):
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.optimize_parameters(step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(model.get_current_log()['l_pix'])
    launches = read_counts(kernels, _entries(('match', 'k2', 'k2_bwd'),
                                             dtype), _forbidden(dtype))
    check(all(np.isfinite(losses)), f'non-finite loss {losses}')
    emit({'phase': tag, 'batch': TRAIN_B, 'gt': TRAIN_GT, 'refs': 1,
          'network_g': model.opt['network_g'], 'dtype': str(dtype),
          'step_ms': step_ms, 'mean_step_ms': statistics.mean(step_ms),
          'peak_mem_bytes': torch.cuda.max_memory_allocated(),
          'losses': losses, 'grads_fresh_weights': cmp,
          'launches_3_steps': {n: v for n, v in launches.items() if v}})

    def one_step():
        model.feed_data(batch)
        model.optimize_parameters(5)

    phase_profile(tag, one_step)
    del model
    torch.cuda.empty_cache()
    return launches


def phase_ref_eval(build_model, correlation, dcn, kernels, dtype):
    """Two single-ref requests at the 500x500 canvas (live offset heads),
    f32 or bf16: the second's ms, launches, peak memory, one request
    through the kernels against the plain versions. Returns the launches
    of the two requests."""
    bf16 = dtype == BF16
    model = build_model(_ref_opt(dtype, train=False))
    check(model.eval_dtype == dtype, f'eval dtype {model.eval_dtype}')
    gen = torch.Generator().manual_seed(SEED + 33)
    with torch.no_grad():
        for m in model.net_g.modules():
            if hasattr(m, 'conv_offset_mask'):
                w, b = m.conv_offset_mask.weight, m.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
                b.copy_(torch.rand(b.shape, generator=gen) * 2 - 1)
    rng = np.random.RandomState(SEED + 34)
    requests = [_single_ref(_request(rng)) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    request_ms = []
    for batch in requests:
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.test()
        rlt = model.get_current_visuals()['rlt']
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        check(rlt.shape == (1, CANVAS, CANVAS, 3)
              and bool(np.isfinite(rlt).all()), f'output {rlt.shape}')
    launches = read_counts(kernels, _entries(('match', 'k2'), dtype),
                           _forbidden(dtype))
    peak = torch.cuda.max_memory_allocated()
    _, cmp = _request_vs_plain(model, correlation, dcn, requests[0], dtype)
    tag = 'ref_eval' + ('_bf16' if bf16 else '')
    emit({'phase': tag, 'canvas': CANVAS, 'refs': 1, 'dtype': str(dtype),
          'request_ms': request_ms, 'second_request_ms': request_ms[1],
          'peak_mem_bytes': peak, **cmp,
          'launches': {n: v for n, v in launches.items() if v}})
    del model
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------- video training
# The video training phases (video_train, sr_train, cli_video): full width
# by BasicSR's published training YAMLs, EDVR-M's options/train/EDVR/
# train_EDVR_M_x4_SR_REDS_woTSA.yml (and train_EDVR_M_x4_SR_REDS.yml with
# TSA), BasicVSR's options/train/BasicVSR/train_BasicVSR_REDS.yml and
# MSRResNet's options/train/SRResNet_SRGAN/train_MSRResNet_x4.yml, on
# synthetic data in REDS's layout and seeded weights. No BasicVSR++
# training YAML is in the repository or the JAX package's tests: its net is
# the REDS configuration of inference/inference_basicvsrpp.py (mid 64, 7
# blocks, residue 10), its train block and data BasicVSR's.
REDS_FRAMES, REDS_LQ = 100, (180, 320)      # a REDS clip, its LQ frames
VAL_FRAMES = 20                 # cli_video's validation clip (011)
VIDEO_B, VIDEO_GT = 4, 256
VIDEO_WARMUP, VIDEO_STEPS = 2, 3
ICONVSR_STEPS = 2          # IconVSR's timed training steps at each type
CUT = 2                    # tsa_iter (YAML 50000) and fix_flow (YAML 5000)
SR_B, SR_GT, SR_IMAGES = 16, 128, 16
# sr_train's timed steps: its loss must fall over them, and at bf16 it
# rises at the fourth step of this batch (by 3e-4), so five steps left the
# last loss within 1e-5 of the first, on either side (about 20 ms a step)
SR_STEPS = 10
YAML_SOURCES = {
    'edvr': 'BasicSR options/train/EDVR/train_EDVR_M_x4_SR_REDS_woTSA.yml',
    'edvr_tsa': 'BasicSR options/train/EDVR/train_EDVR_M_x4_SR_REDS.yml',
    'basicvsr': 'BasicSR options/train/BasicVSR/train_BasicVSR_REDS.yml',
    'iconvsr': 'BasicSR options/train/BasicVSR/train_IconVSR_REDS.yml',
    'iconvsr_serve': 'BasicSR options/test/BasicVSR/test_IconVSR_REDS.yml',
    'tof_serve': 'BasicSR options/test/TOF/test_TOF_official.yml',
    'duf_serve': 'BasicSR options/test/DUF/test_DUF_official.yml',
    'video_gan': 'GAN block: BasicSR options/train/SRResNet_SRGAN/'
                 'train_MSRGAN_x4.yml (L1 1e-2, VGG19 conv5_4 perceptual, '
                 'vanilla GAN 5e-3, Adam 1e-4 for net_d); net_g: the video '
                 'YAML of its kind; net_d: VGGStyleDiscriminator num_feat 64, '
                 'input 256',
    'basicvsrpp': 'net: inference/inference_basicvsrpp.py REDS_KWARGS '
                  '(BasicSR test_BasicVSRPP_REDS.yml); train block and data: '
                  'BasicSR options/train/BasicVSR/train_BasicVSR_REDS.yml',
    'sr': 'BasicSR options/train/SRResNet_SRGAN/train_MSRResNet_x4.yml'}
def _smooth_clip(seed, frames, h, w):
    """``frames`` uint8 BGR frames (h, w, 3) of one smooth seeded scene
    moving 1 pixel down and 2 right a frame (SpyNet has motion to find)."""
    gen = torch.Generator().manual_seed(seed)
    bh, bw = h + frames, w + 2 * frames
    base = torch.nn.functional.interpolate(
        torch.rand((1, 3, bh // 16 + 4, bw // 16 + 4), generator=gen),
        size=(bh, bw), mode='bicubic', align_corners=False).clamp(0, 1)[0]
    base = (base * 255).round().to(torch.uint8).permute(1, 2, 0).numpy()
    return [np.ascontiguousarray(base[i:i + h, 2 * i:2 * i + w])
            for i in range(frames)]


def _reds_data(root):
    """A synthetic REDS under ``root``: clips ``000`` (of REDS4, the test
    CLI's folder) and ``001`` (training) of ``REDS_FRAMES`` frames and
    ``011`` (of REDS4, ``cli_video``'s validation) of ``VAL_FRAMES``, GT
    720x1280 (``train_sharp``) and LQ 180x320 (``train_sharp_bicubic/X4``,
    OpenCV's area resize), PNG, and the meta-info files (the training
    set's, clip 011's, clip 000's). Returns the paths."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor
    h, w = REDS_LQ
    gt_root = os.path.join(root, 'train_sharp')
    lq_root = os.path.join(root, 'train_sharp_bicubic', 'X4')
    jobs = []
    clips = (('000', REDS_FRAMES), ('001', REDS_FRAMES), ('011', VAL_FRAMES))
    for k, (clip, frames) in enumerate(clips):
        for d in (gt_root, lq_root):
            os.makedirs(os.path.join(d, clip))
        for i, gt in enumerate(_smooth_clip(SEED + 30 + k, frames,
                                            4 * h, 4 * w)):
            jobs.append((os.path.join(gt_root, clip, f'{i:08d}.png'), gt))
            jobs.append((os.path.join(lq_root, clip, f'{i:08d}.png'),
                         cv2.resize(gt, (w, h),
                                    interpolation=cv2.INTER_AREA)))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: cv2.imwrite(
            job[0], job[1], [cv2.IMWRITE_PNG_COMPRESSION, 1]), jobs))
    meta = os.path.join(root, 'meta_info_REDS.txt')
    with open(meta, 'w') as f:
        f.write(''.join(f'{c} {REDS_FRAMES} ({4 * h},{4 * w},3)\n'
                        for c in ('000', '001')))
    out = {'gt': gt_root, 'lq': lq_root, 'meta': meta}
    for key, (clip, frames) in (('meta_test', clips[0]),
                                ('meta_val', clips[2])):
        out[key] = os.path.join(root, f'meta_info_REDS4_{clip}.txt')
        with open(out[key], 'w') as f:
            f.write(f'{clip} {frames} ({4 * h},{4 * w},3)\n')
    return out


def _reds_train_set(data, recurrent):
    """The YAMLs' training set: REDS4 held out, gt 256, flips and
    rotations, interval 1, no reverse; 5 frames for EDVR, 15 recurrent."""
    opt = {'name': 'REDS', 'phase': 'train', 'scale': 4,
           'dataroot_gt': data['gt'], 'dataroot_lq': data['lq'],
           'meta_info_file': data['meta'], 'val_partition': 'REDS4',
           'io_backend': {'type': 'disk'}, 'gt_size': VIDEO_GT,
           'interval_list': [1], 'random_reverse': False,
           'use_hflip': True, 'use_rot': True}
    if recurrent:
        opt.update(type='REDSRecurrentDataset', num_frame=15,
                   test_mode=False)
    else:
        opt.update(type='REDSDataset', num_frame=5, dataroot_flow=None)
    return opt


def _video_batch(dataset_opt, seed, b=VIDEO_B):
    """``b`` samples of the set, from its seeded draws, collated."""
    from mrefsr_tpu_torch.data import build_dataset, default_collate
    dataset = build_dataset(dataset_opt, seed=seed)
    step = len(dataset) // b
    return default_collate([dataset[i * step] for i in range(b)])


# IconVSR of test_IconVSR_REDS.yml / train_IconVSR_REDS.yml
ICONVSR = {'type': 'IconVSR', 'num_feat': 64, 'num_block': 30,
           'keyframe_stride': 5, 'temporal_padding': 2}
# K2 launches of one IconVSR forward: the keyframes' EDVR windows folded
# into one batch run the four deformable convs of one PCD alignment once
ICONVSR_DCNS = 4


def _video_train_opt(kind, dtype=torch.float32):
    """The model options of ``kind`` (edvr, edvr_tsa, basicvsr, iconvsr,
    basicvsrpp) at full width: the YAMLs' network and train blocks,
    ``tsa_iter`` / ``fix_flow`` cut to ``CUT``."""
    from mrefsr_tpu_torch.inference.inference_basicvsrpp import REDS_KWARGS
    if kind.startswith('edvr'):
        net = dict(type='EDVR', **EDVR_M, with_predeblur=False,
                   hr_in=False)
        net['with_tsa'] = kind == 'edvr_tsa'
        train = {'optim_g': {'type': 'Adam', 'lr': 4e-4,
                             'betas': [0.9, 0.99]},
                 'scheduler': {'type': 'CosineAnnealingRestartLR',
                               'periods': [150000] * 4,
                               'restart_weights': [1] * 4, 'eta_min': 1e-7},
                 'total_iter': 600000, 'warmup_iter': -1, 'dcn_lr_mul': 1,
                 'pixel_opt': {'type': 'CharbonnierLoss', 'loss_weight': 1.0,
                               'reduction': 'sum'}}
        if kind == 'edvr_tsa':
            train['tsa_iter'] = CUT
        model_type = 'EDVRModel'
    else:
        net = {'basicvsr': {'type': 'BasicVSR', 'num_feat': 64,
                            'num_block': 30},
               'iconvsr': dict(ICONVSR),
               'basicvsrpp': dict(type='BasicVSRPlusPlus',
                                  **REDS_KWARGS)}[kind]
        train = {'optim_g': {'type': 'Adam', 'lr': 2e-4,
                             'betas': [0.9, 0.99]},
                 'scheduler': {'type': 'CosineAnnealingRestartLR',
                               'periods': [300000], 'restart_weights': [1],
                               'eta_min': 1e-7},
                 'total_iter': 300000, 'warmup_iter': -1, 'fix_flow': CUT,
                 'flow_lr_mul': 0.125,
                 'pixel_opt': {'type': 'CharbonnierLoss', 'loss_weight': 1.0,
                               'reduction': 'mean'}}
        model_type = 'VideoRecurrentModel'
    if dtype == BF16:
        train['mixed_precision'] = 'bfloat16'
    return {'name': f'{kind}_train', 'model_type': model_type, 'scale': 4,
            'num_gpu': 1, 'manual_seed': SEED, 'is_train': True,
            'dist': False, 'network_g': net,
            'path': {'pretrain_network_g': None, 'strict_load_g': True},
            'train': train}


def _liven_dcn(net, arch_util, basicvsrpp_arch, gen):
    """Seeded non-zero offset convs (a fresh net has zeros there, which
    samples on the grid): EDVR's ``DCNv2Pack`` as phase ``edvr`` makes
    them, BasicVSR++'s last offset conv as ``basicvsrpp_serve``."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, arch_util.DCNv2Pack):
                w, b = m.conv_offset.weight, m.conv_offset.bias
                w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
                b.copy_(torch.rand(b.shape, generator=gen) * 2 - 1)
            elif isinstance(m, basicvsrpp_arch.SecondOrderDeformableAlignment):
                last = m.conv_offset[-1]
                last.weight.copy_(torch.randn(last.weight.shape,
                                              generator=gen) * 0.01)
                last.bias.copy_(torch.randn(last.bias.shape, generator=gen)
                                * 0.1)


def _video_compare_grads(model, dcn_modules, dcn, batch):
    """``_compare_grads`` for an ``SRModel``: one backward of the step's
    loss through the kernels, through the kernels' Functions with the plain
    forward values, and through the plain versions (``modulated_deform_
    conv2d`` of each module of ``dcn_modules`` replaced)."""
    model.feed_data(batch)

    def backward(plain_ops=False, plain_forward=False):
        model.net_g.zero_grad(set_to_none=True)
        with contextlib.ExitStack() as stack:
            if plain_ops:
                for module in dcn_modules:
                    stack.enter_context(mock.patch.object(
                        module, 'modulated_deform_conv2d',
                        dcn.modulated_deform_conv2d_ref))
            if plain_forward:
                stack.enter_context(mock.patch.object(
                    dcn, '_mdcn_fused_forward_cuda',
                    dcn._mdcn_fused_forward_ref))
            out = model._run(model.net_g, model.train_dtype, False, model.lq)
            loss = sum(model.losses(out, model.gt).values())
        loss.backward()          # outside: the backward kernels all launch
        return out.detach(), {name: p.grad.clone() for name, p
                              in model.net_g.named_parameters()}

    out_k, own = backward()
    out_s, same = backward(plain_forward=True)
    out_p, plain = backward(plain_ops=True)
    model.net_g.zero_grad(set_to_none=True)
    return {'same_forward': _rel_grad_errors(same, plain),
            'same_forward_bit_equal': bool(torch.equal(out_s, out_p)),
            'own_forward': _rel_grad_errors(own, plain),
            'own_forward_bit_equal': bool(torch.equal(out_k, out_p)),
            'out_max_abs_diff': float((out_k - out_p).abs().max())}


def _freeze_steps(model, batch, freezes, must_move=()):
    """Steps 1 and 2 (the warm-ups): with ``freeze_until`` 2 every frozen
    parameter bit-equal through step 1, and moving at step 2. Where the
    model ``freezes`` (``tsa_iter``, ``fix_flow``), it must freeze some
    parameter; otherwise none. Each prefix of ``must_move`` (IconVSR's
    ``spynet.`` and ``edvr.``) must be frozen and then move."""
    keep = model.freeze_keep
    frozen = {n: p.detach().clone() for n, p in model.net_g.named_parameters()
              if keep is not None and not keep(n)}
    check(bool(frozen) == freezes, f'{len(frozen)} frozen parameters; '
          f'the model should {"" if freezes else "not "}freeze some')
    model.feed_data(batch)
    model.optimize_parameters(1)
    held = all(torch.equal(p, frozen[n])
               for n, p in model.net_g.named_parameters() if n in frozen)
    check(held, 'a frozen parameter moved in iteration 1')
    model.optimize_parameters(2)
    moved = sum(not torch.equal(p, frozen[n])
                for n, p in model.net_g.named_parameters() if n in frozen)
    check(not frozen or moved, 'no frozen parameter moved after the '
          'freeze')
    params = dict(model.net_g.named_parameters())
    moved_by = {prefix: sum(not torch.equal(params[n], p) for n, p
                            in frozen.items() if n.startswith(prefix))
                for prefix in must_move}
    check(all(moved_by.values()) and all(
        any(n.startswith(prefix) for n in frozen) for prefix in must_move),
        f'frozen and then moved, by prefix: {moved_by}')
    return {'freeze_until': model.freeze_until, 'frozen_tensors': len(frozen),
            'bit_equal_through_iter_1': held, 'moved_at_iter_2': moved,
            'moved_at_iter_2_by_prefix': moved_by}


def _video_expect(dtype):
    """K2's entry points of a video training step with grad x: the
    forward, the scatter dgrad, wgrad and its sum, at ``dtype`` only."""
    tag = '_bf16' if dtype == BF16 else ''
    return tuple(f'mdcn_fused_{e}{tag}' for e in
                 ('fwd', 'dgrad_scatter', 'wgrad', 'wgrad_sum'))


def phase_video_train(kind, data, kernels, dcn, modules, dtype=torch.float32):
    """``kind``'s full-width training step at B 4 on one batch of the
    synthetic REDS: the gradients through the kernels against the plain
    versions behind the same forward at B 1 (nets with a DCN), two warm-ups
    (the freeze, where ``kind`` has one), ``VIDEO_STEPS`` timed steps
    (``ICONVSR_STEPS`` for IconVSR), their launches (exactly K2's forward,
    scatter dgrad, wgrad and sum at the step's type, nothing else; nothing
    for BasicVSR; for IconVSR each of the four exactly once a step: its
    keyframes' EDVR windows run folded into one batch through the four
    deformable convs of one PCD alignment), peak memory and a profile with
    the scatter apart."""
    from mrefsr_tpu_torch.models import build_model
    arch_util, basicvsrpp_arch, edvr_arch = modules
    bf16 = dtype == BF16
    tag = f'{kind}_train' + ('_bf16' if bf16 else '')
    opt = _video_train_opt(kind, dtype)
    recurrent = not kind.startswith('edvr')
    batch = _video_batch(_reds_train_set(data, recurrent), SEED + 31)
    model = build_model(opt)
    check(model.train_dtype == dtype, f'train dtype {model.train_dtype}')
    _liven_dcn(model.net_g, arch_util, basicvsrpp_arch,
               torch.Generator().manual_seed(SEED + 32))
    expect = () if kind == 'basicvsr' else _video_expect(dtype)
    dcn_modules = {'edvr': (arch_util,), 'edvr_tsa': (arch_util,),
                   'iconvsr': (arch_util,),
                   'basicvsrpp': (basicvsrpp_arch,)}.get(kind, ())
    steps = ICONVSR_STEPS if kind == 'iconvsr' else VIDEO_STEPS
    compare = expect and kind != 'edvr_tsa'
    small = {k: v[:1] for k, v in batch.items() if isinstance(v, np.ndarray)}
    grads = trained = None
    if compare:
        grads = _video_compare_grads(model, dcn_modules, dcn, small)
        _check_grads(f'{tag}, fresh weights', grads, dtype)
    reset_counts(kernels)
    freeze = _freeze_steps(model, batch, freezes=kind != 'edvr',
                           must_move=('spynet.', 'edvr.')
                           if kind == 'iconvsr' else ())
    warm_launches = {n: k.launches for n, k in kernels.items()}
    if kind == 'edvr_tsa':
        _only(kernels, warm_launches, expect)
        emit({'phase': 'video_train', 'path': tag,
              'source': YAML_SOURCES[kind], 'network_g': opt['network_g'],
              'batch': VIDEO_B, 'gt': VIDEO_GT, 'frames': 5,
              'dtype': str(dtype), 'freeze': freeze,
              'launches_2_steps': {n: v for n, v in warm_launches.items()
                                   if v},
              'reduced': [f'tsa_iter {CUT} (YAML 50000)', '2 steps',
                          'one repeated batch', 'seeded weights, live '
                          'offset convs (the YAML starts from the woTSA '
                          'checkpoint)']})
        return warm_launches, None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    step_ms, losses = [], []
    for step in range(VIDEO_WARMUP + 1, VIDEO_WARMUP + steps + 1):
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.optimize_parameters(step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(model.get_current_log()['l_pix'])
    launches = {n: k.launches for n, k in kernels.items()}
    if expect:
        _only(kernels, launches, expect)
    else:
        check(not any(launches.values()), f'{tag} launched {launches}')
    if kind == 'iconvsr':
        check(all(launches[e] == ICONVSR_DCNS * steps for e in expect),
              f'IconVSR launched {launches} in {steps} steps, expected '
              f'{ICONVSR_DCNS} of each of {expect} a step')
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f'non-finite loss: {losses}')
    for p in model.net_g.parameters():
        state = model.optimizer_g.state[p]
        check(p.dtype == p.grad.dtype == state['exp_avg'].dtype
              == torch.float32, 'master parameters, gradients and Adam '
              'state must be f32')
    if compare:
        trained = _video_compare_grads(model, dcn_modules, dcn, small)
        _check_grads(f'{tag}, after {VIDEO_WARMUP + steps} steps',
                     trained, dtype)
    frames = batch['lq'].shape[1]
    mean_ms = statistics.mean(step_ms)
    reduced = ['one repeated batch', f'{steps} timed steps',
               'seeded weights, live offset convs' if expect
               else 'seeded weights']
    if kind != 'edvr':
        reduced.insert(0, f'fix_flow {CUT} (YAML 5000)')
    emit({'phase': 'video_train', 'path': tag, 'source': YAML_SOURCES[kind],
          'network_g': opt['network_g'], 'train': opt['train'],
          'batch': VIDEO_B, 'gt': VIDEO_GT, 'frames': frames,
          'dtype': str(dtype), 'step_ms': step_ms, 'mean_step_ms': mean_ms,
          'step_ms_range': [min(step_ms), max(step_ms)],
          'clips_per_s': VIDEO_B / mean_ms * 1e3, 'peak_mem_bytes': peak,
          'losses': losses, 'freeze': freeze,
          'learning_rates': model.get_current_learning_rate(),
          f'launches_{steps}_steps': {n: v for n, v in launches.items()
                                      if v},
          'grads_fresh_weights': grads,
          f'grads_after_{VIDEO_WARMUP + steps}_steps': trained,
          'grad_tolerance': (TRAIN_GRAD_BF16_TOL if bf16
                             else TRAIN_GRAD_REL_TOL) if grads else None,
          'out_tolerance': (SLICE_BF16_TOL if bf16 else SLICE_TOL)
          if grads else None, 'reduced': reduced})

    def one_step():
        model.feed_data(batch)
        model.optimize_parameters(VIDEO_WARMUP + steps + 1)

    if expect:               # the profile splits K2: BasicVSR has none
        phase_profile(tag, one_step)
    del model
    torch.cuda.empty_cache()
    return launches, mean_ms


def _sr_data(root):
    """``SR_IMAGES`` smooth seeded 256x256 GT PNGs and their 64x64 LQ
    (area resize), as a paired folder; the training set's options."""
    import cv2
    gt_dir, lq_dir = os.path.join(root, 'sr_gt'), os.path.join(root, 'sr_lq')
    os.makedirs(gt_dir)
    os.makedirs(lq_dir)
    for i, gt in enumerate(_smooth_clip(SEED + 40, SR_IMAGES, 256, 256)):
        cv2.imwrite(os.path.join(gt_dir, f'{i:04d}.png'), gt)
        cv2.imwrite(os.path.join(lq_dir, f'{i:04d}.png'),
                    cv2.resize(gt, (64, 64), interpolation=cv2.INTER_AREA))
    return {'name': 'sr_train', 'type': 'PairedImageDataset',
            'phase': 'train', 'scale': 4, 'dataroot_gt': gt_dir,
            'dataroot_lq': lq_dir, 'io_backend': {'type': 'disk'},
            'gt_size': SR_GT, 'use_hflip': True, 'use_rot': True}


def phase_sr_train(root, kernels, dtype=torch.float32):
    """``SRModel`` + MSRResNet (64 features, 16 blocks, x4) as BasicSR's
    ``train_MSRResNet_x4.yml``: gt 128, B 16, L1, Adam 2e-4, on a paired
    folder; two warm-ups and ``SR_STEPS`` timed steps. It launches no
    kernel of this repository (checked)."""
    from mrefsr_tpu_torch.models import build_model
    bf16 = dtype == BF16
    tag = 'sr_train' + ('_bf16' if bf16 else '')
    batch = _video_batch(_sr_data(os.path.join(root, tag)), SEED + 41,
                         b=SR_B)
    train = {'ema_decay': 0.999,
             'optim_g': {'type': 'Adam', 'lr': 2e-4, 'betas': [0.9, 0.99]},
             'scheduler': {'type': 'CosineAnnealingRestartLR',
                           'periods': [250000] * 4,
                           'restart_weights': [1] * 4, 'eta_min': 1e-7},
             'total_iter': 1000000, 'warmup_iter': -1,
             'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0,
                           'reduction': 'mean'}}
    if bf16:
        train['mixed_precision'] = 'bfloat16'
    opt = {'name': tag, 'model_type': 'SRModel', 'scale': 4, 'num_gpu': 1,
           'manual_seed': SEED, 'is_train': True, 'dist': False,
           'network_g': {'type': 'MSRResNet', 'num_in_ch': 3,
                         'num_out_ch': 3, 'num_feat': 64, 'num_block': 16,
                         'upscale': 4},
           'path': {'pretrain_network_g': None}, 'train': train}
    model = build_model(opt)
    reset_counts(kernels)
    model.feed_data(batch)
    for step in range(1, VIDEO_WARMUP + 1):
        model.optimize_parameters(step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for step in range(VIDEO_WARMUP + 1, VIDEO_WARMUP + SR_STEPS + 1):
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.optimize_parameters(step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(model.get_current_log()['l_pix'])
    launches = {n: k.launches for n, k in kernels.items()}
    check(not any(launches.values()), f'{tag} launched a kernel of this '
          f'repository: {launches}')
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f'{tag} losses {losses}')
    mean_ms = statistics.mean(step_ms)
    emit({'phase': 'sr_train', 'path': tag, 'source': YAML_SOURCES['sr'],
          'network_g': opt['network_g'], 'train': train, 'batch': SR_B,
          'gt': SR_GT, 'dtype': str(dtype), 'step_ms': step_ms,
          'mean_step_ms': mean_ms,
          'step_ms_range': [min(step_ms), max(step_ms)],
          'img_per_s': SR_B / mean_ms * 1e3,
          'peak_mem_bytes': torch.cuda.max_memory_allocated(),
          'losses': losses, 'hand_written_kernels_launched': 0,
          'reduced': [f'a folder of {SR_IMAGES} synthetic 256x256 images '
                      '(DIV2K sub-images in the YAML)',
                      'one repeated batch', f'{SR_STEPS} timed steps']})
    del model
    torch.cuda.empty_cache()
    return launches


# K2's grad-x scatter against the dgrad without it and cuDNN's grad input,
# alone, at the video training steps' shapes: (case, N, C, Cout, H, W, dg)
VIDEO_TRAIN_K2_SHAPES = (
    ('edvr_m_l1', VIDEO_B * 5, 64, 64, 64, 64, 8),
    ('edvr_m_l2', VIDEO_B * 5, 64, 64, 32, 32, 8),
    ('edvr_m_l3', VIDEO_B * 5, 64, 64, 16, 16, 8),
    ('basicvsrpp', VIDEO_B, 128, 64, 64, 64, 16),
    # IconVSR's PCD levels: B clips x 4 keyframes x 5 frames in training,
    # 4 keyframes x 5 frames of a 180x320 chunk in serving
    ('iconvsr_l1', VIDEO_B * 4 * 5, 64, 64, 64, 64, 8),
    ('iconvsr_l2', VIDEO_B * 4 * 5, 64, 64, 32, 32, 8),
    ('iconvsr_l3', VIDEO_B * 4 * 5, 64, 64, 16, 16, 8),
    ('iconvsr_serve_l1', 4 * 5, 64, 64, 180, 320, 8),
    ('iconvsr_serve_l2', 4 * 5, 64, 64, 90, 160, 8),
    ('iconvsr_serve_l3', 4 * 5, 64, 64, 45, 80, 8))
# the scatter's second offset case beside _mdcn_inputs' randn * 4: uniform
# on [-SCATTER_NEAR, SCATTER_NEAR], samples within a pixel and a half of
# their taps, as smooth offsets put them (their corners crowd together)
SCATTER_NEAR = 1.5


def _near_offsets(gen, like):
    """Offsets of ``like``'s shape, uniform on [-SCATTER_NEAR,
    SCATTER_NEAR], on the card."""
    return ((torch.rand(like.shape, generator=gen) * 2 - 1)
            * SCATTER_NEAR).cuda()


def _scatter_vs_plain(dcn, launch, cot, x, offset, mask, weight, dg, g_off,
                      g_mask, g_x, tol, label):
    """What one ``launch()`` of the scatter dgrad writes (grad x, grad
    offset, grad mask) against autograd of the plain version, each within
    ``tol`` of its largest entry; returns the errors and the largest
    absolute one."""
    g_x.zero_()
    launch()
    got = {'x': g_x.to(x.dtype), 'offset': g_off.clone(),
           'mask': g_mask.clone()}
    inputs = [t.detach().requires_grad_(i < 3) for i, t in
              enumerate((x, offset, mask, weight))]
    want = dict(zip(('x', 'offset', 'mask'), torch.autograd.grad(
        dcn.modulated_deform_conv2d_ref(*inputs, deform_groups=dg),
        inputs[:3], cot)))
    errs = {k: _rel_err(g.float(), want[k].float()) for k, g in got.items()}
    for k, err in errs.items():
        check(err <= tol, f'{label}: grad {k} differs by {err} of its max')
    return errs, max(float((g.float() - want[k].float()).abs().max())
                     for k, g in got.items())


def phase_video_scatter(dcn, dtype=torch.float32):
    """``mdcn_fused_dgrad_scatter`` (and its bf16 twin) alone at the
    shapes of ``VIDEO_TRAIN_K2_SHAPES``, under two offset cases:
    ``_mdcn_inputs``' ``randn * 4`` and offsets uniform on
    [-SCATTER_NEAR, SCATTER_NEAR]. In each, what one launch writes (grad
    x, grad offset, grad mask) is held to autograd of the plain version
    within ``_k2_tol``, then its device ms is timed beside the dgrad
    without grad x and cuDNN's grad input (autograd of ``F.conv2d``: no
    gather, no grad offset or mask); the bound: the dgrad's work (the grad
    columns' product, the bilinear derivatives) and its bytes, grad x
    written once at x's type, and beside it the bound with the atomics' f32
    read and write of grad x."""
    gen = torch.Generator().manual_seed(SEED + 33)
    # the near offsets from a generator of their own: the randn * 4 case's
    # inputs stay as they were before the near case was added
    near_gen = torch.Generator().manual_seed(SEED + 34)
    _, k_dgrad, k_scatter, _, _ = dcn._fused_kernels(dtype)
    size = torch.finfo(dtype).bits // 8
    tol = _k2_tol(dtype)
    recs = []
    for case, n, c, cout, h, w, dg in VIDEO_TRAIN_K2_SHAPES:
        x, randn4, mask, weight, bias = _mdcn_inputs(
            gen, c, h, dg=dg, n=n, dtype=dtype, w=w, cout=cout)
        cot = torch.randn((n, h, w, cout), generator=gen).to(dtype).cuda()
        near = _near_offsets(near_gen, randn4)
        geom = ((3, 3), (1, 1), (1, 1), (1, 1), (h, w))
        g_off, g_mask = torch.empty_like(randn4), torch.empty_like(mask)
        g_x = torch.zeros_like(x, dtype=torch.float32)
        x_nchw = x.permute(0, 3, 1, 2).requires_grad_()
        w_oihw = weight.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        out_l = torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1)
        cot_l = cot.permute(0, 3, 1, 2)
        rows = n * h * w
        flops = [_k2_products(rows * 9.0 * c * cout, dtype),
                 (20.0 * rows * 9 * c, PEAK_F32_FLOPS)]
        # every input read once, every output written once: grad offset
        # (f32) and mask, grad x at x's type (as the Function returns it)
        nbytes = size * (cot.numel() + 2 * x.numel() + 2 * mask.numel()
                         + weight.numel()) + 4.0 * 2 * randn4.numel()
        b_ms, b_by = bound(flops, nbytes)
        w_op = dcn._weight_operand(weight)  # at f32 its TF32 planes
        for spread, offset in (('randn4', randn4), ('near', near)):
            fused = dcn._fused_args(x, offset, weight, geom)
            head = (cot.data_ptr(), x.data_ptr(), offset.data_ptr(),
                    mask.data_ptr(), w_op.data_ptr(), g_off.data_ptr(),
                    g_mask.data_ptr())
            errs, abs_err = _scatter_vs_plain(
                dcn, lambda: k_scatter(*head, g_x.data_ptr(), *fused), cot,
                x, offset, mask, weight, dg, g_off, g_mask, g_x, tol,
                f'video_scatter {case} {spread} {dtype}')
            torch.cuda.empty_cache()
            times = timed({
                'ms': lambda: k_scatter(*head, g_x.data_ptr(), *fused),
                'dgrad_ms': lambda: k_dgrad(*head, *fused),
                'library_ms': lambda: torch.autograd.grad(
                    out_l, x_nchw, cot_l, retain_graph=True)})
            rec = {'phase': 'video_scatter', 'case': case,
                   'offsets': ('randn * 4' if spread == 'randn4' else
                               f'uniform on [-{SCATTER_NEAR}, '
                               f'{SCATTER_NEAR}]'),
                   'n': n, 'c': c, 'cout': cout, 'h': h, 'w': w,
                   'deform_groups': dg, 'dtype': str(dtype),
                   'rel_err': errs, 'tolerance': tol, 'max_abs_err': abs_err,
                   **times, 'bound_ms': b_ms, 'bound_by': b_by,
                   'bytes': nbytes,
                   'bound_share': b_ms / times['ms'],
                   'bound_with_atomics_ms': scatter_atomics_bound(
                       flops, nbytes, x),
                   'ms_is': 'mdcn_fused_dgrad_scatter alone; dgrad_ms the '
                            'dgrad without grad x; library_ms cuDNN grad '
                            'input',
                   'timing': TIMING_NOTE}
            emit(rec)
            recs.append(rec)
        del x, randn4, near, mask, weight, bias, cot, g_off, g_mask, g_x
        del x_nchw, out_l
        torch.cuda.empty_cache()
    return recs


def _cli_video_yml(root, data, iters, val=True, name='edvr_m_wotsa_cli'):
    """The EDVR-M woTSA YAML of ``cli_video``: the train block of
    ``_video_train_opt('edvr')``, BasicSR's REDS training set (3 loader
    threads a GPU, enlarge ratio 200) through the device prefetcher, and
    validation every 20 iterations on clip 011 (``VideoTestDataset``,
    REDS4 layout, cached), PSNR. Returns its path."""
    import yaml
    opt = _video_train_opt('edvr')
    train_set = dict(_reds_train_set(data, False),
                     batch_size_per_gpu=VIDEO_B, num_worker_per_gpu=3,
                     dataset_enlarge_ratio=200, prefetch_mode='device')
    train_set.pop('phase')
    train_set.pop('scale')
    doc = {'name': name, 'model_type': opt['model_type'], 'scale': 4,
           'num_gpu': 1, 'manual_seed': SEED,
           'datasets': {'train': train_set},
           'network_g': opt['network_g'],
           'path': {'pretrain_network_g': None, 'strict_load_g': True,
                    'resume_state': None,
                    'experiments_root': os.path.join(root, 'experiments')},
           'train': dict(opt['train'], total_iter=iters),
           'logger': {'print_freq': 10, 'save_checkpoint_freq': 30,
                      'use_tb_logger': False},
           'dist_params': {'backend': 'nccl', 'port': 29500}}
    if val:
        doc['datasets']['val'] = {
            'name': 'REDS4', 'type': 'VideoTestDataset',
            'dataroot_gt': data['gt'], 'dataroot_lq': data['lq'],
            'meta_info_file': data['meta_val'], 'io_backend': {'type': 'disk'},
            'cache_data': True, 'num_frame': 5,
            'padding': 'reflection_circle'}
        doc['val'] = {'val_freq': 20, 'save_img': False,
                      'metrics': {'psnr': {'type': 'calculate_psnr',
                                           'crop_border': 0,
                                           'test_y_channel': False}}}
    path = os.path.join(root, f'{name}_{iters}.yml')
    with open(path, 'w') as f:
        yaml.safe_dump(doc, f)
    return path


CLI_VIDEO_ITERS, CLI_VIDEO_PREEMPT_AT, CLI_VIDEO_RESUME_TO = 60, 4, 10


def _cli_video_preemption(root, data):
    """The EDVR-M CLI in a process of its own (no validation set), SIGTERM
    once its log shows iteration ``CLI_VIDEO_PREEMPT_AT``: exit 0 and a
    saved ``.state``; ``--auto_resume`` goes on from it to
    ``CLI_VIDEO_RESUME_TO``."""
    import re
    import signal
    yml = _cli_video_yml(root, data, CLI_VIDEO_RESUME_TO, val=False,
                         name='edvr_m_preempt')
    args = ['mrefsr_tpu_torch.train', '-opt', yml, '--force_yml',
            'logger:print_freq=2', 'logger:save_checkpoint_freq=1000']
    log_path = os.path.join(root, 'video_preempt.log')
    proc, out = _cli_popen(args, log_path)
    rc, log = _cli_wait(proc, out, log_path,
                        until=rf'iter:\s*{CLI_VIDEO_PREEMPT_AT}, lr',
                        then=lambda: proc.send_signal(signal.SIGTERM))
    check(rc == 0, f'the preempted video run exited {rc}:\n{log[-3000:]}')
    m = re.search(r'saving state at iter (\d+) and stopping', log)
    check(m is not None, f'no preemption save in the log:\n{log[-3000:]}')
    stopped = int(m.group(1))
    states = os.path.join(root, 'experiments', 'edvr_m_preempt',
                          'training_states')
    check(os.path.isfile(os.path.join(states, f'{stopped}.state'))
          and CLI_VIDEO_PREEMPT_AT <= stopped < CLI_VIDEO_RESUME_TO,
          f'stopped at {stopped}; states: {os.listdir(states)}')
    log_path = os.path.join(root, 'video_resume.log')
    proc, out = _cli_popen(args + ['--auto_resume'], log_path)
    rc, log = _cli_wait(proc, out, log_path)
    check(rc == 0, f'the resumed video run exited {rc}:\n{log[-3000:]}')
    m = re.search(r'Resuming training from epoch: (\d+), iter: (\d+)\.', log)
    iters = [int(v.replace(',', '')) for v in re.findall(
        r'iter:\s*([\d,]+), lr', log)]
    check(m is not None and int(m.group(2)) == stopped and iters
          and iters[0] > stopped and iters[-1] == CLI_VIDEO_RESUME_TO
          and 'End of training' in log,
          f'the video run did not resume at {stopped} to '
          f'{CLI_VIDEO_RESUME_TO}:\n{log[-3000:]}')
    return {'sigterm_after_iter': CLI_VIDEO_PREEMPT_AT, 'stopped_at': stopped,
            'resumed_logged': iters}


def _cli_video_test_start(root, data):
    """Start ``python -m mrefsr_tpu_torch.test`` with ``VideoRecurrentModel``
    + BasicVSR (64 features, 30 blocks, seeded weights saved to a ``.pth``)
    on clip 000 (``VideoRecurrentTestDataset``, 100 frames of 180x320),
    saving every frame. Returns what :func:`_cli_video_test` waits on."""
    import yaml
    from mrefsr_tpu_torch.models import build_model
    net = {'type': 'BasicVSR', 'num_feat': 64, 'num_block': 30}
    seeded = build_model({'name': 'seed', 'model_type': 'VideoRecurrentModel',
                          'scale': 4, 'manual_seed': SEED + 34,
                          'is_train': False, 'network_g': net,
                          'path': {'models': os.path.join(root, 'models')}})
    weights = seeded.save_network(seeded.net_g, 'net_g', 0)
    del seeded
    doc = {'name': 'basicvsr_reds4_cli', 'model_type': 'VideoRecurrentModel',
           'scale': 4, 'num_gpu': 1, 'manual_seed': SEED,
           'datasets': {'test_1': {
               'name': 'REDS4', 'type': 'VideoRecurrentTestDataset',
               'dataroot_gt': data['gt'], 'dataroot_lq': data['lq'],
               'meta_info_file': data['meta_test'],
               'io_backend': {'type': 'disk'}, 'cache_data': True,
               'num_frame': -1}},
           'network_g': net,
           'path': {'pretrain_network_g': weights, 'strict_load_g': True,
                    'results_root': os.path.join(root, 'results')},
           'val': {'save_img': True, 'flip_seq': False,
                   'center_frame_only': False,
                   'metrics': {'psnr': {'type': 'calculate_psnr',
                                        'crop_border': 0,
                                        'test_y_channel': False}}}}
    yml = os.path.join(root, 'test_basicvsr.yml')
    with open(yml, 'w') as f:
        yaml.safe_dump(doc, f)
    log_path = os.path.join(root, 'video_test.log')
    proc, out = _cli_popen(['mrefsr_tpu_torch.test', '-opt', yml], log_path)
    return yml, proc, out, log_path, time.perf_counter()


def _cli_video_test(root, started):
    """Wait for the test CLI of :func:`_cli_video_test_start`; then this
    process's model from the same options and file on the same clip: every
    saved frame equal to this process's bit for bit, the per-frame PSNR
    array's mean the logged one. Times this process's request for the
    whole folder."""
    import re
    import cv2
    from mrefsr_tpu_torch.data import build_dataloader, build_dataset
    from mrefsr_tpu_torch.metrics import calculate_psnr
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.utils import tensor2img
    from mrefsr_tpu_torch.utils.options import parse_options
    yml, proc, out, log_path, t0 = started
    rc, log = _cli_wait(proc, out, log_path)
    test_s = time.perf_counter() - t0
    check(rc == 0, f'the video test.py exited {rc}:\n{log[-3000:]}')
    logged = re.search(r'# psnr: (\S+)\t # 000: (\S+)', log)
    check(logged is not None, f'no PSNR in the test log:\n{log[-3000:]}')

    opt, _ = parse_options(root, is_train=False, args=['-opt', yml])
    model = build_model(opt)
    dataset_opt = opt['datasets']['test_1']
    loader = build_dataloader(build_dataset(dataset_opt), dataset_opt)
    sample = next(iter(loader))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.feed_data(sample)
    model.test()
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t0) * 1e3
    visuals = model.get_current_visuals()
    saved = os.path.join(opt['path']['visualization'], 'REDS4', '000')
    psnr = []
    for fidx in range(REDS_FRAMES):
        img = tensor2img(visuals['result'][0, fidx])
        cli = cv2.imread(os.path.join(saved,
                                      f"{fidx:08d}_{opt['name']}.png"))
        check(cli is not None and np.array_equal(cli, img),
              f'test.py wrote another frame {fidx} than this process '
              'computed')
        psnr.append(calculate_psnr(img, tensor2img(visuals['gt'][0, fidx]),
                                   crop_border=0))
    # the folder's mean as the model takes it: over a float32 array
    mean = f'{np.asarray(psnr, np.float32).mean():.4f}'
    check(mean == logged.group(2), f'test.py logged PSNR {logged.group(2)}, '
          f'this process {mean}')
    del model, visuals
    torch.cuda.empty_cache()
    return {'frames': REDS_FRAMES, 'h': REDS_LQ[0], 'w': REDS_LQ[1],
            'outputs_bit_equal': True, 'psnr_per_frame': psnr,
            'psnr_logged': logged.group(1), 'request_ms': request_ms,
            'test_cli_s': test_s,
            'test_cli_s_is': 'the process, beside the preemption runs'}


def phase_cli_video(root, data, kernels):
    """``cli_video``: the EDVR-M woTSA YAML through ``train_pipeline`` in
    this process for ``CLI_VIDEO_ITERS`` iterations (3 loader threads, the
    device prefetcher, validation at 20, 40 and 60 on clip 011): img/s over
    iterations 11-60 from the host times of the log lines, data time over
    iteration time, peak memory, the launches (K2's f32 entries with the
    scatter in the training iterations); SIGTERM and ``--auto_resume``; then
    the test CLI with BasicVSR on a 100-frame folder."""
    from mrefsr_tpu_torch.models.video_base_model import EDVRModel
    from mrefsr_tpu_torch.train import train_pipeline
    yml = _cli_video_yml(root, data, CLI_VIDEO_ITERS)
    model, train_launches, launches, rec = _cli_train(
        train_pipeline, root, ['-opt', yml], kernels, VIDEO_B, 10,
        CLI_VIDEO_ITERS, model_cls=EDVRModel)
    _only(kernels, train_launches, _video_expect(torch.float32))
    psnr = float(np.mean([arr.mean() for arr in
                          model.metric_results.values()]))
    check(np.isfinite(psnr), f'validation PSNR {psnr}')
    del model
    torch.cuda.empty_cache()
    rec.update(psnr_val=psnr, launches_training={
        n: v for n, v in train_launches.items() if v},
        launches_run={n: v for n, v in launches.items() if v})
    # the test CLI's process runs beside the preemption's two
    started = _cli_video_test_start(root, data)
    rec['preemption'] = _cli_video_preemption(root, data)
    rec['test'] = _cli_video_test(root, started)
    emit({'phase': 'cli_video', 'source': YAML_SOURCES['edvr'],
          'batch': VIDEO_B, 'gt': VIDEO_GT, 'iterations': CLI_VIDEO_ITERS,
          **rec,
          'reduced': [f'{CLI_VIDEO_ITERS} iterations (YAML 600000)',
                      'two synthetic 100-frame clips (REDS: 270); one '
                      f'validation clip of {VAL_FRAMES} frames (REDS4: 4 '
                      'of 100)',
                      'prefetch_mode device (YAML: unset)',
                      'validation every 20 (YAML 5000)']})
    return launches


def _video_model(opt, modules):
    """``build_model(opt)`` with live offset convs (a fresh net's are
    zero, which samples on the grid)."""
    from mrefsr_tpu_torch.models import build_model
    arch_util, basicvsrpp_arch, _ = modules
    model = build_model(opt)
    _liven_dcn(model.get_bare_model(model.net_g), arch_util,
               basicvsrpp_arch, torch.Generator().manual_seed(SEED + 35))
    return model


def phase_iconvsr_serve(kernels, dcn, modules, dtype=torch.float32):
    """IconVSR of ``test_IconVSR_REDS.yml`` (64 features, 30 blocks,
    keyframe stride 5, temporal padding 2) through ``VideoRecurrentModel``'s
    test path (``feed_data`` -> ``test``; ``val.mixed_precision`` at bf16),
    seeded weights with live offset convs: a warm-up, then two timed
    15-frame 180x320 chunks, each launching K2's forward at ``dtype``
    exactly ``ICONVSR_DCNS`` times and nothing else of this repository;
    peak memory; one chunk through the kernels against the plain K2
    forward; a profile."""
    bf16 = dtype == BF16
    tag = 'iconvsr_serve' + ('_bf16' if bf16 else '')
    opt = {'name': tag, 'model_type': 'VideoRecurrentModel', 'scale': 4,
           'num_gpu': 1, 'manual_seed': SEED, 'is_train': False,
           'dist': False, 'network_g': dict(ICONVSR), 'path': {},
           'val': {'mixed_precision': 'bfloat16'} if bf16 else {}}
    model = _video_model(opt, modules)
    check(model.eval_dtype == dtype, f'eval dtype {model.eval_dtype}')
    lq = _video_frames(SEED + 36, VSR_T, VSR_H, VSR_W)[None]
    name = 'mdcn_fused_fwd' + ('_bf16' if bf16 else '')

    def chunk():
        model.feed_data({'lq': lq})
        model.test()
        return model.output

    chunk()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk_ms = []
    for _ in range(2):
        reset_counts(kernels)
        t0 = time.perf_counter()
        out = chunk()
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_counts(kernels, (name,))
        _only(kernels, launches, (name,))
        check(launches[name] == ICONVSR_DCNS, f'a chunk launched {name} '
              f'{launches[name]} times, expected {ICONVSR_DCNS}')
    peak = torch.cuda.max_memory_allocated()
    check(tuple(out.shape) == (1, VSR_T, 4 * VSR_H, 4 * VSR_W, 3)
          and out.dtype == torch.float32 and bool(torch.isfinite(out).all())
          and float(out.std()) > 0, f'output {tuple(out.shape)}')
    x = model.lq
    out_k, out_p, diff = _kernel_vs_plain(lambda: model.eval_forward(x), dcn)
    scale = float(out_p.abs().max())
    tol = SLICE_BF16_TOL if bf16 else VIDEO_TOL * scale
    check(diff <= tol, f'{tag}: kernels vs plain differ by {diff} (max '
          f'|out| {scale}, tolerance {tol})')
    del out_k, out_p, out
    mean_ms = sum(chunk_ms) / len(chunk_ms)
    emit({'phase': 'iconvsr_serve', 'path': tag,
          'source': YAML_SOURCES['iconvsr_serve'], 'network_g': ICONVSR,
          'frames': VSR_T, 'h': VSR_H, 'w': VSR_W, 'dtype': str(dtype),
          'chunk_ms': chunk_ms, 'frame_ms': mean_ms / VSR_T,
          'frames_per_s': VSR_T / mean_ms * 1e3, 'peak_mem_bytes': peak,
          'launches_per_chunk': {n: v for n, v in launches.items() if v},
          'plain_vs_kernel_max_abs_diff': diff, 'max_abs_out': scale,
          'tolerance': tol,
          'reduced': ['seeded weights, live offset convs (the YAML loads '
                      'the REDS checkpoints)', 'one synthetic 15-frame '
                      'chunk (REDS4: 100-frame clips)']})
    phase_profile(tag, chunk)
    del model
    torch.cuda.empty_cache()
    return launches


def _serve_times(kernels, run, reps=3):
    """A warm-up, then ``reps`` timed calls of ``run()`` (host clock around
    a synchronised call) and the peak memory; no kernel of this repository
    may launch."""
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts(kernels, ())
    check(not any(launches.values()), f'launched {launches}')
    return out, times, torch.cuda.max_memory_allocated(), launches


def phase_tof_serve(kernels):
    """TOFlow of ``test_TOF_official.yml`` (the official frame order)
    through ``VideoBaseModel``'s test path on one window of 7 Vimeo-90K
    frames already upsampled to 256x448, seeded weights, norms on their
    running statistics: time and peak memory (no kernel of this
    repository runs on this path)."""
    from mrefsr_tpu_torch.models import build_model
    opt = {'name': 'tof_serve', 'model_type': 'VideoBaseModel', 'scale': 4,
           'num_gpu': 1, 'manual_seed': SEED, 'is_train': False,
           'dist': False, 'path': {}, 'val': {},
           'network_g': {'type': 'TOFlow', 'adapt_official_weights': True}}
    model = build_model(opt)
    lq = _video_frames(SEED + 37, 7, 256, 448)[None]

    def window():
        model.feed_data({'lq': lq})
        model.test()
        return model.output

    out, times, peak, launches = _serve_times(kernels, window)
    check(tuple(out.shape) == (1, 256, 448, 3)
          and bool(torch.isfinite(out).all()), f'output {tuple(out.shape)}')
    emit({'phase': 'tof_serve', 'source': YAML_SOURCES['tof_serve'],
          'network_g': opt['network_g'], 'frames': 7, 'h': 256, 'w': 448,
          'dtype': 'torch.float32', 'window_ms': times,
          'peak_mem_bytes': peak, 'hand_written_kernels_launched': 0,
          'reduced': ['seeded weights (the YAML loads the official TOF '
                      'weights)', 'one synthetic window (Vimeo-90K test: '
                      '7824 septuplets)']})
    del model
    torch.cuda.empty_cache()
    return launches


def phase_duf_serve(kernels, root):
    """DUF-52L of ``test_DUF_official.yml`` through ``VideoTestDUFDataset``
    (``use_duf_downsampling``: the LQ frames made from the GT frames on
    the host) and ``VideoBaseModel``'s test path, on a synthetic Vid4-layout
    clip of 7 frames, GT 576x720: one window of 7 (the centre frame's), the
    sample's host time apart; seeded weights, norms on their running
    statistics; time and peak memory (no kernel of this repository)."""
    import cv2
    from mrefsr_tpu_torch.data import build_dataset
    from mrefsr_tpu_torch.models import build_model
    gt_dir = os.path.join(root, 'vid4', 'GT', 'calendar')
    lq_dir = os.path.join(root, 'vid4', 'BIx4', 'calendar')
    os.makedirs(gt_dir)
    os.makedirs(lq_dir)
    for i, gt in enumerate(_smooth_clip(SEED + 38, 7, 576, 720)):
        cv2.imwrite(os.path.join(gt_dir, f'{i:08d}.png'), gt)
        cv2.imwrite(os.path.join(lq_dir, f'{i:08d}.png'),
                    cv2.resize(gt, (180, 144), interpolation=cv2.INTER_AREA))
    dataset = build_dataset({
        'name': 'Vid4', 'type': 'VideoTestDUFDataset', 'phase': 'test',
        'scale': 4, 'dataroot_gt': os.path.dirname(gt_dir),
        'dataroot_lq': os.path.dirname(lq_dir), 'io_backend': {'type':
                                                                'disk'},
        'cache_data': False, 'num_frame': 7, 'padding': 'reflection_circle',
        'use_duf_downsampling': True})
    t0 = time.perf_counter()
    sample = dataset[3]
    sample_ms = (time.perf_counter() - t0) * 1e3
    check(sample['lq'].shape == (7, 144, 180, 3), f'lq {sample["lq"].shape}')
    opt = {'name': 'duf_serve', 'model_type': 'VideoBaseModel', 'scale': 4,
           'num_gpu': 1, 'manual_seed': SEED, 'is_train': False,
           'dist': False, 'path': {}, 'val': {},
           'network_g': {'type': 'DUF', 'scale': 4, 'num_layer': 52,
                         'adapt_official_weights': True}}
    model = build_model(opt)
    batch = {'lq': sample['lq'][None], 'gt': sample['gt'][None]}

    def window():
        model.feed_data(batch)
        model.test()
        return model.output

    out, times, peak, launches = _serve_times(kernels, window)
    check(tuple(out.shape) == (1, 576, 720, 3)
          and bool(torch.isfinite(out).all()), f'output {tuple(out.shape)}')
    emit({'phase': 'duf_serve', 'source': YAML_SOURCES['duf_serve'],
          'network_g': opt['network_g'], 'frames': 7, 'lq': [144, 180],
          'gt': [576, 720], 'dtype': 'torch.float32', 'window_ms': times,
          'sample_ms': sample_ms, 'peak_mem_bytes': peak,
          'hand_written_kernels_launched': 0,
          'reduced': ['seeded weights (the YAML loads the official DUF '
                      'weights)', 'one synthetic 7-frame clip, one window '
                      '(Vid4: 4 clips, 171 frames)']})
    del model
    torch.cuda.empty_cache()
    return launches


VIDEO_GAN_STEPS = 4


def _video_gan_opt(kind):
    """``VideoGANModel`` with EDVR-M woTSA or ``VideoRecurrentGANModel`` with
    IconVSR: the video YAML's net, optimizer and schedule for ``net_g``
    (``fix_flow`` and ``flow_lr_mul`` for IconVSR), MSRGAN's GAN block,
    ``VGGStyleDiscriminator`` (64 features, input 256) and a seeded VGG19;
    f32, as every GAN step."""
    opt = _video_train_opt(kind)
    train = opt['train']
    train.pop('pixel_opt')
    train.update(
        pixel_opt={'type': 'L1Loss', 'loss_weight': 1e-2,
                   'reduction': 'mean'},
        perceptual_opt={'type': 'PerceptualLoss',
                        'layer_weights': {'conv5_4': 1}, 'vgg_type': 'vgg19',
                        'use_input_norm': True, 'range_norm': False,
                        'perceptual_weight': 1.0, 'style_weight': 0,
                        'criterion': 'l1'},
        gan_opt={'type': 'GANLoss', 'gan_type': 'vanilla',
                 'real_label_val': 1.0, 'fake_label_val': 0.0,
                 'loss_weight': 5e-3},
        optim_d={'type': 'Adam', 'lr': 1e-4, 'betas': [0.9, 0.99]},
        net_d_iters=1, net_d_init_iters=0)
    opt.update(name=f'video_gan_{kind}',
               model_type='VideoGANModel' if kind == 'edvr'
               else 'VideoRecurrentGANModel',
               network_d={'type': 'VGGStyleDiscriminator', 'num_in_ch': 3,
                          'num_feat': 64, 'input_size': VIDEO_GT})
    opt['path']['vgg_pretrain_path'] = None
    return opt


def _video_gan_compare_grads(model, dcn_modules, dcn, batch):
    """One generator and one discriminator backward of a GAN step (the
    generator's pixel, perceptual and GAN terms; the discriminator's on the
    real and the detached fake frames, its norms writing nothing), three
    times as :func:`_video_compare_grads`: through the kernels, through the
    kernels' Functions behind the plain forward values, through the plain
    versions. Both nets' gradients against the third."""
    from mrefsr_tpu_torch.parallel.batch_norm import frozen_stats
    model.feed_data(batch)

    def backward(plain_ops=False, plain_forward=False):
        model.net_g.zero_grad(set_to_none=True)
        model.net_d.zero_grad(set_to_none=True)
        with contextlib.ExitStack() as stack:
            if plain_ops:
                for module in dcn_modules:
                    stack.enter_context(mock.patch.object(
                        module, 'modulated_deform_conv2d',
                        dcn.modulated_deform_conv2d_ref))
            if plain_forward:
                stack.enter_context(mock.patch.object(
                    dcn, '_mdcn_fused_forward_cuda',
                    dcn._mdcn_fused_forward_ref))
            out = model._run(model.net_g, torch.float32, False, model.lq)
            loss = sum(model.g_losses(out).values())
        loss.backward()
        model.net_d.requires_grad_(True)
        with frozen_stats(model.net_d):
            d = model.d_losses(out.detach())
        (d['l_d_real'] + d['l_d_fake']).backward()
        model.net_d.requires_grad_(False)
        grads = {f'g.{n}': p.grad.clone()
                 for n, p in model.net_g.named_parameters()}
        grads.update({f'd.{n}': p.grad.clone()
                      for n, p in model.net_d.named_parameters()})
        return out.detach(), grads

    out_k, own = backward()
    out_s, same = backward(plain_forward=True)
    out_p, plain = backward(plain_ops=True)
    model.net_g.zero_grad(set_to_none=True)
    model.net_d.zero_grad(set_to_none=True)
    return {'same_forward': _rel_grad_errors(same, plain),
            'same_forward_bit_equal': bool(torch.equal(out_s, out_p)),
            'own_forward': _rel_grad_errors(own, plain),
            'own_forward_bit_equal': bool(torch.equal(out_k, out_p)),
            'out_max_abs_diff': float((out_k - out_p).abs().max())}


def phase_video_gan(kind, data, kernels, dcn, modules):
    """``kind``'s GAN training (``_video_gan_opt``) at B ``VIDEO_B``, gt
    256, f32, on one batch of the synthetic REDS: both nets' gradients
    through the kernels against the plain versions behind the same forward
    at B 1, two warm-ups (IconVSR's ``fix_flow`` among them), then
    ``VIDEO_GAN_STEPS`` timed steps launching exactly K2's forward, scatter
    dgrad, wgrad and sum at f32; step ms and peak memory."""
    arch_util = modules[0]
    opt = _video_gan_opt(kind)
    model = _video_model(opt, modules)
    batch = _video_batch(_reds_train_set(data, kind != 'edvr'), SEED + 39)
    small = {k: v[:1] for k, v in batch.items() if isinstance(v, np.ndarray)}
    grads = _video_gan_compare_grads(model, (arch_util,), dcn, small)
    _check_grads(f'video_gan {kind}, fresh weights', grads)
    expect = _video_expect(torch.float32)
    reset_counts(kernels)
    for step in range(1, VIDEO_WARMUP + 1):
        model.feed_data(batch)
        model.optimize_parameters(step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    step_ms, logs = [], []
    for step in range(VIDEO_WARMUP + 1, VIDEO_WARMUP + VIDEO_GAN_STEPS + 1):
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.optimize_parameters(step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logs.append(model.get_current_log())
    launches = {n: k.launches for n, k in kernels.items()}
    _only(kernels, launches, expect)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(v) for log in logs for v in log.values()),
          f'non-finite GAN losses: {logs}')
    mean_ms = statistics.mean(step_ms)
    emit({'phase': 'video_gan', 'path': f'video_gan_{kind}',
          'model_type': opt['model_type'], 'source': YAML_SOURCES['video_gan'],
          'net_g_source': YAML_SOURCES[kind], 'network_g': opt['network_g'],
          'network_d': opt['network_d'], 'batch': VIDEO_B,
          'gt': VIDEO_GT, 'frames': batch['lq'].shape[1],
          'dtype': 'torch.float32', 'step_ms': step_ms,
          'mean_step_ms': mean_ms, 'peak_mem_bytes': peak, 'logs': logs,
          'launches_per_step': {n: v / VIDEO_GAN_STEPS
                                for n, v in launches.items() if v},
          'grads_fresh_weights': grads, 'grad_tolerance': TRAIN_GRAD_REL_TOL,
          'out_tolerance': SLICE_TOL,
          'reduced': [f'{VIDEO_GAN_STEPS} timed steps', 'one repeated batch',
                      'seeded weights, live offset convs, seeded VGG19']
          + ([f'fix_flow {CUT} (YAML 5000)'] if kind != 'edvr' else [])})
    del model
    torch.cuda.empty_cache()
    return launches


def _zoo_serving_phases(root, data, kernels, dcn, modules):
    """``iconvsr_serve`` (f32, bf16), ``tof_serve``, ``duf_serve`` and
    ``video_gan`` (EDVR-M woTSA, IconVSR). Returns the launches by
    path."""
    by_path = {}
    for dtype in (torch.float32, BF16):
        tag = 'iconvsr_serve' + ('_bf16' if dtype == BF16 else '')
        by_path[tag] = phase_iconvsr_serve(kernels, dcn, modules, dtype)
    by_path['tof_serve'] = phase_tof_serve(kernels)
    by_path['duf_serve'] = phase_duf_serve(kernels, root)
    for kind in ('edvr', 'iconvsr'):
        by_path[f'video_gan_{kind}'] = phase_video_gan(kind, data, kernels,
                                                       dcn, modules)
    return by_path


def zoo_phases(build_model, arch, correlation, dcn, kernels):
    """The phases of the video zoo that IconVSR, TOFlow, DUF and the video
    GAN models add to :func:`video_phases`: IconVSR's ``video_train`` at
    both types, :func:`_zoo_serving_phases` and ``video_scatter`` at both
    types. Returns the launches by path."""
    from mrefsr_tpu_torch.archs import arch_util, basicvsrpp_arch, edvr_arch
    modules = (arch_util, basicvsrpp_arch, edvr_arch)
    by_path = {}
    with tempfile.TemporaryDirectory() as root:
        data = _reds_data(root)
        for dtype in (torch.float32, BF16):
            tag = 'iconvsr_train' + ('_bf16' if dtype == BF16 else '')
            by_path[tag], _ = phase_video_train('iconvsr', data, kernels,
                                                dcn, modules, dtype)
        by_path.update(_zoo_serving_phases(root, data, kernels, dcn,
                                           modules))
        for dtype in (torch.float32, BF16):
            phase_video_scatter(dcn, dtype)
    return by_path


def video_phases(build_model, arch, correlation, dcn, kernels):
    """``video_train`` (EDVR-M woTSA f32 and bf16, EDVR-M with TSA across
    ``tsa_iter``, BasicVSR, BasicVSR++ f32 and bf16, IconVSR f32 and bf16),
    ``iconvsr_serve`` (f32, bf16), ``tof_serve``, ``duf_serve``,
    ``video_gan`` (EDVR-M woTSA, IconVSR), ``video_scatter``, ``sr_train``
    (f32, bf16) and ``cli_video``, on a synthetic REDS written to a
    temporary directory. Returns the launches by path."""
    from mrefsr_tpu_torch.archs import arch_util, basicvsrpp_arch, edvr_arch
    modules = (arch_util, basicvsrpp_arch, edvr_arch)
    by_path = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        data = _reds_data(root)
        emit({'phase': 'video_data', 'seconds': time.perf_counter() - t0,
              'clips': 2, 'frames': REDS_FRAMES, 'lq': list(REDS_LQ)})
        for kind, dtype in (('edvr', torch.float32), ('edvr', BF16),
                            ('edvr_tsa', torch.float32),
                            ('basicvsr', torch.float32),
                            ('basicvsrpp', torch.float32),
                            ('basicvsrpp', BF16),
                            ('iconvsr', torch.float32), ('iconvsr', BF16)):
            tag = f'{kind}_train' + ('_bf16' if dtype == BF16 else '')
            by_path[tag], _ = phase_video_train(kind, data, kernels, dcn,
                                                modules, dtype)
        by_path.update(_zoo_serving_phases(root, data, kernels, dcn,
                                           modules))
        for dtype in (torch.float32, BF16):
            phase_video_scatter(dcn, dtype)
            tag = 'sr_train' + ('_bf16' if dtype == BF16 else '')
            by_path[tag] = phase_sr_train(root, kernels, dtype)
        by_path['cli_video'] = phase_cli_video(root, data, kernels)
    return by_path


def gan_phases(build_model, arch, dcn, kernels, ddp_gan=True):
    """``gan_train`` (dcn, flow, dcn with the perceptual and style losses)
    and, where ``ddp_gan``, ``ddp_gan`` in processes of its own. Returns
    the launches by path."""
    by_path = {}
    for alignment, percep, path in (('dcn', False, 'gan'),
                                    ('flow', False, 'gan_flow'),
                                    ('dcn', True, 'gan_percep')):
        by_path[path], _ = phase_gan_train(alignment, build_model, arch, dcn,
                                           kernels, percep)
    if ddp_gan:
        by_path['ddp_gan'] = phase_ddp_gan(build_model)
    return by_path


def ref_phases(build_model, arch, correlation, dcn, kernels):
    """``ref_train`` and ``ref_eval`` in f32 and bf16. Returns the
    launches by path."""
    by_path = {}
    for dtype, suffix in ((torch.float32, ''), (BF16, '_bf16')):
        by_path['ref' + suffix] = phase_ref_train(build_model, arch, dcn,
                                                  kernels, dtype)
        by_path['ref_eval' + suffix] = phase_ref_eval(
            build_model, correlation, dcn, kernels, dtype)
    return by_path


# ------------------------------------------------------------------ SR zoo
# The single-image nets of the SR zoo at their published widths, seeded
# weights and synthetic images. None of their paths launches a kernel of
# this repository (checked): cuDNN convolutions, cuBLAS products, ATen's
# resampling, pixel shuffles and softmax.
SR_ZOO_YAMLS = {
    'rrdbnet_x4': 'BasicSR options/train/ESRGAN/train_ESRGAN_x4.yml',
    'rrdbnet_x2': 'Real-ESRGAN options/train_realesrgan_x2plus.yml',
    'edsr_m_x4': 'BasicSR options/train/EDSR/train_EDSR_Mx4.yml',
    'rcan_x4': 'BasicSR options/train/RCAN/train_RCAN_x2.yml at upscale 4',
    'srvgg_x4': 'Real-ESRGAN realesr-general-x4v3 (SRVGGNetCompact)',
    'ecbsr_m4c16_x4': 'BasicSR options/train/ECBSR/'
                      'train_ECBSR_x4_m4c16_prelu_RGB.yml',
    'ridnet': 'BasicSR inference/inference_ridnet.py (RIDNet(3, 64, 3))',
    'swinir_classical_x4': 'BasicSR options/train/SwinIR/'
                           'train_SwinIR_SRx4_scratch_P48W8_DIV2K_500k_'
                           'B4G8.yml'}
YAML_SOURCES.update(
    esrgan_train='BasicSR options/train/ESRGAN/train_ESRGAN_x4.yml',
    swinir_train=SR_ZOO_YAMLS['swinir_classical_x4'],
    **SR_ZOO_YAMLS)
_RGB_MEAN = [0.4488, 0.4371, 0.4040]
RRDB_X4 = {'type': 'RRDBNet', 'num_in_ch': 3, 'num_out_ch': 3, 'scale': 4,
           'num_feat': 64, 'num_block': 23, 'num_grow_ch': 32}
SWINIR_X4 = {'type': 'SwinIR', 'upscale': 4, 'in_chans': 3, 'img_size': 48,
             'window_size': 8, 'img_range': 1., 'depths': [6] * 6,
             'embed_dim': 180, 'num_heads': [6] * 6, 'mlp_ratio': 2,
             'upsampler': 'pixelshuffle', 'resi_connection': '1conv',
             'drop_path_rate': 0.1}
# (path, model type, network_g, scale)
SR_ZOO = (
    ('rrdbnet_x4', 'SRModel', RRDB_X4, 4),
    ('rrdbnet_x2', 'SRModel', dict(RRDB_X4, scale=2), 2),
    ('edsr_m_x4', 'SRModel',
     {'type': 'EDSR', 'num_in_ch': 3, 'num_out_ch': 3, 'num_feat': 64,
      'num_block': 16, 'upscale': 4, 'res_scale': 1, 'img_range': 255.,
      'rgb_mean': _RGB_MEAN}, 4),
    ('rcan_x4', 'SRModel',
     {'type': 'RCAN', 'num_in_ch': 3, 'num_out_ch': 3, 'num_feat': 64,
      'num_group': 10, 'num_block': 20, 'squeeze_factor': 16, 'upscale': 4,
      'res_scale': 1, 'img_range': 255., 'rgb_mean': _RGB_MEAN}, 4),
    ('srvgg_x4', 'SRModel',
     {'type': 'SRVGGNetCompact', 'num_in_ch': 3, 'num_out_ch': 3,
      'num_feat': 64, 'num_conv': 32, 'upscale': 4, 'act_type': 'prelu'}, 4),
    ('ecbsr_m4c16_x4', 'SRModel',
     {'type': 'ECBSR', 'num_in_ch': 3, 'num_out_ch': 3, 'num_block': 4,
      'num_channel': 16, 'with_idt': False, 'act_type': 'prelu',
      'scale': 4}, 4),
    ('ridnet', 'SRModel', {'type': 'RIDNet', 'in_channels': 3,
                           'mid_channels': 64, 'out_channels': 3}, 1),
    ('swinir_classical_x4', 'SwinIRModel', SWINIR_X4, 4))
SR_ZOO_LQ, SR_ZOO_CPU_LQ = 256, 64
SR_ZOO_ODD = (3, 5)         # SwinIR's LQ is this much smaller: padded
SR_ZOO_CPU_TOL = 1e-4       # card against CPU, share of the largest entry
ESRGAN_B, ESRGAN_GT, SWINIR_B, SWINIR_GT = 16, 160, 4, 192
SR_ZOO_STEPS = 5
SR_ZOO_LOSS_TOL = 1e-4      # card against CPU, relative, a logged term


def _sr_image(seed, h, w, scale=1.):
    """One smooth seeded RGB image (1, h, w, 3), float32 in [0, scale]."""
    bgr = _smooth_clip(seed, 1, h, w)[0]
    return np.ascontiguousarray(bgr[None, :, :, ::-1], np.float32) \
        / 255. * scale


def _sr_serve_opt(path, model_type, net, scale, dtype, device='cuda'):
    opt = {'name': path, 'model_type': model_type, 'scale': scale,
           'num_gpu': 1, 'manual_seed': SEED, 'is_train': False,
           'dist': False, 'network_g': copy.deepcopy(net), 'path': {},
           'val': {'mixed_precision': 'bfloat16'} if dtype == BF16 else {}}
    from mrefsr_tpu_torch.models import build_model
    return build_model(opt, device=device)


def _sr_test(model, lq):
    model.feed_data({'lq': lq})
    model.test()
    return model.output


def phase_sr_zoo_serve(kernels):
    """Each net of ``SR_ZOO`` built through the registry at its published
    width, one 256x256 LQ (SwinIR 253x251, which ``SwinIRModel.test``
    reflect-pads to the window) through ``SRModel.test`` /
    ``SwinIRModel.test``, f32 and ``val.mixed_precision: bfloat16``: ms a
    forward and peak memory; then the card's f32 output on a 64x64 LQ
    (SwinIR 61x59) against the same net on the CPU. Returns the launches
    (none)."""
    launches = {n: 0 for n in kernels}
    for path, model_type, net, scale in SR_ZOO:
        odd = SR_ZOO_ODD if model_type == 'SwinIRModel' else (0, 0)
        rng = 255. if net['type'] == 'RIDNet' else 1.
        lq = _sr_image(SEED + 50, SR_ZOO_LQ - odd[0], SR_ZOO_LQ - odd[1],
                       rng)
        rec = {'phase': 'sr_zoo_serve', 'path': path,
               'source': SR_ZOO_YAMLS[path], 'model_type': model_type,
               'network_g': net, 'lq': list(lq.shape[1:3])}
        for dtype in (torch.float32, BF16):
            model = _sr_serve_opt(path, model_type, net, scale, dtype)
            x = torch.from_numpy(lq).cuda()
            out, times, peak, counts = _serve_times(
                kernels, lambda: _sr_test(model, x))
            want = (1, lq.shape[1] * scale, lq.shape[2] * scale, 3)
            check(tuple(out.shape) == want
                  and bool(torch.isfinite(out).all()),
                  f'{path} {dtype}: output {tuple(out.shape)}, want {want}')
            tag = 'bf16' if dtype == BF16 else 'f32'
            rec[f'{tag}_forward_ms'] = times
            rec[f'{tag}_peak_mem_bytes'] = peak
            if dtype == torch.float32:
                small = np.ascontiguousarray(
                    lq[:, :SR_ZOO_CPU_LQ - odd[0], :SR_ZOO_CPU_LQ - odd[1]])
                card = _sr_test(model, torch.from_numpy(small).cuda()).cpu()
                cpu = _sr_serve_opt(path, model_type, net, scale, dtype,
                                    device='cpu')
                plain = _sr_test(cpu, torch.from_numpy(small))
                err = float((card - plain).abs().max()
                            / plain.abs().max())
                check(err <= SR_ZOO_CPU_TOL,
                      f'{path}: card and CPU differ by {err}')
                rec.update(cpu_check_lq=list(small.shape[1:3]),
                           card_vs_cpu_rel_err=err,
                           card_vs_cpu_tolerance=SR_ZOO_CPU_TOL)
                del cpu
            for n, v in counts.items():
                launches[n] += v
            del model
            torch.cuda.empty_cache()
        emit(dict(rec, hand_written_kernels_launched=0,
                  reduced=['seeded weights (the published checkpoints are '
                           'not in the repository)', 'one synthetic image']))
    return launches


def _esrgan_opt():
    """``ESRGANModel`` as ``train_ESRGAN_x4.yml``: RRDBNet 64/23/32 against
    ``VGGStyleDiscriminator`` (64 features), L1 1e-2, VGG19 ``conv5_4``
    perceptual 1.0, vanilla GAN 5e-3, Adam 1e-4 for both nets; a seeded
    VGG19. The discriminator takes 160x160: this repository's takes 160
    or 256 (the YAML's 128 is BasicSR's later ``VGGStyleDiscriminator``)."""
    return {'name': 'esrgan_train', 'model_type': 'ESRGANModel', 'scale': 4,
            'num_gpu': 1, 'manual_seed': SEED, 'is_train': True,
            'dist': False, 'network_g': dict(RRDB_X4),
            'network_d': {'type': 'VGGStyleDiscriminator', 'num_in_ch': 3,
                          'num_feat': 64, 'input_size': ESRGAN_GT},
            'path': {'pretrain_network_g': None, 'vgg_pretrain_path': None},
            'train': {
                'ema_decay': 0.999,
                'optim_g': {'type': 'Adam', 'lr': 1e-4, 'betas': [0.9, 0.99]},
                'optim_d': {'type': 'Adam', 'lr': 1e-4, 'betas': [0.9, 0.99]},
                'scheduler': {'type': 'MultiStepLR',
                              'milestones': [50000, 100000, 200000, 300000],
                              'gamma': 0.5},
                'total_iter': 400000, 'warmup_iter': -1,
                'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1e-2,
                              'reduction': 'mean'},
                'perceptual_opt': {'type': 'PerceptualLoss',
                                   'layer_weights': {'conv5_4': 1},
                                   'vgg_type': 'vgg19',
                                   'use_input_norm': True,
                                   'range_norm': False,
                                   'perceptual_weight': 1.0,
                                   'style_weight': 0, 'criterion': 'l1'},
                'gan_opt': {'type': 'GANLoss', 'gan_type': 'vanilla',
                            'real_label_val': 1.0, 'fake_label_val': 0.0,
                            'loss_weight': 5e-3},
                'net_d_iters': 1, 'net_d_init_iters': 0}}


def _sr_pairs(seed, b, gt, scale=4):
    """``b`` smooth seeded gt crops and their LQ (OpenCV's area resize)."""
    import cv2
    frames = _smooth_clip(seed, b, gt, gt)
    lq = [cv2.resize(f, (gt // scale, gt // scale),
                     interpolation=cv2.INTER_AREA) for f in frames]
    as_rgb = lambda imgs: np.ascontiguousarray(  # noqa: E731
        np.stack(imgs)[..., ::-1], np.float32) / 255.
    return {'lq': as_rgb(lq), 'gt': as_rgb(frames)}


def _pixel_grads(model):
    """``net_g``'s gradients of the pixel loss alone, by name, on the
    CPU."""
    model.net_g.zero_grad(set_to_none=True)
    out = model._run(model.net_g, torch.float32, False, model.lq)
    model.cri_pix(out, model.gt).backward()
    grads = {n: p.grad.cpu() for n, p in model.net_g.named_parameters()}
    model.net_g.zero_grad(set_to_none=True)
    return grads


def _esrgan_card_vs_cpu(batch):
    """One ``ESRGANModel`` step at B 1 on the card and on the CPU from the
    same seeded weights. Held: ``net_g``'s gradients of the pixel loss
    (``TRAIN_GRAD_REL_TOL``), the logged terms (``SR_ZOO_LOSS_TOL``), and
    after the step every parameter within 2 lr of the CPU's with 99 % of
    each net's entries within lr / 10 (Adam's first step moves an entry by
    lr whatever its gradient's size, so only a sign that differs moves it
    apart: the rule of the video GAN trajectories' CPU tests), the running
    statistics (``SR_ZOO_CPU_TOL``). The whole step's gradients are not
    compared: through the discriminator (B 1, its norms over 25 positions
    at the last level) and the perceptual loss's L1, f32 itself moves them
    by about 0.6 % of a tensor's largest entry (median; the CPU in f32
    against f64: ``PERF.md`` PR 17)."""
    from mrefsr_tpu_torch.models import build_model
    models = {dev: build_model(_esrgan_opt(), device=dev)
              for dev in ('cuda', 'cpu')}
    for model in models.values():
        model.feed_data(batch)
    pixel = _rel_grad_errors(_pixel_grads(models['cuda']),
                             _pixel_grads(models['cpu']))
    _check_grad_errors('esrgan_train pixel loss, card against CPU', pixel)
    logs = {}
    for dev, model in models.items():
        model.optimize_parameters(1)
        logs[dev] = model.get_current_log()
    loss_err = max(abs(logs['cuda'][k] - v) / max(abs(v), 1e-12)
                   for k, v in logs['cpu'].items())
    check(loss_err <= SR_ZOO_LOSS_TOL, f'esrgan_train logs {logs}')
    lr = _esrgan_opt()['train']['optim_g']['lr']
    params, stats_err = {}, 0.
    for net in ('net_g', 'net_d'):
        card = getattr(models['cuda'], net).state_dict()
        worst, near, count = 0., 0, 0
        for key, val in getattr(models['cpu'], net).state_dict().items():
            if not val.is_floating_point():
                continue
            diff = (card[key].cpu().double() - val.double()).abs()
            if 'running' in key:
                stats_err = max(stats_err, float(diff.max() / val.abs().max()))
                continue
            worst = max(worst, float(diff.max()) / lr)
            near += int((diff <= lr / 10).sum())
            count += diff.numel()
        params[net] = {'max_diff_in_lr': worst,
                       'share_within_lr_10th': near / count}
        check(worst <= 2 and near / count >= 0.99,
              f'esrgan_train {net} after a step: {params[net]}')
    check(stats_err <= SR_ZOO_CPU_TOL,
          f'esrgan_train running statistics differ by {stats_err}')
    return {'pixel_grads': pixel, 'logs': logs, 'logs_rel_err': loss_err, 'params': params,
            'stats_rel_err': stats_err}


def _timed_steps(model, batch, first, steps):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, logs = [], []
    for step in range(first, first + steps):
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.optimize_parameters(step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logs.append(model.get_current_log())
    return step_ms, logs, torch.cuda.max_memory_allocated()


def phase_esrgan_train(kernels):
    """``_esrgan_opt`` at B 16, gt 160, f32 (the JAX GAN step casts
    nothing): the card against the CPU on one step at B 1, two warm-ups
    and ``SR_ZOO_STEPS`` timed steps (finite relativistic terms), peak
    memory and a profile of one step."""
    from mrefsr_tpu_torch.models import build_model
    batch = _sr_pairs(SEED + 51, ESRGAN_B, ESRGAN_GT)
    cmp = _esrgan_card_vs_cpu({k: v[:1] for k, v in batch.items()})
    model = build_model(_esrgan_opt())
    reset_counts(kernels)
    for step in (1, 2):
        model.feed_data(batch)
        model.optimize_parameters(step)
    step_ms, logs, peak = _timed_steps(model, batch, 3, SR_ZOO_STEPS)
    launches = read_counts(kernels, ())
    check(not any(launches.values()), f'esrgan_train launched {launches}')
    check(all(np.isfinite(v) for log in logs for v in log.values()),
          f'non-finite ESRGAN terms: {logs}')
    mean_ms = statistics.mean(step_ms)
    opt = _esrgan_opt()
    emit({'phase': 'esrgan_train', 'source': YAML_SOURCES['esrgan_train'],
          'network_g': opt['network_g'], 'network_d': opt['network_d'],
          'train': opt['train'], 'batch': ESRGAN_B, 'gt': ESRGAN_GT,
          'dtype': 'torch.float32', 'step_ms': step_ms,
          'mean_step_ms': mean_ms, 'img_per_s': ESRGAN_B / mean_ms * 1e3,
          'peak_mem_bytes': peak, 'logs': logs, 'card_vs_cpu_b1': cmp,
          'grad_tolerance': TRAIN_GRAD_REL_TOL,
          'hand_written_kernels_launched': 0,
          'reduced': [f'{SR_ZOO_STEPS} timed steps', 'one repeated batch of '
                      'synthetic images (DIV2K/OST sub-images in the YAML)',
                      'seeded weights and VGG19 (the YAML starts from '
                      'ESRGAN_PSNR_SRx4 and the torchvision VGG19)',
                      f'gt {ESRGAN_GT} (YAML 128, a discriminator this '
                      'repository lacks)']})

    def one_step():
        model.feed_data(batch)
        model.optimize_parameters(3 + SR_ZOO_STEPS)

    phase_profile('esrgan_train', one_step)
    del model
    torch.cuda.empty_cache()
    return launches


# torch.profiler's operators of a SwinIR step, by what they compute: the
# attention's two products are batched (bmm), the linears' plain (mm,
# addmm); forward and backward
SWINIR_OPS = {
    'attention_matmul': ('aten::bmm',),
    'attention_softmax': ('aten::_softmax', 'aten::_softmax_backward_data'),
    'linear_matmul': ('aten::mm', 'aten::addmm'),
    'layer_norm': ('aten::native_layer_norm',
                   'aten::native_layer_norm_backward'),
    'cudnn_conv': ('aten::cudnn_convolution',
                   'aten::convolution_backward'),
}


def _swinir_split(run):
    """``run()`` under torch.profiler (host and device): each operator's
    own device time (the kernels it launched itself; the kernels' own
    entries and annotations such as the optimizer's step range are left
    out, which would count those kernels twice), summed by ``SWINIR_OPS``,
    the rest as ``other``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    own = {}
    for event in prof.key_averages():
        if event.device_type != DeviceType.CPU \
                or getattr(event, 'is_user_annotation', False):
            continue
        us = getattr(event, 'self_device_time_total', None)
        us = event.self_cuda_time_total if us is None else us
        if us:
            own[event.key] = own.get(event.key, 0.) + us / 1e3
    split = {name: sum(own.get(op, 0.) for op in ops)
             for name, ops in SWINIR_OPS.items()}
    total = sum(own.values())
    split['other'] = total - sum(split.values())
    return {'device_ms_by_kind': split, 'device_ms': total,
            'top_ops': sorted(((ms, op) for op, ms in own.items()),
                              reverse=True)[:8]}


def _swinir_opt(dtype):
    train = {'ema_decay': 0.999,
             'optim_g': {'type': 'Adam', 'lr': 2e-4, 'weight_decay': 0,
                         'betas': [0.9, 0.99]},
             'scheduler': {'type': 'MultiStepLR',
                           'milestones': [250000, 400000, 450000, 475000],
                           'gamma': 0.5},
             'total_iter': 500000, 'warmup_iter': -1,
             'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0,
                           'reduction': 'mean'}}
    if dtype == BF16:
        train['mixed_precision'] = 'bfloat16'
    return {'name': 'swinir_train', 'model_type': 'SwinIRModel', 'scale': 4,
            'num_gpu': 1, 'manual_seed': SEED, 'is_train': True,
            'dist': False, 'network_g': dict(SWINIR_X4),
            'path': {'pretrain_network_g': None}, 'train': train}


def phase_swinir_train(kernels, dtype):
    """``SwinIRModel`` as the P48W8 scratch YAML: gt 192, B 4, L1, Adam
    2e-4, drop path 0.1 in training, ``dtype``. Two models from one seed
    give the same first loss; the second's drop path reseeded (another
    ``manual_seed`` after the build: the same weights) another. Then a
    warm-up, ``SR_ZOO_STEPS`` timed steps, peak memory, and one step's
    device time split among the attention, the linears, layer norm and
    cuDNN."""
    from mrefsr_tpu_torch.models import build_model
    batch = _sr_pairs(SEED + 52, SWINIR_B, SWINIR_GT)
    first = {}
    for key, seed in (('a', SEED), ('b', SEED), ('other_seed', SEED + 1)):
        model = build_model(_swinir_opt(dtype))
        model.opt['manual_seed'] = seed
        model.feed_data(batch)
        model.optimize_parameters(1)
        first[key] = model.get_current_log()['l_pix']
    check(first['a'] == first['b'] and first['other_seed'] != first['a'],
          f'swinir_train drop path not seeded: {first}')
    reset_counts(kernels)
    model.opt['manual_seed'] = SEED
    model.feed_data(batch)
    model.optimize_parameters(2)
    step_ms, logs, peak = _timed_steps(model, batch, 3, SR_ZOO_STEPS)
    launches = read_counts(kernels, ())
    check(not any(launches.values()), f'swinir_train launched {launches}')
    losses = [log['l_pix'] for log in logs]
    check(all(np.isfinite(losses)), f'swinir_train losses {losses}')

    def one_step():
        model.feed_data(batch)
        model.optimize_parameters(3 + SR_ZOO_STEPS)

    split = _swinir_split(one_step)
    mean_ms = statistics.mean(step_ms)
    emit({'phase': 'swinir_train', 'path': 'swinir_train'
          + ('_bf16' if dtype == BF16 else ''),
          'source': YAML_SOURCES['swinir_train'],
          'network_g': SWINIR_X4, 'train': _swinir_opt(dtype)['train'],
          'batch': SWINIR_B, 'gt': SWINIR_GT, 'dtype': str(dtype),
          'first_losses_by_seed': first, 'step_ms': step_ms,
          'mean_step_ms': mean_ms, 'img_per_s': SWINIR_B / mean_ms * 1e3,
          'peak_mem_bytes': peak, 'losses': losses, 'profile': split,
          'hand_written_kernels_launched': 0,
          'reduced': [f'{SR_ZOO_STEPS} timed steps, one repeated batch of '
                      'synthetic images (DIV2K sub-images in the YAML)',
                      'one card (the YAML: 8, B 4 each)']})
    del model
    torch.cuda.empty_cache()
    return launches


CLI_SISR_ITERS = 20
SISR_SCRIPTS = (
    # (module, network_g, param key of the .pth, arguments)
    ('inference_esrgan', RRDB_X4, 'params', ('--input', '{inp}', '--output',
                                             '{out}')),
    ('inference_swinir', SWINIR_X4, 'params_ema',
     ('--input', '{inp}', '--output', '{out}', '--task', 'classical_sr',
      '--scale', '4', '--patch_size', '48')),
    ('inference_ridnet', {'type': 'RIDNet', 'in_channels': 3,
                          'mid_channels': 64, 'out_channels': 3}, None,
     ('--test_path', '{rni}', '--noise_g', '25')))


def _sisr_data(root):
    """A MegaDepth-layout training set (16 smooth 256x256 PNGs in one
    scene, the annotation CSV), a Sun80 folder and a CUFED pair folder of
    2 images each, and the inference scripts' 2-image folders."""
    import csv
    import cv2
    md = os.path.join(root, 'md', '0001')
    os.makedirs(md)
    names = [f'{i:04d}.png' for i in range(16)]
    for name, img in zip(names, _smooth_clip(SEED + 53, 16, 256, 256)):
        cv2.imwrite(os.path.join(md, name), img)
    ann = os.path.join(root, 'md.csv')
    gen = np.random.RandomState(SEED + 54)
    with open(ann, 'w', newline='') as f:
        out = csv.writer(f)
        out.writerow(['target', 'H', 'M1', 'M2', 'L1', 'L2', 'p0', 'p1',
                      'p2', 'p3', 'p4', 'p5', 'scene'])
        for name in names:
            point = str([int(v) for v in gen.randint(80, 176, 2)])
            out.writerow([name] * 6 + [point] * 6 + ['0001'])
    folders = {'sun80': os.path.join(root, 'sun80',
                                     'Sun_Hays_SR_groundtruth'),
               'cufed_in': os.path.join(root, 'cufed', 'in'),
               'cufed_ref': os.path.join(root, 'cufed', 'ref'),
               'inp': os.path.join(root, 'sisr_in'),
               'rni': os.path.join(root, 'rni', 'X25')}
    for key, folder in folders.items():
        os.makedirs(folder)
        for i, (h, w) in enumerate(((120, 96), (92, 132))):
            img = _smooth_clip(SEED + 55 + i, 1, h, w)[0]
            ext = '.jpg' if key == 'sun80' else '.png'
            cv2.imwrite(os.path.join(folder, f'im{i}{ext}'), img)
    folders['rni'] = os.path.dirname(folders['rni'])
    folders['sun80'] = os.path.dirname(folders['sun80'])
    return md, ann, folders


def _cli_sisr_yml(root, md, ann, folders):
    """``_esrgan_opt`` as a YAML over ``SISRMegaDepthDataset`` (gt 160, B
    16, 4 loader threads), validating on ``SISRSun80Set`` and
    ``SISRCUFEDDataset`` at the end (PSNR). Returns its path."""
    import yaml
    opt = _esrgan_opt()
    doc = {'name': 'esrgan_sisr_cli', 'model_type': 'ESRGANModel',
           'scale': 4, 'num_gpu': 1, 'manual_seed': SEED,
           'datasets': {
               'train': {'name': 'md', 'type': 'SISRMegaDepthDataset',
                         'dataroot_in': os.path.dirname(md),
                         'dataroot_ref': os.path.dirname(md),
                         'ann_file': ann, 'gt_size': ESRGAN_GT,
                         'use_flip': True, 'use_rot': True,
                         'batch_size_per_gpu': ESRGAN_B,
                         'num_worker_per_gpu': 4,
                         'dataset_enlarge_ratio': 100},
               'val_1': {'name': 'Sun80', 'type': 'SISRSun80Set',
                         'dataroot_in': folders['sun80']},
               'val_2': {'name': 'CUFED', 'type': 'SISRCUFEDDataset',
                         'dataroot_in': folders['cufed_in'],
                         'dataroot_ref': folders['cufed_ref'],
                         'io_backend': {'type': 'disk'}}},
           'network_g': opt['network_g'], 'network_d': opt['network_d'],
           'path': {'pretrain_network_g': None, 'strict_load_g': True,
                    'resume_state': None, 'vgg_pretrain_path': None,
                    'experiments_root': os.path.join(root, 'experiments')},
           'train': dict(opt['train'], total_iter=CLI_SISR_ITERS),
           'val': {'val_freq': CLI_SISR_ITERS, 'save_img': False,
                   'metrics': {'psnr': {'type': 'calculate_psnr',
                                        'crop_border': 4,
                                        'test_y_channel': True}}},
           'logger': {'print_freq': 5, 'save_checkpoint_freq':
                      CLI_SISR_ITERS, 'use_tb_logger': False},
           'dist_params': {'backend': 'nccl', 'port': 29500}}
    path = os.path.join(root, 'esrgan_sisr_cli.yml')
    with open(path, 'w') as f:
        yaml.safe_dump(doc, f)
    return path


def _sisr_script_start(root, folders, module, net, key, argv):
    """Write a seeded reference-layout ``.pth`` of ``net`` and start
    ``python -m mrefsr_tpu_torch.inference.<module>`` on it in ``root``
    (RIDNet writes under the working directory's ``results/``)."""
    from mrefsr_tpu_torch.archs import build_network
    net = build_network(dict(net))
    net.init_weights(torch.Generator().manual_seed(SEED + 56))
    state = {k: v.contiguous() for k, v in net.state_dict().items()}
    pth = os.path.join(root, f'{module}.pth')
    torch.save(state if key is None else {key: state}, pth)
    out = os.path.join(root, f'{module}_out')
    args = [a.format(inp=folders['inp'], out=out, rni=folders['rni'])
            for a in argv] + ['--model_path', pth]
    log_path = os.path.join(root, f'{module}.log')
    log = open(log_path, 'w')
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    proc = subprocess.Popen(
        [sys.executable, '-m', f'mrefsr_tpu_torch.inference.{module}',
         *args], cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT,
        text=True)
    return proc, log, log_path, pth, args


def _sisr_script_check(root, module, started):
    """Wait for the script; then this process's net from the same file
    through the module's own ``build_model`` and ``inference``: every PNG
    the script wrote equal to this process's output bit for bit."""
    import cv2
    import importlib
    proc, log, log_path, pth, args = started
    t0 = time.perf_counter()
    rc, text = _cli_wait(proc, log, log_path)
    check(rc == 0, f'{module} exited {rc}:\n{text[-3000:]}')
    mod = importlib.import_module(f'mrefsr_tpu_torch.inference.{module}')
    parsed = mod.parse_args(args)
    if module == 'inference_swinir':
        kwargs = mod.model_kwargs(parsed)
        model = mod.build_model(mod.SwinIR, kwargs, pth, 'cuda',
                                param_key='params_ema')
        run = lambda img: mod.inference(  # noqa: E731
            img, model, kwargs['window_size'], kwargs['upscale'])
        pairs = [(p, os.path.join(parsed.output, os.path.splitext(
            os.path.basename(p))[0] + '_SwinIR.png'))
            for p in (_files(parsed.input))]
    elif module == 'inference_esrgan':
        model = mod.build_model(mod.RRDBNet, mod.NET_KWARGS, pth, 'cuda')
        run = lambda img: mod.inference(img, model)  # noqa: E731
        pairs = [(p, os.path.join(parsed.output, os.path.splitext(
            os.path.basename(p))[0] + '_ESRGAN.png'))
            for p in (_files(parsed.input))]
    else:
        model = mod.build_model(mod.RIDNet, mod.NET_KWARGS, pth, 'cuda',
                                param_key=None)
        run = lambda img: mod.inference(img, model)  # noqa: E731
        results = os.path.join(root, 'results', 'RIDNet',
                               os.path.basename(parsed.test_path))
        pairs = [(p, os.path.join(results, os.path.basename(p).split('.')[0]
                                  + '_x25_RIDNet.png'))
                 for p in (_files(os.path.join(
                     parsed.test_path, 'X25')))]
    check(len(pairs) == 2, f'{module}: inputs {pairs}')
    for src, written in pairs:
        # as the script reads it: RIDNet takes [0, 255]
        img = cv2.imread(src, cv2.IMREAD_COLOR).astype(np.float32)
        if module != 'inference_ridnet':
            img = img / 255.
        cli = cv2.imread(written, cv2.IMREAD_UNCHANGED)
        check(cli is not None and np.array_equal(cli, run(img)),
              f'{module} wrote another {written} than this process '
              'computed')
    del model
    return {'script': f'mrefsr_tpu_torch.inference.{module}',
            'images': len(pairs), 'pngs_bit_equal': True,
            'script_s_after_train': time.perf_counter() - t0}


def _files(folder):
    """The files of ``folder``, sorted."""
    return sorted(os.path.join(folder, n) for n in os.listdir(folder))


def phase_cli_sisr(kernels):
    """``cli_sisr``: the three SR inference scripts started as processes
    beside ``train_pipeline`` in this process running ``_cli_sisr_yml``
    for ``CLI_SISR_ITERS`` iterations; then the scripts' PNGs against
    this process's outputs. Returns the training run's launches (none)."""
    from mrefsr_tpu_torch.models.esrgan_model import ESRGANModel
    from mrefsr_tpu_torch.train import train_pipeline
    with tempfile.TemporaryDirectory() as root:
        md, ann, folders = _sisr_data(root)
        started = {module: _sisr_script_start(root, folders, module, net,
                                              key, argv)
                   for module, net, key, argv in SISR_SCRIPTS}
        yml = _cli_sisr_yml(root, md, ann, folders)
        model, _, launches, rec = _cli_train(
            train_pipeline, root, ['-opt', yml], kernels, ESRGAN_B, 5,
            CLI_SISR_ITERS, model_cls=ESRGANModel)
        check(not any(launches.values()), f'cli_sisr launched {launches}')
        psnr = {name: model.best_metric_results[name]['psnr']['val']
                for name in ('Sun80', 'CUFED')}
        check(all(np.isfinite(v) for v in psnr.values()),
              f'cli_sisr validation PSNR {psnr}')
        del model
        torch.cuda.empty_cache()
        scripts = [_sisr_script_check(root, module, started[module])
                   for module, _, _, _ in SISR_SCRIPTS]
    emit({'phase': 'cli_sisr', 'source': YAML_SOURCES['esrgan_train'],
          'iterations': CLI_SISR_ITERS, 'batch': ESRGAN_B, 'gt': ESRGAN_GT,
          'psnr_val': psnr, **{k: v for k, v in rec.items()
                               if k != 'losses_logged'},
          'scripts': scripts, 'hand_written_kernels_launched': 0,
          'reduced': [f'{CLI_SISR_ITERS} iterations (YAML 400000)',
                      '16 synthetic 256x256 images in the MegaDepth layout '
                      '(SISRCUFEDDataset gives empty training samples, as '
                      'the reference and the JAX package do)',
                      'validation on 2 synthetic images of each set']})
    return launches


def sr_zoo_phases(build_model, arch, correlation, dcn, kernels):
    """The SR zoo's phases: ``sr_zoo_serve``, ``esrgan_train``,
    ``swinir_train`` (f32, bf16) and ``cli_sisr``. Returns the launches
    by path (all none)."""
    by_path = {'sr_zoo_serve': phase_sr_zoo_serve(kernels)}
    torch.cuda.empty_cache()
    by_path['esrgan_train'] = phase_esrgan_train(kernels)
    torch.cuda.empty_cache()
    for dtype in (torch.float32, BF16):
        by_path['swinir_train' + ('_bf16' if dtype == BF16 else '')] = \
            phase_swinir_train(kernels, dtype)
        torch.cuda.empty_cache()
    by_path['cli_sisr'] = phase_cli_sisr(kernels)
    return by_path


# -------------------------------------------------------------- Real-ESRGAN
# Real-ESRGAN's two published configurations, as dicts: the degradations,
# the dataset's kernels, the nets and the train blocks of
# train_realesrgan_x4plus.yml / train_realesrnet_x4plus.yml. No kernel of
# this repository lies on their paths (checked): cuDNN convolutions (the
# nets, the blurs as grouped convolutions), cuBLAS products (the resize
# matrices, the JPEG DCT), ATen's element-wise and sampling passes.
YAML_SOURCES.update(
    realesrgan='Real-ESRGAN options/train_realesrgan_x4plus.yml',
    realesrnet='Real-ESRGAN options/train_realesrnet_x4plus.yml')
REALESR_DEGRADE = {
    'resize_prob': [0.2, 0.7, 0.1], 'resize_range': [0.15, 1.5],
    'gaussian_noise_prob': 0.5, 'noise_range': [1, 30],
    'poisson_scale_range': [0.05, 3], 'gray_noise_prob': 0.4,
    'jpeg_range': [30, 95], 'second_blur_prob': 0.8,
    'resize_prob2': [0.3, 0.4, 0.3], 'resize_range2': [0.3, 1.2],
    'gaussian_noise_prob2': 0.5, 'noise_range2': [1, 25],
    'poisson_scale_range2': [0.05, 2.5], 'gray_noise_prob2': 0.4,
    'jpeg_range2': [30, 95], 'gt_size': 256, 'queue_size': 180}
_KERNEL_LIST = ['iso', 'aniso', 'generalized_iso', 'generalized_aniso',
                'plateau_iso', 'plateau_aniso']
REALESR_KERNELS = {
    'blur_kernel_size': 21, 'kernel_list': _KERNEL_LIST,
    'kernel_prob': [0.45, 0.25, 0.12, 0.03, 0.12, 0.03], 'sinc_prob': 0.1,
    'blur_sigma': [0.2, 3], 'betag_range': [0.5, 4], 'betap_range': [1, 2],
    'blur_kernel_size2': 21, 'kernel_list2': _KERNEL_LIST,
    'kernel_prob2': [0.45, 0.25, 0.12, 0.03, 0.12, 0.03], 'sinc_prob2': 0.1,
    'blur_sigma2': [0.2, 1.5], 'betag_range2': [0.5, 4],
    'betap_range2': [1, 2], 'final_sinc_prob': 0.8}
UNET_D = {'type': 'UNetDiscriminatorSN', 'num_in_ch': 3, 'num_feat': 64,
          'skip_connection': True}
REALESR_PERCEPTUAL = {
    'type': 'PerceptualLoss',
    'layer_weights': {'conv1_2': 0.1, 'conv2_2': 0.1, 'conv3_4': 1,
                      'conv4_4': 1, 'conv5_4': 1},
    'vgg_type': 'vgg19', 'use_input_norm': True, 'perceptual_weight': 1.0,
    'style_weight': 0, 'range_norm': False, 'criterion': 'l1'}
LDL_OPT = {'type': 'L1Loss', 'loss_weight': 1.0, 'reduction': 'mean'}
# the per-GPU batch, the dataset's crop_pad_size, the timed steps and the
# gt of the card-against-CPU checks at B 1 (the CPU's share of the time)
REALESR_B, REALESR_PAD, REALESR_STEPS, REALESR_CPU_GT = 12, 400, 3, 64
REALESR_IMAGES = 24
# The synthesis on the card against the CPU under deterministic noise, B 2,
# gt 400: JPEG rounds each DCT coefficient, so a coefficient that lies at a
# rounding tie within the two devices' difference (about 1e-6) moves its
# whole 8 x 8 block; the last rounding to 8-bit levels moves one pixel.
# Held: the share of entries more than SYNTH_PRE_TOL apart before the last
# rounding, and of entries a level or more apart after it.
SYNTH_PRE_TOL, SYNTH_PRE_SHARE, SYNTH_LEVEL_SHARE = 1e-5, 1e-3, 1e-3
# a bf16 RealESRNet step, card against CPU (the CPU's bf16 convs sum in f32
# and round once, cuDNN's otherwise): the pixel loss's gradients, each
# tensor's worst entry as a share of its largest (measured, H100, the first
# run: worst 0.0288, 3.7 EPS_BF16, median 0.0050), and the logged loss
# (2.5e-4)
REALESR_BF16_GRAD_TOL, REALESR_BF16_LOSS_TOL = 8 * EPS_BF16, 2 * EPS_BF16
# a parameter after one Adam step, card against CPU, in lr: an entry whose
# gradient has another sign on the two devices moves lr one way and lr the
# other (measured up to 1.9998 lr), plus the rounding of an f32 parameter
REALESR_STEP_LR_TOL = 2.001


def _realesr_opt(kind, dtype=torch.float32, ldl=False, gt=None):
    """``realesrnet`` or ``realesrgan`` as the published YAMLs (the module
    note above), at ``dtype`` (RealESRNet) and with LDL where asked; a
    seeded VGG19 and seeded nets (the YAMLs start from ESRGAN's and
    RealESRNet's checkpoints)."""
    opt = {'name': f'{kind}_train', 'scale': 4, 'num_gpu': 1,
           'manual_seed': SEED, 'is_train': True, 'dist': False,
           **REALESR_DEGRADE, 'network_g': dict(RRDB_X4),
           'path': {'pretrain_network_g': None, 'vgg_pretrain_path': None}}
    if gt:
        opt['gt_size'] = gt
    adam = {'type': 'Adam', 'weight_decay': 0, 'betas': [0.9, 0.99]}
    pixel = {'type': 'L1Loss', 'loss_weight': 1.0, 'reduction': 'mean'}
    if kind == 'realesrnet':
        opt.update(model_type='RealESRNetModel', gt_usm=True)
        opt['train'] = {'ema_decay': 0.999, 'optim_g': dict(adam, lr=2e-4),
                        'scheduler': {'type': 'MultiStepLR',
                                      'milestones': [1000000], 'gamma': 0.5},
                        'total_iter': 1000000, 'warmup_iter': -1,
                        'pixel_opt': pixel}
        if dtype == BF16:
            opt['train']['mixed_precision'] = 'bfloat16'
        return opt
    opt.update(model_type='RealESRGANModel', l1_gt_usm=True,
               percep_gt_usm=True, gan_gt_usm=False, network_d=dict(UNET_D))
    opt['train'] = {'ema_decay': 0.999, 'optim_g': dict(adam, lr=1e-4),
                    'optim_d': dict(adam, lr=1e-4),
                    'scheduler': {'type': 'MultiStepLR',
                                  'milestones': [400000], 'gamma': 0.5},
                    'total_iter': 400000, 'warmup_iter': -1,
                    'pixel_opt': pixel,
                    'perceptual_opt': dict(REALESR_PERCEPTUAL),
                    'gan_opt': {'type': 'GANLoss', 'gan_type': 'vanilla',
                                'real_label_val': 1.0, 'fake_label_val': 0.0,
                                'loss_weight': 1e-1},
                    'net_d_iters': 1, 'net_d_init_iters': 0}
    if ldl:
        opt['train']['ldl_opt'] = dict(LDL_OPT)
    return opt


def _realesr_dataset_opt(folder):
    return {'name': 'DF2K_OST_synthetic', 'type': 'RealESRGANDataset',
            'dataroot_gt': folder, 'io_backend': {'type': 'disk'},
            'use_hflip': True, 'use_rot': False,
            'crop_pad_size': REALESR_PAD, **REALESR_KERNELS,
            'batch_size_per_gpu': REALESR_B, 'num_worker_per_gpu': 4,
            'dataset_enlarge_ratio': 1}


def _realesr_data(root):
    """``REALESR_IMAGES`` smooth seeded 400x400 PNGs (the training set)
    and two 256x256 gt / 64x64 lq pairs (validation)."""
    import cv2
    folders = {k: os.path.join(root, k) for k in ('hr', 'val_gt', 'val_lq')}
    for folder in folders.values():
        os.makedirs(folder)
    for i, img in enumerate(_smooth_clip(SEED + 60, REALESR_IMAGES,
                                         REALESR_PAD, REALESR_PAD)):
        cv2.imwrite(os.path.join(folders['hr'], f'{i:04d}.png'), img)
    for i in range(2):
        img = _smooth_clip(SEED + 61 + i, 1, 256, 256)[0]
        cv2.imwrite(os.path.join(folders['val_gt'], f'v{i}.png'), img)
        cv2.imwrite(os.path.join(folders['val_lq'], f'v{i}.png'),
                    cv2.resize(img, (64, 64), interpolation=cv2.INTER_AREA))
    return folders


def _on_card(batch):
    """A collated batch's arrays as tensors on the card (a device
    prefetcher's batch)."""
    return {k: torch.from_numpy(v).cuda() if isinstance(v, np.ndarray)
            else v for k, v in batch.items()}


def _synth_card_vs_cpu(batch):
    """The synthesis under deterministic noise (``noise_range`` /
    ``poisson_scale_range`` [0, 0], one JPEG quality a stage) at B 2 on
    the card and on the CPU, two plans drawn on the host and set to cover
    both orders of the last resize and JPEG and both noise families."""
    from mrefsr_tpu_torch.models.degradation_synth import \
        DegradationSynthesizer
    det = dict(REALESR_DEGRADE, scale=4, noise_range=[0, 0],
               noise_range2=[0, 0], poisson_scale_range=[0, 0],
               poisson_scale_range2=[0, 0], jpeg_range=[70, 70],
               jpeg_range2=[45, 45])
    card = DegradationSynthesizer(det, 'cuda', SEED)
    cpu = DegradationSynthesizer(det, 'cpu', SEED)
    inputs = [torch.from_numpy(batch[k][:2]) for k in ('gt', 'kernel1',
                                                       'kernel2',
                                                       'sinc_kernel')]
    records = []
    for first, gaussian in ((True, True), (False, False)):
        plan = dict(card.draw(), resize_first=first, second_blur=True,
                    noise1_gaussian=gaussian, noise2_gaussian=not gaussian)
        usm_c, pre_c = card.degrade(*(x.cuda() for x in inputs), plan=plan)
        usm_p, pre_p = cpu.degrade(*inputs, plan=plan)
        pre = (pre_c.clamp(0, 1).cpu() - pre_p.clamp(0, 1)).abs()
        levels = ((torch.round(pre_c.cpu() * 255).clamp(0, 255)
                   - torch.round(pre_p * 255).clamp(0, 255)).abs())
        records.append({
            'resize_first': first, 'noise1_gaussian': gaussian,
            'modes': [plan[f'mode{i}'] for i in (1, 2, 3)],
            'scales': [plan['s1'], plan['s2']],
            'gt_usm_max_abs_diff': float((usm_c.cpu() - usm_p).abs().max()),
            'pre_round_max_abs_diff': float(pre.max()),
            'pre_round_share_over_tol': float((pre > SYNTH_PRE_TOL).float()
                                              .mean()),
            'lq_share_one_level_or_more': float((levels > 0).float().mean()),
            'lq_max_levels_apart': float(levels.max())})
    for rec in records:
        check(rec['gt_usm_max_abs_diff'] <= SYNTH_PRE_TOL
              and rec['pre_round_share_over_tol'] <= SYNTH_PRE_SHARE
              and rec['lq_share_one_level_or_more'] <= SYNTH_LEVEL_SHARE,
              f'the synthesis on the card and the CPU differ: {records}')
    return {'cases': records, 'pre_round_tol': SYNTH_PRE_TOL,
            'pre_round_share_tol': SYNTH_PRE_SHARE,
            'lq_level_share_tol': SYNTH_LEVEL_SHARE}


def phase_realesrgan_synth(kernels, model, folders):
    """``realesrgan_synth``: a ``RealESRGANDataset`` batch (B 12, 400x400,
    the published kernels) timed on the host; the synthesizer's host draws
    and matrices timed alone; ``model.feed_data`` (synthesis, crop, pool,
    the swapped gt sharpened) with the batch on the card, after 15 calls
    that fill the pool of 180: host ms with a sync and device ms; then the
    card's synthesis against the CPU's (:func:`_synth_card_vs_cpu`).
    Returns the batch and the launches (none)."""
    from mrefsr_tpu_torch.data import build_dataset, default_collate
    dataset = build_dataset(_realesr_dataset_opt(folders['hr']), seed=SEED)
    batch_ms = []
    for rnd in range(2):
        t0 = time.perf_counter()
        batch = default_collate([dataset[rnd * REALESR_B + i]
                                 for i in range(REALESR_B)])
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    draws = []
    for _ in range(20):
        t0 = time.perf_counter()
        model.synth.host_inputs(model.synth.draw(), REALESR_PAD, REALESR_PAD)
        draws.append((time.perf_counter() - t0) * 1e3)
    on_card = _on_card(batch)
    reset_counts(kernels)
    fill = REALESR_DEGRADE['queue_size'] // REALESR_B
    for _ in range(fill):
        model.feed_data(on_card)
    torch.cuda.synchronize()
    check(model.pool.queue_ptr == model.pool.queue_size,
          f'the pool holds {model.pool.queue_ptr} pairs after {fill} calls')
    feed_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.feed_data(on_card)
        torch.cuda.synchronize()
        feed_ms.append((time.perf_counter() - t0) * 1e3)
    feed_device = device_ms_each([lambda: model.feed_data(on_card)],
                                 runs=3)[0]
    launches = read_counts(kernels, ())
    check(not any(launches.values()), f'realesrgan_synth launched {launches}')
    gt = REALESR_DEGRADE['gt_size']
    check(tuple(model.lq.shape) == (REALESR_B, gt // 4, gt // 4, 3)
          and tuple(model.gt_usm.shape) == (REALESR_B, gt, gt, 3)
          and bool(torch.isfinite(model.lq).all()),
          f'feed_data gave lq {tuple(model.lq.shape)}')
    cmp = _synth_card_vs_cpu(batch)
    emit({'phase': 'realesrgan_synth', 'source': YAML_SOURCES['realesrgan'],
          'degradations': REALESR_DEGRADE, 'kernels': REALESR_KERNELS,
          'batch': REALESR_B, 'crop_pad_size': REALESR_PAD, 'gt': gt,
          'dataset_batch_host_ms': batch_ms,
          'synth_host_draws_ms': statistics.mean(draws),
          'feed_data_ms': feed_ms, 'feed_data_device_ms': feed_device,
          'pool_bytes': sum(t.numel() * t.element_size() for t in
                            (model.pool.queue_lr, model.pool.queue_gt)),
          'card_vs_cpu_b2': cmp, 'hand_written_kernels_launched': 0,
          'reduced': [f'{REALESR_IMAGES} smooth synthetic 400x400 images '
                      '(DF2K and OST in the YAML)',
                      'five timed calls, on one repeated batch']})
    return batch, launches


def _pixel_grads_at(model):
    """``net_g``'s gradients of the pixel loss alone at the model's
    training dtype, by name, on the CPU."""
    model.net_g.zero_grad(set_to_none=True)
    out = model._run(model.net_g, model.train_dtype, False, model.lq)
    model.cri_pix(out, model._train_step_inputs()[1]
                  if hasattr(model, '_train_step_inputs') else model.gt) \
        .backward()
    grads = {n: p.grad.cpu() for n, p in model.net_g.named_parameters()}
    model.net_g.zero_grad(set_to_none=True)
    return grads


def _realesr_card_vs_cpu(kind, batch, dtype=torch.float32, ldl=False):
    """One step at B 1, gt ``REALESR_CPU_GT``, on the card and on the CPU
    from the same seeded weights, on the pair the card's ``feed_data``
    synthesised (given to the CPU model as it is). Held, as
    ``esrgan_train``'s: the pixel loss's gradients
    (``TRAIN_GRAD_REL_TOL``, ``REALESR_BF16_GRAD_TOL`` at bf16), the
    logged terms (``SR_ZOO_LOSS_TOL``, ``REALESR_BF16_LOSS_TOL``), each
    net's parameters after the step within ``REALESR_STEP_LR_TOL`` lr of
    the CPU's with 99 % of the entries within lr / 10, and the
    discriminator's ``u`` / ``v`` (``SR_ZOO_CPU_TOL``)."""
    from mrefsr_tpu_torch.models import build_model
    opt = _realesr_opt(kind, dtype, ldl, gt=REALESR_CPU_GT)
    models = {dev: build_model(opt, device=dev) for dev in ('cuda', 'cpu')}
    models['cuda'].feed_data(_on_card({k: v[:1] for k, v in batch.items()
                                       if isinstance(v, np.ndarray)}))
    for key in ('lq', 'gt', 'gt_usm'):
        value = getattr(models['cuda'], key, None)
        if value is not None:
            setattr(models['cpu'], key, value.cpu())
    bf16 = dtype == BF16
    pixel = _rel_grad_errors(_pixel_grads_at(models['cuda']),
                             _pixel_grads_at(models['cpu']))
    _check_grad_errors(f'{kind} pixel loss, card against CPU', pixel,
                       REALESR_BF16_GRAD_TOL if bf16 else TRAIN_GRAD_REL_TOL)
    logs = {}
    for dev, model in models.items():
        model.optimize_parameters(1)
        logs[dev] = model.get_current_log()
    loss_err = max(abs(logs['cuda'][k] - v) / max(abs(v), 1e-12)
                   for k, v in logs['cpu'].items())
    check(loss_err <= (REALESR_BF16_LOSS_TOL if bf16 else SR_ZOO_LOSS_TOL),
          f'{kind} logs {logs}')
    lr = opt['train']['optim_g']['lr']
    params, uv_err = {}, 0.
    nets = ('net_g', 'net_d') if kind == 'realesrgan' else ('net_g',)
    for net in nets:
        card = getattr(models['cuda'], net).state_dict()
        worst, near, count = 0., 0, 0
        for key, val in getattr(models['cpu'], net).state_dict().items():
            diff = (card[key].cpu().double() - val.double()).abs()
            if key.endswith(('weight_u', 'weight_v')):
                uv_err = max(uv_err, float(diff.max() / val.abs().max()))
                continue
            worst = max(worst, float(diff.max()) / lr)
            near += int((diff <= lr / 10).sum())
            count += diff.numel()
        params[net] = {'max_diff_in_lr': worst,
                       'share_within_lr_10th': near / count}
        check(worst <= REALESR_STEP_LR_TOL and near / count >= 0.99,
              f'{kind} {net} after a step: {params[net]}')
    check(uv_err <= SR_ZOO_CPU_TOL, f'{kind} u / v differ by {uv_err}')
    del models
    return {'gt': REALESR_CPU_GT, 'ldl': ldl, 'pixel_grads': pixel,
            'logs': logs, 'logs_rel_err': loss_err, 'params': params,
            'uv_rel_err': uv_err if kind == 'realesrgan' else None}


def _realesr_split(model, batch):
    """One step's time by part, each part run alone between two CUDA
    events (the median of two runs after a warm-up; host time in it): the
    synthesis (``feed_data``: synthesis, crop, pool), G (``net_g``'s
    forward and the pixel loss's backward, at the step's dtype), and for
    the GAN the VGG (the perceptual loss's forward and backward to the
    output) and D (the generator's GAN term and the discriminator's two
    passes, forward and backward); then the whole step (``feed_data`` and
    ``optimize_parameters``) under torch.profiler: its device busy time,
    wall time, idle share and top kernels (:func:`profile_record`)."""
    gan = hasattr(model, 'net_d')
    on_card = _on_card(batch)
    model.feed_data(on_card)
    lq, gt_pix, gt_percep = model._train_step_inputs()[:3] if gan \
        else (model.lq, model.gt, model.gt)

    def net_g():
        model.net_g.zero_grad(set_to_none=True)
        out = model._run(model.net_g, model.train_dtype, False, lq)
        model.cri_pix(out, gt_pix).backward()

    with torch.no_grad():
        output = model._run(model.net_g, torch.float32, False, lq)
    parts = {'synthesis': lambda: model.feed_data(on_card), 'G': net_g}
    if gan:
        def vgg():
            leaf = output.clone().requires_grad_(True)
            percep, _ = model.cri_perceptual(leaf, gt_percep)
            percep.backward()

        def net_d():
            model.net_d.zero_grad(set_to_none=True)
            leaf = output.clone().requires_grad_(True)
            model.g_gan_loss(leaf).backward()
            model.net_d.requires_grad_(True)
            d = model.d_losses(output)
            (d['l_d_real'] + d['l_d_fake']).backward()
            model.net_d.requires_grad_(False)

        parts.update(VGG=vgg, D=net_d)
    split = dict(zip(parts, cuda_ms_each(list(parts.values()), reps=2)))
    model.net_g.zero_grad(set_to_none=True)
    if gan:
        model.net_d.zero_grad(set_to_none=True)

    def step():
        model.feed_data(on_card)
        model.optimize_parameters(100)

    whole = profile_record('step', step)
    return {'ms_by_part': split, 'step_device_busy_ms':
            whole['device_busy_ms'], 'step_wall_ms': whole['wall_ms'],
            'step_device_idle_share': whole['device_idle_share'],
            'top_kernels': whole['top_kernels'][:6]}


def phase_realesr_train(kind, kernels, model, batch, dtype=torch.float32):
    """``realesrnet_train`` (f32, bf16) or ``realesrgan_train`` (f32; with
    LDL in its card-against-CPU check only, as the published YAML trains
    without it): the card against the CPU on one step at B 1
    (:func:`_realesr_card_vs_cpu`), then at B 12, gt 256: the pool filled
    by ``feed_data`` alone, two warm-ups and ``REALESR_STEPS`` timed steps
    (``feed_data`` and ``optimize_parameters``: the mixing ones), peak
    memory, and the device time by part (:func:`_realesr_split`)."""
    bf16 = dtype == BF16
    tag = f'{kind}_train' + ('_bf16' if bf16 else '')
    cmp = [_realesr_card_vs_cpu(kind, batch, dtype)]
    if kind == 'realesrgan':
        cmp.append(_realesr_card_vs_cpu(kind, batch, dtype, ldl=True))
    on_card = _on_card(batch)
    reset_counts(kernels)
    while model.pool.queue_ptr < model.pool.queue_size:
        model.feed_data(on_card)
    for step in (1, 2):
        model.feed_data(on_card)
        model.optimize_parameters(step)
    step_ms, logs, peak = _timed_steps(model, on_card, 3, REALESR_STEPS)
    launches = read_counts(kernels, ())
    check(not any(launches.values()), f'{tag} launched {launches}')
    check(all(np.isfinite(v) for log in logs for v in log.values()),
          f'non-finite {tag} terms: {logs}')
    split = _realesr_split(model, batch)
    mean_ms = statistics.mean(step_ms)
    opt = _realesr_opt(kind, dtype)
    emit({'phase': f'{kind}_train', 'path': tag,
          'source': YAML_SOURCES[kind], 'network_g': opt['network_g'],
          'network_d': opt.get('network_d'), 'train': opt['train'],
          'batch': REALESR_B, 'gt': opt['gt_size'], 'dtype': str(dtype),
          'step_ms': step_ms, 'mean_step_ms': mean_ms,
          'img_per_s': REALESR_B / mean_ms * 1e3, 'peak_mem_bytes': peak,
          'logs': logs, 'profile': split, 'card_vs_cpu_b1': cmp,
          'hand_written_kernels_launched': 0,
          'reduced': [f'{REALESR_STEPS} timed steps on one repeated batch '
                      'of synthetic images (DF2K and OST in the YAML)',
                      'seeded weights and VGG19 (the YAML starts from '
                      + ('ESRGAN_SRx4_DF2KOST_official' if kind ==
                         'realesrnet' else 'RealESRNet_x4plus')
                      + ' and the torchvision VGG19)',
                      f'the card-against-CPU step at B 1, gt '
                      f'{REALESR_CPU_GT}']})
    return launches


def _cli_realesrgan_yml(root, folders):
    """``_realesr_opt('realesrgan')`` as a YAML over the PNG folder
    (``RealESRGANDataset``, B 12, 4 loader threads), ``CLI_REALESR_ITERS``
    iterations, validating on a ``RealESRGANPairedDataset`` folder at the
    end (PSNR). Returns its path."""
    import yaml
    doc = _realesr_opt('realesrgan')
    doc.update(name='realesrgan_cli', datasets={
        'train': dict(_realesr_dataset_opt(folders['hr']), phase='train'),
        'val': {'name': 'pairs', 'type': 'RealESRGANPairedDataset',
                'dataroot_gt': folders['val_gt'],
                'dataroot_lq': folders['val_lq'],
                'io_backend': {'type': 'disk'}}},
        path={'pretrain_network_g': None, 'strict_load_g': True,
              'resume_state': None, 'vgg_pretrain_path': None,
              'experiments_root': os.path.join(root, 'experiments')},
        val={'val_freq': CLI_REALESR_ITERS, 'save_img': False,
             'metrics': {'psnr': {'type': 'calculate_psnr',
                                  'crop_border': 4,
                                  'test_y_channel': False}}},
        logger={'print_freq': 5, 'save_checkpoint_freq': CLI_REALESR_ITERS,
                'use_tb_logger': False},
        dist_params={'backend': 'nccl', 'port': 29500})
    doc['train']['total_iter'] = CLI_REALESR_ITERS
    doc.pop('is_train')
    doc.pop('dist')
    path = os.path.join(root, 'realesrgan_cli.yml')
    with open(path, 'w') as f:
        yaml.safe_dump(doc, f)
    return path


CLI_REALESR_ITERS = 10


def phase_cli_realesrgan(kernels, root, folders):
    """``cli_realesrgan``: ``_cli_realesrgan_yml`` through
    ``train_pipeline`` in this process, the loader on the PNG folder; the
    validation's PSNR finite, no kernel launched. The pool of 180 does not
    fill in 10 iterations: every batch passes through it."""
    from mrefsr_tpu_torch.models.realesrgan_model import RealESRGANModel
    from mrefsr_tpu_torch.train import train_pipeline
    yml = _cli_realesrgan_yml(root, folders)
    model, _, launches, rec = _cli_train(
        train_pipeline, root, ['-opt', yml], kernels, REALESR_B, 5,
        CLI_REALESR_ITERS, model_cls=RealESRGANModel)
    check(not any(launches.values()), f'cli_realesrgan launched {launches}')
    psnr = model.best_metric_results['pairs']['psnr']['val']
    check(np.isfinite(psnr), f'cli_realesrgan validation PSNR {psnr}')
    del model
    torch.cuda.empty_cache()
    emit({'phase': 'cli_realesrgan', 'source': YAML_SOURCES['realesrgan'],
          'iterations': CLI_REALESR_ITERS, 'batch': REALESR_B,
          'gt': REALESR_DEGRADE['gt_size'], 'psnr_val': psnr,
          **{k: v for k, v in rec.items() if k != 'losses_logged'},
          'hand_written_kernels_launched': 0,
          'reduced': [f'{CLI_REALESR_ITERS} iterations (YAML 400000): the '
                      'pool of 180 does not fill',
                      f'{REALESR_IMAGES} synthetic 400x400 images',
                      'validation on 2 synthetic pairs']})
    return launches


def realesrgan_phases(build_model, arch, correlation, dcn, kernels):
    """Real-ESRGAN's phases: ``realesrgan_synth``, ``realesrnet_train``
    (f32, bf16), ``realesrgan_train`` and ``cli_realesrgan``. Returns the
    launches by path (all none)."""
    by_path = {}
    with tempfile.TemporaryDirectory() as root:
        folders = _realesr_data(root)
        model = build_model(_realesr_opt('realesrgan'))
        batch, by_path['realesrgan_synth'] = phase_realesrgan_synth(
            kernels, model, folders)
        by_path['realesrgan_train'] = phase_realesr_train(
            'realesrgan', kernels, model, batch)
        del model
        torch.cuda.empty_cache()
        for dtype in (torch.float32, BF16):
            model = build_model(_realesr_opt('realesrnet', dtype))
            by_path['realesrnet_train' + ('_bf16' if dtype == BF16
                                          else '')] = phase_realesr_train(
                'realesrnet', kernels, model, batch, dtype)
            del model
            torch.cuda.empty_cache()
        by_path['cli_realesrgan'] = phase_cli_realesrgan(kernels, root,
                                                         folders)
    return by_path


# ---------------------------------------------------------- the face family
# HiFaceGAN at the JAX package's defaults (hifacegan_arch.py:35-43: num_feat
# 64, crop 512, spectral SPADE with sync-batch (an instance norm on one
# card), init_train_phase 3) and its discriminator's (:147-154); the
# reference's training YAML is not in the repository: the losses are L1,
# hinge MultiScaleGANLoss and GANFeatLoss 10 (pix2pixHD's weight), the
# rates the JAX package's own HiFaceGAN test's (1e-4 / 4e-4)
HIFACEGAN = {'type': 'HiFaceGAN', 'num_in_ch': 3, 'num_feat': 64,
             'use_vae': False, 'z_dim': 256, 'crop_size': 512,
             'norm_g': 'spectralspadesyncbatch3x3', 'is_train': True,
             'init_train_phase': 3}
HIFACEGAN_D = {'type': 'HiFaceGANDiscriminator', 'num_in_ch': 3,
               'num_out_ch': 3, 'conditional_d': True, 'num_d': 2,
               'n_layers_d': 4, 'num_feat': 64, 'norm_d': 'spectralinstance',
               'keep_features': True}
# the card-against-CPU checks' widths (crop 64: maps of 2 x 2 at the bottom)
HIFACEGAN_SMALL = {'num_feat': 8, 'crop_size': 64}
HIFACEGAN_D_SMALL = {'num_feat': 8, 'n_layers_d': 3}
# B 4 a step at 512 x 512: the reference trains on one 512 face a card
# (its YAML is not here); 4 keeps a step under a second and the phase
# inside its share of the script's time limit
FACE_B, FACE_STEPS, FACE_SIDE = 4, 3, 512
# card against CPU, as a share of the CPU tensor's largest entry: outputs
# and u / v (SR_ZOO_CPU_TOL), the step's gradients by tensor
# (TRAIN_GRAD_REL_TOL, median and worst) but for those of exactly zero (a
# conv's bias ahead of an instance norm: the CPU's f64 gradient within
# ZERO_GRAD_SHARE of the net's largest), whose rounding is held to
# ZERO_GRAD_TOL of the net's largest gradient, the logged terms relative.
# Measured (H100, 700 W): G worst 1.5e-5, median 4.0e-6 (the CPU's own f32
# against f64: 2.5e-5, 3.7e-6); D 4.8e-6; the zero ones 2.6e-8 of the
# largest; the logs 1.5e-7; u / v 4.0e-7. Before G's LIP pools and D's
# pool between scales took arch_util.avg_pool2d (a contiguous copy: the
# CUDA pool's backward for channels-last inputs is wrong in this PyTorch),
# G's median was 0.16 and its zero ones 2.5e-3.
FACE_LOSS_TOL, ZERO_GRAD_SHARE, ZERO_GRAD_TOL = 1e-4, 1e-9, 1e-6
# bf16 eval against f32, the mean absolute difference of outputs in [-1, 1]
# (measured, H100: 0.0022, the largest 0.054)
FACE_BF16_MEAN_TOL = 2 * EPS_BF16
# DFDNet's seeded dictionary: atoms a part and scale, K = 512 as in the
# DFDNet paper (Li et al., ECCV 2020, section 3.1: K-means centres of each
# component at each scale, whence the published DictionaryCenter512's name;
# the file is not in the repository, so its shapes were not read), each
# part's side in 512-space (eyes 80, nose 96, mouth 128), the atom planted
# as each part's own VGG features, and the least lead of its score over the
# second, as a share of its score (tests/test_torch_dfdnet.py's GAP_SHARE)
DFD_ATOMS, DFD_PLANTED, DFD_GAP_SHARE = 512, 1, 1e-3
DFD_SIDES = {'left_eye': 80, 'right_eye': 80, 'nose': 96, 'mouth': 128}
# cli_stylegan2: _sg2_train_opt through the CLI on FFHQDataset, 8 iterations
# (path penalty at 4 and 8), then --auto_resume to 12
SG2_CLI_IMAGES, SG2_CLI_ITERS, SG2_CLI_RESUME = 64, 8, 12
# face_metrics: Inception features of 64 images at 299 x 299 (the first 8
# against the CPU), LPIPS on 16 pairs at 256 x 256 (the first 4 against
# the CPU), NIQE of one 512 x 512 image on the host
FID_IMAGES, FID_CPU, LPIPS_PAIRS, LPIPS_CPU = 64, 8, 16, 4


def _face_images(seed, b, side):
    """``b`` smooth seeded RGB images (b, side, side, 3) in [0, 1], as
    float32 numpy."""
    gen = torch.Generator().manual_seed(seed)
    low = torch.rand((b, 3, side // 16 + 4, side // 16 + 4), generator=gen)
    img = torch.nn.functional.interpolate(low, size=(side, side),
                                          mode='bicubic',
                                          align_corners=False).clamp(0, 1)
    return np.ascontiguousarray(img.permute(0, 2, 3, 1).numpy())


def _face_pairs(seed, b, side):
    """``{'lq', 'gt'}``: smooth faces and their degraded copies (a 4x
    average-pool blur, noise of sigma 0.05), NHWC float32."""
    gt = _face_images(seed, b, side)
    t = torch.from_numpy(gt).permute(0, 3, 1, 2)
    blur = torch.nn.functional.interpolate(
        torch.nn.functional.avg_pool2d(t, 4), scale_factor=4,
        mode='bilinear', align_corners=False)
    noise = torch.randn(blur.shape,
                        generator=torch.Generator().manual_seed(seed + 1))
    lq = (blur + 0.05 * noise).clamp(0, 1).permute(0, 2, 3, 1).numpy()
    return {'lq': np.ascontiguousarray(lq), 'gt': gt}


def _hifacegan_opt(is_train, small=False, dtype=torch.float32):
    net_g = dict(HIFACEGAN, **(HIFACEGAN_SMALL if small else {}))
    opt = {'name': 'hifacegan', 'model_type': 'HiFaceGANModel', 'scale': 1,
           'num_gpu': 1, 'manual_seed': SEED, 'is_train': is_train,
           'dist': False, 'network_g': net_g, 'path': {},
           'val': {'mixed_precision': 'bfloat16'} if dtype == BF16 else {}}
    if is_train:
        opt['network_d'] = dict(HIFACEGAN_D,
                                **(HIFACEGAN_D_SMALL if small else {}))
        opt['train'] = {
            'optim_g': {'type': 'Adam', 'lr': 1e-4, 'betas': [0.9, 0.99]},
            'optim_d': {'type': 'Adam', 'lr': 4e-4, 'betas': [0.9, 0.99]},
            'scheduler': {'type': 'MultiStepLR', 'milestones': [100000],
                          'gamma': 0.5},
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0,
                          'reduction': 'mean'},
            'gan_opt': {'type': 'MultiScaleGANLoss', 'gan_type': 'hinge',
                        'loss_weight': 1.0},
            'feature_matching_opt': {'type': 'GANFeatLoss',
                                     'criterion': 'l1', 'loss_weight': 10.0},
            'net_d_iters': 1, 'net_d_init_iters': 1,
            'total_iter': 100000, 'warmup_iter': -1}
    return opt


def _vectors_rel_err(card, cpu):
    """The largest difference of the spectral-norm vectors of two nets, as
    a share of each vector's largest entry."""
    a, b = card.state_dict(), cpu.state_dict()
    return max(float((a[k].cpu() - v).abs().max() / v.abs().max())
               for k, v in b.items() if k.endswith(('weight_u', 'weight_v')))


def _hifacegan_grads(dev, batch, cudnn=True, dtype=torch.float32):
    """One G turn (iteration 2) of the small HiFaceGAN on ``dev`` in
    ``dtype``: the log, every G and D gradient by name (the step leaves
    them in ``.grad``), and the model."""
    from mrefsr_tpu_torch.models import build_model
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
        model = build_model(_hifacegan_opt(True, small=True), device=dev)
        model.feed_data(batch)
        if dtype == torch.float64:
            model.net_g.double()
            model.net_d.double()
            model.lq, model.gt = model.lq.double(), model.gt.double()
            model._run = lambda net, dt, cached, x: net(
                x.movedim(-1, -3)).movedim(-3, -1)
        model.optimize_parameters(2)
    finally:
        torch.backends.cudnn.enabled = before
    grads = {net: {n: p.grad.detach().double().cpu() for n, p in
                   getattr(model, net).named_parameters()}
             for net in ('net_g', 'net_d')}
    return model.get_current_log(), grads, model


def _split_grad_errors(got, want, exact):
    """``got`` against ``want`` (:func:`_rel_grad_errors`) over the tensors
    whose gradient ``exact`` (the CPU's in f64) is not zero; a conv's bias
    ahead of an instance norm has a gradient of exactly zero, where each
    device keeps the rounding of a sum that cancels: those are given apart
    as their largest entry on either device, a share of the net's largest
    gradient."""
    top = max(float(v.abs().max()) for v in exact.values())
    zero = {k for k, v in exact.items()
            if float(v.abs().max()) <= ZERO_GRAD_SHARE * top}
    rec = _rel_grad_errors({k: v for k, v in got.items() if k not in zero},
                           {k: v for k, v in want.items() if k not in zero})
    rec.update(zero_by_construction=len(zero), zero_largest_share=max(
        (max(float(got[k].abs().max()), float(want[k].abs().max())) / top
         for k in zero), default=0.))
    return rec


def _hifacegan_card_vs_cpu():
    """One G turn (iteration 2) at ``HIFACEGAN_SMALL``, B 1, on the card and
    on the CPU from the same seeded weights: the logged terms, every G and
    D gradient by name (:func:`_split_grad_errors`), both nets' ``u`` /
    ``v`` after the step; and G's gradients on the card with cuDNN off
    beside (the share of the difference that is cuDNN's choice of
    algorithms)."""
    batch = _face_pairs(SEED + 70, 1, HIFACEGAN_SMALL['crop_size'])
    runs = {dev: _hifacegan_grads(dev, batch) for dev in ('cuda', 'cpu')}
    logs = {dev: run[0] for dev, run in runs.items()}
    loss_err = max(abs(logs['cuda'][k] - v) / max(abs(v), 1e-12)
                   for k, v in logs['cpu'].items())
    _, no_cudnn, _ = _hifacegan_grads('cuda', batch, cudnn=False)
    _, exact, _ = _hifacegan_grads('cpu', batch, dtype=torch.float64)
    models = {dev: run[2] for dev, run in runs.items()}
    card, cpu = runs['cuda'][1], runs['cpu'][1]
    return {'width': dict(HIFACEGAN_SMALL, d=HIFACEGAN_D_SMALL), 'batch': 1,
            'logs': logs, 'logs_rel_err': loss_err,
            'grads_g': _split_grad_errors(card['net_g'], cpu['net_g'],
                                          exact['net_g']),
            'grads_d': _split_grad_errors(card['net_d'], cpu['net_d'],
                                          exact['net_d']),
            'grads_g_cudnn_off': _split_grad_errors(
                no_cudnn['net_g'], cpu['net_g'], exact['net_g']),
            'grads_g_cpu_f32_vs_f64': _split_grad_errors(
                cpu['net_g'], exact['net_g'], exact['net_g']),
            'uv_rel_err': max(_vectors_rel_err(models['cuda'].net_g,
                                               models['cpu'].net_g),
                              _vectors_rel_err(models['cuda'].net_d,
                                               models['cpu'].net_d)),
            'grad_tolerance': TRAIN_GRAD_REL_TOL,
            'zero_grad_share': ZERO_GRAD_SHARE,
            'zero_grad_tolerance': ZERO_GRAD_TOL,
            'loss_tolerance': FACE_LOSS_TOL, 'uv_tolerance': SR_ZOO_CPU_TOL}


def phase_hifacegan_serve(kernels):
    """``hifacegan_serve``: ``HiFaceGAN`` at the JAX package's defaults in
    eval mode through ``SRModel.test`` on one 512 x 512 face, f32 and
    ``val.mixed_precision: bfloat16``: ms a face (a warm-up, 3 timed),
    peak memory, a profile of the f32 forward; the bf16 output against
    the f32 one (``FACE_BF16_MEAN_TOL``); the f32 net at
    ``HIFACEGAN_SMALL`` against the CPU (``SR_ZOO_CPU_TOL``). Returns the
    launches (none)."""
    from mrefsr_tpu_torch.models import build_model
    lq = torch.from_numpy(_face_pairs(SEED + 71, 1, FACE_SIDE)['lq']).cuda()
    rec = {'phase': 'hifacegan_serve', 'network_g': HIFACEGAN,
           'side': FACE_SIDE}
    launches, outs = {n: 0 for n in kernels}, {}
    for dtype in (torch.float32, BF16):
        model = build_model(_hifacegan_opt(False, dtype=dtype))
        out, times, peak, counts = _serve_times(
            kernels, lambda: _sr_test(model, lq))
        check(tuple(out.shape) == (1, FACE_SIDE, FACE_SIDE, 3)
              and bool(torch.isfinite(out).all()),
              f'hifacegan {dtype}: output {tuple(out.shape)}')
        tag = 'bf16' if dtype == BF16 else 'f32'
        outs[tag] = out.float().cpu()
        rec[f'{tag}_ms'] = times
        rec[f'{tag}_peak_mem_bytes'] = peak
        if dtype == torch.float32:
            rec['f32_profile'] = {
                k: v for k, v in profile_record(
                    'hifacegan_serve', lambda: _sr_test(model, lq)).items()
                if k in ('wall_ms', 'device_busy_ms', 'device_idle_share',
                         'cudnn_cublas_ms', 'other_ms', 'top_kernels')}
        for n, v in counts.items():
            launches[n] += v
        del model
        torch.cuda.empty_cache()
    diff = (outs['bf16'] - outs['f32']).abs()
    rec.update(bf16_vs_f32_mean_abs=float(diff.mean()),
               bf16_vs_f32_max_abs=float(diff.max()),
               bf16_mean_tolerance=FACE_BF16_MEAN_TOL)
    check(rec['bf16_vs_f32_mean_abs'] <= FACE_BF16_MEAN_TOL,
          f'hifacegan bf16 against f32: {rec["bf16_vs_f32_mean_abs"]}')
    small = _face_pairs(SEED + 72, 1, HIFACEGAN_SMALL['crop_size'])['lq']
    card = build_model(_hifacegan_opt(False, small=True))
    cpu = build_model(_hifacegan_opt(False, small=True), device='cpu')
    got = _sr_test(card, torch.from_numpy(small).cuda()).cpu()
    want = _sr_test(cpu, torch.from_numpy(small))
    err = float((got - want).abs().max() / want.abs().max())
    check(err <= SR_ZOO_CPU_TOL, f'hifacegan card and CPU differ by {err}')
    rec.update(card_vs_cpu_width=HIFACEGAN_SMALL, card_vs_cpu_rel_err=err,
               card_vs_cpu_tolerance=SR_ZOO_CPU_TOL)
    check(not any(launches.values()), f'hifacegan_serve launched {launches}')
    emit(dict(rec, hand_written_kernels_launched=0,
              reduced=['seeded weights (no published HiFaceGAN checkpoint '
                       'in the repository)', 'one synthetic face']))
    return launches


def phase_hifacegan_train(kernels):
    """``hifacegan_train``: ``HiFaceGANModel`` at the JAX package's widths
    (G and D), L1 + hinge ``MultiScaleGANLoss`` + ``GANFeatLoss``, B
    ``FACE_B`` at 512 x 512 through ``feed_data`` -> ``optimize_parameters``:
    iteration 1 skips G's turn (``net_d_init_iters`` 1: G as it was, its
    terms 0, its ``u`` / ``v`` moved), iteration 2 a warm-up, then
    ``FACE_STEPS`` timed steps, peak memory, a profile of one step; first
    the card against the CPU at ``HIFACEGAN_SMALL``, B 1
    (:func:`_hifacegan_card_vs_cpu`). Returns the launches (none)."""
    from mrefsr_tpu_torch.models import build_model
    cmp = _hifacegan_card_vs_cpu()
    emit(dict(cmp, phase='hifacegan_train_card_vs_cpu'))
    _check_grad_errors('hifacegan G, card against CPU', cmp['grads_g'])
    _check_grad_errors('hifacegan D, card against CPU', cmp['grads_d'])
    check(max(cmp['grads_g']['zero_largest_share'],
              cmp['grads_d']['zero_largest_share']) <= ZERO_GRAD_TOL
          and cmp['logs_rel_err'] <= FACE_LOSS_TOL
          and cmp['uv_rel_err'] <= SR_ZOO_CPU_TOL,
          f'hifacegan logs or u / v, card against CPU: {cmp}')
    model = build_model(_hifacegan_opt(True))
    batch = _on_card(_face_pairs(SEED + 73, FACE_B, FACE_SIDE))
    reset_counts(kernels)
    g_before = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    model.feed_data(batch)
    model.optimize_parameters(1)
    skipped = model.get_current_log()
    g_after = model.net_g.state_dict()
    moved_uv = [k for k, v in g_before.items()
                if k.endswith('weight_u') and not torch.equal(v, g_after[k])]
    check(all(torch.equal(v, g_after[k]) for k, v in g_before.items()
              if not k.endswith(('weight_u', 'weight_v')))
          and moved_uv and skipped['l_g_gan'] == 0,
          f'hifacegan: the skipped G turn changed G or left its u / v: '
          f'{skipped}')
    model.feed_data(batch)
    model.optimize_parameters(2)
    step_ms, logs, peak = _timed_steps(model, batch, 3, FACE_STEPS)
    launches = read_counts(kernels, ())
    check(not any(launches.values()), f'hifacegan_train launched {launches}')
    check(all(np.isfinite(v) for log in logs for v in log.values()),
          f'non-finite hifacegan terms: {logs}')

    def step():
        model.feed_data(batch)
        model.optimize_parameters(10)

    prof = profile_record('hifacegan_train', step)
    mean_ms = statistics.mean(step_ms)
    emit({'phase': 'hifacegan_train', 'network_g': HIFACEGAN,
          'network_d': HIFACEGAN_D, 'train': _hifacegan_opt(True)['train'],
          'batch': FACE_B, 'side': FACE_SIDE, 'dtype': 'float32',
          'skipped_g_turn_log': skipped, 'step_ms': step_ms,
          'mean_step_ms': mean_ms, 'img_per_s': FACE_B / mean_ms * 1e3,
          'peak_mem_bytes': peak, 'logs': logs,
          'profile': {k: v for k, v in prof.items()
                      if k in ('wall_ms', 'device_busy_ms',
                               'device_idle_share', 'cudnn_cublas_ms',
                               'other_ms', 'top_kernels')},
          'hand_written_kernels_launched': 0,
          'reduced': [f'{FACE_STEPS} timed steps on one repeated batch of '
                      'synthetic faces (FFHQ in the reference)',
                      'seeded weights', f'B {FACE_B} (the reference YAML is '
                      'not in the repository)']})
    del model
    torch.cuda.empty_cache()
    return launches


def _dfdnet_gap_share(query, atoms):
    """The top correlation's lead over the second as a share of the top,
    and the top's index (``DFDNet.swap_feat``'s scores; the softmax is
    monotonic)."""
    from mrefsr_tpu_torch.archs.dfdnet_util import (
        adaptive_instance_normalization)
    sims = torch.einsum('chw,kchw->k', query[0],
                        adaptive_instance_normalization(atoms, query))
    top2 = torch.topk(sims, 2).values
    return float((top2[0] - top2[1]) / top2[0].abs()), int(sims.argmax())


def _dfdnet_queries(net, x, locations):
    """Each scale's and part's box of ``x``'s VGG features sampled at the
    atoms' size, as ``DFDNet.swap_feat`` samples it."""
    from mrefsr_tpu_torch.archs.dfdnet_arch import (
        FEATURE_SIZES, PARTS, VGG_LAYERS, crop_resize_bilinear)
    with torch.inference_mode():
        feats = net.vgg_extractor(x)
    queries = {}
    for layer, size in zip(VGG_LAYERS, FEATURE_SIZES):
        for part_idx, part in enumerate(PARTS):
            side = DFD_SIDES[part] * size // 512
            x0, y0, x1, y1 = [int(v) // (512 // size)
                              for v in locations[part_idx][0]]
            queries[str(size), part] = crop_resize_bilinear(
                feats[layer], (y0, x0, y1, x1), (side, side)).clone()
    return queries


def _dfdnet_gaps(net, x, locations, face_dict):
    """The least lead of a top score over the second (share of the top)
    over every scale and part, checked to fall on ``DFD_PLANTED``."""
    shares = []
    for (size, part), query in _dfdnet_queries(net, x, locations).items():
        with torch.inference_mode():
            share, top = _dfdnet_gap_share(query, face_dict[size][part])
        check(top == DFD_PLANTED, f'dfdnet: atom {top} wins at {size} '
              f'{part}, not the planted {DFD_PLANTED}')
        shares.append(share)
    return min(shares)


def _dfdnet_inputs(root, device='cuda'):
    """A 512 x 512 face (PNG), its 68 landmarks (``.npy``) and a seeded
    dictionary of ``DFD_ATOMS`` atoms a part and scale (``.pth``) under
    ``root``: N(0, 1) from a generator on ``device``, atom ``DFD_PLANTED``
    each part's own VGG features under the seeded net. Returns the folders'
    and the dictionary's paths, the dictionary on ``device`` and on the CPU,
    and the seeded net on ``device``."""
    import cv2
    from mrefsr_tpu_torch.archs.dfdnet_arch import (CHANNEL_SIZES,
                                                    FEATURE_SIZES, PARTS)
    from mrefsr_tpu_torch.inference import inference_dfdnet
    paths = {k: os.path.join(root, k) for k in ('faces', 'landmarks',
                                                 'out')}
    for folder in paths.values():
        os.makedirs(folder)
    img = _face_images(SEED + 74, 1, FACE_SIDE)[0][:, :, ::-1]
    cv2.imwrite(os.path.join(paths['faces'], 'face0.png'),
                np.round(img * 255).astype(np.uint8))
    rng = np.random.RandomState(SEED + 75)
    pts = np.zeros((68, 2))
    for idx, centre in ((range(17, 22), (180, 190)),
                        (range(36, 42), (180, 210)),
                        (range(22, 27), (330, 190)),
                        (range(42, 48), (330, 210)),
                        (range(27, 36), (256, 290)),
                        (range(48, 68), (256, 380)),
                        (range(0, 17), (256, 300))):
        for i in idx:
            pts[i] = np.asarray(centre) + rng.randn(2) * 12
    np.save(os.path.join(paths['landmarks'], 'face0.npy'), pts)
    net = inference_dfdnet.build_model('', device, SEED)
    x = inference_dfdnet.read_face(os.path.join(paths['faces'],
                                                'face0.png')).to(device)
    queries = _dfdnet_queries(net, x,
                              inference_dfdnet.get_part_location(pts))
    gen = torch.Generator(device).manual_seed(SEED + 76)
    face_dict = {}
    for size, channels in zip(FEATURE_SIZES, CHANNEL_SIZES):
        face_dict[str(size)] = {}
        for part in PARTS:
            side = DFD_SIDES[part] * size // 512
            atoms = torch.randn((DFD_ATOMS, channels, side, side),
                                generator=gen, device=device)
            atoms[DFD_PLANTED] = queries[str(size), part][0]
            face_dict[str(size)][part] = atoms
    cpu_dict = {s: {p: a.cpu() for p, a in d.items()}
                for s, d in face_dict.items()}
    paths['dict'] = os.path.join(root, 'dfdnet_dict.pth')
    torch.save(cpu_dict, paths['dict'])
    return paths, face_dict, cpu_dict, net


def phase_dfdnet_serve(kernels, root):
    """``dfdnet_serve``: ``python -m mrefsr_tpu_torch.inference
    .inference_dfdnet`` (its ``main``, on the card) on one face with its
    landmark file and the seeded dictionary file of ``_dfdnet_inputs``
    (seeded weights: ``--model_path ''``); then the same net and
    dictionary: ms a face (a warm-up, 3 timed), peak memory, the written
    PNG within a level of ``restore``'s, the planted atom winning on the
    card by at least ``DFD_GAP_SHARE``, and the float output against the
    CPU's (``SR_ZOO_CPU_TOL``; an atom the CPU chose otherwise would fail
    it). Returns the launches (none)."""
    import cv2
    from mrefsr_tpu_torch.inference import inference_dfdnet
    t0 = time.perf_counter()
    paths, face_dict, cpu_dict, net = _dfdnet_inputs(root)
    torch.cuda.synchronize()
    dict_s = time.perf_counter() - t0
    argv = ['--test_path', paths['faces'], '--landmark_dir',
            paths['landmarks'], '--dict_path', paths['dict'],
            '--model_path', '', '--save_path', paths['out'],
            '--seed', str(SEED)]
    reset_counts(kernels)
    t0 = time.perf_counter()
    inference_dfdnet.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    x = inference_dfdnet.read_face(os.path.join(paths['faces'],
                                                'face0.png'))
    landmarks = np.load(os.path.join(paths['landmarks'], 'face0.npy'))
    locations = inference_dfdnet.get_part_location(landmarks)
    card_gap = _dfdnet_gaps(net, x.cuda(), locations, face_dict)
    img, times, peak, counts = _serve_times(
        kernels, lambda: inference_dfdnet.restore(net, face_dict, x,
                                                  landmarks))
    written = cv2.imread(os.path.join(paths['out'], 'face0_DFDNet.png'))
    levels = int(np.abs(written.astype(int) - img.astype(int)).max())
    check(levels <= 1, f'dfdnet: main wrote a PNG {levels} levels off')
    with torch.inference_mode():
        card = net(x.cuda(), locations, face_dict).cpu()
    del net, face_dict
    torch.cuda.empty_cache()
    check(card_gap >= DFD_GAP_SHARE, f'dfdnet: the planted atom leads by '
          f'{card_gap}, under {DFD_GAP_SHARE}')
    cpu_net = inference_dfdnet.build_model('', 'cpu', SEED)
    with torch.inference_mode():
        plain = cpu_net(x, locations, cpu_dict)
    err = float((card - plain).abs().max() / plain.abs().max())
    check(err <= SR_ZOO_CPU_TOL, f'dfdnet card and CPU differ by {err}')
    launches = {n: k.launches for n, k in kernels.items()}
    check(not any(launches.values()), f'dfdnet_serve launched {launches}')
    emit({'phase': 'dfdnet_serve', 'num_feat': 64, 'side': FACE_SIDE,
          'dictionary': {'atoms': DFD_ATOMS, 'sides_512': DFD_SIDES,
                         'planted': DFD_PLANTED,
                         'bytes': sum(a.numel() * a.element_size()
                                      for d in cpu_dict.values()
                                      for a in d.values())},
          'planted_lead_share': card_gap,
          'planted_lead_share_least': DFD_GAP_SHARE,
          'part_boxes_xyxy': [loc[0].tolist() for loc in locations],
          'dict_s': dict_s, 'main_s': main_s, 'ms': times,
          'peak_mem_bytes': peak,
          'png_levels_off': levels, 'card_vs_cpu_rel_err': err,
          'card_vs_cpu_tolerance': SR_ZOO_CPU_TOL,
          'hand_written_kernels_launched': 0,
          'reduced': ['seeded weights (the published DFDNet weights are '
                      'not in the repository)', 'a seeded dictionary at '
                      f'{DFD_ATOMS} atoms a part and scale, atom '
                      f'{DFD_PLANTED} planted (DictionaryCenter512 is not '
                      'in the repository)', 'one synthetic face, landmarks '
                      'given (no dlib)']})
    return launches


def _ffhq_folder(root):
    """``SG2_CLI_IMAGES`` smooth seeded 256 x 256 PNGs named ``%08d.png``."""
    import cv2
    folder = os.path.join(root, 'ffhq')
    os.makedirs(folder)
    for i in range(0, SG2_CLI_IMAGES, 16):
        for j, img in enumerate(_face_images(SEED + 80 + i, 16,
                                             SG2_TRAIN_SIZE)):
            cv2.imwrite(os.path.join(folder, f'{i + j:08d}.png'),
                        np.round(img[:, :, ::-1] * 255).astype(np.uint8))
    return folder


def _cli_stylegan2_yml(root, folder, iters):
    """``_sg2_train_opt`` (the reference's FFHQ-256 recipe) as a YAML over
    ``FFHQDataset`` (B 8, 4 loader threads, flips, mean / std 0.5), a
    sample grid of 16 at the end, a checkpoint at ``SG2_CLI_ITERS``."""
    import yaml
    doc = _sg2_train_opt(root)
    doc.pop('is_train')
    doc.update(num_gpu=1, datasets={'train': {
        'name': 'FFHQ', 'type': 'FFHQDataset', 'phase': 'train',
        'dataroot_gt': folder, 'io_backend': {'type': 'disk'},
        'use_hflip': True, 'mean': [0.5, 0.5, 0.5], 'std': [0.5, 0.5, 0.5],
        'batch_size_per_gpu': SG2_TRAIN_B, 'num_worker_per_gpu': 4,
        'dataset_enlarge_ratio': 1}},
        path={'pretrain_network_g': None, 'strict_load_g': True,
              'resume_state': None,
              'experiments_root': os.path.join(root, 'experiments')},
        val={'num_val_samples': 16, 'val_freq': SG2_CLI_ITERS,
             'save_img': True},
        logger={'print_freq': 1, 'save_checkpoint_freq': SG2_CLI_ITERS,
                'use_tb_logger': False},
        dist_params={'backend': 'nccl', 'port': 29500})
    doc['train']['total_iter'] = iters
    path = os.path.join(root, f'stylegan2_cli_{iters}.yml')
    with open(path, 'w') as f:
        yaml.safe_dump(doc, f)
    return path


def _profiled_launches(run, names):
    """The device kernels ``run()`` launches, counted by a profile: calls
    of each kernel whose name holds one of ``names``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    counts = {name: 0 for name in names}
    for _, calls, key in device_time_by_name(prof):
        for name in names:
            if name in key:
                counts[name] += calls
    return counts


def phase_cli_stylegan2(kernels, root):
    """``cli_stylegan2``: the FFHQ-256 StyleGAN2 recipe through
    ``train_pipeline`` in this process on ``FFHQDataset`` over
    ``SG2_CLI_IMAGES`` synthetic faces: ``SG2_CLI_ITERS`` iterations (the
    path penalty on 4 and 8), a checkpoint and a sample grid at the last
    (validation without a validation set), then ``--auto_resume`` on to
    ``SG2_CLI_RESUME``; img/s over iterations 3-8, the logger's data time,
    every K7 and K8 entry launched (counted by the kernels' wrappers, and
    by a profile of an iteration with both penalties). Returns the
    launches of both runs."""
    from mrefsr_tpu_torch.models.stylegan2_model import StyleGAN2Model
    from mrefsr_tpu_torch.train import train_pipeline
    folder = _ffhq_folder(root)
    yml = _cli_stylegan2_yml(root, folder, SG2_CLI_ITERS)
    model, train_launches, launches, rec = _cli_train(
        train_pipeline, root, ['-opt', yml], kernels, SG2_TRAIN_B, 2,
        SG2_CLI_ITERS, model_cls=StyleGAN2Model)
    for name in SG2_KERNELS:
        check(train_launches[name] > 0,
              f'cli_stylegan2: {name} not launched in training')
    exp = os.path.join(root, 'experiments', 'stylegan2_256')
    grid = os.path.join(exp, 'visualization', 'train',
                        f'train_{SG2_CLI_ITERS}.png')
    check(os.path.isfile(grid)
          and os.path.isfile(os.path.join(
              exp, 'training_states', f'{SG2_CLI_ITERS}.state')),
          'cli_stylegan2 wrote no sample grid or no state')
    del model
    torch.cuda.empty_cache()
    lines = _LogLines()
    logger = logging.getLogger('mrefsr_tpu_torch')
    logger.addHandler(lines)
    try:
        resumed, _, resumed_launches, _ = _cli_train(
            train_pipeline, root,
            ['-opt', _cli_stylegan2_yml(root, folder, SG2_CLI_RESUME),
             '--auto_resume'], kernels, SG2_TRAIN_B, SG2_CLI_ITERS + 2,
            SG2_CLI_RESUME, model_cls=StyleGAN2Model)
    finally:
        logger.removeHandler(lines)
    check(any(f'iter: {SG2_CLI_ITERS}.' in msg and 'Resuming' in msg
              for _, msg in lines.records),
          'cli_stylegan2 did not resume from its state')
    batch = {'gt': _on_card(_sg2_train_batch())['gt']}

    def both_penalties():
        resumed.feed_data(batch)
        resumed.optimize_parameters(16)

    profiled = _profiled_launches(both_penalties, (
        'upfirdn2d_tile_kernel', 'upfirdn2d_gather_kernel',
        'fused_leaky_relu_fwd_kernel', 'fused_leaky_relu_bwd_kernel',
        'fused_leaky_relu_bwd_rows_kernel'))
    check(profiled['upfirdn2d_tile_kernel'] > 0
          and profiled['fused_leaky_relu_fwd_kernel'] > 0
          and profiled['fused_leaky_relu_bwd_kernel']
          + profiled['fused_leaky_relu_bwd_rows_kernel'] > 0,
          f'cli_stylegan2: the profile saw no K7 or K8 kernel: {profiled}')
    del resumed
    torch.cuda.empty_cache()
    total = {n: launches[n] + resumed_launches[n] for n in kernels}
    emit({'phase': 'cli_stylegan2', 'source': 'the reference FFHQ-256 '
          'recipe (out 256, channel multiplier 2, B 8, R1 every 16, path '
          'length every 4), chip_smoke._sg2_train_opt',
          'iterations': SG2_CLI_ITERS, 'resumed_to': SG2_CLI_RESUME,
          'batch': SG2_TRAIN_B, 'images': SG2_CLI_IMAGES,
          **{k: v for k, v in rec.items() if k != 'losses_logged'},
          'launches_training': {n: train_launches[n] for n in SG2_KERNELS},
          'launches_both_runs': {n: total[n] for n in SG2_KERNELS},
          'launches_per_iteration': {
              n: train_launches[n] / SG2_CLI_ITERS for n in SG2_KERNELS},
          'profiled_kernel_calls_iteration_16': profiled,
          'reduced': [f'{SG2_CLI_ITERS} + '
                      f'{SG2_CLI_RESUME - SG2_CLI_ITERS} iterations '
                      '(800000 in the recipe)',
                      f'{SG2_CLI_IMAGES} synthetic faces (FFHQ: 70000)']})
    return total


def phase_face_metrics(kernels):
    """``face_metrics``: FID's Inception features (seeded weights) of
    ``FID_IMAGES`` images at 299 x 299 in batches of 16, ms; LPIPS (seeded
    weights) on ``LPIPS_PAIRS`` pairs at 256 x 256, ms; each against the
    CPU on its first images (``SR_ZOO_CPU_TOL``); NIQE of one 512 x 512
    image on the host, s. Returns the launches (none)."""
    from mrefsr_tpu_torch.metrics import (calculate_niqe,
                                          extract_inception_features,
                                          load_patched_inception_v3)
    from mrefsr_tpu_torch.metrics.lpips import build_lpips
    reset_counts(kernels)
    rec = {'phase': 'face_metrics'}
    imgs = _face_images(SEED + 90, FID_IMAGES, 299)
    batches = [imgs[i:i + 16] for i in range(0, FID_IMAGES, 16)]
    inception = load_patched_inception_v3(device='cuda')
    extract_inception_features(batches[:1], inception)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    feats = extract_inception_features(batches, inception)
    rec['inception_ms'] = (time.perf_counter() - t0) * 1e3
    rec['inception_peak_mem_bytes'] = torch.cuda.max_memory_allocated()
    cpu_feats = extract_inception_features(
        [imgs[:FID_CPU]], load_patched_inception_v3(device='cpu'))
    rec['inception_card_vs_cpu_rel_err'] = float(
        np.abs(feats[:FID_CPU] - cpu_feats).max() / np.abs(cpu_feats).max())
    check(feats.shape == (FID_IMAGES, 2048) and np.isfinite(feats).all()
          and rec['inception_card_vs_cpu_rel_err'] <= SR_ZOO_CPU_TOL,
          f'inception features: {rec}')
    del inception
    pairs = [torch.from_numpy(_face_images(SEED + 91 + k, LPIPS_PAIRS, 256))
             .permute(0, 3, 1, 2) * 2 - 1 for k in (0, 1)]
    lpips = build_lpips(device='cuda')
    with torch.inference_mode():
        x, y = (p.cuda() for p in pairs)
        lpips(x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist_card = lpips(x, y).cpu()
        torch.cuda.synchronize()
        rec['lpips_ms'] = (time.perf_counter() - t0) * 1e3
        dist_cpu = build_lpips(device='cpu')(pairs[0][:LPIPS_CPU],
                                             pairs[1][:LPIPS_CPU])
    rec['lpips'] = dist_card.tolist()
    rec['lpips_card_vs_cpu_rel_err'] = float(
        (dist_card[:LPIPS_CPU] - dist_cpu).abs().max()
        / dist_cpu.abs().max())
    check(bool(torch.isfinite(dist_card).all())
          and rec['lpips_card_vs_cpu_rel_err'] <= SR_ZOO_CPU_TOL,
          f'lpips: {rec}')
    del lpips
    torch.cuda.empty_cache()
    img = np.round(_face_images(SEED + 93, 1, FACE_SIDE)[0][:, :, ::-1]
                   * 255).astype(np.float32)
    t0 = time.perf_counter()
    rec['niqe'] = calculate_niqe(img, crop_border=0)
    rec['niqe_host_s'] = time.perf_counter() - t0
    check(np.isfinite(rec['niqe']), f'niqe {rec["niqe"]}')
    launches = read_counts(kernels, ())
    check(not any(launches.values()), f'face_metrics launched {launches}')
    emit(dict(rec, fid_images=FID_IMAGES, fid_cpu_images=FID_CPU,
              lpips_pairs=LPIPS_PAIRS, lpips_cpu_pairs=LPIPS_CPU,
              card_vs_cpu_tolerance=SR_ZOO_CPU_TOL,
              hand_written_kernels_launched=0,
              reduced=['seeded Inception and LPIPS weights (pt_inception, '
                       'vgg.pth and torchvision vgg16 are not in the '
                       'repository)', 'synthetic images']))
    return launches


# metrics_cli: calculate_stylegan2_fid at its defaults (the FFHQ-256
# recipe's generator: size 256, channel multiplier 2, 512-wide style, an
# 8-layer MLP; batch 64) on SG2_FID_SAMPLES samples, at truncation 1 and
# at SG2_FID_TRUNCATION over the mean of 4096 codes, against the statistics
# of the cli_stylegan2 phase's 64 faces; the other metric CLIs on
# METRIC_CLI_PAIRS of those faces and degraded copies
SG2_FID_SIZE, SG2_FID_B, SG2_FID_SAMPLES = 256, 64, 128
SG2_FID_TRUNCATION, SG2_FID_MEAN = 0.7, 4096
METRIC_CLI_PAIRS = 8
# the first batch through the kernels against the same codes and noise
# through the plain versions: images as SG2_TOL; their Inception features
# (max |kernel - plain| / max |plain|); the FID of the run at truncation
# 0.7 against the plain run's (|difference| / plain)
SG2_FID_FEATURE_TOL = 1e-4
SG2_FID_TOL = 1e-3


def _counting(module, name, counts):
    """``module.name`` wrapped to count its calls into ``counts[name]``."""
    fn = getattr(module, name)
    counts[name] = 0

    def counted(*args, **kwargs):
        counts[name] += 1
        return fn(*args, **kwargs)

    return mock.patch.object(module, name, counted)


def _sg2_fid_checkpoint(root, arch):
    """A seeded FFHQ-256 generator (live noise strengths and biases) saved
    as ``params_ema`` in the reference layout."""
    net = arch.StyleGAN2Generator(SG2_FID_SIZE, 512, 8, channel_multiplier=2)
    gen = torch.Generator().manual_seed(SEED + 95)
    net.init_weights(gen)
    _liven(net, gen)
    path = os.path.join(root, 'stylegan2_ffhq256_seeded.pth')
    torch.save({'params_ema': net.state_dict()}, path)
    return path


def _sg2_fid_first_batch(sg2_fid, ckpt, arch, ops_upfirdn2d, fused_act,
                         kernels):
    """The first batch of ``main``'s run at SG2_FID_TRUNCATION (seed 0: the
    mean latent's codes, then the batch's codes, then its noise layer by
    layer), its noise drawn here and passed in: the images through the
    kernels (those of the generator's own draws, within SG2_TOL), their
    launches,
    and the images and Inception features against the plain versions."""
    from mrefsr_tpu_torch.metrics import (extract_inception_features,
                                          load_patched_inception_v3)
    device = torch.device('cuda', torch.cuda.current_device())
    net = sg2_fid.build_generator(ckpt, SG2_FID_SIZE, 2, device)
    gen = torch.Generator(device=device).manual_seed(0)
    latent = sg2_fid.mean_latent(net, torch.randn(
        (SG2_FID_MEAN, 512), generator=gen, device=device))
    z = torch.randn((SG2_FID_B, 512), generator=gen, device=device)
    state = gen.get_state()
    noise = [torch.randn((SG2_FID_B, 1, 2 ** ((i + 5) // 2),
                          2 ** ((i + 5) // 2)), generator=gen, device=device)
             for i in range(net.num_layers)]
    gen.set_state(state)
    reset_counts(kernels)
    imgs = sg2_fid.sample(net, z, SG2_FID_TRUNCATION, latent, noise=noise)
    torch.cuda.synchronize()
    launches = read_counts(kernels, ('upfirdn2d_fwd', 'fused_leaky_relu_fwd'))
    drawn = sg2_fid.sample(net, z, SG2_FID_TRUNCATION, latent, generator=gen)
    # the transposed convs' cuDNN algorithms need not repeat to the bit; a
    # different noise would move the images by about its strength, 0.1
    drawn_err = float((imgs - drawn).abs().max() / drawn.abs().max())
    check(drawn_err <= SG2_TOL, f'metrics_cli: the noise drawn here is not '
          f'the noise the generator draws: {drawn_err}')
    with _plain_ops(arch, ops_upfirdn2d, fused_act):
        plain = sg2_fid.sample(net, z, SG2_FID_TRUNCATION, latent,
                               noise=noise)
    inception = load_patched_inception_v3(device=device)
    feats, plain_feats = (extract_inception_features([x], inception)
                          for x in (imgs, plain))
    rec = {'batch_own_draws_rel_err': drawn_err,
           'batch_images_rel_err': float((imgs - plain).abs().max()
                                         / plain.abs().max()),
           'batch_features_rel_err': float(
               np.abs(feats - plain_feats).max() / np.abs(plain_feats).max()),
           'batch_images_range': [float(imgs.min()), float(imgs.max())]}
    check(rec['batch_images_rel_err'] <= SG2_TOL
          and rec['batch_features_rel_err'] <= SG2_FID_FEATURE_TOL
          and imgs.shape == (SG2_FID_B, SG2_FID_SIZE, SG2_FID_SIZE, 3)
          and bool(torch.isfinite(imgs).all()),
          f'metrics_cli: the first batch against the plain versions: {rec}')
    return rec, {n: v for n, v in launches.items() if v}


def _metric_cli_folders(root, faces):
    """``gt``: the first METRIC_CLI_PAIRS faces; ``restored``: every face
    blurred and noised (seeded), the first METRIC_CLI_PAIRS in ``restored8``.
    Returns the three folders."""
    import cv2
    rng = np.random.RandomState(SEED + 96)
    out = {name: os.path.join(root, name) for name in ('gt8', 'restored',
                                                       'restored8')}
    for folder in out.values():
        os.makedirs(folder)
    for i, name in enumerate(sorted(os.listdir(faces))):
        img = cv2.imread(os.path.join(faces, name))
        degraded = np.clip(cv2.GaussianBlur(img, (5, 5), 1.2)
                           + rng.randn(*img.shape) * 6, 0, 255).astype(
                               np.uint8)
        cv2.imwrite(os.path.join(out['restored'], name), degraded)
        if i < METRIC_CLI_PAIRS:
            cv2.imwrite(os.path.join(out['gt8'], name), img)
            cv2.imwrite(os.path.join(out['restored8'], name), degraded)
    return out


def _lpips_files(root):
    """Seeded LPIPS weights as the official ``vgg.pth`` (the heads) and a
    torchvision ``vgg16`` state dict (the tower), the layout the LPIPS CLI
    reads."""
    from mrefsr_tpu_torch.archs.vgg_arch import NAMES
    from mrefsr_tpu_torch.metrics.lpips import build_lpips
    state = build_lpips(device='cpu', seed=SEED + 97).state_dict()
    index = {name: i for i, name in enumerate(NAMES['vgg16'])}
    heads = os.path.join(root, 'lpips_vgg.pth')
    tower = os.path.join(root, 'vgg16.pth')
    torch.save({k: v for k, v in state.items() if k.startswith('lin')},
               heads)
    torch.save({f'features.{index[k.split(".")[2]]}.{k.split(".")[3]}': v
                for k, v in state.items() if k.startswith('vgg.')}, tower)
    return heads, tower


# a metric CLI's main in a process of its own: argv[1] the module,
# argv[2] 'plain' (StyleGAN2 through the plain versions of K7 and K8) or
# 'kernels', the rest the CLI's; its last line the result, the K7 / K8
# launches and (with the kernels) the plain versions' calls
_METRIC_CHILD = """
import contextlib, importlib, json, sys
from unittest import mock
from mrefsr_tpu_torch.archs import stylegan2_arch
from mrefsr_tpu_torch.ops import fused_act
ups = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')
kernels = {n: getattr(m, n + '_kernel') for m, names in (
    (ups, ('upfirdn2d_fwd', 'upfirdn2d_bwd', 'upfirdn2d_bwd2')),
    (fused_act, ('fused_leaky_relu_fwd', 'fused_leaky_relu_bwd',
                 'fused_leaky_relu_bwd2'))) for n in names}
plain_calls = {}


def counted(module, name):
    fn = getattr(module, name)
    plain_calls[name] = 0

    def call(*args, **kwargs):
        plain_calls[name] += 1
        return fn(*args, **kwargs)

    return mock.patch.object(module, name, call)


with contextlib.ExitStack() as stack:
    if sys.argv[2] == 'plain':
        stack.enter_context(mock.patch.object(stylegan2_arch, 'upfirdn2d',
                                              ups.upfirdn2d_ref))
        stack.enter_context(mock.patch.object(
            stylegan2_arch, 'fused_leaky_relu',
            fused_act.fused_leaky_relu_ref))
    else:
        stack.enter_context(counted(ups, '_upfirdn2d_plain'))
        stack.enter_context(counted(fused_act, 'fused_leaky_relu_ref'))
    result = importlib.import_module(sys.argv[1]).main(sys.argv[3:])
print(json.dumps({'result': float(result), 'plain_calls': plain_calls,
                  'launches': {n: k.launches for n, k in kernels.items()}}))
"""
_METRICS = 'mrefsr_tpu_torch.scripts.metrics.'


def _metric_child(root, name, module, mode, argv):
    """:data:`_METRIC_CHILD` started on ``module``'s main; returns the
    process, its log file and the log's path."""
    repo = os.path.dirname(os.path.abspath(__file__))
    log_path = os.path.join(root, f'metrics_cli_{name}.log')
    # scipy's sqrtm is one host thread but for its Schur step: BLAS threads
    # a process would only fight the other processes' for the cores
    env = dict(os.environ, OMP_NUM_THREADS='1', OPENBLAS_NUM_THREADS='1',
               MKL_NUM_THREADS='1')
    out = open(log_path, 'w')
    try:
        return subprocess.Popen(
            [sys.executable, '-c', _METRIC_CHILD, _METRICS + module, mode,
             *argv], cwd=repo, env=env, stdout=out,
            stderr=subprocess.STDOUT, text=True), out, log_path
    except BaseException:
        out.close()
        raise


def _metric_child_result(name, started):
    """The JSON line of a :func:`_metric_child`, once it has exited 0, and
    its seconds from its start."""
    proc, out, log_path = started[name][:3]
    code, log = _cli_wait(proc, out, log_path)
    check(code == 0, f'metrics_cli {name} exited {code}:\n{log[-3000:]}')
    out = json.loads([line for line in log.splitlines()
                      if line.startswith('{"result"')][-1])
    out['s'] = time.perf_counter() - started[name][3]
    return out


def phase_metrics_cli(kernels, root):
    """``metrics_cli``: the port's metric CLIs through their ``main``, on the
    card: ``calculate_fid_stats_from_datasets`` on the ``cli_stylegan2``
    phase's 64 faces under ``root/ffhq``; ``calculate_stylegan2_fid`` at its
    defaults from a seeded ``params_ema`` checkpoint, SG2_FID_SAMPLES
    samples at SG2_FID_TRUNCATION here (every resampling and activation
    through K7 and K8, launches counted for the run and for one batch; no
    plain version called), its first batch held to the plain versions;
    beside it, in processes of their own (each FID is scipy's ``sqrtm`` of
    a 2048 x 2048 product, seconds of one host core), the run at
    truncation 1 (counted there), the plain run at SG2_FID_TRUNCATION whose
    FID the kernels' is held to, and ``calculate_fid_folder`` on degraded
    copies of the faces; then ``calculate_psnr_ssim``, ``calculate_niqe``
    and ``calculate_lpips`` here. Returns the launches of the two StyleGAN2
    FID runs through the kernels."""
    import importlib
    from mrefsr_tpu_torch.archs import stylegan2_arch as arch
    from mrefsr_tpu_torch.ops import fused_act
    from mrefsr_tpu_torch.scripts.metrics import (
        calculate_fid_stats_from_datasets, calculate_lpips, calculate_niqe,
        calculate_psnr_ssim)
    from mrefsr_tpu_torch.scripts.metrics import \
        calculate_stylegan2_fid as sg2_fid
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')
    t_phase = time.perf_counter()
    faces = os.path.join(root, 'ffhq')
    if not os.path.isdir(faces):
        faces = _ffhq_folder(root)
    rec = {'phase': 'metrics_cli', 'faces': len(os.listdir(faces))}
    stats = os.path.join(root, 'inception_ffhq_256_faces.pth')
    reset_counts(kernels)
    t0 = time.perf_counter()
    calculate_fid_stats_from_datasets.main([
        '--dataroot', faces, '--size', str(SG2_FID_SIZE), '--num_sample',
        str(rec['faces']), '--batch_size', str(SG2_FID_B), '--save', stats])
    rec['stats_s'] = time.perf_counter() - t0
    check(not any(read_counts(kernels, ()).values()),
          'the FID statistics launched a kernel of this repository')

    ckpt = _sg2_fid_checkpoint(root, arch)
    folders = _metric_cli_folders(root, faces)
    argv = [ckpt, stats, '--num_sample', str(SG2_FID_SAMPLES)]
    cut = ['--truncation', str(SG2_FID_TRUNCATION), '--truncation_mean',
           str(SG2_FID_MEAN)]
    started = {}
    try:
        for name, module, mode, child_argv in (
                ('truncation_1', 'calculate_stylegan2_fid', 'kernels', argv),
                ('plain_run', 'calculate_stylegan2_fid', 'plain',
                 argv + cut),
                ('fid_folder', 'calculate_fid_folder', 'kernels',
                 [folders['restored'], '--fid_stats', stats, '--batch_size',
                  str(SG2_FID_B)])):
            started[name] = (*_metric_child(root, name, module, mode,
                                            child_argv), time.perf_counter())
        name = f'truncation_{SG2_FID_TRUNCATION}'
        plain_calls = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        t0 = time.perf_counter()
        with _counting(ops_upfirdn2d, '_upfirdn2d_plain', plain_calls), \
                _counting(fused_act, 'fused_leaky_relu_ref', plain_calls):
            fid = float(sg2_fid.main(argv + cut))
        torch.cuda.synchronize()
        launches = read_counts(kernels, ('upfirdn2d_fwd',
                                         'fused_leaky_relu_fwd'))
        rec[name] = {'fid': fid, 's': time.perf_counter() - t0,
                     'peak_mem_bytes': torch.cuda.max_memory_allocated(),
                     'launches': {n: v for n, v in launches.items() if v},
                     'plain_calls': plain_calls}
        batch, rec['launches_one_batch'] = _sg2_fid_first_batch(
            sg2_fid, ckpt, arch, ops_upfirdn2d, fused_act, kernels)
        rec.update(batch)
        reset_counts(kernels)
        t0 = time.perf_counter()
        rec['psnr'], rec['ssim'] = calculate_psnr_ssim.main([
            '--gt', folders['gt8'], '--restored', folders['restored8'],
            '--crop_border', '4', '--test_y_channel'])
        rec['niqe'] = calculate_niqe.main(['--input', folders['restored8']])
        heads, tower = _lpips_files(root)
        rec['lpips'] = calculate_lpips.main([
            '--gt', folders['gt8'], '--restored', folders['restored8'],
            '--lpips_weights', heads, '--vgg16_weights', tower])
        rec['psnr_niqe_lpips_s'] = time.perf_counter() - t0
        check(not any(read_counts(kernels, ()).values()),
              'the PSNR / NIQE / LPIPS CLIs launched a kernel of this '
              'repository')
        for child in started:
            rec[child] = _metric_child_result(child, started)
    finally:
        for proc, out, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    total = {n: launches[n] + rec['truncation_1']['launches'].get(n, 0)
             for n in kernels}
    for child, sg2 in (('truncation_1', True), ('plain_run', False),
                       ('fid_folder', False)):
        got = rec[child]['launches']
        check(not any(rec[child]['plain_calls'].values()) and not any(
            got[n] for n in SG2_KERNELS if 'bwd' in n or not sg2),
              f'metrics_cli {child}: {rec[child]}')
        check(not sg2 or (got['upfirdn2d_fwd'] > 0
                          and got['fused_leaky_relu_fwd'] > 0),
              f'metrics_cli {child} launched no K7 or K8: {rec[child]}')
    check(not any(plain_calls.values()) and not any(
        launches[n] for n in SG2_KERNELS if 'bwd' in n),
          f'metrics_cli {name}: a plain version or a backward ran: '
          f'{rec[name]}')
    rec['fid_rel_err'] = abs(fid - rec['plain_run']['result']) \
        / abs(rec['plain_run']['result'])
    check(rec['fid_rel_err'] <= SG2_FID_TOL and np.isfinite(fid) and fid > 0
          and rec['truncation_1']['result'] > 0,
          f'metrics_cli: FID through the kernels against the plain run: '
          f'{rec}')
    check(all(np.isfinite(rec[k]) for k in ('psnr', 'ssim', 'niqe', 'lpips'))
          and 10 < rec['psnr'] < 60 and rec['lpips'] > 0
          and rec['fid_folder']['result'] > 0,
          f'metrics_cli: the other CLIs: {rec}')
    emit(dict(rec, seconds=time.perf_counter() - t_phase,
              source='calculate_stylegan2_fid defaults (the FFHQ-256 '
                     'recipe: size 256, channel multiplier 2, 512, 8-layer '
                     'MLP, batch 64)',
              samples=SG2_FID_SAMPLES, truncation_mean=SG2_FID_MEAN,
              tolerances={'images': SG2_TOL,
                          'features': SG2_FID_FEATURE_TOL,
                          'fid': SG2_FID_TOL},
              launches_both_runs={n: v for n, v in total.items() if v},
              reduced=[f'{SG2_FID_SAMPLES} samples (50000 in the script)',
                       f'statistics of {rec["faces"]} synthetic faces (FFHQ: '
                       '70000; its published statistics are not in the '
                       'repository)', 'seeded generator, Inception and '
                       'LPIPS weights']))
    return total


def face_phases(build_model, arch, correlation, dcn, kernels):
    """The face family and the learned metrics: ``hifacegan_serve``,
    ``hifacegan_train``, ``dfdnet_serve``, ``cli_stylegan2``,
    ``metrics_cli`` (on ``cli_stylegan2``'s faces), ``face_metrics``.
    Returns the launches by path."""
    by_path = {'hifacegan_serve': phase_hifacegan_serve(kernels)}
    torch.cuda.empty_cache()
    by_path['hifacegan_train'] = phase_hifacegan_train(kernels)
    with tempfile.TemporaryDirectory() as root:
        by_path['dfdnet_serve'] = phase_dfdnet_serve(kernels, root)
        torch.cuda.empty_cache()
        by_path['cli_stylegan2'] = phase_cli_stylegan2(kernels, root)
        torch.cuda.empty_cache()
        by_path['metrics_cli'] = phase_metrics_cli(kernels, root)
    torch.cuda.empty_cache()
    by_path['face_metrics'] = phase_face_metrics(kernels)
    return by_path


# ------------------------------------------------ the last modules (PR 21)
# C5: the input gradient of nn.AdaptiveAvgPool2d(1) on a channels-last
# input, card against CPU, at ImageDiscriminator's pool (ndf 32 x 16
# channels at the gan_* phases' 160 -> 5 x 5 maps, B 8, and ddp_gan's B 4)
# and RCAN's channel attention (64 channels at 64 x 64). Each entry of the
# gradient is the cotangent / (h w), one rounding: held within
# POOL_GRAD_TOL of the largest entry (the card's channels-last avg_pool2d
# was off by 82-110 %, PR 19)
POOL_GRAD_CASES = (('image_discriminator', 8, 512, 5),
                   ('image_discriminator_ddp_gan', 4, 512, 5),
                   ('rcan_channel_attention', 4, 64, 64))
POOL_GRAD_TOL = 1e-6


def phase_adaptive_pool_grad():
    """C5's check: ``nn.AdaptiveAvgPool2d(1)``'s input gradient on an NHWC
    view (as a conv of ``img.permute(0, 3, 1, 2)`` gives it), card
    against CPU; the contiguous input beside it."""
    pool = torch.nn.AdaptiveAvgPool2d(1)
    gen = torch.Generator().manual_seed(SEED + 81)
    cases = []
    for name, b, c, hw in POOL_GRAD_CASES:
        x = torch.randn(b, hw, hw, c, generator=gen).permute(0, 3, 1, 2)
        cot = torch.randn(b, c, 1, 1, generator=gen)
        rec = {'case': name, 'shape': [b, c, hw, hw]}
        for layout, inp in (('channels_last', x), ('contiguous',
                                                   x.contiguous())):
            grads = []
            for device in ('cuda', 'cpu'):
                leaf = inp.to(device).detach().requires_grad_()
                check(leaf.is_contiguous(memory_format=torch.channels_last)
                      == (layout == 'channels_last'), f'{name}: {layout}')
                pool(leaf).backward(cot.to(device))
                grads.append(leaf.grad.cpu())
            err = float((grads[0] - grads[1]).abs().max()) \
                / float(grads[1].abs().max())
            rec[f'{layout}_rel_err'] = err
            check(err <= POOL_GRAD_TOL, f'C5: AdaptiveAvgPool2d\'s input '
                  f'gradient, {name}, {layout}: card against CPU {err}')
        cases.append(rec)
    emit({'phase': 'adaptive_pool_grad', 'tolerance': POOL_GRAD_TOL,
          'cases': cases,
          'sites': ['archs/discriminator_arch.py ImageDiscriminator',
                    'archs/rcan_arch.py ChannelAttention']})


# eval_parity: the port's CUFED5 gate script (mrefsr_tpu_torch/scripts/
# eval_parity.py) in this process on a synthetic CUFED5 folder of
# EVAL_PARITY_SIZES inputs, each with 5 refs, padded to the 500 canvas, and
# seeded full-width checkpoints in the reference .pth layout. Its requests
# through the kernels against the same requests through the plain versions
# (the plain match takes the kernel's indices, as slice's does): each
# output within slice's tolerance (SLICE_TOL, at bf16 SLICE_BF16_TOL), and
# the plain run must pass the script's own gate at the kernels' metrics
EVAL_PARITY_SIZES = ((480, 472), (472, 480))


def _eval_parity_assets(root, build_model, dyn_agg_cls):
    """The CUFED5 folder and the two ``.pth`` files under ``root``:
    ``_cufed5_opt``'s seeded nets, net_g's offset convs live as slice's."""
    import cv2
    cufed = os.path.join(root, 'CUFED5')
    os.makedirs(cufed)
    for g, (h, w) in enumerate(EVAL_PARITY_SIZES):
        for i, img in enumerate(_smooth_clip(SEED + 90 + g, T + 1, h, w)):
            cv2.imwrite(os.path.join(cufed, f'{g:03d}_{i}.png'), img)
    model = build_model(_cufed5_opt())
    gen = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        for m in model.net_g.modules():
            if isinstance(m, dyn_agg_cls):
                w = m.conv_offset_mask.weight
                w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
                b = m.conv_offset_mask.bias
                b.copy_(torch.rand(b.shape, generator=gen) * 2 - 1)
    files = {}
    for key, net in (('net_g', model.net_g), ('extractor',
                                              model.net_extractor)):
        files[key] = os.path.join(root, f'{key}.pth')
        torch.save({'params': {k: v.detach().contiguous().cpu()
                               for k, v in net.state_dict().items()}},
                   files[key])
    del model
    torch.cuda.empty_cache()
    return cufed, files


def _eval_parity_run(main, argv, plain, correlation, dcn, matches):
    """``main(argv)`` in this process: its exit status, JSON report and the
    output of each request. Through the kernels, each request's match is
    kept in ``matches``; through the plain versions (``plain``) the
    prologue and K2 run plain and the match takes the kernel's indices in
    turn, its gap to the plain match's scores recorded."""
    import io
    from mrefsr_tpu_torch.models.multi_ref_restoration_model import \
        MultiRefRestorationModel
    outputs, gaps = [], []
    test = MultiRefRestorationModel.test
    match_cuda = correlation._match_patches_cuda

    def recorded_test(self):
        test(self)
        outputs.append(self.output.detach().clone())

    def match_recorded(pin, pref, chunk=None):
        matches.append(match_cuda(pin, pref))
        return matches[-1]

    def match_plain(pin, pref, chunk=None):
        idx_p, _ = correlation._match_patches_ref(pin, pref, 2048)
        kernel = matches[len(gaps)]
        idx_k = kernel[0].long()
        rows = [pref.gather(1, i.long()[..., None].expand(
            -1, -1, pref.shape[2])).float() for i in (idx_k, idx_p)]
        gap = ((pin.float() * rows[1]).sum(2)
               - (pin.float() * rows[0]).sum(2)).abs()[idx_k != idx_p]
        gaps.append(float(gap.max()) if gap.numel() else 0.0)
        return kernel

    out = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            MultiRefRestorationModel, 'test', recorded_test))
        if plain:
            for name, fn in (('_prologue_cuda', correlation._prologue_ref),
                             ('_match_patches_cuda', match_plain)):
                stack.enter_context(mock.patch.object(correlation, name, fn))
            stack.enter_context(mock.patch.object(
                dcn, '_mdcn_fused_forward_cuda', dcn._mdcn_fused_forward_ref))
        else:
            stack.enter_context(mock.patch.object(
                correlation, '_match_patches_cuda', match_recorded))
        stack.enter_context(contextlib.redirect_stdout(out))
        code = main(argv)
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    return code, report, outputs, gaps


def phase_eval_parity(build_model, dyn_agg_cls, correlation, dcn, kernels):
    """The gate script at f32 and with ``--bf16``: the kernels' launches a
    run (1 prologue, 1 match and 3 K2 a request), each output and the
    metrics against the plain versions, a gate passing (0) and one failing
    (2). Returns the launches by path."""
    from mrefsr_tpu_torch.scripts import eval_parity
    t0 = time.perf_counter()
    by_path, records = {}, []
    with tempfile.TemporaryDirectory() as root:
        cufed, files = _eval_parity_assets(root, build_model, dyn_agg_cls)
        base = ['--net_g', files['net_g'], '--extractor', files['extractor'],
                '--cufed5', cufed, '--results-dir',
                os.path.join(root, 'results')]
        n = len(EVAL_PARITY_SIZES)
        for dtype in (torch.float32, BF16):
            bf16 = dtype == BF16
            argv = base + (['--bf16'] if bf16 else [])
            matches, result = [], []
            reset_counts(kernels)
            # the run under the profiler (the device only): its kernels'
            # device time and the run's wall time
            profile = profile_record(
                'eval_parity' + ('_bf16' if bf16 else ''),
                lambda: result.extend(_eval_parity_run(
                    eval_parity.main, argv, False, correlation, dcn,
                    matches)))
            code, report, out_k, _ = result
            launches = read_counts(kernels, _entries(('match', 'k2'), dtype),
                                   _forbidden(dtype))
            want = {name: per * n for parts, per in ((('match',), 1),
                                                    (('k2',), 3))
                    for name in _entries(parts, dtype)}
            if dtype == torch.float32:  # the weight's split, a forward each
                want['mdcn_fused_split'] = 3 * n
            check(all(launches[k] == v for k, v in want.items())
                  and sum(launches.values()) == sum(want.values()),
                  f'eval_parity {dtype}: launches {launches}, want {want}')
            check(code == 0 and report['parity_ok'] is None,
                  f'eval_parity without a gate: {code} {report}')
            by_path['eval_parity' + ('_bf16' if bf16 else '')] = launches
            metrics = report['metrics']
            gate = ['--expected-psnr', repr(metrics['psnr']),
                    '--expected-psnr-y', repr(metrics['psnr_y']),
                    '--expected-ssim-y', repr(metrics['ssim_y'])]
            code_p, report_p, out_p, gaps = _eval_parity_run(
                eval_parity.main, argv + gate, True, correlation, dcn,
                matches)
            check(len(out_k) == len(out_p) == n,
                  f'eval_parity: {len(out_k)} and {len(out_p)} requests')
            diff = max(float((a - b).abs().max()) for a, b in zip(out_k,
                                                                  out_p))
            tol = SLICE_BF16_TOL if bf16 else SLICE_TOL
            check(diff <= tol, f'eval_parity {dtype}: outputs through the '
                  f'kernels and the plain versions differ by {diff}')
            check(max(gaps) <= K1_IDX_GAP, f'eval_parity: the match differs '
                  f'where the plain scores differ by {max(gaps)}')
            check(code_p == 0 and report_p['parity_ok'] is True,
                  f'eval_parity: the plain run fails the kernels\' gate: '
                  f'{report_p}')
            records.append({
                'dtype': str(dtype), 'run_s': profile['wall_ms'] / 1e3,
                'profile': profile, 'launches': {
                    k: v for k, v in launches.items() if v},
                'metrics': metrics, 'plain_metrics': report_p['metrics'],
                'plain_delta': {k: report_p['metrics'][k] - v
                                for k, v in metrics.items()},
                'gate_at_kernels_metrics': {'exit': code_p,
                                            'gates': report_p['gates']},
                'output_max_abs_diff': diff, 'output_tolerance': tol,
                'worst_match_gap': max(gaps)})
        # a gate 0.2 dB off the bf16 run's PSNR fails: exit status 2
        off = metrics['psnr'] + 0.2
        code_f, report_f, _, _ = _eval_parity_run(
            eval_parity.main, argv + ['--expected-psnr', repr(off)], False,
            correlation, dcn, [])
        check(code_f == 2 and report_f['parity_ok'] is False
              and report_f['metrics'] == metrics,
              f'eval_parity: a failing gate gave {code_f} {report_f}')
    emit({'phase': 'eval_parity', 'canvas': CANVAS, 'refs': T,
          'requests_a_run': n, 'sizes': EVAL_PARITY_SIZES, 'ngf': 64,
          'n_blocks': 16, 'groups': 8, 'runs': records,
          'failing_gate': {'exit': code_f, 'gates': report_f['gates']},
          'seconds': time.perf_counter() - t0})
    return by_path


# A13 in the ddp ranks: RealESRNet at the x4plus width (RRDBNet 64 / 23),
# B 4 a rank, gt 256, a pool of 8 a rank (two steps fill it, the third
# mixes), f32, dist: true; each rank's pool stream against a model of one
# process seeded manual_seed + rank, and the ranks' parameters bit-equal
REALESR_DDP_B, REALESR_DDP_QUEUE, REALESR_DDP_STEPS = 4, 8, 3


def _realesr_ddp_batch(rank, step):
    """A collated batch of ``RealESRGANDataset``'s shape: 400 x 400 smooth
    RGB gt and 21 x 21 kernels (a Gaussian, a sinc, a pulse)."""
    from mrefsr_tpu_torch.data.degradations import (bivariate_Gaussian,
                                                    circular_lowpass_kernel)
    rng = np.random.RandomState(SEED + 100 * rank + step)
    gt = np.stack(_smooth_clip(SEED + 100 * rank + step, REALESR_DDP_B,
                               REALESR_PAD, REALESR_PAD))[..., ::-1]
    pulse = np.zeros((21, 21), np.float32)
    pulse[10, 10] = 1
    k1 = [bivariate_Gaussian(21, s, s, 0)
          for s in rng.uniform(0.5, 3, REALESR_DDP_B)]
    k2 = [circular_lowpass_kernel(c, 21)
          for c in rng.uniform(1, 3, REALESR_DDP_B)]
    return {'gt': np.ascontiguousarray(gt, np.float32) / 255.,
            'kernel1': np.stack(k1).astype(np.float32),
            'kernel2': np.stack(k2).astype(np.float32),
            'sinc_kernel': np.stack([pulse] * REALESR_DDP_B)}


def _ddp_realesr_opt(dist_on, seed=SEED):
    opt = _realesr_opt('realesrnet')
    opt.update(dist=dist_on, manual_seed=seed, queue_size=REALESR_DDP_QUEUE,
               datasets={'train': {'batch_size_per_gpu': REALESR_DDP_B}})
    return opt


def _ddp_realesr_part(build_model, kernels, rank, root):
    """A13's part of a rank in a joined group: ``REALESR_DDP_STEPS``
    steps, the pairs each gave, whether the ranks' parameters are
    bit-equal after them; then the same batches through a model of one
    process seeded ``manual_seed + rank``: its pairs against the rank's.
    Saved to ``root/realesr_rank<r>.json``."""
    t0 = time.perf_counter()
    model = build_model(_ddp_realesr_opt(True))
    batches = [_realesr_ddp_batch(rank, s)
               for s in range(REALESR_DDP_STEPS)]
    pairs, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    for step, batch in enumerate(batches, 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.feed_data(batch)
        pairs.append((model.lq.clone(), model.gt.clone()))
        model.optimize_parameters(step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launches = {n: k.launches for n, k in kernels.items() if k.launches}
    bare = model.get_bare_model(model.net_g)
    params_equal = _same_on_all_ranks(torch.cat(
        [p.detach().reshape(-1) for p in bare.parameters()]))
    report = {'step_ms': step_ms, 'launches': launches,
              'params_equal_across_ranks': params_equal,
              'loss': model.get_current_log()['l_pix'],
              'peak_mem_bytes': torch.cuda.max_memory_allocated()}
    del model, bare
    torch.cuda.empty_cache()
    one = build_model(_ddp_realesr_opt(False, SEED + rank))
    same = []
    for batch, (lq, gt) in zip(batches, pairs):
        one.feed_data(batch)
        same.append(bool(torch.equal(one.lq, lq) and torch.equal(one.gt, gt)))
    # the third step's gt rows came out of the pool's earlier pairs
    held = torch.cat([gt for _, gt in pairs[:-1]])
    report['third_step_from_pool'] = all(
        any(torch.equal(row, h) for h in held) for row in pairs[-1][1])
    report.update(pairs_equal_one_process=same,
                  part_s=time.perf_counter() - t0)
    del one
    dist.barrier()
    with open(os.path.join(root, f'realesr_rank{rank}.json'), 'w') as f:
        json.dump(report, f)


def _ddp_realesr_check(root, backend):
    ranks = []
    for rank in range(DDP_WORLD):
        with open(os.path.join(root, f'realesr_rank{rank}.json')) as f:
            ranks.append(json.load(f))
    emit({'phase': 'ddp_realesrnet', 'backend': backend, 'world': DDP_WORLD,
          'network_g': RRDB_X4, 'batch_a_rank': REALESR_DDP_B,
          'gt': REALESR_DEGRADE['gt_size'], 'queue_size': REALESR_DDP_QUEUE,
          'steps': REALESR_DDP_STEPS, 'ranks': ranks})
    for rank, rec in enumerate(ranks):
        check(rec['params_equal_across_ranks'],
              'ddp_realesrnet: the ranks hold other parameters')
        check(all(rec['pairs_equal_one_process']),
              f'ddp_realesrnet: rank {rank}\'s pairs differ from one process '
              f'seeded manual_seed + rank: {rec["pairs_equal_one_process"]}')
        check(rec['third_step_from_pool'],
              f'ddp_realesrnet: rank {rank}\'s pool did not mix')
        check(not rec['launches'], f'ddp_realesrnet launched {rec}')
        check(math.isfinite(rec['loss']), f'ddp_realesrnet: loss {rec}')


def main():
    import importlib
    from mrefsr_tpu_torch.archs import arch_util, edvr_arch
    from mrefsr_tpu_torch.archs import ref_mrapa_restoration_arch as arch
    from mrefsr_tpu_torch.archs import stylegan2_arch
    from mrefsr_tpu_torch.inference import (inference_basicvsr,
                                            inference_basicvsrpp,
                                            inference_stylegan2)
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.ops import _build, correlation, dcn, fused_act
    # the package exports the function under the module's name
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')

    device, smi = phase_device()
    # no TF32 in cuDNN or cuBLAS, the yardsticks included, and bf16
    # products summed in f32, as the models set it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # the CLI phase's LMR images, written by a process beside the build
    lmr = _LmrImages()
    try:
        phase_build(_build.build)
        k1, k1p = phase_feature_match(correlation)
        k1['train_shape'], k1p['train_shape'] = phase_feature_match(
            correlation, pairs=TRAIN_B * T, h=TRAIN_GT // 4, ties=False)
        torch.cuda.empty_cache()
        k2 = phase_mdcn(dcn)
        k2['train_shape'] = phase_mdcn(dcn, n=TRAIN_B * T, shapes=TRAIN_SHAPES)
        k2['video_shapes'] = phase_mdcn(dcn, video=True)
        k2b = phase_mdcn_backward(dcn)
        k2_split = weight_split_record(dcn)
        k4f, k4b = phase_deform_sample(dcn)
        torch.cuda.empty_cache()
        kernels = kernel_objects(correlation, dcn, ops_upfirdn2d, fused_act)
        dcn_described, by_path = dcn_phases(arch_util, arch, dcn, kernels)
        k7 = phase_upfirdn2d(ops_upfirdn2d)
        k8 = phase_fused_act(fused_act)
        by_path['slice'], model, batch = phase_slice(
            build_model, arch.DynAgg, correlation, dcn, kernels)

        def one_request():
            model.feed_data(batch)
            model.test()

        phase_profile('slice', one_request)
        del model
        torch.cuda.empty_cache()
        phase_adaptive_pool_grad()
        by_path.update(phase_eval_parity(build_model, arch.DynAgg,
                                         correlation, dcn, kernels))
        torch.cuda.empty_cache()
        step_ms = {}
        for alignment in ('dcn', 'flow'):
            by_path[f'train_{alignment}'], step_ms[alignment] = phase_train(
                alignment, build_model, arch, dcn, kernels)
            torch.cuda.empty_cache()
        emit({'phase': 'train_ratio',
              'flow_steps_per_dcn_step': step_ms['dcn'] / step_ms['flow']})
        # ddp_gan's ranks run in the ddp phase's processes, at the end
        by_path.update(gan_phases(build_model, arch, dcn, kernels,
                                  ddp_gan=False))
        by_path.update(ref_phases(build_model, arch, correlation, dcn,
                                  kernels))
        bf16_described, bf16_paths, bf16_step_ms = bf16_phases(
            correlation, dcn, arch, build_model, kernels)
        by_path.update(bf16_paths)
        by_path.update(phase_cli(kernels, bf16_step_ms['dcn'], lmr))
        torch.cuda.empty_cache()
        sg2 = (stylegan2_arch, ops_upfirdn2d, fused_act, kernels)
        by_path['stylegan2_serve'] = phase_stylegan2_serve(inference_stylegan2,
                                                           *sg2)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as root:
            by_path['stylegan2_train'] = phase_stylegan2_train(
                build_model, *sg2, root)
        torch.cuda.empty_cache()
        by_path['basicvsrpp_serve'] = phase_basicvsrpp_serve(
            inference_basicvsr, inference_basicvsrpp, dcn, kernels)
        torch.cuda.empty_cache()
        by_path['edvr'] = phase_edvr(edvr_arch, arch_util, dcn, kernels)
        torch.cuda.empty_cache()
        by_path['basicvsr_serve'] = phase_basicvsr_serve(inference_basicvsr,
                                                         kernels)
        torch.cuda.empty_cache()
        by_path.update(video_phases(build_model, arch, correlation, dcn,
                                    kernels))
        torch.cuda.empty_cache()
        by_path.update(sr_zoo_phases(build_model, arch, correlation, dcn,
                                     kernels))
        torch.cuda.empty_cache()
        by_path.update(realesrgan_phases(build_model, arch, correlation, dcn,
                                         kernels))
        torch.cuda.empty_cache()
        by_path.update(face_phases(build_model, arch, correlation, dcn,
                                   kernels))
        torch.cuda.empty_cache()
        by_path['ddp'], (k6, k6b), by_path['ddp_gan'] = phase_ddp(
            build_model)

        described = (
            (k1p, 'feature_match_prologue.cu', K1_PROLOGUE_TPU),
            (k1, 'feature_match.cu', K1_TPU),
            (k6, 'feature_match.cu', K6_TPU),
            *bf16_described,
            (k6b, 'feature_match_bf16.cu', K6_TPU),
            *((rec, 'mdcn_fused.cu', K2_TPU)
              for rec in [k2, *k2b, k2_split]),
            *dcn_described,
            (k4f, 'deform_sample.cu', 'mrefsr_tpu/ops/dcn.py:296'),
            (k4b, 'deform_sample.cu', 'mrefsr_tpu/ops/dcn.py:296'),
            *((rec, 'upfirdn2d.cu', 'mrefsr_tpu/ops/upfirdn2d.py:13')
              for rec in k7),
            *((rec, 'fused_act.cu', 'mrefsr_tpu/ops/fused_act.py:12')
              for rec in k8))
        for path in ('slice', 'train_dcn', 'eval_parity'):
            check(by_path[path]['mdcn_fused_split'] > 0,
                  f'the f32 path {path} launched no mdcn_fused_split')
        for path in ('slice_bf16', 'train_dcn_bf16', 'eval_parity_bf16'):
            check(by_path[path]['mdcn_fused_split'] == 0,
                  f'the bf16 path {path} launched mdcn_fused_split')
        emit({'kernels': _described(described, by_path), 'card': smi})
        print(smi, flush=True)
        emit({'ok': True, 'device': device})
    finally:
        lmr.close()


def _described(described, by_path):
    """The ``kernels`` line's records: each ``(record, source, replaces)``
    with its route, source, the TPU kernel it replaces and its launches on
    the main paths of ``by_path``."""
    for rec, source, replaces in described:
        # a record of several entry points (K3's and K5's backward) counts
        # the launches of each
        names = rec.get('entries', [rec['name']])
        paths = {path: sum(counts[name] for name in names)
                 for path, counts in by_path.items()}
        rec.update(route='cuda', source='mrefsr_tpu_torch/ops/csrc/' + source,
                   replaces=replaces, launches=sum(paths.values()),
                   launches_by_path=paths)
    return [rec for rec, _, _ in described]


def main_bf16():
    """``--bf16``: the device, the build and the bf16 phases alone, then
    their entries of the ``kernels`` line (K6 at bf16 runs in the ``ddp``
    phase, which this leaves out); no ``ok`` line."""
    from mrefsr_tpu_torch.archs import ref_mrapa_restoration_arch as arch
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.ops import _build, correlation, dcn, fused_act
    import importlib
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')
    _, smi = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    phase_build(_build.build)
    kernels = kernel_objects(correlation, dcn, ops_upfirdn2d, fused_act)
    described, by_path, _ = bf16_phases(correlation, dcn, arch, build_model,
                                        kernels)
    emit({'kernels': _described(described, by_path), 'card': smi})
    print(smi, flush=True)


def main_k2():
    """``--k2``: the device, the build, K2's forward at the eval, training
    and video shapes and its backward at the training shapes, f32 and bf16,
    the f32 weight split, the scatter dgrad at the video shapes, then K3
    and K5 (``--dcn``'s phases), and their entries of the ``kernels``
    line; no ``ok`` line."""
    from mrefsr_tpu_torch.archs import arch_util
    from mrefsr_tpu_torch.archs import ref_mrapa_restoration_arch as arch
    from mrefsr_tpu_torch.ops import _build, correlation, dcn, fused_act
    import importlib
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')
    _, smi = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    phase_build(_build.build)
    described = []
    for dtype, source in ((torch.float32, 'mdcn_fused.cu'),
                          (BF16, 'mdcn_bf16.cu')):
        k2 = phase_mdcn(dcn, dtype=dtype)
        k2['train_shape'] = phase_mdcn(dcn, n=TRAIN_B * T,
                                       shapes=TRAIN_SHAPES, dtype=dtype)
        if dtype == torch.float32:
            k2['video_shapes'] = phase_mdcn(dcn, video=True)
        described += [(rec, source, K2_TPU)
                      for rec in [k2, *phase_mdcn_backward(dcn, dtype)]]
        if dtype == torch.float32:
            described.append((weight_split_record(dcn), source, K2_TPU))
        phase_video_scatter(dcn, dtype)
        torch.cuda.empty_cache()
    kernels = kernel_objects(correlation, dcn, ops_upfirdn2d, fused_act)
    dcn_described, by_path = dcn_phases(arch_util, arch, dcn, kernels)
    emit({'kernels': _described(described + dcn_described, by_path),
          'card': smi})
    print(smi, flush=True)


def main_dcn():
    """``--dcn``: the device, the build, K3 and K5 at both types and the
    bf16 module path (``dcn_modules``), then their entries of the
    ``kernels`` line; no ``ok`` line."""
    from mrefsr_tpu_torch.archs import arch_util
    from mrefsr_tpu_torch.archs import ref_mrapa_restoration_arch as arch
    from mrefsr_tpu_torch.ops import _build, correlation, dcn, fused_act
    import importlib
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')
    _, smi = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    phase_build(_build.build)
    kernels = kernel_objects(correlation, dcn, ops_upfirdn2d, fused_act)
    described, by_path = dcn_phases(arch_util, arch, dcn, kernels)
    emit({'kernels': _described(described, by_path), 'card': smi})
    print(smi, flush=True)


def main_cli():
    """``--cli``: the device, the build and the ``cli`` phase alone, then
    the launches of its two in-process runs; no ``ok`` line."""
    from mrefsr_tpu_torch.ops import _build, correlation, dcn, fused_act
    import importlib
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')
    _, smi = phase_device()
    phase_build(_build.build)
    kernels = kernel_objects(correlation, dcn, ops_upfirdn2d, fused_act)
    by_path = phase_cli(kernels)
    emit({'cli_launches': {path: {n: v for n, v in counts.items() if v}
                           for path, counts in by_path.items()},
          'card': smi})
    print(smi, flush=True)


def _main_alone(phases):
    """The device, the build and ``phases(build_model, arch, correlation,
    dcn, kernels) -> launches by path`` alone, then those launches; no
    ``ok`` line."""
    import importlib
    from mrefsr_tpu_torch.archs import ref_mrapa_restoration_arch as arch
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.ops import _build, correlation, dcn, fused_act
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')
    _, smi = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    phase_build(_build.build)
    kernels = kernel_objects(correlation, dcn, ops_upfirdn2d, fused_act)
    by_path = phases(build_model, arch, correlation, dcn, kernels)
    emit({'launches_by_path': {path: {n: v for n, v in counts.items() if v}
                               for path, counts in by_path.items()},
          'card': smi})
    print(smi, flush=True)


def main_gan():
    """``--gan``: ``gan_train`` (dcn, flow, perceptual + style) and
    ``ddp_gan`` alone."""
    _main_alone(lambda build_model, arch, correlation, dcn, kernels:
                gan_phases(build_model, arch, dcn, kernels))


def main_ref():
    """``--ref``: ``ref_train`` and ``ref_eval`` at both types alone."""
    _main_alone(ref_phases)


def main_video():
    """``--video``: the video phases of :func:`video_phases` alone."""
    _main_alone(video_phases)


def main_zoo():
    """``--zoo``: the video zoo's phases alone (:func:`zoo_phases`)."""
    _main_alone(zoo_phases)


def main_sr_zoo():
    """``--sr-zoo``: the SR zoo's phases alone (:func:`sr_zoo_phases`)."""
    _main_alone(sr_zoo_phases)


def main_realesrgan():
    """``--realesrgan``: Real-ESRGAN's phases alone
    (:func:`realesrgan_phases`)."""
    _main_alone(realesrgan_phases)


def main_face():
    """``--face``: the face family's and the metrics' phases alone
    (:func:`face_phases`)."""
    _main_alone(face_phases)


def main_last():
    """``--last``: the device, the build, C5's pool check, ``eval_parity``
    and the ``ddp`` phase with ``ddp_realesrnet``'s part, then the
    launches of ``eval_parity``'s runs; no ``ok`` line."""
    from mrefsr_tpu_torch.archs import ref_mrapa_restoration_arch as arch
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.ops import _build, correlation, dcn, fused_act
    import importlib
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')
    _, smi = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    phase_build(_build.build)
    kernels = kernel_objects(correlation, dcn, ops_upfirdn2d, fused_act)
    phase_adaptive_pool_grad()
    by_path = phase_eval_parity(build_model, arch.DynAgg, correlation, dcn,
                                kernels)
    phase_ddp()
    emit({'launches_by_path': {path: {n: v for n, v in counts.items() if v}
                               for path, counts in by_path.items()},
          'card': smi})
    print(smi, flush=True)


def main_repeat_grads(rounds):
    """``--repeat-grads N``: the whole-net gradient comparisons of the
    three training paths alone, from fresh weights and then N times more,
    each after further training steps and on other inputs. Every
    comparison is held to the checks of the phases; the last line of each
    path sums up the spread, which the tolerances above are set by."""
    import importlib
    from mrefsr_tpu_torch.archs import ref_mrapa_restoration_arch as arch
    from mrefsr_tpu_torch.archs import stylegan2_arch
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.ops import _build, dcn, fused_act
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')

    _, smi = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()

    def sum_up(path, records, keys):
        worst = {}
        for key in keys:
            for stat in ('worst', 'median', 'one_element_worst',
                         'one_element_median'):
                worst[f'{key}.{stat}'] = max(r[key][stat] for r in records)
        emit({'phase': 'repeat_grads_summary', 'path': path,
              'comparisons': len(records), 'largest': worst, 'card': smi})

    for alignment in ('dcn', 'flow'):
        model = build_model(_train_opt(alignment))
        rng = np.random.RandomState(SEED + 6)
        batch = _train_batch(rng, TRAIN_B)
        records, step = [], 0
        for rnd in range(rounds + 1):
            cmp = _compare_grads(model, arch, dcn, _train_batch(rng, 1))
            emit({'phase': 'repeat_grads', 'path': f'train_{alignment}',
                  'steps_taken': step, **cmp})
            _check_grads(f'{alignment}, after {step} steps', cmp)
            records.append(cmp)
            for _ in range(3):
                step += 1
                model.feed_data(batch)
                model.optimize_parameters(step)
        check(all(r['same_forward_bit_equal'] for r in records),
              f'{alignment}: the plain forward values did not give the '
              f'plain forward')
        sum_up(f'train_{alignment}', records, ('same_forward', 'own_forward'))
        del model
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        model = build_model(_sg2_train_opt(root))
        batch = _sg2_train_batch()
        records, step = [], 0
        for rnd in range(rounds + 1):
            model.feed_data(batch)
            cmp = _sg2_compare_grads(model, stylegan2_arch, ops_upfirdn2d,
                                     fused_act, model.real_img,
                                     seed=SEED + 11 + rnd)
            emit({'phase': 'repeat_grads', 'path': 'stylegan2_train',
                  'steps_taken': step, **cmp})
            _sg2_check_grads(f'stylegan2, after {step} steps', cmp)
            records.append(cmp)
            for _ in range(2):
                step += 1
                model.optimize_parameters(step)
        sum_up('stylegan2_train', records,
               ('grads_d_r1', 'grads_g_path', 'grads_g_path_plain_twice'))


def main_ddp():
    """``--ddp``: the device, the build and the multi-rank phases alone
    (``ddp``, with ``ddp_gan``'s and ``ddp_realesrnet``'s parts in its
    ranks), then K6's entry of the ``kernels`` line; no ``ok`` line."""
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.ops import _build
    _, smi = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build(_build.build)
    launches, k6s, _ = phase_ddp(build_model)
    for k6, source in zip(k6s, ('feature_match.cu', 'feature_match_bf16.cu')):
        k6.update(route='cuda',
                  source=f'mrefsr_tpu_torch/ops/csrc/{source}',
                  replaces=K6_TPU,
                  launches=launches[k6['name']])
    emit({'kernels': k6s, 'card': smi})
    print(smi, flush=True)


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ['--repeat-grads']:
        main_repeat_grads(int(sys.argv[2]))
    elif sys.argv[1:2] == ['--ddp']:
        main_ddp()
    elif sys.argv[1:2] == ['--bf16']:
        main_bf16()
    elif sys.argv[1:2] == ['--dcn']:
        main_dcn()
    elif sys.argv[1:2] == ['--k2']:
        main_k2()
    elif sys.argv[1:2] == ['--cli']:
        main_cli()
    elif sys.argv[1:2] == ['--gan']:
        main_gan()
    elif sys.argv[1:2] == ['--ref']:
        main_ref()
    elif sys.argv[1:2] == ['--video']:
        main_video()
    elif sys.argv[1:2] == ['--zoo']:
        main_zoo()
    elif sys.argv[1:2] == ['--sr-zoo']:
        main_sr_zoo()
    elif sys.argv[1:2] == ['--realesrgan']:
        main_realesrgan()
    elif sys.argv[1:2] == ['--face']:
        main_face()
    elif sys.argv[1:2] == ['--last']:
        main_last()
    else:
        main()
