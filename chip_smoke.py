#!/usr/bin/env python3
"""Drive the port's main paths on one NVIDIA GPU: the 5-ref CUFED5 eval
forward, the stage-3 training step with both alignments, in f32 and in the
shipped bf16 mixed precision, StyleGAN2 sampling and training, video SR
inference (BasicVSR++, EDVR, BasicVSR), and stage-3 training, validation
and the sharded patch match over two ranks.

    python3 chip_smoke.py        # from the root of a checkout
    python3 chip_smoke.py --repeat-grads 20   # only the whole-net gradient
                                              # comparisons, 21 times a path
    python3 chip_smoke.py --ddp  # only the two-rank phase (17)
    python3 chip_smoke.py --bf16 # only the bf16 phases (11a-11e)
    python3 chip_smoke.py --dcn  # only K3, K5 and their module path (7)

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or
``/usr/local/cuda``). Phases, one JSON line each (one per shape where a
phase runs several):

1. device: the card's name and count, and its power limit from
   ``nvidia-smi``;
2. build: the CUDA sources built with ``nvcc`` from this checkout, with
   ``-Xptxas -v``'s registers, shared memory and spills;
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
   with its own outputs checked; with integer offsets and samples on the
   border;
6. deform_sample (kernel K4, forward and backward) against its plain
   version at the three training shapes, and bit for bit against ``x``
   indexed at the shifted positions for integer flows;
7. mdcn_groups (K3, DCNv2 with conv groups 2 and 8) and dcn_v1 (K5, DCNv1
   at padding 0, groups 1 and 8) on the fused kernels, in f32 and then in
   bf16 (``*_bf16``), against their plain versions, forward and every
   gradient, at EDVR-M's L1 shape (5, 180, 320, 64), deform groups 8
   (``DCN_VARIANT_TOL``, at bf16 ``K2_BF16_TOL``); the backward as a
   training step asks it run twice, bit-equal, launching the variant's own
   entry points of the type and no scatter; K3 at groups 2 against two K2
   calls on the channel slices; then dcn_modules: ``DCNv2Pack`` and
   ``DynAgg`` with groups 2 at bf16 (cast as the models cast a net) on
   EDVR-M L1 features, forward and backward through the kernels against
   the plain versions, K3's bf16 entry points only;
8. upfirdn2d (kernel K7: the tile kernel for StyleGAN2's 4x4 cases, the
   gather kernel for any other) against its plain version, forward,
   backward and double backward, at every shape of a 1024x1024 16-sample
   generator forward and of a 256x256 B = 8 generator and discriminator
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
11. train_dcn and train_flow: the same model built for training
    (``alignment`` dcn, then flow) takes one warm-up and five timed
    steps at B = 6, gt 160, T = 5, f32 on one repeated batch; the launch
    counts over the timed steps (no launch may scatter a grad x: the
    sampled features are frozen); at B = 1, from the fresh and from the
    trained weights, every parameter's gradient through the kernels
    against the plain versions behind the same forward (see
    ``TRAIN_GRAD_REL_TOL``), and the two outputs; then a profile of one
    step;
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
    training and validation of this phase are f32;
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
import json
import math
import os
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


def emit(obj):
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

    from torch.autograd import DeviceType
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
            events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and SETTLE_NAME not in e.name
                      and not getattr(e, 'is_user_annotation', False)]
            steady = [e for e in events
                      if not any(name in e.name for name in VARYING_EVENTS)]
            if steady and len(steady) % runs == 0:
                break
        check(steady and len(steady) % runs == 0,
              f'{len(steady)} device events profiled for {runs} calls, '
              f'{DEVICE_TRIES} times: '
              f'{sorted({e.name[:60] for e in events})}')
        out.append(sum(e.time_range.elapsed_us() for e in events)
                   / runs / 1e3)
    return out


# the plain versions' calls profiled a fn (device_ms_each): each takes tens
# to hundreds of ms
PLAIN_DEVICE_RUNS = 3


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


def phase_build(build):
    t0 = time.perf_counter()
    info = build()
    ptxas = {}
    for stem, rec in info.items():
        ptxas[stem] = [line.split(':', 1)[1].strip()
                       for line in rec['log'].splitlines()
                       if line.startswith('ptxas info') and (
                           'registers' in line or 'spill' in line)]
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'built': sorted(info), 'ptxas': ptxas})


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
        wt = weight.reshape(9 * c, cout).t().contiguous()
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
            'bound_f32_cuda_cores_ms')
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
    bias."""
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
    dgrad = (*head, weight.data_ptr(), g_off.data_ptr(), g_mask.data_ptr())
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
    # and mask, grad x (f32), the f32 partials of grad weight and bias
    ins = size * (cot.numel() + x.numel() + mask.numel()) \
        + 4.0 * offset.numel()
    outs_bytes = size * mask.numel() + 4.0 * offset.numel()
    spec = {
        'dgrad': ([mm, col2im], ins + size * weight.numel() + outs_bytes,
                  lambda: plain((1, 2)), lambda: library(x_nchw)),
        'dgrad_scatter': ([mm, col2im], ins + size * weight.numel()
                          + outs_bytes + 4.0 * x.numel(),
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
    return recs


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
    version; the backward as a training step asks it (x frozen) run twice,
    bit-equal, launching the variant's own entry points of the type and no
    other (no scatter); then the device time a call (``ms``) and the
    events around one (``call_ms``) of the forward, of that backward and of
    the backward with grad x, beside the plain version and the library
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

    wrt_x = [a.detach().requires_grad_() for a in args]
    out_k, out_kx, out_p = kernel(*wrt), kernel(*wrt_x), plain(*wrt)
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
                   max_rel_err=max(*errs.values(), *step_errs.values()))
        rec['bound_ms'], rec['bound_by'] = bound(flops, nbytes)
    emit({'phase': f'{"mdcn_groups" if masked else "dcn_v1"}'
                   f'{"_bf16" if bf16 else ""}',
          'n': n, 'h': h, 'w': w, 'c': c, 'cout': cout, 'deform_groups': dg,
          'groups': groups, 'padding': padding, 'dtype': str(dtype),
          'rel_err': errs, 'step_rel_err': step_errs,
          'bit_equal_rerun': bit_equal,
          'launches': {k: v for k, v in launches.items() if v},
          'tolerance': tol, 'forward': fwd, 'backward': bwd,
          'timing': TIMING_NOTE})
    del out_k, out_kx, out_p, out_l
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
    from mrefsr_tpu_torch.models.multi_ref_restoration_model import \
        cast_tensors
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
                 bias=None):
    """Each order of :func:`_order_calls` timed two ways: ``call``, the
    median ms of ``reps`` calls, each between its own pair of CUDA events
    (host time included: a small call's is mostly the host's), and
    ``device``, the ms of device work a call, over ``runs`` calls
    (:func:`device_ms_each`)."""
    calls = _order_calls(fn, x, orders, bias)
    call = {o: cuda_ms(c, reps=reps) for o, c in calls.items()}
    device = device_ms_each(list(calls.values()),
                            runs=DEVICE_RUNS if runs is None else runs,
                            warmup=0)
    return {'call': call, 'device': dict(zip(calls, device))}


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
            got, want = _three_orders(kernel, x), _three_orders(plain, x)
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
                times = {key: _time_orders(f, x, ('fwd',))
                         for key, f in (('kernel', kernel), ('plain', plain),
                                        ('library', library))}
            else:
                # one run each of the plain and the library version: cuDNN
                # takes seconds for some of their double backwards
                times = {'kernel': _time_orders(kernel, x),
                         'plain': _time_orders(plain, x, reps=1, runs=1),
                         'library': _time_orders(library, x, reps=1,
                                                 runs=1)}
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
                times = {key: _time_orders(f, x, ('fwd',), bias=bias)
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

    # one request through the kernels and through the plain versions; the
    # plain run takes the kernel's match so both align with the same
    # correspondences, and the match itself is checked on near-ties
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

    model.feed_data(requests[0])
    with mock.patch.object(correlation, '_match_patches_cuda',
                           match_recorded):
        model.test()
    out_k = model.output.clone()
    with mock.patch.object(correlation, '_match_patches_cuda', match_plain), \
            mock.patch.object(dcn, '_mdcn_fused_forward_cuda',
                              dcn._mdcn_fused_forward_ref):
        model.test()
    diff = float((model.output - out_k).abs().max())
    tol = SLICE_BF16_TOL if bf16 else SLICE_TOL
    check(record['gap'] <= K1_IDX_GAP, f'slice match differs where the plain '
          f'scores differ by {record["gap"]}')
    check(diff <= tol, f'slice output {dtype}: kernels vs plain differ by '
          f'{diff}')
    rec = {'phase': 'slice_bf16' if bf16 else 'slice', 'canvas': CANVAS,
           'refs': T, 'batch': 1, 'ngf': 64, 'n_blocks': 16, 'groups': 8,
           'dtype': str(dtype), 'request_ms': request_ms,
           'peak_mem_bytes': peak, 'launches': launches,
           'plain_vs_kernel_max_abs_diff': diff, 'tolerance': tol,
           'match_disagreements': record['disagree'],
           'worst_disagreement_gap': record['gap']}
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
# median 0; from fresh weights 0.0011.
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


def _only(kernels, launches, expect):
    """Every kernel of ``expect`` launched, and no other: serving runs no
    backward, scatter or other variant."""
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
    parts, and writes its report to ``root/rank<r>.json``."""
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
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f'rank{rank}.json'), 'w') as f:
        json.dump(report, f)


def phase_ddp():
    """Two ranks, each a process started with ``torch.multiprocessing``
    (spawn) under the torchrun env contract: NCCL with a card a rank where
    there are two cards or more, else gloo with both ranks on the one
    card (NCCL refuses two ranks on one device; gloo reduces CUDA tensors
    through the host). Returns the launches of the main path summed over
    the ranks, and K6's record."""
    cards = torch.cuda.device_count()
    backend = 'nccl' if cards >= DDP_WORLD else 'gloo'
    emit({'phase': 'ddp', 'backend': backend, 'world': DDP_WORLD,
          'cards': cards,
          'rank_devices': [f'cuda:{r % cards}' for r in range(DDP_WORLD)]})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        os.environ.update(MASTER_ADDR='localhost',
                          MASTER_PORT=str(_free_port()),
                          WORLD_SIZE=str(DDP_WORLD))
        ctx = torch.multiprocessing.spawn(_ddp_rank, args=(backend, root),
                                          nprocs=DDP_WORLD, join=False)
        try:        # a failed rank raises here, and the others are ended
            while not ctx.join(timeout=5):
                check(time.perf_counter() - t0 < DDP_WAIT_S,
                      f'the ddp ranks outlived {DDP_WAIT_S} s')
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(30)
        reports = []
        for rank in range(DDP_WORLD):
            with open(os.path.join(root, f'rank{rank}.json')) as f:
                reports.append(json.load(f))
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
          'launches': launches})
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
    return launches, k6


# how the profile sorts device kernels: the hand-written ones by name,
# cuDNN's and cuBLAS's (convolutions, their layout changes and FFTs, and
# matmuls) by these marks, the rest (element-wise, reductions, copies,
# Adam) as other
OWN_KERNELS = ('prologue_kernel', 'split_tf32_kernel',
               '::Tf32x3>', '::Bf16>',     # fm::match_kernel<...>
               'mdcn_fused::fwd_kernel',
               'mdcn_fused::dgrad_kernel', 'mdcn_fused::wgrad_kernel',
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


def profile_record(path, run, top=12):
    """:func:`phase_profile`'s line, returned rather than printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_ms(event):
        us = getattr(event, 'self_device_time_total', None)
        return (event.self_cuda_time_total if us is None else us) / 1e3

    # device kernels only: a record_function range (DDP's forward) also
    # shows on the device as a user annotation spanning its kernels
    kernels = sorted(((device_ms(e), e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, 'is_user_annotation', False)),
                     reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    own = {name: sum(ms for ms, _, key in kernels if name in key)
           for name in OWN_KERNELS}
    library = sum(ms for ms, _, key in kernels
                  if any(mark in key for mark in LIBRARY_MARKS)
                  and not any(name in key for name in OWN_KERNELS))
    return {'phase': 'profile', 'path': path, 'wall_ms': wall_ms,
            'device_busy_ms': busy,
            'device_idle_share': 1 - busy / wall_ms if busy else None,
            'hand_written_ms': own, 'cudnn_cublas_ms': library,
            'other_ms': busy - library - sum(own.values()),
            'top_kernels': [{'ms': ms, 'calls': n, 'name': name[:90]}
                            for ms, n, name in kernels[:top]]}


# the TPU kernels the bf16 records replace: K1, K2, K4
K1_TPU = 'mrefsr_tpu/ops/correlation.py:45'
K6_TPU = 'mrefsr_tpu/ops/correlation.py:140'
K2_TPU = 'mrefsr_tpu/ops/dcn.py:111'
K4_TPU = 'mrefsr_tpu/ops/dcn.py:296'


def bf16_phases(correlation, dcn, arch, build_model, kernels):
    """The shipped precision of the main path: K1, K2 (forward and
    backward) and K4 at bf16 against their plain versions, the bf16
    CUFED5 request and the bf16 stage-3 step of both alignments. Returns
    the kernels' ``(record, source, replaces)`` and the paths' launch
    counts."""
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
    return described, by_path


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
    phase_build(_build.build)
    k1, k1p = phase_feature_match(correlation)
    k1['train_shape'], k1p['train_shape'] = phase_feature_match(
        correlation, pairs=TRAIN_B * T, h=TRAIN_GT // 4, ties=False)
    torch.cuda.empty_cache()
    k2 = phase_mdcn(dcn)
    k2['train_shape'] = phase_mdcn(dcn, n=TRAIN_B * T, shapes=TRAIN_SHAPES)
    k2['video_shapes'] = phase_mdcn(dcn, video=True)
    k2b = phase_mdcn_backward(dcn)
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
    step_ms = {}
    for alignment in ('dcn', 'flow'):
        by_path[f'train_{alignment}'], step_ms[alignment] = phase_train(
            alignment, build_model, arch, dcn, kernels)
        torch.cuda.empty_cache()
    emit({'phase': 'train_ratio',
          'flow_steps_per_dcn_step': step_ms['dcn'] / step_ms['flow']})
    bf16_described, bf16_paths = bf16_phases(correlation, dcn, arch,
                                             build_model, kernels)
    by_path.update(bf16_paths)
    sg2 = (stylegan2_arch, ops_upfirdn2d, fused_act, kernels)
    by_path['stylegan2_serve'] = phase_stylegan2_serve(inference_stylegan2,
                                                       *sg2)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        by_path['stylegan2_train'] = phase_stylegan2_train(build_model, *sg2,
                                                           root)
    torch.cuda.empty_cache()
    by_path['basicvsrpp_serve'] = phase_basicvsrpp_serve(
        inference_basicvsr, inference_basicvsrpp, dcn, kernels)
    torch.cuda.empty_cache()
    by_path['edvr'] = phase_edvr(edvr_arch, arch_util, dcn, kernels)
    torch.cuda.empty_cache()
    by_path['basicvsr_serve'] = phase_basicvsr_serve(inference_basicvsr,
                                                     kernels)
    torch.cuda.empty_cache()
    by_path['ddp'], (k6, k6b) = phase_ddp()

    described = (
        (k1p, 'feature_match_prologue.cu', K1_PROLOGUE_TPU),
        (k1, 'feature_match.cu', K1_TPU),
        (k6, 'feature_match.cu', K6_TPU),
        *bf16_described,
        (k6b, 'feature_match_bf16.cu', K6_TPU),
        *((rec, 'mdcn_fused.cu', K2_TPU) for rec in [k2, *k2b]),
        *dcn_described,
        (k4f, 'deform_sample.cu', 'mrefsr_tpu/ops/dcn.py:296'),
        (k4b, 'deform_sample.cu', 'mrefsr_tpu/ops/dcn.py:296'),
        *((rec, 'upfirdn2d.cu', 'mrefsr_tpu/ops/upfirdn2d.py:13')
          for rec in k7),
        *((rec, 'fused_act.cu', 'mrefsr_tpu/ops/fused_act.py:12')
          for rec in k8))
    emit({'kernels': _described(described, by_path), 'card': smi})
    print(smi, flush=True)
    emit({'ok': True, 'device': device})


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
    described, by_path = bf16_phases(correlation, dcn, arch, build_model,
                                     kernels)
    emit({'kernels': _described(described, by_path), 'card': smi})
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
    """``--ddp``: the device, the build and the ``ddp`` phase alone, then
    K6's entry of the ``kernels`` line; no ``ok`` line."""
    from mrefsr_tpu_torch.ops import _build
    _, smi = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build(_build.build)
    launches, k6s = phase_ddp()
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
    else:
        main()
