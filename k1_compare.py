#!/usr/bin/env python3
"""Time K1 and the paths it sits on in one checkout, with that checkout's own
``chip_smoke.py`` phases, so that two commits can be compared in one call on
one card (run it once per checkout, in turns: A, B, B, A).

    python3 k1_compare.py --checkout DIR

``DIR`` is the root of a checkout (this one by default). From its
``chip_smoke.py`` the script runs: the device and build phases; K1's phase
(``feature_match``, with the prologue's where the checkout has one) at f32
and bf16, at the CUFED5 eval shape and the stage-3 training shape; the f32
and the bf16 CUFED5 request (``slice``, ``slice_bf16``) with a profile of
one request each; and the bf16 stage-3 ``dcn`` step with its profile. Each
phase prints its JSON line as in ``chip_smoke.py``. Every CUDA-event time
of those phases is the median of at least ``REPS`` runs after at least 3
warm-ups, by this script's timer put in place of the checkout's
``cuda_ms``, so that both checkouts are timed alike. Where the checkout
has K1's prologue, a last line (``k1_clocks``) runs K1 bf16 at the eval
shape back to back, the function and then the match kernel alone, while
``nvidia-smi`` samples the SM clock and the power draw. Needs one CUDA
device and ``nvcc``.
"""
import argparse
import importlib
import os
import statistics
import subprocess
import sys
import time

import torch

REPS = 20


def median_ms(fn, reps=3, warmup=1):
    """The median ms of ``fn`` over at least ``REPS`` runs after at least 3
    warm-ups, each run between its own pair of CUDA events."""
    for _ in range(max(warmup, 3)):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(max(reps, REPS))]
    torch.cuda.synchronize()
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def _sampled(fn, runs):
    """``fn`` run ``runs`` times back to back while ``nvidia-smi`` samples
    the SM clock (MHz) and the power draw (W) every 20 ms: the mean ms a run
    and the medians of the samples. A quarter as many runs go first, under
    the sampler too, so that no sample is taken on an idle card."""
    smi = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
         '--format=csv,noheader,nounits', '-lms', '20'],
        stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(runs // 4):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / runs
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [[float(v) for v in line.split(',')]
               for line in out.splitlines()[1:] if line.strip()]
    return {'ms_a_run': ms, 'samples': len(samples),
            'sm_clock_mhz': statistics.median(s[0] for s in samples),
            'power_w': statistics.median(s[1] for s in samples)}


def clock_probe(smoke, correlation, runs=200):
    """K1 bf16 at the eval shape: the function, then the match kernel alone
    on the same prologue outputs, each ``runs`` times back to back under
    :func:`_sampled`."""
    gen = torch.Generator().manual_seed(smoke.SEED)
    h = smoke.CANVAS // 4
    feats = torch.randn((2, smoke.T, h, h, 256), generator=gen).cuda()
    feats = (feats / (feats.norm(dim=-1, keepdim=True) + 1e-12)).to(
        smoke.BF16)
    fin, fref = feats[0], feats[1]
    pin, pref, _ = correlation._prologue_cuda(fin, fref, 3, 1, 1, True)
    for _ in range(3):
        correlation.feature_match_index(fin, fref, norm_input=True)
        correlation._match_patches_cuda(pin, pref)
    smoke.emit({'phase': 'k1_clocks', 'runs': runs,
                'function': _sampled(lambda: correlation.feature_match_index(
                    fin, fref, norm_input=True), runs),
                'kernel_only': _sampled(
                    lambda: correlation._match_patches_cuda(pin, pref), runs),
                'function_again': _sampled(
                    lambda: correlation.feature_match_index(
                        fin, fref, norm_input=True), runs)})


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--checkout', default=os.path.dirname(
        os.path.abspath(__file__)))
    args = parser.parse_args()
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    os.chdir(root)
    smoke = importlib.import_module('chip_smoke')
    smoke.cuda_ms = median_ms
    from mrefsr_tpu_torch.archs import ref_mrapa_restoration_arch as arch
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.ops import _build, correlation, dcn, fused_act
    ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')
    for module in (smoke, correlation):
        if not os.path.abspath(module.__file__).startswith(root + os.sep):
            raise RuntimeError(f'{module.__name__} came from '
                               f'{module.__file__}, not from {root}')

    smoke.emit({'phase': 'k1_compare', 'checkout': root})
    smoke.phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smoke.phase_build(_build.build)
    for dtype in (torch.float32, smoke.BF16):
        smoke.phase_feature_match(correlation, dtype=dtype)
        smoke.phase_feature_match(correlation, pairs=smoke.TRAIN_B * smoke.T,
                                  h=smoke.TRAIN_GT // 4, ties=False,
                                  dtype=dtype)
        torch.cuda.empty_cache()
    kernels = smoke.kernel_objects(correlation, dcn, ops_upfirdn2d, fused_act)
    for dtype in (torch.float32, smoke.BF16):
        _, model, batch = smoke.phase_slice(build_model, arch.DynAgg,
                                            correlation, dcn, kernels, dtype)

        def one_request():
            model.feed_data(batch)
            model.test()

        path = 'slice_bf16' if dtype == smoke.BF16 else 'slice'
        smoke.phase_profile(path, one_request)
        del model
        torch.cuda.empty_cache()
    smoke.phase_train('dcn', build_model, arch, dcn, kernels, smoke.BF16)
    torch.cuda.empty_cache()
    if hasattr(correlation, '_prologue_cuda'):
        clock_probe(smoke, correlation)


if __name__ == '__main__':
    main()
