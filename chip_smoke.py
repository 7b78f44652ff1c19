#!/usr/bin/env python3
"""Drive the port's 5-ref CUFED5 eval forward on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or
``/usr/local/cuda``). Phases, one JSON line each:

1. device: the card's name and count, and its power limit from
   ``nvidia-smi``;
2. build: both CUDA sources built with ``nvcc`` from this checkout, with
   ``-Xptxas -v``'s registers, shared memory and spills;
3. feature_match (kernel K1) against its plain PyTorch version at the
   eval shape, 5 pairs of (125, 125, 256) f32;
4. mdcn (kernel K2) against its plain version at the three eval shapes;
5. slice: ``MultiRefRestorationModel`` at full width (ngf 64, 16 blocks,
   8 deform groups) with seeded weights answers 3 requests of B = 1,
   T = 5 on a 500x500 canvas; the kernels' launch counts over those
   requests; then one request through the kernels and through the plain
   versions, compared;
6. profile: one more request under ``torch.profiler``, device time by
   kernel and the device's idle share;
7. the ``kernels`` line.

Then the card's name and power limit as ``nvidia-smi`` prints them, and
last ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without the last line. Times come from CUDA events
(phases 3, 4), the host clock around ``torch.cuda.synchronize()``
(phases 5, 6) and the profiler's device times (phase 6). Bounds use the
H100 SXM's published 67 TFLOP/s f32 (CUDA cores) and 3.35 TB/s.
"""
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
CANVAS, T, SEED = 500, 5, 0
K1_IDX_GAP, K1_VAL_TOL = 1e-4, 1e-5   # index may differ only on near-ties
K2_REL_TOL = 1e-4                     # max |kernel - plain| / max |plain|
SLICE_TOL = 1e-4                      # output is about [0, 1]


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'check failed: {msg}')


def cuda_ms(fn, reps=3, warmup=1):
    """Mean ms of ``fn`` over ``reps`` runs, from CUDA events."""
    for _ in range(warmup):
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


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
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


def phase_feature_match(correlation):
    gen = torch.Generator().manual_seed(SEED)
    h = CANVAS // 4
    feats = torch.randn((2, T, h, h, 256), generator=gen).cuda()
    feats = feats / (feats.norm(dim=-1, keepdim=True) + 1e-12)
    fin, fref = feats[0], feats[1]
    kw = dict(is_norm=True, norm_input=True)
    idx_k, val_k = correlation.feature_match_index(fin, fref, **kw)
    idx_p, val_p = correlation.feature_match_index_ref(fin, fref, **kw)

    pin = correlation.sample_patches(fin)
    pref = correlation.sample_patches(fref)
    pref = pref / (pref.norm(dim=2, keepdim=True) + 1e-5)

    def score(idx):
        rows = pref.gather(1, idx.reshape(T, -1, 1).long().expand(
            -1, -1, pref.shape[2]))
        return (pin * rows).sum(2)

    differ = idx_k.reshape(T, -1) != idx_p.reshape(T, -1)
    gap = (score(idx_p) - score(idx_k)).abs()[differ]
    worst_gap = float(gap.max()) if gap.numel() else 0.0
    val_err = float((val_k - val_p).abs().max())
    check(worst_gap <= K1_IDX_GAP, f'feature_match index differs where the '
          f'plain scores differ by {worst_gap}')
    check(val_err <= K1_VAL_TOL, f'feature_match val error {val_err}')

    ties = _feature_match_ties(correlation)

    n_in, d = pin.shape[1:]
    n_ref = pref.shape[1]
    ms = cuda_ms(lambda: correlation.feature_match_index(fin, fref, **kw))
    kernel_ms = cuda_ms(lambda: correlation._match_patches_cuda(pin, pref))
    plain_ms = cuda_ms(
        lambda: correlation.feature_match_index_ref(fin, fref, **kw), reps=2)
    library_ms = cuda_ms(lambda: torch.matmul(pin, pref.transpose(1, 2)))
    bound_ms, bound_by = bound(2.0 * T * n_in * n_ref * d,
                               4.0 * 2 * fin.numel() + 8.0 * T * n_in)
    rec = {'name': 'feature_match', 'max_abs_err': val_err, 'ms': ms,
           'kernel_only_ms': kernel_ms, 'plain_ms': plain_ms,
           'bound_ms': bound_ms, 'bound_by': bound_by,
           'library_ms': library_ms,
           'library_call': 'torch.matmul of the (5, 15129, 2304) x '
                           '(5, 2304, 15129) score product alone'}
    emit({'phase': 'feature_match', 'pairs': T, 'n_in': n_in,
          'n_ref': n_ref, 'd': d, 'index_disagreements': int(differ.sum()),
          'worst_disagreement_gap': worst_gap, 'exact_ties': ties, **rec})
    return rec


def _feature_match_ties(correlation):
    """Exact ties on the card: features in {-1, 0, 1}, C = 1 (d = 9, not a
    multiple of the kernel's d slice), 40x40 maps, so equal ref patches
    are common, across threads, tiles and blocks, and every score is an
    exact integer. The kernel must return the lowest index of each max."""
    gen = torch.Generator().manual_seed(SEED + 3)
    feats = torch.randint(-1, 2, (2, 2, 40, 40, 1), generator=gen)
    fin, fref = feats.float().cuda()
    idx, val = correlation.feature_match_index(fin, fref, is_norm=False)
    pin = correlation.sample_patches(fin)
    pref = correlation.sample_patches(fref)
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


def _mdcn_inputs(gen, c, h, dg=8):
    n, k = T, 9
    x = torch.randn((n, h, h, c), generator=gen)
    offset = torch.randn((n, h, h, dg, k, 2), generator=gen) * 4
    mask = torch.rand((n, h, h, dg, k), generator=gen)
    weight = torch.randn((3, 3, c, c), generator=gen) * 0.02
    bias = torch.randn((c,), generator=gen) * 0.1
    return [t.cuda() for t in (x, offset, mask, weight, bias)]


def phase_mdcn(dcn):
    gen = torch.Generator().manual_seed(SEED + 1)
    total = {'ms': 0.0, 'kernel_only_ms': 0.0, 'plain_ms': 0.0,
             'bound_ms': 0.0, 'library_ms': 0.0, 'flops': 0.0, 'bytes': 0.0}
    worst = 0.0
    for c, h in ((256, CANVAS // 4), (128, CANVAS // 2), (64, CANVAS)):
        x, offset, mask, weight, bias = _mdcn_inputs(gen, c, h)
        args = (x, offset, mask, weight, bias)
        kw = dict(deform_groups=8)
        out_k = dcn.modulated_deform_conv2d(*args, **kw)
        out_p = dcn.modulated_deform_conv2d_ref(*args, **kw)
        err = float((out_k - out_p).abs().max())
        scale = float(out_p.abs().max())
        check(err <= K2_REL_TOL * scale, f'mdcn C={c}: error {err} against '
              f'max |out| {scale}')
        worst = max(worst, err)
        del out_k, out_p

        rows = T * h * h
        chunk = dcn.COL_CAP_BYTES // (9 * c * 4)
        geom = ((3, 3), (1, 1), (1, 1), (1, 1), (h, h))

        def im2col_only():
            for row0 in range(0, rows, chunk):
                dcn._im2col_cuda(x, offset, mask, row0,
                                 min(chunk, rows - row0), geom)

        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = weight.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        flops = 2.0 * rows * 9 * c * c + 9.0 * rows * 9 * c
        nbytes = 4.0 * (x.numel() + offset.numel() + mask.numel()
                        + weight.numel() + bias.numel() + rows * c)
        shape = {
            'ms': cuda_ms(lambda: dcn.modulated_deform_conv2d(*args, **kw)),
            'kernel_only_ms': cuda_ms(im2col_only),
            'plain_ms': cuda_ms(
                lambda: dcn.modulated_deform_conv2d_ref(*args, **kw),
                reps=1),
            'library_ms': cuda_ms(lambda: torch.nn.functional.conv2d(
                x_nchw, w_oihw, bias, padding=1)),
            'bound_ms': bound(flops, nbytes)[0], 'flops': flops,
            'bytes': nbytes}
        emit({'phase': 'mdcn', 'n': T, 'c': c, 'h': h, 'w': h,
              'deform_groups': 8, 'max_abs_err': err, 'max_abs_out': scale,
              'bound_by': bound(flops, nbytes)[1], **shape})
        for key in total:
            total[key] += shape[key]
        del x, offset, mask, weight, bias, args, x_nchw, w_oihw
        torch.cuda.empty_cache()
    flops, nbytes = total.pop('flops'), total.pop('bytes')
    return {'name': 'mdcn_im2col', 'max_abs_err': worst, **total,
            'bound_by': bound(flops, nbytes)[1],
            'library_call': 'F.conv2d (cuDNN) of the same shapes: the same '
                            'conv with zero offsets and unit mask'}


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


def _request(rng):
    lq = CANVAS // 4
    return {
        'img_in': rng.rand(1, CANVAS, CANVAS, 3).astype(np.float32),
        'img_in_lq': rng.rand(1, lq, lq, 3).astype(np.float32),
        'img_in_up': rng.rand(1, CANVAS, CANVAS, 3).astype(np.float32),
        'img_ref_list': rng.rand(1, T, CANVAS, CANVAS, 3).astype(np.float32),
    }


def phase_slice(build_model, dyn_agg_cls, correlation, dcn, kernels):
    model = build_model(_cufed5_opt())
    check(model.device.type == 'cuda', f'model built on {model.device}')
    gen = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():  # fractional sampling: non-zero offset convs
        for m in model.net_g.modules():
            if isinstance(m, dyn_agg_cls):
                w = m.conv_offset_mask.weight
                w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
                b = m.conv_offset_mask.bias
                b.copy_(torch.rand(b.shape, generator=gen) * 2 - 1)
    rng = np.random.RandomState(SEED)
    requests = [_request(rng) for _ in range(3)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in kernels.values():
        kernel.launches = 0
    request_ms = []
    for batch in requests:
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.test()
        rlt = model.get_current_visuals()['rlt']
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        check(rlt.shape == (1, CANVAS, CANVAS, 3), f'output {rlt.shape}')
        check(bool(np.isfinite(rlt).all()), 'non-finite output')
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        check(n > 0, f'kernel {name} was not launched on the main path')

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
            -1, -1, pref.shape[2]))
        rows_p = pref.gather(1, idx_p.long()[..., None].expand(
            -1, -1, pref.shape[2]))
        gap = ((pin * rows_p).sum(2) - (pin * rows_k).sum(2)).abs()[differ]
        record['disagree'] = int(differ.sum())
        record['gap'] = float(gap.max()) if gap.numel() else 0.0
        return record['match']

    model.feed_data(requests[0])
    with mock.patch.object(correlation, '_match_patches_cuda',
                           match_recorded):
        model.test()
    out_k = model.output.clone()
    with mock.patch.object(correlation, '_match_patches_cuda', match_plain), \
            mock.patch.object(dcn, '_im2col_cuda', dcn._im2col_ref):
        model.test()
    diff = float((model.output - out_k).abs().max())
    check(record['gap'] <= K1_IDX_GAP, f'slice match differs where the plain '
          f'scores differ by {record["gap"]}')
    check(diff <= SLICE_TOL,
          f'slice output: kernels vs plain differ by {diff}')
    emit({'phase': 'slice', 'canvas': CANVAS, 'refs': T, 'batch': 1,
          'ngf': 64, 'n_blocks': 16, 'groups': 8, 'request_ms': request_ms,
          'peak_mem_bytes': peak, 'launches': launches,
          'plain_vs_kernel_max_abs_diff': diff, 'tolerance': SLICE_TOL,
          'match_disagreements': record['disagree'],
          'worst_disagreement_gap': record['gap']})
    return launches, model, requests[1]


def phase_profile(model, batch, top=12):
    """One more request under torch.profiler: device time by kernel, and
    the share of the request's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model.feed_data(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.test()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_ms(event):
        us = getattr(event, 'self_device_time_total', None)
        return (event.self_cuda_time_total if us is None else us) / 1e3

    kernels = sorted(((device_ms(e), e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    emit({'phase': 'profile', 'wall_ms': wall_ms, 'device_busy_ms': busy,
          'device_idle_share': 1 - busy / wall_ms if busy else None,
          'top_kernels': [{'ms': ms, 'calls': n, 'name': name[:90]}
                          for ms, n, name in kernels[:top]]})


def main():
    from mrefsr_tpu_torch.archs.ref_mrapa_restoration_arch import DynAgg
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.ops import _build, correlation, dcn

    device, smi = phase_device()
    # f32 throughout, the yardsticks included: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build(_build.build)
    k1 = phase_feature_match(correlation)
    torch.cuda.empty_cache()
    k2 = phase_mdcn(dcn)
    kernels = {'feature_match': correlation.feature_match_kernel,
               'mdcn_im2col': dcn.mdcn_im2col_kernel}
    launches, model, batch = phase_slice(build_model, DynAgg, correlation,
                                         dcn, kernels)
    phase_profile(model, batch)

    k1.update(route='cuda',
              source='mrefsr_tpu_torch/ops/csrc/feature_match.cu',
              replaces='mrefsr_tpu/ops/correlation.py:42',
              launches=launches['feature_match'])
    k2.update(route='cuda', source='mrefsr_tpu_torch/ops/csrc/mdcn.cu',
              replaces='mrefsr_tpu/ops/dcn.py:111',
              launches=launches['mdcn_im2col'])
    emit({'kernels': [k1, k2], 'card': smi})
    print(smi, flush=True)
    emit({'ok': True, 'device': device})


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
