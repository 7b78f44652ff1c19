#!/usr/bin/env python3
"""Drive the port's main paths on one NVIDIA GPU: the 5-ref CUFED5 eval
forward and the stage-3 training step with both alignments.

    python3 chip_smoke.py        # from the root of a checkout

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or
``/usr/local/cuda``). Phases, one JSON line each (one per shape where a
phase runs several):

1. device: the card's name and count, and its power limit from
   ``nvidia-smi``;
2. build: the CUDA sources built with ``nvcc`` from this checkout, with
   ``-Xptxas -v``'s registers, shared memory and spills;
3. feature_match (kernel K1) against its plain PyTorch version at the
   eval shape, 5 pairs of (125, 125, 256) f32, and at the training
   shape, 30 pairs of (40, 40, 256);
4. mdcn (kernel K2, forward) against its plain version at the three eval
   shapes;
5. mdcn_backward (K2's backward: kernel ``mdcn_col2im`` and two matmuls)
   against autograd through the plain version at the three training
   shapes (N = 30), and with integer offsets and samples on the border;
6. deform_sample (kernel K4, forward and backward) against its plain
   version at the three training shapes, and bit for bit against ``x``
   indexed at the shifted positions for integer flows;
7. slice: ``MultiRefRestorationModel`` at full width (ngf 64, 16 blocks,
   8 deform groups) with seeded weights answers 2 requests of B = 1,
   T = 5 on a 500x500 canvas; the kernels' launch counts over those
   requests; then one request through the kernels and through the plain
   versions, compared; profile: one more request under
   ``torch.profiler``, device time by kernel and the device's idle share;
8. train_dcn and train_flow: the same model built for training
   (``alignment`` dcn, then flow) takes one warm-up and five timed steps
   at B = 6, gt 160, T = 5, f32 on one repeated batch; the launch counts
   over the five steps (no launch may scatter a grad x: the sampled
   features are frozen); at B = 1, from the fresh and from the trained
   weights, every parameter's gradient through the kernels against the
   plain versions; then a profile of one step;
9. the ``kernels`` line.

Then the card's name and power limit as ``nvidia-smi`` prints them, and
last ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without the last line. Times come from CUDA events
(phases 3 to 6), the host clock around ``torch.cuda.synchronize()``
(phases 7, 8) and the profiler's device times. Bounds use the H100 SXM's
published 67 TFLOP/s f32 (CUDA cores) and 3.35 TB/s.
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


def phase_feature_match(correlation, pairs=T, h=CANVAS // 4, ties=True):
    """K1 against its plain version on ``pairs`` pairs of (h, h, 256)
    maps: the eval shape by default."""
    T = pairs  # noqa: N806 (the pair count, whatever the module's T)
    gen = torch.Generator().manual_seed(SEED)
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

    ties = _feature_match_ties(correlation) if ties else None

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
           'library_call': f'torch.matmul of the ({T}, {n_in}, {d}) x '
                           f'({T}, {d}, {n_ref}) score product alone'}
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


def _mdcn_inputs(gen, c, h, dg=8, n=T):
    k = 9
    x = torch.randn((n, h, h, c), generator=gen)
    offset = torch.randn((n, h, h, dg, k, 2), generator=gen) * 4
    mask = torch.rand((n, h, h, dg, k), generator=gen)
    weight = torch.randn((3, 3, c, c), generator=gen) * 0.02
    bias = torch.randn((c,), generator=gen) * 0.1
    return [t.cuda() for t in (x, offset, mask, weight, bias)]


def phase_mdcn(dcn, n=T, shapes=EVAL_SHAPES):
    """K2's forward (mdcn_im2col + matmul) against its plain version on
    ``n`` maps per shape: the eval shapes by default."""
    gen = torch.Generator().manual_seed(SEED + 1)
    total = {'ms': 0.0, 'kernel_only_ms': 0.0, 'plain_ms': 0.0,
             'bound_ms': 0.0, 'library_ms': 0.0, 'flops': 0.0, 'bytes': 0.0}
    worst = 0.0
    for c, h in shapes:
        x, offset, mask, weight, bias = _mdcn_inputs(gen, c, h, n=n)
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

        rows = n * h * h
        geom = ((3, 3), (1, 1), (1, 1), (1, 1), (h, h))

        def im2col_only():
            for row0, nrows in dcn._row_chunks(rows, 9, c, 4):
                dcn._im2col_cuda(x, offset, mask, row0, nrows, geom)

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
        emit({'phase': 'mdcn', 'n': n, 'c': c, 'h': h, 'w': h,
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


TRAIN_B, TRAIN_GT = 6, 160              # options/train/stage3_5ref_*.yml
TRAIN_SHAPES = tuple((c, TRAIN_GT // d) for c, d in ((256, 4), (128, 2),
                                                     (64, 1)))
# max |kernel - plain| / max |plain| of each gradient: f32 sums over a
# group's channels (and, for grad x, atomic adds) in another order
GRAD_REL_TOL = 1e-4


def _rel_err(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _sum_records(name, shapes, extra):
    """One ``kernels`` entry out of a kernel's per-shape records."""
    keys = ('ms', 'kernel_only_ms', 'plain_ms', 'bound_ms', 'library_ms')
    total = {k: sum(rec[k] for rec in shapes) for k in keys}
    flops = sum(rec['flops'] for rec in shapes)
    nbytes = sum(rec['bytes'] for rec in shapes)
    return {'name': name,
            'max_abs_err': max(rec['max_abs_err'] for rec in shapes),
            'max_rel_err': max(rec['max_rel_err'] for rec in shapes),
            **total, 'bound_by': bound(flops, nbytes)[1], **extra}


def _mdcn_grads(fn, args, cot, wrt):
    inputs = [a.detach().requires_grad_(i in wrt)
              for i, a in enumerate(args)]
    out = fn(*inputs, deform_groups=8)
    return torch.autograd.grad(out, [inputs[i] for i in wrt], cot)


def _mdcn_backward_integer_case(dcn, gen):
    """Integer offsets on a 40x40 map, as a fresh net has them: every
    sample sits on a pixel, many of them exactly on row or column -1 or
    H - 1, where one corner row lies outside."""
    c, h = 256, TRAIN_GT // 4
    x, offset, mask, weight, bias = _mdcn_inputs(gen, c, h)
    offset = torch.randint(-3, 4, offset.shape, generator=gen).float().cuda()
    cot = torch.randn((T, h, h, c), generator=gen).cuda()
    base = torch.arange(h, device='cuda').view(1, h, 1, 1, 1) - 1 \
        + (torch.arange(9, device='cuda') // 3).view(1, 1, 1, 1, 9)
    fy = base + offset[..., 0]
    on_edge = int(((fy == -1) | (fy == h - 1)).sum())
    check(on_edge > 0, 'the integer case holds no sample on row -1 or H - 1')
    args = (x, offset, mask, weight, bias)
    got = _mdcn_grads(dcn.modulated_deform_conv2d, args, cot, range(5))
    want = _mdcn_grads(dcn.modulated_deform_conv2d_ref, args, cot, range(5))
    errs = {}
    for name, g, w in zip(('x', 'offset', 'mask', 'weight', 'bias'), got,
                          want):
        errs[name] = _rel_err(g, w)
        check(errs[name] <= GRAD_REL_TOL, f'mdcn backward, integer offsets: '
              f'grad {name} differs by {errs[name]} of its max')
    check(float(got[1].abs().max()) > 0, 'grad offset is zero at integer '
          'offsets')
    return {'samples_on_edge_rows': on_edge, 'rel_err': errs}


def phase_mdcn_backward(dcn):
    """K2's backward (mdcn_col2im + two matmuls) against autograd through
    the plain version, at the three training shapes."""
    gen = torch.Generator().manual_seed(SEED + 4)
    n = TRAIN_B * T
    names = ('x', 'offset', 'mask', 'weight', 'bias')
    shapes = []
    for c, h in TRAIN_SHAPES:
        args = [t.repeat(TRAIN_B, *[1] * (t.dim() - 1)) if i < 3 else t
                for i, t in enumerate(_mdcn_inputs(gen, c, h))]
        args[1] = args[1] * 0.5 + torch.randn(args[1].shape, generator=gen,
                                              device='cpu').cuda()
        x, offset, mask, weight, bias = args
        cot = torch.randn((n, h, h, c), generator=gen).cuda()
        got = _mdcn_grads(dcn.modulated_deform_conv2d, args, cot, range(5))
        want = _mdcn_grads(dcn.modulated_deform_conv2d_ref, args, cot,
                           range(5))
        errs, abs_err = {}, 0.0
        for name, g, w in zip(names, got, want):
            errs[name] = _rel_err(g, w)
            abs_err = max(abs_err, float((g - w).abs().max()))
            check(errs[name] <= GRAD_REL_TOL, f'mdcn backward C={c}: grad '
                  f'{name} differs by {errs[name]} of its max')
        del got, want

        # as the training step runs it: x is a frozen feature, no grad x
        wrt = (1, 2, 3, 4)
        inputs = [a.detach().requires_grad_(i in wrt)
                  for i, a in enumerate(args)]
        out_k = dcn.modulated_deform_conv2d(*inputs, deform_groups=8)
        grad_k = lambda: torch.autograd.grad(  # noqa: E731
            out_k, inputs[1:], cot, retain_graph=True)
        rows = n * h * h
        geom = ((3, 3), (1, 1), (1, 1), (1, 1), (h, h))
        chunks = dcn._row_chunks(rows, 9, c, 4)
        grad_col = torch.randn((chunks[0][1], 9, c), device='cuda')
        g_off, g_mask = torch.empty_like(offset), torch.empty_like(mask)
        g_x = torch.zeros_like(x)

        def col2im_only(grad_x=None):
            for row0, nrows in chunks:
                dcn._col2im_cuda(grad_col[:nrows], x, offset, mask, g_off,
                                 g_mask, grad_x, row0, nrows, geom)

        ms = cuda_ms(grad_k)
        kernel_ms = cuda_ms(col2im_only)
        scatter_ms = cuda_ms(lambda: col2im_only(g_x))
        del out_k, grad_col, g_off, g_mask, g_x
        out_p = dcn.modulated_deform_conv2d_ref(*inputs, deform_groups=8)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            out_p, inputs[1:], cot, retain_graph=True), reps=1)
        del out_p
        torch.cuda.empty_cache()
        x_nchw = x.permute(0, 3, 1, 2).requires_grad_()
        w_oihw = weight.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        b_lib = bias.detach().requires_grad_()
        out_l = torch.nn.functional.conv2d(x_nchw, w_oihw, b_lib, padding=1)
        cot_l = cot.permute(0, 3, 1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            out_l, (x_nchw, w_oihw, b_lib), cot_l, retain_graph=True))
        del out_l
        # two matmuls (grad weight, grad columns) and the bilinear
        # derivative per column element; bytes without grad x
        flops = 4.0 * rows * 9 * c * c + 20.0 * rows * 9 * c
        nbytes = 4.0 * (cot.numel() + x.numel() + 2 * offset.numel()
                        + 2 * mask.numel() + 2 * weight.numel()
                        + bias.numel())
        rec = {'ms': ms, 'kernel_only_ms': kernel_ms,
               'kernel_only_with_grad_x_ms': scatter_ms,
               'plain_ms': plain_ms, 'library_ms': library_ms,
               'bound_ms': bound(flops, nbytes)[0], 'flops': flops,
               'bytes': nbytes, 'max_abs_err': abs_err,
               'max_rel_err': max(errs.values())}
        emit({'phase': 'mdcn_backward', 'n': n, 'c': c, 'h': h, 'w': h,
              'deform_groups': 8, 'chunks': len(chunks), 'rel_err': errs,
              'tolerance': GRAD_REL_TOL,
              'bound_by': bound(flops, nbytes)[1], **rec})
        shapes.append(rec)
        del args, inputs, x, offset, mask, weight, bias, cot, cot_l
        del x_nchw, w_oihw, b_lib
        torch.cuda.empty_cache()
    emit({'phase': 'mdcn_backward', 'case': 'integer offsets',
          'tolerance': GRAD_REL_TOL,
          **_mdcn_backward_integer_case(dcn, gen)})
    return _sum_records('mdcn_col2im', shapes, {
        'library_call': 'autograd of F.conv2d (cuDNN) at the same shapes: '
                        'grad input, grad weight and grad bias'})


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


def phase_deform_sample(dcn):
    """K4 (deform_sample forward and backward kernels) against its plain
    version at the three training shapes, and its gather (the Pallas
    experiment's row gather) bit for bit with integer flows."""
    gen = torch.Generator().manual_seed(SEED + 5)
    n, dg = TRAIN_B * T, 8
    fwd, bwd = [], []
    for c, h in TRAIN_SHAPES:
        x = torch.randn((n, h, h, c), generator=gen).cuda()
        flow = (torch.randn((n, h, h, dg, 2), generator=gen) * 3).cuda()
        cot = torch.randn((n, h, h, c), generator=gen).cuda()

        def grads(fn, wrt=(0, 1)):
            inputs = [x.detach().requires_grad_(0 in wrt),
                      flow.detach().requires_grad_(1 in wrt)]
            out = fn(*inputs)
            return out, inputs, torch.autograd.grad(
                out, [inputs[i] for i in wrt], cot, retain_graph=True)

        out_k, _, (gx_k, gf_k) = grads(dcn.deform_sample)
        out_p, _, (gx_p, gf_p) = grads(dcn.deform_sample_ref)
        err_out = float((out_k - out_p).detach().abs().max())
        rel_out = err_out / float(out_p.detach().abs().max())
        check(rel_out <= 1e-5, f'deform_sample C={c}: forward error '
              f'{err_out}, {rel_out} of max |out|')
        errs = {'x': _rel_err(gx_k, gx_p), 'flow': _rel_err(gf_k, gf_p)}
        for name, e in errs.items():
            check(e <= GRAD_REL_TOL, f'deform_sample C={c}: grad {name} '
                  f'differs by {e} of its max')
        err_grad = max(float((gx_k - gx_p).abs().max()),
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
        grid = _grid_for(flow).requires_grad_()
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
                out_l.shape)).abs().max())
        numel = float(x.numel())
        # some 30 operations per 4 output values, forward and backward
        rec_f = {
            'ms': cuda_ms(lambda: dcn.deform_sample(x, flow)),
            'plain_ms': cuda_ms(lambda: dcn.deform_sample_ref(x, flow)),
            'library_ms': cuda_ms(library),
            'flops': 8.0 * numel,
            'bytes': 4.0 * (2 * numel + flow.numel()),
            'max_abs_err': err_out, 'max_rel_err': rel_out}
        rec_b = {
            'ms': cuda_ms(lambda: torch.autograd.grad(
                out_k, inp_k[1], cot, retain_graph=True)),
            'with_grad_x_ms': cuda_ms(lambda: torch.autograd.grad(
                out_kx, inp_kx, cot, retain_graph=True)),
            'plain_ms': cuda_ms(lambda: torch.autograd.grad(
                out_p, inp_p[1], cot, retain_graph=True)),
            'library_ms': cuda_ms(lambda: torch.autograd.grad(
                out_l, grid, cot_lib, retain_graph=True)),
            'flops': 12.0 * numel,
            'bytes': 4.0 * (2 * numel + 2 * flow.numel()),
            'max_abs_err': err_grad, 'max_rel_err': max(errs.values())}
        for rec in (rec_f, rec_b):
            rec['kernel_only_ms'] = rec['ms']
            rec['bound_ms'], rec['bound_by'] = bound(rec['flops'],
                                                     rec['bytes'])
        emit({'phase': 'deform_sample', 'n': n, 'c': c, 'h': h, 'w': h,
              'deform_groups': dg, 'integer_flow_bit_exact': exact,
              'grad_rel_err': errs, 'tolerance': GRAD_REL_TOL,
              'library_vs_plain_max_abs_diff': lib_err,
              'forward': rec_f, 'backward': rec_b})
        fwd.append(rec_f)
        bwd.append(rec_b)
        del x, flow, cot, iflow, out_k, out_kx, out_p, out_l, inp_k, inp_kx
        del inp_p, grid, x_lib, cot_lib
        torch.cuda.empty_cache()
    call = ('F.grid_sample on the (N * dg, cg, H, W) view, bilinear, zeros, '
            'align_corners=True')
    return (_sum_records('deform_sample_fwd', fwd, {'library_call': call}),
            _sum_records('deform_sample_bwd', bwd, {
                'library_call': call + ': its autograd in the grid'}))


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


def reset_counts(kernels):
    for kernel in kernels.values():
        kernel.launches = 0


def read_counts(kernels, expect, forbid=()):
    """The launch counts since :func:`reset_counts`; every kernel of
    ``expect`` must have been launched and none of ``forbid``."""
    launches = {name: k.launches for name, k in kernels.items()}
    for name in expect:
        check(launches[name] > 0,
              f'kernel {name} was not launched on the main path')
    for name in forbid:
        check(launches[name] == 0,
              f'kernel {name} was launched {launches[name]} times on a '
              f'path that needs no grad x')
    return launches


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
        check(bool(np.isfinite(rlt).all()), 'non-finite output')
    launches = read_counts(kernels, ('feature_match', 'mdcn_im2col'))
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


# max |kernel - plain| / max |plain| of each parameter's gradient after a
# whole backward of net_g. From fresh weights both paths sample on whole
# pixels and their forwards agree bit for bit, so the gradients differ by
# the order of f32 sums only (cuDNN's weight gradients alone move by about
# 2e-5 of a tensor's max from run to run). After a few steps the samples
# are fractional, the two forwards differ in the last bit, and here and
# there a ReLU gate of a residual block falls on the other side: one gate
# moves the gradient of the conv before it by about 1 / sqrt(positions) of
# its size (1 % at 40x40). So the trained comparison asks for most tensors
# within TOL and every tensor within LOOSE.
TRAIN_GRAD_REL_TOL = 1e-3
TRAIN_GRAD_LOOSE_TOL = 5e-2
TRAIN_GRAD_SHARE = 0.8


def _grads_by_name(model, arch, dcn, batch):
    """One backward of net_g's pixel loss from the current weights on
    fixed reference inputs, through the kernels (key False) and through
    the plain versions (key True)."""
    model.feed_data(batch)
    with torch.no_grad():
        pre_offset, img_ref_feat = model._ref_inputs(model.match_img_in,
                                                     model.img_ref_list)
    out = {}
    for use_plain in (False, True):
        model.net_g.zero_grad(set_to_none=True)
        with mock.patch.object(
                arch, 'modulated_deform_conv2d',
                dcn.modulated_deform_conv2d_ref if use_plain
                else dcn.modulated_deform_conv2d), mock.patch.object(
                    arch, 'deform_sample', dcn.deform_sample_ref
                    if use_plain else dcn.deform_sample):
            rlt = model.net_g(model.img_in_lq.permute(0, 3, 1, 2),
                              pre_offset, img_ref_feat).permute(0, 2, 3, 1)
            model.cri_pix(rlt, model.gt).backward()
        out[use_plain] = {name: p.grad.clone()
                          for name, p in model.net_g.named_parameters()}
    model.net_g.zero_grad(set_to_none=True)
    return out


def _compare_grads(model, arch, dcn, batch):
    """Every net_g parameter's gradient through the kernels against the
    plain versions, each error as a share of the plain gradient's max."""
    grads = _grads_by_name(model, arch, dcn, batch)
    rel = {}
    for name, want in grads[True].items():
        scale = float(want.abs().max())
        err = float((grads[False][name] - want).abs().max())
        rel[name] = err / scale if scale else float(err > 0)
    worst = max(rel, key=rel.get)
    return {'tensors': len(rel), 'worst': rel[worst], 'worst_name': worst,
            'share_within_tol': sum(v <= TRAIN_GRAD_REL_TOL
                                    for v in rel.values()) / len(rel)}


def phase_train(alignment, build_model, arch, dcn, kernels):
    """Five timed training steps of the full-width model at B = 6,
    gt 160, T = 5 on one repeated batch, through ``feed_data`` ->
    ``optimize_parameters`` -> ``get_current_log``; before and after
    them, at B = 1, one backward through the kernels against one through
    the plain versions."""
    expect = ('feature_match',) + (
        ('mdcn_im2col', 'mdcn_col2im') if alignment == 'dcn'
        else ('deform_sample_fwd', 'deform_sample_bwd'))
    opt = _train_opt(alignment)
    model = build_model(opt)
    check(model.device.type == 'cuda', f'model built on {model.device}')
    rng = np.random.RandomState(SEED + 6)
    batch, small = _train_batch(rng, TRAIN_B), _train_batch(rng, 1)
    fresh = _compare_grads(model, arch, dcn, small)
    check(fresh['worst'] <= TRAIN_GRAD_REL_TOL, f'{alignment}, fresh '
          f'weights: kernels and plain versions give other gradients: '
          f'{fresh}')
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
    launches = read_counts(
        kernels, expect, ('mdcn_col2im_scatter', 'deform_sample_bwd_scatter'))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(v) for v in [warmup_loss] + losses),
          f'non-finite loss: {[warmup_loss] + losses}')
    check(losses[-1] < losses[0], f'the loss did not fall: {losses}')
    lrs = model.get_current_learning_rate()
    check(lrs == [1e-4, 1e-4, 1e-6, 1e-5], f'learning rates {lrs}')

    trained = _compare_grads(model, arch, dcn, small)
    check(trained['share_within_tol'] >= TRAIN_GRAD_SHARE
          and trained['worst'] <= TRAIN_GRAD_LOOSE_TOL,
          f'{alignment}, after 6 steps: kernels and plain versions give '
          f'other gradients: {trained}')
    mean_ms = sum(step_ms) / len(step_ms)
    emit({'phase': f'train_{alignment}', 'batch': TRAIN_B, 'gt': TRAIN_GT,
          'refs': T, 'network_g': opt['network_g'], 'dtype': 'float32',
          'step_ms': step_ms, 'mean_step_ms': mean_ms,
          'img_per_s': TRAIN_B / mean_ms * 1e3, 'peak_mem_bytes': peak,
          'warmup_loss': warmup_loss, 'losses': losses,
          'learning_rates': lrs, 'launches_5_steps': launches,
          'grads_fresh_weights': fresh, 'grads_after_6_steps': trained,
          'grad_tolerance': TRAIN_GRAD_REL_TOL,
          'grad_loose_tolerance': TRAIN_GRAD_LOOSE_TOL,
          'grad_share_required': TRAIN_GRAD_SHARE})

    def one_step():
        model.feed_data(batch)
        model.optimize_parameters(7)

    phase_profile(f'train_{alignment}', one_step)
    return launches, mean_ms


# how the profile sorts device kernels: the hand-written ones by name,
# cuDNN's and cuBLAS's (convolutions, their layout changes and FFTs, and
# matmuls) by these marks, the rest (element-wise, reductions, copies,
# Adam) as other
OWN_KERNELS = ('feature_match_kernel', 'mdcn_im2col_kernel',
               'mdcn_col2im_kernel', 'deform_sample_fwd_kernel',
               'deform_sample_bwd_kernel')
LIBRARY_MARKS = ('xmma', 'cudnn', 'cutlass', 'gemm', 'gemv', 'DSE::',
                 'fft', 'region_transform', 'cublas', 'wgrad', 'dgrad')


def phase_profile(path, run, top=12):
    """``run()`` once more under torch.profiler: device time by kernel,
    and the share of its wall time the device was busy."""
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

    kernels = sorted(((device_ms(e), e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    own = {name: sum(ms for ms, _, key in kernels if name in key)
           for name in OWN_KERNELS}
    library = sum(ms for ms, _, key in kernels
                  if any(mark in key for mark in LIBRARY_MARKS))
    emit({'phase': 'profile', 'path': path, 'wall_ms': wall_ms,
          'device_busy_ms': busy,
          'device_idle_share': 1 - busy / wall_ms if busy else None,
          'hand_written_ms': own, 'cudnn_cublas_ms': library,
          'other_ms': busy - library - sum(own.values()),
          'top_kernels': [{'ms': ms, 'calls': n, 'name': name[:90]}
                          for ms, n, name in kernels[:top]]})


def main():
    from mrefsr_tpu_torch.archs import ref_mrapa_restoration_arch as arch
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.ops import _build, correlation, dcn

    device, smi = phase_device()
    # f32 throughout, the yardsticks included: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build(_build.build)
    k1 = phase_feature_match(correlation)
    k1['train_shape'] = phase_feature_match(
        correlation, pairs=TRAIN_B * T, h=TRAIN_GT // 4, ties=False)
    torch.cuda.empty_cache()
    k2 = phase_mdcn(dcn)
    k2['train_shape'] = phase_mdcn(dcn, n=TRAIN_B * T, shapes=TRAIN_SHAPES)
    k2b = phase_mdcn_backward(dcn)
    k4f, k4b = phase_deform_sample(dcn)
    kernels = {'feature_match': correlation.feature_match_kernel,
               'mdcn_im2col': dcn.mdcn_im2col_kernel,
               'mdcn_col2im': dcn.mdcn_col2im_kernel,
               'mdcn_col2im_scatter': dcn.mdcn_col2im_scatter_kernel,
               'deform_sample_fwd': dcn.deform_sample_fwd_kernel,
               'deform_sample_bwd': dcn.deform_sample_bwd_kernel,
               'deform_sample_bwd_scatter':
                   dcn.deform_sample_bwd_scatter_kernel}
    by_path = {}
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

    csrc = 'mrefsr_tpu_torch/ops/csrc/'
    described = (
        (k1, 'feature_match.cu', 'mrefsr_tpu/ops/correlation.py:42'),
        (k2, 'mdcn.cu', 'mrefsr_tpu/ops/dcn.py:111'),
        (k2b, 'mdcn.cu', 'mrefsr_tpu/ops/dcn.py:111'),
        (k4f, 'deform_sample.cu', 'mrefsr_tpu/ops/dcn.py:296'),
        (k4b, 'deform_sample.cu', 'mrefsr_tpu/ops/dcn.py:296'))
    for rec, source, replaces in described:
        paths = {path: counts[rec['name']]
                 for path, counts in by_path.items()}
        rec.update(route='cuda', source=csrc + source, replaces=replaces,
                   launches=sum(paths.values()), launches_by_path=paths)
    emit({'kernels': [rec for rec, _, _ in described], 'card': smi})
    print(smi, flush=True)
    emit({'ok': True, 'device': device})


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
