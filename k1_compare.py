#!/usr/bin/env python3
"""Time K1, K2, K3 and K5, or K7 and K8, and the paths they sit on in one
checkout,
with that checkout's own ``chip_smoke.py`` phases, so that two commits can
be compared in one call on one card (run it once per checkout, in turns:
A, B, B, A).

    python3 k1_compare.py --checkout DIR
    python3 k1_compare.py --checkout DIR --k2
    python3 k1_compare.py --checkout DIR --k7
    python3 k1_compare.py --checkout DIR --k3
    python3 k1_compare.py --checkout DIR --scatter

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
``nvidia-smi`` samples the SM clock and the power draw.

With ``--k2`` it runs instead: the device and build phases; K2 through the
checkout's ``modulated_deform_conv2d`` (``k2_function`` lines), forward at
the CUFED5 eval, the stage-3 training and the video nets' shapes in f32
and at the eval and training shapes in bf16, and the backward as the
training step takes it (x frozen) at the training shapes, each with the
peak memory of the call; the f32 and bf16 requests with a profile each;
the f32 ``dcn`` and ``flow`` steps and the bf16 ``dcn`` step; a BasicVSR++
chunk and an EDVR-M window; and the two-rank ``ddp`` phase. The K2 inputs
are made here, from a seed, so that every checkout gets the same.

With ``--k7`` it runs instead: the device and build phases; K7 through the
checkout's ``upfirdn2d`` and K8 through its ``fused_leaky_relu``
(``k7_function`` / ``k8_function`` lines) at every shape of the StyleGAN2
serving grid (forward) and training pass (forward, backward, double
backward; K8's backward also with the bias taking a gradient, as the path
runs it), each order's ``device_ms`` (torch.profiler's device events over
calls, a profile a call) and ``call_ms`` (CUDA events around one call, the
median of ``REPS``), by the timers of the ``chip_smoke.py`` beside this
script whatever the checkout, and their sums weighted by the launches of
a pass; then the checkout's ``stylegan2_serve`` and ``stylegan2_train``
phases (two grids, steps of each kind, a profile of each), and as
controls the f32 CUFED5 request and ``dcn`` step.

With ``--k3`` it runs instead: the device and build phases; K3 through the
checkout's ``modulated_deform_conv2d`` (conv groups 2 and 8) and K5 through
its ``deform_conv2d`` (groups 1 and 8, padding 0) at EDVR-M's L1 shape (5,
180, 320, 64), deform groups 8, in f32 and bf16 (``k3_function`` lines):
the forward, the backward as a training step asks it (x frozen) and the
backward with grad x, each one's ``device_ms`` and ``call_ms`` by the
timers of the ``chip_smoke.py`` beside this script, and a line of sums a
kernel and type. A call the checkout refuses (a bf16 K3 or K5 before they
ran on the fused walk) gives a line with ``refused`` and the error.

With ``--scatter`` it runs instead: the device and build phases; K2's
dgrad with the grad-x scatter (``mdcn_fused_dgrad_scatter`` and its bf16
twin), launched alone through the checkout's ``dcn._fused_kernels``, at
the video training steps' shapes (EDVR-M's L1, L2, L3 and BasicVSR++'s)
and the stage-3 training shapes, f32 and bf16, under two offset
distributions (``randn * 4`` and uniform on [-1.5, 1.5]), each launch's
grad x, grad offset and grad mask first held to autograd of the plain
version within ``_k2_tol`` (``scatter_function`` lines); beside it the
dgrad without grad x, and
at the stage-3 shapes the forward and wgrad; then ``--k3``'s lines. Device
times by the timers of the ``chip_smoke.py`` beside this script.

Needs one CUDA device and ``nvcc``.
"""
import argparse
import importlib
import importlib.util
import os
import statistics
import subprocess
import sys
import time

import torch

REPS = 20
# the directory of this script, whichever checkout it times
HERE = os.path.dirname(os.path.abspath(__file__))


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


# K2's shapes, (N, C, Cout, H, W, deform groups): CUFED5 eval (relu3_1,
# relu2_1, relu1_1 of 5 refs at 500x500), stage-3 training (B 6 x 5 refs,
# gt 160), and the video nets' (a BasicVSR++ alignment on one 180x320
# frame, 2 x 64 channels in, 16 groups; EDVR-M's L1 on 5 frames)
K2_SHAPES = {
    'eval': [(5, 256, 256, 125, 125, 8), (5, 128, 128, 250, 250, 8),
             (5, 64, 64, 500, 500, 8)],
    'train': [(30, 256, 256, 40, 40, 8), (30, 128, 128, 80, 80, 8),
              (30, 64, 64, 160, 160, 8)],
    'video': [(1, 128, 64, 180, 320, 16), (5, 64, 64, 180, 320, 8)]}


def _k2_inputs(gen, n, c, cout, h, w, dg, dtype):
    """x, offset (f32), mask, weight, bias on the card, seeded."""
    x = torch.randn((n, h, w, c), generator=gen)
    offset = torch.randn((n, h, w, dg, 9, 2), generator=gen) * 4
    mask = torch.rand((n, h, w, dg, 9), generator=gen)
    weight = torch.randn((3, 3, c, cout), generator=gen) * 0.02
    bias = torch.randn((cout,), generator=gen) * 0.1
    return [t.cuda() if t is offset else t.to(dtype).cuda()
            for t in (x, offset, mask, weight, bias)]


def _peak_of(fn):
    """The peak device memory one call of ``fn`` takes above what was
    allocated before it, in bytes."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def k2_functions(smoke, dcn):
    """K2 through ``modulated_deform_conv2d``: the forward at every shape of
    ``K2_SHAPES`` (video in f32 only), the backward as the training step
    takes it (offset, mask, weight and bias; x frozen) at the training
    shapes; one line a shape and a line of sums a group."""
    gen = torch.Generator().manual_seed(smoke.SEED + 40)
    for dtype in (torch.float32, smoke.BF16):
        for group, shapes in K2_SHAPES.items():
            if group == 'video' and dtype == smoke.BF16:
                continue
            total = {'fwd_ms': 0.0, 'bwd_ms': 0.0}
            for n, c, cout, h, w, dg in shapes:
                args = _k2_inputs(gen, n, c, cout, h, w, dg, dtype)

                def fwd():
                    return dcn.modulated_deform_conv2d(*args, deform_groups=dg)

                rec = {'phase': 'k2_function', 'dtype': str(dtype),
                       'group': group, 'n': n, 'c': c, 'cout': cout, 'h': h,
                       'w': w, 'deform_groups': dg, 'fwd_ms': median_ms(fwd),
                       'fwd_peak_bytes': _peak_of(fwd)}
                if group == 'train':
                    inputs = [a.detach().requires_grad_(i > 0)
                              for i, a in enumerate(args)]
                    out = dcn.modulated_deform_conv2d(*inputs,
                                                      deform_groups=dg)
                    cot = torch.randn(out.shape, generator=gen).to(
                        dtype).cuda()

                    def bwd():
                        return torch.autograd.grad(out, inputs[1:], cot,
                                                   retain_graph=True)

                    rec['bwd_ms'] = median_ms(bwd)
                    rec['bwd_peak_bytes'] = _peak_of(bwd)
                    del out, inputs, cot
                smoke.emit(rec)
                for key in total:
                    total[key] += rec.get(key, 0.0)
                del args
                torch.cuda.empty_cache()
            smoke.emit({'phase': 'k2_function', 'dtype': str(dtype),
                        'group': group, 'case': 'shapes summed', **total})


def main_k2(smoke, build_model, arch, correlation, dcn, kernels):
    """``--k2``: see the module docstring."""
    from mrefsr_tpu_torch.archs import arch_util, edvr_arch
    from mrefsr_tpu_torch.inference import (inference_basicvsr,
                                            inference_basicvsrpp)
    k2_functions(smoke, dcn)
    torch.cuda.empty_cache()
    for dtype in (torch.float32, smoke.BF16):
        _, model, batch = smoke.phase_slice(build_model, arch.DynAgg,
                                            correlation, dcn, kernels, dtype)

        def one_request():
            model.feed_data(batch)
            model.test()

        smoke.phase_profile('slice_bf16' if dtype == smoke.BF16 else 'slice',
                            one_request)
        del model
        torch.cuda.empty_cache()
    for alignment, dtype in (('dcn', torch.float32), ('flow', torch.float32),
                             ('dcn', smoke.BF16)):
        smoke.phase_train(alignment, build_model, arch, dcn, kernels, dtype)
        torch.cuda.empty_cache()
    smoke.phase_basicvsrpp_serve(inference_basicvsr, inference_basicvsrpp,
                                 dcn, kernels)
    torch.cuda.empty_cache()
    smoke.phase_edvr(edvr_arch, arch_util, dcn, kernels)
    torch.cuda.empty_cache()
    smoke.phase_ddp()


def _timers_here():
    """The ``chip_smoke.py`` beside this script, for its timers and
    StyleGAN2 case lists, whichever checkout is timed."""
    path = os.path.join(HERE, 'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('chip_smoke_here', path)
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    return here


def _timed_cases(smoke, here, name, paths, make):
    """``name`` lines: each case of ``paths`` (``{path: ([(case, launches
    a pass)], orders)}``) timed by ``here._time_orders`` on the function
    ``make(case)`` returns, ``(fn, x, bias)``; then a line of sums a path,
    weighted by the launches."""
    for path, (cases, orders) in paths.items():
        total = {'device_ms': {}, 'call_ms': {}}
        for case, count in cases:
            fn, x, bias = make(case)
            times = here._time_orders(fn, x, orders, reps=REPS, bias=bias)
            smoke.emit({'phase': name, 'path': path, 'case': case,
                        'launches_per_pass': count,
                        'device_ms': times['device'],
                        'call_ms': times['call']})
            for kind, key in (('device', 'device_ms'), ('call', 'call_ms')):
                for order, ms in times[kind].items():
                    total[key][order] = total[key].get(order, 0.0) \
                        + ms * count
            del fn, x, bias
            torch.cuda.empty_cache()
        smoke.emit({'phase': name, 'path': path, 'case': 'pass summed',
                    **total})


def k7_k8_functions(smoke, ops_upfirdn2d, fused_act):
    """K7 and K8 through the checkout's functions at every StyleGAN2 shape,
    each order's device and call time."""
    from mrefsr_tpu_torch.archs.stylegan2_arch import make_resample_kernel
    here = _timers_here()
    gen = torch.Generator().manual_seed(smoke.SEED + 41)
    base = make_resample_kernel(here.SG2_FIR)
    size, b = here.SG2_SERVE['out_size'], here.SG2_SERVE_SAMPLES
    tsize, tb = here.SG2_TRAIN_SIZE, here.SG2_TRAIN_B

    def k7(case):
        n, c, h, up, down, pad, gain = case
        fir = base * gain
        return (lambda t: ops_upfirdn2d.upfirdn2d(t, fir, up, down, pad),
                torch.randn((n, c, h, h), generator=gen).cuda(), None)

    _timed_cases(smoke, here, 'k7_function', {
        'serve': (here._counted(here._k7_generator_cases(size, b)),
                  ('fwd',)),
        'train': (here._counted([*here._k7_generator_cases(tsize, tb),
                                 *here._k7_discriminator_cases(tsize, tb)]),
                  ('fwd', 'bwd', 'bwd2'))}, k7)

    def k8(shape):
        x = torch.randn(shape, generator=gen).cuda()
        bias = (torch.randn((shape[1],), generator=gen) * 0.5).cuda()
        return fused_act.fused_leaky_relu, x, bias

    _timed_cases(smoke, here, 'k8_function', {
        'serve': (here._counted(here._k8_generator_cases(size, b)),
                  ('fwd',)),
        'train': (here._counted([*here._k8_generator_cases(tsize, tb),
                                 *here._k8_discriminator_cases(tsize, tb)]),
                  ('fwd', 'bwd', 'bwd_with_bias', 'bwd2'))}, k8)


# K3's and K5's cases at EDVR-M's L1 shape: (kernel, conv groups, padding)
K3_CASES = (('k3', 2, 1), ('k3', 8, 1), ('k5', 1, 0), ('k5', 8, 0))
EDVR_L1, EDVR_DG = (5, 180, 320, 64), 8


def k3_functions(smoke, dcn):
    """K3 and K5 through the checkout's functions: see the module
    docstring."""
    here = _timers_here()
    gen = torch.Generator().manual_seed(smoke.SEED + 42)
    n, h, w, c = EDVR_L1
    for dtype in (torch.float32, smoke.BF16):
        totals = {}
        for variant, groups, pad in K3_CASES:
            ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
            x = torch.randn((n, h, w, c), generator=gen).to(dtype).cuda()
            offset = (torch.randn((n, ho, wo, EDVR_DG, 9, 2), generator=gen)
                      * 4).cuda()
            mask = torch.rand((n, ho, wo, EDVR_DG, 9), generator=gen).to(
                dtype).cuda()
            weight = (torch.randn((3, 3, c // groups, c), generator=gen)
                      * 0.05).to(dtype).cuda()
            bias = torch.randn((c,), generator=gen).to(dtype).cuda()
            cot = torch.randn((n, ho, wo, c), generator=gen).to(dtype).cuda()
            kw = dict(padding=pad, groups=groups, deform_groups=EDVR_DG)
            if variant == 'k3':
                args = (x, offset, mask, weight, bias)

                def fn(*a):
                    return dcn.modulated_deform_conv2d(*a, **kw)
            else:
                args = (x, offset, weight)

                def fn(*a):
                    return dcn.deform_conv2d(*a, **kw)
            rec = {'phase': 'k3_function', 'kernel': variant.upper(),
                   'dtype': str(dtype), 'groups': groups, 'padding': pad,
                   'n': n, 'h': h, 'w': w, 'c': c,
                   'deform_groups': EDVR_DG}
            try:
                with torch.no_grad():
                    fn(*args)
            except TypeError as err:
                smoke.emit({**rec, 'refused': str(err)})
                continue
            wrt = [a.detach().requires_grad_(i > 0)
                   for i, a in enumerate(args)]
            wrt_x = [a.detach().requires_grad_() for a in args]
            out, out_x = fn(*wrt), fn(*wrt_x)

            def fwd():
                with torch.no_grad():
                    return fn(*args)

            calls = {'fwd': fwd,
                     'bwd': lambda: torch.autograd.grad(
                         out, wrt[1:], cot, retain_graph=True),
                     'bwd_with_grad_x': lambda: torch.autograd.grad(
                         out_x, wrt_x, cot, retain_graph=True)}
            device = dict(zip(calls, here.device_ms_each(
                list(calls.values()))))
            call = {order: median_ms(f) for order, f in calls.items()}
            smoke.emit({**rec, 'device_ms': device, 'call_ms': call})
            total = totals.setdefault(variant, {'device_ms': {},
                                                'call_ms': {}})
            for key, times in (('device_ms', device), ('call_ms', call)):
                for order, ms in times.items():
                    total[key][order] = total[key].get(order, 0.0) + ms
            del x, offset, mask, weight, bias, cot, args, wrt, wrt_x, out
            del out_x, calls
            torch.cuda.empty_cache()
        for variant, total in totals.items():
            smoke.emit({'phase': 'k3_function', 'kernel': variant.upper(),
                        'dtype': str(dtype), 'case': 'both groups summed',
                        **total})


# the scatter's shapes: (case, N, C, Cout, H, W, deform groups): the video
# training steps' (chip_smoke.py's VIDEO_TRAIN_K2_SHAPES at B 4) and the
# stage-3 training shapes (B 6 x 5 refs)
SCATTER_SHAPES = (('edvr_m_l1', 20, 64, 64, 64, 64, 8),
                  ('edvr_m_l2', 20, 64, 64, 32, 32, 8),
                  ('edvr_m_l3', 20, 64, 64, 16, 16, 8),
                  ('basicvsrpp', 4, 128, 64, 64, 64, 16),
                  ('stage3_c256', 30, 256, 256, 40, 40, 8),
                  ('stage3_c128', 30, 128, 128, 80, 80, 8),
                  ('stage3_c64', 30, 64, 64, 160, 160, 8))
# offsets: randn * 4 (chip_smoke.py's), most corners far from the patch,
# and one whose samples stay within a pixel and a half of their taps
SCATTER_OFFSETS = {
    'randn4': lambda gen, shape: torch.randn(shape, generator=gen) * 4,
    'uniform1.5': lambda gen, shape: torch.rand(shape, generator=gen) * 3
    - 1.5}


def scatter_functions(smoke, dcn):
    """``--scatter``: see the module docstring."""
    here = _timers_here()
    # the weight the checkout's forward and dgrad entry points read: at
    # f32 its TF32 planes where the checkout splits them, else
    # the weight itself
    operand = getattr(dcn, '_weight_operand', lambda w: w)
    for dtype in (torch.float32, smoke.BF16):
        k_fwd, k_dgrad, k_scatter, k_wgrad, _ = dcn._fused_kernels(dtype)
        tol = here._k2_tol(dtype)
        for case, n, c, cout, h, w, dg in SCATTER_SHAPES:
            for spread, make in SCATTER_OFFSETS.items():
                gen = torch.Generator().manual_seed(smoke.SEED + 43)
                x = torch.randn((n, h, w, c), generator=gen).to(dtype).cuda()
                offset = make(gen, (n, h, w, dg, 9, 2)).cuda()
                mask = torch.rand((n, h, w, dg, 9), generator=gen).to(
                    dtype).cuda()
                weight = (torch.randn((3, 3, c, cout), generator=gen)
                          * 0.02).to(dtype).cuda()
                cot = torch.randn((n, h, w, cout), generator=gen).to(
                    dtype).cuda()
                geom = ((3, 3), (1, 1), (1, 1), (1, 1), (h, w))
                fused = dcn._fused_args(x, offset, weight, geom)
                g_off, g_mask = torch.empty_like(offset), \
                    torch.empty_like(mask)
                g_x = torch.zeros_like(x, dtype=torch.float32)
                w_op = operand(weight)
                head = (cot.data_ptr(), x.data_ptr(), offset.data_ptr(),
                        mask.data_ptr(), w_op.data_ptr(), g_off.data_ptr(),
                        g_mask.data_ptr())
                errs, _ = here._scatter_vs_plain(
                    dcn, lambda: k_scatter(*head, g_x.data_ptr(), *fused),
                    cot, x, offset, mask, weight, dg, g_off, g_mask, g_x, tol,
                    f'{case} {spread} {dtype}')
                torch.cuda.empty_cache()
                rec = {'phase': 'scatter_function', 'case': case,
                       'offsets': spread, 'dtype': str(dtype), 'n': n,
                       'c': c, 'cout': cout, 'h': h, 'w': w,
                       'deform_groups': dg, 'rel_err': errs,
                       'tolerance': tol}
                calls = {'ms': lambda: k_scatter(*head, g_x.data_ptr(),
                                                 *fused),
                         'dgrad_ms': lambda: k_dgrad(*head, *fused)}
                if case.startswith('stage3') and spread == 'randn4':
                    splits, split_patches = dcn._wgrad_slices(
                        n, h, w, 9, c, cout, dtype)
                    partial = torch.empty((splits, 9 * c + 1, cout),
                                          device='cuda')
                    wt = operand(weight.reshape(9 * c, cout).t()
                                 .contiguous())
                    out = torch.empty_like(cot)
                    calls['fwd_ms'] = lambda: k_fwd(
                        x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                        wt.data_ptr(), None, out.data_ptr(), *fused)
                    calls['wgrad_ms'] = lambda: k_wgrad(
                        *head[:4], partial.data_ptr(), splits,
                        split_patches, *fused)
                rec.update(zip(calls, here.device_ms_each(
                    list(calls.values()))))
                smoke.emit(rec)
                del x, offset, mask, weight, w_op, cot, g_off, g_mask, g_x
                del calls
                torch.cuda.empty_cache()
    k3_functions(smoke, dcn)


def main_k7(smoke, build_model, arch, correlation, dcn, ops_upfirdn2d,
            fused_act):
    """``--k7``: see the module docstring."""
    import tempfile
    from mrefsr_tpu_torch.archs import stylegan2_arch
    from mrefsr_tpu_torch.inference import inference_stylegan2
    k7_k8_functions(smoke, ops_upfirdn2d, fused_act)
    kernels = smoke.kernel_objects(correlation, dcn, ops_upfirdn2d,
                                   fused_act)
    sg2 = (stylegan2_arch, ops_upfirdn2d, fused_act, kernels)
    smoke.phase_stylegan2_serve(inference_stylegan2, *sg2)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        smoke.phase_stylegan2_train(build_model, *sg2, root)
    torch.cuda.empty_cache()
    _, model, batch = smoke.phase_slice(build_model, arch.DynAgg,
                                        correlation, dcn, kernels)

    def one_request():
        model.feed_data(batch)
        model.test()

    smoke.phase_profile('slice', one_request)
    del model
    torch.cuda.empty_cache()
    smoke.phase_train('dcn', build_model, arch, dcn, kernels)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--checkout', default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument('--k2', action='store_true',
                        help='time K2 and its paths instead of K1\'s')
    parser.add_argument('--k7', action='store_true',
                        help='time K7, K8 and the StyleGAN2 paths instead')
    parser.add_argument('--k3', action='store_true',
                        help='time K3 and K5 through the functions instead')
    parser.add_argument('--scatter', action='store_true',
                        help='time K2\'s grad-x scatter dgrad instead')
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
    if args.k3:
        k3_functions(smoke, dcn)
        return
    if args.scatter:
        scatter_functions(smoke, dcn)
        return
    if args.k7:
        main_k7(smoke, build_model, arch, correlation, dcn, ops_upfirdn2d,
                fused_act)
        return
    if args.k2:
        main_k2(smoke, build_model, arch, correlation, dcn,
                smoke.kernel_objects(correlation, dcn, ops_upfirdn2d,
                                     fused_act))
        return
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
