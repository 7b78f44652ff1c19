"""Where the bf16 K2 backward's time goes: ``mdcn_fused_dgrad`` and
``mdcn_fused_wgrad`` of ``csrc/mdcn_bf16.cu`` at the stage-3 training
shapes, each built as is and with one part of its work taken out.

    python3 -m mrefsr_tpu_torch.ops.mdcn_bf16_ablation

Needs one CUDA device and ``nvcc``. The variants are copies of the source
with a part cut by text edits, built under ``build/`` beside the kernels:
``gather`` (no corner loads: every sample reads as outside the map),
``offsets`` (no offset or mask reads: wgrad's per sample, dgrad's staging
of a patch), ``operands`` (no weight tiles in dgrad, no grad-out tiles in
wgrad), ``products`` (no ``mma.sync``) and ``gather+operands``. A cut
variant computes wrong values; only its time counts. Prints one JSON line
per shape and variant, ms over 10 launches after a warm-up, then the
card's name and power limit.
"""
import ctypes
import json
import subprocess

import torch

from ._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

SHAPES = ((256, 40), (128, 80), (64, 160))     # (C, H) at B 6 x 5 refs
ITEMS, DG = 30, 8

# each cut: (text of mdcn_bf16.cu, its replacement, how often it occurs)
CUTS = {
    'gather': [('  if (!t.live) cn.in00', '  if (true) cn.in00', 1)],
    'offsets': [('  if (t.live) {\n    const size_t om',
                 '  if (false) {\n    const size_t om', 1),
                ('    if (in) {\n      copy_span(o_s',
                 '    if (false) {\n      copy_span(o_s', 1),
                ('    } else {\n      copy_span(offset + 2 * at',
                 '    } else if (!in) {\n      copy_span(offset + 2 * at', 1)],
    'operands': [('      const bool in = c0 + cc < g.c && q * 8 < g.cout;',
                  '      const bool in = false;', 1),
                 ('      const bool in = o.live && q * 8 < g.cout;\n'
                  '      cp_async16(dst + r * LDO',
                  '      const bool in = false;\n'
                  '      cp_async16(dst + r * LDO', 1)],
    'products': [('mma_bf16(acc', 'if (false) mma_bf16(acc', 3)],
}
VARIANTS = {'as is': (), 'gather': ('gather',), 'offsets': ('offsets',),
            'operands': ('operands',), 'products': ('products',),
            'gather+operands': ('gather', 'operands')}


def _source(cuts):
    text = (CSRC / 'mdcn_bf16.cu').read_text()
    for cut in cuts:
        for old, new, count in CUTS[cut]:
            if text.count(old) != count:
                raise RuntimeError(f'cut {cut!r}: {old!r} occurs '
                                   f'{text.count(old)} times, not {count}')
            text = text.replace(old, new)
    return text


def _build_variants():
    out_dir = BUILD_DIR / 'ablation'
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in VARIANTS.items():
        stem = name.replace(' ', '_').replace('+', '_')
        src = out_dir / f'{stem}.cu'
        src.write_text(_source(cuts))
        lib = out_dir / f'{stem}.so'
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, f'-I{CSRC}', '-o', str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for variant {name!r}:\n{log}')
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _ms(fn, reps=10):
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


def _check(err):
    if err:
        raise RuntimeError(f'launch failed: CUDA error {err}')


def _inputs(c, h, gen):
    """The shape's tensors on the card, offsets spread as chip_smoke.py's
    backward phase spreads them (about 2.2 pixels)."""
    x = torch.randn((ITEMS, h, h, c), generator=gen)
    offset = torch.randn((ITEMS, h, h, DG, 9, 2), generator=gen) * 2 \
        + torch.randn((ITEMS, h, h, DG, 9, 2), generator=gen)
    mask = torch.rand((ITEMS, h, h, DG, 9), generator=gen)
    weight = torch.randn((3, 3, c, c), generator=gen) * 0.02
    go = torch.randn((ITEMS * h * h, c), generator=gen)
    return [t.cuda() if t is offset else t.to(torch.bfloat16).cuda()
            for t in (x, offset, mask, weight, go)]


def main():
    from . import dcn
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    libs = _build_variants()
    ptr, geo = ctypes.c_void_p, [ctypes.c_int] * 16 + [ctypes.c_void_p]
    for lib in libs.values():
        lib.mdcn_fused_dgrad_bf16_launch.argtypes = [ptr] * 7 + geo
        lib.mdcn_fused_wgrad_bf16_launch.argtypes = \
            [ptr] * 5 + [ctypes.c_int] * 2 + geo
    gen = torch.Generator().manual_seed(0)
    for c, h in SHAPES:
        x, offset, mask, weight, go = _inputs(c, h, gen)
        geom = ((3, 3), (1, 1), (1, 1), (1, 1), (h, h))
        args = dcn._fused_args(x, offset, weight, geom)
        splits, split_patches = dcn._wgrad_slices(ITEMS, h, h, 9, c, c)
        partial = torch.empty((splits, 9 * c + 1, c), device='cuda')
        g_off, g_mask = torch.empty_like(offset), torch.empty_like(mask)
        head = (go.data_ptr(), x.data_ptr(), offset.data_ptr(),
                mask.data_ptr())
        for name, lib in libs.items():
            def dgrad():
                _check(lib.mdcn_fused_dgrad_bf16_launch(
                    *head, weight.data_ptr(), g_off.data_ptr(),
                    g_mask.data_ptr(), *args))

            def wgrad():
                _check(lib.mdcn_fused_wgrad_bf16_launch(
                    *head, partial.data_ptr(), splits, split_patches, *args))

            print(json.dumps({'c': c, 'h': h, 'items': ITEMS,
                              'deform_groups': DG, 'cut': name,
                              'dgrad_ms': _ms(dgrad),
                              'wgrad_ms': _ms(wgrad)}), flush=True)
        del x, offset, mask, weight, go, partial, g_off, g_mask
        torch.cuda.empty_cache()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())


if __name__ == '__main__':
    main()
