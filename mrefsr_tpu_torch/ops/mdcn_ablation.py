"""Where the fused K2's time goes: ``mdcn_fused_fwd``, ``mdcn_fused_dgrad``
and ``mdcn_fused_wgrad`` (the walk of ``csrc/mdcn_fused.cuh``, at f32 from
``csrc/mdcn_fused.cu`` or at bf16 from ``csrc/mdcn_bf16.cu``) at the stage-3
training shapes, each kernel launched alone, built as is and with one part
of its work taken out.

    python3 -m mrefsr_tpu_torch.ops.mdcn_ablation            # f32
    python3 -m mrefsr_tpu_torch.ops.mdcn_ablation --bf16

Needs one CUDA device and ``nvcc``. The variants are copies of the walk's
headers with a part cut by text edits, each beside a copy of the entry
points' source in a directory of its own under ``build/``: ``gather`` (no
corner loads: every sample reads as outside the map), ``offsets`` (no
offset or mask reads: the gathers' per sample, dgrad's staging of a
patch), ``operands`` (no weight tiles in dgrad, no grad-out tiles in
wgrad), ``products`` (no ``mma.sync``, and so no fragment loads or
splits), ``splits`` (f32 only: the TF32 split left out, hi = x, lo = 0)
and ``gather+products``. A cut variant computes wrong values; only its
time counts. Prints one JSON line per shape and variant, the median ms of
7 launches after a warm-up, then the card's name and power limit.
"""
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from ._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

SHAPES = ((256, 40), (128, 80), (64, 160))     # (C, H) at B 6 x 5 refs
ITEMS, DG = 30, 8

# each cut: (header, its text, the replacement, how often it occurs)
CUTS = {
    'gather': [('mdcn_fused.cuh', '  if (!t.live) cn.in00',
                '  if (true) cn.in00', 1)],
    'offsets': [('mdcn_fused.cuh', '  if (t.live) {\n    const size_t om',
                 '  if (false) {\n    const size_t om', 1),
                ('mdcn_fused.cuh', '    if (in) {\n      copy_span(o_s',
                 '    if (false) {\n      copy_span(o_s', 1),
                ('mdcn_fused.cuh',
                 '    } else {\n      copy_span(offset + 2 * at',
                 '    } else if (!in) {\n      copy_span(offset + 2 * at',
                 1)],
    'operands': [('mdcn_fused.cuh',
                  '      const bool in = c0 + cc < g.c && q * N < g.cout;',
                  '      const bool in = false;', 1),
                 ('mdcn_fused.cuh',
                  '      const bool in = o.live && q * N < g.cout;\n'
                  '      cp_async16(dst + r * LDO',
                  '      const bool in = false;\n'
                  '      cp_async16(dst + r * LDO', 1)],
    'products': [('mdcn_fused.cuh', 'P::mma(', 'if (false) P::mma(', 3)],
    'splits': [('mma_sync.cuh',
                '  hi = (x + 0x1000u) & 0xFFFFE000u;\n'
                '  lo = __float_as_uint(__uint_as_float(x) - '
                '__uint_as_float(hi));',
                '  hi = x;\n  lo = 0u;', 1)],
}
VARIANTS = {'as is': (), 'gather': ('gather',), 'offsets': ('offsets',),
            'operands': ('operands',), 'products': ('products',),
            'splits': ('splits',), 'gather+products': ('gather', 'products')}


def _headers(cuts):
    texts = {name: (CSRC / name).read_text()
             for name in ('mdcn_fused.cuh', 'mma_sync.cuh')}
    for cut in cuts:
        for name, old, new, count in CUTS[cut]:
            if texts[name].count(old) != count:
                raise RuntimeError(f'cut {cut!r}: {old!r} occurs '
                                   f'{texts[name].count(old)} times in '
                                   f'{name}, not {count}')
            texts[name] = texts[name].replace(old, new)
    return texts


def _build_variants(source, variants):
    out_dir = BUILD_DIR / 'ablation' / source.split('.')[0]
    procs = {}
    for name in variants:
        stem = name.replace(' ', '_').replace('+', '_')
        (out_dir / stem).mkdir(parents=True, exist_ok=True)
        # the source finds the cut headers beside it before those in CSRC
        for header, text in _headers(VARIANTS[name]).items():
            (out_dir / stem / header).write_text(text)
        src = out_dir / stem / source
        src.write_text((CSRC / source).read_text())
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


def _ms(fn, reps=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _check(err):
    if err:
        raise RuntimeError(f'launch failed: CUDA error {err}')


def _inputs(c, h, gen, dtype):
    """The shape's tensors on the card, offsets spread as chip_smoke.py's
    backward phase spreads them (about 2.2 pixels)."""
    x = torch.randn((ITEMS, h, h, c), generator=gen)
    offset = torch.randn((ITEMS, h, h, DG, 9, 2), generator=gen) * 2 \
        + torch.randn((ITEMS, h, h, DG, 9, 2), generator=gen)
    mask = torch.rand((ITEMS, h, h, DG, 9), generator=gen)
    weight = torch.randn((3, 3, c, c), generator=gen) * 0.02
    go = torch.randn((ITEMS * h * h, c), generator=gen)
    return [t.cuda() if t is offset else t.to(dtype).cuda()
            for t in (x, offset, mask, weight, go)]


def main(argv=None):
    from . import dcn
    bf16 = '--bf16' in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    dtype = torch.bfloat16 if bf16 else torch.float32
    suffix = '_bf16' if bf16 else ''
    variants = [v for v in VARIANTS if not (bf16 and v == 'splits')]
    libs = _build_variants('mdcn_bf16.cu' if bf16 else 'mdcn_fused.cu',
                           variants)
    ptr, geo = ctypes.c_void_p, [ctypes.c_int] * 16 + [ctypes.c_void_p]
    entries = {}
    for name, lib in libs.items():
        fwd = getattr(lib, f'mdcn_fused_fwd{suffix}_launch')
        dgrad = getattr(lib, f'mdcn_fused_dgrad{suffix}_launch')
        wgrad = getattr(lib, f'mdcn_fused_wgrad{suffix}_launch')
        fwd.argtypes = [ptr] * 6 + geo
        dgrad.argtypes = [ptr] * 7 + geo
        wgrad.argtypes = [ptr] * 5 + [ctypes.c_int] * 2 + geo
        entries[name] = fwd, dgrad, wgrad
    gen = torch.Generator().manual_seed(0)
    for c, h in SHAPES:
        x, offset, mask, weight, go = _inputs(c, h, gen, dtype)
        geom = ((3, 3), (1, 1), (1, 1), (1, 1), (h, h))
        args = dcn._fused_args(x, offset, weight, geom)
        splits, split_patches = dcn._wgrad_slices(ITEMS, h, h, 9, c, c,
                                                  dtype)
        wt = weight.reshape(9 * c, c).t().contiguous()
        out = torch.empty_like(go)
        partial = torch.empty((splits, 9 * c + 1, c), device='cuda')
        g_off, g_mask = torch.empty_like(offset), torch.empty_like(mask)
        head = (go.data_ptr(), x.data_ptr(), offset.data_ptr(),
                mask.data_ptr())
        for name, (fwd, dgrad, wgrad) in entries.items():
            print(json.dumps({
                'c': c, 'h': h, 'items': ITEMS, 'deform_groups': DG,
                'dtype': str(dtype), 'cut': name,
                'fwd_ms': _ms(lambda: _check(fwd(
                    x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                    wt.data_ptr(), None, out.data_ptr(), *args))),
                'dgrad_ms': _ms(lambda: _check(dgrad(
                    *head, weight.data_ptr(), g_off.data_ptr(),
                    g_mask.data_ptr(), *args))),
                'wgrad_ms': _ms(lambda: _check(wgrad(
                    *head, partial.data_ptr(), splits, split_patches,
                    *args)))}), flush=True)
        del x, offset, mask, weight, go, partial, g_off, g_mask, out, wt
        torch.cuda.empty_cache()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())


if __name__ == '__main__':
    main()
