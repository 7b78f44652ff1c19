"""Where the fused K2's time goes: ``mdcn_fused_fwd``, ``mdcn_fused_dgrad``
and ``mdcn_fused_wgrad`` (the forward and dgrad on the wgmma walk of
``csrc/mdcn_wgmma.cuh``, wgrad on ``csrc/mdcn_fused.cuh``'s, at f32 from
``csrc/mdcn_fused.cu`` or at bf16 from ``csrc/mdcn_bf16.cu``) at the
stage-3 training shapes, each kernel launched alone, built as is and with
one part of its work taken out.

    python3 -m mrefsr_tpu_torch.ops.mdcn_ablation            # f32
    python3 -m mrefsr_tpu_torch.ops.mdcn_ablation --bf16

Needs one CUDA device and ``nvcc``. The variants are copies of the walk's
headers with a part cut by text edits, each beside a copy of the entry
points' source in a directory of its own under ``build/``: ``gather`` (no
corner loads: every sample reads as outside the map), ``offsets`` (no
offset or mask reads: the gathers' per sample, dgrad's staging of a
patch), ``operands`` (no TMA loads of the weight in the forward and
dgrad, nor of dgrad's grad-out tile, the barriers arriving without them;
no grad-out tiles in wgrad), ``products`` (no ``wgmma`` and no
``mma.sync``), ``splits`` (f32 only: the TF32 split left out, hi = x, lo =
0) and ``gather+products``. A cut variant computes wrong values; only its
time counts. At f32 the forward and dgrad read the weight's planes, split
beforehand by the checkout's own ``mdcn_fused_split``. Prints one JSON line
per shape and variant, the median ms of 7 launches after a warm-up, then
the card's name and power limit.

    python3 -m mrefsr_tpu_torch.ops.mdcn_ablation --scatter [--bf16]

times the dgrad with the grad-x scatter instead, at EDVR-M's L1, BasicVSR++
and the stage-3 C 64 shapes, offsets ``randn * 4`` and uniform on [-1.5,
1.5], built as is and with one of its levers undone by the same kind of
text edit (these variants compute right values): ``scalar atomics`` (each
16-byte vector reduction split into four scalar atomic adds) and
``unpaired`` (at bf16, each lane reducing its own two half sectors, no
trade between the lanes of a pair).

    python3 -m mrefsr_tpu_torch.ops.mdcn_ablation --sass

builds ``mdcn_fused.cu`` and ``mdcn_bf16.cu`` as the port does and prints,
for every kernel of the two libraries, its registers and spills as ptxas
reports them and how many ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync)
instructions ``cuobjdump -sass`` finds in it: one JSON line a kernel.
"""
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

from ._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc, build

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
    'operands': [('mdcn_wgmma.cuh',
                  '      mbar_expect_tx(&full[stage], R::B_BYTES);',
                  '      mbar_arrive(&full[stage]);\n      return;', 1),
                 ('mdcn_wgmma.cuh',
                  '      mbar_expect_tx(&w_full[stage], D::W_STAGE);',
                  '      mbar_arrive(&w_full[stage]);\n      return;', 1),
                 ('mdcn_wgmma.cuh',
                  '      mbar_expect_tx(&go_full, slabs * SLAB);',
                  '      mbar_arrive(&go_full);\n      if (false)', 1),
                 ('mdcn_fused.cuh',
                  '      const bool in = o.live && q * N < g.cout;\n'
                  '      cp_async16(dst + r * LDO',
                  '      const bool in = false;\n'
                  '      cp_async16(dst + r * LDO', 1)],
    'products': [('mdcn_wgmma.cuh', 'bf16_ss(d, ', 'if (false) bf16_ss(d, ',
                  1),
                 ('mdcn_wgmma.cuh', 'tf32_ss(d, ', 'if (false) tf32_ss(d, ',
                  3),
                 ('mdcn_wgmma.cuh', 'bf16_ss(acc, ',
                  'if (false) bf16_ss(acc, ', 1),
                 ('mdcn_wgmma.cuh', 'tf32_rs(acc, ',
                  'if (false) tf32_rs(acc, ', 3),
                 ('mdcn_fused.cuh', 'P::mma(', 'if (false) P::mma(', 1)],
    'splits': [('mma_sync.cuh',
                '  hi = (x + 0x1000u) & 0xFFFFE000u;\n'
                '  lo = __float_as_uint(__uint_as_float(x) - '
                '__uint_as_float(hi));',
                '  hi = x;\n  lo = 0u;', 1)],
}
VARIANTS = {'as is': (), 'gather': ('gather',), 'offsets': ('offsets',),
            'operands': ('operands',), 'products': ('products',),
            'splits': ('splits',), 'gather+products': ('gather', 'products')}

# the scatter's levers undone: (header, its text, the replacement, count)
CUTS.update({
    'scalar atomics': [('deform_bilinear.cuh',
                        '  atomicAdd(reinterpret_cast<float4*>(p), v);',
                        '  atomicAdd(p, v.x), atomicAdd(p + 1, v.y), '
                        'atomicAdd(p + 2, v.z), atomicAdd(p + 3, v.w);', 1)],
    'unpaired': [('deform_bilinear.cuh', '    if constexpr (N == 4) {',
                  '    if constexpr (N == 4 || N == 8) {', 1)]})
SCATTER_VARIANTS = {'as is': (), 'scalar atomics': ('scalar atomics',),
                    'unpaired': ('unpaired',)}
# (case, N, C, Cout, H, W, deform groups)
SCATTER_SHAPES = (('edvr_m_l1', 20, 64, 64, 64, 64, 8),
                  ('basicvsrpp', 4, 128, 64, 64, 64, 16),
                  ('stage3_c64', ITEMS, 64, 64, 160, 160, DG))


def _headers(cuts):
    texts = {name: (CSRC / name).read_text()
             for name in ('mdcn_fused.cuh', 'mdcn_wgmma.cuh', 'mma_sync.cuh',
                          'deform_bilinear.cuh')}
    for cut in cuts:
        for name, old, new, count in CUTS[cut]:
            if texts[name].count(old) != count:
                raise RuntimeError(f'cut {cut!r}: {old!r} occurs '
                                   f'{texts[name].count(old)} times in '
                                   f'{name}, not {count}')
            texts[name] = texts[name].replace(old, new)
    return texts


def _build_variants(source, variants, table=VARIANTS):
    out_dir = BUILD_DIR / 'ablation' / source.split('.')[0]
    procs = {}
    for name in variants:
        stem = name.replace(' ', '_').replace('+', '_')
        (out_dir / stem).mkdir(parents=True, exist_ok=True)
        # the source finds the cut headers beside it before those in CSRC
        for header, text in _headers(table[name]).items():
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


def scatter(dcn, bf16):
    """``--scatter``: see the module docstring."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    suffix = '_bf16' if bf16 else ''
    # the f32 runs trade nothing between lanes: no 'unpaired' there
    variants = {name: cuts for name, cuts in SCATTER_VARIANTS.items()
                if bf16 or name != 'unpaired'}
    libs = _build_variants('mdcn_bf16.cu' if bf16 else 'mdcn_fused.cu',
                           variants, variants)
    ptr, geo = ctypes.c_void_p, [ctypes.c_int] * 16 + [ctypes.c_void_p]
    entries = {}
    for name, lib in libs.items():
        launch = getattr(lib, f'mdcn_fused_dgrad_scatter{suffix}_launch')
        launch.argtypes = [ptr] * 8 + geo
        entries[name] = launch
    for case, n, c, cout, h, w, dg in SCATTER_SHAPES:
        for spread in ('randn4', 'uniform1.5'):
            gen = torch.Generator().manual_seed(0)
            shape = (n, h, w, dg, 9, 2)
            offset = (torch.randn(shape, generator=gen) * 4
                      if spread == 'randn4' else
                      torch.rand(shape, generator=gen) * 3 - 1.5).cuda()
            x = torch.randn((n, h, w, c), generator=gen).to(dtype).cuda()
            mask = torch.rand((n, h, w, dg, 9), generator=gen).to(
                dtype).cuda()
            weight = (torch.randn((3, 3, c, cout), generator=gen)
                      * 0.02).to(dtype).cuda()
            go = torch.randn((n * h * w, cout), generator=gen).to(
                dtype).cuda()
            geom = ((3, 3), (1, 1), (1, 1), (1, 1), (h, w))
            args = dcn._fused_args(x, offset, weight, geom)
            g_off, g_mask = torch.empty_like(offset), torch.empty_like(mask)
            g_x = torch.zeros_like(x, dtype=torch.float32)
            w = dcn._weight_operand(weight)  # f32: its TF32 planes
            head = (go.data_ptr(), x.data_ptr(), offset.data_ptr(),
                    mask.data_ptr(), w.data_ptr(), g_off.data_ptr(),
                    g_mask.data_ptr(), g_x.data_ptr())
            for name, launch in entries.items():
                print(json.dumps({
                    'case': case, 'offsets': spread, 'n': n, 'c': c,
                    'cout': cout, 'h': h, 'w': w, 'deform_groups': dg,
                    'dtype': str(dtype), 'variant': name,
                    'scatter_ms': _ms(lambda: _check(launch(*head,
                                                            *args)))}),
                      flush=True)
            del x, offset, mask, weight, w, go, g_off, g_mask, g_x
            torch.cuda.empty_cache()


def _demangled(names):
    """``names`` through ``cu++filt`` where the toolkit has it."""
    filt = os.path.join(os.path.dirname(_nvcc()), 'cu++filt')
    if not os.path.exists(filt):
        return list(names)
    out = subprocess.run([filt, *names], capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if len(lines) == len(names) else list(names)


def sass():
    """``--sass``: see the module docstring."""
    info = build(['mdcn_fused', 'mdcn_bf16'])
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), 'cuobjdump')
    for lib, rec in info.items():
        regs, name = {}, None
        for line in rec['log'].splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                continue
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', line)
            if m and name:
                regs.setdefault(name, {})['spill_bytes'] = [
                    int(m.group(1)), int(m.group(2))]
            m = re.search(r'Used (\d+) registers', line)
            if m and name:
                regs.setdefault(name, {})['registers'] = int(m.group(1))
        text = subprocess.run([cuobjdump, '-sass', str(rec['path'])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, name = {}, None
        for line in text.splitlines():
            m = re.search(r'Function : (\S+)', line)
            if m:
                name = m.group(1)
                counts[name] = {'HGMMA': 0, 'HMMA': 0}
            elif name and 'HGMMA' in line:
                counts[name]['HGMMA'] += 1
            elif name and 'HMMA' in line:
                counts[name]['HMMA'] += 1
        for mangled, readable in zip(counts, _demangled(list(counts))):
            print(json.dumps({'library': lib, 'kernel': readable,
                              **counts[mangled], **regs.get(mangled, {})}),
                  flush=True)


def main(argv=None):
    from . import dcn
    argv = sys.argv[1:] if argv is None else argv
    bf16 = '--bf16' in argv
    if '--sass' in argv:
        sass()
        return
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    if '--scatter' in argv:
        scatter(dcn, bf16)
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True).stdout.strip())
        return
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
        # at f32 the weight's TF32 planes, as the wrapper hands them over
        wt = dcn._weight_operand(weight.reshape(9 * c, c).t().contiguous())
        w = dcn._weight_operand(weight.reshape(9 * c, c))
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
                    *head, w.data_ptr(), g_off.data_ptr(),
                    g_mask.data_ptr(), *args))),
                'wgrad_ms': _ms(lambda: _check(wgrad(
                    *head, partial.data_ptr(), splits, split_patches,
                    *args)))}), flush=True)
        del x, offset, mask, weight, go, partial, g_off, g_mask, out, wt, w
        torch.cuda.empty_cache()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())


if __name__ == '__main__':
    main()
