"""Deformable convolution, modulated (DCNv2) and not (DCNv1), with any
number of conv groups, and the per-pixel grouped bilinear warp
``deform_sample``, each with its gradient.

Port of ``mrefsr_tpu/ops/dcn.py``. On a CPU tensor everything runs the
plain version (:func:`_im2col_ref` and a matmul, in chunks of rows so that
the column scratch stays under :data:`COL_CAP_BYTES`), with autograd
through it. On a CUDA tensor the op is a ``torch.autograd.Function`` that
keeps ``x, offset, mask, weight`` only and recomputes in the backward what
it needs (the JAX package's default, full remat). Fused kernels gather the
columns into shared memory and contract them there on the tensor cores, in
one launch per call, as the JAX package's scans contract each tap's slab
in their own bodies: no column matrix, no chunks, no matmul.
``csrc/mdcn_fused.cu`` (float32, 3xTF32) and ``csrc/mdcn_bf16.cu``
(bfloat16) instantiate one walk: the forward and dgrad on Hopper's wgmma,
fed by TMA and by producer warps that gather the columns
(``csrc/mdcn_wgmma.cuh``), wgrad on ``mma.sync`` (``csrc/mdcn_fused.cuh``).
The forward is ``mdcn_fused_fwd``; the backward ``mdcn_fused_dgrad`` (grad
offset, grad mask and, in its ``_scatter`` variant, grad x) and
``mdcn_fused_wgrad`` (per-slice partials of grad weight and grad bias),
then ``mdcn_fused_wgrad_sum`` adds the partials in a fixed order; the bf16
entry points carry a ``_bf16`` suffix. At float32 the forward and dgrad
take the weight as its TF32 hi and lo planes, which ``mdcn_fused_split``
(:data:`mdcn_fused_split_kernel`, plain version :func:`_split_tf32_ref`)
writes once a call. The walk runs three TPU kernels of
the JAX package, each with Kernels of its own (:data:`FUSED_KERNELS`) so
that their launches count apart:

- K2 (``_mdcn_slab_scan``: conv groups 1, a mask) as it is;
- K3 (``_mdcn_tap_scan``: conv groups > 1) on a block-diagonal weight
  (:func:`_block_diagonal`, exact zeros off the groups' blocks), its grad
  weight the diagonal blocks of wgrad's (:func:`_diagonal_blocks`);
- K5 (:func:`deform_conv2d`, DCNv1: no mask, no bias) with a null mask:
  no mask is read, staged or differentiated.

All three take the walk's limits, checked by name in
:func:`_check_fused_inputs`.

``deform_sample`` is the K = 1 case without mask or weight
(``csrc/deform_sample.cu``, forward and backward kernels, either type).

Types and rounding. Everything is float32, as the JAX package's default;
or, as its bf16 mixed precision has it, x, mask, weight and bias bfloat16
with the offset (or flow) float32, which is what a bf16 offset residual
plus the f32 pre-offsets gives (a bf16 offset is widened exactly).
Coordinates are f32 whatever the types. At bf16 the sampled corners are
widened to f32, combined in f32 and rounded to bf16 once per column
element (the kernels and the plain versions alike); the contraction sums
bf16 x bf16 products in f32 (the fused kernels' ``wgmma`` and
``mma.sync``, the plain version's ``torch.mm`` / ``torch.bmm``) and rounds
once to bf16, and the bias is added after that rounding, as at the JAX
package's dcn.py:104-107.
In the backward the grad columns (grad out x W^T) are summed in f32 and
rounded to bf16 before the bilinear derivative, where JAX's vjp and
``torch.mm`` round them; grad offset is f32, grad mask bf16 rounded once;
grad weight, grad bias and grad x are summed in f32 and rounded once. In
float32 the fused kernels take each product as 3xTF32 (lo*hi + hi*lo +
hi*hi of TF32 splits, about 2^-21 of |a||b|) and sum in f32, where the
plain version's ``torch.addmm`` sums exact f32 products; the bias is added
to the f32 sum. A block-diagonal weight's zeros add exact zeros to those
sums, at either type.

Layouts (the JAX package's, NHWC / HWIO):
    x:      (N, H, W, C)
    offset: (N, Ho, Wo, dg, K, 2)   last dim (dy, dx), K = kh*kw row-major
    mask:   (N, Ho, Wo, dg, K)      already sigmoid-ed by the caller
    weight: (kh, kw, C // groups, Cout); output channel o belongs to conv
            group o // (Cout // groups)
    bias:   (Cout,) or None
    flow:   (N, H, W, dg, 2)        last dim (dy, dx)
"""
import ctypes

import torch
from torch.autograd.function import once_differentiable

from ._build import Kernel
from .cpu_bf16 import f32_products

# The plain version's column scratch per chunk of rows. One CUFED5
# request's relu1_1 level needs 5 * 250000 rows * 576 * 4 B = 2.9 GB of
# columns; 512 MiB keeps the scratch small beside the activations.
COL_CAP_BYTES = 512 << 20

_P = ctypes.c_void_p
# The fused walk's C entry points, each part's arguments: pointers, then
# rows, h, w, c, cout, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw, dg, stream.
_FUSED = [ctypes.c_int] * 16 + [ctypes.c_void_p]
_FUSED_PARTS = {'fwd': [_P] * 6 + _FUSED,
                'dgrad': [_P] * 7 + _FUSED,
                'dgrad_scatter': [_P] * 8 + _FUSED,
                'wgrad': [_P] * 5 + [ctypes.c_int] * 2 + _FUSED,
                'wgrad_sum': [_P] * 2 + [ctypes.c_int] * 2 + [_P]}
# their library and suffix by type: csrc/mdcn_fused.cu (float32) and
# csrc/mdcn_bf16.cu (x, mask, weight, bias, grad out bfloat16, the offset
# float32)
_FUSED_TYPES = {torch.float32: ('mdcn_fused', ''),
                torch.bfloat16: ('mdcn_bf16', '_bf16')}
# the TPU kernels the walk runs, by the name their launches count under:
# K2 (conv groups 1, a mask), K3 (conv groups > 1), K5 (DCNv1, no mask)
VARIANTS = {'k2': 'mdcn_fused', 'k3': 'mdcn_groups_fused',
            'k5': 'deform_conv_fused'}
# a Kernel for each TPU kernel and C entry point, e.g. 'mdcn_fused_fwd',
# 'mdcn_groups_fused_dgrad_bf16', 'deform_conv_fused_wgrad_sum': one C
# entry point counts the launches of K2, K3 and K5 apart
FUSED_KERNELS = {
    f'{name}_{part}{suffix}': Kernel(library,
                                     f'mdcn_fused_{part}{suffix}_launch',
                                     argtypes)
    for name in VARIANTS.values()
    for library, suffix in _FUSED_TYPES.values()
    for part, argtypes in _FUSED_PARTS.items()}
# float32 only: the weight's TF32 hi and lo planes, which the float32
# forward and dgrad read (w, planes, n, stream), for K2, K3 and K5 alike
mdcn_fused_split_kernel = Kernel('mdcn_fused', 'mdcn_fused_split_launch',
                                 [_P, _P, ctypes.c_longlong, _P])
# the fused kernels' widest output tile, and the deform groups x taps whose
# offsets a dgrad block stages in shared memory
FUSED_MAX_COUT = 256
FUSED_MAX_STAGED = 144
# a fused block's output rows: an 8 x 8 patch of pixels
PATCH = 8
# wgrad's blocks of (tap, 8 runs of channels) x slice of patches: about three
# waves of blocks on the H100's 132 SMs (two blocks an SM below Cout 256,
# one of 512 threads at 256), the slices cut from the shapes alone so that
# the sum's order is the same on any card
WGRAD_WAVES = 3
_SHAPE = [ctypes.c_int] * 5 + [ctypes.c_void_p]  # n, h, w, c, dg, stream
deform_sample_fwd_kernel = Kernel('deform_sample', 'deform_sample_fwd_launch',
                                  [ctypes.c_void_p] * 3 + _SHAPE)
deform_sample_bwd_kernel = Kernel('deform_sample', 'deform_sample_bwd_launch',
                                  [ctypes.c_void_p] * 4 + _SHAPE)
deform_sample_bwd_scatter_kernel = Kernel(
    'deform_sample', 'deform_sample_bwd_scatter_launch',
    [ctypes.c_void_p] * 5 + _SHAPE)
# K4 at bf16: x, out and grad out bfloat16, the flow float32
deform_sample_fwd_bf16_kernel = Kernel(
    'deform_sample', 'deform_sample_fwd_bf16_launch',
    [ctypes.c_void_p] * 3 + _SHAPE)
deform_sample_bwd_bf16_kernel = Kernel(
    'deform_sample', 'deform_sample_bwd_bf16_launch',
    [ctypes.c_void_p] * 4 + _SHAPE)
deform_sample_bwd_scatter_bf16_kernel = Kernel(
    'deform_sample', 'deform_sample_bwd_scatter_bf16_launch',
    [ctypes.c_void_p] * 5 + _SHAPE)
# channels in one 16-byte run of a kernel thread, by x's dtype
_RUN = {torch.float32: 4, torch.bfloat16: 8}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _im2col_ref(x, offset, mask, row0, rows, geom, groups=1):
    """The plain version's deformable im2col: the columns ``(groups, rows,
    K, C/groups)`` of output rows ``[row0, row0 + rows)`` of the flattened
    ``(N, Ho, Wo)``; ``mask`` None is a mask of ones. A bf16 ``x`` is
    sampled in f32 and the columns rounded to bf16 once, as the fused
    kernels round the column tiles they gather."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw), (ho, wo) = geom
    n, h, w, c = x.shape
    dg = offset.shape[3]
    k = kh * kw
    cg = c // dg
    r = torch.arange(row0, row0 + rows, device=x.device)
    item = torch.div(r, ho * wo, rounding_mode='floor')
    oy = torch.div(r, wo, rounding_mode='floor') % ho * sh - ph  # (rows,)
    ox = r % wo * sw - pw
    taps = torch.arange(k, device=x.device)
    ky = torch.div(taps, kw, rounding_mode='floor') * dh  # (K,)
    kx = taps % kw * dw
    off = offset.reshape(-1, dg, k, 2)[row0:row0 + rows]  # (rows, dg, K, 2)
    # f32 coordinates, added in the JAX order: (base + tap) + offset
    fy = (oy[:, None] + ky[None, :]).to(torch.float32)[:, None] + off[..., 0]
    fx = (ox[:, None] + kx[None, :]).to(torch.float32)[:, None] + off[..., 1]
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy1 = fy - y0
    wx1 = fx - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    # validity on the unclipped corners, rows of the 1-padded map clipped
    wide = torch.promote_types(x.dtype, torch.float32)
    vy0 = ((y0 >= 0) & (y0 <= h - 1)).to(wide)
    vy1 = ((y0 >= -1) & (y0 <= h - 2)).to(wide)
    vx0 = ((x0 >= 0) & (x0 <= w - 1)).to(wide)
    vx1 = ((x0 >= -1) & (x0 <= w - 2)).to(wide)
    yc = torch.clamp(y0, -1, h - 1).to(torch.int64) + 1  # (rows, dg, K)
    xc = torch.clamp(x0, -1, w - 1).to(torch.int64) + 1
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    xp = xp.reshape(n * (h + 2) * (w + 2) * dg, cg)
    g = torch.arange(dg, device=x.device)[None, :, None]
    base = item[:, None, None] * (h + 2)

    def corner(dy, dx):
        rows_idx = ((base + yc + dy) * (w + 2) + xc + dx) * dg + g
        return xp[rows_idx.reshape(-1)].reshape(rows, dg, k, cg).to(wide)

    out = (corner(0, 0) * (wy0 * wx0 * vy0 * vx0)[..., None]
           + corner(0, 1) * (wy0 * wx1 * vy0 * vx1)[..., None]
           + corner(1, 0) * (wy1 * wx0 * vy1 * vx0)[..., None]
           + corner(1, 1) * (wy1 * wx1 * vy1 * vx1)[..., None])
    if mask is not None:
        m = mask.reshape(-1, dg, k)[row0:row0 + rows].to(wide)
        out = out * m[..., None]                   # (rows, dg, K, cg)
    out = out.to(x.dtype).permute(0, 2, 1, 3).reshape(rows, k, groups,
                                                       c // groups)
    return out.permute(2, 0, 1, 3)


def _check_cuda_inputs(name, x, coords, *others, backward=False):
    """What the kernels take: ``x`` and ``others`` (mask or grad out) all
    float32 or all bfloat16, ``coords`` (the offset or the flow) float32
    whatever x's type, all on one device; C and the channels of a deform
    group multiples of the 16-byte run a kernel thread loads and stores (4
    float32 or 8 bfloat16 channels); for a backward kernel the deform
    group's runs a power of two <= 32 (they are summed by warp shuffles).
    ``None`` entries of ``others`` (no mask) are skipped."""
    others = [t for t in others if t is not None]
    dg = coords.shape[3]
    c = x.shape[-1]
    if x.dtype not in _RUN or coords.dtype != torch.float32 \
            or any(t.dtype != x.dtype for t in others):
        raise TypeError(f'{name} kernel takes float32 or bfloat16 tensors '
                        'of one type, with float32 coordinates, got '
                        f'{[t.dtype for t in (x, coords, *others)]}')
    run = _RUN[x.dtype]
    if c % run or (c // dg) % run:
        raise ValueError(f'{name} kernel needs C and C/deform_groups to be '
                         f'multiples of {run} ({run} {x.dtype} channels are '
                         f'one 16-byte load), got C={c}, deform_groups={dg}')
    if any(t.device != x.device for t in (coords, *others)):
        raise ValueError(f'{name}: tensors lie on '
                         f'{[str(t.device) for t in (x, coords, *others)]}')
    runs = c // dg // run
    if backward and (runs > 32 or runs & (runs - 1)):
        raise ValueError(f'{name} backward kernel needs C/deform_groups/'
                         f'{run} to be a power of two <= 32, got {runs}')


def _check_fused_inputs(x, offset, mask, weight, bias=None, go=None,
                        backward=False):
    """The fused kernels' rules beyond :func:`_check_cuda_inputs`'s, for K2,
    K3 and K5 alike: x, mask (or none), weight, bias and grad out all
    float32 or all bfloat16 (the offset float32); Cout a multiple of 8
    (16-byte runs of the output, grad out and weight rows, and the row
    strides of the TMA boxes, which must be multiples of 16 bytes) and at
    most :data:`FUSED_MAX_COUT` (the widest output tile: the forward's
    wgmma is at most 256 wide);
    deform_groups * kh * kw at most :data:`FUSED_MAX_STAGED` (the offsets a
    block stages); for the backward a deform group's runs of 16 bytes
    (C/deform_groups/4 at float32, /8 at bfloat16) a power of two <= 8
    (they are summed by shuffles within a chunk of 8 runs)."""
    _check_cuda_inputs('mdcn', x, offset, mask)
    cout = weight.shape[3]
    dg = offset.shape[3]
    if any(t is not None and t.dtype != x.dtype for t in (weight, bias, go)):
        name = str(x.dtype).split('.')[-1]
        raise TypeError(f'the fused DCN kernels take a {name} weight, bias '
                        'and grad out (x\'s type), got '
                        f'{[getattr(t, "dtype", None) for t in (weight, bias, go)]}')
    if any(t is not None and t.device != x.device
           for t in (weight, bias, go)):
        raise ValueError('mdcn: weight, bias and grad out must lie on '
                         f'{x.device}')
    if cout % 8:
        raise ValueError(f'the fused DCN kernels need Cout to be a '
                         f'multiple of 8 (16-byte rows), got '
                         f'Cout={cout}')
    if cout > FUSED_MAX_COUT:
        raise ValueError(f'the fused DCN kernels take Cout at most '
                         f'{FUSED_MAX_COUT} (the widest output tile), got '
                         f'Cout={cout}')
    kh, kw = weight.shape[:2]
    if dg * kh * kw > FUSED_MAX_STAGED:
        raise ValueError(f'the fused DCN kernels take deform_groups * '
                         f'kh * kw at most {FUSED_MAX_STAGED} (the offsets '
                         f'a block stages), got {dg} * {kh} * {kw}')
    run = _RUN[x.dtype]
    runs = x.shape[3] // dg // run
    if backward and (runs > 8 or runs & (runs - 1)):
        raise ValueError(f'the fused DCN backward needs C/deform_groups/'
                         f'{run} to be a power of two <= 8 at {x.dtype}, '
                         f'got {runs}')


def _variant(mask, groups):
    """The TPU kernel a call ports: ``'k5'`` (DCNv1, no mask), ``'k3'``
    (conv groups > 1) or ``'k2'`` (conv groups 1, a mask)."""
    return 'k5' if mask is None else 'k3' if groups > 1 else 'k2'


def _fused_kernels(dtype, variant='k2'):
    """The fused kernels of ``variant`` (:data:`VARIANTS`) at ``dtype``: the
    forward, dgrad, its grad-x scatter variant, wgrad and the sum of
    wgrad's partials, looked up in :data:`FUSED_KERNELS` at each call."""
    suffix = _FUSED_TYPES[dtype][1]
    return tuple(FUSED_KERNELS[f'{VARIANTS[variant]}_{part}{suffix}']
                 for part in _FUSED_PARTS)


def _block_diagonal(weight, groups):
    """HWIO ``(kh, kw, C/G, Cout)`` -> ``(kh, kw, C, Cout)``: input channel
    group q feeds only output channels ``[q Cout/G, (q + 1) Cout/G)`` (the
    JAX package's ``reshape(cin_g, groups, cout // groups)``, its
    dcn.py:238); exact zeros elsewhere, which add nothing to the fused
    kernels' f32 sums."""
    if groups == 1:
        return weight
    kh, kw, cin_g, cout = weight.shape
    full = weight.new_zeros((kh, kw, groups, cin_g, groups, cout // groups))
    q = torch.arange(groups, device=weight.device)
    full[:, :, q, :, q] = weight.reshape(kh, kw, cin_g, groups, -1).permute(
        3, 0, 1, 2, 4)
    return full.reshape(kh, kw, groups * cin_g, cout)


def _diagonal_blocks(grad_w, shape, groups):
    """The gradient of a weight of ``shape`` ``(kh, kw, C/G, Cout)`` out of
    that of its block-diagonal expansion, ``(K * C, Cout)``: the blocks
    :func:`_block_diagonal` fills."""
    if groups == 1:
        return grad_w.reshape(shape)
    kh, kw, cin_g, cout = shape
    full = grad_w.reshape(kh, kw, groups, cin_g, groups, cout // groups)
    q = torch.arange(groups, device=grad_w.device)
    return full[:, :, q, :, q].permute(1, 2, 3, 0, 4).reshape(shape)


def _aligned16(t):
    """``t`` contiguous at a 16-byte aligned address (the fused kernels
    load 16-byte runs of x, the weight and grad out, and offset pairs),
    copied where a view starts elsewhere."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t):
    """A tensor's device pointer, or NULL for None."""
    return None if t is None else t.data_ptr()


def _geometry(x, offset, mask, weight, stride, padding, dilation, groups,
              deform_groups):
    """Check the shapes; return ``((kh, kw), (sh, sw), (ph, pw), (dh, dw),
    (ho, wo))``."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    n, h, w, c = x.shape
    kh, kw, cin_g, cout = weight.shape
    k = kh * kw
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = deform_groups
    if offset.shape != (n, ho, wo, dg, k, 2):
        raise ValueError(f'offset shape {tuple(offset.shape)} != '
                         f'{(n, ho, wo, dg, k, 2)}')
    if mask is not None and mask.shape != (n, ho, wo, dg, k):
        raise ValueError(f'mask shape {tuple(mask.shape)} != '
                         f'{(n, ho, wo, dg, k)}')
    if c % dg:
        raise ValueError(f'C={c} must divide by deform_groups={dg}')
    if c % groups or cout % groups or cin_g != c // groups:
        raise ValueError(f'C={c} and Cout={cout} must divide by groups='
                         f'{groups}, and the weight take C/groups input '
                         f'channels, not {cin_g}')
    return (kh, kw), (sh, sw), (ph, pw), (dh, dw), (ho, wo)


def _row_chunks(total, k, c, element_size):
    chunk = max(1, COL_CAP_BYTES // (k * c * element_size))
    return [(row0, min(chunk, total - row0))
            for row0 in range(0, total, chunk)]


def _grouped_weight(weight, groups):
    """HWIO ``(kh, kw, C/G, Cout)`` -> ``(G, K * C/G, Cout/G)``: group q's
    output channels are ``[q * Cout/G, (q + 1) * Cout/G)`` (the JAX
    package's ``reshape(cin_g, groups, cout // groups)``)."""
    kh, kw, cin_g, cout = weight.shape
    return weight.reshape(kh * kw, cin_g, groups, cout // groups).permute(
        2, 0, 1, 3).reshape(groups, kh * kw * cin_g, cout // groups)


def _mdcn_forward(x, offset, mask, weight, bias, geom, im2col, groups=1):
    """The plain version: ``im2col``'s columns of each chunk of rows times
    the weight, ``torch.mm`` (``torch.addmm`` with an f32 bias) or, over
    the conv groups, ``torch.bmm``."""
    x, offset = x.contiguous(), offset.contiguous()
    mask = None if mask is None else mask.contiguous()
    (kh, kw), (ho, wo) = geom[0], geom[4]
    n, c = x.shape[0], x.shape[3]
    k, cout = kh * kw, weight.shape[3]
    if groups == 1:
        w2d = weight.reshape(k * c, cout)
    else:
        w_g = _grouped_weight(weight, groups)
    pieces = []
    for row0, rows in _row_chunks(n * ho * wo, k, c, x.element_size()):
        col = im2col(x, offset, mask, row0, rows, geom, groups)
        if groups == 1:
            col = col.reshape(rows, k * c)
            if bias is None:
                pieces.append(torch.mm(col, w2d))
            elif x.dtype == torch.float32:
                pieces.append(torch.addmm(bias, col, w2d))
            else:   # the bias after the rounding to x's type (JAX :104)
                pieces.append(torch.mm(col, w2d) + bias)
        else:
            out = torch.bmm(col.reshape(groups, rows, -1), w_g)
            out = out.permute(1, 0, 2).reshape(rows, cout)
            pieces.append(out if bias is None else out + bias)
        del col
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    return out.reshape(n, ho, wo, cout)


def _split_tf32_ref(w):
    """Plain version of ``mdcn_fused_split``: the float32 ``w`` as its
    3xTF32 planes ``(2, *w.shape)``, hi = w rounded to TF32, ties away from
    zero (half of the dropped 13 bits added to the bits, then cleared), lo
    = w - hi, exact in float32, so that hi + lo == w."""
    bits = w.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.stack([hi, w - hi])


def _weight_operand(w):
    """The weight the fused forward (``w`` is wt, ``(Cout, K * C)``) or
    dgrad (the HWIO weight, ``(K * C, Cout)``) reads: at bfloat16 ``w``
    itself; at float32 its TF32 hi and lo planes, split by one launch of
    ``mdcn_fused_split`` into a scratch of twice its size."""
    if w.dtype != torch.float32:
        return w
    planes = torch.empty((2, *w.shape), dtype=torch.float32, device=w.device)
    mdcn_fused_split_kernel(w.data_ptr(), planes.data_ptr(), w.numel(),
                            torch.cuda.current_stream().cuda_stream)
    return planes


def _fused_args(x, offset, weight, geom):
    """The geometry and stream arguments of the fused kernels."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw), (ho, wo) = geom
    n, h, w, c = x.shape
    return (n * ho * wo, h, w, c, weight.shape[3], ho, wo, kh, kw, sh, sw,
            ph, pw, dh, dw, offset.shape[3],
            torch.cuda.current_stream().cuda_stream)


def _mdcn_fused_forward_cuda(x, offset, mask, weight, bias, geom, groups=1):
    """The forward of K2, K3 (``groups > 1``, on the block-diagonal weight)
    or K5 (``mask`` None), float32 or bfloat16, one launch of its
    ``mdcn_fused_fwd``: same contract as :func:`_mdcn_fused_forward_ref`."""
    _check_fused_inputs(x, offset, mask, weight, bias)
    kernels = _fused_kernels(x.dtype, _variant(mask, groups))
    x, offset = _aligned16(x), _aligned16(offset)
    mask = None if mask is None else mask.contiguous()
    (kh, kw), (ho, wo) = geom[0], geom[4]
    n, c = x.shape[0], x.shape[3]
    cout = weight.shape[3]
    # the products' B operand wants the (tap, channel) depth contiguous
    wt = _block_diagonal(weight, groups).reshape(kh * kw * c, cout).t() \
        .contiguous()
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        wt = _weight_operand(wt)
        kernels[0](x.data_ptr(), offset.data_ptr(), _ptr(mask), wt.data_ptr(),
                   _ptr(None if bias is None else bias.contiguous()),
                   out.data_ptr(), *_fused_args(x, offset, weight, geom))
    return out


def _mdcn_fused_forward_ref(x, offset, mask, weight, bias, geom, groups=1):
    """Plain version of ``mdcn_fused_fwd``: at bf16 the columns rounded to
    bf16 once, their bf16 product with the weight summed in f32 and rounded
    (``torch.mm``, over the conv groups ``torch.bmm``), the bias added after
    that rounding; at f32 the exact columns' product with the weight plus
    the bias (``torch.addmm``)."""
    return _mdcn_forward(x, offset, mask, weight, bias, geom, _im2col_ref,
                         groups)


def _wgrad_slices(n, ho, wo, k, c, cout, dtype):
    """``(splits, split_patches)``: wgrad's slices of 8 x 8 output patches
    (numbered item-major, then row-major) for ``k * ceil(C / BK)`` tiles
    (BK 8 runs of 16 bytes: 64 bf16 or 32 f32 channels), about
    :data:`WGRAD_WAVES` waves of blocks."""
    patches = n * -(-ho // PATCH) * -(-wo // PATCH)
    tiles = k * -(-c // (8 * _RUN[dtype]))
    per_sm = 1 if cout > 128 else 2
    splits = max(1, min(WGRAD_WAVES * 132 * per_sm // tiles, patches))
    split_patches = -(-patches // splits)
    return -(-patches // split_patches), split_patches


def _mdcn_fused_backward_cuda(go, x, offset, mask, weight, geom, need_x,
                              need_sample, need_params, groups=1):
    """The backward of K2, K3 or K5, float32 or bfloat16: its
    ``mdcn_fused_dgrad`` (the ``_scatter`` variant where x needs a
    gradient; at float32 after ``mdcn_fused_split`` of the weight) when x,
    the offset or the mask needs one, then its
    ``mdcn_fused_wgrad`` and the ordered sum of its partials when the
    weight or the bias does. ``go`` is the ``(rows, Cout)`` grad out.
    Returns grad x (float32), grad offset (float32), grad mask (x's type;
    None without a mask), grad weight (float32, ``weight``'s shape: with
    ``groups > 1`` the diagonal blocks of the block-diagonal weight's) and
    grad bias (float32), None where not asked."""
    _check_fused_inputs(x, offset, mask, weight, go=go, backward=True)
    _, dgrad, dgrad_scatter, wgrad, wgrad_sum = _fused_kernels(
        x.dtype, _variant(mask, groups))
    full = _aligned16(_block_diagonal(weight, groups))
    go, x, offset = _aligned16(go), _aligned16(x), _aligned16(offset)
    mask = None if mask is None else mask.contiguous()
    (kh, kw), (ho, wo) = geom[0], geom[4]
    c, cout = x.shape[3], weight.shape[3]
    args = _fused_args(x, offset, weight, geom)
    grad_x = grad_offset = grad_mask = grad_w = grad_b = None
    with torch.cuda.device(x.device):
        if need_sample or need_x:
            grad_offset = torch.empty_like(offset)
            grad_mask = None if mask is None else torch.empty_like(mask)
            w = _weight_operand(full)
            head = (go.data_ptr(), x.data_ptr(), offset.data_ptr(),
                    _ptr(mask), w.data_ptr(), grad_offset.data_ptr(),
                    _ptr(grad_mask))
            if need_x:
                grad_x = torch.zeros_like(x, dtype=torch.float32)
                dgrad_scatter(*head, grad_x.data_ptr(), *args)
            else:
                dgrad(*head, *args)
        if need_params:
            splits, split_patches = _wgrad_slices(x.shape[0], ho, wo,
                                                  kh * kw, c, cout, x.dtype)
            # grad weight's K * C rows, then grad bias
            partial = torch.empty((splits, kh * kw * c + 1, cout),
                                  dtype=torch.float32, device=x.device)
            wgrad(go.data_ptr(), x.data_ptr(), offset.data_ptr(), _ptr(mask),
                  partial.data_ptr(), splits, split_patches, *args)
            total = torch.empty(partial.shape[1:], dtype=torch.float32,
                                device=x.device)
            wgrad_sum(
                partial.data_ptr(), total.data_ptr(), splits, total.numel(),
                args[-1])
            grad_w = _diagonal_blocks(total[:-1], weight.shape, groups)
            grad_b = total[-1]
    return grad_x, grad_offset, grad_mask, grad_w, grad_b


class _ModulatedDeformConv2d(torch.autograd.Function):
    """The CUDA path (K2, K3, K5) with its hand-written backward; ``mask``
    None is DCNv1."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, geom, groups):
        x, offset = _aligned16(x), _aligned16(offset)
        mask = None if mask is None else mask.contiguous()
        ctx.geom, ctx.groups = geom, groups
        ctx.save_for_backward(x, offset, mask, weight)
        return _mdcn_fused_forward_cuda(x, offset, mask, weight, bias, geom,
                                        groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        need_x, need_offset, need_mask, need_weight, need_bias = \
            ctx.needs_input_grad[:5]
        # grad_out comes as a permuted view of a channels-last tensor
        go = grad_out.reshape(-1, weight.shape[3]).contiguous()
        grad_x, grad_offset, grad_mask, grad_w, grad_b = \
            _mdcn_fused_backward_cuda(go, x, offset, mask, weight, ctx.geom,
                                      need_x, need_offset or need_mask,
                                      need_weight or need_bias, ctx.groups)
        return (None if grad_x is None else grad_x.to(x.dtype),
                grad_offset if need_offset else None,
                grad_mask if need_mask else None,
                grad_w.to(weight.dtype) if need_weight else None,
                grad_b.to(go.dtype) if need_bias else None, None, None)


def _dispatch(name, x, offset, mask, weight, bias, geom, groups):
    if x.dtype == torch.bfloat16 and offset.dtype == torch.bfloat16:
        offset = offset.float()     # exact: the coordinates are f32
    if x.is_cuda:
        return _ModulatedDeformConv2d.apply(x, offset, mask, weight, bias,
                                            geom, groups)
    if x.device.type != 'cpu':
        raise RuntimeError(f'{name} runs on cuda or cpu tensors, got '
                           f'{x.device}')
    with f32_products(x.device):
        return _mdcn_forward(x, offset, mask, weight, bias, geom,
                             _im2col_ref, groups)


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, stride=1,
                            padding=1, dilation=1, groups=1,
                            deform_groups=1):
    """DCNv2 with mmcv semantics, differentiable in ``x``, ``offset``,
    ``mask``, ``weight`` and ``bias``: sampling positions are
    ``p_out * stride - pad + tap * dilation + offset``, bilinear, and a
    corner outside the image contributes zero. ``floor`` carries no
    gradient, so at an integer position the gradient in the offset is the
    one-sided difference towards the next pixel. With ``groups > 1`` input
    channel group q feeds output channel group q only. Layouts in the
    module docstring."""
    geom = _geometry(x, offset, mask, weight, stride, padding, dilation,
                     groups, deform_groups)
    return _dispatch('modulated_deform_conv2d', x, offset, mask, weight,
                     bias, geom, groups)


def modulated_deform_conv2d_ref(x, offset, mask, weight, bias=None,
                                stride=1, padding=1, dilation=1, groups=1,
                                deform_groups=1):
    """:func:`modulated_deform_conv2d` through the plain PyTorch im2col and
    autograd on any device: the yardstick the CUDA kernels are held
    against."""
    geom = _geometry(x, offset, mask, weight, stride, padding, dilation,
                     groups, deform_groups)
    return _mdcn_forward(x, offset, mask, weight, bias, geom, _im2col_ref,
                         groups)


def deform_conv2d(x, offset, weight, stride=1, padding=0, dilation=1,
                  groups=1, deform_groups=1):
    """DCNv1, the reference ops surface's ``deform_conv``: the sampling of
    :func:`modulated_deform_conv2d` with no mask (mask 1) and no bias, and
    a default padding of 0. Differentiable in ``x``, ``offset`` and
    ``weight``. On a CUDA tensor the fused kernels run with a null mask
    (K5): no mask is read, made or differentiated."""
    geom = _geometry(x, offset, None, weight, stride, padding, dilation,
                     groups, deform_groups)
    return _dispatch('deform_conv2d', x, offset, None, weight, None, geom,
                     groups)


def deform_conv2d_ref(x, offset, weight, stride=1, padding=0, dilation=1,
                      groups=1, deform_groups=1):
    """Plain version of :func:`deform_conv2d` on any device:
    :func:`modulated_deform_conv2d_ref` with a mask of ones."""
    mask = torch.ones(offset.shape[:5], dtype=x.dtype, device=x.device)
    return modulated_deform_conv2d_ref(x, offset, mask, weight, None, stride,
                                       padding, dilation, groups,
                                       deform_groups)


def _check_flow(x, flow):
    n, h, w, c = x.shape
    if flow.dim() != 5 or flow.shape != (n, h, w, flow.shape[3], 2):
        raise ValueError(f'flow shape {tuple(flow.shape)} != '
                         f'{(n, h, w, "dg", 2)}')
    if c % flow.shape[3]:
        raise ValueError(f'C={c} must divide by the flow\'s '
                         f'{flow.shape[3]} deform groups')


def deform_sample_ref(x, flow):
    """Plain version of :func:`deform_sample` on any device: the K = 1
    case of :func:`_im2col_ref`'s gather, differentiable by autograd."""
    _check_flow(x, flow)
    n, h, w, c = x.shape
    geom = ((1, 1), (1, 1), (0, 0), (1, 1), (h, w))
    mask = torch.ones(flow.shape[:4] + (1,), dtype=x.dtype, device=x.device)
    col = _im2col_ref(x, flow[..., None, :], mask, 0, n * h * w,
                      geom)
    return col.reshape(n, h, w, c)


def _deform_sample_fwd_cuda(x, flow):
    """The forward kernel on contiguous ``x`` and ``flow``, same contract
    as :func:`deform_sample_ref`."""
    _check_cuda_inputs('deform_sample', x, flow)
    if x.numel() // _RUN[x.dtype] >= 2 ** 31:
        raise ValueError(f'deform_sample kernel indexes runs of '
                         f'{_RUN[x.dtype]} channels with an int; x has '
                         f'{x.numel()} elements')
    out = torch.empty_like(x)
    kernel = (deform_sample_fwd_bf16_kernel if x.dtype == torch.bfloat16
              else deform_sample_fwd_kernel)
    with torch.cuda.device(x.device):
        kernel(
            x.data_ptr(), flow.data_ptr(), out.data_ptr(), *x.shape,
            flow.shape[3], torch.cuda.current_stream().cuda_stream)
    return out


class _DeformSample(torch.autograd.Function):
    """The CUDA kernels of ``csrc/deform_sample.cu``."""

    @staticmethod
    def forward(ctx, x, flow):
        x, flow = x.contiguous(), flow.contiguous()
        ctx.save_for_backward(x, flow)
        return _deform_sample_fwd_cuda(x, flow)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, flow = ctx.saved_tensors
        need_x = ctx.needs_input_grad[0]
        go = grad_out.contiguous()
        _check_cuda_inputs('deform_sample', x, flow, go, backward=True)
        grad_flow = torch.empty_like(flow)
        # grad x is summed in f32 and, for a bf16 x, rounded once
        grad_x = torch.zeros_like(x, dtype=torch.float32) if need_x else None
        head = (go.data_ptr(), x.data_ptr(), flow.data_ptr(),
                grad_flow.data_ptr())
        bf16 = x.dtype == torch.bfloat16
        with torch.cuda.device(x.device):
            tail = (*x.shape, flow.shape[3],
                    torch.cuda.current_stream().cuda_stream)
            if need_x:
                kernel = (deform_sample_bwd_scatter_bf16_kernel if bf16
                          else deform_sample_bwd_scatter_kernel)
                kernel(*head, grad_x.data_ptr(), *tail)
            else:
                kernel = (deform_sample_bwd_bf16_kernel if bf16
                          else deform_sample_bwd_kernel)
                kernel(*head, *tail)
        return (None if grad_x is None else grad_x.to(x.dtype),
                grad_flow if ctx.needs_input_grad[1] else None)


def deform_sample(x, flow):
    """Per-pixel grouped bilinear sampling, the flow alignment's warp:
    group ``g`` of the output at ``(y, x)`` is group ``g`` of ``x``
    sampled bilinearly at ``(y, x) + flow[n, y, x, g]``, mmcv zero-outside
    corners, f32 coordinates. ``x`` is ``(N, H, W, C)``, ``flow``
    ``(N, H, W, dg, 2)`` as (dy, dx); returns ``(N, H, W, C)``.
    Differentiable in ``x`` and ``flow``. A bf16 ``x`` is sampled at f32
    coordinates (a bf16 flow is widened exactly), in f32, and rounded
    once."""
    _check_flow(x, flow)
    if x.dtype == torch.bfloat16 and flow.dtype == torch.bfloat16:
        flow = flow.float()
    if x.is_cuda:
        return _DeformSample.apply(x, flow)
    if x.device.type != 'cpu':
        raise RuntimeError(f'deform_sample runs on cuda or cpu tensors, '
                           f'got {x.device}')
    return deform_sample_ref(x, flow)


def offset_mask_from_conv_out(out, deform_groups, kernel_size=(3, 3)):
    """Split an NHWC ``conv_offset_mask`` output ``(N, Ho, Wo, 3*dg*K)``
    into ``offset (N, Ho, Wo, dg, K, 2)`` as (dy, dx) and the raw
    (un-sigmoided) ``mask (N, Ho, Wo, dg, K)``.

    The conv's channels are the thirds (o1, o2, mask); mmcv reads the
    concatenated (o1, o2), i.e. the first two thirds, as interleaved
    (dy, dx) pairs per tap within each deform group."""
    n, ho, wo, c3 = out.shape
    k = kernel_size[0] * kernel_size[1]
    dg = deform_groups
    if c3 != 3 * dg * k:
        raise ValueError(f'conv output has {c3} channels, expected '
                         f'3 * {dg} * {k}')
    offset = out[..., :2 * dg * k].reshape(n, ho, wo, dg, k, 2)
    mask = out[..., 2 * dg * k:].reshape(n, ho, wo, dg, k)
    return offset, mask
