"""Modulated deformable convolution (DCNv2), forward, conv groups == 1.

Port of ``mrefsr_tpu/ops/dcn.py``. The sampling half (deformable im2col)
runs in ``csrc/mdcn.cu`` on a CUDA tensor and in :func:`_im2col_ref` on a
CPU tensor; the contraction over (tap, channel) is one matmul with the
reshaped weight, as the JAX package leaves it to an XLA einsum. Rows are
processed in chunks so that the column scratch stays under
:data:`COL_CAP_BYTES`.

Layouts (the JAX package's, NHWC / HWIO):
    x:      (N, H, W, C)
    offset: (N, Ho, Wo, dg, K, 2)   last dim (dy, dx), K = kh*kw row-major
    mask:   (N, Ho, Wo, dg, K)      already sigmoid-ed by the caller
    weight: (kh, kw, C, Cout)
    bias:   (Cout,) or None
"""
import ctypes

import torch

from ._build import Kernel

# Column scratch per chunk. One CUFED5 request's relu1_1 level needs
# 5 * 250000 rows * 576 * 4 B = 2.9 GB of columns; 512 MiB keeps the
# scratch small beside the activations and each launch's float4 index
# within an int.
COL_CAP_BYTES = 512 << 20

mdcn_im2col_kernel = Kernel(
    'mdcn', 'mdcn_im2col_launch',
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + [ctypes.c_void_p])


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _im2col_ref(x, offset, mask, row0, rows, geom):
    """Plain version of the kernel: the columns ``(rows, K, C)`` of output
    rows ``[row0, row0 + rows)`` of the flattened ``(N, Ho, Wo)``."""
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
    m = mask.reshape(-1, dg, k)[row0:row0 + rows]
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
    vy0 = ((y0 >= 0) & (y0 <= h - 1)).to(x.dtype)
    vy1 = ((y0 >= -1) & (y0 <= h - 2)).to(x.dtype)
    vx0 = ((x0 >= 0) & (x0 <= w - 1)).to(x.dtype)
    vx1 = ((x0 >= -1) & (x0 <= w - 2)).to(x.dtype)
    yc = torch.clamp(y0, -1, h - 1).to(torch.int64) + 1  # (rows, dg, K)
    xc = torch.clamp(x0, -1, w - 1).to(torch.int64) + 1
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    xp = xp.reshape(n * (h + 2) * (w + 2) * dg, cg)
    g = torch.arange(dg, device=x.device)[None, :, None]
    base = item[:, None, None] * (h + 2)

    def corner(dy, dx):
        rows_idx = ((base + yc + dy) * (w + 2) + xc + dx) * dg + g
        return xp[rows_idx.reshape(-1)].reshape(rows, dg, k, cg)

    out = (corner(0, 0) * (wy0 * wx0 * vy0 * vx0)[..., None]
           + corner(0, 1) * (wy0 * wx1 * vy0 * vx1)[..., None]
           + corner(1, 0) * (wy1 * wx0 * vy1 * vx0)[..., None]
           + corner(1, 1) * (wy1 * wx1 * vy1 * vx1)[..., None])
    out = out * m[..., None]                       # (rows, dg, K, cg)
    return out.permute(0, 2, 1, 3).reshape(rows, k, c)


def _im2col_cuda(x, offset, mask, row0, rows, geom):
    """The CUDA kernel, same contract as :func:`_im2col_ref`."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw), (ho, wo) = geom
    n, h, w, c = x.shape
    dg = offset.shape[3]
    if x.dtype != torch.float32 or offset.dtype != torch.float32 \
            or mask.dtype != torch.float32:
        raise TypeError('mdcn kernel takes float32 x, offset and mask, got '
                        f'{x.dtype}, {offset.dtype}, {mask.dtype}')
    if c % 4 or (c // dg) % 4:
        raise ValueError(f'mdcn kernel needs C and C/deform_groups to be '
                         f'multiples of 4, got C={c}, deform_groups={dg}')
    if not (x.device == offset.device == mask.device):
        raise ValueError(f'x, offset and mask lie on {x.device}, '
                         f'{offset.device}, {mask.device}')
    col = torch.empty((rows, kh * kw, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        mdcn_im2col_kernel(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                           col.data_ptr(), row0, rows, h, w, c, ho, wo, kh,
                           kw, sh, sw, ph, pw, dh, dw, dg,
                           torch.cuda.current_stream().cuda_stream)
    return col


def _mdcn(x, offset, mask, weight, bias, stride, padding, dilation, groups,
          deform_groups, im2col):
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    n, h, w, c = x.shape
    kh, kw, cin_g, cout = weight.shape
    k = kh * kw
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = deform_groups
    if groups != 1:
        raise NotImplementedError(
            'modulated_deform_conv2d with conv groups > 1 is not ported yet '
            '(ROADMAP B4, mrefsr_tpu/ops/dcn.py::_mdcn_tap_scan)')
    if offset.shape != (n, ho, wo, dg, k, 2):
        raise ValueError(f'offset shape {tuple(offset.shape)} != '
                         f'{(n, ho, wo, dg, k, 2)}')
    if mask.shape != (n, ho, wo, dg, k):
        raise ValueError(f'mask shape {tuple(mask.shape)} != '
                         f'{(n, ho, wo, dg, k)}')
    if c % dg or cin_g != c:
        raise ValueError(f'C={c} must divide by deform_groups={dg} and '
                         f'equal the weight input channels {cin_g}')
    x = x.contiguous()
    offset = offset.contiguous()
    mask = mask.contiguous()
    w2d = weight.reshape(k * c, cout)
    geom = ((kh, kw), (sh, sw), (ph, pw), (dh, dw), (ho, wo))
    total = n * ho * wo
    chunk = max(1, COL_CAP_BYTES // (k * c * x.element_size()))
    out = torch.empty((total, cout), dtype=x.dtype, device=x.device)
    for row0 in range(0, total, chunk):
        rows = min(chunk, total - row0)
        col = im2col(x, offset, mask, row0, rows, geom).reshape(rows, k * c)
        if bias is None:
            torch.mm(col, w2d, out=out[row0:row0 + rows])
        else:
            torch.addmm(bias, col, w2d, out=out[row0:row0 + rows])
    return out.reshape(n, ho, wo, cout)


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, stride=1,
                            padding=1, dilation=1, groups=1,
                            deform_groups=1):
    """DCNv2 forward with mmcv semantics: sampling positions are
    ``p_out * stride - pad + tap * dilation + offset``, bilinear, and a
    corner outside the image contributes zero. Layouts in the module
    docstring. ``groups > 1`` raises ``NotImplementedError``."""
    if x.is_cuda:
        im2col = _im2col_cuda
    elif x.device.type == 'cpu':
        im2col = _im2col_ref
    else:
        raise RuntimeError(f'modulated_deform_conv2d runs on cuda or cpu '
                           f'tensors, got {x.device}')
    return _mdcn(x, offset, mask, weight, bias, stride, padding, dilation,
                 groups, deform_groups, im2col)


def modulated_deform_conv2d_ref(x, offset, mask, weight, bias=None,
                                stride=1, padding=1, dilation=1, groups=1,
                                deform_groups=1):
    """:func:`modulated_deform_conv2d` through the plain PyTorch im2col on
    any device: the yardstick the CUDA kernel is held against."""
    return _mdcn(x, offset, mask, weight, bias, stride, padding, dilation,
                 groups, deform_groups, _im2col_ref)


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
