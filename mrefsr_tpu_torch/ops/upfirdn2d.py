"""upfirdn2d: upsample, pad, FIR filter, downsample, per channel, with its
gradient to any order.

Port of ``mrefsr_tpu/ops/upfirdn2d.py``. On a CUDA tensor the op is the
gather kernel of ``csrc/upfirdn2d.cu``, wrapped in a
``torch.autograd.Function`` whose backward is the same Function with ``up``
and ``down`` swapped, the FIR flipped and the pads of :func:`_transposed`:
so the backward, the double backward (R1, the path-length penalty) and any
higher order launch the kernel too. On a CPU tensor the op is
:func:`upfirdn2d_ref` and autograd runs through it.

Layout: ``x`` is ``(N, C, H, W)``, the layout of the port's StyleGAN2 nets
(the JAX op takes NHWC; per channel the two compute the same). The kernel
reads ``N * C`` contiguous planes: a tensor in another memory layout (e.g.
channels-last) is made contiguous once, by the wrapper. ``kernel`` is the
``(kh, kw)`` FIR, not flipped: the op applies it flipped, a true
convolution. It is a constant (no gradient) and is best kept on the CPU:
the CUDA path passes its values by value, and reading them off a CUDA
tensor waits for the device.
"""
import ctypes

import torch
from torch.nn import functional as F

from ._build import Kernel

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
# One kernel behind three entry points, which only count apart: the op
# itself, its backward, and the backward's backward (a third or higher
# order counts with the double backward).
upfirdn2d_kernels = tuple(
    Kernel('upfirdn2d', f'upfirdn2d_{order}_launch', _ARGTYPES)
    for order in ('fwd', 'bwd', 'bwd2'))
upfirdn2d_fwd_kernel, upfirdn2d_bwd_kernel, upfirdn2d_bwd2_kernel = \
    upfirdn2d_kernels
MAX_TAPS = 64


def _out_size(size, k, up, down, pad0, pad1):
    return (size * up + pad0 + pad1 - k) // down + 1


def _check(x, fir, up, down, pads):
    """Shapes and sizes both paths refuse; returns ``(out_h, out_w)``."""
    if x.dim() != 4:
        raise ValueError(f'upfirdn2d takes (N, C, H, W), got '
                         f'{tuple(x.shape)}')
    if fir.dim() != 2:
        raise ValueError(f'the FIR kernel must be (kh, kw), got '
                         f'{tuple(fir.shape)}')
    if up < 1 or down < 1:
        raise ValueError(f'up and down must be >= 1, got {up}, {down}')
    kh, kw = fir.shape
    out_h = _out_size(x.shape[2], kh, up, down, pads[0], pads[1])
    out_w = _out_size(x.shape[3], kw, up, down, pads[2], pads[3])
    if x.shape[2] * up + pads[0] + pads[1] < kh \
            or x.shape[3] * up + pads[2] + pads[3] < kw or x.numel() == 0:
        raise ValueError(f'upfirdn2d of {tuple(x.shape)} with a {kh}x{kw} '
                         f'FIR, up {up} and pads {pads} has no output')
    return out_h, out_w


def _upfirdn2d_plain(x, fir, up, down, pads):
    """The plain version: zero-stuff, ``F.pad`` / crop, one-channel
    ``F.conv2d`` with the flipped FIR, stride slicing. ``pads`` is
    ``(y0, y1, x0, x1)``."""
    _check(x, fir, up, down, pads)
    n, c, h, w = x.shape
    kh, kw = fir.shape
    x = x.reshape(n * c, 1, h, w)
    if up > 1:
        stuffed = x.new_zeros((n * c, 1, h * up, w * up))
        stuffed[:, :, ::up, ::up] = x
        x = stuffed
    y0, y1, x0, x1 = pads
    x = F.pad(x, [max(x0, 0), max(x1, 0), max(y0, 0), max(y1, 0)])
    x = x[:, :, max(-y0, 0):x.shape[2] - max(-y1, 0),
          max(-x0, 0):x.shape[3] - max(-x1, 0)]
    weight = torch.flip(fir, [0, 1]).reshape(1, 1, kh, kw).to(x)
    x = F.conv2d(x, weight)
    if down > 1:
        x = x[:, :, ::down, ::down]
    return x.reshape(n, c, x.shape[2], x.shape[3])


def _upfirdn2d_cuda(x, fir, up, down, pads, order):
    """The CUDA kernel, same contract as :func:`_upfirdn2d_plain`;
    ``order`` picks the entry point that counts the launch."""
    out_h, out_w = _check(x, fir, up, down, pads)
    if fir.numel() > MAX_TAPS:
        raise ValueError(f'the upfirdn2d kernel takes a FIR of at most '
                         f'{MAX_TAPS} taps, got {tuple(fir.shape)}')
    if not x.is_cuda or x.dtype != torch.float32:
        raise TypeError(f'the upfirdn2d kernel takes float32 CUDA tensors, '
                        f'got {x.dtype} on {x.device}')
    n, c, h, w = x.shape
    if n * c * out_h * out_w >= 2 ** 39:      # 2^31 blocks of 256 threads
        raise ValueError(f'upfirdn2d kernel: {tuple(x.shape)} is too large')
    x = x.contiguous()
    taps = fir.detach().to('cpu', torch.float32).reshape(-1).tolist()
    fir_values = (ctypes.c_float * len(taps))(*taps)
    out = torch.empty((n, c, out_h, out_w), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        upfirdn2d_kernels[min(order, 2)](
            x.data_ptr(), out.data_ptr(), fir_values, n * c, h, w,
            fir.shape[0], fir.shape[1], up, down, *pads,
            torch.cuda.current_stream().cuda_stream)
    return out


def _transposed(in_hw, out_hw, fir, up, down, pads):
    """``(fir, up, down, pads)`` of the op that is the gradient in ``x``:
    the roles of ``up`` and ``down`` swap, the FIR is flipped, and the
    pads place the gradient's samples back over the ``up - 1`` trailing
    zeros and the rows a stride left unread. It maps ``out_hw`` back to
    exactly ``in_hw``."""
    kh, kw = fir.shape
    y0, _, x0, _ = pads
    g_pads = (kh - y0 - 1, in_hw[0] * up - out_hw[0] * down + y0 - up + 1,
              kw - x0 - 1, in_hw[1] * up - out_hw[1] * down + x0 - up + 1)
    return torch.flip(fir, [0, 1]), down, up, g_pads


class _UpFirDn2d(torch.autograd.Function):
    """The CUDA path. ``order`` is 0 for the op, 1 for its backward, 2 for
    the backward's backward, ...: each backward applies this Function
    again on the gradient."""

    @staticmethod
    def forward(ctx, x, fir, up, down, pads, order):
        out = _upfirdn2d_cuda(x, fir, up, down, pads, order)
        ctx.transposed = _transposed(x.shape[2:], out.shape[2:], fir, up,
                                     down, pads)
        ctx.order = order
        return out

    @staticmethod
    def backward(ctx, grad_out):
        grad_x = None
        if ctx.needs_input_grad[0]:
            grad_x = _UpFirDn2d.apply(grad_out, *ctx.transposed,
                                      ctx.order + 1)
        return grad_x, None, None, None, None, None


def _pads4(pad):
    pad = tuple(int(p) for p in pad)
    if len(pad) == 2:
        return pad + pad
    if len(pad) == 4:
        return pad
    raise ValueError(f'pad must be (pad0, pad1) or (y0, y1, x0, x1), got '
                     f'{pad}')


def _fir(kernel):
    return torch.as_tensor(kernel, dtype=torch.float32)


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """Up-FIR-down of an ``(N, C, H, W)`` tensor, per channel: zero-stuff
    by ``up`` (to ``H * up``, zeros after the last sample too), pad both
    axes by ``pad = (pad0, pad1)`` (negative crops), convolve with the
    ``(kh, kw)`` ``kernel``, keep every ``down``-th sample. The output has
    ``(H * up + pad0 + pad1 - kh) // down + 1`` rows. Differentiable in
    ``x`` to any order. ``pad`` may also be ``(y0, y1, x0, x1)``."""
    fir, pads = _fir(kernel), _pads4(pad)
    if x.is_cuda:
        return _UpFirDn2d.apply(x, fir, int(up), int(down), pads, 0)
    if x.device.type != 'cpu':
        raise RuntimeError(f'upfirdn2d runs on cuda or cpu tensors, got '
                           f'{x.device}')
    return _upfirdn2d_plain(x, fir, int(up), int(down), pads)


def upfirdn2d_ref(x, kernel, up=1, down=1, pad=(0, 0)):
    """:func:`upfirdn2d` through the plain PyTorch version and ordinary
    autograd on any device: the yardstick the CUDA kernel is held
    against."""
    return _upfirdn2d_plain(x, _fir(kernel), int(up), int(down), _pads4(pad))
