"""Bias + leaky ReLU + scale in one pass, as StyleGAN2 uses it, with its
gradient to any order.

Port of ``mrefsr_tpu/ops/fused_act.py``. On a CUDA tensor the forward and
the backward are the kernels of ``csrc/fused_act.cu``, each wrapped in a
``torch.autograd.Function``; the backward is linear in the incoming
gradient, so its own backward is the same kernel again (the double
backward that R1 and the path-length penalty need). ``grad_bias`` is
``torch.sum`` of ``grad_x`` over all but the channel axis, as the
reference's wrapper had it. On a CPU tensor the op is
:func:`fused_leaky_relu_ref` and autograd runs through it.

**At exactly 0 the derivative is 1**, as ``jax.nn.leaky_relu``
(``where(x >= 0, x, slope * x)``) has it; ``F.leaky_relu``'s backward
gives the slope there. So the plain version is written with
``torch.where`` and the kernel tests ``out >= 0``.

Layout: the channel axis is axis 1 (``(N, C, H, W)`` or ``(N, C)``; the
JAX op takes channels last). The kernel reads flat memory and finds the
channel from the element's index, for an NCHW-contiguous tensor, a
channels-last one and a 2-D one alike; any other memory layout is made
contiguous once, by the wrapper. The output has the input's layout.
"""
import ctypes

import torch

from ._build import Kernel

_TAIL = [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]  # slope ... stream
fused_leaky_relu_fwd_kernel = Kernel(
    'fused_act', 'fused_leaky_relu_fwd_launch',
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    + _TAIL)
# One kernel behind two entry points, which only count apart: the backward,
# and the backward's backward (a third or higher order counts with it).
fused_leaky_relu_bwd_kernel, fused_leaky_relu_bwd2_kernel = (
    Kernel('fused_act', f'fused_leaky_relu_{order}_launch',
           [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + _TAIL)
    for order in ('bwd', 'bwd2'))


def _check(x, bias):
    if x.dim() < 2:
        raise ValueError(f'fused_leaky_relu takes (N, C, ...), got '
                         f'{tuple(x.shape)}')
    if bias is not None and bias.shape != (x.shape[1],):
        raise ValueError(f'bias shape {tuple(bias.shape)} != '
                         f'({x.shape[1]},), the channel axis of '
                         f'{tuple(x.shape)}')


def fused_leaky_relu_ref(x, bias=None, negative_slope=0.2, scale=2 ** 0.5):
    """The plain version on any device: ``leaky_relu(x + bias over axis 1)
    * scale`` with ``torch.where``, so the derivative at 0 is 1.
    Differentiable by autograd to any order."""
    _check(x, bias)
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, x * negative_slope) * scale


def _memory_layout(x):
    """``(x in a layout the kernel reads, inner)``: the channel of flat
    element ``i`` is ``(i // inner) % C``."""
    if x.is_contiguous():
        return x, x[0, 0].numel()
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return x, 1
    return x.contiguous(), x[0, 0].numel()


def _like_layout(t, like):
    """``t`` in the memory layout of ``like`` (same shape)."""
    if t.stride() == like.stride():
        return t
    out = torch.empty_like(like)
    out.copy_(t)
    return out


def _check_cuda(name, *tensors):
    if any(not t.is_cuda or t.dtype != torch.float32 for t in tensors):
        raise TypeError(f'the {name} kernel takes float32 CUDA tensors, got '
                        f'{[(t.dtype, str(t.device)) for t in tensors]}')
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f'{name}: tensors lie on '
                         f'{[str(t.device) for t in tensors]}')
    if tensors[0].numel() == 0:
        raise ValueError(f'{name}: empty tensor')


class _FusedLeakyReLUBackward(torch.autograd.Function):
    """``grad_x`` from ``grad_out`` and the saved output. ``order`` is 1
    for the backward and 2 for its own backward, ..."""

    @staticmethod
    def forward(ctx, grad_out, out, negative_slope, scale, order):
        _check_cuda('fused_leaky_relu backward', grad_out, out)
        grad_out = _like_layout(grad_out, out)
        ctx.save_for_backward(out)
        ctx.args = (negative_slope, scale, order)
        grad_x = torch.empty_like(out)
        kernel = fused_leaky_relu_bwd_kernel if order == 1 \
            else fused_leaky_relu_bwd2_kernel
        with torch.cuda.device(out.device):
            kernel(grad_out.data_ptr(), out.data_ptr(), grad_x.data_ptr(),
                   out.numel(), negative_slope, scale,
                   torch.cuda.current_stream().cuda_stream)
        return grad_x

    @staticmethod
    def backward(ctx, grad_grad_x):
        # the output is piecewise constant in the saved `out`
        out, = ctx.saved_tensors
        negative_slope, scale, order = ctx.args
        return _FusedLeakyReLUBackward.apply(
            grad_grad_x, out, negative_slope, scale, order + 1), None, None, \
            None, None


class _FusedLeakyReLU(torch.autograd.Function):
    """The CUDA path."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        _check_cuda('fused_leaky_relu', x,
                    *(() if bias is None else (bias,)))
        x, inner = _memory_layout(x)
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            fused_leaky_relu_fwd_kernel(
                x.data_ptr(),
                None if bias is None else bias.contiguous().data_ptr(),
                out.data_ptr(), x.numel(), inner, x.shape[1], negative_slope,
                scale, torch.cuda.current_stream().cuda_stream)
        ctx.save_for_backward(out)
        ctx.args = (negative_slope, scale)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        out, = ctx.saved_tensors
        grad_x = _FusedLeakyReLUBackward.apply(grad_out, out, *ctx.args, 1)
        grad_bias = None
        if ctx.needs_input_grad[1]:
            grad_bias = grad_x.sum([d for d in range(grad_x.dim()) if d != 1])
        return grad_x, grad_bias, None, None


def fused_leaky_relu(x, bias=None, negative_slope=0.2, scale=2 ** 0.5):
    """``leaky_relu(x + bias, negative_slope) * scale`` with the bias
    ``(C,)`` added over axis 1 of ``x`` ``(N, C, ...)``. Differentiable in
    ``x`` and ``bias`` to any order; the derivative at 0 is 1."""
    _check(x, bias)
    if x.is_cuda:
        return _FusedLeakyReLU.apply(x, bias, float(negative_slope),
                                     float(scale))
    if x.device.type != 'cpu':
        raise RuntimeError(f'fused_leaky_relu runs on cuda or cpu tensors, '
                           f'got {x.device}')
    return fused_leaky_relu_ref(x, bias, negative_slope, scale)
