"""Bias + leaky ReLU + scale in one pass, as StyleGAN2 uses it, with its
gradient to any order.

Port of ``mrefsr_tpu/ops/fused_act.py``. On a CUDA tensor the forward is
the forward kernel of ``csrc/fused_act.cu``, and every derivative is its
backward kernel, ``res = (a + b[channel]) * scale * (out >= 0 ? 1 :
slope)`` with, where asked, ``sum(res)`` over all but the channel axis:
the backward (``a`` = grad_out, the sum = grad_bias) and the double
backward (``a`` = gg_x, ``b`` = gg_bias, either absent), whose own
backward is the backward again. Each is one ``torch.autograd.Function``;
where no graph of a derivative is being built (``create_graph=False``),
the backward launches the kernel itself, without another Function. On a
CPU tensor the op is :func:`fused_leaky_relu_ref` and autograd runs
through it.

**At exactly 0 the derivative is 1**, as ``jax.nn.leaky_relu``
(``where(x >= 0, x, slope * x)``) has it; ``F.leaky_relu``'s backward
gives the slope there. So the plain version is written with
``torch.where`` and the kernel tests ``out >= 0``.

Layout: the channel axis is axis 1 (``(N, C, H, W)`` or ``(N, C)``; the
JAX op takes channels last). The kernels read flat memory, ``(outer, C,
inner)``, for an NCHW-contiguous tensor (``inner = H * W``), a
channels-last one and a 2-D one (``inner = 1``) alike; any other memory
layout is made contiguous once, by the wrapper. The output has the
input's layout.
"""
import ctypes

import torch

from ._build import Kernel, launch

_TAIL = [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]  # slope ... stream
fused_leaky_relu_fwd_kernel = Kernel(
    'fused_act', 'fused_leaky_relu_fwd_launch',
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    + _TAIL)
# One kernel behind two entry points, which only count apart: the backward,
# and the backward's backward (a third or higher order counts with it).
fused_leaky_relu_bwd_kernel, fused_leaky_relu_bwd2_kernel = (
    Kernel('fused_act', f'fused_leaky_relu_{order}_launch',
           [ctypes.c_void_p] * 6
           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
           + _TAIL)
    for order in ('bwd', 'bwd2'))
# how the backward kernel shares a channel's elements between blocks:
# about this many blocks in all, and no fewer elements (rows, where
# inner == 1) than this a block
SPLIT_BLOCKS = 1024
SPLIT_ELEMENTS = 4096
SPLIT_ROWS = 64


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


def splits(numel, inner, channels):
    """The backward kernel's blocks that share one channel's elements (for
    ``inner > 1``; one column block's rows for ``inner == 1``): enough
    for about :data:`SPLIT_BLOCKS` blocks in all, each of at least
    :data:`SPLIT_ELEMENTS` elements (:data:`SPLIT_ROWS` rows where
    ``inner == 1``). Where it is more than 1, grad_bias is the sum of the
    blocks' partials in split order, a second launch."""
    per_channel = numel // channels
    if inner > 1:
        want = -(-SPLIT_BLOCKS // channels)
        return max(1, min(want, per_channel // SPLIT_ELEMENTS, 65535))
    return max(1, min(SPLIT_BLOCKS, per_channel // SPLIT_ROWS))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bwd_cuda(a, b, out, inner, with_sum, slope, scale, order):
    """One call of the backward kernel: ``(res, sum)`` with ``res = (a +
    b[channel]) * scale * (out >= 0 ? 1 : slope)`` in ``out``'s layout
    (``a`` and ``b`` may be None: zero) and, where ``with_sum``, its sum
    over all but the channel axis (else None). ``order`` 1 counts with
    the backward's entry point, 2 and higher with the double backward's."""
    if a is not None:
        _check_cuda('fused_leaky_relu backward', a, out)
        a = _like_layout(a, out)
    if b is not None:
        b = b.contiguous()
    res = torch.empty_like(out)
    channels = out.shape[1]
    n_splits = splits(out.numel(), inner, channels)
    total = partial = None
    if with_sum:
        total = out.new_empty((channels,))
        if n_splits > 1:
            partial = out.new_empty((n_splits, channels))
    kernel = fused_leaky_relu_bwd_kernel if order == 1 \
        else fused_leaky_relu_bwd2_kernel
    launch(kernel, out.device, _ptr(a), _ptr(b), out.data_ptr(),
           res.data_ptr(), _ptr(partial), _ptr(total), out.numel(), inner,
           channels, n_splits, slope, scale)
    return res, total


class _FusedLeakyReLUBackward(torch.autograd.Function):
    """``(grad_x, grad_bias)`` from ``grad_out`` and the saved output (the
    backward, ``order`` 1; the backward of the double backward, 3, ...);
    grad_bias is None unless ``with_bias``. Its backward is
    :class:`_FusedLeakyReLUDoubleBackward`."""

    @staticmethod
    def forward(ctx, grad_out, out, with_bias, inner, negative_slope, scale,
                order):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(out)
        ctx.args = (inner, negative_slope, scale, order)
        return _bwd_cuda(grad_out, None, out, inner, with_bias,
                         negative_slope, scale, order)

    @staticmethod
    def backward(ctx, gg_x, gg_bias):
        # the output is piecewise constant in the saved `out`
        out, = ctx.saved_tensors
        inner, negative_slope, scale, order = ctx.args
        ggo = None
        if gg_x is not None or gg_bias is not None:
            ggo = _double_backward(gg_x, gg_bias, out, inner,
                                   negative_slope, scale, order + 1)
        return ggo, None, None, None, None, None, None


class _FusedLeakyReLUDoubleBackward(torch.autograd.Function):
    """``ggo = (gg_x + gg_bias[channel]) * scale * (out >= 0 ? 1 :
    slope)`` (either of ``gg_x``, ``gg_bias`` may be None), in one launch.
    Its backward is :class:`_FusedLeakyReLUBackward` again."""

    @staticmethod
    def forward(ctx, gg_x, gg_bias, out, inner, negative_slope, scale,
                order):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(out)
        ctx.args = (inner, negative_slope, scale, order)
        return _bwd_cuda(gg_x, gg_bias, out, inner, False, negative_slope,
                         scale, order)[0]

    @staticmethod
    def backward(ctx, grad):
        out, = ctx.saved_tensors
        inner, negative_slope, scale, order = ctx.args
        grad_x = grad_bias = None
        if grad is not None:
            grad_x, grad_bias = _backward(grad, out, ctx.needs_input_grad[1],
                                          inner, negative_slope, scale,
                                          order + 1)
        if not ctx.needs_input_grad[0]:       # gg_x was None
            grad_x = None
        return grad_x, grad_bias, None, None, None, None, None


def _backward(grad, out, with_bias, inner, negative_slope, scale, order):
    """``(grad_x, grad_bias)``: through :class:`_FusedLeakyReLUBackward`
    where a graph of it is being built, else one launch."""
    if torch.is_grad_enabled():
        return _FusedLeakyReLUBackward.apply(grad, out, with_bias, inner,
                                             negative_slope, scale, order)
    return _bwd_cuda(grad, None, out, inner, with_bias, negative_slope,
                     scale, order)


def _double_backward(gg_x, gg_bias, out, inner, negative_slope, scale,
                     order):
    """``ggo``: through :class:`_FusedLeakyReLUDoubleBackward` where a
    graph of it is being built, else one launch."""
    if torch.is_grad_enabled():
        return _FusedLeakyReLUDoubleBackward.apply(
            gg_x, gg_bias, out, inner, negative_slope, scale, order)
    return _bwd_cuda(gg_x, gg_bias, out, inner, False, negative_slope,
                     scale, order)[0]


class _FusedLeakyReLU(torch.autograd.Function):
    """The CUDA path."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        _check_cuda('fused_leaky_relu', x,
                    *(() if bias is None else (bias,)))
        x, inner = _memory_layout(x)
        out = torch.empty_like(x)
        launch(fused_leaky_relu_fwd_kernel, x.device, x.data_ptr(),
               None if bias is None else bias.contiguous().data_ptr(),
               out.data_ptr(), x.numel(), inner, x.shape[1], negative_slope,
               scale)
        ctx.save_for_backward(out)
        ctx.args = (inner, negative_slope, scale)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        out, = ctx.saved_tensors
        grad_x, grad_bias = _backward(grad_out, out, ctx.needs_input_grad[1],
                                      *ctx.args, 1)
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
