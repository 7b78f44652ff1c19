"""upfirdn2d: upsample, pad, FIR filter, downsample, per channel, with its
gradient to any order.

Port of ``mrefsr_tpu/ops/upfirdn2d.py``. On a CUDA tensor the op is a
kernel of ``csrc/upfirdn2d.cu``, wrapped in a ``torch.autograd.Function``
whose backward is the same Function with ``up`` and ``down`` swapped, the
FIR flipped and the pads of :func:`_transposed`: so the backward, the double
backward (R1, the path-length penalty) and any higher order launch the
kernel too. :func:`route` says which kernel: the tile kernel (strips of
outputs a thread, from a window staged in shared memory or read through
L1, :func:`tile_geometry`) for the 4x4 FIR with ``(up, down)`` = (1, 1),
(2, 1) or (1, 2), which is every StyleGAN2 call and its transposes, else
the gather kernel. On a CPU tensor the op is :func:`upfirdn2d_ref` and
autograd runs through it.

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
import math

import torch
from torch.nn import functional as F

from ._build import Kernel, launch

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 \
    + [ctypes.c_void_p] * 2
# One kernel behind three entry points, which only count apart: the op
# itself, its backward, and the backward's backward (a third or higher
# order counts with the double backward).
upfirdn2d_kernels = tuple(
    Kernel('upfirdn2d', f'upfirdn2d_{order}_launch', _ARGTYPES)
    for order in ('fwd', 'bwd', 'bwd2'))
upfirdn2d_fwd_kernel, upfirdn2d_bwd_kernel, upfirdn2d_bwd2_kernel = \
    upfirdn2d_kernels
MAX_TAPS = 64
# The tile kernel (csrc/upfirdn2d.cu), its constants chosen by timing
# the StyleGAN2 shapes on the H100 under other settings:
# the (up, down) it takes with a 4x4 FIR; the strip heights it is built
# for (outputs a thread computes down one column), a strip at most this
# share of the output's rows but at least TILE_MIN_STRIP, shortened while
# a call has fewer threads than TILE_MIN_THREADS; a block's threads,
# planes (its third dimension), output columns, floats of a window row
# and staged floats (32 KB) at most; the blocks a call should have, at
# least, where fewer strips or planes a block give them; and the calls
# (all their outputs) and planes (one plane's outputs) small enough to
# read x directly, through L1, rather than through a window staged in
# shared memory.
TILE_CASES = ((1, 1), (2, 1), (1, 2))
TILE_STRIPS = (1, 2, 4, 8, 16, 32)
TILE_STRIP_SHARE = 4
TILE_MIN_STRIP = 4
TILE_MIN_THREADS = 2 ** 16
TILE_THREADS = 256
TILE_MAX_PLANES = 64
TILE_MAX_COLS = 128
TILE_ROW_FLOATS = 128
TILE_MAX_WINDOW = 8192
TILE_MIN_BLOCKS = 264
TILE_DIRECT_OUTPUTS = 2 ** 20
TILE_DIRECT_PLANE = 129 * 129


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


def route(fir, up, down):
    """``'tile'`` where the tile kernel takes the case (the 4x4 FIR with
    ``(up, down)`` in :data:`TILE_CASES`), else ``'general'``: the gather
    kernel."""
    return 'tile' if tuple(fir.shape) == (4, 4) \
        and (up, down) in TILE_CASES else 'general'


def _cdiv(a, b):
    return -(-a // b)


def tile_window(up, down, th, tw):
    """Rows and columns of the input window of one plane that a tile of
    ``th`` output rows and ``tw`` columns reads: the tile's extent in x
    plus the 3-sample halo of the 4x4 FIR (halved for ``up`` 2, doubled
    for ``down`` 2). Its origin in x is ``(ceil((oy0 - pad_y0) / 2),
    ceil((ox0 - pad_x0) / 2))`` for ``up`` 2, else ``(oy0 * down -
    pad_y0, ox0 * down - pad_x0)``, for the tile's first output ``(oy0,
    ox0)``."""
    if up == 2:
        return th // 2 + 2, tw // 2 + 2
    return (th - 1) * down + 4, (tw - 1) * down + 4


def tile_geometry(planes, out_h, out_w, up, down):
    """The tile kernel's blocks for one call: ``(rows, tw, rg, pb, nx, ny,
    rows_in, cols_in)``. A thread computes ``rows`` outputs down one
    column (the tallest of :data:`TILE_STRIPS` within a
    :data:`TILE_STRIP_SHARE` of ``out_h``, or :data:`TILE_MIN_STRIP`;
    shorter while the call has fewer than :data:`TILE_MIN_THREADS`
    threads); a block ``tw`` columns by ``rg`` strips of each of ``pb``
    planes; ``nx`` by ``ny`` tiles cover a plane. Columns: at most
    :data:`TILE_MAX_COLS` and a window row of at most
    :data:`TILE_ROW_FLOATS`, balanced over the tiles across. Strips down:
    as many as fill :data:`TILE_THREADS` threads and keep the window
    within :data:`TILE_MAX_WINDOW` floats, balanced over the tiles down.
    Planes: as many as fill the threads where one plane leaves them idle,
    at most :data:`TILE_MAX_PLANES`. Fewer strips and planes where the
    call would have fewer than :data:`TILE_MIN_BLOCKS` blocks.
    ``rows_in`` by ``cols_in`` is one plane's window (:func:`tile_window`),
    or ``(0, 0)`` for a call of at most :data:`TILE_DIRECT_OUTPUTS`
    outputs or planes of at most :data:`TILE_DIRECT_PLANE`: the threads
    then read x directly, and no window bounds the block."""
    direct = planes * out_h * out_w <= TILE_DIRECT_OUTPUTS \
        or out_h * out_w <= TILE_DIRECT_PLANE
    rows = max(r for r in TILE_STRIPS
               if r <= TILE_MIN_STRIP or r * TILE_STRIP_SHARE <= out_h)
    while rows > TILE_STRIPS[0] \
            and planes * out_w * _cdiv(out_h, rows) < TILE_MIN_THREADS:
        rows = TILE_STRIPS[TILE_STRIPS.index(rows) - 1]
    max_cols = TILE_MAX_COLS
    while tile_window(up, down, rows, max_cols)[1] > TILE_ROW_FLOATS:
        max_cols -= 1
    nx = _cdiv(out_w, max_cols)
    tw = _cdiv(out_w, nx)

    def window(rg):
        return (0, 0) if direct else tile_window(up, down, rg * rows, tw)

    rg = max(1, min(TILE_THREADS // tw, _cdiv(out_h, rows)))
    while rg > 1 and math.prod(window(rg)) > TILE_MAX_WINDOW:
        rg -= 1
    while rg > 1 and planes * nx * _cdiv(out_h, rg * rows) \
            < TILE_MIN_BLOCKS:
        rg -= 1
    ny = _cdiv(out_h, rg * rows)
    rg = _cdiv(_cdiv(out_h, ny), rows)
    rows_in, cols_in = window(rg)
    pb = max(1, min(TILE_THREADS // (tw * rg), planes, TILE_MAX_PLANES,
                    TILE_MAX_WINDOW // max(1, rows_in * cols_in)))
    while pb > 1 and _cdiv(planes, pb) * nx * ny < TILE_MIN_BLOCKS:
        pb = _cdiv(pb, 2) if pb > 2 else 1
    return rows, tw, rg, pb, nx, ny, rows_in, cols_in


def _check_cuda(x):
    if not x.is_cuda or x.dtype != torch.float32:
        raise TypeError(f'the upfirdn2d kernel takes float32 CUDA tensors, '
                        f'got {x.dtype} on {x.device}')


def _upfirdn2d_cuda(x, fir, up, down, pads, order):
    """The CUDA kernel :func:`route` names, same contract as
    :func:`_upfirdn2d_plain`; ``order`` picks the entry point that counts
    the launch."""
    out_h, out_w = _check(x, fir, up, down, pads)
    if fir.numel() > MAX_TAPS:
        raise ValueError(f'the upfirdn2d kernel takes a FIR of at most '
                         f'{MAX_TAPS} taps, got {tuple(fir.shape)}')
    _check_cuda(x)
    n, c, h, w = x.shape
    if n * c * out_h * out_w >= 2 ** 39:      # 2^31 blocks of 256 threads
        raise ValueError(f'upfirdn2d kernel: {tuple(x.shape)} is too large')
    x = x.contiguous()
    taps = fir.detach().to('cpu', torch.float32).reshape(-1).tolist()
    fir_values = (ctypes.c_float * len(taps))(*taps)
    tile = None
    if route(fir, up, down) == 'tile':
        tile = (ctypes.c_int * 8)(*tile_geometry(n * c, out_h, out_w, up,
                                                 down))
    out = torch.empty((n, c, out_h, out_w), dtype=x.dtype, device=x.device)
    launch(upfirdn2d_kernels[min(order, 2)], x.device, x.data_ptr(),
           out.data_ptr(), fir_values, n * c, h, w, fir.shape[0],
           fir.shape[1], up, down, *pads, tile)
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
