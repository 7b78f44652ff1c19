"""bf16 convolutions and matrix products on the CPU, computed in f32 and
rounded to bf16 once, so that the port's plain bf16 path gives one result
on every CPU.

PyTorch hands a bf16 ``conv2d`` or ``mm`` on the CPU to oneDNN, whose
kernel depends on the instructions the CPU has: with AVX512-BF16 or AMX it
takes the bf16 operands as they are and sums them in another order than
where it lacks them, and about one output in ten thousand then rounds to
another bf16 value (VGG19's conv1_2 at 6 x 64 x 32 x 32, the first op of
the bf16 training step to differ). Through ReLU gates and Adam's first
steps that moved a whole tensor of the training test's update off the
JAX package's. XLA, the JAX package's CPU backend, computes a bf16
convolution or dot in f32 and rounds the result once; so does
:func:`f32_products`: inside it, each of these ops with a bf16 operand on
the CPU widens its bf16 operands to f32 (exact), runs in f32, where oneDNN
takes the same kernel whatever bf16 instructions the CPU has, and rounds
the result to bf16 once. Autograd records the widening, so the gradients
are f32 products rounded once as well. CUDA tensors are left alone: the
card's kernels, cuDNN and cuBLAS (bf16 sums in f32) do not change.
"""
import contextlib

import torch
from torch.overrides import TorchFunctionMode

# the products the bf16 path runs on the CPU: the nets' convolutions, the
# plain DCN's contraction (K1's plain match widens to f32 itself)
_PRODUCTS = frozenset({torch.conv2d, torch.mm})


def _cpu_bf16(a):
    return (isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
            and a.device.type == 'cpu')


def _widen(a):
    return a.float() if _cpu_bf16(a) else a


class _F32Products(TorchFunctionMode):

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS and any(
                _cpu_bf16(a) for a in (*args, *kwargs.values())):
            out = func(*map(_widen, args),
                       **{k: _widen(v) for k, v in kwargs.items()})
            return out.to(torch.bfloat16)
        return func(*args, **kwargs)


def f32_products(device):
    """A context in which a convolution or matrix product with a bf16 CPU
    operand runs in f32 on the widened operands and is rounded to bf16
    once; for a ``device`` other than the CPU none, so that the card's
    path pays nothing for it."""
    if torch.device(device).type != 'cpu':
        return contextlib.nullcontext()
    return _F32Products()
