"""The port's bf16 convolutions and products on the CPU give one result
whatever instructions the CPU has (``ops/cpu_bf16.py``).

PyTorch hands a bf16 ``conv2d`` on the CPU to oneDNN, which takes the
bf16 operands as they are where the CPU has AVX512-BF16 or AMX and sums
them in another order than where it lacks them: VGG19's conv1_2 at the
bf16 training test's shapes rounded about one output in ten thousand to
another bf16 value, the first op of the step to differ, and the test's
update then missed JAX's by a tensor. ``ONEDNN_MAX_CPU_ISA`` caps the
instructions oneDNN may use; it is read when oneDNN starts, so each cap
runs in a process of its own.
"""
import os
import subprocess
import sys

import numpy as np
import torch

from mrefsr_tpu_torch.ops.cpu_bf16 import f32_products

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = torch.bfloat16

# VGG19's conv1_2 (64 -> 64 channels, 3 x 3) on the bf16 training test's
# 6 images of 32 x 32, forward and both gradients, inside f32_products;
# prints a digest of the bits
_CULPRIT = '''
import hashlib, numpy as np, torch
from mrefsr_tpu_torch.ops.cpu_bf16 import f32_products
torch.set_num_threads(2)
rng = np.random.RandomState(0)
bf = torch.bfloat16
x = torch.tensor(rng.rand(6, 64, 32, 32), dtype=torch.float32).to(bf)
w = torch.tensor(rng.randn(64, 64, 3, 3) * 0.05, dtype=torch.float32).to(bf)
b = torch.tensor(rng.randn(64) * 0.1, dtype=torch.float32).to(bf)
g = torch.tensor(rng.randn(6, 64, 32, 32), dtype=torch.float32).to(bf)
x.requires_grad_(); w.requires_grad_()
with f32_products('cpu'):
    y = torch.nn.functional.conv2d(x, w, b, padding=1)
    y.backward(g)
digest = hashlib.sha256()
for t in (y, x.grad, w.grad):
    assert t.dtype == bf
    digest.update(t.detach().view(torch.int16).numpy().tobytes())
print(digest.hexdigest())
'''

# oneDNN's caps: every instruction the CPU has, and none past AVX512-VNNI
# (no AVX512-BF16, no AMX)
ISA_CAPS = (None, 'AVX512_CORE_VNNI')


def _digest(cap):
    env = {k: v for k, v in os.environ.items()
           if k not in ('ONEDNN_MAX_CPU_ISA', 'DNNL_MAX_CPU_ISA')}
    if cap:
        env['ONEDNN_MAX_CPU_ISA'] = env['DNNL_MAX_CPU_ISA'] = cap
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    run = subprocess.run([sys.executable, '-c', _CULPRIT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    return run.stdout.strip()


def test_the_culprit_conv_gives_the_same_bits_under_every_isa_cap():
    """The bf16 conv that oneDNN's ISA changed, forward and both
    gradients, bit for bit the same with every instruction the CPU has
    and with oneDNN capped below its bf16 ones."""
    digests = {cap: _digest(cap) for cap in ISA_CAPS}
    assert len(set(digests.values())) == 1, digests


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(2, 16, 9, 9), dtype=torch.float32).to(BF)
    w = torch.tensor(rng.randn(8, 16, 3, 3) * 0.2, dtype=torch.float32)
    a = torch.tensor(rng.randn(12, 144), dtype=torch.float32).to(BF)
    return x, w.to(BF), a


def test_products_run_in_f32_and_round_once():
    """Inside ``f32_products`` a bf16 conv2d (with a bias or without) and
    mm on the CPU give the f32 result on the widened operands rounded to
    bf16 once, bit for bit, and a bf16 result; gradients come through the
    widening in bf16; f32 operands are left alone."""
    x, w, a = _inputs()
    m = w.reshape(8, 144).t().contiguous()
    bias = torch.linspace(-1, 1, 8).to(BF)
    want_conv = torch.nn.functional.conv2d(x.float(), w.float(),
                                           padding=1).to(BF)
    want_biased = torch.nn.functional.conv2d(x.float(), w.float(),
                                             bias.float()).to(BF)
    want_mm = (a.float() @ m.float()).to(BF)
    with f32_products('cpu'):
        got_conv = torch.nn.functional.conv2d(x, w, padding=1)
        got_biased = torch.nn.functional.conv2d(x, w, bias)
        got_mm = torch.mm(a, m)
        wr = w.clone().requires_grad_()
        torch.nn.functional.conv2d(x, wr, padding=1).sum().backward()
        f32 = torch.mm(a.float(), m.float())
    assert got_conv.dtype == BF and torch.equal(got_conv, want_conv)
    assert torch.equal(got_biased, want_biased)
    assert got_mm.dtype == BF and torch.equal(got_mm, want_mm)
    assert wr.grad.dtype == BF
    assert f32.dtype == torch.float32


def test_other_devices_are_left_alone():
    """For a device other than the CPU the context does nothing, so the
    card's bf16 path runs cuDNN and cuBLAS as it did."""
    x, w, _ = _inputs()
    with f32_products('meta'):
        y = torch.nn.functional.conv2d(x.to('meta'), w.to('meta'))
    assert y.dtype == BF and y.device.type == 'meta'
    with f32_products(torch.device('cuda', 0)) as mode:
        assert mode is None
