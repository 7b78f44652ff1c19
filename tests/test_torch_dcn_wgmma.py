"""The wgmma walk of K2's forward and dgrad (``csrc/mdcn_wgmma.cuh``) on the
CPU: its f32 arithmetic (3xTF32) emulated in numpy against JAX's f32
``modulated_deform_conv2d``, the plain version of the weight's TF32 split
(``mdcn_fused_split``) bit for bit, and the producers' swizzled stores
against the canonical 128-byte swizzle that TMA writes and the wgmma
descriptors read. No kernel runs here: the kernels themselves are held to
their plain versions on the card by ``chip_smoke.py``."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.ops import dcn as jax_dcn
from mrefsr_tpu_torch.ops import _build, dcn

jax.config.update('jax_platforms', 'cpu')
torch.set_num_threads(2)

# chip_smoke.py's K2 tolerance: max |kernel - plain| / max |plain|
K2_REL_TOL = 1e-4
BK = 32          # f32 channels of a k step: one 128-byte swizzled row
K_GROUP = 8      # depth of one TF32 wgmma


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def _tf32_rna(x):
    """hi of the split: round to nearest, ties away from zero, on the f32
    bits (half of the dropped 13 bits added, then cleared)."""
    return ((_bits(x) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_trunc(x):
    """What the tensor cores read of a TF32 operand: its top 19 bits."""
    return (_bits(x) & np.uint32(0xFFFFE000)).view(np.float32)


def _walk_products(col, w, c, taps, x3=True):
    """The forward's sums as the walk takes them: for each chunk of BK
    channels, each tap, each 8-deep k group in turn (chunk-major), the
    group's products lo*hi + hi*lo + hi*hi (``x3``; else hi*hi alone,
    plain TF32), each group product summed exactly and added to the f32
    sums in that order. ``col`` (rows, taps * c), ``w`` (taps * c, cout)."""
    a_hi = _tf32_rna(col)
    a_lo = _tf32_trunc(col - a_hi)
    b_hi = _tf32_rna(w)
    b_lo = _tf32_trunc(w - b_hi)
    terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)) if x3 else \
        ((a_hi, b_hi),)
    acc = np.zeros((col.shape[0], w.shape[1]), np.float32)
    for c0 in range(0, c, BK):
        for k in range(taps):
            for g0 in range(c0, min(c0 + BK, c), K_GROUP):
                idx = k * c + np.arange(g0, g0 + K_GROUP)
                for a, b in terms:
                    part = a[:, idx].astype(np.float64) @ b[idx].astype(
                        np.float64)
                    acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


@pytest.mark.parametrize('c,cout,h,dg', [(256, 32, 6, 8), (64, 64, 8, 8)])
def test_tf32x3_holds_k2_tolerance(c, cout, h, dg):
    """The f32 forward's 3xTF32 arithmetic, emulated: at K = 9 * 256 = 2304
    (the deepest K2 forward) and at a small C 64 case, within K2_REL_TOL of
    JAX's f32 ``modulated_deform_conv2d``; plain TF32 (hi*hi alone) falls
    outside it. (The tensor cores' truncation of their own f32 sums is not
    emulated: chip_smoke.py measures the kernels against the plain version
    on the card.)"""
    rng = np.random.RandomState(c + h)
    x = rng.randn(1, h, h, c).astype(np.float32)
    offset = (rng.randn(1, h, h, dg, 9, 2) * 1.5).astype(np.float32)
    mask = rng.rand(1, h, h, dg, 9).astype(np.float32)
    weight = (rng.randn(3, 3, c, cout) * 0.02).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    want = np.asarray(jax_dcn.modulated_deform_conv2d(
        *(jnp.asarray(a) for a in (x, offset, mask, weight, bias)),
        deform_groups=dg)).reshape(-1, cout)
    geom = ((3, 3), (1, 1), (1, 1), (1, 1), (h, h))
    rows = h * h
    col = dcn._im2col_ref(torch.from_numpy(x), torch.from_numpy(offset),
                          torch.from_numpy(mask), 0, rows, geom)
    col = col.reshape(rows, 9 * c).numpy()
    w2d = weight.reshape(9 * c, cout)
    scale = np.abs(want).max()
    err_x3 = np.abs(_walk_products(col, w2d, c, 9) + bias - want).max()
    err_tf32 = np.abs(_walk_products(col, w2d, c, 9, x3=False) + bias
                      - want).max()
    assert err_x3 <= K2_REL_TOL * scale, err_x3 / scale
    assert err_tf32 > K2_REL_TOL * scale, err_tf32 / scale


def test_weight_split_plain_version_bit_for_bit():
    """``dcn._split_tf32_ref``, the plain version of ``mdcn_fused_split``,
    against the split written out in numpy, bit for bit, on normal, tiny,
    negative and exactly-halfway values: hi the f32 rounded to TF32 (ties
    away from zero), lo = w - hi, and hi + lo == w exactly."""
    rng = np.random.RandomState(5)
    w = np.concatenate([
        rng.randn(4096).astype(np.float32) * 0.05,
        rng.randn(512).astype(np.float32) * 1e-30,
        -np.abs(rng.randn(512).astype(np.float32)) * 300,
        # low 13 bits exactly half of the dropped part: ties away from 0
        ((rng.randint(1 << 10, 1 << 17, 256).astype(np.uint32) << 13)
         | np.uint32(0x1000)).view(np.float32),
        np.array([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -0.5],
                 np.float32)]).reshape(-1, 8)
    hi = _tf32_rna(w)
    lo = (w - hi).astype(np.float32)
    got = dcn._split_tf32_ref(torch.from_numpy(w))
    assert got.shape == (2, *w.shape) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(hi))
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(lo))
    assert (_bits(hi) & 0x1FFF == 0).all()
    np.testing.assert_array_equal(got[0].numpy() + got[1].numpy(), w)
    ties = w.reshape(-1)[5120:5376]
    np.testing.assert_array_equal(np.abs(_tf32_rna(ties)) > np.abs(ties),
                                  True)


def _producer_store(row, chunk):
    """The mirror of mdcn_wgmma.cuh's ``sw128(r, j)``: where a producer
    stores 16-byte chunk j of pixel row r of a 64-row stage."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _canonical_sw128(row, chunk):
    """The canonical K-major layout with the 128-byte swizzle (CUTLASS's
    Swizzle<3, 4, 3> on the byte offset of the row-major tile of 128-byte
    rows): bits 4-6 of the offset XORed with bits 7-9."""
    linear = row * 128 + chunk * 16
    return linear ^ (((linear >> 7) & 7) << 4)


def test_producer_stores_are_the_canonical_swizzle():
    """Every (row, 16-byte chunk) of a 64-row stage goes where the 128-byte
    swizzle puts it, one chunk each: a bijection onto the stage's 512
    16-byte slots; and the header computes the address as mirrored here."""
    seen = set()
    for row in range(64):
        for chunk in range(8):
            at = _producer_store(row, chunk)
            assert at == _canonical_sw128(row, chunk)
            assert at % 16 == 0 and 0 <= at < 64 * 128
            seen.add(at // 16)
    assert seen == set(range(512))
    text = (_build.CSRC / 'mdcn_wgmma.cuh').read_text()
    assert re.search(r'uint32_t sw128\(int r, int j\) \{\s*return r \* ROW '
                     r'\+ \(\(j \^ \(r & 7\)\) << 4\);', text)
    assert re.search(r'constexpr int ROW = 128;', text)
