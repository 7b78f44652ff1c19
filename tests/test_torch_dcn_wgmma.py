"""The wgmma walk of K2's forward, dgrad and wgrad (``csrc/mdcn_wgmma.cuh``)
on the CPU: its f32 arithmetic (3xTF32; at wgrad with the tensor cores'
truncating sums and the span of fresh accumulators) emulated in numpy
against JAX's f32 ``modulated_deform_conv2d`` and its vjp, the plain
version of the weight's TF32 split (``mdcn_fused_split``) bit for bit, and
the producers' swizzled stores and the wgmma descriptors' address maps
against the canonical 128-byte swizzle that TMA writes and wgmma reads. No
kernel runs here: the kernels themselves are held to their plain versions
on the card by ``chip_smoke.py``."""
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


# ------------------------------------------------------------------ wgrad

WGRAD_SPAN = 4   # mdcn_wgmma.cuh's WGRAD_SPAN
SLAB = 64 * 128  # a 64-row tile of 128-byte rows


def _header():
    return (_build.CSRC / 'mdcn_wgmma.cuh').read_text()


def _trunc_f32(x):
    """float64 -> float32 rounded toward zero: the tensor cores' f32 sum."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def _wgrad_walk(col, go, span):
    """The f32 wgrad's sums for one slice as the walk takes them:
    ``col`` (rows, channels) and ``go`` (rows, Cout), rows in patch order,
    64 a patch. A = go^T and B = the columns, each split into TF32 hi and lo
    (the tensor cores reading lo's top 19 bits); for each 8-deep k step of
    each patch the products lo*hi, hi*lo, hi*hi in turn, each group of 8
    summed exactly and added to the fresh f32 sums rounded toward zero; the
    fresh sums start at zero every ``span`` patches and are then added to
    the running sums rounded to nearest. Returns (channels, Cout) f32."""
    a_hi = _tf32_rna(go)
    a_lo = _tf32_trunc(go - a_hi)
    b_hi = _tf32_rna(col)
    b_lo = _tf32_trunc(col - b_hi)
    terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
    patches = col.shape[0] // 64
    run = np.zeros((col.shape[1], go.shape[1]), np.float32)
    fresh = np.zeros_like(run)
    for p in range(patches):
        if p % span == 0:
            fresh[:] = 0
        for kk in range(8):
            idx = slice(64 * p + 8 * kk, 64 * p + 8 * kk + 8)
            for a, b in terms:
                part = b[idx].astype(np.float64).T @ a[idx].astype(
                    np.float64)
                fresh = _trunc_f32(fresh.astype(np.float64) + part)
        if (p + 1) % span == 0 or p + 1 == patches:
            run = (run + fresh).astype(np.float32)
    return run


def test_wgrad_span_is_the_headers():
    assert re.search(rf'constexpr int WGRAD_SPAN = {WGRAD_SPAN};', _header())


@pytest.mark.parametrize('c', [64, 128, 256])
def test_wgrad_walk_holds_k2_tolerance(c):
    """The f32 wgrad's arithmetic, emulated over one slice as long as the
    stage-3 training shape's at this width (``dcn._wgrad_slices``: 273, 137
    and 150 patches at C 64, 128 and 256; here one 8 x 8 item a patch), dg
    8: grad weight (one tap, 16 Cout) and grad bias (the rows summed in
    order, rounded to nearest) within K2_REL_TOL of JAX's f32 vjp of
    ``modulated_deform_conv2d``. At the longest slice a walk without fresh
    accumulators (one span of the whole slice) falls outside it."""
    _, patches = dcn._wgrad_slices(30, 160 * 64 // c, 160 * 64 // c, 9, c,
                                   c, torch.float32)
    cout, dg, tap = 16, 8, 4
    rng = np.random.RandomState(c)
    x = rng.randn(patches, 8, 8, c).astype(np.float32)
    offset = (rng.randn(patches, 8, 8, dg, 9, 2) * 1.5).astype(np.float32)
    mask = rng.rand(patches, 8, 8, dg, 9).astype(np.float32)
    weight = (rng.randn(3, 3, c, cout) * 0.02).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    go = rng.randn(patches, 8, 8, cout).astype(np.float32)

    def conv(w, b):
        return jax_dcn.modulated_deform_conv2d(
            jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask), w, b,
            deform_groups=dg)

    _, vjp = jax.vjp(conv, jnp.asarray(weight), jnp.asarray(bias))
    want_w, want_b = (np.asarray(g) for g in vjp(jnp.asarray(go)))
    want_w = want_w.reshape(9, c, cout)[tap]
    rows = patches * 64
    geom = ((3, 3), (1, 1), (1, 1), (1, 1), (8, 8))
    col = dcn._im2col_ref(torch.from_numpy(x), torch.from_numpy(offset),
                          torch.from_numpy(mask), 0, rows, geom)
    col = col.reshape(rows, 9, c)[:, tap].numpy()
    go2d = go.reshape(rows, cout)
    scale = np.abs(want_w).max()
    err = np.abs(_wgrad_walk(col, go2d, WGRAD_SPAN) - want_w).max()
    assert err <= K2_REL_TOL * scale, err / scale
    got_b = np.cumsum(go2d, axis=0, dtype=np.float32)[-1]
    assert np.abs(got_b - want_b).max() <= K2_REL_TOL * np.abs(
        want_b).max()
    if c == 64:
        err_one = np.abs(_wgrad_walk(col, go2d, patches) - want_w).max()
        assert err_one > K2_REL_TOL * scale, err_one / scale


def _wpix(s):
    """mdcn_wgmma.cuh's ``wpix``: the pixel at K position s."""
    return (s & ~7) | ((s & 3) << 1) | ((s >> 2) & 1)


def _col_t_at(c, s):
    """mdcn_wgmma.cuh's ``col_t_at``: (channel row c, K position s) of a
    plane of the f32 transposed column tile."""
    return (s >> 5) * (32 * 128) + _producer_store(c, (s & 31) >> 2) \
        + 4 * (s & 3)


def _go_at(px, o, size):
    """mdcn_wgmma.cuh's ``go_at<T>``: (pixel px, Cout o) of the grad-out
    tile as TMA writes it, T of ``size`` bytes."""
    e, v = 128 // size, 16 // size
    return (o // e) * SLAB + _producer_store(px, (o % e) // v) \
        + (o % v) * size


def test_wgrad_f32_column_tile_is_the_canonical_k_major_swizzle():
    """The f32 producers' transposed stores: (channel c, K position s) goes
    where the canonical K-major 128-byte swizzle of a tile of 32 rows puts
    it, in two K atoms of 32 positions (the TF32 wgmma's B, 32 bytes of K a
    step), a bijection onto the plane's 2048 words; K position s holds the
    pixel the consumer's A fragments read there (k tig and tig + 4 of step
    kk: pixels 8 kk + 2 tig and + 1); and the header computes both maps as
    mirrored here."""
    seen = set()
    for c in range(32):
        for s in range(64):
            at = _col_t_at(c, s)
            assert at == (s // 32) * 32 * 128 + _canonical_sw128(
                c, (s % 32) // 4) + 4 * (s % 4)
            seen.add(at // 4)
    assert seen == set(range(2048))
    assert sorted(_wpix(s) for s in range(64)) == list(range(64))
    for kk in range(8):
        for tig in range(4):
            assert _wpix(8 * kk + tig) == 8 * kk + 2 * tig
            assert _wpix(8 * kk + tig + 4) == 8 * kk + 2 * tig + 1
    text = _header()
    assert re.search(r'return \(s & ~7\) \| \(\(s & 3\) << 1\) \| '
                     r'\(\(s >> 2\) & 1\);', text)
    assert re.search(r'return \(s >> 5\) \* \(32 \* ROW\) \+ '
                     r'sw128\(c, \(s & 31\) >> 2\) \+ 4 \* \(s & 3\);', text)
    assert re.search(r'return \(o / E\) \* SLAB \+ sw128\(px, \(o % E\) / '
                     r'V\) \+ \(o % V\) \* sizeof\(T\);', text)


@pytest.mark.parametrize('producers', [256, 512])
def test_wgrad_f32_shared_memory_meets_32_banks(producers):
    """Each of a producer warp's four stores of a step (8 runs of 4 K
    positions, each value rotated by (j / 2) % 4) meets 32 banks, one word
    each; each of the consumer's 8-byte A loads (Cout 2 gid, + 1 of pixel
    8 kk + 2 tig, or + 1) meets each bank twice: 256 bytes in the least
    two passes."""
    for warp in range(producers // 32):
        for q in range(64 * 8 // producers):
            for i in range(4):
                banks = []
                for lane in range(32):
                    tid, j = 32 * warp + lane, lane & 7
                    s = (tid >> 3) + producers // 8 * q
                    rot = (j >> 1) & 3
                    banks.append(_col_t_at(4 * j + ((i + rot) & 3), s) // 4
                                 % 32)
                assert sorted(banks) == list(range(32))
    for cw in range(4):
        for mt in range(4):
            for kk in range(8):
                for pair in range(2):
                    words = []
                    for lane in range(32):
                        gid, tig = lane >> 2, lane & 3
                        at = _go_at(8 * kk + 2 * tig + pair,
                                    64 * mt + 16 * cw + 2 * gid, 4)
                        assert at % 8 == 0
                        words += [at // 4, at // 4 + 1]
                    counts = np.bincount([w % 32 for w in words],
                                         minlength=32)
                    assert (counts == 2).all()


def _canonical_mn_sw128(start, lbo, sbo, mn, k):
    """The canonical MN-major layout of 16-bit elements with the 128-byte
    swizzle that a wgmma descriptor (start, LBO, SBO) reads with the
    transpose immediate: 8 elements a 16-byte chunk, 8 chunks (64 of M or
    N) a 128-byte row, atoms of 64 LBO bytes apart along M or N; K down the
    rows, 8 rows SBO bytes apart; then bits 4-6 XORed with bits 7-9 (the
    tile 1024-byte aligned)."""
    linear = start + (mn % 8) * 2 + (mn % 64) // 8 * 16 + (mn // 64) * lbo \
        + (k % 8) * 128 + (k // 8) * sbo
    return linear ^ (((linear >> 7) & 7) << 4)


def test_wgrad_bf16_descriptors_read_the_stored_tiles():
    """bf16 wgrad's operands, both MN-major: A = the column tile (M the
    chunk's 64 channels, K the pixels) as the producers store it (pixel r,
    channel 8 j + e at sw128(r, j) + 2 e), and B = the grad-out tile (N
    Cout, K the pixels) as TMA writes it (slabs of 64 Cout, 8 KB apart),
    each read by wgmma k step kk (16 pixels) through a descriptor at + kk *
    2048 with SBO 1024 and LBO one slab: every element where the descriptor
    reads it; and the header builds the descriptor and calls wgmma so."""
    for kk in range(4):
        for k in range(16):
            r = 16 * kk + k
            for m in range(64):
                at = _producer_store(r, m // 8) + 2 * (m % 8)
                assert at == _canonical_mn_sw128(2048 * kk, SLAB, 1024, m, k)
            for o in range(256):
                assert _go_at(r, o, 2) == _canonical_mn_sw128(
                    2048 * kk, SLAB, 1024, o, k)
    text = _header()
    assert re.search(r'\(\(uint64_t\)\(\(lbo >> 4\) & 0x3FFF\) << 16\) \|\s*'
                     r'\(\(uint64_t\)\(1024 >> 4\) << 32\) \| '
                     r'\(\(uint64_t\)1 << 62\);', text)
    assert re.search(r'bf16_ss<1>\(acc, desc_mn_sw128\(col \+ kk \* 2048, '
                     r'SLAB\),\s*desc_mn_sw128\(go \+ kk \* 2048, SLAB\),',
                     text)
    assert re.search(r'"%32, %33, p, 1, 1, %35, %35;', text)
