"""The port's patch matching (``mrefsr_tpu_torch.ops.correlation``)
against the JAX package's, on the CPU, where the port runs the plain
version of its CUDA kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.ops import correlation as jax_corr
from mrefsr_tpu_torch.ops import correlation


def _features(seed, h=9, w=8, c=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(h, w, c).astype(np.float32),
            rng.randn(h + 1, w - 1, c).astype(np.float32))


def _top2_gap(feat_in, feat_ref, is_norm):
    """Best minus second-best score per input patch, from the JAX unfold."""
    pin = np.asarray(jax_corr.sample_patches(jnp.asarray(feat_in)))
    pref = np.asarray(jax_corr.sample_patches(jnp.asarray(feat_ref)))
    if is_norm:
        pref = pref / (np.linalg.norm(pref, axis=1, keepdims=True) + 1e-5)
    top2 = np.sort(pin.astype(np.float64) @ pref.T.astype(np.float64),
                   axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize('is_norm', [True, False])
@pytest.mark.parametrize('norm_input', [True, False])
def test_feature_match_index_matches_jax(is_norm, norm_input):
    feat_in, feat_ref = _features(0)
    kw = dict(is_norm=is_norm, norm_input=norm_input, chunk=7)
    idx_j, val_j = jax_corr.feature_match_index(
        jnp.asarray(feat_in), jnp.asarray(feat_ref), **kw)
    idx, val = correlation.feature_match_index(
        torch.from_numpy(feat_in), torch.from_numpy(feat_ref), **kw)
    assert idx.dtype == torch.int32 and idx.shape == (7, 6)
    gap = _top2_gap(feat_in, feat_ref, is_norm).reshape(7, 6)
    clear = gap > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[clear], np.asarray(idx_j)[clear])
    np.testing.assert_allclose(val.numpy(), np.asarray(val_j), rtol=1e-5,
                               atol=1e-6)


def test_batched_pairs_match_one_by_one():
    """Leading dims are pairs: each pair matches as on its own."""
    pairs = [_features(s) for s in (1, 2, 3)]
    fin = torch.from_numpy(np.stack([p[0] for p in pairs]))
    fref = torch.from_numpy(np.stack([p[1] for p in pairs]))
    idx, val = correlation.feature_match_index(fin, fref, chunk=5)
    for i, (a, b) in enumerate(pairs):
        idx1, val1 = correlation.feature_match_index(
            torch.from_numpy(a), torch.from_numpy(b), chunk=5)
        torch.testing.assert_close(idx[i], idx1, rtol=0, atol=0)
        torch.testing.assert_close(val[i], val1)


@pytest.mark.parametrize('chunk', [3, 2048])
def test_duplicated_ref_patch_lowest_index_wins(chunk):
    """Two equal ref patches, in different chunks or the same one: the
    lower index wins, as the JAX scan's argmax + strict '>' decide.
    Small integers keep every score exact, so the tie is exact."""
    rng = np.random.RandomState(4)
    feat_ref = rng.randint(-3, 4, size=(8, 8, 3)).astype(np.float32)
    feat_ref[5:, 5:] = feat_ref[:3, :3]     # patch 5*6+5 = 35 copies 0
    feat_ref[5:, 1:4] = feat_ref[:3, :3]    # patch 5*6+1 = 31 copies 0
    feat_in = feat_ref[:3, :3].copy()
    kw = dict(is_norm=False, chunk=chunk)
    idx, val = correlation.feature_match_index(
        torch.from_numpy(feat_in), torch.from_numpy(feat_ref), **kw)
    idx_j, val_j = jax_corr.feature_match_index(
        jnp.asarray(feat_in), jnp.asarray(feat_ref), **kw)
    best = float((feat_in ** 2).sum())
    assert float(val[0, 0]) == best == float(val_j[0, 0])
    assert int(idx[0, 0]) == 0 == int(idx_j[0, 0])


def test_sample_patches_matches_jax():
    feat, _ = _features(5)
    for stride in (1, 2):
        ours = correlation.sample_patches(torch.from_numpy(feat),
                                          stride=stride)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(
            jax_corr.sample_patches(jnp.asarray(feat), stride=stride)))


def test_index_to_flow_exact():
    rng = np.random.RandomState(6)
    idx = rng.randint(0, 5 * 7, size=(5, 7)).astype(np.int32)
    ours = correlation.index_to_flow(torch.from_numpy(idx))
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jax_corr.index_to_flow(jnp.asarray(idx))))
    batched = correlation.index_to_flow(torch.from_numpy(np.stack([idx,
                                                                   idx])))
    np.testing.assert_array_equal(batched[1].numpy(), ours.numpy())


@pytest.mark.parametrize('shift', [(0, 0), (1, 1), (2, 0), (0, 4), (3, 2)])
def test_tensor_shift_exact(shift):
    rng = np.random.RandomState(7)
    x = rng.randn(6, 5, 2).astype(np.float32)
    ours = correlation.tensor_shift(torch.from_numpy(x), shift, fill_val=-1.)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(
        jax_corr.tensor_shift(jnp.asarray(x), shift, fill_val=-1.)))


@pytest.mark.parametrize('input_stride', [1, 2])
@pytest.mark.parametrize('ref_stride', [1, 2])
def test_prologue_plain_matches_jax_unfold_and_norms(input_stride,
                                                     ref_stride):
    """The prologue's plain version (what the CUDA kernel of
    ``feature_match_prologue.cu`` is held to) against the JAX package's
    ``sample_patches`` and norms (correlation.py:20, :70-71, :101-103):
    the input patches exact, the normalised ref patches and the input
    norms within 1e-6, for 2 pairs of unequal maps."""
    rng = np.random.RandomState(8)
    fin = rng.randn(2, 9, 8, 4).astype(np.float32)
    fref = rng.randn(2, 10, 7, 4).astype(np.float32)
    pin, pref, norm = correlation._prologue_ref(
        torch.from_numpy(fin), torch.from_numpy(fref), 3, input_stride,
        ref_stride, True)
    for p in range(2):
        pin_j = jax_corr.sample_patches(jnp.asarray(fin[p]), 3, input_stride)
        pref_j = jax_corr.sample_patches(jnp.asarray(fref[p]), 3, ref_stride)
        pref_j = pref_j / (jnp.linalg.norm(pref_j, axis=1, keepdims=True)
                           + 1e-5)
        np.testing.assert_array_equal(pin[p].numpy(), np.asarray(pin_j))
        np.testing.assert_allclose(pref[p].numpy(), np.asarray(pref_j),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            norm[p].numpy(), np.asarray(jnp.linalg.norm(pin_j, axis=1)),
            rtol=1e-6, atol=0)
    raw = correlation._prologue_ref(torch.from_numpy(fin),
                                    torch.from_numpy(fref), 3, input_stride,
                                    ref_stride, False)[1]
    np.testing.assert_array_equal(raw[1].numpy(), np.asarray(
        jax_corr.sample_patches(jnp.asarray(fref[1]), 3, ref_stride)))


def _tf32(x):
    """``cvt.rna.tf32.f32``: round to nearest (ties away from zero) on the
    f32 bits, the low 13 bits cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32x3_scores(pin, pref):
    """The f32 kernel's arithmetic: each operand split into hi = tf32(x)
    and lo = tf32(x - hi), the products summed in f32 as lo*hi + hi*lo +
    hi*hi (``feature_match.cu``)."""
    ah, bh = _tf32(pin), _tf32(pref)
    al, bl = _tf32(pin - ah), _tf32(pref - bh)
    mm = lambda a, b: torch.matmul(torch.from_numpy(a),  # noqa: E731
                                   torch.from_numpy(b).transpose(1, 2))
    return mm(al, bh) + mm(ah, bl) + mm(ah, bh), mm(ah, bh)


def test_tf32x3_holds_k1_tolerances_at_the_eval_depth():
    """The 3xTF32 design of the f32 match kernel, emulated: at d = 2304
    (C 256) on unit-norm features, ``val`` within K1_VAL_TOL (1e-5) of the
    f32 product's, the index equal wherever the f32 scores' top-2 gap
    exceeds 1e-4; plain TF32 (hi*hi alone) is far less exact."""
    rng = np.random.RandomState(9)
    f = rng.randn(2, 2, 12, 12, 256).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    pin, pref, norm = correlation._prologue_ref(
        torch.from_numpy(f[0]), torch.from_numpy(f[1]), 3, 1, 1, True)
    assert pin.shape == (2, 100, 2304)
    exact = torch.matmul(pin, pref.transpose(1, 2))
    x3, tf32 = _tf32x3_scores(pin.numpy(), pref.numpy())
    denom = norm + 1e-5
    want = exact.max(2).values / denom
    err_x3 = float((x3.max(2).values / denom - want).abs().max())
    err_tf32 = float((tf32.max(2).values / denom - want).abs().max())
    assert err_x3 <= 1e-5
    assert err_tf32 > 10 * err_x3
    top2 = torch.topk(exact, 2, dim=2).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-4
    assert clear.float().mean() > 0.9
    np.testing.assert_array_equal(x3.argmax(2)[clear].numpy(),
                                  exact.argmax(2)[clear].numpy())


def _unfold(f, k, s):
    """The prologue's unfold, written out for the stand-in: (P, H, W, C) ->
    (P, n, k * k * C), element order (i, j, c)."""
    ph, pw = (f.shape[1] - k) // s + 1, (f.shape[2] - k) // s + 1
    taps = [f[:, i:i + (ph - 1) * s + 1:s, j:j + (pw - 1) * s + 1:s]
            for i in range(k) for j in range(k)]
    return torch.stack(taps, 3).reshape(f.shape[0], ph * pw, -1)


def _stand_in_match_kernels(monkeypatch):
    """PyTorch stand-ins for the C entry points of ``csrc/
    feature_match_prologue.cu``, ``feature_match.cu`` and
    ``feature_match_bf16.cu`` with their contracts: pointers in, shapes as
    ints; the prologue writes the padded patch matrices (zeros past d) and
    the input norms, rounding at bf16 as ``l2_norm`` / ``add_scalar`` do;
    the match reads rows ld apart (at f32 with a scratch for the hi and lo
    planes) and writes the lowest index of each maximum and its f32
    score. Returns the entry points launched, in
    order; ``sample_patches``, ``l2_norm`` and ``add_scalar`` raise."""
    launched, tensors = [], {}
    real_data_ptr = torch.Tensor.data_ptr

    def data_ptr(t):
        ptr = real_data_ptr(t)
        tensors[ptr] = t
        return ptr

    def prologue(fin, fref, pairs, h_in, w_in, h_ref, w_ref, c, k, si, sr,
                 is_norm, ld, eps, pin, pref, norm, _stream):
        fin = tensors[fin].reshape(pairs, h_in, w_in, c)
        fref = tensors[fref].reshape(pairs, h_ref, w_ref, c)
        dtype = fin.dtype

        def norms(x):
            sq = x.float().square().sum(-1).to(dtype)
            return sq.float().sqrt().to(dtype).float()

        a, b = _unfold(fin, k, si), _unfold(fref, k, sr)
        if is_norm:
            denom = (norms(b) + eps).to(dtype).float()[..., None]
            b = (b.float() / denom).to(dtype)
        d = a.shape[2]
        for ptr, value in ((pin, a), (pref, b)):
            out = tensors[ptr].view(pairs, -1, ld)
            out[..., :d] = value
            out[..., d:] = 0
        tensors[norm].view(pairs, -1).copy_(norms(a).to(dtype))

    def match(pin, pref, pairs, n_in, n_ref, d, ld, *rest):
        if len(rest) == 4:      # f32: the scratch of the hi / lo planes
            scratch, *rest = rest
            assert tensors[scratch].dtype == torch.float32
            assert tensors[scratch].numel() == 2 * pairs * (n_in + n_ref) * ld
        idx, val, _stream = rest
        a = torch.as_strided(tensors[pin], (pairs, n_in, d),
                             (n_in * ld, ld, 1)).double()
        b = torch.as_strided(tensors[pref], (pairs, n_ref, d),
                             (n_ref * ld, ld, 1)).double()
        scores = torch.matmul(a, b.transpose(1, 2))
        best = scores.max(2, keepdim=True).values
        cols = torch.arange(n_ref).expand_as(scores)
        lowest = torch.where(scores == best, cols, n_ref).min(2).values
        tensors[idx].view(pairs, n_in).copy_(lowest)
        tensors[val].view(pairs, n_in).copy_(best[..., 0])

    def entry(kernel, fn):
        def launch(*args):
            launched.append(kernel.symbol)
            fn(*args)
            return 0
        monkeypatch.setattr(kernel, '_fn', launch)

    class _NoDevice:
        def __init__(self, *_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

    class _Stream:
        cuda_stream = 0

    def refuse(*_, **__):
        raise AssertionError('the CUDA path ran a plain unfold or norm')

    monkeypatch.setattr(torch.Tensor, 'data_ptr', data_ptr)
    monkeypatch.setattr(torch.cuda, 'device', _NoDevice)
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda: _Stream)
    for name in ('sample_patches', 'l2_norm', 'add_scalar'):
        monkeypatch.setattr(correlation, name, refuse)
    for kernel in correlation._PROLOGUES.values():
        entry(kernel, prologue)
    for pair in correlation._KERNELS.values():
        for kernel in pair:
            entry(kernel, match)
    return launched


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('sharded', [False, True])
def test_cuda_path_launches_the_prologue_then_the_match(monkeypatch, dtype,
                                                        sharded):
    """K1 and K6 on the CUDA path, with PyTorch stand-ins for the C entry
    points: one launch of the prologue of the features' dtype, then one of
    the match (K6's own entry point when sharded), per call, with no plain
    unfold or norm between them; the answer the plain path's (K6 here on
    one rank: its two all-reduces are the identity)."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(10)
    fin = torch.from_numpy(rng.randn(2, 9, 8, 4).astype(np.float32)).to(dt)
    fref = torch.from_numpy(rng.randn(2, 10, 7, 4).astype(np.float32)).to(dt)
    want_idx, want_val = correlation.feature_match_index(fin, fref,
                                                         norm_input=True)
    launched = _stand_in_match_kernels(monkeypatch)
    match = (correlation._match_patches_sharded_cuda if sharded
             else correlation._match_patches_cuda)
    kernel = correlation._KERNELS[dt][sharded]
    prologue = correlation._PROLOGUES[dt]
    before = (prologue.launches, kernel.launches)
    if sharded:
        monkeypatch.setattr(correlation.dist, 'all_reduce',
                            lambda *_, **__: None)
        idx, val = correlation._feature_match_sharded(
            fin, (fref, 0), None, 3, 1, 1, True, True, 2048,
            correlation._prologue_cuda, match)
    else:
        idx, val = correlation._feature_match(
            fin, fref, 3, 1, 1, True, True, 2048,
            correlation._prologue_cuda, match)
    assert launched == [prologue.symbol, kernel.symbol]
    assert (prologue.launches, kernel.launches) == (before[0] + 1,
                                                    before[1] + 1)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(val, want_val, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_match_wrapper_takes_only_the_prologue_layout(dtype):
    """The match wrappers take patch rows padded to a multiple of 8
    elements, as the prologue writes them, and raise before any launch on
    another layout: a contiguous d = 9 matrix, and a ref matrix whose row
    stride is not the input's."""
    dt = getattr(torch, dtype)
    kernel = correlation._KERNELS[dt][False]
    before = kernel.launches
    padded_in = torch.zeros((2, 4, 16), dtype=dt)[..., :9]
    padded_ref = torch.zeros((2, 5, 16), dtype=dt)[..., :9]
    for pin, pref in ((torch.zeros((2, 4, 9), dtype=dt), padded_ref),
                      (padded_in, torch.zeros((2, 5, 9), dtype=dt)),
                      (padded_in, torch.zeros((2, 5, 24), dtype=dt)[..., :9])):
        with pytest.raises(ValueError, match='layout the prologue writes'):
            correlation._match_patches_cuda(pin, pref)
    assert correlation._row_stride(padded_in) == 16
    assert correlation._row_stride(padded_ref, 16) == 16
    assert kernel.launches == before
