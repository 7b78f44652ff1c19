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
