"""K6, the patch match over a reference split by rows across ranks
(``feature_match_index_sharded``), against the JAX package's under
``shard_map``, on the CPU: the port's ranks are processes of
``tests/torch_dist_worker.py`` over gloo, started once per world size;
the JAX side runs in this process on a mesh of ``jax.devices()[:n]``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_worker as worker
from mrefsr_tpu.ops import feature_match_index as jax_match
from mrefsr_tpu.ops.correlation import \
    feature_match_index_sharded as jax_sharded
from mrefsr_tpu_torch.ops import correlation

WORLDS = (2, 4)
STRIDES = (1, 2)


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The test workers of one run share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(ref_stride):
    """The inputs of tests/test_ops/test_correlation_sharded.py: image rows
    of the ref that split evenly over 2, 4 or 8 ranks, plus the halo."""
    if ref_stride == 1:
        rng = np.random.RandomState(0)
        c, h, w, rows = 8, 18, 16, 16
    else:
        rng = np.random.RandomState(1)
        c, h, w, rows = 4, 12, 12, 32
    feat_in = rng.rand(h, w, c).astype(np.float32)
    feat_ref = rng.rand(rows + 2, w, c).astype(np.float32)
    return feat_in, feat_ref, rows


def _even_bands(rows, n, patch_size=3):
    hs = rows // n
    return [(d * hs, d * hs + hs + patch_size - 1) for d in range(n)]


def _tie_inputs(n):
    """Entries in {-1, 0, 1} (every score an exact integer) and a ref whose
    patch row 2 is a copy of patch row 12, which lies in a later band: an
    input patch that matches one matches both, in two ranks' bands."""
    rng = np.random.RandomState(2)
    feat_in = rng.randint(-1, 2, (18, 16, 2)).astype(np.float32)
    feat_ref = rng.randint(-1, 2, (18, 16, 2)).astype(np.float32)
    feat_ref[2:5] = feat_ref[12:15]
    feat_in[6:9, 3:6] = feat_ref[12:15, 7:10]
    return feat_in, feat_ref, _even_bands(16, n)


def _case(feat_in, feat_ref, bands, **kwargs):
    return {'feat_in': torch.from_numpy(feat_in),
            'feat_ref': torch.from_numpy(feat_ref), 'bands': bands,
            'kwargs': dict(kwargs, chunk=64)}


def _cases(n):
    cases = {}
    for stride in STRIDES:
        feat_in, feat_ref, rows = _inputs(stride)
        for norm_input in (True, False):
            cases[f's{stride}_norm{norm_input}'] = _case(
                feat_in, feat_ref, _even_bands(rows, n), ref_stride=stride,
                norm_input=norm_input)
    cases['tie'] = _case(*_tie_inputs(n), is_norm=False)
    if n == 2:   # 7 and 13 image rows: 5 and 11 patch rows
        feat_in, feat_ref, _ = _inputs(1)
        cases['uneven'] = _case(feat_in, feat_ref, [(0, 7), (5, 18)])
    return cases


@pytest.fixture(scope='module')
def reports(tmp_path_factory):
    """Every case on 2 and on 4 ranks: ``{n: [report of rank 0, ...]}``."""
    out = {}
    for n in WORLDS:
        out[n] = worker.spawn('sharded_match', {'cases': _cases(n)},
                              tmp_path_factory.mktemp(f'world{n}'), n)
    return out


def _jax_sharded(feat_in, feat_ref, bands, **kwargs):
    """The JAX package's K6 under shard_map on ``len(bands)`` devices; the
    answer every device holds, which must agree."""
    n = len(bands)
    mesh = Mesh(np.array(jax.devices()[:n]), ('sp',))
    shards = np.stack([feat_ref[a:b] for a, b in bands])
    offsets = np.asarray([a for a, _ in bands], np.int32)

    def fn(fi, shard, off):
        gi, gv = jax_sharded(fi, (shard[0], off[0]), 'sp', patch_size=3,
                             chunk=64, **kwargs)
        return gi[None], gv[None]

    gi, gv = shard_map(fn, mesh=mesh, in_specs=(P(), P('sp'), P('sp')),
                       out_specs=(P('sp'), P('sp')), check_rep=False)(
        jnp.asarray(feat_in), jnp.asarray(shards), jnp.asarray(offsets))
    gi, gv = np.asarray(gi), np.asarray(gv)
    for d in range(1, n):
        np.testing.assert_array_equal(gi[d], gi[0])
        np.testing.assert_array_equal(gv[d], gv[0])
    return gi[0], gv[0]


def _port_answers(ranks, name):
    """Every rank's ``(idx, val)`` of both versions; all must be equal."""
    first = ranks[0][name]['kernel']
    for report in ranks:
        for version in ('kernel', 'plain'):
            idx, val = report[name][version]
            torch.testing.assert_close(idx, first[0], rtol=0, atol=0)
            torch.testing.assert_close(val, first[1], rtol=0, atol=0)
    return first[0].numpy(), first[1].numpy()


@pytest.mark.parametrize('norm_input', [True, False])
@pytest.mark.parametrize('ref_stride', STRIDES)
@pytest.mark.parametrize('n', WORLDS)
def test_sharded_match_matches_jax(reports, n, ref_stride, norm_input):
    """Every rank holds the JAX package's answer: the index exactly, the
    value within rtol 1e-5; and the unsharded match's."""
    name = f's{ref_stride}_norm{norm_input}'
    case = _cases(n)[name]
    feat_in, feat_ref = case['feat_in'].numpy(), case['feat_ref'].numpy()
    kw = dict(ref_stride=ref_stride, norm_input=norm_input)
    idx, val = _port_answers(reports[n], name)
    want_idx, want_val = _jax_sharded(feat_in, feat_ref, case['bands'], **kw)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(val, want_val, rtol=1e-5)
    whole_idx, whole_val = jax_match(jnp.asarray(feat_in),
                                     jnp.asarray(feat_ref), patch_size=3,
                                     chunk=64, **kw)
    np.testing.assert_array_equal(idx, np.asarray(whole_idx))
    np.testing.assert_allclose(val, np.asarray(whole_val), rtol=1e-5)


def _lowest_best(feat_in, feat_ref):
    """Brute force: for each input patch the lowest ref patch index among
    the best scores, and how many bests lie in more than one band."""
    pin = correlation.sample_patches(torch.from_numpy(feat_in)).numpy()
    pref = correlation.sample_patches(torch.from_numpy(feat_ref)).numpy()
    scores = pin @ pref.T
    return scores.argmax(1), scores == scores.max(1, keepdims=True)


@pytest.mark.parametrize('n', WORLDS)
def test_ties_across_bands_go_to_the_lowest_index(reports, n):
    """Ties planted across a band boundary: both packages give the lowest
    global patch index, as the unsharded match does."""
    feat_in, feat_ref, bands = _tie_inputs(n)
    lowest, best = _lowest_best(feat_in, feat_ref)
    pw = feat_ref.shape[1] - 2
    patch_rows = np.arange(best.shape[1]) // pw
    band_of = np.searchsorted([a for a, _ in bands[1:]], patch_rows,
                              side='right')
    spans = [len(set(band_of[row])) for row in best]
    assert max(spans) > 1, 'no tie spans two bands'
    idx, _ = _port_answers(reports[n], 'tie')
    want_idx, _ = _jax_sharded(feat_in, feat_ref, bands, is_norm=False)
    np.testing.assert_array_equal(want_idx.ravel(), lowest)
    np.testing.assert_array_equal(idx.ravel(), lowest)


def test_uneven_bands_match_the_unsharded_match(reports):
    """Bands of 5 and 11 patch rows (the JAX package takes equal ones
    only): the port's unsharded plain match, index and value."""
    case = _cases(2)['uneven']
    idx, val = _port_answers(reports[2], 'uneven')
    want_idx, want_val = correlation.feature_match_index(
        case['feat_in'], case['feat_ref'], chunk=64)
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_allclose(val, want_val.numpy(), rtol=1e-6)


@pytest.mark.parametrize('n', WORLDS)
def test_cpu_ranks_launch_no_kernel(reports, n):
    assert [r['kernel_launches'] for r in reports[n]] == [0] * n


def test_band_offset_must_lie_on_the_stride_grid():
    feat = torch.zeros((8, 8, 2))
    with pytest.raises(ValueError, match='multiple of ref_stride'):
        correlation.feature_match_index_sharded(feat, (feat, 3),
                                                ref_stride=2)


def test_sharded_match_refuses_other_devices():
    feat = torch.empty((8, 8, 2), device='meta')
    with pytest.raises(RuntimeError, match='cuda or cpu'):
        correlation.feature_match_index_sharded(feat, (feat, 0))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('ref_stride', STRIDES)
def test_band_prologue_is_the_whole_refs_rows(dtype, ref_stride):
    """K6 runs K1's prologue on each rank's band: the band's normalised
    ref patches are, bit for bit, the whole ref's patch rows from the
    band's first patch row on (a patch lies whole in one band, and its norm
    is its own), for every band of 2 and 4 ranks."""
    dt = getattr(torch, dtype)
    feat_in, feat_ref, rows = _inputs(ref_stride)
    fin = torch.from_numpy(feat_in).to(dt)
    fref = torch.from_numpy(feat_ref).to(dt)
    _, whole, _ = correlation._prologue_ref(fin, fref, 3, 1, ref_stride,
                                            True)
    pw = (feat_ref.shape[1] - 3) // ref_stride + 1
    for n in WORLDS:
        for start, stop in _even_bands(rows, n):
            _, band, _ = correlation._prologue_ref(
                fin, fref[start:stop], 3, 1, ref_stride, True)
            first = start // ref_stride * pw
            torch.testing.assert_close(
                band, whole[:, first:first + band.shape[1]], rtol=0, atol=0)
