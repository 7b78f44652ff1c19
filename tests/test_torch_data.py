"""The port's options, datasets, loader and prefetchers against the JAX
package's on the CPU (same YAMLs, same seeded images, same seeds), and the
three faults of the model and launcher that the data path exposed: uint8
batches, missing checkpoints and ``dist_params.port``."""
import os
import random
import threading
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_cli_data
from mrefsr_tpu.data import build_dataloader as jax_build_dataloader
from mrefsr_tpu.data import build_dataset as jax_build_dataset
from mrefsr_tpu.data.data_sampler import EnlargedSampler as JaxSampler
from mrefsr_tpu.data.transforms import augment as jax_augment
from mrefsr_tpu.utils.options import parse_options as jax_parse_options
from mrefsr_tpu_torch.data import (BackgroundDevicePrefetcher, CPUPrefetcher,
                                   CUDAPrefetcher, DataLoader,
                                   EnlargedSampler, build_dataloader,
                                   build_dataset, uint8_to_float32)
from mrefsr_tpu_torch.data.transforms import augment
from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.utils import dist_util
from mrefsr_tpu_torch.utils.options import parse_options

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted((REPO / 'options').rglob('*.yml'))


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores: more threads per process only get in each other's
    way."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _equal(a, b):
    """Two samples or batches: the same keys, arrays bit for bit."""
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            assert x == y, key


# ------------------------------------------------------------------ options
@pytest.mark.parametrize('path', YAMLS,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_parse_options_equals_the_jax_package(path, tmp_path):
    """Every YAML of the repository parses to the JAX package's dict, key by
    key (``--launcher none``; test YAMLs by their directory). The port's
    docstring lists what may differ; none of it shows on these files."""
    is_train = path.parent.name != 'test'
    want, _ = jax_parse_options(str(tmp_path), is_train,
                                ['-opt', str(path), '--launcher', 'none'])
    got, args = parse_options(str(tmp_path), is_train,
                              ['-opt', str(path), '--launcher', 'none',
                               '--device', 'cpu'])
    assert got == want
    assert args.device == 'cpu'


def test_force_yml_and_debug_equal_the_jax_package(tmp_path):
    """``--force_yml`` sets nested keys (made where missing) to None, ints,
    floats, lists and strings, and ``--debug`` renames the run and
    shortens its frequencies, as in the JAX package."""
    cli = ['-opt', str(REPO / 'options/train/stage3_5ref_restoration_mse.yml'),
           '--debug', '--force_yml', 'train:total_iter=60',
           'path:pretrain_network_feature_extractor=~',
           'datasets:train:gt_size=32', 'new:deep:key=1e-4',
           'train:beta_g=[0.5, 0.9]', 'datasets:val:dataroot_in=/x/y z',
           'dist_params:init_method=file:///tmp/rendezvous']
    want, _ = jax_parse_options(str(tmp_path), True, cli)
    got, _ = parse_options(str(tmp_path), True, cli + ['--device', 'cpu'])
    assert got == want
    assert got['train']['total_iter'] == 60
    assert got['path']['pretrain_network_feature_extractor'] is None
    assert got['new'] == {'deep': {'key': 1e-4}}
    assert got['train']['beta_g'] == [0.5, 0.9]
    assert got['datasets']['val']['dataroot_in'] == '/x/yz'
    assert got['dist_params']['init_method'] == 'file:///tmp/rendezvous'
    assert got['name'].startswith('debug_')
    assert got['logger']['print_freq'] == 1
    assert got['logger']['save_checkpoint_freq'] == 8
    assert got['val']['val_freq'] == 8


def test_parse_options_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        parse_options(str(tmp_path), True, ['-opt', str(YAMLS[0])])


# ----------------------------------------------------------------- datasets
@pytest.fixture(scope='module')
def lmr(tmp_path_factory):
    root = tmp_path_factory.mktemp('lmr')
    folder, ann = torch_cli_data.write_lmr(str(root), samples=6)
    return {'name': 'lmr', 'type': 'MultiRefMegaDepthDataset',
            'phase': 'train', 'scale': 4, 'gt_size': 32,
            'dataroot_in': folder, 'dataroot_ref': folder, 'ann_file': ann,
            'use_flip': True, 'use_rot': True, 'num_worker_per_gpu': 0,
            'batch_size_per_gpu': 2, 'dataset_enlarge_ratio': 2}


def test_annotations_equal_the_jax_package(lmr):
    """The CSV read with ``csv`` gives pandas' rows: paths (the scene's
    leading zeros kept) and match points."""
    got = build_dataset(lmr).samples
    want = jax_build_dataset(lmr).samples
    assert len(got) == len(want) == 6
    for (t, refs, p0, prefs), (jt, jrefs, jp0, jprefs) in zip(got, want):
        assert t == jt and refs == jrefs and '/0001/' in t
        np.testing.assert_array_equal(p0, jp0)
        for p, q in zip(prefs, jprefs):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize('output_dtype', [None, 'uint8'])
@pytest.mark.parametrize('cache', [0, 16])
def test_megadepth_samples_equal_the_jax_package(lmr, output_dtype, cache):
    """With the same seed (python's global generator there, the dataset's
    ``random.Random`` here) every sample is the JAX dataset's bit for bit:
    the crops, the shuffle of the refs, the flips and transposes, Pillow's
    bicubic down and up; float32 or uint8; the decode cache on or off
    (the second pass reads the cache)."""
    opt = dict(lmr, output_dtype=output_dtype, decode_cache_size=cache)
    ours = build_dataset(opt, seed=7)
    theirs = jax_build_dataset(opt)
    random.seed(7)
    for index in [0, 1, 2, 3, 4, 5, 0, 3]:
        want = theirs[index]
        _equal(ours[index], want)
    dtype = np.uint8 if output_dtype == 'uint8' else np.float32
    assert want['img_ref_list'].dtype == dtype
    assert want['img_ref_list'].shape == (5, 32, 32, 3)
    assert want['img_in_lq'].shape == (8, 8, 3)


def test_augment_draws_as_the_jax_package():
    """The same three draws in the same order, flows turned alike."""
    rng = np.random.RandomState(0)
    imgs = [rng.rand(6, 5, 3) for _ in range(2)]
    flows = [rng.rand(6, 5, 2).astype(np.float32)]
    for seed in range(8):
        random.seed(seed)
        want = jax_augment(list(imgs), True, True, [f.copy() for f in flows],
                           return_status=False)
        got = augment(list(imgs), True, True, [f.copy() for f in flows],
                      rng=random.Random(seed))
        for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
            np.testing.assert_array_equal(a, b)


def test_output_dtype_is_refused_by_name(lmr):
    with pytest.raises(ValueError, match='output_dtype'):
        build_dataset(dict(lmr, output_dtype='float16'))


@pytest.fixture(scope='module')
def cufed(tmp_path_factory):
    root = tmp_path_factory.mktemp('cufed')
    folder = torch_cli_data.write_cufed(str(root),
                                        sizes=((44, 60), (60, 44), (33, 47)))
    return {'name': 'cufed', 'type': 'MultiRefCUFEDSet', 'phase': 'val',
            'scale': 4, 'dataroot_in': folder, 'dataroot_ref': folder}


@pytest.mark.parametrize('pad_to', [None, [48, 64]])
def test_cufed_set_equals_the_jax_package(cufed, pad_to):
    """Every item bit for bit, ``padding`` / ``original_size`` / ``lq_path``
    included: the reference's 500 canvas, and per-dimension buckets (refs
    taller than the input cropped to its canvas)."""
    opt = dict(cufed) if pad_to is None else dict(cufed, pad_to=pad_to)
    ours, theirs = build_dataset(opt), jax_build_dataset(opt)
    assert len(ours) == len(theirs) == 3
    canvases = set()
    for i in range(3):
        got, want = ours[i], theirs[i]
        _equal(got, want)
        canvases.add(got['img_ref_list'].shape[1:3])
        assert got['img_in'].shape[:2] == got['original_size']
    assert canvases == ({(500, 500)} if pad_to is None
                        else {(48, 64), (64, 48), (48, 48)})


# ------------------------------------------------------------------- loader
class _Counting:
    """A dataset that draws nothing at random: sample ``i`` holds ``i``."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {'x': np.full((2, 3), i, np.float32), 'i': i, 'name': f'{i}'}


@pytest.mark.parametrize('workers', [1, 3])
def test_threaded_loader_gives_the_synchronous_batches(workers):
    def batches(num_workers):
        loader = DataLoader(_Counting(), batch_size=3, shuffle=True,
                            num_workers=num_workers, drop_last=True, seed=4)
        loader.set_epoch(2)
        return list(loader)

    sync = batches(0)
    assert len(sync) == 3 and [b['i'].tolist() for b in sync] != [
        [0, 1, 2], [3, 4, 5], [6, 7, 8]]
    for got, want in zip(batches(workers), sync):
        _equal(got, want)


def test_threaded_loader_raises_a_workers_exception():
    class Broken(_Counting):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError('sample 5')
            return super().__getitem__(i)

    with pytest.raises(KeyError, match='sample 5'):
        list(DataLoader(Broken(), batch_size=2, num_workers=2))


def test_train_loader_batches_equal_the_jax_package(lmr):
    """``build_dataloader`` with ``EnlargedSampler`` (2 ranks, rank 1, ratio
    2): the first batches of an epoch equal the JAX package's, with the
    same seed. ``batch_size_per_gpu`` is the loader's batch."""
    opt = dict(lmr, output_dtype='uint8')
    ours = build_dataset(opt, seed=3)
    loader = build_dataloader(ours, opt,
                              sampler=EnlargedSampler(ours, 2, 1, 2), seed=3)
    loader.set_epoch(1)
    theirs = jax_build_dataset(opt)
    jloader = jax_build_dataloader(theirs, opt,
                                   sampler=JaxSampler(theirs, 2, 1, 2),
                                   seed=3)
    jloader.set_epoch(1)
    random.seed(3)
    want = list(jloader)
    got = list(loader)
    assert loader.batch_size == 2 and len(got) == len(want) == 3
    for a, b in zip(got, want):
        _equal(a, b)


def test_val_loader_is_batch_one_in_order(cufed):
    loader = build_dataloader(build_dataset(cufed), cufed)
    assert loader.batch_size == 1 and loader.num_workers == 0
    names = [b['lq_path'][0] for b in loader]
    assert names == sorted(names) and len(names) == 3
    with pytest.raises(ValueError, match='Wrong dataset phase'):
        build_dataloader(build_dataset(cufed), dict(cufed, phase='serve'))


# -------------------------------------------------------------- prefetchers
def test_uint8_conversion_is_the_host_formula():
    """Each of the 256 values bit for bit ``astype(float32) / 255``, on numpy
    and on tensors; ``x.float() / 255`` is that formula on the CPU too."""
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = x.astype(np.float32) / 255.
    for got in (uint8_to_float32(x),
                uint8_to_float32(torch.from_numpy(x)).numpy(),
                (torch.from_numpy(x).float() / 255).numpy()):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _host_batches():
    rng = np.random.RandomState(0)
    return [{'img_in': rng.randint(0, 256, (2, 8, 8, 3), dtype=np.uint8),
             'img_ref_list': rng.randint(0, 256, (2, 5, 8, 8, 3),
                                         dtype=np.uint8),
             'img_ref_lq_list': rng.randint(0, 256, (2, 5, 2, 2, 3),
                                            dtype=np.uint8),
             'img_in_lq': rng.rand(2, 2, 2, 3).astype(np.float32),
             'lq_path': ['a', 'b']} for _ in range(3)]


def test_cpu_prefetcher_hands_the_batches_over():
    batches = _host_batches()
    prefetcher = CPUPrefetcher(batches)
    assert prefetcher.next() is batches[0]
    prefetcher.next(), prefetcher.next()
    assert prefetcher.next() is None
    prefetcher.reset()
    assert prefetcher.next() is batches[0]


@pytest.mark.parametrize('kind', ['device', 'cuda'])
def test_device_prefetchers_on_the_cpu(kind):
    """The device prefetchers (on ``--device cpu``: no stream, no pinning)
    move the named keys only, uint8 as the host formula, floats as they
    are, every batch in order, then None; a reset starts the epoch again."""
    batches = _host_batches()
    keys = ('img_in', 'img_ref_list', 'img_in_lq')
    device = torch.device('cpu')
    prefetcher = BackgroundDevicePrefetcher(batches, device, depth=2,
                                            device_keys=keys) \
        if kind == 'device' else CUDAPrefetcher(batches, device, keys)
    for _ in range(2):
        prefetcher.reset()
        for want in batches:
            got = prefetcher.next()
            for key in keys:
                assert isinstance(got[key], torch.Tensor)
                assert got[key].dtype == torch.float32
                np.testing.assert_array_equal(
                    got[key].numpy(), uint8_to_float32(want[key])
                    if want[key].dtype == np.uint8 else want[key])
            assert got['img_ref_lq_list'] is want['img_ref_lq_list']
            assert got['lq_path'] is want['lq_path']
        assert prefetcher.next() is None
        assert prefetcher.next() is None
    prefetcher.close()


def test_background_prefetcher_depth_errors_and_reset():
    """The queue depth is ``prefetch_depth`` or twice
    ``steps_per_dispatch``; a loader's exception is raised by ``next``; a
    reset stops the old thread, and ``close`` the current one."""
    cpu = torch.device('cpu')
    assert BackgroundDevicePrefetcher([], cpu, {'train': {
        'steps_per_dispatch': 16}}).depth == 32
    assert BackgroundDevicePrefetcher([], cpu, None, depth=1).depth == 2

    def broken():
        yield _host_batches()[0]
        raise OSError('disk gone')

    class Loader:
        def __iter__(self):
            return broken()

    prefetcher = BackgroundDevicePrefetcher(Loader(), cpu, depth=2)
    assert prefetcher.next() is not None
    with pytest.raises(OSError, match='disk gone'):
        prefetcher.next()

    prefetcher = BackgroundDevicePrefetcher(_host_batches() * 20, cpu,
                                            depth=2)
    prefetcher.next()
    old = prefetcher._thread
    prefetcher.reset()
    assert not old.is_alive()
    prefetcher.close()
    assert not any(t is old for t in threading.enumerate())


# --------------------------------------------------- the repairs of the port
def _tiny_model_opt(path=None, is_train=True):
    return {'model_type': 'MultiRefRestorationModel', 'manual_seed': 0,
            'is_train': is_train,
            'network_g': {'type': 'MRAPARestorationNet', 'ngf': 8,
                          'n_blocks': 1, 'groups': 2},
            'network_map': {'type': 'CorrespondenceGenerationArch'},
            'network_extractor': {'type': 'ContrasMultiExtractorSep'},
            'path': path or {},
            'train': {'lr_g': 1e-4, 'lr_offset': 1e-4,
                      'lr_relu3_offset': 1e-6, 'lr_relu2_offset': 1e-5,
                      'pixel_criterion': 'L1Loss', 'pixel_weight': 1.0}}


def test_a_uint8_batch_trains_as_the_host_formula():
    """``feed_data`` takes uint8 (``output_dtype: uint8`` with the CPU
    prefetcher) as ``astype(float32) / 255``: the step equals the step on
    the float batch, where it used to train on [0, 255]."""
    rng = np.random.RandomState(1)
    u8 = {'img_in': rng.randint(0, 256, (1, 16, 16, 3), dtype=np.uint8),
          'img_in_lq': rng.randint(0, 256, (1, 4, 4, 3), dtype=np.uint8),
          'img_in_up': rng.randint(0, 256, (1, 16, 16, 3), dtype=np.uint8),
          'img_ref_list': rng.randint(0, 256, (1, 2, 16, 16, 3),
                                      dtype=np.uint8)}
    f32 = {k: v.astype(np.float32) / 255. for k, v in u8.items()}
    losses = []
    for batch in (u8, f32):
        model = build_model(_tiny_model_opt(), device='cpu')
        model.feed_data(batch)
        assert float(model.gt.max()) <= 1.0
        torch.testing.assert_close(model.gt, torch.from_numpy(f32['img_in']),
                                   rtol=0, atol=0)
        model.optimize_parameters(1)
        losses.append(model.get_current_log()['l_pix'])
    assert losses[0] == losses[1]


@pytest.mark.parametrize('key', ['pretrain_network_g',
                                 'pretrain_network_feature_extractor',
                                 'vgg_pretrain_path'])
def test_a_missing_checkpoint_raises_with_its_key(tmp_path, key):
    """A ``path`` entry naming a file that is not there raises, as the JAX
    package fails, instead of training from the seeded weights; ``~``
    starts from them."""
    missing = str(tmp_path / 'feature_extraction_network.pth')
    with pytest.raises(FileNotFoundError, match=f'path.{key}'):
        build_model(_tiny_model_opt({key: missing}), device='cpu')
    build_model(_tiny_model_opt({key: None}), device='cpu')


def test_dist_params_port_is_accepted(monkeypatch):
    """The shipped ``dist_params: {backend: nccl, port: 29739}``: ``port``
    becomes ``MASTER_PORT`` unless the environment sets it, and nothing
    else reaches ``init_process_group``, whose own signature checks the
    call (it used to get ``port=`` and raise a ``TypeError``)."""
    init = mock.create_autospec(dist.init_process_group)
    monkeypatch.setattr(dist, 'init_process_group', init)
    monkeypatch.setattr(dist, 'is_initialized', lambda: False)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('WORLD_SIZE', '1')
    monkeypatch.delenv('MASTER_PORT', raising=False)
    dist_util.init_dist('pytorch', **{'backend': 'gloo', 'port': 29739})
    assert os.environ['MASTER_PORT'] == '29739'
    init.assert_called_once_with('gloo', init_method='env://', rank=0,
                                 world_size=1,
                                 timeout=dist_util.DEFAULT_TIMEOUT)
    monkeypatch.setenv('MASTER_PORT', '30001')
    dist_util.init_dist('pytorch', backend='gloo', port=29739)
    assert os.environ['MASTER_PORT'] == '30001'
    with pytest.raises(TypeError, match='store_path'):
        dist_util.init_dist('pytorch', backend='gloo', store_path='/x')
