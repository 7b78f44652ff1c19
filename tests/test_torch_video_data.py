"""The port's video and paired-image data against the JAX package's on the
CPU: the REDS (with quantized flows too), REDSRecurrent, Vimeo-90K (and
recurrent) training sets, the three video test sets and the paired /
single image sets (from folders and from packed shards) bit for bit
for a seed (JAX's global ``random`` against the port dataset's
``random.Random(seed)``), the path and frame-index helpers, the file
client, and the metric dispatch with the batched ``_pt`` metrics."""
import random

import cv2
import numpy as np
import pytest
import torch

from mrefsr_tpu.data import build_dataset as jax_build_dataset
from mrefsr_tpu.data import data_util as jax_data_util
from mrefsr_tpu.metrics import calculate_metric as jax_calculate_metric
from mrefsr_tpu.metrics.psnr_ssim import (calculate_psnr_jax,
                                          calculate_ssim_jax)
from mrefsr_tpu_torch.data import build_dataset, data_util
from mrefsr_tpu_torch.metrics import (calculate_metric, calculate_psnr_pt,
                                      calculate_ssim_pt)
from mrefsr_tpu_torch.utils.file_client import FileClient

SCALE, LQ, CLIP = 4, 16, 100      # REDS clips hold 100 frames
GT = LQ * SCALE


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write(path, img):
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), img)


def _pair(rng, h=GT, w=GT):
    gt = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    return gt, cv2.resize(gt, (w // SCALE, h // SCALE),
                          interpolation=cv2.INTER_AREA)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """REDS (clips 000, a REDS4 clip, and 001, 100 frames each), Vimeo-90K
    (two septuplets) and a paired folder of four images, seeded."""
    root = tmp_path_factory.mktemp('video_data')
    rng = np.random.RandomState(0)
    for clip in ('000', '001'):
        for i in range(CLIP):
            gt, lq = _pair(rng)
            _write(root / 'reds' / 'gt' / clip / f'{i:08d}.png', gt)
            _write(root / 'reds' / 'lq' / clip / f'{i:08d}.png', lq)
    (root / 'reds' / 'meta.txt').write_text(
        f'000 {CLIP} ({GT},{GT},3)\n001 {CLIP} ({GT},{GT},3)\n')
    seqs = ('00001/0001', '00001/0002')
    for seq in seqs:
        for i in range(1, 8):
            gt, lq = _pair(rng)
            _write(root / 'vimeo' / 'gt' / seq / f'im{i}.png', gt)
            _write(root / 'vimeo' / 'lq' / seq / f'im{i}.png', lq)
    (root / 'vimeo' / 'meta.txt').write_text(
        ''.join(f'{s} 7 ({GT},{GT},3)\n' for s in seqs))
    for i in range(4):
        gt, lq = _pair(rng, 32, 48)
        _write(root / 'paired' / 'gt' / f'{i:04d}.png', gt)
        _write(root / 'paired' / 'lq' / f'{i:04d}x4.png', lq)
    (root / 'paired' / 'meta.txt').write_text(
        ''.join(f'{i:04d}.png (32,48,3)\n' for i in range(4)))
    return root


def _equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            assert str(x) == str(y), key


def _same_samples(opt, indices, seed=7):
    """The JAX dataset after ``random.seed(seed)`` and the port's with
    ``seed`` give the same samples at ``indices``, in turn."""
    jax_set = jax_build_dataset(dict(opt))
    port_set = build_dataset(dict(opt), seed=seed)
    assert len(jax_set) == len(port_set)
    random.seed(seed)
    for index in indices:
        _equal(jax_set[index], port_set[index])
    return port_set


def _reds_opt(root, kind, **extra):
    opt = {'name': 'reds', 'type': kind, 'phase': 'train', 'scale': SCALE,
           'gt_size': 32, 'dataroot_gt': str(root / 'reds' / 'gt'),
           'dataroot_lq': str(root / 'reds' / 'lq'),
           'meta_info_file': str(root / 'reds' / 'meta.txt'),
           'io_backend': {'type': 'disk'}, 'num_frame': 5,
           'interval_list': [1, 2, 3], 'random_reverse': True,
           'use_hflip': True, 'use_rot': True}
    opt.update(extra)
    return opt


@pytest.mark.parametrize('partition', ['REDS4', 'official'])
def test_reds_dataset_matches_jax(root, partition):
    """Windows near both ends of a clip (moved inside by a draw), every
    interval, reversals, crops and flips."""
    opt = _reds_opt(root, 'REDSDataset', val_partition=partition,
                    dataroot_flow=None)
    port = _same_samples(opt, [0, 1, 2, 50, 97, 99, 3, 98, 60, 0])
    assert len(port) == (CLIP if partition == 'REDS4' else 2 * CLIP)


@pytest.mark.parametrize('test_mode', [False, True])
def test_reds_recurrent_dataset_matches_jax(root, test_mode):
    opt = _reds_opt(root, 'REDSRecurrentDataset', val_partition='REDS4',
                    test_mode=test_mode, num_frame=7)
    port = _same_samples(opt, [0, 90, 99, 45, 97])
    assert len(port) == CLIP
    assert port[0]['lq'].shape == (7, 8, 8, 3)


def test_reds_flows_are_refused_by_name(root):
    """REDS flows are ported: ``dataroot_flow``'s quantized flows of clip
    001 (both halves of each PNG random levels) give the JAX dataset's
    samples, ``flow`` (5, 4, 4, 2) with zeros at the centre, through
    every interval, reversal, crop and flip / transpose draw."""
    rng = np.random.RandomState(9)
    for i in range(CLIP):
        for tag in ('p1', 'p2', 'n1', 'n2'):
            _write(root / 'flow' / '001' / f'{i:08d}_{tag}.png',
                   rng.randint(0, 256, (2 * LQ, LQ), dtype=np.uint8))
    opt = _reds_opt(root, 'REDSDataset', val_partition='REDS4',
                    dataroot_flow=str(root / 'flow'), gt_size=16)
    port = _same_samples(opt, [0, 1, 50, 98, 99, 7, 33, 60])
    sample = port[3]
    assert sample['flow'].shape == (5, 4, 4, 2)     # gt 16 at x4
    assert not sample['flow'][2].any() and sample['flow'][0].any()


@pytest.mark.parametrize('kind,extra', [
    ('Vimeo90KDataset', {'num_frame': 7}),
    ('Vimeo90KDataset', {'num_frame': 5}),
    ('Vimeo90KRecurrentDataset', {'num_frame': 7, 'flip_sequence': True}),
    ('Vimeo90KRecurrentDataset', {'num_frame': 7, 'flip_sequence': False})])
def test_vimeo90k_datasets_match_jax(root, kind, extra):
    opt = {'name': 'vimeo', 'type': kind, 'phase': 'train', 'scale': SCALE,
           'gt_size': 32, 'dataroot_gt': str(root / 'vimeo' / 'gt'),
           'dataroot_lq': str(root / 'vimeo' / 'lq'),
           'meta_info_file': str(root / 'vimeo' / 'meta.txt'),
           'io_backend': {'type': 'disk'}, 'random_reverse': True,
           'use_hflip': True, 'use_rot': True, **extra}
    _same_samples(opt, [0, 1, 1, 0, 1])


def _video_test_opt(root, kind, name='REDS4', **extra):
    opt = {'name': name, 'type': kind, 'phase': 'val', 'scale': SCALE,
           'dataroot_gt': str(root / 'reds' / 'gt'),
           'dataroot_lq': str(root / 'reds' / 'lq'),
           'io_backend': {'type': 'disk'}, 'num_frame': 5,
           'padding': 'reflection_circle', 'cache_data': True}
    opt.update(extra)
    return opt


@pytest.mark.parametrize('cache', [True, False])
def test_video_test_dataset_matches_jax(root, cache):
    opt = _video_test_opt(root, 'VideoTestDataset', cache_data=cache,
                          padding='replicate' if cache else 'reflection')
    port = _same_samples(opt, [0, 1, 2, 50, 98, 99, 100, 199])
    jax_set = jax_build_dataset(dict(opt))
    assert port.data_info == jax_set.data_info


def test_video_test_dataset_meta_info_and_recurrent_match_jax(root):
    opt = _video_test_opt(root, 'VideoTestDataset',
                          meta_info_file=str(root / 'reds' / 'meta.txt'),
                          name='REDSofficial')
    _same_samples(opt, [0, 150])
    port = _same_samples(_video_test_opt(root, 'VideoRecurrentTestDataset'),
                         [0, 1])
    assert port[1]['lq'].shape == (CLIP, LQ, LQ, 3)


def test_video_test_vimeo90k_dataset_matches_jax(root):
    opt = {'name': 'Vimeo90K', 'type': 'VideoTestVimeo90KDataset',
           'phase': 'val', 'scale': SCALE, 'cache_data': False,
           'dataroot_gt': str(root / 'vimeo' / 'gt'),
           'dataroot_lq': str(root / 'vimeo' / 'lq'),
           'meta_info_file': str(root / 'vimeo' / 'meta.txt'),
           'io_backend': {'type': 'disk'}, 'num_frame': 7}
    _same_samples(opt, [0, 1])


def _paired_opt(root, phase, **extra):
    opt = {'name': 'paired', 'type': 'PairedImageDataset', 'phase': phase,
           'scale': SCALE, 'dataroot_gt': str(root / 'paired' / 'gt'),
           'dataroot_lq': str(root / 'paired' / 'lq'),
           'filename_tmpl': '{}x4', 'io_backend': {'type': 'disk'},
           'gt_size': 16, 'use_hflip': True, 'use_rot': True}
    opt.update(extra)
    return opt


@pytest.mark.parametrize('extra', [
    {}, {'color': 'y'}, {'mean': [0.5, 0.4, 0.3], 'std': [0.2, 0.3, 0.4]},
    {'meta_info_file': 'meta'}])
@pytest.mark.parametrize('phase', ['train', 'val'])
def test_paired_image_dataset_matches_jax(root, phase, extra):
    if extra.get('meta_info_file'):
        extra = dict(extra, meta_info_file=str(root / 'paired' / 'meta.txt'))
    _same_samples(_paired_opt(root, phase, **extra), [0, 3, 1, 2, 0])


def test_single_image_dataset_matches_jax(root):
    opt = {'name': 'single', 'type': 'SingleImageDataset', 'phase': 'test',
           'dataroot_lq': str(root / 'paired' / 'lq'),
           'io_backend': {'type': 'disk'}}
    _same_samples(opt, [0, 1, 2, 3])
    _same_samples(dict(opt, color='y', mean=[0.5], std=[0.25]), [2])


def test_pack_backend_is_refused_by_name(root, tmp_path):
    """The ``pack`` backend is ported: ``PairedImageDataset`` on an lq and
    a gt shard (written by the JAX package's writer, keyed alike) gives
    the JAX dataset's samples in training and validation, and
    ``SingleImageDataset`` reads the lq shard's images by key."""
    from mrefsr_tpu.data.packio import PackWriter as JaxPackWriter
    from test_torch_a12_data import jax_packio_built_here
    patch = jax_packio_built_here(tmp_path)
    try:
        packs = {}
        for kind in ('lq', 'gt'):
            packs[kind] = str(tmp_path / f'{kind}.pack')
            writer = JaxPackWriter(packs[kind])
            for i in range(4):
                name = f'{i:04d}x4.png' if kind == 'lq' else f'{i:04d}.png'
                writer.put(f'{i:04d}',
                           (root / 'paired' / kind / name).read_bytes())
            writer.close()
        for phase in ('train', 'val'):
            _same_samples(_paired_opt(root, phase, io_backend={'type': 'pack'},
                                      dataroot_lq=packs['lq'],
                                      dataroot_gt=packs['gt']), [0, 3, 1, 2])
        single = build_dataset({'name': 'single', 'type': 'SingleImageDataset',
                                'phase': 'test', 'dataroot_lq': packs['lq'],
                                'io_backend': {'type': 'pack'}})
        assert [single[i]['lq_path'] for i in range(len(single))] == \
            ['0000', '0001', '0002', '0003']
        np.testing.assert_array_equal(
            single[1]['lq'], cv2.imread(str(root / 'paired' / 'lq' /
                                            '0001x4.png'))[:, :, ::-1]
            .astype(np.float32) / 255.)
        assert FileClient('pack', db_paths=[packs['gt']]).get('0002') == \
            (root / 'paired' / 'gt' / '0002.png').read_bytes()
    finally:
        patch.undo()


def test_disk_file_client_reads_bytes_and_text(root):
    path = root / 'reds' / 'meta.txt'
    client = FileClient('disk')
    assert client.get(path) == path.read_bytes()
    assert client.get_text(path) == path.read_text()


# ---------------------------------------------------------------- helpers
@pytest.mark.parametrize('padding', ['replicate', 'reflection',
                                     'reflection_circle', 'circle'])
def test_generate_frame_indices_matches_jax(padding):
    for num_frames in (3, 5, 7):
        for crt in range(12):
            assert data_util.generate_frame_indices(
                crt, 12, num_frames, padding) == \
                jax_data_util.generate_frame_indices(crt, 12, num_frames,
                                                     padding)


def test_path_lists_match_jax(root, tmp_path):
    folders = [str(root / 'paired' / 'lq'), str(root / 'paired' / 'gt')]
    meta = str(root / 'paired' / 'meta.txt')
    assert data_util.paired_paths_from_meta_info_file(
        folders, ['lq', 'gt'], meta, '{}x4') == \
        jax_data_util.paired_paths_from_meta_info_file(
            folders, ['lq', 'gt'], meta, '{}x4')
    assert sorted(data_util.paths_from_folder(folders[0])) == sorted(
        jax_data_util.paths_from_folder(folders[0]))
    lmdbs = []
    for name, keys in (('a.lmdb', 'x.png\ny.png\n'),
                       ('b.lmdb', 'y.png\nx.png\n')):
        (tmp_path / name).mkdir()
        (tmp_path / name / 'meta_info.txt').write_text(keys)
        lmdbs.append(str(tmp_path / name))
    assert data_util.paired_paths_from_lmdb(lmdbs, ['lq', 'gt']) == \
        jax_data_util.paired_paths_from_lmdb(lmdbs, ['lq', 'gt'])
    assert data_util.paths_from_lmdb(lmdbs[0]) == \
        jax_data_util.paths_from_lmdb(lmdbs[0])


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize('metric', ['calculate_psnr', 'calculate_ssim',
                                    'calculate_psnr_pt', 'calculate_ssim_pt'])
@pytest.mark.parametrize('crop,y', [(0, False), (4, True)])
def test_calculate_metric_dispatch_matches_jax(metric, crop, y):
    """The validation loops' call: HWC BGR uint8 images, by the YAML's
    ``type:`` (measured: the numpy pair within 7e-16 relative, the ``_pt``
    pair within 7.9e-7)."""
    rng = np.random.RandomState(1)
    img = (rng.rand(40, 36, 3) * 255).astype(np.uint8)
    img2 = np.clip(img + rng.randint(-20, 21, img.shape), 0,
                   255).astype(np.uint8)
    opt = {'type': metric, 'crop_border': crop, 'test_y_channel': y}
    data = {'img': img, 'img2': img2}
    got = calculate_metric(data, opt)
    want = jax_calculate_metric(data, opt)
    assert isinstance(got, float)
    assert abs(got - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize('crop,y', [(0, False), (3, True)])
def test_batched_pt_metrics_match_jax(crop, y):
    """NHWC RGB batches in [0, 1], one value an image (measured: within
    6.7e-7 of the largest value)."""
    rng = np.random.RandomState(2)
    a = rng.rand(3, 32, 40, 3).astype(np.float32)
    b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 0.05, 0, 1)
    for port, jax_fn in ((calculate_psnr_pt, calculate_psnr_jax),
                         (calculate_ssim_pt, calculate_ssim_jax)):
        got = port(torch.from_numpy(a), torch.from_numpy(b), crop,
                   test_y_channel=y)
        want = np.asarray(jax_fn(a, b, crop, test_y_channel=y))
        assert got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
