"""The SISR datasets against the JAX package's on the CPU, on synthetic
folders of each layout: every sample of ``SISRMegaDepthDataset`` (the LMR
annotation CSV, match-point crops, flips under one seed),
``SISRCUFEDDataset`` (folder and ``ann_file`` modes; a training sample is
empty in both packages), ``SISRSun80Set``, ``SISRManga109Set``,
``SISRWRSRSet``, ``SISRMegaDepthTestSet`` and ``SISRMegaDepthv3TestSet``
equals the JAX dataset's bit for bit: the keys, the arrays (Pillow's uint8
bicubic LR included) and the names."""
import csv
import os
import random

import cv2
import numpy as np
import pytest

from mrefsr_tpu.data import build_dataset as jax_build_dataset
from mrefsr_tpu_torch.data import build_dataset
from torch_cli_data import write_lmr

# HR sizes that are not multiples of 4, so mod_crop cuts
SIZES = ((37, 50), (50, 41), (44, 44))


def _write(folder, names, seed, ext='.png'):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name, (h, w) in zip(names, SIZES):
        cv2.imwrite(os.path.join(folder, name + ext),
                    rng.randint(0, 256, (h, w, 3), dtype=np.uint8))


def _same(got, want):
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        if isinstance(val, np.ndarray):
            assert got[key].dtype == val.dtype and got[key].shape \
                == val.shape, key
            np.testing.assert_array_equal(got[key], val, key)
        else:
            assert got[key] == val, key


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('sisr'))
    names = ['a', 'b', 'c']
    _write(os.path.join(root, 'cufed', 'in'), names, 1)
    _write(os.path.join(root, 'cufed', 'ref'), names, 2)
    with open(os.path.join(root, 'cufed', 'ann.txt'), 'w') as f:
        f.writelines(f'{n}.png\n' for n in names)
    _write(os.path.join(root, 'sun80', 'Sun_Hays_SR_groundtruth'), names, 3,
           '.jpg')
    _write(os.path.join(root, 'manga'), names, 4)
    _write(os.path.join(root, 'md_test', 'test1600Pairs'), names, 5)
    with open(os.path.join(root, 'md_test', 'test1600Pairs.csv'), 'w',
              newline='') as f:
        out = csv.writer(f)
        out.writerow(['target', 'ref'])
        for n in ('c', 'a'):
            out.writerow([f'{n}.png', 'unused.png'])
    for i, n in enumerate(names):
        _write(os.path.join(root, 'md_v3', f'{i:05d}{n}.png'), [n], 6 + i)
    return root


def _test_opt(kind, root):
    folders = {'SISRSun80Set': 'sun80', 'SISRManga109Set': 'manga',
               'SISRWRSRSet': 'manga', 'SISRMegaDepthTestSet': 'md_test'}
    opt = {'name': kind, 'type': kind, 'phase': 'test', 'scale': 4}
    if kind == 'SISRMegaDepthv3TestSet':
        opt['data_folder'] = os.path.join(root, 'md_v3')
    else:
        opt['dataroot_in'] = os.path.join(root, folders[kind])
    return opt


@pytest.mark.parametrize('kind', ['SISRSun80Set', 'SISRManga109Set',
                                  'SISRWRSRSet', 'SISRMegaDepthTestSet',
                                  'SISRMegaDepthv3TestSet'])
def test_glob_test_sets_equal_the_jax_package(root, kind):
    ours = build_dataset(_test_opt(kind, root))
    theirs = jax_build_dataset(_test_opt(kind, root))
    assert len(ours) == len(theirs) == (2 if kind == 'SISRMegaDepthTestSet'
                                        else 3)
    for i in range(len(theirs)):
        _same(ours[i], theirs[i])
    assert ours[0]['gt'].shape[:2] == tuple(4 * (s // 4) for s in
                                            ours[0]['gt'].shape[:2])


@pytest.mark.parametrize('mode', ['folder', 'ann_file'])
@pytest.mark.parametrize('phase', ['val', 'train'])
def test_cufed_equals_the_jax_package(root, mode, phase):
    """Eval samples crop to a multiple of the scale; a training sample is
    an empty dict in both, after the same flip draws (the next draw of
    the generators agrees)."""
    folder = os.path.join(root, 'cufed')
    opt = {'name': 'cufed', 'type': 'SISRCUFEDDataset', 'phase': phase,
           'scale': 4, 'gt_size': 32, 'use_flip': True, 'use_rot': True,
           'dataroot_in': os.path.join(folder, 'in'),
           'dataroot_ref': os.path.join(folder, 'ref'),
           'io_backend': {'type': 'disk'}}
    if mode == 'ann_file':
        opt['ann_file'] = os.path.join(folder, 'ann.txt')
    ours = build_dataset(opt, seed=5)
    theirs = jax_build_dataset(opt)
    random.seed(5)
    assert len(ours) == len(theirs) == 3
    for i in (0, 2, 1):
        _same(ours[i], theirs[i])
    assert ours.rng.random() == random.random()
    if phase == 'val':
        assert ours[0]['lq'].shape == (9, 12, 3)


def test_megadepth_equals_the_jax_package(tmp_path):
    """The LMR training set's targets: crops at the match points, flips
    and transposes under one seed, the LR at gt / 4."""
    md, ann = write_lmr(str(tmp_path))
    opt = {'name': 'md', 'type': 'SISRMegaDepthDataset', 'phase': 'train',
           'scale': 4, 'gt_size': 32, 'use_flip': True, 'use_rot': True,
           'dataroot_in': md, 'dataroot_ref': md, 'ann_file': ann}
    ours = build_dataset(opt, seed=9)
    theirs = jax_build_dataset(opt)
    random.seed(9)
    assert len(ours) == len(theirs) == 4
    for i in (0, 1, 2, 3, 1):
        _same(ours[i], theirs[i])
    assert ours[0]['lq'].shape == (8, 8, 3)
