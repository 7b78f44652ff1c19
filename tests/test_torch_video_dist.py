"""The video models' validation over two gloo ranks on the CPU, through
``tests/torch_dist_worker.py``, against one process: ``VideoBaseModel``'s
frame sharding (EDVR, 10 frames over 2 ranks) and the recurrent folder
sharding padded to the rank count (BasicVSR, 3 folders over 2 ranks), the
per-folder arrays summed by one all-reduce."""
import cv2
import numpy as np
import pytest
import torch

import torch_dist_worker as worker

SCALE = 4


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _clips(root, names, frames, lq):
    rng = np.random.RandomState(len(names))
    for clip in names:
        for kind in ('gt', 'lq'):
            (root / kind / clip).mkdir(parents=True)
        for i in range(frames):
            gt = (rng.rand(lq * SCALE, lq * SCALE, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / 'gt' / clip / f'{i:08d}.png'), gt)
            cv2.imwrite(str(root / 'lq' / clip / f'{i:08d}.png'),
                        cv2.resize(gt, (lq, lq),
                                   interpolation=cv2.INTER_AREA))
    return {'name': 'REDS4', 'phase': 'val', 'scale': SCALE,
            'cache_data': True, 'dataroot_gt': str(root / 'gt'),
            'dataroot_lq': str(root / 'lq'), 'io_backend': {'type': 'disk'},
            'padding': 'reflection_circle'}


def _model_opt(model_type, net):
    return {'name': 'video_val', 'model_type': model_type, 'scale': SCALE,
            'manual_seed': 3, 'is_train': False, 'network_g': net,
            'path': {},
            'val': {'metrics': {
                'psnr': {'type': 'calculate_psnr', 'crop_border': 0},
                'ssim': {'type': 'calculate_ssim_pt', 'crop_border': 0,
                         'test_y_channel': True}}}}


def test_two_rank_video_validation_equals_one_process(tmp_path):
    """Every folder's (frames, metrics) array from two ranks equals the
    one process's, bit for bit: each entry is one rank's value plus
    zeros."""
    edvr_data = dict(_clips(tmp_path / 'edvr', ('000', '011'), 5, 16),
                     type='VideoTestDataset', num_frame=5)
    vr_data = dict(_clips(tmp_path / 'vr', ('000', '011', '015'), 3, 64),
                   type='VideoRecurrentTestDataset', num_frame=3)
    spec = {'video': {
        'edvr': (_model_opt('EDVRModel', {
            'type': 'EDVR', 'num_feat': 8, 'num_frame': 5,
            'deformable_groups': 2, 'num_extract_block': 1,
            'num_reconstruct_block': 1, 'with_tsa': True}), edvr_data),
        'basicvsr': (_model_opt('VideoRecurrentModel', {
            'type': 'BasicVSR', 'num_feat': 8, 'num_block': 1}), vr_data)}}
    ranks = worker.spawn('video_val', spec, tmp_path, world=2)
    alone = worker.video_validation(spec)
    for name, folders in alone.items():
        assert set(folders) == ({'000', '011'} if name == 'edvr'
                                else {'000', '011', '015'})
        for folder, want in folders.items():
            assert want.shape == ((5, 2) if name == 'edvr' else (3, 2))
            assert bool((want > 0).all()), (name, folder)
            for report in ranks:
                assert torch.equal(report[name][folder], want), \
                    (name, folder)
