"""The port's ``VideoRecurrentModel`` with ``BasicVSR`` (num_feat 8, 1
block, lq 64: SpyNet's smallest) against the JAX package's on the CPU,
from the same seeded flax weights: the trajectory across ``fix_flow`` 2
with ``flow_lr_mul`` 0.125 (SpyNet frozen, then at an eighth of the rate),
and the recurrent validation's per-folder ``metric_results``, with and
without ``flip_seq``."""
import cv2
import jax
import numpy as np
import pytest
import torch

from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.data import build_dataloader as jax_build_dataloader
from mrefsr_tpu.data import build_dataset as jax_build_dataset
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu.parallel import replicate
from mrefsr_tpu_torch.data import build_dataloader, build_dataset
from mrefsr_tpu_torch.models import build_model
from torch_video_params import random_params

NET = {'type': 'BasicVSR', 'num_feat': 8, 'num_block': 1,
       'spynet_path': None}
LR, STEPS, FIX_FLOW, T, LQ = 2e-4, 3, 2, 3, 64


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _opt(val=None):
    """BasicSR's ``train_BasicVSR_REDS.yml`` train block (Charbonnier,
    mean; Adam 2e-4, betas (0.9, 0.99); ``flow_lr_mul`` 0.125) at the tiny
    net, ``fix_flow`` cut to 2."""
    return {'name': 'basicvsr_test', 'model_type': 'VideoRecurrentModel',
            'scale': 4, 'num_gpu': 1, 'manual_seed': 0, 'is_train': True,
            'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': dict(NET),
            'path': {'pretrain_network_g': None, 'strict_load_g': True},
            'train': {'ema_decay': 0,
                      'optim_g': {'type': 'Adam', 'lr': LR,
                                  'betas': [0.9, 0.99]},
                      'scheduler': {'type': 'MultiStepLR',
                                    'milestones': [100], 'gamma': 0.5},
                      'pixel_opt': {'type': 'CharbonnierLoss',
                                    'loss_weight': 1.0, 'reduction': 'mean'},
                      'total_iter': 10, 'warmup_iter': -1,
                      'fix_flow': FIX_FLOW, 'flow_lr_mul': 0.125},
            'val': val or {'metrics': {'psnr': {
                'type': 'calculate_psnr', 'crop_border': 0,
                'test_y_channel': False}}},
            'datasets': {}}


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.fixture(scope='module')
def run():
    rng = np.random.RandomState(0)
    batch = {'lq': rng.rand(1, T, LQ, LQ, 3).astype(np.float32),
             'gt': rng.rand(1, T, 4 * LQ, 4 * LQ, 3).astype(np.float32)}
    jax_model = jax_build_model(_opt())
    params = random_params(jax_model.net_g, [batch['lq']], seed=2)
    jax_model.variables = replicate({'params': params}, jax_model.mesh)
    jax_model.opt_state = replicate(
        jax_model.tx.init(jax_model.variables['params']), jax_model.mesh)
    model = build_model(_opt(), device='cpu')
    model.load_from_flax({'params': params})
    states = [{k: v.clone() for k, v in model.net_g.state_dict().items()}]
    losses, losses_jax, jax_states = [], [], [_torch_named(params)]
    for step in range(1, STEPS + 1):
        jax_model.feed_data(batch)
        jax_model.optimize_parameters(step)
        losses_jax.append(float(jax_model.get_current_log()['l_pix']))
        jax_states.append(_torch_named(jax_model.variables['params']))
        model.feed_data(batch)
        model.optimize_parameters(step)
        losses.append(model.get_current_log()['l_pix'])
        states.append({k: v.clone() for k, v in
                       model.net_g.state_dict().items()})
    return {'jax': jax_model, 'model': model,
            'losses': (losses, losses_jax), 'states': (states, jax_states)}


def test_fix_flow_freezes_spynet_then_trains_it_slower(run):
    """Iteration 1 < fix_flow: every ``spynet`` parameter bit-equal in both
    packages, the rest moved; from iteration 2 SpyNet trains, at an eighth
    of the rate (the group's rate)."""
    states, jax_states = run['states']
    for before, after, label in ((states[0], states[1], 'port'),
                                 (jax_states[0], jax_states[1], 'jax')):
        for key in before:
            same = np.array_equal(np.asarray(before[key]),
                                  np.asarray(after[key]))
            if 'spynet' in key:
                assert same, (label, key)
        assert any(not np.array_equal(np.asarray(before[k]),
                                      np.asarray(after[k]))
                   for k in before if 'spynet' not in k), label
    assert any(not torch.equal(states[1][k], states[2][k])
               for k in states[1] if 'spynet' in k and 'mean' not in k)
    model = run['model']
    normal, flow = model.optimizer_g.param_groups
    names = {id(p): n for n, p in model.net_g.named_parameters()}
    assert flow['params'] and all('spynet' in names[id(p)]
                                  for p in flow['params'])
    assert not any('spynet' in names[id(p)] for p in normal['params'])
    assert model.get_current_learning_rate() == run['jax'].base_lrs \
        == [LR, LR * 0.125]


def test_trajectory_across_fix_flow_matches_jax(run):
    """The losses within rtol 1e-5 (measured 1.0e-7), and after each step
    every parameter within lr of JAX's and 99.9 % of each tensor's entries
    within lr / 10 (measured: at most 0.31 lr, two entries of
    ``conv_hr.weight`` where the gradient is near 0 and Adam's first steps
    take its sign; at least 99.992 % of each tensor within lr / 10). A
    SpyNet whose Adam count lagged through the freeze would be a quarter
    of a step off in every entry after step 2. The port's Adam is at STEPS
    steps for every parameter, SpyNet's included."""
    got, want = run['losses']
    np.testing.assert_allclose(got, want, rtol=1e-5)
    states, jax_states = run['states']
    for step in range(1, STEPS + 1):
        for name, value in jax_states[step].items():
            diff = np.abs(states[step][name].numpy() - value)
            assert diff.max() <= LR, (step, name, diff.max())
            assert (diff <= LR / 10).mean() >= 0.999, (step, name)
    state = run['model'].optimizer_g.state
    assert {int(s['step']) for s in state.values()} == {STEPS}


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    """Two REDS4-layout clips of T frames, lq 64, seeded."""
    root = tmp_path_factory.mktemp('clips')
    rng = np.random.RandomState(3)
    for clip in ('000', '011'):
        for kind in ('gt', 'lq'):
            (root / kind / clip).mkdir(parents=True)
        for i in range(T):
            gt = (rng.rand(4 * LQ, 4 * LQ, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / 'gt' / clip / f'{i:08d}.png'), gt)
            cv2.imwrite(str(root / 'lq' / clip / f'{i:08d}.png'),
                        cv2.resize(gt, (LQ, LQ),
                                   interpolation=cv2.INTER_AREA))
    return {'name': 'REDS4', 'type': 'VideoRecurrentTestDataset',
            'phase': 'val', 'scale': 4, 'cache_data': True,
            'dataroot_gt': str(root / 'gt'), 'dataroot_lq': str(root / 'lq'),
            'io_backend': {'type': 'disk'}, 'num_frame': T,
            'padding': 'reflection_circle'}


@pytest.mark.parametrize('flip_seq', [False, True])
def test_recurrent_validation_matches_jax(run, clips, flip_seq):
    """Each folder's (frames, metrics) PSNR array from the trained weights,
    the folders whole, with ``flip_seq`` the clip and its reverse averaged
    (measured: within 4.8e-6 dB without, 7.7e-6 with ``flip_seq``: float32
    PSNRs of images that agree but for a few bytes)."""
    val = dict(_opt()['val'], flip_seq=flip_seq)
    jax_model, model = run['jax'], run['model']
    jax_model.opt['val'] = model.opt['val'] = val
    jax_model._eval_step = None
    for m in (jax_model, model):
        if hasattr(m, 'metric_results'):
            del m.metric_results
    jax_model.validation(jax_build_dataloader(
        jax_build_dataset(dict(clips)), clips, num_gpu=1, dist=False), 3,
        None, save_img=False)
    model.validation(build_dataloader(build_dataset(dict(clips)), clips), 3,
                     None, save_img=False)
    assert set(model.metric_results) == set(jax_model.metric_results) \
        == {'000', '011'}
    for folder, want in jax_model.metric_results.items():
        got = model.metric_results[folder]
        assert got.shape == want.shape == (T, 1)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4)
    best = model.best_metric_results['REDS4']['psnr']
    assert best['iter'] == 3
