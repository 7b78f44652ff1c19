"""Real-ESRGAN under DDP on the CPU: ``RealESRNetModel`` and
``RealESRGANModel`` with ``dist: true`` on two gloo ranks
(``tests/torch_dist_worker.py``'s ``realesr`` task, both models in one
start of the ranks) against one process a rank.

The port keeps one pool a rank, as the reference's DDP run does (ROADMAP
C): each rank synthesises its own batch from generators seeded by
``manual_seed`` plus its rank, and mixes it in its own pool. So at every
step each rank's pairs must equal, bit for bit, those of a model of one
process seeded ``manual_seed + rank`` fed the same batches; and the
gradient each rank steps with must be the mean of the two one-process
gradients at the same parameters. Tiny RRDBNet (8 features, one block),
B 2 a rank, gt 32, ``queue_size`` 4: the first two steps fill the pool,
the third mixes it. ``RealESRGANModel`` adds a tiny ``UNetDiscriminatorSN``
(8 features), whose gradients ``all_reduce_grads_mean`` averages outside
DDP, a VGG19 perceptual loss and the vanilla GAN loss, as the published
x4plus YAML: its one-process models take the rank's ``net_d`` state (the
spectral norms' ``u`` / ``v`` too) before each step, and the generator's
and the discriminator's gradients are both held to the mean. The averaged
gradients within 1e-6 of each tensor's largest entry (two f32 sums in
another order; measured: 0, bit-equal). After the steps both ranks hold
the same parameters (and the same ``net_d`` state), and rank 0 alone saves
and validates; its PSNR is that of one process with its EMA weights."""
import os

import cv2
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from mrefsr_tpu_torch.data import build_dataloader, build_dataset
from mrefsr_tpu_torch.models import build_model
from test_torch_realesrgan_model import (DEGRADE, KERNEL_OPTS, NET_D, NET_G,
                                        SCALE)

B, STEPS, SEED, WORLD = 2, 3, 5, 2
KINDS = ('RealESRNetModel', 'RealESRGANModel')
GRAD_REL_TOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _opt(kind, root, dist, seed=SEED):
    opt = {'name': 'realesr_ddp', 'model_type': kind,
           'scale': SCALE, 'num_gpu': WORLD, 'manual_seed': seed,
           'is_train': True, 'dist': dist, 'high_order_degradation': True,
           **DEGRADE, 'network_g': dict(NET_G),
           'path': {'pretrain_network_g': None,
                    'models': os.path.join(root, 'models'),
                    'training_states': os.path.join(root, 'states'),
                    'visualization': os.path.join(root, 'vis')},
           'train': {'ema_decay': 0.999,
                     'optim_g': {'type': 'Adam', 'lr': 2e-4,
                                 'betas': [0.9, 0.99]},
                     'scheduler': {'type': 'MultiStepLR',
                                   'milestones': [100], 'gamma': 0.5},
                     'total_iter': 10, 'warmup_iter': -1,
                     'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0,
                                   'reduction': 'mean'}},
           'val': {'metrics': {'psnr': {'type': 'calculate_psnr',
                                        'crop_border': 4,
                                        'test_y_channel': False}}},
           'datasets': {'train': {'batch_size_per_gpu': B}}}
    if kind == 'RealESRGANModel':
        opt.update(l1_gt_usm=True, percep_gt_usm=True, gan_gt_usm=False,
                   network_d=dict(NET_D))
        opt['train'].update(
            optim_d={'type': 'Adam', 'lr': 1e-4, 'betas': [0.9, 0.99]},
            perceptual_opt={'type': 'PerceptualLoss',
                            'layer_weights': {'conv1_2': 0.1,
                                              'conv2_2': 0.1},
                            'vgg_type': 'vgg19', 'use_input_norm': True,
                            'perceptual_weight': 1.0, 'style_weight': 0,
                            'range_norm': False, 'criterion': 'l1'},
            gan_opt={'type': 'GANLoss', 'gan_type': 'vanilla',
                     'real_label_val': 1.0, 'fake_label_val': 0.0,
                     'loss_weight': 0.1},
            net_d_iters=1, net_d_init_iters=0)
    return opt


def _batch(seed):
    """A collated batch of ``RealESRGANDataset``'s shape: gt 64 x 64 and
    21 x 21 kernels drawn from ``KERNEL_OPTS``' families."""
    from mrefsr_tpu_torch.data.degradations import (bivariate_Gaussian,
                                                    circular_lowpass_kernel)
    rng = np.random.RandomState(seed)
    pulse = np.zeros((21, 21), np.float32)
    pulse[10, 10] = 1
    assert KERNEL_OPTS['blur_kernel_size'] == 21
    k1 = [bivariate_Gaussian(21, s, s, 0) for s in rng.uniform(0.5, 3, B)]
    k2 = [circular_lowpass_kernel(c, 21) for c in rng.uniform(1, 3, B)]
    return {'gt': torch.from_numpy(rng.rand(B, 64, 64, 3).astype(np.float32)),
            'kernel1': torch.from_numpy(np.stack(k1).astype(np.float32)),
            'kernel2': torch.from_numpy(np.stack(k2).astype(np.float32)),
            'sinc_kernel': torch.from_numpy(np.stack([pulse] * B))}


def _val_opt(root):
    folder = os.path.join(root, 'val')
    rng = np.random.RandomState(SEED)
    for sub in ('gt', 'lq'):
        os.makedirs(os.path.join(folder, sub))
    img = (rng.rand(32, 24, 3) * 255).astype(np.uint8)
    cv2.imwrite(os.path.join(folder, 'gt', 'p.png'), img)
    cv2.imwrite(os.path.join(folder, 'lq', 'p.png'), img[::4, ::4])
    return {'name': 'val', 'type': 'RealESRGANPairedDataset', 'phase': 'val',
            'scale': SCALE, 'io_backend': {'type': 'disk'},
            'dataroot_gt': os.path.join(folder, 'gt'),
            'dataroot_lq': os.path.join(folder, 'lq')}


def _one_process_grads(model, params, d_state, step):
    """The gradients ``model`` steps with at ``params`` (and ``net_d``'s
    ``d_state``): ``net_g``'s, then ``net_d``'s where there is one."""
    optimizers = [(model.optimizer_g, model.net_g, [])]
    if d_state is not None:
        model.net_d.load_state_dict(d_state, strict=True)
        optimizers.append((model.optimizer_d, model.net_d, []))
    for optimizer, net, record in optimizers:
        worker._recorded_grads(optimizer, net, record)
    model.net_g.load_state_dict(params, strict=True)
    model.optimize_parameters(step)
    for optimizer, _, _ in optimizers:
        del optimizer.step              # the class's step again
    return [record[0] for _, _, record in optimizers]


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """Both models' runs on two ranks, their batches and the validation
    options."""
    tmp_path = tmp_path_factory.mktemp('realesr_ddp')
    root = str(tmp_path)
    batches = [[_batch(100 * r + s) for s in range(STEPS)]
               for r in range(WORLD)]
    val_opt = _val_opt(root)
    runs = {kind: {'opt': _opt(kind, os.path.join(root, kind), True),
                   'batches': batches} for kind in KINDS}
    ranks = worker.spawn('realesr', {'runs': runs, 'val_opt': val_opt},
                         tmp_path, world=WORLD)
    return root, batches, val_opt, ranks


@pytest.mark.parametrize('kind', KINDS)
def test_two_ranks_against_one_process_a_rank(two_ranks, kind):
    root, batches, val_opt, reports = two_ranks
    ranks = [r[kind] for r in reports]
    gan = kind == 'RealESRGANModel'

    for key, value in ranks[0]['params'].items():
        assert torch.equal(ranks[1]['params'][key], value), key
    if gan:
        assert ranks[0]['d_state'].keys() == ranks[1]['d_state'].keys()
        assert any(k.endswith('weight_u') for k in ranks[0]['d_state'])
        for key, value in ranks[0]['d_state'].items():
            assert torch.equal(ranks[1]['d_state'][key], value), key
    # rank 0 alone writes the checkpoints and the state, and validates
    assert sorted(ranks[0]['written']) == (
        ['3.state', 'net_d_3.pth', 'net_g_3.pth'] if gan
        else ['3.state', 'net_g_3.pth'])
    assert ranks[1]['written'] == [] and ranks[1]['metric_results'] == {}

    singles = [build_model(_opt(kind, os.path.join(root, f'one{r}'), False,
                                SEED + r), device='cpu')
               for r in range(WORLD)]
    if gan:     # the perceptual loss's VGG is seeded by manual_seed alone
        singles[1].cri_perceptual.vgg.load_state_dict(
            singles[0].cri_perceptual.vgg.state_dict(), strict=True)
    for step in range(STEPS):
        means = None
        for r, (rank, single) in enumerate(zip(ranks, singles)):
            single.feed_data({k: v.numpy()
                              for k, v in batches[r][step].items()})
            assert torch.equal(single.lq, rank['lq'][step]), (r, step)
            assert torch.equal(single.gt, rank['gt'][step]), (r, step)
            grads = _one_process_grads(
                single, ranks[0]['params_before'][step],
                ranks[0]['d_before'][step] if gan else None, step + 1)
            if means is None:
                means = [{} for _ in grads]
            for mean, net_grads in zip(means, grads):
                for n, g in net_grads.items():
                    mean[n] = mean.get(n, 0) + g / WORLD
        # from the third step on the pool gives back pairs it held
        if step == STEPS - 1:
            for rank in ranks:
                held = torch.cat(rank['gt'][:step])
                assert all(any(torch.equal(row, h) for h in held)
                           for row in rank['gt'][step])
        for rank in ranks:
            got = [rank['grads'][step]] + (
                [rank['d_grads'][step]] if gan else [])
            assert len(got) == len(means)
            for net_got, mean in zip(got, means):
                assert net_got.keys() == mean.keys()
                for n, want in mean.items():
                    err = float((net_got[n] - want).abs().max()) \
                        / float(want.abs().max())
                    assert err <= GRAD_REL_TOL, (step, n, err)

    one = singles[0]
    one.net_g_ema.load_state_dict(ranks[0]['ema'], strict=True)
    loader = build_dataloader(build_dataset(val_opt), val_opt)
    one.nondist_validation(loader, 1, None, False)
    assert ranks[0]['metric_results']['psnr'] == pytest.approx(
        one.metric_results['psnr'], rel=1e-12)


def test_pool_error_names_the_batch_of_a_rank():
    from mrefsr_tpu_torch.models.degradation_synth import TrainingPairPool
    pool = TrainingPairPool(180)
    lq = torch.zeros(48, 8, 8, 3)
    with pytest.raises(ValueError, match=r'batch size of a rank '
                                         r'\(batch_size_per_gpu\) 48'):
        pool(lq, torch.zeros(48, 32, 32, 3))
