"""The port's ``VideoGANModel`` (``EDVR`` num_feat 8, one extract and one
reconstruct block, 2 deform groups, T 5, with TSA, against
``VGGStyleDiscriminator`` num_feat 4 on 160 x 160) against the JAX
package's on the CPU, from the same seeded flax variables with live offset
convs: a 3-step trajectory with ``net_d_iters`` 2 (the generator steps at
iteration 2 only), and the validation of ``VideoBaseModel`` in the JAX
package's order of bases. The JAX step compiles once."""
import jax
import numpy as np
import pytest
import torch

from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu.parallel import replicate
from mrefsr_tpu_torch.archs.edvr_arch import EDVR
from mrefsr_tpu_torch.convert import nhwc_dense_to_nchw
from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.models.video_base_model import VideoBaseModel
from test_torch_video_zoo import params_by_torch_names
from torch_video_params import random_params

NET_G = {'type': 'EDVR', 'num_in_ch': 3, 'num_out_ch': 3, 'num_feat': 8,
         'num_frame': 5, 'deformable_groups': 2, 'num_extract_block': 1,
         'num_reconstruct_block': 1, 'with_tsa': True}
NET_D = {'type': 'VGGStyleDiscriminator', 'num_in_ch': 3, 'num_feat': 4,
         'input_size': 160}
LR_G, LR_D, STEPS, B, LQ = 4e-4, 1e-4, 3, 2, 40


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _opt():
    """EDVR's REDS train block (Charbonnier, sum; Adam 4e-4) with a
    vanilla GAN loss of weight 5e-3, ``net_d`` at Adam 1e-4 and
    ``net_d_iters`` 2."""
    return {'name': 'video_gan_test', 'model_type': 'VideoGANModel',
            'scale': 4, 'num_gpu': 1, 'manual_seed': 0, 'is_train': True,
            'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': dict(NET_G), 'network_d': dict(NET_D),
            'path': {'pretrain_network_g': None, 'strict_load_g': True},
            'train': {'ema_decay': 0,
                      'optim_g': {'type': 'Adam', 'lr': LR_G,
                                  'betas': [0.9, 0.99]},
                      'optim_d': {'type': 'Adam', 'lr': LR_D,
                                  'betas': [0.9, 0.99]},
                      'scheduler': {'type': 'MultiStepLR',
                                    'milestones': [100], 'gamma': 0.5},
                      'total_iter': 10, 'warmup_iter': -1,
                      'pixel_opt': {'type': 'CharbonnierLoss',
                                    'loss_weight': 1.0, 'reduction': 'sum'},
                      'gan_opt': {'type': 'GANLoss', 'gan_type': 'vanilla',
                                  'loss_weight': 5e-3},
                      'net_d_iters': 2, 'net_d_init_iters': 0},
            'datasets': {}}


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _state(net):
    return {k: v.detach().clone().numpy() for k, v in
            net.state_dict().items() if not k.endswith('batches_tracked')}


@pytest.fixture(scope='module')
def run():
    rng = np.random.RandomState(0)
    base = rng.rand(B, LQ + 8, LQ + 8, 3).astype(np.float32)
    batch = {'lq': np.stack([base[:, i:i + LQ, i:i + LQ] for i in range(5)],
                            1),
             'gt': rng.rand(B, 4 * LQ, 4 * LQ, 3).astype(np.float32)}
    kwargs = {k: v for k, v in NET_G.items() if k != 'type'}
    params = params_by_torch_names(EDVR, 3, **kwargs)['params']
    jax_model = jax_build_model(_opt())
    params_d = random_params(jax_model.net_d, [batch['gt']], seed=4)
    shapes = jax.eval_shape(lambda x: jax_model.net_d.init(
        jax.random.PRNGKey(0), x), batch['gt'])['batch_stats']
    stats = {k: {'mean': np.zeros(v['mean'].shape, np.float32),
                 'var': np.ones(v['var'].shape, np.float32)}
             for k, v in dict(shapes).items()}
    mesh = jax_model.mesh
    jax_model.variables = replicate({'params': params}, mesh)
    jax_model.opt_state = replicate(jax_model.tx.init(params), mesh)
    jax_model.vars_d = replicate({'params': params_d,
                                  'batch_stats': stats}, mesh)
    jax_model.opt_state_d = replicate(jax_model.tx_d.init(params_d), mesh)
    model = build_model(_opt(), device='cpu')
    model.load_from_flax({'params': params})
    model.load_net_d_from_flax({'params': params_d, 'batch_stats': stats})
    records = []
    for step in range(1, STEPS + 1):
        jax_model.feed_data(batch)
        jax_model.optimize_parameters(step)
        model.feed_data(batch)
        model.optimize_parameters(step)
        jd = _torch_named(jax_model.vars_d['params'])
        jd['linear1.weight'] = nhwc_dense_to_nchw(jd['linear1.weight'], 32)
        records.append({
            'log': (model.get_current_log(),
                    {k: float(v) for k, v in
                     jax_model.get_current_log().items()}),
            'g': (_state(model.net_g),
                  _torch_named(jax_model.variables['params'])),
            'd': (_state(model.net_d), jd)})
    return {'model': model, 'records': records}


def test_video_gan_model_keeps_the_jax_order_of_bases():
    from mrefsr_tpu_torch.models.srgan_model import SRGANModel
    from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY
    cls = MODEL_REGISTRY.get('VideoGANModel')
    assert cls.__mro__[1:4] == (SRGANModel, VideoBaseModel,
                                VideoBaseModel.__mro__[1])
    assert cls.dist_validation is VideoBaseModel.dist_validation


def test_losses_and_turns_match_jax(run):
    """Each step's logged terms within rtol 1e-5 (measured 5.6e-7); the
    generator's terms 0 off its turn (iterations 1 and 3)."""
    for step, rec in enumerate(run['records'], start=1):
        got, want = rec['log']
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-5,
                                       atol=1e-9, err_msg=f'{step} {key}')
        assert (got['l_g_pix'] == 0) == (step != 2)


def test_trajectory_matches_jax(run):
    """After each step every parameter of ``net_d`` within lr of JAX's and
    99.9 % of each tensor's entries within lr / 10 (measured: at most
    0.035 lr, every entry within lr / 10); ``net_g``'s, which takes one
    Adam step, within 2 lr and 99 % within lr / 10 (measured: at most 2.0
    lr, at least 99.83 %). Adam's first step moves an entry by
    ``lr * g / (|g| + eps)``, almost +-lr whatever the size of g, so an
    entry whose gradient lies within rounding of 0 (a ReLU gate flipped
    by the order of a sum in the deformable alignment) moves by +-lr in
    each package with the sign its sums give it; which entries do depends
    on the number of threads."""
    for step, rec in enumerate(run['records'], start=1):
        for part, lr, tol, share in (('g', LR_G, 2, 0.99),
                                     ('d', LR_D, 1, 0.999)):
            got, want = rec[part]
            for name, value in want.items():
                diff = np.abs(got[name] - value)
                assert diff.max() <= tol * lr, (step, part, name, diff.max())
                assert (diff <= lr / 10).mean() >= share, (step, name)
