"""The port's ``VideoRecurrentModel`` with ``IconVSR`` (num_feat 8, one
block, T 5, lq 36: SpyNet takes it at 64) against the JAX package's on the
CPU, from the same seeded flax weights with live offset convs: the
trajectory across ``fix_flow`` 2 with ``flow_lr_mul`` 0.125 (``spynet``
and the ``edvr`` keyframe extractor frozen, then SpyNet at an eighth of
the rate), as ``test_torch_video_recurrent_model.py`` holds BasicVSR's.
The JAX step compiles once."""
import jax
import numpy as np
import pytest
import torch

from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu.parallel import replicate
from mrefsr_tpu_torch.archs.basicvsr_arch import IconVSR
from mrefsr_tpu_torch.models import build_model
from test_torch_video_zoo import params_by_torch_names

NET = {'type': 'IconVSR', 'num_feat': 8, 'num_block': 1,
       'keyframe_stride': 5, 'temporal_padding': 2, 'spynet_path': None,
       'edvr_path': None}
LR, STEPS, FIX_FLOW, T, LQ = 2e-4, 3, 2, 5, 36


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _opt():
    """BasicSR's ``train_IconVSR_REDS.yml`` train block (Charbonnier, mean;
    Adam 2e-4, betas (0.9, 0.99); ``flow_lr_mul`` 0.125) at the tiny net,
    ``fix_flow`` cut to 2."""
    return {'name': 'iconvsr_test', 'model_type': 'VideoRecurrentModel',
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
            'datasets': {}}


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.fixture(scope='module')
def run():
    rng = np.random.RandomState(0)
    base = rng.rand(1, LQ + 8, LQ + 8, 3).astype(np.float32)
    lq = np.stack([base[:, i:i + LQ, i:i + LQ] for i in range(T)], 1)
    batch = {'lq': lq,
             'gt': rng.rand(1, T, 4 * LQ, 4 * LQ, 3).astype(np.float32)}
    kwargs = {k: v for k, v in NET.items() if k != 'type'}
    params = params_by_torch_names(IconVSR, 2, **kwargs)['params']
    jax_model = jax_build_model(_opt())
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


def test_fix_flow_freezes_spynet_and_edvr_then_trains_them(run):
    """Iteration 1 < fix_flow: every ``spynet`` and ``edvr`` parameter
    bit-equal in both packages, the rest moved; from iteration 2 both
    train, SpyNet in the flow group at an eighth of the rate."""
    states, jax_states = run['states']
    frozen = ('spynet', 'edvr')
    for before, after, label in ((states[0], states[1], 'port'),
                                 (jax_states[0], jax_states[1], 'jax')):
        for key in before:
            if key.startswith(frozen):
                assert np.array_equal(np.asarray(before[key]),
                                      np.asarray(after[key])), (label, key)
        assert any(not np.array_equal(np.asarray(before[k]),
                                      np.asarray(after[k]))
                   for k in before if not k.startswith(frozen)), label
    for part in frozen:
        assert any(not torch.equal(states[1][k], states[2][k])
                   for k in states[1] if k.startswith(part)
                   and 'mean' not in k and 'std' not in k), part
    model = run['model']
    normal, flow = model.optimizer_g.param_groups
    names = {id(p): n for n, p in model.net_g.named_parameters()}
    assert flow['params'] and all(names[id(p)].startswith('spynet')
                                  for p in flow['params'])
    assert model.get_current_learning_rate() == run['jax'].base_lrs \
        == [LR, LR * 0.125]


def test_trajectory_across_fix_flow_matches_jax(run):
    """The losses within rtol 1e-5 (measured 3.1e-7), and after each step
    every parameter within 2 lr of JAX's and 99 % of each tensor's entries
    within lr / 10 (measured: at most 1.40 lr, in ``upconv2.weight``; at
    least 99.54 % within lr / 10, one entry of a 216-entry tensor). An
    entry whose gradient lies within rounding of 0 takes Adam's first step
    of about +-lr with the sign each package's sums give it, so two such
    entries can end up to 2 lr apart; IconVSR's recurrence and keyframe
    alignment leave a few more of them than BasicVSR's test meets, and
    ``test_torch_video_zoo.py`` holds its gradients themselves. Adam is at
    STEPS steps for every parameter, the frozen ones included."""
    got, want = run['losses']
    np.testing.assert_allclose(got, want, rtol=1e-5)
    states, jax_states = run['states']
    for step in range(1, STEPS + 1):
        for name, value in jax_states[step].items():
            diff = np.abs(states[step][name].numpy() - value)
            assert diff.max() <= 2 * LR, (step, name, diff.max())
            assert (diff <= LR / 10).mean() >= 0.99, (step, name)
    state = run['model'].optimizer_g.state
    assert {int(s['step']) for s in state.values()} == {STEPS}
