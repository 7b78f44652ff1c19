"""The port's ``EDVRModel`` against the JAX package's on the CPU (num_feat
8, 1 extract block, 1 reconstruct block, 2 deform groups, T 5, with TSA,
as tests/test_models/test_video_models.py), from the same seeded flax
weights with live offset convs: the trajectory across ``tsa_iter`` 2 (the
first step trains the ``fusion`` parameters alone; Adam's step count runs
for every parameter, which the steps after it show), the ``dcn`` group of
``dcn_lr_mul`` against the JAX label set, and an EDVR woTSA checkpoint
loaded into the TSA net with ``strict_load_g: false``."""
import contextlib
import logging

import jax
import numpy as np
import pytest
import torch

from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu.parallel import replicate
from mrefsr_tpu_torch.models import build_model
from torch_video_params import random_params

NET = {'type': 'EDVR', 'num_in_ch': 3, 'num_out_ch': 3, 'num_feat': 8,
       'num_frame': 5, 'deformable_groups': 2, 'num_extract_block': 1,
       'num_reconstruct_block': 1, 'with_tsa': True}
LR, STEPS, TSA_ITER, B, LQ = 4e-4, 3, 2, 2, 16


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _opt(net=None, path=None):
    """BasicSR's ``train_EDVR_M_x4_SR_REDS.yml`` train block (Charbonnier,
    sum; Adam 4e-4, betas (0.9, 0.99); ``dcn_lr_mul``) at the tiny net,
    ``dcn_lr_mul`` 0.5 and ``tsa_iter`` 2."""
    return {'name': 'edvr_test', 'model_type': 'EDVRModel', 'scale': 4,
            'num_gpu': 1, 'manual_seed': 0, 'is_train': True, 'dist': False,
            'rank': 0, 'world_size': 1, 'network_g': dict(net or NET),
            'path': {'pretrain_network_g': None, 'strict_load_g': True,
                     **(path or {})},
            'train': {'ema_decay': 0,
                      'optim_g': {'type': 'Adam', 'lr': LR,
                                  'betas': [0.9, 0.99]},
                      'scheduler': {'type': 'MultiStepLR',
                                    'milestones': [100], 'gamma': 0.5},
                      'pixel_opt': {'type': 'CharbonnierLoss',
                                    'loss_weight': 1.0, 'reduction': 'sum'},
                      'total_iter': 10, 'warmup_iter': -1,
                      'tsa_iter': TSA_ITER, 'dcn_lr_mul': 0.5},
            'datasets': {}}


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _dotted(path):
    return '.'.join(str(getattr(k, 'key', k)) for k in path)


@pytest.fixture(scope='module')
def run():
    """STEPS steps of each model on one batch from the same seeded flax
    weights (the JAX step compiles once: its variables and optimizer
    state are placed as its own init places them)."""
    rng = np.random.RandomState(0)
    batch = {'lq': rng.rand(B, 5, LQ, LQ, 3).astype(np.float32),
             'gt': rng.rand(B, 4 * LQ, 4 * LQ, 3).astype(np.float32)}
    jax_model = jax_build_model(_opt())
    params = random_params(jax_model.net_g, [batch['lq'][:1]], seed=1)
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
    return {'jax': jax_model, 'model': model, 'params': params,
            'losses': (losses, losses_jax),
            'states': (states, jax_states)}


def test_tsa_phase_trains_fusion_alone_then_everything(run):
    """Iteration 1 < tsa_iter: every non-``fusion`` parameter bit-equal in
    both packages, the fusion ones moved; iteration 2 (= tsa_iter, the
    reference unfreezes before it) moves the rest too."""
    states, jax_states = run['states']
    for before, after, label in ((states[0], states[1], 'port'),
                                 (jax_states[0], jax_states[1], 'jax')):
        moved = {k for k in before
                 if not np.array_equal(np.asarray(before[k]),
                                       np.asarray(after[k]))}
        assert moved and all('fusion' in k for k in moved), label
    moved = {k for k in states[1]
             if not torch.equal(states[1][k], states[2][k])}
    assert any('fusion' not in k for k in moved)
    assert any('dcn_pack' in k for k in moved)


def test_trajectory_across_tsa_iter_matches_jax(run):
    """The losses (Charbonnier, sum) within rtol 1e-5 (measured 6.8e-8),
    and every parameter within lr / 50 of JAX's after each step (measured
    1.5e-8, 1.2e-6 and 1.2e-6 after steps 1-3). This holds Adam's count
    for the frozen parameters: with their gradients set to None instead
    of zeroed (the reference's ``requires_grad_(False)``), Adam skips them
    in step 1 and their first update takes the first step's size, and the
    parameters part from JAX's by 1.0e-4 after step 2 and 7.5e-4 after
    step 3 (measured)."""
    got, want = run['losses']
    np.testing.assert_allclose(got, want, rtol=1e-5)
    states, jax_states = run['states']
    for step in range(1, STEPS + 1):
        for name, value in jax_states[step].items():
            diff = np.abs(states[step][name].numpy() - value).max()
            assert diff <= LR / 50, (step, name, diff)


def test_adam_counts_every_parameter(run):
    """The port's Adam has taken STEPS steps for every parameter,
    the frozen ones included (optax's single count)."""
    state = run['model'].optimizer_g.state
    assert {int(s['step']) for s in state.values()} == {STEPS}
    assert len(state) == len(list(run['model'].net_g.parameters()))


def test_dcn_group_matches_the_jax_labels(run):
    """``dcn_lr_mul``: the parameters of the second group are those the JAX
    package labels ``dcn`` (every path holding ``dcn``), mapped to torch
    names by the converter; the rates are the JAX model's ``base_lrs``."""
    labels = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, 'dcn' in _dotted(path)),
        run['params'])
    want = {name for name, flag in _torch_named(labels).items()
            if flag.all()}
    model = run['model']
    names = {id(p): n for n, p in model.net_g.named_parameters()}
    normal, dcn = model.optimizer_g.param_groups
    assert {names[id(p)] for p in dcn['params']} == want
    assert want and all('dcn' in n for n in want)
    assert len(normal['params']) + len(dcn['params']) == len(names)
    assert model.get_current_learning_rate() == run['jax'].base_lrs \
        == [LR, LR * 0.5]


@contextlib.contextmanager
def _port_warnings():
    lines = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: lines.append(record.getMessage())
    port = logging.getLogger('mrefsr_tpu_torch')
    port.addHandler(handler)
    try:
        yield lines
    finally:
        port.removeHandler(handler)


def test_wotsa_checkpoint_loads_into_the_tsa_net(tmp_path):
    """``train_EDVR_M_x4_SR_REDS.yml`` starts from the woTSA run's
    checkpoint with ``strict_load_g: false``: the keys both nets hold are
    loaded, the TSA module's keep their seeded values with a log line each,
    the woTSA ``fusion`` conv, which the TSA net does not have, is skipped
    with one; a strict load raises."""
    wotsa = build_model(_opt(dict(NET, with_tsa=False)), device='cpu')
    wotsa.opt['path']['models'] = str(tmp_path)
    path = wotsa.save_network(wotsa.net_g, 'net_g', 5)
    seeded = build_model(_opt(), device='cpu').net_g.state_dict()
    with pytest.raises(ValueError, match='strict load'):
        build_model(_opt(path={'pretrain_network_g': path}), device='cpu')
    with _port_warnings() as lines:
        model = build_model(_opt(path={'pretrain_network_g': path,
                                       'strict_load_g': False}),
                            device='cpu')
    loaded = wotsa.net_g.state_dict()
    kept = 0
    for key, value in model.net_g.state_dict().items():
        if key in loaded and loaded[key].shape == value.shape:
            assert torch.equal(value, loaded[key]), key
        else:
            assert torch.equal(value, seeded[key]), key
            kept += 1
    assert kept and sum('missing key' in line for line in lines) \
        + sum('Size different' in line for line in lines) >= kept
    assert 'unexpected ckpt key: fusion.weight' in lines
