"""Checkpoints of the port: ``net_g_<iter>.pth`` in the reference's layout
and ``<iter>.state``, round trips, resuming a run, loading a saved file
into the JAX package, and the DCN -> flow warm start against the JAX
package's converter."""
import jax
import numpy as np
import pytest
import torch

from mrefsr_tpu import convert as jax_convert
from mrefsr_tpu_torch import convert
from mrefsr_tpu_torch.models import build_model


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores: more threads per process only get in each other's
    way."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _opt(tmp_path, alignment='dcn'):
    return {
        'model_type': 'MultiRefRestorationModel', 'manual_seed': 10,
        'is_train': True,
        'network_g': {'type': 'MRAPARestorationNet', 'ngf': 8,
                      'n_blocks': 1, 'groups': 2, 'alignment': alignment},
        'network_map': {'type': 'CorrespondenceGenerationArch'},
        'network_extractor': {'type': 'ContrasMultiExtractorSep'},
        'path': {'models': str(tmp_path / 'models'),
                 'training_states': str(tmp_path / 'training_states')},
        'train': {'lr_g': 1e-4, 'lr_offset': 1e-4, 'lr_relu3_offset': 1e-6,
                  'lr_relu2_offset': 1e-5, 'weight_decay_g': 1e-4,
                  'scheduler': {'type': 'MultiStepLR', 'milestones': [2, 4],
                                'gamma': 0.5},
                  'warmup_iter': 3, 'pixel_criterion': 'MSELoss',
                  'pixel_weight': 1.0},
    }


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {
        'img_in': rng.rand(1, 16, 16, 3).astype(np.float32),
        'img_in_lq': rng.rand(1, 4, 4, 3).astype(np.float32),
        'img_in_up': rng.rand(1, 16, 16, 3).astype(np.float32),
        'img_ref_list': rng.rand(1, 2, 16, 16, 3).astype(np.float32),
    }


def _steps(model, first, last):
    losses = []
    for step in range(first, last + 1):
        model.feed_data(_batch(step))
        model.optimize_parameters(step)
        losses.append(model.get_current_log()['l_pix'])
    return losses


@pytest.mark.parametrize('alignment', ['dcn', 'flow'])
def test_resume_continues_the_same_trajectory(tmp_path, alignment):
    """Two steps, save, three more; a new model that loads the ``.pth``
    and the ``.state`` takes the same three steps: the same losses, rates
    and weights, bit for bit (CPU, one process). The seed stays: it also
    makes the frozen nets, which no checkpoint of net_g holds."""
    model = build_model(_opt(tmp_path, alignment), device='cpu')
    _steps(model, 1, 2)
    model.save(epoch=0, current_iter=2)
    want_losses = _steps(model, 3, 5)
    want_rates = model.get_current_learning_rate()

    pth = tmp_path / 'models' / 'net_g_2.pth'
    state_file = tmp_path / 'training_states' / '2.state'
    assert pth.is_file() and state_file.is_file()
    saved = torch.load(pth, weights_only=True)
    assert list(saved) == ['params']
    assert sorted(saved['params']) == sorted(model.net_g.state_dict())

    opt = _opt(tmp_path, alignment)
    opt['path']['pretrain_network_g'] = str(pth)
    resumed = build_model(opt, device='cpu')
    state = resumed.load_training_state(state_file)
    assert state['iter'] == 2 and state['epoch'] == 0
    resumed.resume_training(state)
    assert _steps(resumed, state['iter'] + 1, 5) == want_losses
    assert resumed.get_current_learning_rate() == want_rates
    for key, val in model.net_g.state_dict().items():
        torch.testing.assert_close(resumed.net_g.state_dict()[key], val,
                                   rtol=0, atol=0)
    # without the optimizer's state the same steps go elsewhere
    cold = build_model(opt, device='cpu')
    assert _steps(cold, 3, 5) != want_losses


def test_resume_refuses_a_state_of_another_shape(tmp_path):
    model = build_model(_opt(tmp_path), device='cpu')
    with pytest.raises(ValueError, match='optimizers'):
        model.resume_training({'optimizers': [], 'schedulers': []})


def test_latest_and_unsaved_states(tmp_path):
    model = build_model(_opt(tmp_path), device='cpu')
    path = model.save_network(model.net_g, 'net_g', -1)
    assert path.endswith('net_g_latest.pth')
    assert model.save_training_state(0, -1) is None
    assert not (tmp_path / 'training_states').exists()


@pytest.mark.parametrize('alignment', ['dcn', 'flow'])
def test_saved_pth_loads_into_the_jax_package(tmp_path, alignment):
    """``mrefsr_tpu.convert`` reads the port's ``.pth`` into the flax tree
    the port's own converter maps back onto the same state dict."""
    model = build_model(_opt(tmp_path, alignment), device='cpu')
    _steps(model, 1, 1)
    path = model.save_network(model.net_g, 'net_g', 1)
    variables = jax_convert.torch_to_flax(
        jax_convert.load_torch_state_dict(path, param_key='params'))
    back = convert.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables['params']))
    want = model.net_g.state_dict()
    assert sorted(back) == sorted(want)
    for key, val in want.items():
        torch.testing.assert_close(back[key], val, rtol=0, atol=0)
    agg = 'small_dyn_agg' if alignment == 'dcn' else 'small_flow_agg'
    assert agg in variables['params']['dyn_agg_restore']


@pytest.mark.parametrize('as_torch', [True, False])
def test_dcn_to_flow_state_dict_matches_jax(tmp_path, as_torch):
    """The port's copy of the DCN -> flow warm start gives the JAX
    package's result on a trained-looking DCN state dict (non-zero offset
    heads), and the result loads strictly into the flow net."""
    model = build_model(_opt(tmp_path), device='cpu')
    rng = np.random.RandomState(0)
    sd = {}
    for key, val in model.net_g.state_dict().items():
        if 'conv_offset_mask' in key:
            val = torch.from_numpy(rng.uniform(-0.5, 0.5, tuple(val.shape))
                                   .astype(np.float32))
        sd[key] = val.clone() if as_torch else val.numpy().copy()
    got = convert.dcn_to_flow_state_dict(sd, deform_groups=2)
    want = jax_convert.dcn_to_flow_state_dict(sd, deform_groups=2)
    assert list(got) == list(want)
    for key in want:
        assert type(got[key]) is type(want[key])
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]))
    flow = build_model(_opt(tmp_path, 'flow'), device='cpu')
    flow.net_g.load_state_dict(
        {k: torch.as_tensor(v) for k, v in got.items()}, strict=True)
    gate = flow.net_g.dyn_agg_restore.large_flow_agg.conv_flow_gate
    assert float(gate.weight[:4].abs().max()) > 0      # the flow rows
    assert float(gate.weight[4:].abs().max()) == 0     # the gate rows


def test_dcn_to_flow_refuses_a_wrong_group_count(tmp_path):
    model = build_model(_opt(tmp_path), device='cpu')
    with pytest.raises(ValueError, match='conv_offset_mask'):
        convert.dcn_to_flow_state_dict(model.net_g.state_dict(),
                                       deform_groups=8)


def _net(width):
    """A conv, a norm with running statistics and a constant buffer."""
    net = torch.nn.Sequential(torch.nn.Conv2d(3, width, 3),
                              torch.nn.BatchNorm2d(width))
    net.register_buffer('mean', torch.full((3,), 0.5))
    return net


@pytest.mark.parametrize('case', ['strict', 'constants', 'not_strict'])
def test_load_network_follows_merge_loaded(tmp_path, case):
    """``BaseModel.load_network``, every model's loader, by the JAX
    package's ``_merge_loaded`` (its base_model.py:324): a key the file
    lacks, a key the net lacks and a tensor of another size are each
    logged and keep the net's value, and with ``strict`` raise; a norm's
    running statistics count as keys (flax's ``batch_stats``), the constant
    buffers flax has no variable for do not."""
    from mrefsr_tpu_torch.models.base_model import BaseModel
    model = BaseModel({'is_train': False}, device='cpu')
    src = _net(4 if case == 'not_strict' else 8)
    with torch.no_grad():
        for t in src.state_dict().values():
            t.copy_(torch.arange(t.numel()).reshape(t.shape) % 7 + 1)
    state = src.state_dict()
    drop = {'strict': ('1.running_mean',),
            'constants': ('mean', '1.num_batches_tracked'),
            'not_strict': ()}[case]
    state = {k: v for k, v in state.items() if k not in drop}
    if case == 'not_strict':
        state['extra.weight'] = torch.zeros(2)
    path = str(tmp_path / 'net.pth')
    torch.save({'params': state}, path)
    dst = _net(8)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    if case == 'strict':
        with pytest.raises(ValueError,
                           match='missing key in checkpoint: 1.running_mean'):
            model.load_network(dst, path, strict=True)
        return
    model.load_network(dst, path, strict=case == 'constants')
    for key, value in dst.state_dict().items():
        want = state[key] if key in state and (
            state[key].shape == before[key].shape) else before[key]
        assert torch.equal(value, want), key
    if case == 'not_strict':
        with pytest.raises(ValueError, match='Size different.*unexpected'):
            model.load_network(dst, path, strict=True)
