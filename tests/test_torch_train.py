"""The port's training half against the JAX package's, on the CPU: the
pixel losses, the learning-rate schedules, the routing of net_g's
parameters to the four Adam groups, and the pixel-phase training step of
``MultiRefRestorationModel`` for both alignments (one backward's gradients
by name, then a 3-step loss and parameter trajectory) from the same flax
init and the same numpy batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.losses import legacy_losses as jax_losses
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu.models.lr_scheduler import build_schedule as jax_schedule
from mrefsr_tpu_torch.losses import legacy_losses
from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.models.lr_scheduler import ScheduleLR, build_schedule
from mrefsr_tpu_torch.models.multi_ref_restoration_model import (
    PARAM_GROUPS, param_group_of)

T, GT, B, STEPS = 5, 32, 2, 3
LRS = {'lr_g': 1e-4, 'lr_offset': 1e-4, 'lr_relu3_offset': 1e-6,
       'lr_relu2_offset': 1e-5}


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores: more threads per process only get in each other's
    way."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize('name', ['L1Loss', 'MSELoss'])
@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
@pytest.mark.parametrize('weight_channels', [None, 1, 3])
def test_pixel_losses_match_jax(name, reduction, weight_channels):
    rng = np.random.RandomState(0)
    pred = rng.rand(2, 5, 6, 3).astype(np.float32)
    target = rng.rand(2, 5, 6, 3).astype(np.float32)
    weight = None if weight_channels is None else rng.rand(
        2, 5, 6, weight_channels).astype(np.float32)
    want = getattr(jax_losses, name)(loss_weight=0.7, reduction=reduction)(
        jnp.asarray(pred), jnp.asarray(target),
        None if weight is None else jnp.asarray(weight))
    got = getattr(legacy_losses, name)(loss_weight=0.7, reduction=reduction)(
        torch.from_numpy(pred), torch.from_numpy(target),
        None if weight is None else torch.from_numpy(weight))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_pixel_loss_refuses_an_unknown_reduction():
    with pytest.raises(ValueError, match='reduction'):
        legacy_losses.L1Loss(reduction='median')


# --------------------------------------------------------------- schedules
SCHEDULES = {
    'multistep': {'type': 'MultiStepLR', 'milestones': [5, 12],
                  'gamma': 0.5},
    'multistep_default_gamma': {'type': 'MultiStepLR', 'milestones': [7]},
    'multistep_restart': {'type': 'MultiStepRestartLR',
                          'milestones': [4, 9, 14, 19], 'gamma': 0.5,
                          'restarts': [0, 10], 'restart_weights': [1, 0.5]},
    'cosine': {'type': 'CosineAnnealingRestartLR', 'periods': [8, 8, 8],
               'restart_weights': [1, 0.5, 0.25], 'eta_min': 1e-7},
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
@pytest.mark.parametrize('warmup', [-1, 6])
def test_schedules_match_jax(name, warmup):
    """Every multiplier over 30 steps; with warm-up the first step gets
    1 / warmup, not 0. f32 in JAX (its cosine included), f64 here:
    rtol 1e-5."""
    want_fn = jax_schedule(SCHEDULES[name], warmup, base_lr=1e-4)
    got_fn = build_schedule(SCHEDULES[name], warmup, base_lr=1e-4)
    got = [got_fn(step) for step in range(30)]
    want = [float(want_fn(step)) for step in range(30)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if warmup > 0:
        assert got[0] == pytest.approx(1 / warmup)


def test_unknown_schedule_raises():
    with pytest.raises(NotImplementedError, match='Scheduler'):
        build_schedule({'type': 'Linear'})


def test_schedule_lr_sets_and_restores_the_rates():
    """Iteration i trains with base * schedule(i - 1), group by group."""
    params = [torch.nn.Parameter(torch.zeros(1)) for _ in range(2)]
    optimizer = torch.optim.Adam([{'params': [params[0]], 'lr': 1e-4},
                                  {'params': [params[1]], 'lr': 1e-6}])
    schedule = build_schedule(SCHEDULES['multistep'])
    scheduler = ScheduleLR(optimizer, schedule)
    scheduler.step(6)                           # schedule(5): one milestone
    assert scheduler.get_last_lr() == [5e-5, 5e-7]
    state = scheduler.state_dict()
    other = ScheduleLR(optimizer, schedule)     # base rates already halved
    other.load_state_dict(state)
    other.step(13)
    assert other.get_last_lr() == [2.5e-5, 2.5e-7]


# ----------------------------------------------------------------- routing
def _opt(alignment, ngf=8, n_blocks=1, groups=2, train=True):
    opt = {
        'name': 'test_mref', 'model_type': 'MultiRefRestorationModel',
        'scale': 4, 'crop_border': 4, 'num_gpu': 1, 'manual_seed': 10,
        'is_train': train, 'dist': False, 'rank': 0, 'world_size': 1,
        'network_g': {'type': 'MRAPARestorationNet', 'ngf': ngf,
                      'n_blocks': n_blocks, 'groups': groups,
                      'alignment': alignment},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'patch_size': 3, 'stride': 1,
                        'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                        'vgg_type': 'vgg19'},
        'network_extractor': {'type': 'ContrasMultiExtractorSep'},
        'path': {},
        'train': dict(LRS, weight_decay_g=0, beta_g=[0.9, 0.999],
                      scheduler={'type': 'MultiStepLR', 'milestones': [2],
                                 'gamma': 0.5},
                      total_iter=10, warmup_iter=-1, net_g_pretrain_steps=0,
                      steps_per_dispatch=16, pixel_criterion='L1Loss',
                      pixel_weight=1.0),
        'val': {'val_freq': 5, 'save_img': False},
    }
    return opt


def _reference_label(path):
    """The JAX package's rule (multi_ref_restoration_model.py:168-177) on a
    flax parameter path."""
    if 'offset' in path:
        return 'relu3_offset' if 'small' in path else \
            'relu2_offset' if 'medium' in path else 'offset'
    return 'g'


@pytest.mark.parametrize('alignment', ['dcn', 'flow'])
def test_param_groups_follow_the_names_of_the_full_width_net(alignment):
    """Every parameter of the full-width net lands in the group the JAX
    package's rule gives its flax path."""
    from mrefsr_tpu.archs import build_network as jax_build_network
    net_opt = {'type': 'MRAPARestorationNet', 'ngf': 64, 'n_blocks': 16,
               'groups': 8, 'alignment': alignment}
    lq = 4
    zeros = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    pre = {k: zeros(1, 1, lq * s, lq * s, 9, 2)
           for k, s in (('relu3_1', 1), ('relu2_1', 2), ('relu1_1', 4))}
    feats = {k: zeros(1, 1, lq * s, lq * s, c) for k, s, c in
             (('relu3_1', 1, 256), ('relu2_1', 2, 128), ('relu1_1', 4, 64))}
    shapes = jax.eval_shape(lambda: jax_build_network(net_opt).init(
        jax.random.PRNGKey(0), zeros(1, lq, lq, 3), pre, feats))
    flat = jax.tree_util.tree_flatten_with_path(shapes['params'])[0]
    want = {}
    for path, _ in flat:
        keys = [getattr(k, 'key', str(k)) for k in path]
        leaf = {'kernel': 'weight', 'scale': 'weight'}.get(keys[-1],
                                                           keys[-1])
        want['.'.join(keys[:-1] + [leaf])] = _reference_label(
            '.'.join(keys))
    from mrefsr_tpu_torch.archs import build_network
    with torch.device('meta'):
        net = build_network(net_opt)
    got = {name: param_group_of(name) for name, _ in net.named_parameters()}
    assert got == want
    counts = {g: sum(v == g for v in got.values()) for g in PARAM_GROUPS}
    per_scale = 6 if alignment == 'dcn' else 4   # 2 offset convs (+ dcn's)
    assert counts['offset'] == counts['relu3_offset'] \
        == counts['relu2_offset'] == per_scale
    agg = 'dyn_agg.conv_offset_mask' if alignment == 'dcn' \
        else 'flow_agg.conv_flow_gate'
    assert got[f'dyn_agg_restore.small_{agg}.weight'] == (
        'relu3_offset' if alignment == 'dcn' else 'g')
    assert got['dyn_agg_restore.large_offset_conv2.bias'] == 'offset'


def test_optimizer_groups_and_rates():
    model = build_model(_opt('dcn'), device='cpu')
    groups = model.optimizer_g.param_groups
    assert [g['lr'] for g in groups] == [1e-4, 1e-4, 1e-6, 1e-5]
    by_id = {id(p): name for name, p in model.net_g.named_parameters()}
    for label, group in zip(PARAM_GROUPS, groups):
        assert group['params']
        assert {param_group_of(by_id[id(p)]) for p in group['params']} \
            == {label}
    assert sum(len(g['params']) for g in groups) == len(by_id)
    assert not any(p.requires_grad for net in (model.net_extractor,
                                               model.net_map)
                   for p in net.parameters())
    model.update_learning_rate(3)                # schedule(2): the milestone
    assert model.get_current_learning_rate() == [5e-5, 5e-5, 5e-7, 5e-6]


# ---------------------------------------------------------- training step
def _batch(rng):
    lq = GT // 4
    return {
        'img_in': rng.rand(B, GT, GT, 3).astype(np.float32),
        'img_in_lq': rng.rand(B, lq, lq, 3).astype(np.float32),
        'img_in_up': rng.rand(B, GT, GT, 3).astype(np.float32),
        'img_ref_list': rng.rand(B, T, GT, GT, 3).astype(np.float32),
    }


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.fixture(scope='module', params=['dcn', 'flow'])
def runs(request):
    """Both models from one flax init on one batch: one backward's
    gradients, then STEPS training steps on the repeated batch."""
    alignment = request.param
    batch = _batch(np.random.RandomState(0))
    jax_model = jax_build_model(_opt(alignment))
    jax_model.feed_data(batch)                              # lazy init
    model = build_model(_opt(alignment), device='cpu')
    model.load_from_flax(jax_model.vars_extractor, jax_model.vars_map,
                         jax_model.vars_g)

    args = [jnp.asarray(batch[k])
            for k in ('img_in_up', 'img_ref_list', 'img_in_lq')]

    def loss_fn(params):
        out = jax_model._forward(params, jax_model.vars_extractor,
                                 jax_model.vars_map, *args)
        return jax_model.cri_pix(out, jnp.asarray(batch['img_in']))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))

    def both_grads():
        """(loss, gradients by torch name) of the port and of the JAX
        model, at the JAX model's current weights."""
        model.load_from_flax(jax_model.vars_extractor, jax_model.vars_map,
                             jax_model.vars_g)
        loss_jax, grads_jax = grad_fn(jax_model.vars_g['params'])
        model.net_g.zero_grad(set_to_none=True)   # a step leaves its own
        model.feed_data(batch)
        loss = model.cri_pix(model._forward(
            model.match_img_in, model.img_ref_list, model.img_in_lq),
            model.gt)
        loss.backward()
        grads = {name: p.grad.numpy().copy()
                 for name, p in model.net_g.named_parameters()}
        model.net_g.zero_grad(set_to_none=True)
        return ((float(loss), float(loss_jax)),
                (grads, _torch_named(grads_jax)))

    fresh = both_grads()
    losses_jax, losses, rates = [], [], []
    for step in range(1, STEPS + 1):
        jax_model.feed_data(batch)
        jax_model.optimize_parameters(step)
        losses_jax.append(float(jax_model.get_current_log()['l_pix']))
        model.feed_data(batch)
        model.optimize_parameters(step)
        losses.append(model.get_current_log()['l_pix'])
        jax_model.update_learning_rate(step)
        rates.append((model.get_current_learning_rate(),
                      jax_model.get_current_learning_rate()))
    params = ({k: v.detach().numpy().copy() for k, v in
               model.net_g.state_dict().items()},
              _torch_named(jax_model.vars_g['params']))
    return {'alignment': alignment, 'fresh': fresh, 'trained': both_grads(),
            'losses': (losses, losses_jax), 'rates': rates,
            'params': params}


@pytest.mark.parametrize('weights', ['fresh', 'trained'])
def test_gradients_match_jax_by_name(runs, weights):
    """One backward from the flax init (zero offset heads: every sample on
    a whole pixel, and the offset convs get exactly no gradient) and one
    from the JAX model's weights after its three steps (fractional
    samples). A parameter's gradient is held against that tensor's largest
    entry: within 1e-3 of it for at least 95 % of the tensors (the two
    frameworks sum f32 convolutions in another order, and an entry that is
    small against its tensor's max is noise in both), and within 5e-2 for
    all of them: where the two forwards differ in the last bit, a ReLU or
    leaky-ReLU gate can fall on the other side, and one gate moves the
    gradient of the conv before it by about 1 / sqrt(positions) of its
    size."""
    (loss, loss_jax), (got, want) = runs[weights]
    assert sorted(got) == sorted(want)
    assert loss == pytest.approx(loss_jax, rel=1e-5)
    zero = [name for name in want if not np.abs(want[name]).max() > 0]
    if weights == 'fresh':
        assert zero and all('offset_conv' in name for name in zero)
    else:
        assert not zero
    rel = {}
    for name in want:
        scale = np.abs(want[name]).max()
        err = np.abs(got[name] - want[name]).max()
        rel[name] = err / scale if scale else float(err > 0)
    assert max(rel.values()) <= 5e-2, max(rel, key=rel.get)
    loose = sorted(name for name, v in rel.items() if v > 1e-3)
    assert len(loose) <= 0.05 * len(rel), loose
    # the alignment's own parameters get a gradient through the sampler
    head = 'conv_offset_mask' if runs['alignment'] == 'dcn' \
        else 'conv_flow_gate'
    for scale_name in ('small', 'medium', 'large'):
        assert np.abs(got[f'dyn_agg_restore.{scale_name}_'
                          f'{"dyn" if runs["alignment"] == "dcn" else "flow"}'
                          f'_agg.{head}.weight']).max() > 0


def test_loss_trajectory_matches_jax(runs):
    """Three steps on one batch: every loss within 1e-5 (relative) of the
    JAX model's, falling, at the same learning rates."""
    got, want = runs['losses']
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    for ours, theirs in runs['rates']:
        np.testing.assert_allclose(ours, theirs, rtol=1e-6)
    assert runs['rates'][-1][0] == [5e-5, 5e-5, 5e-7, 5e-6]


def test_parameters_after_three_steps_match_jax(runs):
    """Adam's first steps move a parameter by about its learning rate
    whatever the gradient's size, so a gradient at noise level may take the
    other sign in the two frameworks: every entry within 2 * lr * steps of
    the JAX value (lr the largest group's, 1e-4), and 99 % of each
    tensor's entries within a tenth of one step."""
    got, want = runs['params']
    assert sorted(got) == sorted(want)
    lr = LRS['lr_g']
    for name in want:
        diff = np.abs(got[name] - want[name])
        assert diff.max() <= 2 * lr * STEPS, name
        assert (diff <= 0.1 * lr).mean() >= 0.99, name


def test_training_step_needs_is_train():
    model = build_model(_opt('dcn', train=False), device='cpu')
    model.feed_data(_batch(np.random.RandomState(1)))
    with pytest.raises(RuntimeError, match='is_train'):
        model.optimize_parameters(1)
