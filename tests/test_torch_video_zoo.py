"""IconVSR and its ``EDVRFeatureExtractor`` against the JAX package's on
the CPU (``temporal_padding`` 2 and 3, an odd size to IconVSR's pad), and
the new nets' reference names; and the helpers the video zoo's other
parity tests share (``test_torch_tof_duf.py``, ``test_torch_iconvsr_model
.py``, ``test_torch_video_gan_model.py``): seeded flax variables, the port
net loaded from them through the port's ``convert``, and the check of a
net's output, every parameter's gradient of ``sum(out * cot)``
(``jax.grad``) and its norms' statistics against the JAX package's.

Tolerances, each against the largest entry of the JAX tensor (measured
in brackets, the worst case of the video zoo's parity files): outputs
1e-4 (8.5e-7); running statistics 1e-5 (6.9e-7); gradients 1e-2 (4.9e-3,
IconVSR; 4.4e-5 for the others): a gradient sums every position's terms,
and a ReLU whose input lies within rounding of 0 passes or stops a whole
term depending on the order of the sums before it, which through
IconVSR's recurrence, flow warps and deformable convs happens at several
positions. A gradient that is zero but for rounding (a bias before a norm
in training mode) is held against 1e-3 of the net's largest gradient
instead of its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu import convert as jax_convert
from mrefsr_tpu.archs import basicvsr_arch as jax_basicvsr
from mrefsr_tpu.archs import edvr_arch as jax_edvr
from mrefsr_tpu_torch.archs import basicvsr_arch, build_network, edvr_arch
from mrefsr_tpu_torch.convert import (flax_to_torch, load_from_flax,
                                      load_torch_state_dict,
                                      nhwc_dense_to_nchw,
                                      state_dict_from_flax_variables)
from torch_video_params import random_params


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


OUT_TOL, GRAD_TOL, GRAD_FLOOR, STATS_TOL = 1e-4, 1e-2, 1e-3, 1e-5


def smooth_frames(seed, b, t, h, w):
    """Smooth frames moving a pixel or two between neighbours."""
    rng = np.random.RandomState(seed)
    base = rng.rand(b, h + 8, w + 8, 3).astype(np.float32)
    base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)) / 3
    return np.stack([base[:, i:i + h, i % 5:i % 5 + w] for i in range(t)],
                    axis=1)


def seeded_variables(module, inputs, seed, kwargs=None):
    """Seeded flax variables from the flax module: ``random_params``'
    parameters and, where the net has norms, statistics away from (0, 1)
    (mean N(0, 0.1), variance U[0.5, 1.5])."""
    shapes = jax.eval_shape(lambda *a: module.init(
        jax.random.PRNGKey(0), *a, **(kwargs or {})), *inputs)
    variables = {'params': random_params(module, inputs, seed,
                                         kwargs=kwargs)}
    if 'batch_stats' in shapes:
        rng = np.random.RandomState(seed + 1000)

        def fill(node, leaf=None):
            if isinstance(node, dict):
                return {k: fill(v, k) for k, v in node.items()}
            if leaf == 'mean':
                return (rng.randn(*node.shape) * 0.1).astype(np.float32)
            return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)

        variables['batch_stats'] = fill(dict(shapes['batch_stats']))
    return variables


def port_net(cls, variables, state_fn=state_dict_from_flax_variables,
             **kwargs):
    """The port net from ``meta``, seeded, then the flax variables through
    the port's ``convert``, strictly (the net's constant buffers kept)."""
    with torch.device('meta'):
        net = cls(**kwargs)
    net.to_empty(device='cpu')
    net.init_weights(torch.Generator().manual_seed(0))
    if 'batch_stats' not in variables:
        return load_from_flax(net, variables['params'])
    state = state_fn(variables)
    for key, val in net.state_dict().items():
        if not key.endswith(('running_mean', 'running_var')):
            state.setdefault(key, val)
    net.load_state_dict(state, strict=True)
    return net


def close(got, want, tol, what, floor=0.):
    """``max |got - want|`` as a share of ``max |want|`` (or of ``floor``
    where that is larger), held to ``tol``; returns it."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), floor)
    assert scale > 0, what
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err)
    return err


def nchw(x):
    """NHWC (..., H, W, C) -> (..., C, H, W), a torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def nhwc(t):
    return t.detach().movedim(-3, -1).numpy()


def check_pair(jax_net, variables, x, net, out_shape, train=False,
                grads=True, linear_channels=None):
    """Output, every parameter's gradient of ``sum(out * cot)`` (``grads``;
    one jitted ``jax.value_and_grad``) and (``train``) the new statistics
    of ``net`` on NHWC ``x`` against ``jax_net``'s, whose output is
    ``out_shape``."""
    kwargs = {'train': True} if train else {}
    xj = jnp.asarray(x)
    mutable = ['batch_stats'] if train and 'batch_stats' in variables \
        else False
    cot = np.random.RandomState(99).randn(*out_shape).astype(np.float32)

    def apply(params):
        out = jax_net.apply(dict(variables, params=params), xj,
                            mutable=mutable, **kwargs)
        out, updates = out if mutable else (out, {})
        return jnp.sum(out * cot), (out, updates)

    if grads:
        (_, (want, updates)), want_grads = jax.jit(jax.value_and_grad(
            apply, has_aux=True))(variables['params'])
    else:
        _, (want, updates) = jax.jit(apply)(variables['params'])
    net.train(train)
    got = net(nchw(x))
    if got.dim() == 2:
        got_nhwc = got.detach().numpy()
        loss = (got * torch.from_numpy(cot)).sum()
    else:
        got_nhwc = nhwc(got)
        loss = (got * nchw(cot)).sum()
    errs = {'out': close(got_nhwc, want, OUT_TOL, 'out')}
    if grads:
        loss.backward()
        want_grads = flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                          want_grads))
        if linear_channels:
            want_grads['linear1.weight'] = nhwc_dense_to_nchw(
                want_grads['linear1.weight'], linear_channels)
        named = dict(net.named_parameters())
        assert set(named) == set(want_grads)
        floor = GRAD_FLOOR * max(np.abs(v).max() for v in want_grads.values())
        errs['grad'] = max(close(named[k].grad, v, GRAD_TOL, k, floor)
                           for k, v in want_grads.items())
    if mutable:
        state = net.state_dict()
        stats = state_dict_from_flax_variables({'params': {}, **updates})
        errs['stats'] = max(close(state[k], v.numpy(), STATS_TOL, k)
                            for k, v in stats.items())
    return errs


def params_by_torch_names(cls, seed, **kwargs):
    """The same seeded variables without tracing the flax ``init`` (tens of
    seconds for IconVSR and TOFlow): a port net's tensors drawn as
    ``random_params`` draws them (kernels N(0, 1 / fan_in), 1-D
    parameters N(0, 0.01); norm statistics: mean N(0, 0.1), variance
    U[0.5, 1.5]), then the JAX package's ``torch_to_flax`` (the constant
    ImageNet buffers left out)."""
    with torch.device('meta'):
        net = cls(**kwargs)
    rng = np.random.RandomState(seed)
    state = {}
    for key, val in net.state_dict().items():
        shape = tuple(val.shape)
        if key.endswith('running_mean'):
            state[key] = (rng.randn(*shape) * 0.1).astype(np.float32)
        elif key.endswith('running_var'):
            state[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif key.rpartition('.')[2] in ('weight', 'bias') and len(shape) >= 2:
            state[key] = (rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
                          ).astype(np.float32)
        elif key.rpartition('.')[2] in ('weight', 'bias'):
            state[key] = (rng.randn(*shape) * 0.01).astype(np.float32)
    return jax_convert.torch_to_flax(state)


def test_edvr_feature_extractor_matches_jax():
    """Five frames of 24 x 28, the centre frame's features fused (forward:
    IconVSR's test below holds the gradients of its ``edvr``)."""
    x = smooth_frames(0, 2, 5, 24, 28)
    jax_net = jax_edvr.EDVRFeatureExtractor(num_input_frame=5, num_feat=8)
    variables = params_by_torch_names(edvr_arch.EDVRFeatureExtractor, 1,
                                          num_input_frame=5, num_feat=8)
    net = port_net(edvr_arch.EDVRFeatureExtractor, variables,
                num_input_frame=5, num_feat=8)
    check_pair(jax_net, variables, x, net, (2, 24, 28, 8), grads=False)


@pytest.mark.parametrize('tp,frames', [(2, 5), (3, 7)])
def test_iconvsr_matches_jax(tp, frames):
    """34 x 38 frames (reflect-padded to 36 x 40, the output cropped back;
    SpyNet takes them at 64 x 64), keyframe stride 5: keyframes 0 and 4
    (0, 5 and 6 at T 7). At ``temporal_padding`` 2 the gradients too; at 3
    the forward (the mirrored windows need 7 frames: the JAX package
    clamps an index past the clip, the port raises)."""
    x = smooth_frames(2 + tp, 1, frames, 34, 38)
    kwargs = dict(num_feat=8, num_block=1, keyframe_stride=5,
                  temporal_padding=tp)
    jax_net = jax_basicvsr.IconVSR(**kwargs)
    variables = params_by_torch_names(basicvsr_arch.IconVSR, 4 + tp,
                                          **kwargs)
    net = port_net(basicvsr_arch.IconVSR, variables, **kwargs)
    assert net.keyframes(frames) == ([0, 4] if frames == 5 else [0, 5, 6])
    check_pair(jax_net, variables, x, net, (1, frames, 136, 152, 3),
                grads=tp == 2)
    with pytest.raises(ValueError, match=f'at least {2 * tp + 1} frames'):
        net(nchw(x[:, :2 * tp]))


# a few of the reference's torch names, as a published checkpoint has them
REFERENCE_KEYS = {
    'IconVSR': ('edvr.pcd_align.dcn_pack.l1.conv_offset.weight',
                'edvr.fusion.spatial_attn_add2.bias',
                'edvr.feature_extraction.4.conv2.weight',
                'backward_fusion.weight', 'forward_trunk.main.0.weight',
                'spynet.basic_module.5.basic_module.8.bias', 'spynet.mean'),
    'TOFlow': ('spynet.basic_module.3.basic_module.0.weight',
               'spynet.basic_module.0.basic_module.1.running_var',
               'spynet.basic_module.2.basic_module.12.bias', 'conv_4.weight',
               'mean', 'std'),
    'DUF': ('conv3d1.weight', 'dense_block1.dense_blocks.2.5.weight',
            'dense_block1.dense_blocks.0.0.running_mean',
            'dense_block2.temporal_reduce3.3.weight', 'bn3d2.running_var',
            'conv3d_f2.bias'),
    'VGGStyleDiscriminator': ('conv0_0.bias', 'bn0_1.running_mean',
                              'conv4_1.weight', 'linear1.weight',
                              'linear2.bias'),
}
SMALL = {'IconVSR': dict(num_feat=8, num_block=1),
         'TOFlow': {}, 'DUF': dict(num_layer=16),
         'VGGStyleDiscriminator': dict(num_feat=4)}


@pytest.mark.parametrize('name', sorted(REFERENCE_KEYS))
def test_checkpoints_load_strictly_with_reference_names(tmp_path, name):
    """Each new net is registered, holds the reference's names, and a
    reference-format ``.pth`` of it loads back into a fresh one strictly;
    an IconVSR naming ``spynet_path`` / ``edvr_path`` loads them, and a
    named file that is not there raises."""
    with torch.device('meta'):
        net = build_network({'type': name, **SMALL[name]})
    net.to_empty(device='cpu')
    net.init_weights(torch.Generator().manual_seed(1))
    state = net.state_dict()
    assert set(REFERENCE_KEYS[name]) <= set(state)
    path = tmp_path / f'{name}.pth'
    torch.save({'params': state}, path)
    other = build_network({'type': name, **SMALL[name]})
    other.load_state_dict(load_torch_state_dict(str(path)), strict=True)
    for key, val in other.state_dict().items():
        assert torch.equal(val, state[key]), key
    if name != 'IconVSR':
        return
    for part in ('spynet', 'edvr'):
        file = tmp_path / f'{part}.pth'
        torch.save({'params': getattr(net, part).state_dict()}, file)
        loaded = build_network({'type': name, **SMALL[name],
                                f'{part}_path': str(file)})
        loaded.init_weights(torch.Generator().manual_seed(2))
        for key, val in getattr(loaded, part).state_dict().items():
            assert torch.equal(val, state[f'{part}.{key}']), key
        missing = build_network({'type': name, **SMALL[name],
                                 f'{part}_path': str(tmp_path / 'no.pth')})
        with pytest.raises(FileNotFoundError, match='no.pth'):
            missing.init_weights(torch.Generator().manual_seed(2))
