"""The port's StyleGAN2 nets against the JAX package's on the CPU: the same
flax-initialised weights (carried across by
``convert.stylegan2_state_dict_from_flax``, loaded strictly) and the same
numpy codes, noise and images go through both. Outputs are held to
1e-4 x max |out|: the two frameworks sum f32 convolutions in another
order, and the port computes the demodulation as one product."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs import stylegan2_arch as jax_arch
from mrefsr_tpu_torch.archs import build_network, stylegan2_arch as arch
from mrefsr_tpu_torch.convert import (load_stylegan2_from_flax,
                                      stylegan2_state_dict_from_flax)
from mrefsr_tpu_torch.utils import tensor2img

# tests/test_models/test_stylegan2_model.py's sizes
G_OPT = dict(out_size=32, num_style_feat=16, num_mlp=2, channel_multiplier=1,
             narrow=0.125)
D_OPT = dict(out_size=32, channel_multiplier=1, narrow=0.125, stddev_group=2)
FULL_G = dict(out_size=1024, num_style_feat=512, num_mlp=8,
              channel_multiplier=2)
FULL_D = dict(out_size=256, channel_multiplier=2)


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol=1e-4):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _liven(params, rng):
    """Flax starts every noise strength and activation bias at zero, which
    would leave the injected noise and the bias add out of the comparison:
    give them seeded values (an activation's bias is the only parameter of
    its module)."""
    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            elif (key == 'bias' and set(node) == {'bias'}) \
                    or (key == 'weight' and val.shape == (1,)) \
                    or (key == 'bias' and val.shape == (1, 3, 1, 1)):
                node[key] = (rng.randn(*val.shape) * 0.3).astype(np.float32)
    walk(params, ())
    return params


@pytest.fixture(scope='module')
def generators():
    rng = np.random.RandomState(0)
    jax_net = jax_arch.StyleGAN2Generator(**G_OPT)
    variables = jax_net.init(
        {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)},
        [jnp.zeros((1, 16))], randomize_noise=False)
    params = _liven(jax.tree_util.tree_map(np.array, variables['params']),
                    rng)
    net = build_network(dict(type='StyleGAN2Generator', **G_OPT))
    net.load_state_dict(stylegan2_state_dict_from_flax(params), strict=True)
    return jax_net, params, net.eval()


def _noise(rng, net, batch):
    return [rng.randn(batch, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2),
                      1).astype(np.float32) for i in range(net.num_layers)]


def _torch_noise(noise):
    return [torch.from_numpy(n).permute(0, 3, 1, 2) for n in noise]


def test_generator_with_given_noise(generators):
    jax_net, params, net = generators
    rng = np.random.RandomState(1)
    z = rng.randn(3, 16).astype(np.float32)
    noise = _noise(rng, net, 3)
    want, latent_want = jax_net.apply(
        {'params': params}, [jnp.asarray(z)],
        noise=[jnp.asarray(n) for n in noise], return_latents=True)
    got, latent = net([torch.from_numpy(z)], noise=_torch_noise(noise),
                      return_latents=True)
    _close(_nhwc(got), np.asarray(want))
    _close(latent.detach().numpy(), np.asarray(latent_want), 1e-5)
    assert net([torch.from_numpy(z)], noise=_torch_noise(noise))[1] is None


def test_generator_stored_noise(generators):
    """``randomize_noise=False`` takes the ``noises.noise{i}`` buffers,
    which came across from the flax parameters."""
    jax_net, params, net = generators
    z = np.random.RandomState(2).randn(2, 16).astype(np.float32)
    want, _ = jax_net.apply({'params': params}, [jnp.asarray(z)],
                            randomize_noise=False)
    got, _ = net([torch.from_numpy(z)], randomize_noise=False)
    _close(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize('inject_index', [1, 3, 7])
def test_generator_style_mixing_and_truncation(generators, inject_index):
    jax_net, params, net = generators
    rng = np.random.RandomState(3)
    z1, z2 = (rng.randn(2, 16).astype(np.float32) for _ in range(2))
    mean = rng.randn(1, 16).astype(np.float32) * 0.1
    noise = _noise(rng, net, 2)
    want, latent_want = jax_net.apply(
        {'params': params}, [jnp.asarray(z1), jnp.asarray(z2)],
        noise=[jnp.asarray(n) for n in noise], inject_index=inject_index,
        truncation=0.7, truncation_latent=jnp.asarray(mean),
        return_latents=True)
    got, latent = net([torch.from_numpy(z1), torch.from_numpy(z2)],
                      noise=_torch_noise(noise), inject_index=inject_index,
                      truncation=0.7, truncation_latent=torch.from_numpy(mean),
                      return_latents=True)
    _close(_nhwc(got), np.asarray(want))
    _close(latent.detach().numpy(), np.asarray(latent_want), 1e-5)


def test_generator_from_latents(generators):
    """``input_is_latent`` with a (b, num_latent, c) tensor: the path
    penalty's second forward."""
    jax_net, params, net = generators
    rng = np.random.RandomState(4)
    w = rng.randn(2, net.num_latent, 16).astype(np.float32)
    noise = _noise(rng, net, 2)
    want, _ = jax_net.apply({'params': params}, [jnp.asarray(w)],
                            input_is_latent=True,
                            noise=[jnp.asarray(n) for n in noise])
    got, _ = net([torch.from_numpy(w)], input_is_latent=True,
                 noise=_torch_noise(noise))
    _close(_nhwc(got), np.asarray(want))


def test_style_mlp_alone(generators):
    """``StyleMLP`` on the generator's ``style_mlp.*`` entries, and the
    generator's own ``style_mlp``, against the JAX ``StyleMLP``."""
    _, params, net = generators
    z = np.random.RandomState(5).randn(64, 16).astype(np.float32)
    mlp_params = {k: v for k, v in params.items()
                  if k.startswith('style_mlp.')}
    want = np.asarray(jax_arch.StyleMLP(16, 2).apply(
        {'params': mlp_params}, jnp.asarray(z)))
    mlp = arch.StyleMLP(16, 2)
    mlp.load_state_dict({k: v for k, v in net.state_dict().items()
                         if k.startswith('style_mlp.')}, strict=True)
    _close(mlp(torch.from_numpy(z)).detach().numpy(), want, 1e-5)
    _close(net.style_mlp(torch.from_numpy(z)).detach().numpy(), want, 1e-5)


def test_generator_randomness_is_explicit(generators):
    _, _, net = generators
    z = torch.from_numpy(np.random.RandomState(6).randn(2, 16).astype(
        np.float32))
    with pytest.raises(ValueError, match='torch.Generator'):
        net([z])
    with pytest.raises(ValueError, match='inject_index'):
        net([z, z], randomize_noise=False)
    with pytest.raises(ValueError, match='1 or 2'):
        net([z, z, z], randomize_noise=False)
    a, _ = net([z], generator=torch.Generator().manual_seed(7))
    b, _ = net([z], generator=torch.Generator().manual_seed(7))
    c, _ = net([z], generator=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    import random
    mixed, latent = net([z, z + 1], randomize_noise=False,
                        rng=random.Random(0), return_latents=True)
    crossover = random.Random(0).randint(1, net.num_latent - 1)
    assert torch.equal(latent[:, crossover - 1], latent[:, 0])
    assert not torch.equal(latent[:, crossover], latent[:, 0])


def test_discriminator_with_stddev_group_2():
    rng = np.random.RandomState(7)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    jax_net = jax_arch.StyleGAN2Discriminator(**D_OPT)
    params = _liven(jax.tree_util.tree_map(np.array, jax_net.init(
        jax.random.PRNGKey(2), jnp.asarray(x))['params']), rng)
    net = build_network(dict(type='StyleGAN2Discriminator', **D_OPT))
    load_stylegan2_from_flax(net, params)
    want = np.asarray(jax_net.apply({'params': params}, jnp.asarray(x)))
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.detach().numpy(), want)
    assert got.shape == (4, 1)


def test_generator_without_flax_noises_keeps_its_buffers():
    jax_net = jax_arch.StyleGAN2Generator(**G_OPT)
    params = jax.tree_util.tree_map(np.asarray, jax_net.init(
        {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)},
        [jnp.zeros((1, 16))])['params'])
    assert not any(k.startswith('noises.') for k in params)
    net = build_network(dict(type='StyleGAN2Generator', **G_OPT))
    net.init_weights(torch.Generator().manual_seed(0))
    before = net.noises.noise3.clone()
    load_stylegan2_from_flax(net, params)
    assert torch.equal(net.noises.noise3, before)
    np.testing.assert_array_equal(
        net.constant_input.weight.detach().numpy(),
        params['constant_input']['const'].transpose(0, 3, 1, 2))
    with pytest.raises(RuntimeError, match='stray'):
        load_stylegan2_from_flax(
            net, dict(params, stray=np.zeros(1, np.float32)))
    short = {k: v for k, v in params.items() if k != 'to_rgb1'}
    with pytest.raises(RuntimeError, match='to_rgb1'):
        load_stylegan2_from_flax(net, short)


def _flax_shapes(net, *args, **kwargs):
    shapes = jax.eval_shape(lambda: net.init(
        {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)},
        *args, **kwargs))['params']
    leaves = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    shapes)
    return {k: tuple(v.shape)
            for k, v in stylegan2_state_dict_from_flax(leaves).items()}


def test_full_width_names_and_shapes_match_the_jax_package():
    """The FFHQ config-f generator (1024, 512 style features, 8 MLP
    layers, channel multiplier 2) and the 256 discriminator on the
    ``meta`` device: every parameter and buffer name and shape equals what
    the JAX package's flax tree converts to."""
    want_g = _flax_shapes(jax_arch.StyleGAN2Generator(**FULL_G),
                          [jnp.zeros((1, 512))], randomize_noise=False)
    want_d = _flax_shapes(jax_arch.StyleGAN2Discriminator(**FULL_D),
                          jnp.zeros((1, 256, 256, 3)))
    with torch.device('meta'):
        net_g = build_network(dict(type='StyleGAN2Generator', **FULL_G))
        net_d = build_network(dict(type='StyleGAN2Discriminator', **FULL_D))
    got_g = {k: tuple(v.shape) for k, v in net_g.state_dict().items()}
    got_d = {k: tuple(v.shape) for k, v in net_d.state_dict().items()}
    assert got_g == want_g
    assert got_d == want_d
    assert got_g['style_convs.14.modulated_conv.weight'] == (1, 32, 64, 3, 3)
    assert got_g['constant_input.weight'] == (1, 512, 4, 4)
    assert got_g['to_rgbs.7.bias'] == (1, 3, 1, 1)
    assert got_g['noises.noise16'] == (1, 1, 1024, 1024)
    assert got_d['conv_body.1.conv2.1.weight'] == (256, 128, 3, 3)
    assert got_d['conv_body.1.skip.1.weight'] == (256, 128, 1, 1)
    assert got_d['final_linear.0.weight'] == (512, 8192)
    assert net_g.num_latent == 18 and net_g.num_layers == 17
    assert sum(v.numel() for k, v in net_g.named_parameters()) == 30370060


def test_seeded_init_is_reproducible_and_as_the_reference_starts():
    a = build_network(dict(type='StyleGAN2Generator', **G_OPT))
    b = build_network(dict(type='StyleGAN2Generator', **G_OPT))
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert float(a.style_conv1.weight) == 0
    assert float(a.style_conv1.activate.bias.abs().max()) == 0
    assert bool((a.style_conv1.modulated_conv.modulation.bias == 1).all())
    # style_mlp weights are N(0, 1) / lr_mul
    assert 50 < float(a.style_mlp[1].weight.std()) < 200


@pytest.mark.parametrize('shape', [(5, 8, 6, 3), (1, 8, 6, 3), (8, 6, 3),
                                   (16, 4, 4, 3), (4, 5, 5, 1)])
def test_tensor2img_matches_jax(shape):
    """Grid, ``min_max=(-1, 1)``, BGR, uint8, from a tensor and from a
    numpy array, bit for bit."""
    from mrefsr_tpu.utils import tensor2img as jax_tensor2img
    x = (np.random.RandomState(8).randn(*shape) * 0.8).astype(np.float32)
    want = jax_tensor2img(x, min_max=(-1, 1))
    for value in (torch.from_numpy(x), x):
        got = tensor2img(value, min_max=(-1, 1))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
