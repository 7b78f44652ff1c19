"""TOFlow (both frame orders; its norms in eval and in training mode), DUF
at 16 layers (both eps), its dynamic upsampling filter and
``VGGStyleDiscriminator`` (input 160) against the JAX package's on the
CPU: the same seeded flax variables (the norms' statistics seeded too) go
into the port through ``convert``, strictly, and the same inputs through
both; the output, every parameter's gradient of ``sum(out * cot)``
(``jax.grad``) and in training mode the running statistics the norms
write are held to the JAX package's within the
tolerances ``test_torch_video_zoo.py`` states."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs import discriminator_arch as jax_disc
from mrefsr_tpu.archs import duf_arch as jax_duf
from mrefsr_tpu.archs import tof_arch as jax_tof
from mrefsr_tpu_torch.archs import discriminator_arch, duf_arch, tof_arch
from mrefsr_tpu_torch.convert import (
    vgg_style_discriminator_state_dict_from_flax)
from test_torch_video_zoo import (check_pair, close, nhwc,
                                  params_by_torch_names, port_net,
                                  seeded_variables, smooth_frames)


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize('official,train', [(False, False), (True, True)],
                         ids=['eval', 'official_train'])
def test_toflow_matches_jax(official, train):
    """Seven 32 x 48 frames, each frame order: in eval mode the norms take
    their running statistics (forward), in training mode their batch's and
    write them six times, once a frame (forward, gradients, statistics)."""
    x = smooth_frames(10, 2, 7, 32, 48)
    jax_net = jax_tof.TOFlow(adapt_official_weights=official)
    variables = params_by_torch_names(
        tof_arch.TOFlow, 11, adapt_official_weights=official)
    net = port_net(tof_arch.TOFlow, variables, adapt_official_weights=official)
    check_pair(jax_net, variables, x, net, (2, 32, 48, 3), train=train,
                grads=train)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('official', [False, True])
def test_duf_matches_jax(official, train):
    """DUF-16L on seven 12 x 16 frames (eps 1e-3 with the official
    weights, else 1e-5): the 3-D dense blocks, the temporal reduction, the
    softmaxed filter bank over 25 taps and the pixel shuffle. The
    gradients in training mode at eps 1e-3: at eps 1e-5 one channel of
    ``temporal_reduce1``'s second norm has a batch variance next to 0, and
    its gradients through the batch statistics differ by 3.3 % of their
    largest entry between two f32 summation orders (that case holds the
    output and the statistics)."""
    x = smooth_frames(12, 2, 7, 12, 16)
    kwargs = dict(scale=4, num_layer=16, adapt_official_weights=official)
    jax_net = jax_duf.DUF(**kwargs)
    variables = seeded_variables(jax_net, (jnp.asarray(x),), 13)
    net = port_net(duf_arch.DUF, variables, **kwargs)
    assert net.bn3d2.eps == (1e-3 if official else 1e-5)
    check_pair(jax_net, variables, x, net, (2, 48, 64, 3), train=train,
                grads=official or not train)


def test_dynamic_upsampling_filter_matches_jax():
    rng = np.random.RandomState(14)
    x = rng.rand(2, 6, 7, 3).astype(np.float32)
    filt = rng.rand(2, 6, 7, 25, 4).astype(np.float32)
    want = jax_duf.dynamic_upsampling_filter(jnp.asarray(x),
                                             jnp.asarray(filt))
    got = duf_arch.dynamic_upsampling_filter(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(filt).permute(0, 3, 4, 1, 2))
    close(nhwc(got), want, 1e-6, 'filtered')


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_vgg_style_discriminator_matches_jax(train):
    """num_feat 4 on two 160 x 160 images: ``linear1`` reads the NCHW
    flatten, its flax kernel (NHWC flatten) permuted by the converter."""
    x = np.random.RandomState(15).rand(2, 160, 160, 3).astype(np.float32)
    jax_net = jax_disc.VGGStyleDiscriminator(num_in_ch=3, num_feat=4,
                                             input_size=160)
    variables = seeded_variables(jax_net, (jnp.asarray(x),), 16)
    net = port_net(discriminator_arch.VGGStyleDiscriminator, variables,
                state_fn=vgg_style_discriminator_state_dict_from_flax,
                num_in_ch=3, num_feat=4, input_size=160)
    assert net.linear1.in_features == 4 * 8 * 5 * 5
    check_pair(jax_net, variables, x, net, (2, 1), train=train,
                linear_channels=32)
    with pytest.raises(ValueError, match='input size must be 160'):
        net(torch.zeros((1, 3, 128, 128)))


