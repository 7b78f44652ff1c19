"""The port's converters of published checkpoints against the JAX
package's scripts (``scripts/model_conversion/``) on the CPU.

Each official-layout state dict is made from a seeded port net by
inverting the converter's key rules (the test's own maps), so that a
converter that undoes them recovers the net's state dict. Then:

* the port's converter (through its ``main``) and the JAX script's give
  the same keys and the same tensors, which are the seeded net's own, and
  load strictly into the port's net;
* where the net is small enough to run here, the port's net on the
  converted file and the JAX net on the same file (through
  ``torch_to_flax``, as the JAX package loads a ``.pth``) agree on one
  input within 1e-5 of the output's largest entry: RRDBNet, EDSR and RCAN
  at tiny widths (the CLI's fixed depths, EDSR 32 blocks, RCAN 10 groups
  of 20, are converted and loaded; the forward runs the functions at 2
  blocks), RIDNet at its published width.

``convert_dcn_to_flow``: the port's CLI and the JAX script on a
DCN-alignment MRAPA checkpoint (``params``, ``params_ema`` and an
iteration count) write the same file, which loads strictly into the
port's flow-alignment net. EDVR and DUF are in
``test_torch_converters_video.py``.
"""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs.edsr_arch import EDSR as JaxEDSR
from mrefsr_tpu.archs.rcan_arch import RCAN as JaxRCAN
from mrefsr_tpu.archs.ridnet_arch import RIDNet as JaxRIDNet
from mrefsr_tpu.archs.rrdbnet_arch import RRDBNet as JaxRRDBNet
from mrefsr_tpu.convert import torch_to_flax
from mrefsr_tpu_torch.archs.edsr_arch import EDSR
from mrefsr_tpu_torch.archs.rcan_arch import RCAN
from mrefsr_tpu_torch.archs.ridnet_arch import RIDNet
from mrefsr_tpu_torch.archs.rrdbnet_arch import RRDBNet
from mrefsr_tpu_torch.model_conversion import (convert_dcn_to_flow,
                                               convert_models,
                                               convert_ridnet)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_script(name):
    """The JAX package's ``scripts/model_conversion/<name>.py`` as a
    module."""
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(REPO, 'scripts', 'model_conversion',
                                    f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def seeded(net, seed):
    """``net`` with every float entry of its state dict N(0, 0.1) from
    ``seed`` (running variances |.| + 0.5)."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, value in net.state_dict().items():
        if value.is_floating_point():
            value = torch.randn(value.shape, generator=gen) * 0.1
            if key.endswith('running_var'):
                value = value.abs() + 0.5
        state[key] = value
    net.load_state_dict(state, strict=True)
    return net


def convert_both(tmp_path, model, official, port_kwargs=None,
                 jax_kwargs=None):
    """``official`` saved, then converted by the port's ``main`` and the
    JAX script's function; returns both ``params`` dicts."""
    ori = str(tmp_path / f'{model}_official.pth')
    torch.save(official, ori)
    port_out, jax_out = (str(tmp_path / f'{model}_{who}.pth')
                         for who in ('port', 'jax'))
    convert_models.main([model, '--ori', ori, '--save', port_out,
                         *(port_kwargs or [])])
    jax_script('convert_models').CONVERTERS[model](ori, jax_out,
                                                   **(jax_kwargs or {}))
    return tuple(torch.load(p, weights_only=True)['params']
                 for p in (port_out, jax_out))


def assert_same(got, want):
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def jax_output(module, state, x):
    variables = torch_to_flax({k: v.numpy() for k, v in state.items()})
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    return np.asarray(jax.jit(module.apply)(variables, jnp.asarray(x)))


def port_output(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()


def close(got, want):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err


def _esrgan_official(state):
    out = {}
    for key, value in state.items():
        if key.startswith('body.'):
            key = 'RRDB_trunk.' + key[len('body.'):].replace('.rdb', '.RDB')
        key = (key.replace('conv_body', 'trunk_conv')
               .replace('conv_up', 'upconv').replace('conv_hr', 'HRconv'))
        out[key] = value
    return out


def test_esrgan(tmp_path):
    kwargs = dict(scale=4, num_feat=4, num_block=2, num_grow_ch=2)
    net = seeded(RRDBNet(3, 3, **kwargs).eval(), 0)
    official = _esrgan_official(net.state_dict())
    got, want = convert_both(tmp_path, 'esrgan', official)
    assert_same(got, want)
    assert_same(got, net.state_dict())
    converted = RRDBNet(3, 3, **kwargs).eval()
    converted.load_state_dict(got, strict=True)
    x = np.random.RandomState(1).rand(1, 8, 8, 3).astype(np.float32)
    close(port_output(converted, x),
          jax_output(JaxRRDBNet(3, 3, **kwargs), got, x))


def _edsr_official(state, num_block):
    out = {}
    for key, value in state.items():
        parts = key.split('.')
        if key.startswith('conv_first'):
            key = key.replace('conv_first', 'head.0')
        elif key.startswith('conv_after_body'):
            key = key.replace('conv_after_body', f'body.{num_block}')
        elif key.startswith('body.'):
            key = f'body.{parts[1]}.body.' \
                  f'{ {"conv1": 0, "conv2": 2}[parts[2]] }.{parts[3]}'
        elif key.startswith('upsample.'):
            key = key.replace('upsample.', 'tail.0.')
        elif key.startswith('conv_last'):
            key = key.replace('conv_last', 'tail.1')
        out[key] = value
    return out


def test_edsr(tmp_path):
    # the CLI's EDSR has 32 blocks (EDSR-L's depth)
    net = seeded(EDSR(num_feat=4, num_block=32, upscale=4), 2)
    got, want = convert_both(tmp_path, 'edsr',
                             _edsr_official(net.state_dict(), 32))
    assert_same(got, want)
    assert_same(got, net.state_dict())
    # at 2 blocks through the functions, and the JAX net's output
    kwargs = dict(num_feat=4, num_block=2, upscale=2)
    net = seeded(EDSR(**kwargs), 3)
    ori, port, jax_path = (str(tmp_path / n) for n in ('o', 'p', 'j'))
    torch.save(_edsr_official(net.state_dict(), 2), ori)
    convert_models.convert_edsr(ori, port, num_block=2)
    jax_script('convert_models').convert_edsr(ori, jax_path, num_block=2)
    got = torch.load(port, weights_only=True)['params']
    assert_same(got, torch.load(jax_path, weights_only=True)['params'])
    converted = EDSR(**kwargs)
    converted.load_state_dict(got, strict=True)
    x = np.random.RandomState(4).rand(1, 8, 8, 3).astype(np.float32) * 255
    close(port_output(converted, x), jax_output(JaxEDSR(**kwargs), got, x))


def _rcan_official(state, num_group, num_block):
    out = {}
    for key, value in state.items():
        parts = key.split('.')
        if key.startswith('conv_first'):
            key = key.replace('conv_first', 'head.0')
        elif key.startswith('conv_after_body'):
            key = key.replace('conv_after_body', f'body.{num_group}')
        elif key.startswith('upsample.'):
            key = key.replace('upsample.', 'tail.0.')
        elif key.startswith('conv_last'):
            key = key.replace('conv_last', 'tail.1')
        elif 'attention' in key:        # body.g.residual_group.b.rcab.3...
            key = f'body.{parts[1]}.body.{parts[3]}.conv_du.' \
                  f'{int(parts[7]) - 1}.{parts[8]}'
        elif 'rcab' in key:
            key = f'body.{parts[1]}.body.{parts[3]}.body.{parts[5]}.' \
                  f'{parts[6]}'
        else:                           # body.g.conv
            key = f'body.{parts[1]}.body.{num_block}.{parts[3]}'
        out[key] = value
    return out


def test_rcan(tmp_path):
    # the CLI's RCAN has 10 groups of 20 blocks
    net = seeded(RCAN(num_feat=4, num_group=10, num_block=20,
                      squeeze_factor=2, upscale=4), 5)
    got, want = convert_both(tmp_path, 'rcan',
                             _rcan_official(net.state_dict(), 10, 20))
    assert_same(got, want)
    assert_same(got, net.state_dict())
    kwargs = dict(num_feat=4, num_group=2, num_block=2, squeeze_factor=2,
                  upscale=2)
    net = seeded(RCAN(**kwargs), 6)
    ori, port, jax_path = (str(tmp_path / n) for n in ('o', 'p', 'j'))
    torch.save(_rcan_official(net.state_dict(), 2, 2), ori)
    convert_models.convert_rcan(ori, port, num_group=2, num_block=2)
    jax_script('convert_models').convert_rcan(ori, jax_path, num_group=2,
                                              num_block=2)
    got = torch.load(port, weights_only=True)['params']
    assert_same(got, torch.load(jax_path, weights_only=True)['params'])
    converted = RCAN(**kwargs)
    converted.load_state_dict(got, strict=True)
    x = np.random.RandomState(7).rand(1, 8, 8, 3).astype(np.float32) * 255
    close(port_output(converted, x), jax_output(JaxRCAN(**kwargs), got, x))


def test_ridnet(tmp_path):
    """The official file's tensors under names of its own, in the
    reference's order; the JAX script's order (spelled out, checked
    against its flax net) is the port's."""
    net = seeded(RIDNet(3, 64, 3), 8)
    official = {f'official_{i}': v
                for i, v in enumerate(net.state_dict().values())}
    jax_module = jax_script('convert_ridnet')
    names = jax_module.ridnet_key_order()
    assert convert_ridnet.ridnet_key_order() == names
    ori, save = str(tmp_path / 'ori.pt'), str(tmp_path / 'RIDNet.pth')
    torch.save(official, ori)
    convert_ridnet.main(['--ori', ori, '--save', save])
    got = torch.load(save, weights_only=True)['params']
    assert_same(got, jax_module.convert_ridnet(official, names))
    assert_same(got, net.state_dict())
    with pytest.raises(ValueError, match='tensors'):
        convert_ridnet.convert_ridnet(dict(list(official.items())[:-1]),
                                      names)
    converted = RIDNet(3, 64, 3)
    converted.load_state_dict(got, strict=True)
    x = np.random.RandomState(9).rand(1, 12, 12, 3).astype(np.float32) * 255
    close(port_output(converted, x), jax_output(JaxRIDNet(3, 64, 3), got, x))


def test_dcn_to_flow(tmp_path, monkeypatch):
    from mrefsr_tpu_torch.archs.ref_mrapa_restoration_arch import \
        MRAPARestorationNet
    net = seeded(MRAPARestorationNet(ngf=8, n_blocks=1, groups=2), 10)
    flow_net = MRAPARestorationNet(ngf=8, n_blocks=1, groups=2,
                                   alignment='flow')
    state = net.state_dict()
    ckpt = {'params': state, 'params_ema': {k: v * 2 for k, v in
                                            state.items()}, 'iter': 7}
    src = str(tmp_path / 'dcn.pth')
    torch.save(ckpt, src)
    outs = {who: str(tmp_path / f'flow_{who}.pth') for who in ('port',
                                                              'jax')}
    convert_dcn_to_flow.main(['--input', src, '--output', outs['port'],
                              '--deform-groups', '2'])
    monkeypatch.setattr(sys, 'argv', ['convert_dcn_to_flow', '--input', src,
                                      '--output', outs['jax'],
                                      '--deform-groups', '2'])
    jax_script('convert_dcn_to_flow').main()
    got, want = (torch.load(p, weights_only=True) for p in outs.values())
    assert list(got) == list(want) == ['params', 'params_ema', 'iter']
    assert got['iter'] == 7
    for key in ('params', 'params_ema'):
        assert_same(got[key], want[key])
        flow_net.load_state_dict(got[key], strict=True)
    bare = convert_dcn_to_flow.convert_checkpoint(state, 2)
    assert_same(bare, got['params'])
