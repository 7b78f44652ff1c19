"""``convert_models`` ``edvr`` and ``duf`` in the port against the JAX
package's script on the CPU, as ``test_torch_converters.py`` holds the
others: an official-layout state dict made from a seeded port net by
inverting the converter's key rules; the port's CLI and the JAX script
give the net's own state dict back, key for key and tensor for tensor; it
loads strictly into the port's net; and the port's net and the JAX net on
the converted file agree on one input within 1e-4 of the output's largest
entry (the deformable convs sample between pixels): EDVR with the
pre-deblurring module on a 4x input and TSA at num_feat 8; EDVR without
TSA by keys; DUF-16L (the dense blocks' per-layer names, the residual
head's channels regrouped from the official interleaving) and DUF-52L
(one flat sequence of dense layers) by keys, DUF-16L's output too.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs.duf_arch import DUF as JaxDUF
from mrefsr_tpu.archs.edvr_arch import EDVR as JaxEDVR
from mrefsr_tpu.convert import torch_to_flax
from mrefsr_tpu_torch.archs.duf_arch import DUF
from mrefsr_tpu_torch.archs.edvr_arch import EDVR
from test_torch_converters import assert_same, convert_both, seeded

TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


_EDVR_TSA = (('temporal_attn1', 'tAtt_2'), ('temporal_attn2', 'tAtt_1'),
             ('feat_fusion', 'fea_fusion'), ('spatial_attn_add', 'sAtt_add_'),
             ('spatial_attn_l', 'sAtt_L'), ('spatial_attn', 'sAtt_'))
_EDVR_PREDEBLUR = (('conv_first', 'conv_first_1'),
                   ('stride_conv_hr1', 'conv_first_2'),
                   ('stride_conv_hr2', 'conv_first_3'),
                   ('stride_conv_l2', 'deblur_L2_conv'),
                   ('stride_conv_l3', 'deblur_L3_conv'),
                   ('resblock_l3', 'RB_L3_1'), ('resblock_l2_', 'RB_L2_'))


def _edvr_official_key(key):
    m = re.match(r'predeblur\.resblock_l1\.(\d+)\.(.*)', key)
    if m:
        return f'pre_deblur.RB_L1_{int(m.group(1)) + 1}.{m.group(2)}'
    if key.startswith('predeblur.'):
        for crt, ori in _EDVR_PREDEBLUR:
            if key.startswith(f'predeblur.{crt}'):
                return key.replace(f'predeblur.{crt}', f'pre_deblur.{ori}')
    m = re.match(r'conv_l([23])_(\d)\.(.*)', key)
    if m:
        return f'fea_L{m.group(1)}_conv{m.group(2)}.{m.group(3)}'
    m = re.match(r'pcd_align\.dcn_pack\.l(\d)\.(.*)', key)
    if m:
        return f'pcd_align.L{m.group(1)}_dcnpack.' + m.group(2).replace(
            'conv_offset', 'conv_offset_mask')
    m = re.match(r'pcd_align\.offset_conv(\d)\.l(\d)\.(.*)', key)
    if m:
        return f'pcd_align.L{m.group(2)}_offset_conv{m.group(1)}.' \
               f'{m.group(3)}'
    m = re.match(r'pcd_align\.feat_conv\.l(\d)\.(.*)', key)
    if m:
        return f'pcd_align.L{m.group(1)}_fea_conv.{m.group(2)}'
    if key.startswith('pcd_align.cas_dcnpack.'):
        return key.replace('conv_offset', 'conv_offset_mask')
    if key.startswith('fusion.'):
        for crt, ori in _EDVR_TSA:
            if key.startswith(f'fusion.{crt}'):
                return key.replace(f'fusion.{crt}', f'tsa_fusion.{ori}')
        return key.replace('fusion.', 'tsa_fusion.')
    return key.replace('reconstruction', 'recon_trunk').replace(
        'conv_hr', 'HRconv')


def _frames(seed, b, t, h, w):
    rng = np.random.RandomState(seed)
    base = rng.rand(b, h + 8, w + 8, 3).astype(np.float32)
    base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)) / 3
    return np.stack([base[:, i:i + h, 2 * i % 5:2 * i % 5 + w]
                     for i in range(t)], axis=1)


def _close(got, want):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err


@pytest.mark.parametrize('tsa', [True, False])
def test_edvr(tmp_path, tsa):
    kwargs = dict(num_feat=8, num_frame=5, deformable_groups=2,
                  num_extract_block=1, num_reconstruct_block=1,
                  with_tsa=tsa, with_predeblur=tsa, hr_in=tsa)
    net = seeded(EDVR(**kwargs).eval(), 11)
    official = {_edvr_official_key(k): v for k, v in net.state_dict().items()}
    got, want = convert_both(tmp_path, 'edvr', official)
    assert_same(got, want)
    assert_same(got, net.state_dict())
    converted = EDVR(**kwargs).eval()
    converted.load_state_dict(got, strict=True)
    if not tsa:
        return
    x = _frames(12, 1, 5, 64, 64)
    variables = torch_to_flax({k: v.numpy() for k, v in got.items()})
    jax_out = np.asarray(jax.jit(JaxEDVR(**kwargs).apply)(variables,
                                                         jnp.asarray(x)))
    with torch.no_grad():
        out = converted(torch.from_numpy(x).permute(0, 1, 4, 2, 3))
    _close(out.permute(0, 2, 3, 1).numpy(), jax_out)


# (kind, slot within the dense layer pair): the official per-layer names
_DUF_SLOTS = {0: ('bn3d', 0), 2: ('conv3d', 0), 3: ('bn3d', 1),
              5: ('conv3d', 1)}


def _duf_official(state, num_layer, scale=4):
    out = {}
    for key, value in state.items():
        m = re.match(r'dense_block1\.dense_blocks\.(\d+)\.(\d)\.(.*)', key)
        n = re.match(r'dense_block2\.temporal_reduce(\d)\.(\d)\.(.*)', key)
        if m and num_layer == 16:
            kind, within = _DUF_SLOTS[int(m.group(2))]
            key = f'dense_block_1.{kind}_{int(m.group(1)) * 2 + within + 1}' \
                  f'.{m.group(3)}'
        elif m:
            key = f'dense_block_1.dense_blocks.' \
                  f'{int(m.group(1)) * 6 + int(m.group(2))}.{m.group(3)}'
        elif n:
            kind, within = _DUF_SLOTS[int(n.group(2))]
            layer = (int(n.group(1)) - 1) * 2 + within + 1
            key = f'dense_block_2.{kind}_{layer}.{n.group(3)}'
        else:
            key = key.replace('conv3d1', 'conv3d_1').replace(
                'conv3d2', 'conv3d_2').replace('bn3d2', 'bn3d_2')
            if key.startswith('conv3d_r2.'):
                # the official head interleaves the colours: u * 3 + c
                r2 = scale ** 2
                value = value.reshape(3, r2, *value.shape[1:]).transpose(
                    0, 1).reshape(value.shape)
        out[key] = value
    return out


@pytest.mark.parametrize('num_layer', [16, 52])
def test_duf(tmp_path, num_layer):
    net = seeded(DUF(scale=4, num_layer=num_layer).eval(), 13)
    official = _duf_official(net.state_dict(), num_layer)
    got, want = convert_both(
        tmp_path, 'duf', official,
        port_kwargs=['--num_layer', str(num_layer), '--scale', '4'],
        jax_kwargs={'num_layer': num_layer, 'scale': 4})
    assert_same(got, want)
    assert_same(got, net.state_dict())
    converted = DUF(scale=4, num_layer=num_layer).eval()
    converted.load_state_dict(got, strict=True)
    if num_layer != 16:
        return
    x = _frames(14, 1, 7, 12, 16)
    variables = torch_to_flax({k: v.numpy() for k, v in got.items()})
    jax_out = np.asarray(jax.jit(JaxDUF(scale=4, num_layer=16).apply)(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        out = converted(torch.from_numpy(x).permute(0, 1, 4, 2, 3))
    _close(out.permute(0, 2, 3, 1).numpy(), jax_out)
