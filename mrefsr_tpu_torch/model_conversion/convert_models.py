"""Convert official third-party checkpoints into the reference's
(BasicSR-layout) keys, which the port's nets load strictly (port of
``scripts/model_conversion/convert_models.py``, the reference's)::

    python -m mrefsr_tpu_torch.model_conversion.convert_models esrgan \\
        --ori RRDB_ESRGAN_x4.pth --save ESRGAN_x4_official.pth
    python -m mrefsr_tpu_torch.model_conversion.convert_models duf \\
        --ori DUF_x4_52L_official.pth --save DUF_x4_52L.pth --num_layer 52

``esrgan``, ``edsr``, ``rcan``, ``edvr`` and ``duf``: each remaps the
official file's keys and writes ``{'params': state_dict}``.
"""
import argparse
import re

import torch


def _load(path):
    """The official file's state dict (unwrapped from ``params`` or
    ``state_dict``), read with ``weights_only``."""
    net = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(net, dict) and 'params' in net:
        net = net['params']
    if isinstance(net, dict) and 'state_dict' in net:
        net = net['state_dict']
    return net


def convert_esrgan(ori_path, save_path):
    """Old-arch ESRGAN (RRDB_ESRGAN_x4.pth) -> RRDBNet keys
    (reference convert_models.py:174-199)."""
    ori_net = _load(ori_path)
    out = {}
    for ori_k, v in ori_net.items():
        crt_k = (ori_k.replace('RRDB_trunk', 'body')
                 .replace('RDB', 'rdb')
                 .replace('trunk_conv', 'conv_body')
                 .replace('upconv', 'conv_up')
                 .replace('HRconv', 'conv_hr'))
        # inside an RRDB the dense blocks live under 'rdb<i>'
        out[crt_k] = v
    torch.save({'params': out}, save_path)
    print(f'saved {save_path} ({len(out)} tensors)')


def convert_edsr(ori_path, save_path, num_block=32):
    """Official EDSR-PyTorch -> EDSR keys
    (reference convert_models.py:102-135).

    head.0 -> conv_first; body.i.body.{0,2} -> body.i.conv{1,2};
    body.N -> conv_after_body; tail.0.{0,2} -> upsample.{0,2};
    tail.1 -> conv_last.
    """
    ori_net = _load(ori_path)
    out = {}
    for ori_k, v in ori_net.items():
        parts = ori_k.split('.')
        if ori_k.startswith('head.0'):
            crt_k = ori_k.replace('head.0', 'conv_first')
        elif ori_k.startswith(f'body.{num_block}.'):
            crt_k = ori_k.replace(f'body.{num_block}',
                                  'conv_after_body')
        elif ori_k.startswith('body.'):
            crt_k = (f'body.{parts[1]}.'
                     + {'0': 'conv1', '2': 'conv2'}[parts[3]]
                     + f'.{parts[4]}')
        elif ori_k.startswith('tail.0.0'):
            crt_k = ori_k.replace('tail.0.0', 'upsample.0')
        elif ori_k.startswith('tail.0.2'):
            crt_k = ori_k.replace('tail.0.2', 'upsample.2')
        elif ori_k.startswith('tail.1'):
            crt_k = ori_k.replace('tail.1', 'conv_last')
        else:
            print('unprocessed key', ori_k)
            continue
        out[crt_k] = v
    torch.save({'params': out}, save_path)
    print(f'saved {save_path} ({len(out)} tensors)')


def convert_rcan(ori_path, save_path, num_group=10, num_block=20):
    """Official RCAN -> RCAN keys (reference convert_models.py:138-171).

    body.g.body.b.body.{0,2} -> body.g.residual_group.b.rcab.{0,2};
    body.g.body.b.conv_du.{0,2} -> ...rcab.3.attention.{1,3};
    body.g.body.N -> body.g.conv; body.G -> conv_after_body.
    """
    ori_net = _load(ori_path)
    out = {}
    for ori_k, v in ori_net.items():
        parts = ori_k.split('.')
        if ori_k.startswith('head.0'):
            crt_k = ori_k.replace('head.0', 'conv_first')
        elif ori_k.startswith(f'body.{num_group}.'):
            crt_k = ori_k.replace(f'body.{num_group}', 'conv_after_body')
        elif ori_k.startswith('tail.0.0'):
            crt_k = ori_k.replace('tail.0.0', 'upsample.0')
        elif ori_k.startswith('tail.0.2'):
            crt_k = ori_k.replace('tail.0.2', 'upsample.2')
        elif ori_k.startswith('tail.1'):
            crt_k = ori_k.replace('tail.1', 'conv_last')
        elif ori_k.startswith('body.') and 'conv_du' in ori_k:
            g, b = parts[1], parts[3]
            du_idx = int(parts[5])
            crt_k = (f'body.{g}.residual_group.{b}.rcab.3.'
                     f'attention.{du_idx + 1}.{parts[6]}')
        elif ori_k.startswith('body.') and parts[4] == 'body':
            g, b = parts[1], parts[3]
            crt_k = (f'body.{g}.residual_group.{b}.rcab.'
                     f'{parts[5]}.{parts[6]}')
        elif ori_k.startswith('body.') and parts[2] == 'body' \
                and parts[3] == str(num_block):
            g = parts[1]
            crt_k = f'body.{g}.conv.{parts[4]}'
        else:
            print('unprocessed key', ori_k)
            continue
        out[crt_k] = v
    torch.save({'params': out}, save_path)
    print(f'saved {save_path} ({len(out)} tensors)')


def _edvr_key(ori_k):
    """Old official EDVR key -> BasicSR-layout key, or None if unknown.

    Inverse of the crt->ori rules in reference
    scripts/model_conversion/convert_models.py:4-99 (convert_edvr).
    """
    k = ori_k
    # --- predeblur module ---
    if k.startswith('pre_deblur.'):
        m = re.match(r'pre_deblur\.RB_L1_(\d+)\.(.*)', k)
        if m:  # RB_L1_{i+1} -> resblock_l1.{i} (reference :37-39)
            return f'predeblur.resblock_l1.{int(m.group(1)) - 1}.' \
                   + m.group(2)
        for ori, crt in (('conv_first_1', 'conv_first'),
                         ('conv_first_2', 'stride_conv_hr1'),
                         ('conv_first_3', 'stride_conv_hr2'),
                         ('deblur_L2_conv', 'stride_conv_l2'),
                         ('deblur_L3_conv', 'stride_conv_l3'),
                         ('RB_L3_1', 'resblock_l3'),
                         ('RB_L2_', 'resblock_l2_')):
            if f'pre_deblur.{ori}' in k:
                return k.replace(f'pre_deblur.{ori}', f'predeblur.{crt}')
        return None
    if 'fea_L2_conv' in k:  # reference :41-42
        return k.replace('fea_L2_conv', 'conv_l2_')
    if 'fea_L3_conv' in k:
        return k.replace('fea_L3_conv', 'conv_l3_')
    # --- PCD alignment (reference :47-68) ---
    m = re.match(r'pcd_align\.L(\d)_dcnpack\.(.*)', k)
    if m:
        name = m.group(2).replace('conv_offset_mask', 'conv_offset')
        return f'pcd_align.dcn_pack.l{m.group(1)}.{name}'
    m = re.match(r'pcd_align\.L(\d)_offset_conv(\d)\.(.*)', k)
    if m:
        return (f'pcd_align.offset_conv{m.group(2)}.l{m.group(1)}.'
                + m.group(3))
    m = re.match(r'pcd_align\.L(\d)_fea_conv\.(.*)', k)
    if m:
        return f'pcd_align.feat_conv.l{m.group(1)}.{m.group(2)}'
    if 'pcd_align.cas_dcnpack' in k:
        return k.replace('conv_offset_mask', 'conv_offset')
    # --- TSA fusion (reference :70-90); order matters: tAtt, add_, L,
    # then the bare sAtt_ ---
    if k.startswith('tsa_fusion.'):
        for ori, crt in (('tAtt_2', 'temporal_attn1'),
                         ('tAtt_1', 'temporal_attn2'),
                         ('fea_fusion', 'feat_fusion'),
                         ('sAtt_add_', 'spatial_attn_add'),
                         ('sAtt_L', 'spatial_attn_l'),
                         ('sAtt_', 'spatial_attn')):
            if ori in k:
                return k.replace(f'tsa_fusion.{ori}', f'fusion.{crt}')
        return k.replace('tsa_fusion.', 'fusion.')  # woTSA model (:89-90)
    if 'recon_trunk' in k:  # reference :83-86
        return k.replace('recon_trunk', 'reconstruction')
    if 'HRconv' in k:
        return k.replace('HRconv', 'conv_hr')
    if k.split('.')[0] in ('conv_first', 'feature_extraction', 'upconv1',
                           'upconv2', 'conv_last', 'conv_1x1') \
            or k.startswith('pcd_align.cas_offset_conv'):
        return k  # identity keys (reference :66-68)
    return None


def convert_edvr(ori_path, save_path):
    """Old official EDVR (e.g. EDVR_REDS_SR_M.pth) -> EDVR keys
    (reference convert_models.py:4-99)."""
    ori_net = _load(ori_path)
    out = {}
    for ori_k, v in ori_net.items():
        crt_k = _edvr_key(ori_k)
        if crt_k is None:
            print('unprocessed key', ori_k)
            continue
        out[crt_k] = v
    torch.save({'params': out}, save_path)
    print(f'saved {save_path} ({len(out)} tensors)')


def _duf_key(ori_k, num_layer):
    """Old official DUF key -> BasicSR-layout key, or None if unknown.

    Inverse of reference convert_models.py:202-341 (convert_duf_model):
    16-layer models name dense-block children bn3d_{k}/conv3d_{k}
    (k = 1..6, two per dense block: reference :274-305); 28/52-layer
    models use a flat Sequential dense_blocks.{i*6 + pos} (the
    commented variant, reference :215-224). Sequential slot: bn 0,
    conv 2, bn 3, conv 5 (relu 1/4 have no params).
    """
    k = ori_k
    m = re.match(r'dense_block_1\.(bn3d|conv3d)_(\d+)\.(.*)', k)
    if m and num_layer == 16:
        idx = int(m.group(2)) - 1  # 0-based; 2 per block
        block, within = idx // 2, idx % 2
        pos = {('bn3d', 0): 0, ('conv3d', 0): 2,
               ('bn3d', 1): 3, ('conv3d', 1): 5}[(m.group(1), within)]
        return f'dense_block1.dense_blocks.{block}.{pos}.{m.group(3)}'
    m = re.match(r'dense_block_1\.dense_blocks\.(\d+)\.(.*)', k)
    if m and num_layer in (28, 52):
        flat = int(m.group(1))
        return (f'dense_block1.dense_blocks.{flat // 6}.{flat % 6}.'
                + m.group(2))
    m = re.match(r'dense_block_2\.(bn3d|conv3d)_(\d+)\.(.*)', k)
    if m:  # temporal_reduce{j}: bn3d_{2j-1}->0, conv3d_{2j-1}->2,
        #       bn3d_{2j}->3, conv3d_{2j}->5 (reference :307-332)
        idx = int(m.group(2)) - 1
        j, within = idx // 2 + 1, idx % 2
        pos = {('bn3d', 0): 0, ('conv3d', 0): 2,
               ('bn3d', 1): 3, ('conv3d', 1): 5}[(m.group(1), within)]
        return f'dense_block2.temporal_reduce{j}.{pos}.{m.group(3)}'
    if k.startswith('conv3d_1.'):
        return k.replace('conv3d_1', 'conv3d1')
    if k.startswith('conv3d_2.'):
        return k.replace('conv3d_2', 'conv3d2')
    if k.startswith('bn3d_2.'):
        return k.replace('bn3d_2', 'bn3d2')
    if k.split('.')[0] in ('conv3d_r1', 'conv3d_r2', 'conv3d_f1',
                           'conv3d_f2'):
        return k  # identity keys
    return None


def convert_duf(ori_path, save_path, scale=4, num_layer=52):
    """Old official DUF -> DUF keys + conv3d_r2 channel regrouping
    (reference convert_models.py:202-357).

    The official residual head interleaves the 3 color channels
    (channel u*3 + c); BasicSR's group them (channel c*r2 + u) to
    feed pixel_shuffle — reference :342-356 performs exactly this
    ::3-stride regroup on conv3d_r2 weight and bias.
    """
    ori_net = _load(ori_path)
    out = {}
    for ori_k, v in ori_net.items():
        crt_k = _duf_key(ori_k, num_layer)
        if crt_k is None:
            print('unprocessed key', ori_k)
            continue
        out[crt_k] = v
    r2 = scale ** 2
    for name in ('conv3d_r2.weight', 'conv3d_r2.bias'):
        x = out[name]
        if x.shape[0] != 3 * r2:
            raise ValueError(f'{name}: expected {3 * r2} out channels, got '
                             f'{x.shape[0]}')
        out[name] = torch.cat([x[0::3], x[1::3], x[2::3]], dim=0)
    torch.save({'params': out}, save_path)
    print(f'saved {save_path} ({len(out)} tensors)')


CONVERTERS = {'esrgan': convert_esrgan, 'edsr': convert_edsr,
              'rcan': convert_rcan, 'edvr': convert_edvr,
              'duf': convert_duf}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('model', choices=sorted(CONVERTERS))
    parser.add_argument('--ori', type=str, required=True,
                        help='official checkpoint path')
    parser.add_argument('--save', type=str, required=True)
    parser.add_argument('--scale', type=int, default=4,
                        help='duf: upscale factor of the checkpoint')
    parser.add_argument('--num_layer', type=int, default=52,
                        help='duf: 16 / 28 / 52 layer variant')
    args = parser.parse_args(argv)
    if args.model == 'duf':
        convert_duf(args.ori, args.save, scale=args.scale,
                    num_layer=args.num_layer)
    else:
        CONVERTERS[args.model](args.ori, args.save)


if __name__ == '__main__':
    main()
