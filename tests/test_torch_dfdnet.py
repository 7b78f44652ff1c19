"""DFDNet in the port against the JAX package on the CPU:

* the part sampling (``crop_resize_bilinear``) and the paste
  (``paste_indices`` against the JAX package's ``paste_nearest``, its
  full map and its inside mask) for boxes inside the map, on its edges,
  partly and wholly outside it;
* ``swap_feat`` against the JAX package's ``_swap_feat`` (its masked
  full-map attention convs) at those boxes, on an 8-channel map with a
  5-atom dictionary of 6 x 7 atoms;
* the whole ``DFDNet`` (``num_feat`` 64, the only width whose SFT blocks
  fit the VGG taps) forward on one 512 x 512 face with its landmarks' part
  boxes and a seeded dictionary of 4 atoms a part and scale, at 512-space
  sides eyes 80, nose 96, mouth 128 (40, 20, 10, 5 / 48, 24, 12, 6 / 64,
  32, 16, 8 at the four scales);
* ``inference_dfdnet.main`` on ``--device cpu`` with ``.npy`` landmarks,
  a saved dictionary and a saved ``.pth``; ``get_part_location`` against
  the JAX script's;
* the DFDNet converter: an official-layout checkpoint made from the
  port's layout by the official names, through the port's converter and
  the JAX package's script: equal to each other and to the port's state.

The atom is the argmax of the softmaxed correlations, so the dictionaries
are built with a clear winner: at each part and scale one atom (not the
first) is the part's own sampled features, the others N(0, 1). AdaIN
gives every atom the part's channel means and deviations, so the scores
share the means' term and differ in the rest: the top score leads the
second by at least ``GAP_SHARE`` (1e-3) of itself, measured 2.0e-3 at
the least (the whole net's 5 x 5 atoms of conv5_4), where the two
frameworks' f32 scores differ in the sixth digit. The outputs agree to
1e-4 of their largest entry (measured 3.0e-6 for the whole net, 1.1e-6
for a swap); the samplings and pastes bit for bit. The flax variables
are ``test_torch_hifacegan.py``'s seeded ones.
"""
import os
import runpy

import cv2
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mrefsr_tpu.archs import dfdnet_arch as jax_dfdnet
from mrefsr_tpu_torch.archs import dfdnet_arch
from mrefsr_tpu_torch.archs.dfdnet_util import adaptive_instance_normalization
from mrefsr_tpu_torch.convert import state_dict_from_flax_variables
from mrefsr_tpu_torch.inference import inference_dfdnet
from mrefsr_tpu_torch.model_conversion import convert_dfdnet
from test_torch_hifacegan import _seeded_variables
from test_torch_video_zoo import close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_TOL, GAP_SHARE = 1e-4, 1e-3
PART_SIDES = {'left_eye': 80, 'right_eye': 80, 'nose': 96, 'mouth': 128}
ATOMS, PLANTED = 4, 2


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# (y0, x0, y1, x1) on a 20 x 24 map: inside, on the edges, partly outside
# at the top left and at the bottom right, wholly outside
BOXES = [(3, 5, 11, 17), (0, 0, 20, 24), (-4, -3, 6, 9), (14, 18, 26, 30),
         (22, 2, 30, 9)]


@pytest.mark.parametrize('box', BOXES)
def test_crop_and_paste_helpers(box):
    """The sampling of a box at 6 x 7 and the atom's paste, against the
    JAX package's coordinate sampling and masked inverse warp, bit for
    bit; inside the map the sampling is ``F.interpolate`` of the crop."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 20, 24, 3).astype(np.float32)
    want = jax_dfdnet.crop_resize_bilinear(jnp.asarray(x), jnp.asarray(box),
                                           (6, 7))
    got = dfdnet_arch.crop_resize_bilinear(_nchw(x), box, (6, 7))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    y0, x0, y1, x1 = box
    if y0 >= 0 and x0 >= 0 and y1 <= 20 and x1 <= 24:
        plain = torch.nn.functional.interpolate(
            _nchw(x)[:, :, y0:y1, x0:x1], size=(6, 7), mode='bilinear',
            align_corners=False)
        close(got, plain, 1e-6, 'against F.interpolate')
    atom = rng.randn(6, 7, 3).astype(np.float32)
    full, mask = jax_dfdnet.paste_nearest(jnp.asarray(atom),
                                          jnp.asarray(box), (20, 24))
    where = dfdnet_arch.paste_indices(box, (6, 7), (20, 24))
    mine_full = np.zeros((1, 20, 24, 3), np.float32)
    mine_mask = np.zeros((1, 20, 24, 1), bool)
    if where is not None:
        (rows, iy), (cols, ix) = where
        mine_full[0, rows, cols] = atom[iy.numpy()][:, ix.numpy()]
        mine_mask[0, rows, cols] = True
    np.testing.assert_array_equal(mine_mask, np.asarray(mask))
    np.testing.assert_array_equal(mine_full, np.asarray(full))


class _JaxSwap(flax_nn.Module):
    """The JAX package's ``_swap_feat`` of one part at scale 32 with its
    attention block ``attn_blocks.left_eye_32``."""
    channels: int

    @flax_nn.compact
    def __call__(self, vgg_feat, dict_feat, location):
        return jax_dfdnet.DFDNet._swap_feat(
            self, jax_dfdnet._AttnBlocks(name='attn_blocks'), vgg_feat,
            vgg_feat, dict_feat, location, 'left_eye', 32, self.channels)


def _planted_dictionary(rng, query, shape, index=PLANTED):
    """``ATOMS`` N(0, 1) atoms of ``shape`` (K, C, h, w), atom ``index``
    the query's own features (1, C, h, w)."""
    atoms = rng.randn(*shape).astype(np.float32)
    atoms[index] = query[0]
    return torch.from_numpy(atoms)


def _gap_share(query, atoms):
    """The top correlation's lead over the second as a share of the top
    (the softmax is monotonic), and the top's index."""
    sims = torch.einsum('chw,kchw->k', query[0],
                        adaptive_instance_normalization(atoms, query))
    top2 = torch.topk(sims, 2).values
    return float((top2[0] - top2[1]) / top2[0].abs()), int(sims.argmax())


@pytest.mark.parametrize('box', BOXES)
def test_swap_feat(box):
    """``swap_feat`` on an (1, 8, 20, 24) map against the JAX package's,
    from the same attention block's variables; a box wholly outside leaves
    the features as they were."""
    rng = np.random.RandomState(1)
    feat = np.abs(rng.randn(1, 20, 24, 8)).astype(np.float32)
    query = dfdnet_arch.crop_resize_bilinear(_nchw(feat), box, (6, 7))
    atoms = _planted_dictionary(rng, query.numpy(), (5, 8, 6, 7))
    share, top = _gap_share(query, atoms)
    assert top == PLANTED and share >= GAP_SHARE, share
    y0, x0, y1, x1 = box
    location = np.asarray([x0, y0, x1, y1], np.int32)
    module = _JaxSwap(8)
    dict_nhwc = atoms.permute(0, 2, 3, 1).numpy()
    variables = _seeded_variables(module, [feat, dict_nhwc, location], 2)
    want = jax.jit(module.apply)(variables, feat, dict_nhwc, location)
    holder = nn.Module()
    holder.attn_blocks = nn.ModuleDict(
        {'left_eye_32': dfdnet_arch._sn_pair(8, 8)})
    holder.load_state_dict(state_dict_from_flax_variables(variables),
                           strict=True)
    holder.eval()
    with torch.no_grad():
        got = dfdnet_arch.DFDNet.swap_feat(
            holder, _nchw(feat), _nchw(feat), atoms, location, 'left_eye',
            32)
    close(_nhwc(got), want, OUT_TOL, f'swap {box}')
    if dfdnet_arch.paste_indices(box, (6, 7), (20, 24)) is None:
        assert torch.equal(got, _nchw(feat))


# --------------------------------------------------------------- whole net
def _landmarks(rng):
    """68 points of a frontal face in 512-space: brows, eyes, nose, mouth,
    jaw about their usual places, jittered."""
    pts = np.zeros((68, 2))
    for idx, centre in ((range(17, 22), (180, 190)),
                        (range(36, 42), (180, 210)),
                        (range(22, 27), (330, 190)),
                        (range(42, 48), (330, 210)),
                        (range(27, 36), (256, 290)),
                        (range(48, 68), (256, 380)),
                        (range(0, 17), (256, 300))):
        for i in idx:
            pts[i] = np.asarray(centre) + rng.randn(2) * 12
    return pts


def _face_dictionary(net, x, locations, rng):
    """A dictionary whose atom ``PLANTED`` is each part's own sampled VGG
    features at each scale (``PART_SIDES`` in 512-space, ``ATOMS`` atoms)
    and the smallest lead of a top score over the second."""
    with torch.no_grad():
        feats = net.vgg_extractor(x)
    face_dict, shares = {}, []
    for layer, size in zip(dfdnet_arch.VGG_LAYERS,
                           dfdnet_arch.FEATURE_SIZES):
        face_dict[str(size)] = {}
        for part_idx, part in enumerate(dfdnet_arch.PARTS):
            side = PART_SIDES[part] * size // 512
            x0, y0, x1, y1 = [int(v) // (512 // size)
                              for v in locations[part_idx][0]]
            query = dfdnet_arch.crop_resize_bilinear(
                feats[layer], (y0, x0, y1, x1), (side, side))
            atoms = _planted_dictionary(
                rng, query.numpy(), (ATOMS, query.shape[1], side, side))
            share, top = _gap_share(query, atoms)
            assert top == PLANTED, (size, part)
            shares.append(share)
            face_dict[str(size)][part] = atoms
    return face_dict, min(shares)


def test_dfdnet_forward_at_512():
    """The whole net on a 512 x 512 face against the JAX package's, from
    the same variables and dictionary."""
    rng = np.random.RandomState(2)
    x = (rng.rand(1, 512, 512, 3) * 2 - 1).astype(np.float32)
    locations = inference_dfdnet.get_part_location(_landmarks(rng))
    with torch.device('meta'):
        net = dfdnet_arch.DFDNet(64)
    net.to_empty(device='cpu')
    module = jax_dfdnet.DFDNet(num_feat=64)
    dummy = {str(s): {p: np.zeros((ATOMS, PART_SIDES[p] * s // 512,
                                   PART_SIDES[p] * s // 512, c), np.float32)
                      for p in dfdnet_arch.PARTS}
             for s, c in zip(dfdnet_arch.FEATURE_SIZES,
                             dfdnet_arch.CHANNEL_SIZES)}
    variables = _seeded_variables(module, [x, locations, dummy], 3)
    net.load_state_dict(state_dict_from_flax_variables(variables), strict=True)
    net.eval()
    face_dict, share = _face_dictionary(net, _nchw(x), locations, rng)
    assert share >= GAP_SHARE, share
    jax_dict = {s: {p: a.permute(0, 2, 3, 1).numpy() for p, a in d.items()}
                for s, d in face_dict.items()}
    want = jax.jit(module.apply)(variables, x, locations, jax_dict)
    with torch.no_grad():
        got = net(_nchw(x), locations, face_dict)
    close(_nhwc(got), want, OUT_TOL, 'DFDNet')


def test_inference_main_on_cpu(tmp_path):
    """``main`` on ``--device cpu``: one image (300 x 280, resized to 512),
    its landmark file, a dictionary and a ``.pth`` saved from seeded
    weights; the PNG it writes equals ``restore`` of the same net, and the
    part boxes are the JAX script's."""
    rng = np.random.RandomState(4)
    folders = {k: tmp_path / k for k in ('faces', 'landmarks', 'out')}
    for folder in folders.values():
        folder.mkdir()
    base = rng.rand(40, 36, 3)
    img = (cv2.resize(base, (280, 300), interpolation=cv2.INTER_CUBIC)
           .clip(0, 1) * 255).astype(np.uint8)
    cv2.imwrite(str(folders['faces'] / 'face0.png'), img)
    landmarks = _landmarks(rng)
    np.save(folders['landmarks'] / 'face0.npy', landmarks)
    jax_script = runpy.run_path(os.path.join(ROOT, 'inference',
                                             'inference_dfdnet.py'))
    for mine, theirs in zip(inference_dfdnet.get_part_location(landmarks),
                            jax_script['get_part_location'](landmarks)):
        np.testing.assert_array_equal(mine, theirs)
    net = inference_dfdnet.build_model('', 'cpu', seed=5)
    model_path = tmp_path / 'dfdnet.pth'
    torch.save({'params': net.state_dict()}, model_path)
    face_dict = {str(s): {p: torch.randn(
        (2, c, PART_SIDES[p] * s // 512, PART_SIDES[p] * s // 512),
        generator=torch.Generator().manual_seed(6)) for p in
        dfdnet_arch.PARTS} for s, c in zip(dfdnet_arch.FEATURE_SIZES,
                                           dfdnet_arch.CHANNEL_SIZES)}
    dict_path = tmp_path / 'dict.pth'
    torch.save(face_dict, dict_path)
    inference_dfdnet.main([
        '--test_path', str(folders['faces']), '--landmark_dir',
        str(folders['landmarks']), '--dict_path', str(dict_path),
        '--model_path', str(model_path), '--save_path', str(folders['out']),
        '--device', 'cpu'])
    model_path.unlink()  # 440 MB
    written = cv2.imread(str(folders['out'] / 'face0_DFDNet.png'))
    assert written.shape == (512, 512, 3)
    want = inference_dfdnet.restore(
        net, dfdnet_arch.load_dfdnet_dict(dict_path),
        inference_dfdnet.read_face(str(folders['faces'] / 'face0.png')),
        landmarks)
    np.testing.assert_array_equal(written, want)


def test_build_model_refuses_a_missing_weights_file(tmp_path):
    """A ``--model_path`` that names no file raises, as the JAX script's
    load does; an empty one keeps the weights drawn from the seed."""
    with pytest.raises(FileNotFoundError, match='no_such.pth'):
        inference_dfdnet.build_model(str(tmp_path / 'no_such.pth'), 'cpu',
                                     seed=5)
    seeded = inference_dfdnet.build_model('', 'cpu', seed=5).state_dict()
    again = inference_dfdnet.build_model(None, 'cpu', seed=5).state_dict()
    assert seeded.keys() == again.keys()
    assert all(torch.equal(v, again[k]) for k, v in seeded.items())


def _official_key(key):
    """The official DFDNet name of a port key, written out from the
    official layout (``VggExtract.model.features.<i>``, ``le`` / ``re`` /
    ``no`` / ``mo``, ``MSDilate.conv<i + 1>`` / ``convi``, ``up<i>`` with
    ``ScaleModel1`` / ``ShiftModel1`` / ``Model``)."""
    from mrefsr_tpu_torch.archs.vgg_arch import NAMES
    parts = key.split('.')
    if parts[0] == 'vgg_extractor':
        return (f'VggExtract.model.features.'
                f'{NAMES["vgg19"].index(parts[2])}.{parts[3]}')
    if parts[0] == 'attn_blocks':
        name, size = parts[1].rsplit('_', 1)
        short = {'left_eye': 'le', 'right_eye': 're', 'nose': 'no',
                 'mouth': 'mo'}[name]
        return '.'.join([f'{short}_{size}'] + parts[2:])
    if parts[0] == 'multi_scale_dilation':
        if parts[1] == 'conv_blocks':
            return '.'.join(['MSDilate', f'conv{int(parts[2]) + 1}']
                            + parts[3:])
        return '.'.join(['MSDilate', 'convi'] + parts[2:])
    names = {'scale_block': 'ScaleModel1', 'shift_block': 'ShiftModel1',
             'body': 'Model'}
    return '.'.join(['up' + parts[0][len('upsample'):]]
                    + [names.get(p, p) for p in parts[1:]])


def test_dfdnet_converter(tmp_path):
    shapes = convert_dfdnet.port_shapes()
    gen = torch.Generator().manual_seed(7)
    port_state = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    official = {_official_key(k): v for k, v in port_state.items()}
    assert len(official) == len(port_state)
    mine = convert_dfdnet.convert_net(official, shapes)
    script = runpy.run_path(os.path.join(
        ROOT, 'scripts', 'model_conversion', 'convert_dfdnet.py'))
    theirs = script['convert_net'](official, shapes)
    assert mine.keys() == theirs.keys() == port_state.keys()
    for key, val in port_state.items():
        assert torch.equal(mine[key], val) and torch.equal(theirs[key], val)
    ori = tmp_path / 'official.pth'
    torch.save(official, ori)
    convert_dfdnet.main(['--ori', str(ori), '--save',
                         str(tmp_path / 'converted.pth')])
    with torch.device('meta'):
        net = dfdnet_arch.DFDNet(64)
    net.to_empty(device='cpu')
    net.load_state_dict(torch.load(tmp_path / 'converted.pth')['params'],
                        strict=True)
    for path in (ori, tmp_path / 'converted.pth'):  # 440 MB each
        path.unlink()
    with pytest.raises(ValueError, match='Wrong tensor size'):
        convert_dfdnet.convert_net(
            dict(official, **{'up4.4.bias': torch.zeros(4)}), shapes)
