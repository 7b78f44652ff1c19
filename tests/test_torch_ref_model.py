"""The port's single-reference family against the JAX package's, on the
CPU: ``ContrasExtractorSep`` and ``RestorationNet`` against flax, a
``RefRestorationModel`` pixel step in f32 and in bf16 and a GAN step from
one flax init, and the five single-ref datasets bit for bit for a seed."""
import os
import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs import build_network as jax_build_network
from mrefsr_tpu.convert import flax_to_torch
from mrefsr_tpu.data import build_dataset as jax_build_dataset
from mrefsr_tpu.models import build_model as jax_build_model
from mrefsr_tpu_torch.archs import build_network
from mrefsr_tpu_torch.convert import state_dict_from_flax
from mrefsr_tpu_torch.data import build_dataset
from mrefsr_tpu_torch.models import build_model

NGF, BLOCKS, GROUPS, LR = 8, 1, 2, 1e-4


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The test workers of one run share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _torch_named(tree):
    return {k: np.asarray(v) for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x), -1, 1)))


# ------------------------------------------------------------------- archs
def test_contras_extractor_sep_matches_flax():
    rng = np.random.RandomState(0)
    img1 = rng.rand(2, 32, 32, 3).astype(np.float32)
    img2 = rng.rand(2, 32, 32, 3).astype(np.float32)
    net = jax_build_network({'type': 'ContrasExtractorSep'})
    variables = net.init(jax.random.PRNGKey(0), img1, img2)
    want = net.apply(variables, img1, img2)
    port = build_network({'type': 'ContrasExtractorSep'})
    port.load_state_dict(state_dict_from_flax(variables['params']),
                         strict=True)
    with torch.no_grad():
        got = port(_nchw(img1), _nchw(img2))
    for key in ('dense_features1', 'dense_features2'):
        w = np.moveaxis(np.asarray(want[key]), -1, 1)
        assert np.abs(got[key].numpy() - w).max() <= 1e-5 * np.abs(w).max()


def _restoration_inputs(rng, b=2, lq=8):
    x = rng.rand(b, lq, lq, 3).astype(np.float32)
    pre = {}
    feats = {}
    for level, s, c in (('relu3_1', 1, 256), ('relu2_1', 2, 128),
                        ('relu1_1', 4, 64)):
        pre[level] = rng.randint(-2, 3, (b, lq * s, lq * s, 9, 2)).astype(
            np.float32)
        feats[level] = rng.rand(b, lq * s, lq * s, c).astype(np.float32)
    return x, pre, feats


def _live_offsets(params, rng):
    """Non-zero offset heads, so that sampling is fractional."""
    def perturb(path, leaf):
        keys = [getattr(k, 'key', str(k)) for k in path]
        if 'conv_offset_mask' not in keys:
            return leaf
        scale = 0.01 if keys[-1] == 'kernel' else 1.0
        return jnp.asarray(rng.uniform(-scale, scale, leaf.shape),
                           jnp.float32)
    return jax.tree_util.tree_map_with_path(perturb, params)


def test_restoration_net_matches_flax():
    """The output and every parameter's gradient of a sum of the output,
    from flax weights with live offset heads (measured: output within
    2e-7 of its largest entry, gradients within 4e-6)."""
    rng = np.random.RandomState(1)
    x, pre, feats = _restoration_inputs(rng)
    opt = {'type': 'RestorationNet', 'ngf': NGF, 'n_blocks': BLOCKS,
           'groups': GROUPS}
    net = jax_build_network(opt)
    params = _live_offsets(net.init(jax.random.PRNGKey(2), x, pre,
                                    feats)['params'], rng)
    weights = jnp.asarray(rng.rand(2, 32, 32, 3).astype(np.float32))

    def loss(p):
        out = net.apply({'params': p}, x, pre, feats)
        return (out * weights).sum(), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    port = build_network(dict(opt, dcn_outer_remat=True, fusion_remat=True))
    port.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    out = port(_nchw(x), {k: torch.from_numpy(v) for k, v in pre.items()},
               {k: _nchw(v) for k, v in feats.items()})
    (out * _nchw(weights)).sum().backward()
    want = np.moveaxis(np.asarray(want), -1, 1)
    assert np.abs(out.detach().numpy() - want).max() \
        <= 1e-5 * np.abs(want).max()
    want_grads = _torch_named(want_grads)
    for name, param in port.named_parameters():
        scale = np.abs(want_grads[name]).max()
        assert np.abs(param.grad.numpy() - want_grads[name]).max() \
            <= 1e-4 * scale, name
    assert sum('_dyn_agg.' in n for n, _ in port.named_parameters()) == 12


# -------------------------------------------------------------------- model
# gt 32 as the JAX model tests; the GAN step at 64, where the
# discriminator's last norm sees n = 8 values a channel (at n = 2 its input
# gradient depends on eps / d^3, which the penalty amplifies)
GT, GAN_GT, B = 32, 64, 2


def _opt(train_mp=None, gan=False):
    """The JAX model tests' single-ref options (tests/test_models/
    test_multi_ref_model.py:10-66): ngf 8, 1 block, 2 deform groups; with
    ``gan`` a discriminator of ndf 4 whose first GAN step is step 2."""
    opt = {
        'name': 'test_ref', 'model_type': 'RefRestorationModel', 'scale': 4,
        'crop_border': 4, 'num_gpu': 1, 'manual_seed': 10, 'is_train': True,
        'dist': False, 'rank': 0, 'world_size': 1,
        'network_g': {'type': 'RestorationNet', 'ngf': NGF,
                      'n_blocks': BLOCKS, 'groups': GROUPS},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'patch_size': 3, 'stride': 1,
                        'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                        'vgg_type': 'vgg19'},
        'network_extractor': {'type': 'ContrasExtractorSep'},
        'path': {},
        'train': {'lr_g': LR, 'lr_offset': LR, 'lr_relu3_offset': 1e-6,
                  'lr_relu2_offset': 1e-5, 'weight_decay_g': 0,
                  'beta_g': [0.9, 0.999],
                  'scheduler': {'type': 'MultiStepLR',
                                'milestones': [300000], 'gamma': 0.5},
                  'total_iter': 10, 'warmup_iter': -1,
                  'net_g_pretrain_steps': 1, 'pixel_criterion': 'L1Loss',
                  'pixel_weight': 1.0},
    }
    if train_mp:
        opt['train']['mixed_precision'] = train_mp
    if gan:
        opt['network_d'] = {'type': 'ImageDiscriminator', 'in_nc': 3,
                            'ndf': 4}
        opt['train'].update(lr_d=LR, beta_d=[0.9, 0.999], gan_type='wgan',
                            gan_weight=1e-5, grad_penalty_weight=10.0)
    return opt


def _batch(rng, gt=GT):
    return {'img_in': rng.rand(B, gt, gt, 3).astype(np.float32),
            'img_in_lq': rng.rand(B, gt // 4, gt // 4, 3).astype(np.float32),
            'img_in_up': rng.rand(B, gt, gt, 3).astype(np.float32),
            'img_ref': rng.rand(B, gt, gt, 3).astype(np.float32)}


def _check_params(got, want, updates, lr=LR):
    """Adam's first steps move an entry by about its learning rate whatever
    its gradient's size, so a noise-level gradient of the other sign parts
    the two by 2 lr: every entry within 2 * lr * updates, 99 % of all
    entries and 95 % of each tensor's within a tenth of one step (the
    pre-norm conv biases of a discriminator only the first: their gradient
    is rounding noise). Measured: 98.4 % of the worst tensor."""
    assert sorted(got) == sorted(want)
    close = []
    for name in want:
        diff = np.abs(got[name] - want[name])
        assert diff.max() <= 2 * lr * updates + 1e-7, name
        parts = name.split('.')
        noise = parts[0].startswith('conv_block') and parts[1] in ('0', '3') \
            and parts[-1] == 'bias'
        if not noise:
            close.append((diff <= 0.1 * lr + 1e-7).ravel())
            assert close[-1].mean() >= 0.95, name
    assert np.concatenate(close).mean() >= 0.99


@pytest.fixture(scope='module')
def gan_run():
    """One pixel step (f32), then one GAN step with G, of both models from
    one flax init; the port's penalty fed JAX's interpolation weights."""
    batch = _batch(np.random.RandomState(0), GAN_GT)
    opt = _opt(gan=True)
    opt['train'].update(net_d_steps=1, net_d_init_steps=0)
    jax_model = jax_build_model(opt)
    jax_model.feed_data(batch)
    model = build_model(opt, device='cpu')
    model.load_from_flax(jax_model.vars_extractor, jax_model.vars_map,
                         jax_model.vars_g, jax_model.vars_d)
    keys, next_rng = [], jax_model.next_rng

    def recorded():
        keys.append(next_rng())
        return keys[-1]

    jax_model.next_rng = recorded
    model.penalty_alpha = lambda b, step: torch.from_numpy(np.asarray(
        jax.random.uniform(keys[-1], (b, 1, 1, 1), jnp.float32)))
    out = []
    for step in (1, 2):
        jax_model.feed_data(batch)
        jax_model.optimize_parameters(step)
        model.feed_data(batch)
        model.optimize_parameters(step)
        out.append({
            'logs': (model.get_current_log(),
                     {k: float(v) for k, v in
                      jax_model.get_current_log().items()}),
            'g': ({k: v.detach().numpy().copy() for k, v in
                   model.net_g.state_dict().items()},
                  _torch_named(jax_model.vars_g['params'])),
            'd': ({k: v.detach().numpy().copy() for k, v in
                   model.net_d.state_dict().items()
                   if 'running' not in k and 'num_batches' not in k},
                  _torch_named(jax_model.vars_d['params']))})
    return out


# Measured: the pixel loss within 1e-7 (relative), the GAN step's losses
# within 2e-6 but the penalty (test_torch_gan.py: it follows the
# generator's output through a double backward).
REF_LOG_RTOL, REF_PENALTY_RTOL = 1e-4, 2e-3


def test_ref_pixel_and_gan_steps_match_jax(gan_run):
    """The pixel step's ``l_pix`` and the GAN step's losses; the
    generator's parameters after each, the discriminator's after the GAN
    step."""
    for i, record in enumerate(gan_run):
        got, want = record['logs']
        assert sorted(got) == sorted(want)
        for key in want:
            tol = REF_PENALTY_RTOL if key == 'l_grad_penalty' \
                else REF_LOG_RTOL
            assert got[key] == pytest.approx(want[key], rel=tol), (i, key)
        _check_params(*record['g'], updates=i + 1)
    assert 'l_g_gan' in gan_run[1]['logs'][0]
    _check_params(*gan_run[1]['d'], updates=1)


# the bf16 step against JAX's bf16 step: the loss within 3e-4 (measured
# 4e-6), as tests/test_torch_bf16.py holds the multi-ref one
BF16_LOSS_RTOL = 3e-4


def test_ref_bf16_pixel_step_matches_jax():
    """``train.mixed_precision: bfloat16``: the pixel loss of two steps and
    the parameters after them; the nets keep f32 parameters."""
    batch = _batch(np.random.RandomState(1))
    opt = _opt('bfloat16')
    jax_model = jax_build_model(opt)
    jax_model.feed_data(batch)
    model = build_model(opt, device='cpu')
    model.load_from_flax(jax_model.vars_extractor, jax_model.vars_map,
                         jax_model.vars_g)
    for step in (1, 2):
        jax_model.feed_data(batch)
        jax_model.optimize_parameters(step)
        model.feed_data(batch)
        model.optimize_parameters(step)
        assert model.get_current_log()['l_pix'] == pytest.approx(
            float(jax_model.get_current_log()['l_pix']), rel=BF16_LOSS_RTOL)
    assert model.train_dtype == torch.bfloat16
    assert {p.dtype for p in model.net_g.parameters()} == {torch.float32}
    # where bf16 noise gives a small gradient the other sign, Adam's steps
    # part by 2 lr (tests/test_torch_bf16.py): every entry within 2 lr a
    # step, 90 % of all within a tenth of a step
    got = {k: v.detach().numpy() for k, v in model.net_g.state_dict().items()}
    want = _torch_named(jax_model.vars_g['params'])
    assert sorted(got) == sorted(want)
    diffs = [np.abs(got[k] - want[k]).ravel() for k in want]
    assert max(d.max() for d in diffs) <= 2 * LR * 2
    assert (np.concatenate(diffs) <= 0.1 * LR).mean() >= 0.9


def test_ref_eval_request_shapes():
    """A request (f32 and bf16) on a single ref: NHWC f32 out at 4x."""
    batch = _batch(np.random.RandomState(2))
    for mp in (None, 'bfloat16'):
        opt = dict(_opt(), is_train=False, val={'mixed_precision': mp})
        model = build_model(opt, device='cpu')
        model.feed_data(batch)
        model.test()
        out = model.get_current_visuals()['rlt']
        assert out.shape == (B, GT, GT, 3) and out.dtype == np.float32
        assert np.isfinite(out).all()


# ----------------------------------------------------------------- datasets
IMG, DGT, SCALE = 96, 32, 4


@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    """The JAX dataset tests' fixtures (tests/test_data/
    test_ref_datasets.py): an LMR CSV, a RefMegaDepth CSV with a test
    scene, and CUFED folders whose refs are 8 rows shorter."""
    root = tmp_path_factory.mktemp('ref_data')
    rng = np.random.RandomState(0)
    lmr = root / 'lmr' / 'imgs' / '0001'
    lmr.mkdir(parents=True)
    names = [f'im{i}.jpg' for i in range(6)]
    for name in names:
        cv2.imwrite(str(lmr / name),
                    (rng.rand(IMG, IMG, 3) * 255).astype(np.uint8))
    pts = [f'"{(IMG // 2 + d, IMG // 2 - d)}"' for d in range(6)]
    rows = ['target,H,M1,M2,L1,L2,p0,p1,p2,p3,p4,p5,scene']
    rows += [','.join(names) + ',' + ','.join(pts) + ',0001'] * 3
    (root / 'lmr' / 'ann.csv').write_text('\n'.join(rows) + '\n')

    md = root / 'md' / 'imgs'
    for scene in ('0001', '0000'):
        (md / scene).mkdir(parents=True)
        for name in ('a.jpg', 'b.jpg'):
            cv2.imwrite(str(md / scene / name),
                        (rng.rand(IMG, IMG - 4, 3) * 255).astype(np.uint8))
    pa = str([(IMG // 2, IMG // 2), (IMG // 2 + 3, IMG // 2 - 5)])
    pb = str([(IMG // 2 - 2, IMG // 2 + 1), (IMG // 2, IMG // 2)])
    rows = ['target,reference,scene,sim,pA,pB']
    for scene in ('0001', '0000'):
        rows.append(f'a.jpg,b.jpg,{scene},H,"{pa}","{pb}"')
    rows.append(f'a.jpg,b.jpg,0001,L,"{pa}","{pb}"')
    (root / 'md' / 'ann.csv').write_text('\n'.join(rows) + '\n')

    cufed = root / 'cufed'
    (cufed / 'input').mkdir(parents=True)
    (cufed / 'ref').mkdir()
    for name in ('x', 'y', 'z'):
        cv2.imwrite(str(cufed / 'input' / f'{name}.png'),
                    (rng.rand(IMG, IMG, 3) * 255).astype(np.uint8))
        cv2.imwrite(str(cufed / 'ref' / f'{name}.png'),
                    (rng.rand(IMG - 8, IMG, 3) * 255).astype(np.uint8))
    (cufed / 'ann.txt').write_text('y.png\nx.png\n')
    return root


def _dataset_opts(roots):
    base = {'name': 't', 'scale': SCALE, 'gt_size': DGT, 'use_flip': True,
            'use_rot': True}
    md = dict(base, dataroot_in=str(roots / 'md' / 'imgs'),
              dataroot_ref=str(roots / 'md' / 'imgs'),
              ann_file=str(roots / 'md' / 'ann.csv'))
    cufed = dict(base, io_backend={'type': 'disk'},
                 dataroot_in=str(roots / 'cufed' / 'input'),
                 dataroot_ref=str(roots / 'cufed' / 'ref'))
    return {
        'single_ref_train': dict(
            base, type='SingleRefMegaDepthDataset', phase='train',
            dataroot_in=str(roots / 'lmr' / 'imgs'),
            dataroot_ref=str(roots / 'lmr' / 'imgs'),
            ann_file=str(roots / 'lmr' / 'ann.csv')),
        'ref_md_train': dict(md, type='RefMegaDepthDataset', phase='train'),
        'ref_md_val': dict(md, type='RefMegaDepthDataset', phase='val'),
        'ref_md_cvt_train': dict(md, type='RefMegaDepthCVTDataset',
                                 phase='train'),
        'ref_cufed_train': dict(cufed, type='RefCUFEDDataset',
                                phase='train'),
        'ref_cufed_val': dict(cufed, type='RefCUFEDDataset', phase='val'),
        'ref_cufed_ann_val': dict(
            cufed, type='RefCUFEDDataset', phase='val',
            ann_file=str(roots / 'cufed' / 'ann.txt')),
        'ref_cufed_cvt_train': dict(cufed, type='RefCUFEDCVTDataset',
                                    phase='train'),
    }


CASES = ['single_ref_train', 'ref_md_train', 'ref_md_val',
         'ref_md_cvt_train', 'ref_cufed_train', 'ref_cufed_val',
         'ref_cufed_ann_val', 'ref_cufed_cvt_train']


@pytest.mark.parametrize('case', CASES)
def test_ref_datasets_match_jax_for_a_seed(roots, case):
    """Every item of every epoch of two, the port's dataset seeded 5
    against the JAX package's under ``random.seed(5)`` and
    ``np.random.seed(5)``: the same keys, the same arrays bit for bit."""
    opt = _dataset_opts(roots)[case]
    ours = build_dataset(opt, seed=5)
    random.seed(5)
    np.random.seed(5)
    theirs = jax_build_dataset(opt)
    assert len(ours) == len(theirs) > 0
    for _ in range(2):
        for i in range(len(ours)):
            got, want = ours[i], theirs[i]
            assert sorted(got) == sorted(want), case
            for key, val in want.items():
                if isinstance(val, np.ndarray):
                    assert got[key].dtype == val.dtype, key
                    np.testing.assert_array_equal(got[key], val,
                                                  err_msg=key)
                else:
                    assert got[key] == val, key


def _cufed_lmdb(roots):
    """``in.lmdb`` and ``ref.lmdb`` folders holding the CUFED images and a
    ``meta_info.txt`` of their keys (the layout the lmdb backend reads; no
    lmdb environment, which the stand-in backend below does without)."""
    out = {}
    for kind, folder in (('in', 'input'), ('ref', 'ref')):
        db = roots / 'cufed' / f'{kind}.lmdb'
        db.mkdir(exist_ok=True)
        for name in ('x', 'y', 'z'):
            (db / f'{name}.png').write_bytes(
                (roots / 'cufed' / folder / f'{name}.png').read_bytes())
        (db / 'meta_info.txt').write_text(
            'z.png (88,96,3) 1\nx.png (88,96,3) 1\ny.png (88,96,3) 1\n')
        out[kind] = str(db)
    return out


class _StandInLmdb:
    """The lmdb backend's interface over the folders of :func:`_cufed_lmdb`:
    ``get(key, client_key)`` returns the bytes of ``<db>/<key>.png``."""

    def __init__(self, db_paths, client_keys='default', **kwargs):
        self.paths = dict(zip(client_keys, db_paths))

    def get(self, filepath, client_key):
        with open(os.path.join(self.paths[client_key],
                               f'{filepath}.png'), 'rb') as f:
            return f.read()


def test_ref_dataset_split_and_lmdb(roots):
    """RefMegaDepth trains on the scenes outside the test split (two match
    points of one row: the rows stop at similarity ``L``) and tests on
    the test scene; the CUFED sets with ``io_backend: lmdb`` pair the keys
    of both databases' ``meta_info.txt`` as the JAX package's do, and give
    their file client the two databases under the keys ``in`` and
    ``ref``."""
    opts = _dataset_opts(roots)
    assert len(build_dataset(opts['ref_md_train'])) == 2
    val = build_dataset(opts['ref_md_val'])
    assert len(val) == 1 and val[0]['lq_path'].endswith(
        os.path.join('0000', 'b.jpg'))
    dbs = _cufed_lmdb(roots)
    for case in ('ref_cufed_val', 'ref_cufed_cvt_train'):
        opt = dict(opts[case], io_backend={'type': 'lmdb'},
                   dataroot_in=dbs['in'], dataroot_ref=dbs['ref'])
        ours, theirs = build_dataset(opt, seed=5), jax_build_dataset(opt)
        assert ours.paths == theirs.paths == [
            {'in_path': k, 'ref_path': k} for k in ('x', 'y', 'z')]
        assert ours.io_backend_opt == theirs.io_backend_opt == {
            'type': 'lmdb', 'db_paths': [dbs['in'], dbs['ref']],
            'client_keys': ['in', 'ref']}


@pytest.mark.parametrize('case', ['ref_cufed_train', 'ref_cufed_val',
                                  'ref_cufed_cvt_train'])
def test_ref_cufed_lmdb_samples_through_a_stand_in_backend(
        roots, monkeypatch, case):
    """``lmdb`` is not installed: with a stand-in lmdb backend that serves
    the databases' keys, every item of two epochs of the port's lmdb set
    (seeded 5) equals the JAX package's folder set on the same images
    (``random.seed(5)``, ``np.random.seed(5)``; its pairs listed by an
    ``ann_file`` in the keys' sorted order) bit for bit; ``lq_path`` is the
    key."""
    from mrefsr_tpu_torch.utils.file_client import FileClient
    monkeypatch.setitem(FileClient._backends, 'lmdb', _StandInLmdb)
    dbs = _cufed_lmdb(roots)
    opt = _dataset_opts(roots)[case]
    ours = build_dataset(dict(opt, io_backend={'type': 'lmdb'},
                              dataroot_in=dbs['in'],
                              dataroot_ref=dbs['ref']), seed=5)
    ann = roots / 'cufed' / 'ann_xyz.txt'
    ann.write_text('x.png\ny.png\nz.png\n')
    random.seed(5)
    np.random.seed(5)
    theirs = jax_build_dataset(dict(opt, ann_file=str(ann)))
    assert len(ours) == len(theirs) == 3
    for _ in range(2):
        for i in range(3):
            got, want = ours[i], theirs[i]
            assert sorted(got) == sorted(want)
            for key, val in want.items():
                if key == 'lq_path':
                    assert got[key] == 'xyz'[i]
                elif isinstance(val, np.ndarray):
                    np.testing.assert_array_equal(got[key], val,
                                                  err_msg=key)
                else:
                    assert got[key] == val, key
