"""Boundaries of the port: it imports nothing of JAX or the JAX package,
its entry points never fall back to the CPU unasked, a CPU tensor never
reaches a CUDA kernel, and a kernel that fails to build or launch
raises."""
import ast
import ctypes
import importlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.ops import _build, correlation, dcn, fused_act

# the package exports the function under its module's name
ops_upfirdn2d = importlib.import_module('mrefsr_tpu_torch.ops.upfirdn2d')

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'mrefsr_tpu'}
PORT_FILES = sorted((REPO / 'mrefsr_tpu_torch').rglob('*.py')) \
    + [REPO / 'chip_smoke.py', REPO / 'k1_compare.py']
# helpers that run as rank processes of their own, apart from pytest
RANK_WORKERS = [REPO / 'tests' / 'torch_dist_worker.py']


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tensors here are tiny, and the test workers of one run share
    the host's cores: more threads per process only get in each other's
    way."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split('.')[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', '')) in (
                    'import_module', '__import__') and node.args \
                and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split('.')[0])
    return roots


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize('path', RANK_WORKERS,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_rank_workers_import_no_jax(path):
    """The tests' rank processes import nothing of JAX, as the port."""
    assert not _imported_roots(path) & FORBIDDEN


def test_scan_covers_the_distributed_modules():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ('utils/dist_util.py', 'utils/color_util.py',
                   'parallel/__init__.py', 'parallel/ddp.py',
                   'data/__init__.py', 'data/data_sampler.py',
                   'data/loader.py', 'metrics/__init__.py',
                   'metrics/metric_util.py', 'metrics/psnr_ssim.py'):
        assert f'mrefsr_tpu_torch/{module}' in names


def test_scan_sees_forbidden_imports(tmp_path):
    bad = tmp_path / 'bad.py'
    bad.write_text('import jax.numpy as jnp\n'
                   'from mrefsr_tpu.ops import dcn\n'
                   'import importlib\nimportlib.import_module("flax")\n')
    assert _imported_roots(bad) & FORBIDDEN == {'jax', 'mrefsr_tpu', 'flax'}


# imported inside the functions that use them, never when a module of the
# port is imported: the card's machine need not have them, and importing
# the package must not pay for them
LAZY = {'cv2', 'PIL', 'yaml', 'lmdb', 'tensorboard', 'wandb'}


def _module_level_roots(path):
    """The roots of the imports that run when ``path`` is imported: those
    outside every function body."""
    roots = set()
    stack = list(ast.parse(path.read_text(), str(path)).body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            roots |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split('.')[0])
        stack.extend(ast.iter_child_nodes(node))
    return roots


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_optional_packages_are_imported_inside_functions(path):
    assert not _module_level_roots(path) & LAZY


def test_scan_covers_the_data_and_cli_modules(tmp_path):
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ('train.py', 'test.py', 'version.py', 'utils/options.py',
                   'utils/logger.py', 'utils/misc.py', 'utils/registry.py',
                   'data/transforms.py', 'data/data_util.py',
                   'data/multi_ref_dataset.py', 'data/loader.py',
                   'data/prefetch_dataloader.py', 'data/__init__.py'):
        assert f'mrefsr_tpu_torch/{module}' in names
    bad = tmp_path / 'bad.py'
    bad.write_text('import os\nif os.name:\n    import cv2\n'
                   'def f():\n    import yaml\n'
                   'class C:\n    from PIL import Image\n')
    assert _module_level_roots(bad) & LAZY == {'cv2', 'PIL'}


def test_scan_covers_the_inference_modules():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert 'mrefsr_tpu_torch/inference/inference_stylegan2.py' in names
    assert 'mrefsr_tpu_torch/inference/inference_basicvsr.py' in names
    assert 'mrefsr_tpu_torch/inference/inference_basicvsrpp.py' in names
    assert 'mrefsr_tpu_torch/inference/__init__.py' in names
    assert 'chip_smoke.py' in names


def _tiny_opt():
    return {
        'model_type': 'MultiRefRestorationModel', 'manual_seed': 0,
        'network_g': {'type': 'MRAPARestorationNet', 'ngf': 8,
                      'n_blocks': 1, 'groups': 2},
        'network_map': {'type': 'CorrespondenceGenerationArch'},
        'network_extractor': {'type': 'ContrasMultiExtractorSep'},
        'path': {},
    }


def test_model_without_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_model(_tiny_opt())


def _tiny_stylegan2_opt():
    return {
        'name': 'sg2', 'model_type': 'StyleGAN2Model', 'manual_seed': 0,
        'is_train': True,
        'network_g': {'type': 'StyleGAN2Generator', 'out_size': 16,
                      'num_style_feat': 8, 'num_mlp': 2,
                      'channel_multiplier': 1, 'narrow': 0.0625},
        'network_d': {'type': 'StyleGAN2Discriminator', 'out_size': 16,
                      'channel_multiplier': 1, 'narrow': 0.0625,
                      'stddev_group': 2},
        'path': {},
        'train': {'optim_g': {'type': 'Adam', 'lr': 2e-3},
                  'optim_d': {'type': 'Adam', 'lr': 2e-3},
                  'gan_opt': {'type': 'GANLoss',
                              'gan_type': 'wgan_softplus'},
                  'r1_reg_weight': 10, 'path_reg_weight': 2,
                  'net_g_reg_every': 1, 'net_d_reg_every': 1,
                  'mixing_prob': 0.9}}


def test_stylegan2_model_without_device_raises_on_a_host_without_cuda(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_model(_tiny_stylegan2_opt())


def _tiny_train_opt():
    opt = _tiny_opt()
    opt['is_train'] = True
    opt['train'] = {'lr_g': 1e-4, 'lr_offset': 1e-4, 'lr_relu3_offset': 1e-6,
                    'lr_relu2_offset': 1e-5, 'pixel_criterion': 'L1Loss',
                    'pixel_weight': 1.0}
    return opt


def test_model_refuses_what_is_not_ported():
    """Options of parts that are not ported raise and name the roadmap
    item; none is silently ignored. The options without any of them
    build, and so do they with the bf16 mixed precision of training and
    of eval, and with the GAN phase's keys (ROADMAP A4, ported). The names
    of ROADMAP A8, A9 and A10 are registered. Every name the port refuses is
    one the JAX package registers."""
    from mrefsr_tpu.utils import registry as jax_registry
    from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY, PENDING
    assert build_model(_tiny_train_opt(), device='cpu').is_train
    opt = _tiny_train_opt()
    opt['train']['mixed_precision'] = 'bfloat16'
    opt['val'] = {'mixed_precision': 'bfloat16'}
    model = build_model(opt, device='cpu')
    assert model.train_dtype == model.eval_dtype == torch.bfloat16
    opt = _tiny_train_opt()
    opt['network_d'] = {'type': 'ImageDiscriminator', 'ndf': 4}
    opt['train'].update(
        gan_type='wgan', gan_weight=1e-5, lr_d=1e-4,
        perceptual_opt={'layer_weights': {'relu5_1': 1.0}},
        style_opt={'layer_weights': {'relu1_1': 1.0}, 'style_weight': 1.})
    model = build_model(opt, device='cpu')
    assert model.net_d is not None and model.cri_style is not None
    for where, key, value, item in [
            (None, 'model_type', 'HiFaceGANModel', 'ROADMAP A11'),
            (None, 'network_d', {'type': 'HiFaceGANDiscriminator'},
             'ROADMAP A11')]:
        opt = _tiny_train_opt()
        opt['train']['gan_type'] = 'wgan'
        opt[key] = value
        with pytest.raises(NotImplementedError, match=item):
            build_model(opt, device='cpu')
    # the models of ROADMAP A6-A10 are ported: SRModel, the video models,
    # SRGANModel, the video GAN models, ESRGAN, SwinIR's and Real-ESRGAN's
    for model_type in ('SRModel', 'VideoBaseModel', 'EDVRModel',
                       'VideoRecurrentModel', 'SRGANModel', 'VideoGANModel',
                       'VideoRecurrentGANModel', 'ESRGANModel',
                       'SwinIRModel', 'SwinIRGANModel', 'RealESRGANModel',
                       'RealESRNetModel'):
        assert MODEL_REGISTRY.get(model_type).__name__ == model_type
        assert model_type not in PENDING['model']
    from mrefsr_tpu_torch.data import build_dataset
    from mrefsr_tpu_torch.utils.file_client import FileClient
    from mrefsr_tpu_torch.utils.registry import (ARCH_REGISTRY,
                                                 DATASET_REGISTRY)
    for arch in ('IconVSR', 'TOFlow', 'DUF', 'VGGStyleDiscriminator',
                 'RRDBNet', 'EDSR', 'RCAN', 'SRVGGNetCompact', 'ECBSR',
                 'RIDNet', 'SwinIR', 'UNetDiscriminatorSN'):
        assert ARCH_REGISTRY.get(arch).__name__ == arch
        assert arch not in PENDING['arch']
    for dataset in ('VideoTestDUFDataset', 'SISRMegaDepthDataset',
                    'SISRCUFEDDataset', 'SISRSun80Set', 'SISRManga109Set',
                    'SISRWRSRSet', 'SISRMegaDepthTestSet',
                    'SISRMegaDepthv3TestSet', 'RealESRGANDataset',
                    'RealESRGANPairedDataset'):
        assert DATASET_REGISTRY.get(dataset).__name__ == dataset
        assert dataset not in PENDING['dataset']
    with pytest.raises(NotImplementedError, match='ROADMAP A11'):
        build_dataset({'type': 'FFHQDataset', 'name': 'FFHQ'})
    with pytest.raises(NotImplementedError, match='ROADMAP A12'):
        FileClient('pack', db_paths=['x.pack'])
    jax_names = {'model': jax_registry.MODEL_REGISTRY,
                 'arch': jax_registry.ARCH_REGISTRY,
                 'dataset': jax_registry.DATASET_REGISTRY}
    import mrefsr_tpu.archs  # noqa: F401  (fill the JAX registries)
    import mrefsr_tpu.data  # noqa: F401
    import mrefsr_tpu.models  # noqa: F401
    for kind, names in PENDING.items():
        for name in names:
            jax_names[kind].get(name)       # raises where it is unknown


def test_seeded_weights_are_reproducible():
    a = build_model(_tiny_opt(), device='cpu').net_g.state_dict()
    b = build_model(_tiny_opt(), device='cpu').net_g.state_dict()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


def _refuse(*_):
    raise AssertionError('a CUDA kernel was reached from CPU tensors')


KERNELS = (correlation.feature_match_prologue_kernel,
           correlation.feature_match_prologue_bf16_kernel,
           correlation.feature_match_kernel,
           correlation.feature_match_sharded_kernel,
           correlation.feature_match_bf16_kernel,
           correlation.feature_match_sharded_bf16_kernel,
           *dcn.FUSED_KERNELS.values(),
           dcn.deform_sample_fwd_bf16_kernel,
           dcn.deform_sample_bwd_bf16_kernel,
           dcn.deform_sample_bwd_scatter_bf16_kernel,
           dcn.deform_sample_fwd_kernel, dcn.deform_sample_bwd_kernel,
           dcn.deform_sample_bwd_scatter_kernel,
           *ops_upfirdn2d.upfirdn2d_kernels,
           fused_act.fused_leaky_relu_fwd_kernel,
           fused_act.fused_leaky_relu_bwd_kernel,
           fused_act.fused_leaky_relu_bwd2_kernel)


def test_cpu_tensors_never_reach_a_kernel(monkeypatch):
    """A request and a training step on the CPU, with either alignment,
    in f32 and in bf16, launch no kernel and build no library."""
    monkeypatch.setattr(correlation, '_prologue_cuda', _refuse)
    monkeypatch.setattr(correlation, '_match_patches_cuda', _refuse)
    monkeypatch.setattr(dcn, '_mdcn_fused_forward_cuda', _refuse)
    monkeypatch.setattr(dcn, '_mdcn_fused_backward_cuda', _refuse)
    monkeypatch.setattr(dcn._DeformSample, 'apply', _refuse)
    before = [kernel.launches for kernel in KERNELS]
    rng = np.random.RandomState(0)
    for alignment, mp in (('dcn', None), ('flow', None),
                          ('dcn', 'bfloat16'), ('flow', 'bfloat16')):
        opt = _tiny_train_opt()
        opt['network_g']['alignment'] = alignment
        if mp:
            opt['train']['mixed_precision'] = mp
            opt['val'] = {'mixed_precision': mp}
        model = build_model(opt, device='cpu')
        model.feed_data({
            'img_in': rng.rand(1, 16, 16, 3),
            'img_in_lq': rng.rand(1, 4, 4, 3),
            'img_in_up': rng.rand(1, 16, 16, 3),
            'img_ref_list': rng.rand(1, 2, 16, 16, 3)})
        model.test()
        assert np.isfinite(model.get_current_visuals()['rlt']).all()
        model.optimize_parameters(1)
        assert np.isfinite(model.get_current_log()['l_pix'])
    assert [kernel.launches for kernel in KERNELS] == before
    assert _build._libs == {}


def test_cpu_tensors_never_reach_a_kernel_in_the_gan_and_ref_steps(
        monkeypatch):
    """A bf16 pixel step, then a GAN step (the penalty's double backward
    included), of either alignment, and a single-ref request and step, on
    the CPU, launch no kernel and build no library."""
    monkeypatch.setattr(correlation, '_prologue_cuda', _refuse)
    monkeypatch.setattr(correlation, '_match_patches_cuda', _refuse)
    monkeypatch.setattr(dcn, '_mdcn_fused_forward_cuda', _refuse)
    monkeypatch.setattr(dcn, '_mdcn_fused_backward_cuda', _refuse)
    monkeypatch.setattr(dcn._DeformSample, 'apply', _refuse)
    before = [kernel.launches for kernel in KERNELS]
    rng = np.random.RandomState(1)
    batch = {'img_in': rng.rand(1, 32, 32, 3),
             'img_in_lq': rng.rand(1, 8, 8, 3),
             'img_in_up': rng.rand(1, 32, 32, 3),
             'img_ref_list': rng.rand(1, 2, 32, 32, 3)}
    for alignment in ('dcn', 'flow'):
        opt = _tiny_train_opt()
        opt['network_g']['alignment'] = alignment
        opt['network_d'] = {'type': 'ImageDiscriminator', 'ndf': 4}
        opt['train'].update(mixed_precision='bfloat16', gan_type='wgan',
                            gan_weight=1e-5, grad_penalty_weight=10.,
                            lr_d=1e-4, net_g_pretrain_steps=1)
        model = build_model(opt, device='cpu')
        for step in (1, 2):
            model.feed_data(batch)
            model.optimize_parameters(step)
            assert all(np.isfinite(v)
                       for v in model.get_current_log().values())
    opt = _tiny_train_opt()
    opt.update(model_type='RefRestorationModel',
               network_extractor={'type': 'ContrasExtractorSep'})
    opt['network_g']['type'] = 'RestorationNet'
    model = build_model(opt, device='cpu')
    single = dict(batch, img_ref=batch['img_ref_list'][:, 0])
    del single['img_ref_list']
    model.feed_data(single)
    model.test()
    assert np.isfinite(model.get_current_visuals()['rlt']).all()
    model.optimize_parameters(1)
    assert np.isfinite(model.get_current_log()['l_pix'])
    assert [kernel.launches for kernel in KERNELS] == before
    assert _build._libs == {}


def test_scan_covers_the_sr_and_video_training_modules():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ('utils/file_client.py', 'metrics/__init__.py',
                   'metrics/psnr_ssim.py', 'models/sr_model.py',
                   'models/video_base_model.py',
                   'models/video_recurrent_model.py',
                   'data/reds_dataset.py', 'data/vimeo90k_dataset.py',
                   'data/video_test_dataset.py',
                   'data/paired_image_dataset.py', 'archs/srresnet_arch.py'):
        assert f'mrefsr_tpu_torch/{module}' in names


def test_scan_covers_the_gan_and_single_ref_modules():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ('parallel/batch_norm.py', 'archs/discriminator_arch.py',
                   'archs/ref_restoration_arch.py', 'losses/loss_util.py',
                   'losses/legacy_losses.py',
                   'models/ref_restoration_model.py',
                   'data/ref_megadepth_dataset.py',
                   'data/ref_cufed_dataset.py'):
        assert f'mrefsr_tpu_torch/{module}' in names


def test_scan_covers_the_video_zoo_modules():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ('archs/basicvsr_arch.py', 'archs/edvr_arch.py',
                   'archs/tof_arch.py', 'archs/duf_arch.py',
                   'archs/discriminator_arch.py', 'data/data_util.py',
                   'data/video_test_dataset.py', 'models/srgan_model.py',
                   'models/video_base_model.py',
                   'models/video_recurrent_model.py', 'convert.py'):
        assert f'mrefsr_tpu_torch/{module}' in names


@pytest.mark.parametrize('mp', [None, 'bfloat16'])
def test_cpu_tensors_never_reach_a_kernel_in_an_iconvsr_step(monkeypatch,
                                                              mp):
    """An IconVSR training step (its keyframes' deformable alignment
    included; lq 36, which SpyNet takes at 64) and its eval on the CPU, in
    f32 and in bf16, launch no kernel and build no library."""
    monkeypatch.setattr(dcn, '_mdcn_fused_forward_cuda', _refuse)
    monkeypatch.setattr(dcn, '_mdcn_fused_backward_cuda', _refuse)
    before = [kernel.launches for kernel in KERNELS]
    train = {'optim_g': {'type': 'Adam', 'lr': 1e-4},
             'pixel_opt': {'type': 'CharbonnierLoss'}, 'fix_flow': 2,
             'flow_lr_mul': 0.125}
    val = {}
    if mp:
        train['mixed_precision'] = val['mixed_precision'] = mp
    model = build_model({
        'model_type': 'VideoRecurrentModel', 'scale': 4, 'is_train': True,
        'network_g': {'type': 'IconVSR', 'num_feat': 8, 'num_block': 1},
        'path': {}, 'train': train, 'val': val}, device='cpu')
    rng = np.random.RandomState(2)
    model.feed_data({'lq': rng.rand(1, 5, 36, 36, 3),
                     'gt': rng.rand(1, 5, 144, 144, 3)})
    model.optimize_parameters(1)
    assert np.isfinite(model.get_current_log()['l_pix'])
    model.test()
    assert model.output.shape == (1, 5, 144, 144, 3)
    assert torch.isfinite(model.output).all()
    assert [kernel.launches for kernel in KERNELS] == before
    assert _build._libs == {}


def test_cpu_tensors_never_reach_the_stylegan2_kernels(monkeypatch):
    """A StyleGAN2 training step with both penalties (the double backward
    included) and a sample on the CPU launch no kernel and build no
    library."""
    monkeypatch.setattr(ops_upfirdn2d, '_upfirdn2d_cuda', _refuse)
    monkeypatch.setattr(ops_upfirdn2d._UpFirDn2d, 'apply', _refuse)
    monkeypatch.setattr(fused_act._FusedLeakyReLU, 'apply', _refuse)
    monkeypatch.setattr(fused_act._FusedLeakyReLUBackward, 'apply', _refuse)
    monkeypatch.setattr(fused_act._FusedLeakyReLUDoubleBackward, 'apply',
                        _refuse)
    monkeypatch.setattr(fused_act, '_bwd_cuda', _refuse)
    before = [kernel.launches for kernel in KERNELS]
    model = build_model(_tiny_stylegan2_opt(), device='cpu')
    rng = np.random.RandomState(0)
    model.feed_data({'gt': rng.rand(2, 16, 16, 3) * 2 - 1})
    model.optimize_parameters(1)
    log = model.get_current_log()
    assert log['l_d_r1'] > 0 and log['l_g_path'] >= 0
    assert all(np.isfinite(v) for v in log.values())
    model.test()
    assert torch.isfinite(model.output).all()
    assert [kernel.launches for kernel in KERNELS] == before
    assert _build._libs == {}


def test_stylegan2_kernel_wrappers_take_cuda_tensors_only():
    """The wrappers that launch K7 and K8 refuse a tensor that is not a
    float32 CUDA tensor before they build or launch anything."""
    x = torch.zeros((1, 2, 4, 4))
    fir = torch.ones((2, 2))
    with pytest.raises(TypeError, match='float32 CUDA'):
        ops_upfirdn2d._upfirdn2d_cuda(x, fir, 1, 1, (0, 0, 0, 0), 0)
    with pytest.raises(ValueError, match='at most 64 taps'):
        ops_upfirdn2d._upfirdn2d_cuda(
            torch.zeros((1, 1, 16, 16)), torch.ones((9, 9)), 1, 1,
            (0, 0, 0, 0), 0)
    with pytest.raises(TypeError, match='float32 CUDA'):
        fused_act._FusedLeakyReLU.apply(x, None, 0.2, 1.0)
    with pytest.raises(TypeError, match='float32 CUDA'):
        fused_act._FusedLeakyReLUBackward.apply(x, x, True, 16, 0.2, 1.0, 1)
    with pytest.raises(TypeError, match='float32 CUDA'):
        fused_act._FusedLeakyReLUDoubleBackward.apply(x, None, x, 16, 0.2,
                                                      1.0, 2)
    assert _build._libs == {}


def test_ops_refuse_other_devices():
    x = torch.empty((1, 4, 4, 8), device='meta')
    with pytest.raises(RuntimeError, match='cuda or cpu'):
        correlation.feature_match_index(x[0], x[0])
    with pytest.raises(RuntimeError, match='cuda or cpu'):
        dcn.modulated_deform_conv2d(
            x, torch.empty((1, 4, 4, 1, 9, 2), device='meta'),
            torch.empty((1, 4, 4, 1, 9), device='meta'),
            torch.empty((3, 3, 8, 8), device='meta'))
    with pytest.raises(RuntimeError, match='cuda or cpu'):
        dcn.deform_conv2d(
            x, torch.empty((1, 2, 2, 1, 9, 2), device='meta'),
            torch.empty((3, 3, 8, 8), device='meta'))
    with pytest.raises(RuntimeError, match='cuda or cpu'):
        dcn.deform_sample(x, torch.empty((1, 4, 4, 2, 2), device='meta'))
    with pytest.raises(RuntimeError, match='cuda or cpu'):
        ops_upfirdn2d.upfirdn2d(x, torch.ones((2, 2)))
    with pytest.raises(RuntimeError, match='cuda or cpu'):
        fused_act.fused_leaky_relu(x, torch.empty((4,), device='meta'))


def test_backward_kernels_refuse_group_widths_they_cannot_sum():
    """The backward kernels add a deform group's runs of 4 channels with
    warp shuffles: C / dg / 4 must be a power of two <= 32."""
    x = torch.zeros((1, 4, 4, 24))
    flow = torch.zeros((1, 4, 4, 2, 2))
    dcn._check_cuda_inputs('deform_sample', x, flow)           # cg4 = 3
    with pytest.raises(ValueError, match='power of two'):
        dcn._check_cuda_inputs('deform_sample', x, flow, backward=True)
    with pytest.raises(ValueError, match='multiples of 4'):
        dcn._check_cuda_inputs('deform_sample', x[..., :6], flow)
    with pytest.raises(TypeError, match='float32'):
        dcn._check_cuda_inputs('deform_sample', x.double(), flow)


def test_scan_covers_the_video_modules():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for stem in ('spynet', 'basicvsr', 'basicvsrpp', 'edvr'):
        assert f'mrefsr_tpu_torch/archs/{stem}_arch.py' in names
    assert {'mrefsr_tpu_torch/ops/warp.py',
            'mrefsr_tpu_torch/ops/resize.py'} <= names


def test_video_nets_on_cpu_tensors_never_reach_a_kernel(monkeypatch):
    """EDVR (DCNv2Pack through the op), a grouped DCNv2Pack and DCNv1, on
    the CPU, forward and backward: no kernel launched, no library built."""
    from mrefsr_tpu_torch.archs.arch_util import DCNv2Pack
    from mrefsr_tpu_torch.archs.edvr_arch import EDVR
    monkeypatch.setattr(dcn._ModulatedDeformConv2d, 'apply', _refuse)
    before = [kernel.launches for kernel in KERNELS]
    net = EDVR(num_feat=8, deformable_groups=2, num_extract_block=1,
               num_reconstruct_block=1)
    out = net(torch.rand((1, 5, 3, 16, 16)))
    pack = DCNv2Pack(8, 8, groups=2, deformable_groups=2)
    out = out.mean() + pack(torch.rand((1, 8, 6, 6)),
                            torch.rand((1, 8, 6, 6))).mean()
    out = out + dcn.deform_conv2d(torch.rand((1, 6, 6, 8)),
                                  torch.rand((1, 4, 4, 2, 9, 2)),
                                  torch.rand((3, 3, 4, 4)), groups=2,
                                  deform_groups=2).mean()
    out.backward()
    assert [kernel.launches for kernel in KERNELS] == before
    assert _build._libs == {}


@pytest.mark.parametrize('mp', [None, 'bfloat16'])
def test_video_training_steps_on_cpu_never_reach_a_kernel(monkeypatch, mp):
    """An ``EDVRModel`` step (grad x through every DCN) and a
    ``VideoRecurrentModel`` step with BasicVSR++ on the CPU, in f32 and
    with ``train.mixed_precision: bfloat16``: no kernel launched, no
    library built."""
    monkeypatch.setattr(dcn._ModulatedDeformConv2d, 'apply', _refuse)
    before = [kernel.launches for kernel in KERNELS]
    train = {'optim_g': {'type': 'Adam', 'lr': 1e-4},
             'pixel_opt': {'type': 'CharbonnierLoss'}}
    if mp:
        train['mixed_precision'] = mp
    for model_type, net, t, lq in (
            ('EDVRModel', {'type': 'EDVR', 'num_feat': 8,
                           'deformable_groups': 2, 'num_extract_block': 1,
                           'num_reconstruct_block': 1}, 5, 16),
            ('VideoRecurrentModel', {'type': 'BasicVSRPlusPlus',
                                     'mid_channels': 8, 'num_blocks': 1},
             2, 64)):
        model = build_model({'model_type': model_type, 'is_train': True,
                             'network_g': net, 'path': {},
                             'train': dict(train)}, device='cpu')
        rng = np.random.RandomState(0)
        gt = (1, 4 * lq, 4 * lq, 3) if model_type == 'EDVRModel' \
            else (1, t, 4 * lq, 4 * lq, 3)
        model.feed_data({'lq': rng.rand(1, t, lq, lq, 3).astype(np.float32),
                         'gt': rng.rand(*gt).astype(np.float32)})
        model.optimize_parameters(1)
        assert np.isfinite(model.get_current_log()['l_pix'])
    assert [kernel.launches for kernel in KERNELS] == before
    assert _build._libs == {}


def test_every_cuda_source_has_its_kernel_objects():
    """Each ``csrc/*.cu`` is bound by at least one ``Kernel``, and the
    headers count for the library names (an edited header rebuilds)."""
    bound = {k.library for k in KERNELS}
    assert bound == {p.stem for p in _build.CSRC.glob('*.cu')}
    assert list(_build.CSRC.glob('*.cuh'))


def _defines(text):
    """``{name: (parameters or None, body)}`` of the ``#define``s of
    ``text``, comments and line continuations taken out first."""
    text = re.sub(r'//[^\n]*', '', text).replace('\\\n', ' ')
    macros = {}
    for m in re.finditer(r'^[ \t]*#define[ \t]+(\w+)(\(([^)]*)\))?(.*)$',
                         text, re.M):
        params = None if m.group(2) is None else [
            p.strip() for p in m.group(3).split(',')]
        macros[m.group(1)] = (params, m.group(4).strip())
    return macros


def _c_entry_points():
    """``{symbol: [parameter declarations]}`` of the ``extern "C"``
    functions of ``ops/csrc/*.cu``, their macros (theirs and the headers')
    expanded."""
    found = {}
    headers = _defines(''.join(p.read_text()
                               for p in sorted(_build.CSRC.glob('*.cuh'))))
    for path in sorted(_build.CSRC.glob('*.cu')):
        text = re.sub(r'//[^\n]*', '', path.read_text())
        text = text.replace('\\\n', ' ')
        macros = {**headers, **_defines(text)}
        text = re.sub(r'^[ \t]*#.*$', '', text, flags=re.M)
        for _ in range(3):      # macros that use macros
            for name, (params, body) in macros.items():
                if params is None:
                    text = re.sub(rf'\b{name}\b', body, text)
                    continue

                def expand(m, params=params, body=body):
                    args = [a.strip() for a in m.group(1).split(',')]
                    for param, arg in zip(params, args):
                        body = re.sub(rf'\b{param}\b', arg, body)
                    return body
                text = re.sub(rf'\b{name}\(([^()]*)\)', expand, text)
        block = text[text.index('extern "C" {'):]
        for m in re.finditer(r'\bint\s+(\w+)\s*\(([^)]*)\)\s*\{', block):
            found[m.group(1)] = [p.strip() for p in m.group(2).split(',')
                                 if p.strip()]
    return found


def _ctype_of(declaration):
    if '*' in declaration:
        return ctypes.c_void_p
    kind = declaration.rsplit(None, 1)[0]
    return {'int': ctypes.c_int, 'long long': ctypes.c_longlong,
            'float': ctypes.c_float}[kind]


# K3's and K5's Kernels call K2's C entry points: their ids name them
_K3_K5 = {id(k): name for name, k in dcn.FUSED_KERNELS.items()
          if not name.startswith(dcn.VARIANTS['k2'] + '_')}


@pytest.mark.parametrize('kernel', KERNELS,
                         ids=lambda k: _K3_K5.get(id(k), k.symbol))
def test_kernel_argtypes_match_the_c_signature(kernel):
    """A Kernel's argtypes have the C entry point's arity, with
    ``c_void_p`` exactly where the C parameter is a pointer: a wrong
    argtype passes a pointer as a 32-bit int, which shows only on the
    card."""
    params = _c_entry_points()[kernel.symbol]
    assert kernel.argtypes == [_ctype_of(p) for p in params], params


def test_every_c_entry_point_has_a_kernel():
    """The scan reads the macro-made signatures (mdcn_fused.cuh's
    FUSED_ARGS in mdcn_fused.cu and mdcn_bf16.cu,
    upfirdn2d.cu's UPFIRDN2D_ENTRY, fused_act.cu's FUSED_BWD_ENTRY), and
    every launch entry point is bound by a Kernel."""
    found = _c_entry_points()
    assert len(found['mdcn_fused_wgrad_launch']) == 7 + 17
    assert len(found['mdcn_fused_wgrad_bf16_launch']) == 7 + 17
    assert len(found['upfirdn2d_bwd2_launch']) == 16
    assert len(found['fused_leaky_relu_bwd2_launch']) == 13
    launches = {name for name in found if name.endswith('_launch')}
    assert launches == {k.symbol for k in KERNELS}


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='nvcc'):
        _build.build()


class _FakeFunction:
    """Stands in for a ctypes function: takes argtypes, returns ``ret``."""

    def __init__(self, ret):
        self.ret = ret

    def __call__(self, *args):
        return self.ret


class _FakeLibrary:
    def __init__(self, code):
        self.feature_match_launch = _FakeFunction(code)
        self.cuda_error_string = _FakeFunction(b'fake error')


@pytest.mark.parametrize('code', [0, 9])
def test_launch_error_raises_and_is_not_counted(monkeypatch, code):
    kernel = _build.Kernel('feature_match', 'feature_match_launch', [])
    monkeypatch.setattr(_build, 'load_library',
                        lambda name: _FakeLibrary(code))
    if code:
        with pytest.raises(RuntimeError, match='CUDA error 9'):
            kernel()
        assert kernel.launches == 0
    else:
        kernel()
        kernel()
        assert kernel.launches == 2


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items()
           if k not in ('PYTHONPATH', 'CUDA_VISIBLE_DEVICES')}
    return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_gpu_or_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device; the smoke run would run')
    here = _run_smoke(REPO)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    shutil.copy(REPO / 'chip_smoke.py', tmp_path)
    alone = _run_smoke(tmp_path)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
    assert 'mrefsr_tpu_torch' in alone.stderr
