"""One rank of the port's multi-process tests on the CPU.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r python tests/torch_dist_worker.py \\
        TASK SPEC OUT_DIR

joins the group through ``mrefsr_tpu_torch.utils.dist_util.init_dist``
(``pytorch`` launcher, gloo, the ``file://`` rendezvous the spec names),
runs ``TASK`` on the inputs of ``SPEC`` (a ``torch.save`` file) and writes
its report to ``OUT_DIR/rank<r>.pt``. The test files start the ranks with
:func:`spawn`, which waits for them with a time limit. Like the port, this
file imports no jax: the ranks are processes of their own, apart from the
test process, which holds the JAX side.
"""
import os
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from mrefsr_tpu_torch.data.loader import default_collate  # noqa: E402

# the dry run's net and batch (__graft_entry__.py:212-252): ngf 8, 1
# block, 2 deform groups, T 2, gt 32
T, GT = 2, 32
PADDED = 1                    # the validation item that carries padding
ORIGINAL_SIZE = (24, 28)


def train_opt(alignment, root, dist=True):
    """The dry run's options with ``alignment``, ``dist`` and the
    checkpoint directories under ``root``."""
    return {
        'name': 'ddp_test', 'model_type': 'MultiRefRestorationModel',
        'scale': 4, 'crop_border': 4, 'num_gpu': 2, 'manual_seed': 0,
        'is_train': True, 'dist': dist,
        'network_g': {'type': 'MRAPARestorationNet', 'ngf': 8,
                      'n_blocks': 1, 'groups': 2, 'alignment': alignment},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'patch_size': 3, 'stride': 1,
                        'vgg_layer_list': ['relu1_1', 'relu2_1', 'relu3_1'],
                        'vgg_type': 'vgg19'},
        'network_extractor': {'type': 'ContrasMultiExtractorSep'},
        'path': {'models': os.path.join(root, 'models'),
                 'training_states': os.path.join(root, 'training_states')},
        'train': {
            'lr_g': 1e-4, 'lr_offset': 1e-4, 'lr_relu3_offset': 1e-6,
            'lr_relu2_offset': 1e-5, 'weight_decay_g': 0,
            'beta_g': [0.9, 0.999],
            'scheduler': {'type': 'MultiStepLR', 'milestones': [2],
                          'gamma': 0.5},
            'total_iter': 10, 'warmup_iter': -1, 'net_g_pretrain_steps': 3,
            'pixel_criterion': 'L1Loss', 'pixel_weight': 1.0},
    }


def gan_opt(alignment, root, dist=True, pretrain=0):
    """The JAX model tests' GAN options (``ImageDiscriminator`` of ndf 4,
    wgan, ``gan_weight`` 1e-5, penalty 10) on :func:`train_opt`'s, G
    updating every ``net_d_steps: 2`` GAN steps after the first."""
    opt = train_opt(alignment, root, dist)
    opt['network_d'] = {'type': 'ImageDiscriminator', 'in_nc': 3, 'ndf': 4}
    opt['train'].update(
        net_g_pretrain_steps=pretrain, net_d_steps=2, net_d_init_steps=1,
        lr_d=1e-4, weight_decay_d=0, beta_d=[0.9, 0.999], gan_type='wgan',
        gan_weight=1e-5, grad_penalty_weight=10.0,
        scheduler={'type': 'MultiStepLR', 'milestones': [300000],
                   'gamma': 0.5})
    return opt


def batch(rng, b, gt=GT):
    """A training batch of ``b`` samples in the dry run's shapes (at
    ``gt``)."""
    return {
        'img_in': rng.rand(b, gt, gt, 3).astype(np.float32),
        'img_in_lq': rng.rand(b, gt // 4, gt // 4, 3).astype(np.float32),
        'img_in_up': rng.rand(b, gt, gt, 3).astype(np.float32),
        'img_ref_list': rng.rand(b, T, gt, gt, 3).astype(np.float32),
    }


class TinyValSet:
    """Three seeded CUFED5-style items (``__graft_entry__.py:287-305``);
    item ``PADDED`` is padded to the canvas, its gt of
    ``ORIGINAL_SIZE``."""
    opt = {'name': 'tiny_val'}

    def __len__(self):
        return 3

    def __getitem__(self, i):
        r = np.random.RandomState(100 + i)
        item = {
            'img_in': r.rand(GT, GT, 3).astype(np.float32),
            'img_in_lq': r.rand(GT // 4, GT // 4, 3).astype(np.float32),
            'img_in_up': r.rand(GT, GT, 3).astype(np.float32),
            'img_ref_list': r.rand(T, GT, GT, 3).astype(np.float32),
            'lq_path': f'tiny_{i:03d}.png',
        }
        if i == PADDED:
            height, width = ORIGINAL_SIZE
            item['img_in'] = item['img_in'][:height, :width].copy()
            item['padding'] = True
            item['original_size'] = ORIGINAL_SIZE
        return item


class TinyValLoader:
    """A validation loader: batch 1, no sampler."""
    dataset = TinyValSet()
    sampler = None
    batch_size = 1

    def __iter__(self):
        return (default_collate([self.dataset[i]])
                for i in range(len(self.dataset)))


# ------------------------------------------------------------- the parent
def spawn(task, spec, tmp_path, world, timeout=300):
    """Run ``task`` on ``world`` ranks, each a process of this script,
    and return their reports by rank. Raises if a rank fails or the ranks
    outlive ``timeout`` seconds (then they are killed)."""
    spec = dict(spec, init_method=f'file://{tmp_path / "rendezvous"}')
    spec_path = tmp_path / 'spec.pt'
    torch.save(spec, spec_path)
    out_dir = tmp_path / 'reports'
    out_dir.mkdir()
    env = dict(os.environ, WORLD_SIZE=str(world), OMP_NUM_THREADS='2',
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get('PYTHONPATH')]
                                  if p]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(spec_path), str(out_dir)],
        env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    failed = [f'rank {rank} exited with {proc.returncode}:\n{out[-3000:]}'
              for rank, (proc, out) in enumerate(zip(procs, outputs))
              if proc.returncode != 0]
    if failed:
        raise RuntimeError('\n'.join(failed))
    return [torch.load(out_dir / f'rank{rank}.pt', weights_only=True)
            for rank in range(world)]


# -------------------------------------------------------------- the tasks
def run_sharded_match(spec, rank, world):
    """Every case of ``spec['cases']``: the ref split into the case's
    bands (one ``(start, stop)`` of image rows a rank), through
    ``feature_match_index_sharded`` and its plain version."""
    from mrefsr_tpu_torch.ops import correlation
    report = {}
    for name, case in spec['cases'].items():
        start, stop = case['bands'][rank]
        shard = (case['feat_ref'][..., start:stop, :, :], start)
        kw = case['kwargs']
        report[name] = {
            'kernel': correlation.feature_match_index_sharded(
                case['feat_in'], shard, **kw),
            'plain': correlation.feature_match_index_sharded_ref(
                case['feat_in'], shard, **kw)}
    report['kernel_launches'] = \
        correlation.feature_match_sharded_kernel.launches
    return report


def _load(model, weights, keys=('extractor', 'map', 'g')):
    """The spec's state dicts into the bare nets named by ``keys``, as the
    JAX package's weights come into the port (``load_from_flax``)."""
    nets = dict(zip(('extractor', 'map', 'g'), model._nets()))
    for key in keys:
        nets[key].load_state_dict(weights[key], strict=True)
    model._to_channels_last()


def _params(model):
    return {k: v.detach().clone() for k, v in
            model.get_bare_model(model.net_g).state_dict().items()}


def _rank_batch(full, rank):
    """This rank's rows of a global batch."""
    return {k: v[rank:rank + 1].numpy() for k, v in full.items()}


@contextmanager
def _recorded_saves(written):
    """Record the name of every file ``torch.save`` writes."""
    save = torch.save

    def recording(obj, path, *args, **kwargs):
        written.append(os.path.basename(str(path)))
        return save(obj, path, *args, **kwargs)

    with mock.patch.object(torch, 'save', recording):
        yield


def run_ddp(spec, rank, world):
    """For each alignment: sharded validation at the loaded weights; the
    DDP gradient of one batch; three steps one at a time, as a wave, and
    on the global batch in one process without DDP; then a save
    at step 3, and step 4 unbroken and from the files."""
    import torch.distributed as dist

    from mrefsr_tpu_torch.models import build_model
    root = spec['root']
    report = {}
    loader = TinyValLoader()
    for alignment in spec['alignments']:
        weights = spec['weights'][alignment]
        batches = [_rank_batch(b, rank) for b in spec['batches']]
        out = report[alignment] = {}
        opt = train_opt(alignment, os.path.join(root, alignment))
        model = build_model(opt, device='cpu')
        _load(model, weights)

        # validation: this rank's shard, the reduced averages, the whole set
        out['shard_sums'] = torch.from_numpy(model._validate_images(
            loader, 0, False, rank=rank, world=world))
        model.validation(loader, 0, None)
        out['metric_results'] = dict(model.metric_results)
        if rank == 0:
            out['full_sums'] = torch.from_numpy(
                model._validate_images(loader, 0, False))

        # the DDP gradient of one step's batch, before any step
        model.feed_data(batches[0])
        model.net_g.zero_grad(set_to_none=True)
        model.cri_pix(model._forward(model.match_img_in, model.img_ref_list,
                                     model.img_in_lq), model.gt).backward()
        bare = model.get_bare_model(model.net_g)
        out['ddp_grads'] = {n: p.grad.clone()
                            for n, p in bare.named_parameters()}
        # every rank also runs the work below (no rank idles in a
        # collective while another works): each rank's sample through the
        # bare net, averaged
        total, missing = {}, set()
        for r in range(world):
            model.feed_data(_rank_batch(spec['batches'][0], r))
            bare.zero_grad(set_to_none=True)
            model.cri_pix(model._forward(
                model.match_img_in, model.img_ref_list, model.img_in_lq,
                bare), model.gt).backward()
            for n, p in bare.named_parameters():
                if p.grad is None:
                    missing.add(n)
                else:
                    total[n] = total.get(n, 0) + p.grad / world
        out['mean_grads'] = total
        out['unused_params'] = sorted(missing)
        bare.zero_grad(set_to_none=True)

        # three steps one at a time, and the same three as a wave
        losses = []
        for step in range(1, 4):
            model.feed_data(batches[step - 1])
            model.optimize_parameters(step)
            losses.append(model.get_current_log()['l_pix'])
        out['losses'] = losses
        out['params'] = _params(model)
        # the global batch on one process, without DDP
        single = build_model(train_opt(alignment, root, dist=False),
                             device='cpu')
        _load(single, weights)
        for step in range(1, 4):
            single.feed_data({k: v.numpy() for k, v
                              in spec['batches'][step - 1].items()})
            single.optimize_parameters(step)
        out['single_loss'] = single.get_current_log()['l_pix']
        out['single_params'] = _params(single)
        del single
        wave = build_model(opt, device='cpu')
        _load(wave, weights)
        wave.optimize_parameters_wave(batches[:3], 1)
        out['wave_loss'] = wave.get_current_log()['l_pix']
        out['wave_params'] = _params(wave)
        del wave

        # save at step 3; step 4 unbroken, then from the files
        written = []
        with _recorded_saves(written):
            model.save(0, 3)
        out['written'] = written
        dist.barrier()
        model.feed_data(batches[3])
        model.optimize_parameters(4)
        out['unbroken_loss'] = model.get_current_log()['l_pix']
        out['unbroken_params'] = _params(model)
        pth = os.path.join(opt['path']['models'], 'net_g_3.pth')
        out['pth_keys'] = sorted(torch.load(pth, weights_only=True)['params'])
        resumed_opt = dict(opt, path=dict(opt['path'],
                                          pretrain_network_g=pth))
        resumed = build_model(resumed_opt, device='cpu')
        _load(resumed, weights, ('extractor', 'map'))   # net_g: the .pth
        state = resumed.load_training_state(
            os.path.join(opt['path']['training_states'], '3.state'))
        resumed.resume_training(state)
        resumed.feed_data(batches[3])
        resumed.optimize_parameters(state['iter'] + 1)
        out['resumed_loss'] = resumed.get_current_log()['l_pix']
        out['resumed_params'] = _params(resumed)
        del model, resumed
    return report


def run_ddp_bf16(spec, rank, world):
    """``train.mixed_precision: bfloat16`` under DDP, ``dcn`` alignment,
    from the seeded weights (the same on every rank): the DDP gradient of
    one step's batch and, on every rank alike, the mean of each rank's
    sample through the bare net; then two steps."""
    from mrefsr_tpu_torch.models import build_model
    opt = train_opt('dcn', os.path.join(spec['root'], 'bf16'))
    opt['train']['mixed_precision'] = 'bfloat16'
    model = build_model(opt, device='cpu')
    bare = model.get_bare_model(model.net_g)
    batches = [_rank_batch(b, rank) for b in spec['batches']]
    model.feed_data(batches[0])
    model.net_g.zero_grad(set_to_none=True)
    model.cri_pix(model._forward(model.match_img_in, model.img_ref_list,
                                 model.img_in_lq), model.gt).backward()
    report = {'ddp_grads': {n: p.grad.clone()
                            for n, p in bare.named_parameters()}}
    total = {}
    for r in range(world):
        model.feed_data(_rank_batch(spec['batches'][0], r))
        bare.zero_grad(set_to_none=True)
        model.cri_pix(model._forward(model.match_img_in, model.img_ref_list,
                                     model.img_in_lq, bare),
                      model.gt).backward()
        for n, p in bare.named_parameters():
            total[n] = total.get(n, 0) + p.grad / world
    report['mean_grads'] = total
    bare.zero_grad(set_to_none=True)
    losses = []
    for step in (1, 2):
        model.feed_data(batches[step])
        model.optimize_parameters(step)
        losses.append(model.get_current_log()['l_pix'])
    report['losses'] = losses
    report['params'] = _params(model)
    report['param_dtypes'] = sorted({str(p.dtype)
                                     for p in bare.parameters()})
    return report


def _recorded_grads(optimizer, net, record):
    """Append ``net``'s gradients by name to ``record`` at each step of
    ``optimizer``, before it steps."""
    step = optimizer.step

    def recording(*args, **kwargs):
        record.append({n: p.grad.detach().clone()
                       for n, p in net.named_parameters()})
        return step(*args, **kwargs)

    optimizer.step = recording


def run_ddp_gan(spec, rank, world):
    """GAN steps (G on each) of the ``dcn`` model with
    ``dist: true`` on this rank's sample, and the same on every rank in
    one process without DDP on the global batch: D's and G's gradients at
    each step, D's state and the logs."""
    from mrefsr_tpu_torch.models import build_model
    report = {}
    for prefix, dist_on, rows in (('', True, rank), ('single_', False,
                                                      None)):
        opt = gan_opt('dcn', '', dist=dist_on)
        opt['train'].update(net_d_steps=1, net_d_init_steps=0)
        model = build_model(opt, device='cpu')
        d_grads, g_grads = [], []
        _recorded_grads(model.optimizer_d, model.net_d, d_grads)
        _recorded_grads(model.optimizer_g,
                        model.get_bare_model(model.net_g), g_grads)
        for step, full in enumerate(spec['batches'], 1):
            model.feed_data(_rank_batch(full, rows) if dist_on else
                            {k: v.numpy() for k, v in full.items()})
            model.optimize_parameters(step)
        report[prefix + 'd_grads'] = d_grads
        report[prefix + 'g_grads'] = g_grads
        report[prefix + 'd_state'] = {k: v.clone() for k, v in
                                      model.net_d.state_dict().items()}
        report[prefix + 'log'] = model.get_current_log()
        del model
    return report


def _net_d_state(model):
    return {k: v.detach().clone() for k, v in
            model.net_d.state_dict().items()}


def run_realesr(spec, rank, world):
    """``RealESRNetModel`` and ``RealESRGANModel`` with ``dist: true``,
    each of ``spec['runs']`` (by name) in turn: each step this rank's
    batch through ``feed_data`` (synthesis, crop, this rank's pool), the
    pairs that come out, the bare nets' parameters (and ``net_d``'s power
    iteration vectors) before the step and the averaged gradients it steps
    with; then a save and validation (rank 0 alone writes and scores)."""
    from mrefsr_tpu_torch.data import build_dataloader, build_dataset
    from mrefsr_tpu_torch.models import build_model
    reports = {}
    for name, run in spec['runs'].items():
        model = build_model(run['opt'], device='cpu')
        gan = getattr(model, 'net_d', None) is not None
        report = {'lq': [], 'gt': [], 'params_before': [], 'grads': []}
        _recorded_grads(model.optimizer_g, model.get_bare_model(model.net_g),
                        report['grads'])
        if gan:
            report.update(d_before=[], d_grads=[])
            _recorded_grads(model.optimizer_d, model.net_d,
                            report['d_grads'])
        for step, batch in enumerate(run['batches'][rank], 1):
            model.feed_data({k: v.numpy() for k, v in batch.items()})
            report['lq'].append(model.lq.clone())
            report['gt'].append(model.gt.clone())
            report['params_before'].append(_params(model))
            if gan:
                report['d_before'].append(_net_d_state(model))
            model.optimize_parameters(step)
        report['params'] = _params(model)
        if gan:
            report['d_state'] = _net_d_state(model)
        report['ema'] = {k: v.detach().clone() for k, v in
                         model.net_g_ema.state_dict().items()}
        written = []
        with _recorded_saves(written):
            model.save(0, len(run['batches'][rank]))
        report['written'] = written
        val_opt = spec['val_opt']
        model.validation(build_dataloader(build_dataset(val_opt), val_opt),
                         1, None, save_img=False)
        report['metric_results'] = {k: float(v) for k, v in
                                    getattr(model, 'metric_results',
                                            {}).items()}
        reports[name] = report
        del model
    return reports


def video_validation(spec):
    """Each ``(model options, dataset options)`` of ``spec['video']``
    through ``validation`` (frames sharded over the ranks for a sliding-
    window model, folders for a recurrent one): the per-folder metric
    arrays as tensors."""
    from mrefsr_tpu_torch.data import build_dataloader, build_dataset
    from mrefsr_tpu_torch.models import build_model
    report = {}
    for name, (model_opt, data_opt) in spec['video'].items():
        model = build_model(model_opt, device='cpu')
        loader = build_dataloader(build_dataset(data_opt), data_opt)
        model.validation(loader, 1, None, save_img=False)
        report[name] = {folder: torch.from_numpy(arr) for folder, arr
                        in model.metric_results.items()}
    return report


def run_video_val(spec, rank, world):
    return video_validation(spec)


TASKS = {'sharded_match': run_sharded_match, 'ddp': run_ddp,
         'ddp_bf16': run_ddp_bf16, 'ddp_gan': run_ddp_gan,
         'video_val': run_video_val, 'realesr': run_realesr}


def main():
    import torch.distributed as dist

    from mrefsr_tpu_torch.utils.dist_util import get_dist_info, init_dist
    task, spec_path, out_dir = sys.argv[1:4]
    torch.set_num_threads(2)
    spec = torch.load(spec_path, weights_only=True)
    init_dist('pytorch', backend='gloo', init_method=spec['init_method'])
    rank, world = get_dist_info()
    try:
        report = TASKS[task](spec, rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(report, os.path.join(out_dir, f'rank{rank}.pt'))


if __name__ == '__main__':
    main()
