"""``calculate_stylegan2_fid`` in the port against the JAX package's
``scripts/metrics/calculate_stylegan2_fid.py`` on the CPU, stage by stage,
on a seeded ``params_ema`` checkpoint of a 512-wide, 8-layer-MLP generator
at 8 x 8 (the JAX script's widths; the depth cut to one up-sampling
block): the JAX script's generator (its own loading of the file, read
from its ``generator.apply``) and the port's ``build_generator`` give the
same images for the same codes and noise (1e-4 of the largest entry); the
mean latent of the JAX script's 64 codes (1e-5 of its largest entry); the
FID of the same features (rtol 1e-9). The scripts' random draws differ,
so their end-to-end FIDs are not compared. The port's ``main`` on the CPU
samples from its ``--seed`` alone, the same images twice (another seed
others), in batches of ``--batch_size``.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs.stylegan2_arch import \
    StyleGAN2Generator as JaxStyleGAN2Generator
from mrefsr_tpu_torch.archs.stylegan2_arch import StyleGAN2Generator
from mrefsr_tpu_torch.scripts.metrics import calculate_stylegan2_fid
from mrefsr_tpu_torch.scripts.metrics.calculate_fid_folder import \
    fid_of_features
from test_torch_metric_clis import jax_script

SIZE = 8


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _checkpoint(tmp_path):
    """A seeded generator (``SIZE``, 512-wide style, 8-layer MLP, channel
    multiplier 2) saved as ``params_ema`` in the reference layout."""
    net = StyleGAN2Generator(SIZE, 512, 8, channel_multiplier=2)
    net.init_weights(torch.Generator().manual_seed(1))
    path = str(tmp_path / 'net_g.pth')
    torch.save({'params_ema': net.state_dict()}, path)
    return path


def _stats(tmp_path, dim=16):
    """FID statistics of ``dim`` features, as tensors (the JAX script
    reads them with torch's default ``weights_only`` load)."""
    feats = np.random.RandomState(2).randn(40, dim)
    path = str(tmp_path / 'stats.pth')
    torch.save({'mean': torch.from_numpy(feats.mean(0)),
                'cov': torch.from_numpy(np.cov(feats, rowvar=False))}, path)
    return path


FEATURES = np.random.RandomState(3).randn(6, 16) * 1.3 + 0.2


def test_stylegan2_fid_stages_match_the_jax_script(tmp_path, monkeypatch,
                                                   capsys):
    ckpt, stats = _checkpoint(tmp_path), _stats(tmp_path)
    script = jax_script('calculate_stylegan2_fid')
    seen = {}

    class Recorder:
        def __init__(self, **kwargs):
            self.module = JaxStyleGAN2Generator(**kwargs)

        def apply(self, variables, styles, **kwargs):
            seen.update(variables=variables, z=styles[0], **kwargs)
            return self.module.apply(variables, styles, **kwargs)

    def features(batches, feature_fn, total):
        seen['images'] = [np.asarray(b) for b in batches]
        return FEATURES

    monkeypatch.setattr(script, 'StyleGAN2Generator', Recorder)
    monkeypatch.setattr(script, 'load_patched_inception_v3',
                        lambda path: (None, None, None))
    monkeypatch.setattr(script, 'extract_inception_features', features)
    monkeypatch.setattr(sys, 'argv', [
        'calculate_stylegan2_fid', ckpt, stats, '--size', str(SIZE),
        '--batch_size', '2', '--num_sample', '2', '--truncation', '0.7',
        '--truncation_mean', '64'])
    script.main()
    want_fid = float(re.search(r'fid: (\S+)', capsys.readouterr().out)[1])
    assert seen['images'][0].shape == (2, SIZE, SIZE, 3)

    # the checkpoint as each script loads it: one set of codes and noise
    net = calculate_stylegan2_fid.build_generator(ckpt, SIZE, 2, 'cpu')
    rng = np.random.RandomState(4)
    z = rng.randn(2, 512).astype(np.float32)
    noise = [rng.randn(2, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2))
             .astype(np.float32) for i in range(net.num_layers)]
    latent = np.asarray(seen['truncation_latent'])
    want, _ = JaxStyleGAN2Generator(
        out_size=SIZE, num_style_feat=512, num_mlp=8,
        channel_multiplier=2).apply(
            seen['variables'], [jnp.asarray(z)], truncation=0.7,
            truncation_latent=jnp.asarray(latent),
            noise=[jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise])
    got = calculate_stylegan2_fid.sample(
        net, torch.from_numpy(z), 0.7, torch.from_numpy(latent),
        noise=[torch.from_numpy(n) for n in noise])
    want = np.asarray(want)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-4, err

    # the mean latent of the JAX script's codes
    _, key = jax.random.split(jax.random.PRNGKey(0))
    latent_in = np.asarray(jax.random.normal(key, (64, 512)))
    mean = calculate_stylegan2_fid.mean_latent(net,
                                               torch.from_numpy(latent_in))
    assert mean.shape == latent.shape == (1, 512)
    np.testing.assert_allclose(mean.numpy(), latent, rtol=0,
                               atol=1e-5 * np.abs(latent).max())

    # the FID of the same features
    np.testing.assert_allclose(fid_of_features(FEATURES[:2], stats),
                               want_fid, rtol=1e-9)


def test_stylegan2_fid_main_samples_from_its_seed(tmp_path, monkeypatch,
                                                  capsys):
    """The port's ``main`` on the CPU, the Inception replaced by a
    recorder of its batches: 3 samples in batches of 2 (the last one
    whole, then cut), the same images from the same ``--seed`` and
    others from another; ``fid:`` that of the features."""
    ckpt, stats = _checkpoint(tmp_path), _stats(tmp_path)
    runs = []

    def features(batches, inception, total):
        runs.append([b.clone() for b in batches])
        return FEATURES[:2 * total]

    monkeypatch.setattr(calculate_stylegan2_fid,
                        'extract_inception_features', features)
    monkeypatch.setattr(calculate_stylegan2_fid,
                        'load_patched_inception_v3',
                        lambda path, device: None)
    argv = [ckpt, stats, '--size', str(SIZE), '--batch_size', '2',
            '--num_sample', '3', '--truncation', '0.7',
            '--truncation_mean', '16', '--device', 'cpu']
    fid = calculate_stylegan2_fid.main(argv)
    calculate_stylegan2_fid.main(argv)
    calculate_stylegan2_fid.main(argv + ['--seed', '5'])
    assert f'fid: {fid}' in capsys.readouterr().out
    assert fid == fid_of_features(FEATURES[:3], stats)
    assert [b.shape for b in runs[0]] == [(2, SIZE, SIZE, 3)] * 2
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    assert not torch.equal(runs[0][0], runs[2][0])
    assert all(bool(torch.isfinite(b).all()) for b in runs[0])
