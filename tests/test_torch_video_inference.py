"""The port's video inference on the CPU: ``utils.read_img_seq`` and
``img2tensor`` against the JAX package's, ``inference`` (frames in, uint8
frames out) against the JAX model and ``tensor2img``, and ``main`` of
both entry points on ``--device cpu`` over a few tiny PNG frames: the
BasicVSR++ REDS configuration at full width, chunked by ``--interval``,
with seeded weights or weights from ``--model_path``, from a folder or
from a video split by ``ffmpeg`` (a stand-in on ``PATH``); no kernel is
launched and no library built.

Tolerance: uint8 frames within 1 of the JAX package's (a value on a
rounding boundary may fall either way), most of them equal.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrefsr_tpu.archs import basicvsr_arch as jax_basicvsr
from mrefsr_tpu.data.data_util import read_img_seq as jax_read_img_seq
from mrefsr_tpu.utils import img2tensor as jax_img2tensor
from mrefsr_tpu.utils import tensor2img as jax_tensor2img
from mrefsr_tpu_torch.archs.basicvsr_arch import BasicVSR
from mrefsr_tpu_torch.convert import load_from_flax
from mrefsr_tpu_torch.inference import (inference_basicvsr,
                                        inference_basicvsrpp)
from mrefsr_tpu_torch.ops import _build, dcn
from mrefsr_tpu_torch.utils import img2tensor, read_img_seq
from torch_video_params import random_params


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The test workers of one run share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write_frames(folder, t, h=64, w=64, seed=0):
    """``t`` PNG frames of a smooth image moving a pixel a frame."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    base = cv2.GaussianBlur(rng.randint(0, 256, (h + t, w + t, 3)).astype(
        np.uint8), (5, 5), 0)
    for i in range(t):
        cv2.imwrite(os.path.join(folder, f'{i:08d}.png'),
                    base[i:i + h, i:i + w])
    return sorted(os.path.join(folder, f) for f in os.listdir(folder))


def test_read_img_seq_matches_jax(tmp_path):
    paths = _write_frames(str(tmp_path / 'clip'), 3, 13, 10)
    for arg in (str(tmp_path / 'clip'), paths):
        got, names = read_img_seq(arg, return_imgname=True)
        want, want_names = jax_read_img_seq(arg, return_imgname=True)
        assert got.dtype == np.float32 and got.shape == (3, 13, 10, 3)
        np.testing.assert_array_equal(got, want)
        assert names == want_names == ['00000000', '00000001', '00000002']
    got = read_img_seq(paths, require_mod_crop=True, scale=4)
    assert got.shape == (3, 12, 8, 3)
    np.testing.assert_array_equal(
        got, jax_read_img_seq(paths, require_mod_crop=True, scale=4))


def test_img2tensor_matches_jax():
    rng = np.random.RandomState(1)
    imgs = [rng.rand(5, 4, 3), rng.randint(0, 255, (5, 4)).astype(np.uint8)]
    for got, want in zip(img2tensor(imgs), jax_img2tensor(imgs)):
        assert got.dtype == want.dtype and got.flags['C_CONTIGUOUS']
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(img2tensor(imgs[0], bgr2rgb=False),
                                  jax_img2tensor(imgs[0], bgr2rgb=False))


def test_inference_matches_the_jax_model(tmp_path):
    """``inference`` on the frames ``main`` reads: the uint8 BGR frames of
    the JAX model's output through the JAX ``tensor2img``."""
    imgs = read_img_seq(_write_frames(str(tmp_path / 'clip'), 3))
    jax_net = jax_basicvsr.BasicVSR(num_feat=8, num_block=1)
    params = random_params(jax_net, (jnp.asarray(imgs)[None],), 2)
    out = jax.jit(jax_net.apply)({'params': params}, jnp.asarray(imgs)[None])
    want = [jax_tensor2img(np.asarray(frame)) for frame in out[0]]
    net = inference_basicvsr.build_model(
        BasicVSR, dict(num_feat=8, num_block=1), '', torch.device('cpu'))
    got = inference_basicvsr.inference(imgs, load_from_flax(net, params))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (256, 256, 3)
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99


def _refuse(*_):
    raise AssertionError('a CUDA kernel was reached from CPU tensors')


def test_basicvsrpp_main_on_the_cpu(tmp_path, monkeypatch):
    """The REDS configuration at full width (mid 64, 7 blocks) over 4
    frames in chunks of 2: one PNG per frame, x4, named as the JAX
    script names them; seeded weights when ``--model_path`` is missing;
    the same frames from the same seed; no kernel reached."""
    monkeypatch.setattr(dcn, '_im2col_cuda', _refuse)
    monkeypatch.setattr(dcn, '_col2im_cuda', _refuse)
    launches = [k.launches for k in vars(dcn).values()
                if isinstance(k, _build.Kernel)]
    clip = str(tmp_path / 'clip')
    _write_frames(clip, 4)
    outs = []
    for run in range(2):
        save = str(tmp_path / f'out{run}')
        written = inference_basicvsrpp.main([
            '--input_path', clip, '--save_path', save, '--interval', '2',
            '--model_path', str(tmp_path / 'missing.pth'), '--device',
            'cpu'])
        assert [os.path.basename(p) for p in written] == [
            f'{i:08d}_BasicVSRPP.png' for i in range(4)]
        frames = [cv2.imread(p) for p in written]
        assert all(f.shape == (256, 256, 3) for f in frames)
        outs.append(np.stack(frames))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].std() > 1
    assert [k.launches for k in vars(dcn).values()
            if isinstance(k, _build.Kernel)] == launches
    assert _build._libs == {}


def test_basicvsr_main_takes_weights_from_model_path(tmp_path):
    """A reference-format ``.pth`` at ``--model_path`` is loaded strictly
    and used: its frames are those of a net holding those weights, not the
    seeded ones."""
    clip = str(tmp_path / 'clip')
    paths = _write_frames(clip, 2)
    kwargs = dict(num_feat=8, num_block=1)
    net = inference_basicvsr.build_model(BasicVSR, kwargs, '', 'cpu',
                                         seed=5)
    ckpt = str(tmp_path / 'net.pth')
    torch.save({'params': net.state_dict()}, ckpt)
    run = {}
    for label, path in (('file', ckpt), ('seeded', '')):
        written = inference_basicvsr.main(
            ['--input_path', clip, '--save_path', str(tmp_path / label),
             '--model_path', path, '--device', 'cpu'], BasicVSR, kwargs)
        run[label] = np.stack([cv2.imread(p) for p in written])
    want = np.stack(inference_basicvsr.inference(read_img_seq(paths), net))
    np.testing.assert_array_equal(run['file'], want)
    assert not np.array_equal(run['file'], run['seeded'])


def test_main_splits_a_video_with_ffmpeg(tmp_path, monkeypatch):
    """An ``--input_path`` that is not a folder is split into frames by
    ``ffmpeg`` (here a stand-in that copies prepared PNGs to the pattern it
    is given) under ``./<suffix>_tmp/<video name>``, which is removed
    after."""
    frames = _write_frames(str(tmp_path / 'frames'), 2)
    fake = tmp_path / 'bin' / 'ffmpeg'
    fake.parent.mkdir()
    fake.write_text(
        '#!/bin/sh\n'
        '# copies the prepared frames to the output pattern (last argument)\n'
        'out=$(dirname "$(eval echo \\${$#})")\n'
        + ''.join(f'cp {p} "$out/frame{i + 1:08d}.png"\n'
                  for i, p in enumerate(frames)))
    fake.chmod(0o755)
    monkeypatch.setenv('PATH', f'{fake.parent}:{os.environ["PATH"]}')
    monkeypatch.chdir(tmp_path)
    video = tmp_path / 'clip.mp4'
    video.write_bytes(b'')
    written = inference_basicvsr.main(
        ['--input_path', str(video), '--save_path', str(tmp_path / 'out'),
         '--model_path', '', '--device', 'cpu'], BasicVSR,
        dict(num_feat=8, num_block=1))
    assert [os.path.basename(p) for p in written] == [
        'frame00000001_BasicVSR.png', 'frame00000002_BasicVSR.png']
    assert cv2.imread(written[0]).shape == (256, 256, 3)
    assert not (tmp_path / 'BasicVSR_tmp' / 'clip').exists()


def test_main_without_a_device_raises_on_a_host_without_cuda(tmp_path,
                                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        inference_basicvsrpp.main(['--input_path', str(tmp_path)])
