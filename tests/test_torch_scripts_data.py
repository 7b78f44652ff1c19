"""The port's data-preparation and MATLAB scripts
(``mrefsr_tpu_torch/scripts/data_preparation/``, ``.../matlab_scripts/``)
against the JAX package's (``scripts/data_preparation/``,
``scripts/matlab_scripts/``) on the CPU, on the same tiny folders: the
same file names, and the same decoded images.

Every image here is equal bit for bit: both run OpenCV's crops, blurs and
codecs, and the two MATLAB ``imresize`` agree to the 8-bit level on these
inputs (no level differs, so no 1-LSB allowance is taken). The meta-info
text is equal to the byte. The TFRecord test writes its records with the
installed TensorFlow; the degradations draw from numpy's global generator
in both scripts, seeded alike before each run."""
import glob
import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest

from mrefsr_tpu_torch.scripts.data_preparation import (
    extract_images_from_tfrecords, extract_subimages, generate_bicubic_img,
    generate_meta_info, prepare_hifacegan_dataset, regroup_reds_dataset)
from mrefsr_tpu_torch.scripts.matlab_scripts import (back_projection,
                                                     generate_lr_vimeo90k)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(group, name):
    """The JAX package's ``scripts/<group>/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(REPO, 'scripts', group, f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    # registered, so that a pool's workers find its functions by name
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def _run_jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', [module.__name__] + argv)
    module.main()


def _write_images(folder, sizes, seed, gray=()):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate(sizes):
        shape = (h, w) if i in gray else (h, w, 3)
        img = cv2.GaussianBlur((rng.rand(*shape) * 255).astype(np.uint8),
                               (5, 5), 1.5)
        cv2.imwrite(os.path.join(folder, f'img{i:02d}.png'), img)


def _same_tree(a, b):
    """The two folders hold the same relative file names, and each image
    decodes to the same array."""
    names_a = sorted(os.path.relpath(p, a) for p in glob.glob(
        os.path.join(a, '**', '*.*'), recursive=True))
    names_b = sorted(os.path.relpath(p, b) for p in glob.glob(
        os.path.join(b, '**', '*.*'), recursive=True))
    assert names_a == names_b and names_a
    for name in names_a:
        img_a = cv2.imread(os.path.join(a, name), cv2.IMREAD_UNCHANGED)
        img_b = cv2.imread(os.path.join(b, name), cv2.IMREAD_UNCHANGED)
        assert img_a.shape == img_b.shape, name
        assert np.array_equal(img_a, img_b), (
            name, int(np.abs(img_a.astype(int) - img_b).max()))
    return names_a


def test_extract_subimages(tmp_path):
    """The crop grid (every ``step``, one more flush with the edge beyond
    ``thresh_size``) of three images in a pool of two processes, and the
    exit on an existing output folder."""
    src = str(tmp_path / 'hr')
    _write_images(src, [(70, 90), (64, 64), (50, 81)], seed=0, gray=(1,))
    jax_mod = jax_script('data_preparation', 'extract_subimages')
    for module, out in ((jax_mod, 'jax'), (extract_subimages, 'port')):
        module.extract_subimages({
            'n_thread': 2, 'compression_level': 3, 'input_folder': src,
            'save_folder': str(tmp_path / out), 'crop_size': 32,
            'step': 20, 'thresh_size': 5})
    names = _same_tree(str(tmp_path / 'jax'), str(tmp_path / 'port'))
    # 70 x 90: rows 0, 20 and 38 (8 left over > 5), columns 0, 20, 40, 58
    assert sum(n.startswith('img00') for n in names) == 12
    assert list(extract_subimages.crop_starts(70, 32, 20, 5)) == [0, 20, 38]
    with pytest.raises(SystemExit) as exc:
        extract_subimages.main(['--input', src, '--output',
                                str(tmp_path / 'port'), '--n_thread', '1'])
    assert exc.value.code == 1


def test_generate_meta_info(tmp_path):
    src = str(tmp_path / 'sub')
    _write_images(src, [(40, 52), (33, 30), (20, 21)], seed=1, gray=(2,))
    jax_mod = jax_script('data_preparation', 'generate_meta_info')
    jax_mod.generate_meta_info_div2k(src, str(tmp_path / 'jax.txt'))
    generate_meta_info.main(['--gt_folder', src, '--meta_info_txt',
                             str(tmp_path / 'port.txt')])
    text = (tmp_path / 'port.txt').read_text()
    assert text == (tmp_path / 'jax.txt').read_text()
    assert text.splitlines() == ['img00.png (40,52,3)', 'img01.png (33,30,3)',
                                 'img02.png (20,21,1)']


def test_generate_bicubic_img(tmp_path, monkeypatch):
    """LR (cropped to a multiple of 4 first) and its bicubic upsampling by
    MATLAB's ``imresize``."""
    src = str(tmp_path / 'hr')
    _write_images(src, [(50, 42), (64, 64)], seed=2)
    jax_mod = jax_script('data_preparation', 'generate_bicubic_img')
    for tag, run in (
            ('jax', lambda a: _run_jax_main(jax_mod, a, monkeypatch)),
            ('port', generate_bicubic_img.main)):
        run(['--input', src, '--output_lr', str(tmp_path / tag / 'lr'),
             '--output_bic', str(tmp_path / tag / 'bic'), '--scale', '4'])
    _same_tree(str(tmp_path / 'jax'), str(tmp_path / 'port'))
    assert cv2.imread(str(tmp_path / 'port' / 'lr' / 'img00.png')).shape \
        == (12, 10, 3)


def test_regroup_reds_dataset(tmp_path):
    for tag in ('jax', 'port'):
        for clip in ('000', '007'):
            _write_images(str(tmp_path / tag / 'val' / clip),
                          [(8, 8), (8, 8)], seed=int(clip))
        os.makedirs(tmp_path / tag / 'train')
    jax_mod = jax_script('data_preparation', 'regroup_reds_dataset')
    jax_mod.regroup_reds_dataset(str(tmp_path / 'jax' / 'train'),
                                 str(tmp_path / 'jax' / 'val'))
    regroup_reds_dataset.main(['--train_path', str(tmp_path / 'port' /
                                                   'train'),
                               '--val_path', str(tmp_path / 'port' / 'val')])
    names = _same_tree(str(tmp_path / 'jax' / 'train'),
                       str(tmp_path / 'port' / 'train'))
    assert sorted({n.split(os.sep)[0] for n in names}) == ['240', '247']


@pytest.mark.parametrize('mode', prepare_hifacegan_dataset.MODES)
def test_prepare_hifacegan_dataset(tmp_path, monkeypatch, mode):
    """Each degradation, numpy's global generator seeded alike before each
    run (the noise and JPEG through each package's ``degradations``)."""
    src = str(tmp_path / 'faces')
    _write_images(src, [(40, 40), (37, 45)], seed=3)
    jax_mod = jax_script('data_preparation', 'prepare_hifacegan_dataset')
    for tag, run in (
            ('jax', lambda a: _run_jax_main(jax_mod, a, monkeypatch)),
            ('port', prepare_hifacegan_dataset.main)):
        np.random.seed(7)
        run(['--input', src, '--output', str(tmp_path / tag), '--mode',
             mode])
    _same_tree(str(tmp_path / 'jax'), str(tmp_path / 'port'))
    src_img = cv2.imread(os.path.join(src, 'img00.png'))
    out = cv2.imread(str(tmp_path / 'port' / 'img00.png'))
    assert not np.array_equal(src_img, out)


def _write_tfrecord(path, images):
    import tensorflow as tf
    with tf.io.TFRecordWriter(path) as writer:
        for img in images:
            chw = np.ascontiguousarray(img.transpose(2, 0, 1))
            example = tf.train.Example(features=tf.train.Features(feature={
                'shape': tf.train.Feature(
                    int64_list=tf.train.Int64List(value=list(chw.shape))),
                'data': tf.train.Feature(
                    bytes_list=tf.train.BytesList(value=[chw.tobytes()]))}))
            writer.write(example.SerializeToString())


@pytest.mark.parametrize('save_type', ['img', 'pack'])
def test_extract_images_from_tfrecords(tmp_path, save_type):
    """Two records of two and one RGB images (CHW bytes) to PNGs or a
    shard: the same images in order (the shards read back by the port's
    ``PackReader``)."""
    rng = np.random.RandomState(4)
    images = [(rng.rand(16, 16, 3) * 255).astype(np.uint8) for _ in range(3)]
    os.makedirs(tmp_path / 'rec')
    _write_tfrecord(str(tmp_path / 'rec' / 'a-r08.tfrecords'), images[:2])
    _write_tfrecord(str(tmp_path / 'rec' / 'b-r08.tfrecords'), images[2:])
    pattern = str(tmp_path / 'rec' / '*.tfrecords')
    jax_mod = jax_script('data_preparation', 'extract_images_from_tfrecords')
    os.makedirs(tmp_path / 'jax')
    jax_mod.convert_celeba_tfrecords(pattern, 4, str(tmp_path / 'jax'),
                                     save_type)
    assert extract_images_from_tfrecords.main([
        '--tf_file', pattern, '--log_resolution', '4', '--save_root',
        str(tmp_path / 'port'), '--save_type', save_type]) == 3
    if save_type == 'img':
        names = _same_tree(str(tmp_path / 'jax'), str(tmp_path / 'port'))
        assert names == [os.path.join('celeba_16_train', f'{i:08d}.png')
                         for i in range(3)]
        got = cv2.imread(str(tmp_path / 'port' / names[2]))
        assert np.array_equal(got, images[2][:, :, ::-1])
        return
    from mrefsr_tpu_torch.data.packio import PackReader
    readers = [PackReader(str(tmp_path / tag / 'celeba_16_train.pack'))
               for tag in ('jax', 'port')]
    for i, img in enumerate(images):
        key = f'{i:08d}'
        blobs = [r.get(key) for r in readers]
        assert blobs[0] == blobs[1]
        got = cv2.imdecode(np.frombuffer(blobs[1], np.uint8),
                           cv2.IMREAD_UNCHANGED)
        assert np.array_equal(got, img[:, :, ::-1])


def test_extract_images_from_tfrecords_names_tensorflow(tmp_path,
                                                        monkeypatch):
    monkeypatch.setitem(sys.modules, 'tensorflow', None)
    with pytest.raises(ImportError, match='tensorflow'):
        extract_images_from_tfrecords.main(['--tf_file', str(tmp_path / '*'),
                                            '--save_root', str(tmp_path)])


@pytest.mark.parametrize('mode', ['bp', 'reverse'])
def test_back_projection(tmp_path, monkeypatch, mode):
    """SR images paired with their LR by name (``name`` and
    ``name_<suffix>``; one without an LR image is skipped), three rounds
    of each mode."""
    _write_images(str(tmp_path / 'lr'), [(10, 12), (9, 8)], seed=5)
    _write_images(str(tmp_path / 'sr'), [(40, 48), (36, 32), (20, 20)],
                  seed=6)
    os.rename(tmp_path / 'sr' / 'img01.png', tmp_path / 'sr' / 'img01_x4.png')
    os.rename(tmp_path / 'sr' / 'img02.png', tmp_path / 'sr' / 'zz.png')
    jax_mod = jax_script('matlab_scripts', 'back_projection')
    for tag, run in (
            ('jax', lambda a: _run_jax_main(jax_mod, a, monkeypatch)),
            ('port', back_projection.main)):
        run(['--sr', str(tmp_path / 'sr'), '--lr', str(tmp_path / 'lr'),
             '--output', str(tmp_path / tag), '--iters', '3', '--mode',
             mode])
    assert _same_tree(str(tmp_path / 'jax'), str(tmp_path / 'port')) == [
        'img00.png', 'img01_x4.png']


def test_generate_lr_vimeo90k(tmp_path, monkeypatch):
    """The sequences tree, mod-cropped and resized by 1 / 4, under
    ``<root>_matlabLRx4`` with the same relative names."""
    for tag in ('jax', 'port'):
        for seq in ('00001/0001', '00002/0003'):
            _write_images(str(tmp_path / tag / 'vimeo' / 'sequences' / seq),
                          [(34, 45), (32, 32)], seed=len(seq) + int(seq[-1]))
    jax_mod = jax_script('matlab_scripts', 'generate_lr_vimeo90k')
    _run_jax_main(jax_mod, ['--root', str(tmp_path / 'jax' / 'vimeo')],
                  monkeypatch)
    assert generate_lr_vimeo90k.main(
        ['--root', str(tmp_path / 'port' / 'vimeo') + '/']) == 4
    names = _same_tree(str(tmp_path / 'jax' / 'vimeo_matlabLRx4'),
                       str(tmp_path / 'port' / 'vimeo_matlabLRx4'))
    assert len(names) == 4
    assert cv2.imread(str(tmp_path / 'port' / 'vimeo_matlabLRx4' /
                          names[0])).shape == (8, 11, 3)
