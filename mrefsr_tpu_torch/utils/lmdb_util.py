"""lmdb datasets from image folders (port of
``mrefsr_tpu/utils/lmdb_util.py``, the reference's
basicsr/utils/lmdb_util.py:9-196): each image PNG-encoded under its key,
and a ``meta_info.txt`` beside ``data.mdb`` with a ``key.png (h,w,c)
compress_level`` line a key. ``lmdb`` is imported where an environment is
opened, and its absence raises ``ImportError`` there."""
import multiprocessing
import sys
from os import path as osp


def _require_lmdb():
    try:
        import lmdb
    except ImportError as exc:
        raise ImportError("creating an lmdb dataset needs the 'lmdb' module, "
                          'which is not installed') from exc
    return lmdb


def make_lmdb_from_imgs(data_path, lmdb_path, img_path_list, keys,
                        batch=5000, compress_level=1,
                        multiprocessing_read=False, n_thread=40,
                        map_size=None):
    """The lmdb folder ``lmdb_path`` (ending in ``.lmdb``) of the images
    ``img_path_list`` (relative to ``data_path``) under ``keys``, committed
    every ``batch`` images; read by ``n_thread`` processes first where
    ``multiprocessing_read`` (spawned); ``map_size`` ten times the first
    image's encoded bytes times the count unless given. An existing
    ``lmdb_path`` exits the process (reference lmdb_util.py:9-130)."""
    if len(img_path_list) != len(keys):
        raise ValueError('img_path_list and keys should have the same '
                         f'length, but got {len(img_path_list)} and '
                         f'{len(keys)}')
    if not img_path_list:
        raise ValueError(f'img_path_list is empty: nothing to write into '
                         f'{lmdb_path}')
    if not lmdb_path.endswith('.lmdb'):
        raise ValueError("lmdb_path must end with '.lmdb'.")
    lmdb = _require_lmdb()
    print(f'Create lmdb for {data_path}, save to {lmdb_path}...')
    print(f'Total images: {len(img_path_list)}')
    if osp.exists(lmdb_path):
        print(f'Folder {lmdb_path} already exists. Exit.')
        sys.exit(1)

    dataset, shapes = {}, {}
    if multiprocessing_read:
        print(f'Read images with multiprocessing, #thread: {n_thread} ...')
        with multiprocessing.get_context('spawn').Pool(n_thread) as pool:
            results = [pool.apply_async(read_img_worker, args=(
                osp.join(data_path, path), key, compress_level))
                for path, key in zip(img_path_list, keys)]
            for res in results:
                key, dataset[key], shapes[key] = res.get()
        print(f'Finish reading {len(img_path_list)} images.')

    if map_size is None:
        if multiprocessing_read:
            data_size_per_img = dataset[keys[0]].nbytes
        else:
            _, img_byte, _ = read_img_worker(
                osp.join(data_path, img_path_list[0]), keys[0],
                compress_level)
            data_size_per_img = img_byte.nbytes
        print('Data size per image is: ', data_size_per_img)
        map_size = data_size_per_img * len(img_path_list) * 10

    env = lmdb.open(lmdb_path, map_size=map_size)
    txn = env.begin(write=True)
    try:
        with open(osp.join(lmdb_path, 'meta_info.txt'), 'w') as txt_file:
            for idx, (path, key) in enumerate(zip(img_path_list, keys)):
                if multiprocessing_read:
                    img_byte, (h, w, c) = dataset[key], shapes[key]
                else:
                    _, img_byte, (h, w, c) = read_img_worker(
                        osp.join(data_path, path), key, compress_level)
                txn.put(key.encode('ascii'), img_byte)
                txt_file.write(f'{key}.png ({h},{w},{c}) {compress_level}\n')
                if idx % batch == 0:
                    txn.commit()
                    txn = env.begin(write=True)
        txn.commit()
    finally:
        env.close()
    print('\nFinish writing lmdb.')


def read_img_worker(path, key, compress_level):
    """``(key, PNG bytes, (h, w, c))`` of the image at ``path`` (reference
    lmdb_util.py:133-156)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f'cv2 could not read image: {path}')
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    _, img_byte = cv2.imencode('.png', img,
                               [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
    return key, img_byte, (h, w, c)


class LmdbMaker:
    """An lmdb folder written one image at a time: :meth:`put` the encoded
    bytes, then :meth:`close` (reference lmdb_util.py:156-196)."""

    def __init__(self, lmdb_path, map_size=1024 ** 4, batch=5000,
                 compress_level=1):
        if not lmdb_path.endswith('.lmdb'):
            raise ValueError("lmdb_path must end with '.lmdb'.")
        lmdb = _require_lmdb()
        if osp.exists(lmdb_path):
            print(f'Folder {lmdb_path} already exists. Exit.')
            sys.exit(1)
        self.lmdb_path = lmdb_path
        self.batch = batch
        self.compress_level = compress_level
        self.env = lmdb.open(lmdb_path, map_size=map_size)
        self.txn = self.env.begin(write=True)
        self.txt_file = open(osp.join(lmdb_path, 'meta_info.txt'), 'w')
        self.counter = 0

    def put(self, img_byte, key, img_shape):
        self.counter += 1
        self.txn.put(key.encode('ascii'), img_byte)
        h, w, c = img_shape
        self.txt_file.write(f'{key}.png ({h},{w},{c}) {self.compress_level}\n')
        if self.counter % self.batch == 0:
            self.txn.commit()
            self.txn = self.env.begin(write=True)

    def close(self):
        self.txn.commit()
        self.env.close()
        self.txt_file.close()
