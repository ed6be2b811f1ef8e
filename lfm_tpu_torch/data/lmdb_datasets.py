"""LMDB-backed datasets, read on the host (the port's copy of
lfm_tpu/data/lmdb_datasets.py).

The reference's readers: NVAE-style raw-RGB LMDB (reference
datasets_prep/lmdb_datasets.py:26-60), torchvision-style multi-class LSUN
with key caching (reference datasets_prep/lsun.py:26-67), and
torchtoolbox-style ImageLMDB for celeba_512/1024 (reference
datasets_prep/__init__.py:78-102). They read through the ``lmdb`` binding
where it is installed, else the pure-Python ``minilmdb``. Encoded records
and resampling need Pillow; a raw NVAE record already at the image size
needs neither (its same-size resize is a copy).
"""

from __future__ import annotations

import io
import os
import pickle
import string
from typing import List, Tuple

import numpy as np

from lfm_tpu_torch.data.transforms import (maybe_flip, require_pil, resize_and_crop,
                                           resize_short_side, to_neg1_1)


def _require_lmdb():
    """The C binding when available (fastest), else the pure-Python reader
    (data/minilmdb.py): the read path works either way."""
    try:
        import lmdb

        return lmdb
    except ImportError:
        from lfm_tpu_torch.data import minilmdb

        return minilmdb


class LMDBDataset:
    """NVAE raw-RGB LMDB: key = str(index), value = raw HxWx3 uint8 bytes
    (square), or an encoded image when is_encoded."""

    def __init__(self, root: str, name: str = "", train: bool = True, image_size: int = 256,
                 is_encoded: bool = False, random_flip: bool = True, crop: bool = False,
                 seed: int = 0):
        lmdb = _require_lmdb()
        path = os.path.join(root, "train.lmdb" if train else "validation.lmdb")
        self.env = lmdb.open(path, readonly=True, max_readers=1, lock=False, readahead=False,
                             meminit=False)
        self.is_encoded = is_encoded
        self.image_size = image_size
        self.random_flip = random_flip
        self.crop = crop
        self.rng = np.random.default_rng(seed)
        self.num_classes = 1
        with self.env.begin() as txn:
            self._len = txn.stat()["entries"]

    def __len__(self):
        return self._len

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        with self.env.begin(write=False, buffers=True) as txn:
            data = txn.get(str(index).encode())
            if self.is_encoded:
                img = require_pil("an encoded LMDB record").open(
                    io.BytesIO(bytes(data))).convert("RGB")
            else:
                arr = np.frombuffer(data, np.uint8)
                size = int(np.sqrt(len(arr) / 3))
                arr = arr.reshape(size, size, 3)
                # Pillow's resize to the same size (and the crop of a square
                # to itself) is a copy: at the image size, the same bits
                # without Pillow
                img = (arr if size == self.image_size
                       else require_pil("resampling a raw LMDB record").fromarray(arr))
        if not isinstance(img, np.ndarray):
            img = (resize_and_crop(img, self.image_size) if self.crop
                   else resize_short_side(img, self.image_size))
        out = to_neg1_1(np.asarray(img))
        if self.random_flip:
            out = maybe_flip(out, self.rng)
        return out, 0


class LSUNClass:
    """One LSUN category LMDB (webp-encoded values, arbitrary byte keys) with
    the torchvision key cache (reference lsun.py:26-67), which is written
    to the working directory as ``_cache_<letters of root>``."""

    def __init__(self, root: str, image_size: int = 256, random_flip: bool = True,
                 seed: int = 0):
        lmdb = _require_lmdb()
        self.env = lmdb.open(root, max_readers=1, readonly=True, lock=False, readahead=False,
                             meminit=False)
        with self.env.begin(write=False) as txn:
            self._len = txn.stat()["entries"]
        cache_file = "_cache_" + "".join(c for c in root if c in string.ascii_letters)
        if os.path.isfile(cache_file):
            with open(cache_file, "rb") as f:
                self.keys = pickle.load(f)
        else:
            with self.env.begin(write=False) as txn:
                self.keys = [key for key in txn.cursor().iternext(keys=True, values=False)]
            with open(cache_file, "wb") as f:
                pickle.dump(self.keys, f)
        self.image_size = image_size
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)
        self.num_classes = 1

    def __len__(self):
        return self._len

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        with self.env.begin(write=False) as txn:
            imgbuf = txn.get(self.keys[index])
        img = require_pil("an LSUN record").open(io.BytesIO(imgbuf)).convert("RGB")
        img = resize_and_crop(img, self.image_size)
        out = to_neg1_1(np.asarray(img))
        if self.random_flip:
            out = maybe_flip(out, self.rng)
        return out, 0


class LSUN:
    """Multi-class LSUN (reference lsun.py): classes like 'bedroom_train'."""

    def __init__(self, root: str, classes: List[str], image_size: int = 256,
                 random_flip: bool = True, seed: int = 0):
        self.dbs = [LSUNClass(os.path.join(root, f"{c}_lmdb"), image_size, random_flip, seed)
                    for c in classes]
        self.indices = []
        count = 0
        for db in self.dbs:
            count += len(db)
            self.indices.append(count)
        self._len = count
        self.num_classes = len(classes)

    def __len__(self):
        return self._len

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        target = 0
        sub = 0
        for ind in self.indices:
            if index < ind:
                break
            index -= ind
            target += 1
            sub += 1
        img, _ = self.dbs[sub][index]
        return img, target


class ImageLMDB:
    """torchtoolbox-style image LMDB used for celeba_512/1024
    (reference datasets_prep/__init__.py:78-102): values are encoded images
    keyed '{db_name}_{i}', length under key '__len__' (falls back to the
    entry count)."""

    def __init__(self, db_path: str, db_name: str, image_size: int, random_flip: bool = True,
                 seed: int = 0):
        lmdb = _require_lmdb()
        self.env = lmdb.open(db_path, readonly=True, lock=False, readahead=False,
                             meminit=False)
        self.db_name = db_name
        self.image_size = image_size
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)
        self.num_classes = 1
        with self.env.begin() as txn:
            n = txn.get(b"__len__")
            self._len = int(n.decode()) if n else txn.stat()["entries"]

    def __len__(self):
        return self._len

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        with self.env.begin(write=False) as txn:
            buf = txn.get(f"{self.db_name}_{index}".encode())
            if buf is None:
                buf = txn.get(str(index).encode())
        img = require_pil("an ImageLMDB record").open(io.BytesIO(bytes(buf))).convert("RGB")
        img = resize_short_side(img, self.image_size)
        out = to_neg1_1(np.asarray(img))
        if self.random_flip:
            out = maybe_flip(out, self.rng)
        return out, 0
