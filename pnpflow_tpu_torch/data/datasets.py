"""Host-side data pipelines yielding numpy NHWC float32 batches in [-1, 1].

A copy of ``pnpflow_tpu/data/datasets.py`` (synthetic, mnist and the three
image-file datasets).  PIL and pandas are imported only by the file
datasets that need them, so the synthetic path runs on numpy alone; its
splits are made at first use, with the same seeds and values.
"""

from __future__ import annotations

import functools
import gzip
import os
import struct
import warnings

import numpy as np


def _to_array(img) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def _center_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def _resize(img, size):
    """torchvision-compatible resize: int => short edge, tuple => exact."""
    from PIL import Image

    if isinstance(size, int):
        w, h = img.size
        if w <= h:
            new = (size, max(int(round(h * size / w)), 1))
        else:
            new = (max(int(round(w * size / h)), 1), size)
    else:
        new = (size[1], size[0])  # PIL uses (w, h)
    return img.resize(new, Image.BILINEAR)


class _FileDataset:
    """Sequential-batched image-file dataset -> normalized NHWC batches."""

    def __init__(self, paths, batch_size, transform, shuffle=False, seed=0,
                 drop_last=False):
        self.paths = list(paths)
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.paths)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        from PIL import Image

        order = np.arange(len(self.paths))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        batch = []
        for idx in order:
            path = self.paths[idx]
            if not os.path.exists(path):
                warnings.warn(f"File not found: {path}. Skipping.")
                continue
            img = Image.open(path).convert("RGB")
            batch.append(self.transform(img))
            if len(batch) == self.batch_size:
                yield np.stack(batch), np.zeros(len(batch), dtype=np.int32)
                batch = []
        if batch and not self.drop_last:
            yield np.stack(batch), np.zeros(len(batch), dtype=np.int32)


class _ArrayDataset:
    """In-memory NHWC dataset (mnist / synthetic).  ``images`` may be a
    callable that makes the array at first use, so a split that a run never
    reads costs nothing."""

    def __init__(self, images, batch_size, shuffle=False, seed=0):
        self._images = images
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    @property
    def images(self):
        if callable(self._images):
            self._images = self._images()
        return self._images

    def __len__(self):
        n = len(self.images)
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.images))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            yield self.images[idx], np.zeros(len(idx), dtype=np.int32)


def _load_mnist_split(root, train):
    prefix = "train" if train else "t10k"
    img_path = os.path.join(root, f"{prefix}-images-idx3-ubyte.gz")
    with gzip.open(img_path, "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols, 1)
    return data.astype(np.float32) / 255.0 * 2.0 - 1.0


def synthetic_images(n, dim, channels, seed=0):
    """Smooth procedural images in [-1,1]: random low-frequency fourier mix."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:dim, 0:dim].astype(np.float32) / dim
    imgs = np.zeros((n, dim, dim, channels), dtype=np.float32)
    for i in range(n):
        for c in range(channels):
            acc = np.zeros((dim, dim), dtype=np.float32)
            for _ in range(4):
                fx, fy = rng.uniform(0.5, 4, size=2)
                px, py = rng.uniform(0, 2 * np.pi, size=2)
                acc += rng.uniform(0.2, 1.0) * np.sin(
                    2 * np.pi * (fx * xx + px)
                ) * np.cos(2 * np.pi * (fy * yy + py))
            imgs[i, :, :, c] = acc
    imgs /= np.abs(imgs).max(axis=(1, 2, 3), keepdims=True) + 1e-8
    return imgs


def celeba_transform(img, dim: int):
    return _to_array(_resize(_center_crop(img, 178), (dim, dim))) * 2.0 - 1.0


def resize_transform(img, size):
    """``_resize`` to ``size`` (int: the short edge), then [-1, 1]."""
    return _to_array(_resize(img, size)) * 2.0 - 1.0


class DataLoaders:
    """Reference-compatible factory: ``load_data()`` -> {train, val, test}.

    ``backend`` "thread" (the default) reads the image-file datasets in
    this process (the trainer's prefetch thread overlaps it); "grain" reads
    them in ``num_workers`` worker processes (``data/grain_loader.py``).
    The in-memory datasets (synthetic, mnist) take no backend.  The
    transforms are module-level functions, so a worker process can unpickle
    them."""

    def __init__(self, dataset_name, batch_size_train, batch_size_test,
                 root="./data", dim_image=None, num_channels=None,
                 test_n=None, backend="thread", num_workers=4):
        if backend not in ("thread", "grain"):
            raise ValueError(f"unknown data_backend {backend!r}: thread or "
                             "grain")
        self.dataset_name = dataset_name
        self.batch_size_train = batch_size_train
        self.batch_size_test = batch_size_test
        self.root = root
        self.dim_image = dim_image
        self.num_channels = num_channels
        # synthetic only: size of the generated test split
        self.test_n = test_n
        self.backend = backend
        self.num_workers = num_workers

    def _file_loader(self, paths, bs, transform, shuffle=False,
                     drop_last=False):
        if self.backend == "grain":
            from pnpflow_tpu_torch.data.grain_loader import GrainFileLoader

            return GrainFileLoader(paths, bs, transform, shuffle=shuffle,
                                   drop_last=drop_last,
                                   num_workers=self.num_workers)
        return _FileDataset(paths, bs, transform, shuffle=shuffle,
                            drop_last=drop_last)

    def load_data(self):
        name = self.dataset_name
        if name == "celeba":
            transform = functools.partial(celeba_transform,
                                          dim=self.dim_image or 128)

            img_dir = os.path.join(self.root, "celeba/img_align_celeba/")
            csv_path = os.path.join(self.root, "celeba/list_eval_partition.csv")
            import pandas as pd

            df = pd.read_csv(
                csv_path, header=0, names=["image", "partition"], skiprows=1
            )

            def split(partition, bs, shuffle):
                names = df[df["partition"] == partition]["image"].values
                paths = [os.path.join(img_dir, n) for n in names]
                return self._file_loader(paths, bs, transform,
                                         shuffle=shuffle)

            return {
                "train": split(0, self.batch_size_train, True),
                "val": split(1, self.batch_size_test, False),
                "test": split(2, self.batch_size_test, False),
            }

        if name == "celebahq":
            transform = functools.partial(resize_transform, size=256)

            test_dir = os.path.join(self.root, "celebahq/test/")
            paths = [
                os.path.join(test_dir, f) for f in sorted(os.listdir(test_dir))
            ]
            return {
                "train": None,
                "val": None,
                "test": self._file_loader(paths, self.batch_size_test,
                                          transform),
            }

        if name == "afhq_cat":
            transform = functools.partial(resize_transform, size=(256, 256))

            def split(sub, bs, shuffle, drop_last=False):
                d = os.path.join(self.root, f"afhq_cat/{sub}/cat/")
                paths = [os.path.join(d, f) for f in sorted(os.listdir(d))]
                return self._file_loader(paths, bs, transform,
                                         shuffle=shuffle,
                                         drop_last=drop_last)

            return {
                "train": split("train", self.batch_size_train, True, True),
                "val": split("val", self.batch_size_test, False),
                "test": split("test", self.batch_size_test, False),
            }

        if name == "mnist":
            root = os.path.join(self.root, "mnist")
            train = _load_mnist_split(root, train=True)
            test = _load_mnist_split(root, train=False)
            n_val = len(test) // 2
            return {
                "train": _ArrayDataset(train, self.batch_size_train, True),
                "val": _ArrayDataset(test[:n_val], self.batch_size_test),
                "test": _ArrayDataset(test[n_val:], self.batch_size_test),
            }

        if name == "synthetic":
            dim = self.dim_image or 64
            ch = self.num_channels or 3
            test_n = max(128, int(self.test_n or 0))
            train = functools.partial(synthetic_images, 256, dim, ch, seed=0)
            val = functools.partial(synthetic_images, 64, dim, ch, seed=1)
            test = functools.partial(synthetic_images, test_n, dim, ch, seed=2)
            return {
                "train": _ArrayDataset(train, self.batch_size_train, True),
                "val": _ArrayDataset(val, self.batch_size_test),
                "test": _ArrayDataset(test, self.batch_size_test),
            }

        raise ValueError("The dataset you entered does not exist")
