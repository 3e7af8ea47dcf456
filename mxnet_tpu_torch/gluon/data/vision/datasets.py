"""Vision datasets (port of ``mxnet_tpu/gluon/data/vision/datasets.py``;
reference python/mxnet/gluon/data/vision/datasets.py).

All datasets read from local files: pass `root` pointing at the standard
raw files (MNIST's idx files, CIFAR's python pickles, a RecordIO pack or
an image folder).  Images are host arrays.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ....context import cpu
from ....ndarray.ndarray import array as _array
from ....recordio import unpack_img
from ..dataset import Dataset, RecordFileDataset


def nd_array(source):
    """A host NDArray (dataset samples live on the host)."""
    return _array(source, ctx=cpu())


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from idx files (reference datasets.py MNIST)."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_idx(self, path):
        for p in (path, path + ".gz"):
            if os.path.exists(p):
                op = gzip.open if p.endswith(".gz") else open
                with op(p, "rb") as f:
                    magic = struct.unpack(">I", f.read(4))[0]
                    ndim = magic & 0xFF
                    shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
                    return np.frombuffer(f.read(), np.uint8).reshape(shape)
        raise FileNotFoundError(path)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        data = self._read_idx(os.path.join(self._root, files[0]))
        label = self._read_idx(os.path.join(self._root, files[1]))
        self._data = data.reshape(-1, 28, 28, 1)
        self._label = label.astype(np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from the python pickle batches (reference datasets.py)."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            batch = pickle.load(fin, encoding="latin1")
        data = batch["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = batch.get("labels", batch.get("fine_labels"))
        return data, np.asarray(labels, np.int32)

    def _get_data(self):
        base = self._root
        sub = os.path.join(base, "cifar-10-batches-py")
        if os.path.isdir(sub):
            base = sub
        if self._train:
            parts = [self._read_batch(os.path.join(base, "data_batch_%d" % i))
                     for i in range(1, 6)]
            self._data = np.concatenate([p[0] for p in parts])
            self._label = np.concatenate([p[1] for p in parts])
        else:
            self._data, self._label = self._read_batch(
                os.path.join(base, "test_batch"))


class CIFAR100(CIFAR10):
    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=False,
                 train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        base = self._root
        sub = os.path.join(base, "cifar-100-python")
        if os.path.isdir(sub):
            base = sub
        name = "train" if self._train else "test"
        with open(os.path.join(base, name), "rb") as fin:
            batch = pickle.load(fin, encoding="latin1")
        self._data = batch["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        key = "fine_labels" if self._fine_label else "coarse_labels"
        self._label = np.asarray(batch[key], np.int32)


class ImageRecordDataset(RecordFileDataset):
    """Images packed in a RecordIO file (reference ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        record = super().__getitem__(idx)
        header, img = unpack_img(record, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(nd_array(img), label)
        return nd_array(img), label


class ImageFolderDataset(Dataset):
    """root/category/image.jpg layout (reference ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from PIL import Image
        img = np.asarray(Image.open(self.items[idx][0]).convert(
            "RGB" if self._flag else "L"))
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(nd_array(img), label)
        return nd_array(img), label

    def __len__(self):
        return len(self.items)
