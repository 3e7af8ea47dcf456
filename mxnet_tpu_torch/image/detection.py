"""Detection image iterator and augmenters (port of
``mxnet_tpu/image/detection.py``; reference
python/mxnet/image/detection.py: the DetAugmenter zoo and ImageDetIter).

The JAX module's numpy logic, copied.  The label of a batch is
``(batch, max_objects, 5+)`` padded with -1, parsed from MXNet's
detection header ``[header_width, object_width, cls, x0, y0, x1, y1,
...]``; images are host arrays and each batch is built in fresh pinned
buffers (``io/pinned.py``).
"""
from __future__ import annotations

import random

import numpy as np

from ..base import MXNetError
from ..io import pinned
from ..io.io import DataBatch, DataDesc
from ..ndarray.ndarray import NDArray
from .image import ImageIter, _host, _np

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """reference detection.py DetAugmenter: operates on (img, label) where
    label rows are [cls, xmin, ymin, xmax, ymax, ...] normalised coords."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only Augmenter (reference DetBorrowAug)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    def __init__(self, aug_list, skip_prob=0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if random.random() < self.skip_prob:
            return src, label
        return random.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if random.random() < self.p:
            arr = _np(src)[:, ::-1]
            src = _host(arr, dtype=src.dtype)
            label = label.copy()
            valid = label[:, 0] >= 0
            tmp = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - label[valid, 1]
            label[valid, 1] = tmp
        return src, label


class DetRandomCropAug(DetAugmenter):
    """IoU-constrained random crop (reference DetRandomCropAug)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            area = random.uniform(*self.area_range) * h * w
            ratio = random.uniform(*self.aspect_ratio_range)
            cw = int(np.sqrt(area * ratio))
            ch = int(np.sqrt(area / ratio))
            if cw > w or ch > h:
                continue
            x0 = random.randint(0, w - cw)
            y0 = random.randint(0, h - ch)
            crop_box = np.array([x0 / w, y0 / h, (x0 + cw) / w,
                                 (y0 + ch) / h])
            new_label = self._update_labels(label, crop_box)
            if new_label is None:
                continue
            arr = _np(src)[y0:y0 + ch, x0:x0 + cw]
            return _host(arr, dtype=src.dtype), new_label
        return src, label

    def _update_labels(self, label, crop_box):
        valid = label[:, 0] >= 0
        if not valid.any():
            return None
        boxes = label[valid, 1:5]
        cx0, cy0, cx1, cy1 = crop_box
        # intersection with crop
        ix0 = np.maximum(boxes[:, 0], cx0)
        iy0 = np.maximum(boxes[:, 1], cy0)
        ix1 = np.minimum(boxes[:, 2], cx1)
        iy1 = np.minimum(boxes[:, 3], cy1)
        iw = np.maximum(0, ix1 - ix0)
        ih = np.maximum(0, iy1 - iy0)
        inter = iw * ih
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        coverage = inter / np.maximum(areas, 1e-12)
        if coverage.max() < self.min_object_covered:
            return None
        keep = coverage >= self.min_eject_coverage
        if not keep.any():
            return None
        new_label = np.full_like(label, -1.0)
        scale_w = cx1 - cx0
        scale_h = cy1 - cy0
        kept = boxes[keep]
        out = np.zeros_like(kept)
        out[:, 0] = np.clip((kept[:, 0] - cx0) / scale_w, 0, 1)
        out[:, 1] = np.clip((kept[:, 1] - cy0) / scale_h, 0, 1)
        out[:, 2] = np.clip((kept[:, 2] - cx0) / scale_w, 0, 1)
        out[:, 3] = np.clip((kept[:, 3] - cy0) / scale_h, 0, 1)
        cls = label[valid, 0][keep]
        n = keep.sum()
        new_label[:n, 0] = cls
        new_label[:n, 1:5] = out
        return new_label


class DetRandomPadAug(DetAugmenter):
    """Random expansion pad (reference DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        h, w, c = src.shape
        for _ in range(self.max_attempts):
            scale = random.uniform(*self.area_range)
            if scale < 1:
                continue
            nw = int(w * np.sqrt(scale))
            nh = int(h * np.sqrt(scale))
            if nw < w or nh < h:
                continue
            x0 = random.randint(0, nw - w)
            y0 = random.randint(0, nh - h)
            canvas = np.full((nh, nw, c), self.pad_val, dtype=np.float32)
            canvas[y0:y0 + h, x0:x0 + w] = _np(src)
            new_label = label.copy()
            valid = label[:, 0] >= 0
            new_label[valid, 1] = (label[valid, 1] * w + x0) / nw
            new_label[valid, 2] = (label[valid, 2] * h + y0) / nh
            new_label[valid, 3] = (label[valid, 3] * w + x0) / nw
            new_label[valid, 4] = (label[valid, 4] * h + y0) / nh
            return _host(canvas), new_label
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """reference detection.py CreateDetAugmenter."""
    from .image import (CastAug, ColorJitterAug, ForceResizeAug,
                        HueJitterAug, LightingAug, RandomGrayAug,
                        ColorNormalizeAug)
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ForceResizeAug((resize, resize),
                                                   inter_method)))
    if rand_crop > 0:
        crop_aug = DetRandomCropAug(min_object_covered,
                                    aspect_ratio_range,
                                    (area_range[0], min(1.0, area_range[1])),
                                    min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop_aug], 1 - rand_crop))
    if rand_pad > 0:
        pad_aug = DetRandomPadAug(aspect_ratio_range,
                                  (1.0, max(1.0, area_range[1])),
                                  max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad_aug], 1 - rand_pad))
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(ColorJitterAug(brightness, contrast,
                                                   saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: label is (batch, max_objects, 5+) padded with -1
    (reference detection.py ImageDetIter)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in CreateDetAugmenter.__code__.co_varnames})
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=[],
                         imglist=imglist, data_name=data_name,
                         label_name=label_name)
        self.det_auglist = aug_list
        self._max_objects = None
        self.label_shape = self._estimate_label_shape()

    def _parse_label(self, label):
        raw = np.asarray(label).ravel()
        if raw.size < 7:
            raise MXNetError("label is too short for detection")
        header_width = int(raw[0])
        obj_width = int(raw[1])
        body = raw[header_width:]
        n = body.size // obj_width
        return body[:n * obj_width].reshape(n, obj_width)

    def _estimate_label_shape(self):
        max_count = 0
        obj_width = 5
        self.reset()
        try:
            while True:
                label, _ = self.next_sample()
                label = self._parse_label(label)
                max_count = max(max_count, label.shape[0])
                obj_width = label.shape[1]
        except StopIteration:
            pass
        self.reset()
        self._max_objects = max(max_count, 1)
        return (self._max_objects, obj_width)

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size,) + self.label_shape)]

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, h, w, c), np.float32)
        batch_label = np.full((batch_size,) + self.label_shape, -1.0,
                              np.float32)
        i = 0
        pad = 0
        try:
            while i < batch_size:
                raw_label, img = self.next_sample()
                label = self._parse_label(raw_label)
                for aug in self.det_auglist:
                    img, label = aug(img, label)
                arr = _np(img)
                batch_data[i] = arr.reshape(h, w, c)
                n = min(label.shape[0], self._max_objects)
                batch_label[i, :n, :label.shape[1]] = label[:n]
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = batch_size - i
        data, label = pinned.stage([batch_data.transpose(0, 3, 1, 2),
                                    batch_label])
        return DataBatch([NDArray(data)], [NDArray(label)], pad=pad)
