"""Image IO and augmentation (port of ``mxnet_tpu/image/image.py``;
reference python/mxnet/image/image.py: ImageIter :999 and the augmenters
:482-873, C++ counterpart src/io/image_aug_default.cc).

The JAX module's numpy and PIL logic, copied: PIL decodes (RGB, HWC
uint8), and the colour augmenters are written batched, each exposing
``batch_call(arr, rng)`` over an (N, H, W, C) float32 block with
independent per-sample draws, so that ``ImageIter`` decodes and crops
per sample, stacks once, and runs the batchable tail of the chain as a
few numpy kernels over the block.

Every array made here is a host array, whatever the current context (as
MXNet's image functions return CPU arrays), in the dtype the JAX
package's has.  ``ImageIter`` builds each batch in
fresh pinned buffers (``io/pinned.py``), so the Module copies them to
the card without blocking.
"""
from __future__ import annotations

import io as _io
import logging
import os
import random

import numpy as np
import torch

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc, DataIter
from ..io import pinned
from ..ndarray.ndarray import NDArray
from .. import recordio

# Batched per-sample random draws come from this module generator;
# mx.random.seed(n) reseeds it (geometric choices use python `random`, so
# the reference's random.seed idiom covers those).  NOTE: not thread-safe;
# per-image worker threads must pass their own Generator to batch_call.
_rng = np.random.default_rng()


def reseed(n: int):
    """Reset the batched-augmentation generator (called by mx.random.seed)."""
    global _rng
    _rng = np.random.default_rng(n)


def _np(src):
    """A numpy view of a host NDArray (a copy of a card one), or
    ``np.asarray`` of anything else; callers never write into it."""
    if isinstance(src, NDArray):
        t = src._handle.detach()
        return t.numpy() if t.device.type == "cpu" else t.cpu().numpy()
    return np.asarray(src)


def _host(arr, dtype=None):
    """A new host NDArray holding a copy of ``arr`` (in ``dtype``, else
    in its own, as the JAX package's arrays)."""
    return NDArray(torch.from_numpy(np.array(arr, dtype=dtype, order="C",
                                             copy=True)))


def _as_f32(src):
    """(N,H,W,C) float32 view of an NDArray/ndarray image or batch."""
    return _np(src).astype(np.float32, copy=False)

__all__ = ["imdecode", "imread", "imresize", "scale_down", "resize_short",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "Augmenter", "SequentialAug",
           "RandomOrderAug", "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "ColorNormalizeAug", "RandomGrayAug",
           "HorizontalFlipAug", "CastAug", "CreateAugmenter", "ImageIter"]


def imdecode(buf, to_rgb=1, flag=1, **kwargs):
    """Decode image bytes → NDArray HWC (reference image.py imdecode)."""
    from PIL import Image
    img = Image.open(_io.BytesIO(buf if isinstance(buf, bytes)
                                 else bytes(buf)))
    img = img.convert("RGB" if flag else "L")
    arr = np.asarray(img)
    if not to_rgb and flag:
        arr = arr[:, :, ::-1]
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return _host(arr, dtype=np.uint8)


def imread(filename, flag=1, to_rgb=1):
    with open(filename, "rb") as f:
        return imdecode(f.read(), to_rgb=to_rgb, flag=flag)


def imresize(src, w, h, interp=1):
    from PIL import Image
    arr = _np(src)
    squeeze = arr.shape[-1] == 1
    if squeeze:
        arr = arr[:, :, 0]
    img = Image.fromarray(arr.astype(np.uint8))
    img = img.resize((w, h), _interp(interp))
    out = np.asarray(img)
    if squeeze:
        out = out[:, :, None]
    return _host(out, dtype=np.uint8)


def _interp(interp):
    from PIL import Image
    return {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
            3: Image.NEAREST, 4: Image.LANCZOS}.get(interp, Image.BILINEAR)


def scale_down(src_size, size):
    """Shrink a requested crop (w, h) to fit inside src (sw, sh), keeping
    aspect.  Height clamps first, then width against the updated aspect —
    the exact two-step float order of the reference (image.py scale_down),
    kept because its int() truncation is visible in crop sizes (a single
    uniform-scale formula differs by one pixel on ties)."""
    sw, sh = src_size
    w, h = map(float, size)
    if h > sh:
        w, h = w * sh / h, sh
    if w > sw:
        w, h = sw, h * sw / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize shorter edge to `size` (reference resize_short)."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    arr = _np(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(_host(out, dtype=np.uint8), size[0], size[1],
                        interp)
    return _host(out, dtype=out.dtype)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    arr = _np(src).astype(np.float32)
    arr = arr - np.asarray(mean)
    if std is not None:
        arr = arr / np.asarray(std)
    return _host(arr)


def random_size_crop(src, size, area, ratio, interp=2):
    """reference random_size_crop."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = random.uniform(area[0], area[1]) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(random.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


class Augmenter:
    """reference image.py Augmenter base.

    Augmenters whose effect is a per-pixel/per-channel transform set
    ``batchable = True`` and implement ``batch_call(arr, rng)`` over an
    (N,H,W,C) float32 block, drawing each sample's random parameters as a
    length-N vector.  ``__call__`` on a single image then delegates to the
    N=1 batch — one implementation, two shapes.
    """

    batchable = False

    def __init__(self, **kwargs):
        # NDArray and numpy parameters are kept as lists, so that dumps()
        # serialises them (reference image.py Augmenter.__init__; the JAX
        # package converts only NDArrays, and its dumps() of a numpy mean
        # raises, which breaks CreateDetAugmenter(mean=...))
        self._kwargs = kwargs
        for k, v in self._kwargs.items():
            if isinstance(v, NDArray):
                v = v.asnumpy()
            if isinstance(v, np.ndarray):
                self._kwargs[k] = v.tolist()

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def batch_call(self, arr, rng):
        raise NotImplementedError

    def __call__(self, src):
        if not self.batchable:
            raise NotImplementedError
        out = self.batch_call(_as_f32(src)[None], _rng)[0]
        return _host(out)


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    @property
    def batchable(self):
        return all(t.batchable for t in self.ts)

    def batch_call(self, arr, rng):
        for aug in self.ts:
            arr = aug.batch_call(arr, rng)
        return arr

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    """Children applied in a random order.  Batched note: the order is
    shuffled once per BATCH (the reference shuffles per image); the
    per-sample jitter amounts stay independent.  The batched order is
    drawn from the passed Generator so mx.random.seed covers it."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    @property
    def batchable(self):
        return all(t.batchable for t in self.ts)

    def batch_call(self, arr, rng):
        for k in rng.permutation(len(self.ts)):
            arr = self.ts[int(k)].batch_call(arr, rng)
        return arr

    def __call__(self, src):
        ts = list(self.ts)
        random.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


# BT.601 luma weights, the gray projection all color jitters share
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def _jitter_alphas(rng, n, width):
    """n independent multipliers in [1-width, 1+width]."""
    return (1.0 + rng.uniform(-width, width, n)).astype(np.float32)


class BrightnessJitterAug(Augmenter):
    batchable = True

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def batch_call(self, arr, rng):
        alphas = _jitter_alphas(rng, arr.shape[0], self.brightness)
        return arr * alphas[:, None, None, None]


class ContrastJitterAug(Augmenter):
    """Lerp each sample toward its own mean luma."""

    batchable = True

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def batch_call(self, arr, rng):
        alphas = _jitter_alphas(rng, arr.shape[0], self.contrast)
        a = alphas[:, None, None, None]
        mean_luma = (arr @ _LUMA).mean(axis=(1, 2))  # (N,)
        return arr * a + (1.0 - a) * mean_luma[:, None, None, None]


class SaturationJitterAug(Augmenter):
    """Lerp each pixel toward its own luma (desaturation axis)."""

    batchable = True

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def batch_call(self, arr, rng):
        alphas = _jitter_alphas(rng, arr.shape[0], self.saturation)
        a = alphas[:, None, None, None]
        luma = (arr @ _LUMA)[..., None]  # (N,H,W,1)
        return arr * a + (1.0 - a) * luma


class HueJitterAug(Augmenter):
    """Rotate chroma in YIQ space: one 3x3 matrix per sample, applied to
    the whole block with a single einsum."""

    batchable = True
    _TO_YIQ = np.array([[0.299, 0.587, 0.114],
                        [0.596, -0.274, -0.321],
                        [0.211, -0.523, 0.311]], np.float32)
    _FROM_YIQ = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], np.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def batch_call(self, arr, rng):
        n = arr.shape[0]
        theta = rng.uniform(-self.hue, self.hue, n).astype(np.float32) * np.pi
        c, s = np.cos(theta), np.sin(theta)
        rot = np.zeros((n, 3, 3), np.float32)
        rot[:, 0, 0] = 1.0
        rot[:, 1, 1] = c
        rot[:, 1, 2] = -s
        rot[:, 2, 1] = s
        rot[:, 2, 2] = c
        # per-sample RGB->RGB matrix: FROM_YIQ @ rot_n @ TO_YIQ
        t = np.einsum("ij,njk,kl->nil", self._FROM_YIQ, rot, self._TO_YIQ)
        return np.einsum("nhwc,nkc->nhwk", arr, t)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA noise (reference LightingAug), one draw per
    sample."""

    batchable = True

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd, eigval=eigval, eigvec=eigvec)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def batch_call(self, arr, rng):
        alpha = rng.normal(0, self.alphastd,
                           (arr.shape[0], 3)).astype(np.float32)
        rgb = (self.eigvec * alpha[:, None, :]) @ self.eigval  # (N,3)
        return arr + rgb[:, None, None, :]


class ColorNormalizeAug(Augmenter):
    batchable = True

    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = np.asarray(mean, np.float32) if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None

    def batch_call(self, arr, rng):
        if self.mean is not None:
            arr = arr - self.mean
        if self.std is not None:
            arr = arr / self.std
        return arr

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    """Desaturate a random subset of the batch (equal-weight gray, matching
    the reference's 0.21/0.72/0.07 projection broadcast to 3 channels)."""

    batchable = True
    _GRAY = np.array([[0.21, 0.21, 0.21],
                      [0.72, 0.72, 0.72],
                      [0.07, 0.07, 0.07]], np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def batch_call(self, arr, rng):
        pick = rng.random(arr.shape[0]) < self.p
        if not pick.any():
            return arr
        out = np.array(arr, copy=True)
        out[pick] = arr[pick] @ self._GRAY
        return out

    def __call__(self, src):
        # not-picked images pass through untouched (dtype preserved)
        if random.random() < self.p:
            return _host(_as_f32(src) @ self._GRAY)
        return src


class HorizontalFlipAug(Augmenter):
    batchable = True

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def batch_call(self, arr, rng):
        pick = rng.random(arr.shape[0]) < self.p
        if not pick.any():
            return arr
        out = np.array(arr, copy=True)
        out[pick] = arr[pick][:, :, ::-1]
        return out

    def __call__(self, src):
        # single-image path keeps the source dtype (uint8 stays uint8)
        if random.random() < self.p:
            arr = _np(src)[:, ::-1]
            return _host(arr, dtype=src.dtype)
        return src


class CastAug(Augmenter):
    batchable = True

    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def batch_call(self, arr, rng):
        return arr.astype(self.typ, copy=False)

    def __call__(self, src):
        # numpy's cast, not an op call: a torch op's intra-op threads
        # contend with the decode threads of ImageRecordIter
        return _host(_np(src).astype(self.typ))


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """reference image.py CreateAugmenter.  The chain is built geometric
    prefix first (resize -> crop -> flip), then the batchable color tail —
    the order ImageIter exploits to vectorize everything after the crop."""
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop, "rand_resize implies rand_crop"
        crop = RandomSizedCropAug(crop_size, 0.08, (3.0 / 4.0, 4.0 / 3.0),
                                  inter_method)
    else:
        crop_cls = RandomCropAug if rand_crop else CenterCropAug
        crop = crop_cls(crop_size, inter_method)
    chain = ([ResizeAug(resize, inter_method)] if resize > 0 else []) \
        + [crop] \
        + ([HorizontalFlipAug(0.5)] if rand_mirror else []) \
        + [CastAug()]
    if brightness or contrast or saturation:
        chain.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        chain.append(HueJitterAug(hue))
    if pca_noise > 0:
        # ImageNet RGB covariance eigensystem (AlexNet fancy-PCA constants)
        chain.append(LightingAug(
            pca_noise,
            np.array([55.46, 4.794, 1.148]),
            np.array([[-0.5675, 0.7192, 0.4009],
                      [-0.5808, -0.0045, -0.8140],
                      [-0.5836, -0.6948, 0.4203]])))
    if rand_gray > 0:
        chain.append(RandomGrayAug(rand_gray))
    # mean/std True selects the ImageNet defaults
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None:
        chain.append(ColorNormalizeAug(np.asarray(mean),
                                       None if std is None
                                       else np.asarray(std)))
    return chain


class ImageIter(DataIter):
    """Flexible image iterator over .rec/.lst/raw files (reference
    image.py ImageIter:999)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__()
        assert path_imgrec or path_imglist or (isinstance(imglist, list))
        self.imgrec = None
        self.imgidx = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            logging.info("loading recordio %s...", path_imgrec)
            if path_imgidx or os.path.isfile(
                    os.path.splitext(path_imgrec)[0] + ".idx"):
                idx_path = path_imgidx or \
                    os.path.splitext(path_imgrec)[0] + ".idx"
                self.imgrec = recordio.MXIndexedRecordIO(idx_path,
                                                         path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
        if path_imglist:
            logging.info("loading image list %s...", path_imglist)
            with open(path_imglist) as fin:
                imglist = {}
                imgkeys = []
                for line in iter(fin.readline, ""):
                    line = line.strip().split("\t")
                    label = np.array(line[1:-1], dtype=np.float32)
                    key = int(line[0])
                    imglist[key] = (label, line[-1])
                    imgkeys.append(key)
                self.imglist = imglist
                self.seq = imgkeys
        elif isinstance(imglist, list):
            result = {}
            imgkeys = []
            index = 1
            for img in imglist:
                key = str(index)
                index += 1
                if isinstance(img[0], (list, np.ndarray)):
                    label = np.array(img[0], dtype=np.float32)
                else:
                    label = np.array([img[0]], dtype=np.float32)
                result[key] = (label, img[1])
                imgkeys.append(str(key))
            self.imglist = result
            self.seq = imgkeys
        elif self.imgidx is not None:
            self.seq = self.imgidx

        self.path_root = path_root
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        if num_parts > 1 and self.seq is not None:
            # equal-size contiguous shards; the tail remainder is dropped so
            # every worker sees the same number of batches (sync training)
            assert part_index < num_parts
            per = len(self.seq) // num_parts
            lo = part_index * per
            self.seq = self.seq[lo:lo + per]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.cur = 0
        self.data_name = data_name
        self.label_name = label_name
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size,) +
                         self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        if self.shuffle and self.seq is not None:
            random.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def _sample_at(self, idx):
        """Fetch + decode one sample by sequence key."""
        if self.imgrec is not None:
            header, img = recordio.unpack(self.imgrec.read_idx(idx))
            label = header.label if self.imglist is None \
                else self.imglist[idx][0]
            return label, imdecode(img)
        label, fname = self.imglist[idx]
        return label, self.read_image(fname)

    def next_sample(self):
        """Return (label, decoded image NDArray)."""
        if self.seq is None:
            # pure sequential record stream (no index)
            s = self.imgrec.read()
            if s is None:
                raise StopIteration
            header, img = recordio.unpack(s)
            return header.label, imdecode(img)
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        return self._sample_at(idx)

    def read_image(self, fname):
        with open(os.path.join(self.path_root or "", fname), "rb") as fin:
            return imdecode(fin.read())

    def _split_aug_chain(self):
        """(per_image_prefix, batched_suffix): the longest tail of the
        augmenter chain in which every augmenter is batchable runs as
        vectorized NumPy kernels over the stacked (N,H,W,C) block; only the
        geometric prefix (resize/crop — shapes differ until the crop) runs
        per sample."""
        split = len(self.auglist)
        while split > 0 and self.auglist[split - 1].batchable:
            split -= 1
        return self.auglist[:split], self.auglist[split:]

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        per_image, batched = self._split_aug_chain()
        batch_data = np.zeros((batch_size, h, w, c), np.float32)
        batch_label = np.zeros((batch_size, self.label_width), np.float32)
        i = 0
        pad = 0
        try:
            while i < batch_size:
                label, img = self.next_sample()
                for aug in per_image:
                    img = aug(img)
                arr = _np(img)
                if arr.shape[:2] != (h, w):
                    raise MXNetError(
                        "augmented image size %s != data_shape %s"
                        % (arr.shape, self.data_shape))
                batch_data[i] = arr.reshape(h, w, c)
                batch_label[i] = \
                    np.asarray(label).reshape(-1)[:self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = batch_size - i
            for j in range(i, batch_size):
                batch_data[j] = batch_data[j % max(i, 1)]
                batch_label[j] = batch_label[j % max(i, 1)]
        # vectorized color/normalize tail: whole batch per kernel (pad rows
        # get jitter too — they're discarded downstream)
        for aug in batched:
            batch_data = aug.batch_call(batch_data, _rng)
        cast_typ = next((a.typ for a in reversed(batched)
                         if isinstance(a, CastAug)), None)
        if batch_data.dtype == np.float64 and cast_typ is None:
            # an aug upcast (e.g. float64 normalize constants): bring back
            # to float32 — but keep any dtype a user CastAug chose
            batch_data = batch_data.astype(np.float32, copy=False)
        data, label = pinned.stage([
            batch_data.transpose(0, 3, 1, 2),      # NCHW
            batch_label[:, 0] if self.label_width == 1 else batch_label])
        return DataBatch([NDArray(data)], [NDArray(label)], pad=pad)
