"""Vision transforms (port of
``mxnet_tpu/gluon/data/vision/transforms.py``; reference
python/mxnet/gluon/data/vision/transforms.py, which landed just after
v1.1: image.py's augmenters in composable Block form).  Every transform
returns a host array, whatever the current context, so that it may run
in a forked data worker (which must never touch CUDA)."""
from __future__ import annotations

import numpy as np

from ....image.image import _host as nd_array, _np
from ...block import Block, HybridBlock
from ...nn import Sequential


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(Block):
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def forward(self, x):
        arr = _np(x)
        arr = arr.astype(np.float32) / 255.0
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        elif arr.ndim == 2:
            arr = arr[None]
        return nd_array(arr)


class Normalize(Block):
    def __init__(self, mean, std):
        super().__init__()
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        arr = _np(x)
        return nd_array((arr - self._mean) / self._std)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        from PIL import Image
        arr = _np(x)
        img = Image.fromarray(arr.astype(np.uint8))
        img = img.resize(self._size, Image.BILINEAR)
        return nd_array(np.asarray(img))


class CenterCrop(Block):
    def __init__(self, size):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        arr = _np(x)
        h, w = arr.shape[:2]
        th, tw = self._size
        y0 = max(0, (h - th) // 2)
        x0 = max(0, (w - tw) // 2)
        return nd_array(arr[y0:y0 + th, x0:x0 + tw])


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4., 4. / 3.),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        from PIL import Image
        arr = _np(x)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            aspect = np.random.uniform(*self._ratio)
            nw = int(round(np.sqrt(target_area * aspect)))
            nh = int(round(np.sqrt(target_area / aspect)))
            if nw <= w and nh <= h:
                x0 = np.random.randint(0, w - nw + 1)
                y0 = np.random.randint(0, h - nh + 1)
                crop = arr[y0:y0 + nh, x0:x0 + nw]
                img = Image.fromarray(crop.astype(np.uint8))
                return nd_array(np.asarray(img.resize(self._size,
                                                      Image.BILINEAR)))
        return CenterCrop(self._size).forward(nd_array(arr))


class RandomFlipLeftRight(Block):
    def forward(self, x):
        arr = _np(x)
        if np.random.rand() < 0.5:
            arr = arr[:, ::-1]
        return nd_array(arr)


class RandomFlipTopBottom(Block):
    def forward(self, x):
        arr = _np(x)
        if np.random.rand() < 0.5:
            arr = arr[::-1]
        return nd_array(arr)


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        arr = _np(x)
        f = 1.0 + np.random.uniform(-self._b, self._b)
        return nd_array(np.clip(arr * f, 0, 255))
