"""``mx.image`` (port of ``mxnet_tpu/image``; reference
python/mxnet/image/): decode with PIL, the augmenters, ``ImageIter``,
``ImageRecordIter`` and the detection pipeline.  Every array is a host
array; each batch is built in fresh pinned buffers."""
from .image import (Augmenter, BrightnessJitterAug, CastAug, CenterCropAug,
                    ColorJitterAug, ColorNormalizeAug, ContrastJitterAug,
                    CreateAugmenter, ForceResizeAug, HorizontalFlipAug,
                    HueJitterAug, ImageIter, LightingAug, RandomCropAug,
                    RandomGrayAug, RandomOrderAug, RandomSizedCropAug,
                    ResizeAug, SaturationJitterAug, SequentialAug,
                    center_crop, color_normalize, fixed_crop, imdecode,
                    imread, imresize, random_crop, random_size_crop,
                    resize_short, scale_down)
from .record_iter import ImageRecordIter, ImageRecordUInt8Iter
from . import detection
from .detection import CreateDetAugmenter, ImageDetIter
