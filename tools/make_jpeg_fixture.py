"""Write the JPEG decode fixture: 16 seeded scenes at ImageNet's stored
size (256x341, short side 256), encoded as JPEG at quality 95, with the
pixels that ``mxnet_tpu.image.imdecode`` (PIL) gives for each.

The scenes are smooth (a few low-frequency gradients and soft discs per
image, as photographs are), not noise, so that the JPEG sizes and the
decode work are those of real records.  The port's decoders are held
against these pixels on the card (``tests/test_torch_data_cuda.py`` and
phase 37 of ``chip_smoke.py``) and on the CPU (``tests/test_torch_image.py``).

    python tools/make_jpeg_fixture.py [--out tests/fixtures/jpeg_fixture.npz]

The file holds ``jpeg`` (the 16 JPEG streams, concatenated, uint8),
``offsets`` (17 int64 byte offsets into it), ``pixels`` (16, 256, 341, 3)
uint8 and ``seed``; it is written with ``np.savez_compressed``.
"""
import argparse
import io
import os
import sys

import numpy as np

SEED = 22
COUNT = 16
HEIGHT, WIDTH = 256, 341
QUALITY = 95


def scene(rs, h=HEIGHT, w=WIDTH):
    """One smooth RGB scene (uint8 HWC) drawn from ``rs``: per channel a
    tilted plane and three products of sinusoids in x and y, then 2 to 5
    soft-edged discs of one colour each."""
    y = np.arange(h, dtype=np.float64)[:, None]
    x = np.arange(w, dtype=np.float64)[None, :]
    img = np.empty((h, w, 3))
    for c in range(3):
        base = rs.uniform(40, 200)
        gx, gy = rs.uniform(-0.3, 0.3, 2)
        plane = base + gx * (x - w / 2) + gy * (y - h / 2)
        for _ in range(3):
            fx, fy = rs.uniform(0.005, 0.05, 2)
            px, py = rs.uniform(0, 2 * np.pi, 2)
            plane = plane + rs.uniform(5, 30) * np.sin(fx * x + px) \
                * np.cos(fy * y + py)
        img[..., c] = plane
    for _ in range(rs.randint(2, 6)):
        cx, cy = rs.uniform(0, w), rs.uniform(0, h)
        r = rs.uniform(15, 80)
        col = rs.uniform(-80, 80, 3)
        # the disc's edge is a logistic of width 3 px: beyond r + 30 px
        # its weight is below 5e-5, so only that box is touched
        y0, y1 = max(0, int(cy - r - 30)), min(h, int(cy + r + 31))
        x0, x1 = max(0, int(cx - r - 30)), min(w, int(cx + r + 31))
        d = np.sqrt((x[:, x0:x1] - cx) ** 2 + (y[y0:y1] - cy) ** 2)
        soft = 1.0 / (1.0 + np.exp((d - r) / 3.0))
        img[y0:y1, x0:x1] += soft[..., None] * col
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def encode(img, quality=QUALITY):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--out", default=os.path.join(
        here, "tests", "fixtures", "jpeg_fixture.npz"))
    args = ap.parse_args()
    sys.path.insert(0, here)
    from mxnet_tpu.image import imdecode
    rs = np.random.RandomState(SEED)
    streams, pixels = [], []
    for _ in range(COUNT):
        jpg = encode(scene(rs))
        streams.append(np.frombuffer(jpg, np.uint8))
        pixels.append(imdecode(jpg).asnumpy())
    offsets = np.cumsum([0] + [len(s) for s in streams]).astype(np.int64)
    np.savez_compressed(args.out, jpeg=np.concatenate(streams),
                        offsets=offsets, pixels=np.stack(pixels),
                        seed=np.int64(SEED))
    print("%s: %d JPEGs of %dx%d at quality %d, %d bytes of JPEG, file "
          "%d bytes" % (args.out, COUNT, HEIGHT, WIDTH, QUALITY,
                        int(offsets[-1]), os.path.getsize(args.out)))


if __name__ == "__main__":
    main()
