"""Writes the golden JPEG cases of ``tests/data/jpeg/`` with OpenCV, and
times the port's codec against OpenCV's on this machine's CPU.

    python tests/_make_jpeg_cases.py            # (re)write the cases
    python tests/_make_jpeg_cases.py --time     # decode / encode ms, 2048x1550 q92

Each case is a small seeded source image (``<name>.png``, lossless, 8-bit
RGB; a gray case's three channels are equal) and the
JPEG that ``cv2.imwrite`` makes of it with the case's quality, sampling and
restart interval (``<name>.jpg``). ``digests.json`` holds, for each case,
the sha256 of the JPEG's bytes and of the (H, W, 3) BGR pixels that
``cv2.imread`` decodes from it. ``tests/test_torch_port_jpeg.py`` derives
both again with OpenCV, so they cannot drift, and holds the port's codec to
them; ``chip_smoke.py`` phase 21a holds it to them on the card's host, which
has no OpenCV. Cases with ``encode`` set are ones the port's encoder writes
(4:2:0 colour or gray, no restart interval): encoding their source PNG must
give the JPEG's bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
import time

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent / 'data' / 'jpeg'

# name: (height, width, channels, quality, sampling, restart interval, encode)
CASES = {
    '420_q92': (32, 48, 3, 92, '420', 0, True),
    '420_q95': (32, 32, 3, 95, '420', 0, True),
    '420_odd_q80': (23, 45, 3, 80, '420', 0, True),
    '444_q90': (25, 30, 3, 90, '444', 0, False),
    '422_q85': (19, 34, 3, 85, '422', 0, False),
    'gray_q90': (29, 37, 1, 90, None, 0, True),
    'dri_420_q92': (24, 72, 3, 92, '420', 2, False),
    'tiny_1x1_q75': (1, 1, 3, 75, '420', 0, True),
}


def source_image(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """A smooth seeded image with an edge and some noise: small as PNG and
    JPEG, yet every DCT band is used."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = [128 + 90 * np.sin(x / (3 + 2 * c) + y / (5 + c)) for c in range(3)]
    img = np.stack(base, -1) + rng.normal(0, 3, (h, w, 3))
    img[h // 3:, w // 2:] = 255 - img[h // 3:, w // 2:]
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 0].copy() if channels == 1 else img


def source_of_png(bgr: np.ndarray, channels: int) -> np.ndarray:
    """A case's source image from its PNG's (H, W, 3) BGR pixels."""
    return bgr[..., 0].copy() if channels == 1 else bgr


def write_params(cv2, quality, sampling, rst):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f'IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}')]
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    return params


def digests_of(cv2, name: str) -> dict:
    data = (DATA / f'{name}.jpg').read_bytes()
    pixels = cv2.imread(str(DATA / f'{name}.jpg'), cv2.IMREAD_COLOR)
    return {'jpeg_sha256': hashlib.sha256(data).hexdigest(),
            'pixels_sha256': hashlib.sha256(
                np.ascontiguousarray(pixels).tobytes()).hexdigest(),
            'shape': list(pixels.shape)}


def make_cases() -> None:
    import cv2
    DATA.mkdir(parents=True, exist_ok=True)
    digests = {}
    for i, (name, (h, w, ch, q, sampling, rst, enc)) in enumerate(
            sorted(CASES.items())):
        img = source_image(h, w, ch, seed=i)
        cv2.imwrite(str(DATA / f'{name}.png'),
                    img if ch == 3 else np.repeat(img[..., None], 3, -1))
        cv2.imwrite(str(DATA / f'{name}.jpg'), img,
                    write_params(cv2, q, sampling, rst))
        digests[name] = dict(digests_of(cv2, name), quality=q, encode=enc)
    (DATA / 'digests.json').write_text(json.dumps(digests, indent=1,
                                                  sort_keys=True) + '\n')
    print(f'wrote {len(digests)} cases to {DATA}')


def time_codec(repeats: int = 20) -> None:
    """Median ms of OpenCV's and the port's decode and encode of one
    2048x1550 q92 image (the full-size loop's front camera) on this CPU."""
    import cv2

    sys.path.insert(0, str(DATA.parents[2]))
    from far3d_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    img = source_image(2048, 1550, 3, seed=0)
    data = encode_jpeg(img, 92)
    arr = np.frombuffer(data, np.uint8)
    assert data == cv2.imencode('.jpg', img,
                                [cv2.IMWRITE_JPEG_QUALITY, 92])[1].tobytes()
    assert np.array_equal(decode_jpeg(data), cv2.imdecode(arr,
                                                          cv2.IMREAD_COLOR))
    out = {}
    for name, fn in (('cv2_decode', lambda: cv2.imdecode(arr, 1)),
                     ('port_decode', lambda: decode_jpeg(data)),
                     ('cv2_encode', lambda: cv2.imencode(
                         '.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, 92])),
                     ('port_encode', lambda: encode_jpeg(img, 92))):
        fn()
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        out[name + '_ms'] = 1e3 * float(np.median(ts))
    out['decode_ratio'] = out['port_decode_ms'] / out['cv2_decode_ms']
    out['encode_ratio'] = out['port_encode_ms'] / out['cv2_encode_ms']
    print(json.dumps(out))


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--time', action='store_true',
                    help='time both codecs on a 2048x1550 q92 image')
    args = ap.parse_args()
    time_codec() if args.time else make_cases()
