"""The port's JPEG codec (``data/jpeg.py``, ``csrc/jpeg_codec.cpp``) against
OpenCV: decoding equal bit for bit to ``cv2.imread`` / ``cv2.imdecode`` and
encoding equal byte for byte to ``cv2.imwrite(..., [IMWRITE_JPEG_QUALITY,
q])``, on the golden cases of ``tests/data/jpeg`` (their digests derived
again with OpenCV here), on hypothesis-drawn sizes and qualities and on a
full-size camera; the files it refuses, by name; its build from several
processes at once."""

import hashlib
import json
import pathlib
import subprocess
import sys

import cv2
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from far3d_tpu_torch.data import image_io
from far3d_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg, jpeg_info

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / 'tests' / 'data' / 'jpeg'
DIGESTS = json.loads((DATA / 'digests.json').read_text())
sys.path.insert(0, str(ROOT / 'tests'))
from _make_jpeg_cases import (CASES, source_image, source_of_png,  # noqa
                               write_params)


def _sha(b):
    return hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize('name', sorted(CASES))
def test_golden_digests_are_opencvs(name):
    """The stored digests are what OpenCV gives today: the JPEG is
    cv2.imwrite's of the source PNG, and its pixels cv2.imread's."""
    h, w, ch, q, sampling, rst, _ = CASES[name]
    src = source_of_png(cv2.imread(str(DATA / f'{name}.png')), ch)
    assert src.shape[:2] == (h, w)
    np.testing.assert_array_equal(src, source_image(h, w, ch, sorted(
        CASES).index(name)))
    data = cv2.imencode('.jpg', src, write_params(cv2, q, sampling, rst))[1]
    assert _sha(data.tobytes()) == DIGESTS[name]['jpeg_sha256']
    assert _sha((DATA / f'{name}.jpg').read_bytes()) == \
        DIGESTS[name]['jpeg_sha256']
    pixels = cv2.imread(str(DATA / f'{name}.jpg'), cv2.IMREAD_COLOR)
    assert _sha(pixels.tobytes()) == DIGESTS[name]['pixels_sha256']


@pytest.mark.parametrize('name', sorted(CASES))
def test_golden_decode_and_encode(name):
    data = (DATA / f'{name}.jpg').read_bytes()
    got = decode_jpeg(data)
    np.testing.assert_array_equal(
        got, cv2.imread(str(DATA / f'{name}.jpg'), cv2.IMREAD_COLOR))
    assert _sha(got.tobytes()) == DIGESTS[name]['pixels_sha256']
    h, w, ch = CASES[name][:3]
    assert jpeg_info(data) == (h, w, ch)
    if DIGESTS[name]['encode']:
        src = source_of_png(image_io.read_png(str(DATA / f'{name}.png')), ch)
        assert _sha(encode_jpeg(src, DIGESTS[name]['quality'])) == \
            DIGESTS[name]['jpeg_sha256']


def _content(kind, h, w, seed):
    rng = np.random.RandomState(seed)
    if kind == 'noise':
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return source_image(h, w, 3, seed)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(h=st.integers(1, 97), w=st.integers(1, 131), q=st.integers(50, 100),
       kind=st.sampled_from(['noise', 'smooth', 'gray']),
       seed=st.integers(0, 2 ** 31 - 1))
def test_encode_equals_cv2_imencode(h, w, q, kind, seed):
    img = _content('noise' if kind == 'noise' else 'smooth', h, w, seed)
    if kind == 'gray':
        img = np.ascontiguousarray(img[..., 1])
    want = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, q])[1]
    assert encode_jpeg(img, q) == want.tobytes()


@settings(max_examples=60, deadline=None, derandomize=True)
@given(h=st.integers(1, 97), w=st.integers(1, 131), q=st.integers(50, 100),
       sampling=st.sampled_from(['420', '422', '444', 'gray']),
       rst=st.sampled_from([0, 1, 3]), seed=st.integers(0, 2 ** 31 - 1))
def test_decode_equals_cv2_imdecode(h, w, q, sampling, rst, seed):
    img = _content('noise' if seed % 2 else 'smooth', h, w, seed)
    if sampling == 'gray':
        img, sampling = np.ascontiguousarray(img[..., 0]), None
    data = cv2.imencode('.jpg', img, write_params(cv2, q, sampling, rst))[1]
    np.testing.assert_array_equal(decode_jpeg(data.tobytes()),
                                  cv2.imdecode(data, cv2.IMREAD_COLOR))


def test_full_size_camera_q92():
    """A 2048x1550 front camera of the full-size loop's writer, as the
    JAX writer encodes it (q92), both ways."""
    img = source_image(2048, 1550, 3, seed=1)
    want = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, 92])[1]
    assert encode_jpeg(img, 92) == want.tobytes()
    np.testing.assert_array_equal(decode_jpeg(want.tobytes()),
                                  cv2.imdecode(want, cv2.IMREAD_COLOR))


def _segment(marker, payload):
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, 'big') + \
        payload


def _exif(orientation):
    ifd = (b'\x01\x00' + b'\x12\x01\x03\x00\x01\x00\x00\x00'
           + orientation.to_bytes(2, 'little') + b'\x00\x00'
           + b'\x00\x00\x00\x00')
    return _segment(0xE1, b'Exif\x00\x00II*\x00\x08\x00\x00\x00' + ifd)


def _patched(kind):
    data = bytearray((DATA / '420_q92.jpg').read_bytes())
    sof = data.index(b'\xff\xc0')
    if kind == 'progressive':
        img = source_image(16, 16, 3, 0)
        return cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                          1])[1].tobytes()
    if kind == 'arithmetic':
        data[sof + 1] = 0xC9
    elif kind == 'lossless':
        data[sof + 1] = 0xC3
    elif kind == '12-bit':
        data[sof + 4] = 12
    elif kind == 'orientation':
        return bytes(data[:2]) + _exif(6) + bytes(data[2:])
    return bytes(data)


@pytest.mark.parametrize('kind,message', [
    ('progressive', 'progressive'), ('arithmetic', 'arithmetic'),
    ('lossless', 'lossless'), ('12-bit', '12-bit'),
    ('orientation', 'orientation 6')])
def test_refuses_by_name(kind, message):
    with pytest.raises(ValueError, match=message):
        decode_jpeg(_patched(kind))


_CORRUPT_WORKER = '''
import glob, sys
import numpy as np
sys.path.insert(0, {root!r})
from far3d_tpu_torch.data.jpeg import decode_jpeg
rng = np.random.default_rng(0)
files = [open(f, 'rb').read() for f in sorted(glob.glob({data!r} + '/*.jpg'))]
cases = [
    # a DHT with more 1-bit codes than 1 bit holds
    files[0][:2] + bytes([0xFF, 0xC4, 0, 21, 0x00, 5] + [0] * 15 + [1] * 0),
    # a segment length below 2, which would step the parser backwards
    files[0][:2] + bytes([0xFF, 0xE3, 0, 1]) + files[0][2:],
]
for t in range(400):
    d = bytearray(files[t % len(files)])
    if t % 3 == 0:
        for _ in range(int(rng.integers(1, 8))):
            d[int(rng.integers(2, len(d)))] = int(rng.integers(0, 256))
    elif t % 3 == 1:
        d = d[:int(rng.integers(2, len(d)))]
    else:
        i = int(rng.integers(2, len(d) - 4))
        d[i:i + 2] = bytes([0xFF, int(rng.integers(0xC0, 0xFF))])
    cases.append(bytes(d))
raised = 0
for d in cases:
    try:
        decode_jpeg(d)
    except ValueError:
        raised += 1
print(len(cases), raised)
'''


def test_corrupt_files_raise_or_decode():
    """Damaged files (bytes changed, cut short, markers dropped in) decode or
    raise ValueError; none crashes the process or hangs it."""
    proc = subprocess.run(
        [sys.executable, '-c', _CORRUPT_WORKER.format(root=str(ROOT),
                                                      data=str(DATA))],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n, raised = map(int, proc.stdout.split())
    assert n == 402 and raised > 0


def test_exif_orientation_1_decodes():
    data = (DATA / '420_q92.jpg').read_bytes()
    with_exif = data[:2] + _exif(1) + data[2:]
    np.testing.assert_array_equal(decode_jpeg(with_exif), decode_jpeg(data))


def test_write_jpeg_and_read_image(tmp_path):
    img = source_image(37, 61, 3, seed=5)
    path = str(tmp_path / 'a.jpeg')
    image_io.write_jpeg(path, img, 92)
    assert open(path, 'rb').read() == cv2.imencode(
        '.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, 92])[1].tobytes()
    np.testing.assert_array_equal(image_io.read_image(path), cv2.imread(path))
    # a JPEG under another name is told by its first bytes
    other = tmp_path / 'b.img'
    other.write_bytes(open(path, 'rb').read())
    np.testing.assert_array_equal(image_io.read_image(str(other)),
                                  cv2.imread(path))
    (tmp_path / 'c.bmp').write_bytes(cv2.imencode('.bmp', img)[1].tobytes())
    with pytest.raises(ValueError, match='neither PNG nor JPEG'):
        image_io.read_image(str(tmp_path / 'c.bmp'))


_BUILD_WORKER = '''
import pathlib, sys
import numpy as np
sys.path.insert(0, {root!r})
from far3d_tpu_torch.ops import _build
_build.BUILD_DIR = pathlib.Path({build!r})
from far3d_tpu_torch.data import jpeg
img = np.full((9, 11, 3), 7 * {i}, np.uint8)
assert jpeg.decode_jpeg(jpeg.encode_jpeg(img, 90)).shape == (9, 11, 3)
'''


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Processes that build the codec into one empty directory at once (as
    the test workers do) each load a whole library: the build goes to a
    temporary file that is renamed into place."""
    procs = [subprocess.Popen(
        [sys.executable, '-c', _BUILD_WORKER.format(
            root=str(ROOT), build=str(tmp_path), i=i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(4)]
    outs = [(p.communicate(timeout=300)[0], p.returncode) for p in procs]
    assert all(rc == 0 for _, rc in outs), outs
    libs = [p.name for p in tmp_path.iterdir()]
    assert len(libs) == 1 and libs[0].startswith('jpeg_codec-'), libs
