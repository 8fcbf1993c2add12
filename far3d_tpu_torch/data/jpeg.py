"""The port's baseline JPEG codec: decoding equal bit for bit to
``cv2.imread(path, IMREAD_COLOR)`` / ``cv2.imdecode`` and encoding equal byte
for byte to ``cv2.imwrite(path, img, [IMWRITE_JPEG_QUALITY, q])``, as OpenCV
builds them on libjpeg-turbo with its defaults.

The codec is host C++ (``csrc/jpeg_codec.cpp``; the entropy coding is serial,
and a 7-camera AV2 frame is seven 2048x1550 images), built at first use by
``ops/_build.py:load_host_library`` and bound with ctypes. What it decodes and
what it raises on by name is listed at the head of that file. There is no
other route: a failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ..ops._build import load_host_library
        lib = load_host_library('jpeg_codec')
        lib.jpeg_last_error.restype = ctypes.c_char_p
        lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
        lib.jpeg_encode.restype = ctypes.c_long
        lib.jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.POINTER(
                                        ctypes.c_uint8))]
        lib.jpeg_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _LIB = lib
    return _LIB


def _error(lib) -> str:
    return lib.jpeg_last_error().decode()


def jpeg_info(data: bytes):
    """(height, width, components) of a JPEG's frame header."""
    lib = _lib()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                     ctypes.byref(c)):
        raise ValueError(_error(lib))
    return h.value, w.value, c.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 BGR of a JPEG file's bytes, as ``cv2.imdecode(...,
    IMREAD_COLOR)`` gives it (a grayscale file comes out with three equal
    channels). Raises ``ValueError`` on a file it does not decode."""
    data = bytes(data)
    lib = _lib()
    h, w, _ = jpeg_info(data)
    out = np.empty((h, w, 3), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, h, w):
        raise ValueError(_error(lib))
    return out


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """The bytes ``cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY,
    quality])`` gives for an (H, W, 3) uint8 BGR image (4:2:0) or an (H, W)
    uint8 gray one. OpenCV's default quality is 95."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (1, 3))):
        raise ValueError(f'encode_jpeg takes (H, W) or (H, W, 3) uint8, got '
                         f'{img.shape} {img.dtype}')
    channels = 1 if img.ndim == 2 else img.shape[2]
    lib = _lib()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.jpeg_encode(img.ctypes.data, img.shape[0], img.shape[1], channels,
                        int(quality), ctypes.byref(buf))
    if n < 0:
        raise ValueError(_error(lib))
    try:
        return ctypes.string_at(buf, n)
    finally:
        lib.jpeg_free(buf)
