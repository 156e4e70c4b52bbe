"""Self-contained PNG codec (8/16-bit, gray/RGB/RGBA, no interlace).

The reference uses Go's image/png (NRGBA and NRGBA64 writers,
/root/reference/mel/impl.go:127-193, phase/impl.go:168-278) and, in the port,
PIL for 8-bit plus pypng for 16-bit HDR (/root/reference/phase.py:716-747).
pypng is not available in this environment, so the framework ships its own
codec: zlib (C speed) for inflate/deflate, a native C++ helper
(gomel_tpu/native/pngfilter.cpp) for the sequential scanline filter/unfilter loops, and
a pure numpy/Python fallback when the toolchain is absent.

Supports color types 0 (gray), 2 (RGB), 4 (gray+alpha), 6 (RGBA) at bit depth
8 or 16, which covers everything Go's encoder emits for NRGBA/NRGBA64 images.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ._native import get_lib

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}

# Decode-size ceiling for untrusted files (raw filtered scanline bytes).
# 2 GiB admits ~35 minutes of HDR phase PNG at the flagship config; callers
# with genuinely larger artifacts may raise it (module attribute).
MAX_IMAGE_BYTES = 1 << 31


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray, compress_level: int = 1,
              compress_strategy: int = zlib.Z_RLE) -> None:
    """Write an image array as PNG.

    path: filesystem path or binary file object.
    image: uint8 or uint16 array of shape [H, W] (gray), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA). 16-bit samples are stored big-endian per the PNG spec.
    compress_level / compress_strategy: zlib settings for the IDAT deflate.
    PNG is lossless at any setting — this is an encoder-private speed/size
    trade. Measured on real quantized spectrogram streams
    (host CPU deflate):
    Z_RLE is 2.0-3.2x FASTER than the old level-3 default AND 2.4-5.2%
    SMALLER on Up-filtered spectrogram scanlines (run-length coding matches
    the residual structure; the level is irrelevant under Z_RLE). For
    maximum-compression archival pass compress_strategy=zlib.Z_DEFAULT_STRATEGY
    with compress_level 6+.
    """
    image = np.ascontiguousarray(image)
    if image.dtype == np.uint8:
        depth = 8
    elif image.dtype == np.uint16:
        depth = 16
    else:
        raise ValueError(f"unsupported dtype {image.dtype}")
    if image.ndim == 2:
        ctype = 0
    elif image.ndim == 3 and image.shape[2] == 3:
        ctype = 2
    elif image.ndim == 3 and image.shape[2] == 4:
        ctype = 6
    else:
        raise ValueError(f"unsupported shape {image.shape}")
    h, w = image.shape[0], image.shape[1]

    if depth == 16:
        body = image.astype(">u2").tobytes()
    else:
        body = image.tobytes()
    rowbytes = len(body) // h
    img_rows = np.frombuffer(body, dtype=np.uint8).reshape(h, rowbytes)

    lib = get_lib()
    if lib is not None:
        raw = np.empty(h * (rowbytes + 1), dtype=np.uint8)
        src = np.ascontiguousarray(img_rows)
        lib.png_filter_up(src.ctypes.data, raw.ctypes.data, h, rowbytes)
        raw_bytes = raw.tobytes()
    else:
        # numpy fallback: filter type 2 (Up) for rows > 0, 0 for row 0
        filtered = np.empty((h, rowbytes + 1), dtype=np.uint8)
        filtered[0, 0] = 0
        filtered[0, 1:] = img_rows[0]
        if h > 1:
            filtered[1:, 0] = 2
            filtered[1:, 1:] = img_rows[1:] - img_rows[:-1]
        raw_bytes = filtered.tobytes()

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    comp = zlib.compressobj(compress_level, zlib.DEFLATED, 15, 8,
                            compress_strategy)
    idat = comp.compress(raw_bytes) + comp.flush()
    payload = (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
               + _chunk(b"IEND", b""))
    if hasattr(path, "write"):
        path.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def _unfilter_python(raw: np.ndarray, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Pure-Python/numpy scanline unfilter (slow Paeth path; fallback only)."""
    out = np.zeros((h, rowbytes), dtype=np.uint8)
    raw = raw.reshape(h, rowbytes + 1)
    for y in range(h):
        ft = int(raw[y, 0])
        line = raw[y, 1:].astype(np.int32)
        up = out[y - 1].astype(np.int32) if y > 0 else np.zeros(rowbytes, np.int32)
        if ft == 0:
            cur = line
        elif ft == 2:
            cur = (line + up) & 0xFF
        elif ft == 1:
            cur = line.copy()
            for x in range(bpp, rowbytes):
                cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
        elif ft == 3:
            cur = line.copy()
            for x in range(rowbytes):
                a = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((a + up[x]) >> 1)) & 0xFF
        elif ft == 4:
            cur = line.copy()
            for x in range(rowbytes):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(up[x])
                c = int(up[x - bpp]) if (y > 0 and x >= bpp) else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"invalid PNG filter type {ft}")
        out[y] = cur.astype(np.uint8)
    return out


def read_png(path: str) -> np.ndarray:
    """Read a PNG file -> numpy array [H, W] or [H, W, C], dtype uint8/uint16.

    Handles all five filter types; interlace and palette images are rejected.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: {path!r}")
    pos = 8
    idat = []
    w = h = depth = ctype = interlace = None
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("corrupt PNG: truncated chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            if len(payload) < 13:
                raise ValueError("corrupt PNG: truncated IHDR")
            w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", payload[:13])
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if w is None:
        raise ValueError("missing IHDR")
    if interlace != 0:
        raise ValueError("interlaced PNG not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG color type {ctype}")
    if depth not in (8, 16):
        raise ValueError(f"unsupported PNG bit depth {depth}")
    channels = _CHANNELS[ctype]
    bpp = channels * (depth // 8)
    rowbytes = w * bpp
    if w == 0 or h == 0:
        raise ValueError("corrupt PNG: zero image dimension")
    expected = h * (rowbytes + 1)
    # Untrusted-input bounds (same policy as the FLAC decoder's
    # decompression-bomb guard, native/flacdec.cpp): reject absurd IHDR
    # dimensions outright, and never inflate more than the image needs —
    # a KB-scale crafted IDAT must not be able to demand GBs of output.
    if expected > MAX_IMAGE_BYTES:
        raise ValueError(
            f"PNG dimensions {w}x{h} ({channels} ch, depth {depth}) exceed "
            f"the {MAX_IMAGE_BYTES >> 20} MiB decode limit")
    try:
        dec = zlib.decompressobj()
        raw_bytes = dec.decompress(b"".join(idat), expected)
        if dec.unconsumed_tail and dec.decompress(dec.unconsumed_tail, 1):
            raise ValueError("corrupt PNG: IDAT inflates past the image size")
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: bad IDAT stream ({e})") from None
    raw = np.frombuffer(raw_bytes, dtype=np.uint8)
    if raw.size != expected:
        raise ValueError("corrupt PNG: unexpected data size")

    lib = get_lib()
    if lib is not None:
        out = np.empty(h * rowbytes, dtype=np.uint8)
        src = np.ascontiguousarray(raw)
        rc = lib.png_unfilter(src.ctypes.data, out.ctypes.data, h, rowbytes, bpp)
        if rc != 0:
            raise ValueError("invalid PNG filter type")
        flat = out
    else:
        flat = _unfilter_python(raw.copy(), h, rowbytes, bpp).reshape(-1)

    if depth == 16:
        img = flat.view(np.uint8).reshape(h, w, channels, 2)
        arr = (img[..., 0].astype(np.uint16) << 8) | img[..., 1].astype(np.uint16)
    else:
        arr = flat.reshape(h, w, channels)
    if channels == 1:
        arr = arr.reshape(h, w)
    return arr
