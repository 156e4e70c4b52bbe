"""Generate byte-exact Go-layout phase PNG fixtures.

The repo's phase reader was previously validated only against the repo's
own writer (self-consistency). The reference repo ships no Go-binary phase
PNG and no Go toolchain exists here, so this script constructs the
artifacts the Go writer WOULD produce by transcribing
/root/reference/phase/impl.go line by line — independently of
gomel_tpu.io.imagecodec / pngcodec (pure-Python per-pixel loops + a
minimal self-contained PNG encoder, no repo imports):

  - dumpimage (impl.go:168-278): in-place asinh passes (impl.go:171-177);
    column-major buf indexing ``buf[y + x*mels]`` (impl.go:203, 229);
    per-channel float64 min/max over the (asinh'd) buffer
    (impl.go:198-212); 16-byte float16 metadata block max0, max1, 0,
    min0, min1, 0, samples_in_mel, sr (impl.go:213-222) stored in the
    blue channel of column x=0 at rows >= mels-16 (impl.go:233-248,
    255-264); quantization R = uint8(int(255*val0)) / uint16(int(65535*
    val0)) for HDR — Go's int() truncation, then uint8/uint16 WRAPAROUND
    for the conjugate hint B = -val0 (impl.go:230: val2 := -val0, so
    int(255*val2) is negative and the uint8 conversion takes the low
    byte); A = 255/65535; y-flip when reverse (impl.go:246, 261).
  - The quantization normalizes by the RAW float64 min/max while the
    metadata stores the float16-ROUNDED values — the reader rescales with
    the rounded ones (impl.go:139-142), so the expected decode below uses
    float16(max/min), not the raw extrema.
  - loadpng (impl.go:51-153): val0 = (r>>8)/255 (8-bit; r = R8*0x101 so
    r>>8 == R8) or r/65535 (HDR, A=65535 so RGBA() returns raw);
    v = val*(max-min)+min; sinh undo per IHS pass (impl.go:141-147);
    samples = samples_in_mel * stride (impl.go:149).

Outputs (checked in):
  phase_go_8bit.png        reverse=True, ihs=0, 32 bins x 24 frames
  phase_go_8bit_ihs.png    reverse=True, ihs=2 (asinh-compressed)
  phase_go_hdr.png         reverse=True, ihs=0, NRGBA64 16-bit
  phase_go_expected.npz    per-fixture expected (spec, samples, sr)

Run from the repo root:  python tests/fixtures/make_phase_go_fixture.py
"""
from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

MELS, STRIDE = 32, 24          # nf x frames; nf >= 16 for the metadata block
SAMPLES_IN_MEL = 1664.0        # float16-exact
SR = 48000.0                   # float16-exact (step 32 at this magnitude)


# --- minimal standalone PNG encoder (RGBA, 8- or 16-bit, no filters) -------

def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png_rgba(path: str, rows, bit16: bool) -> None:
    """rows: [height][width] of (r, g, b, a) ints."""
    h, w = len(rows), len(rows[0])
    raw = bytearray()
    for row in rows:
        raw.append(0)  # filter type None
        for px in row:
            for s in px:
                if bit16:
                    raw += struct.pack(">H", s)
                else:
                    raw.append(s)
    ihdr = struct.pack(">IIBBBBB", w, h, 16 if bit16 else 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(bytes(raw))))
        f.write(_chunk(b"IEND", b""))


# --- Go transcriptions ------------------------------------------------------

def pack_float16(v: float) -> bytes:
    """packFloat16ToBytes (impl.go:155-160): float16.Fromfloat32(float32(v))
    little-endian — numpy's float16 cast is the same round-to-nearest-even."""
    return struct.pack("<e", np.float16(np.float32(v)))


def f16_round(v: float) -> float:
    """What the reader recovers from the packed bytes."""
    return float(np.float16(np.float32(v)))


def synth_buf():
    """Deterministic synthetic 2-channel spectrogram, column-major like the
    Go buf (index y + x*mels); mixed-sign values so the B = -val0 uint8/16
    wraparound is actually exercised."""
    buf = []
    for x in range(STRIDE):
        for y in range(MELS):
            v0 = 1.7 * math.sin(0.37 * x + 0.11 * y) + 0.3 * math.cos(0.05 * x * y)
            v1 = 1.3 * math.cos(0.23 * x - 0.07 * y) - 0.2 * math.sin(0.13 * y)
            buf.append([v0, v1])
    return buf


def dumpimage_go(path: str, buf, mels: int, reverse: bool,
                 samples_in_mel: float, sr: float, ihs_passes: int,
                 hdr: bool):
    """Line-by-line transcription of dumpimage (impl.go:168-278). Returns
    the pixel grid it wrote (for the expected-decode computation)."""
    buf = [list(v) for v in buf]
    for _ in range(ihs_passes):                      # impl.go:171-177
        for v in buf:
            v[0] = math.asinh(v[0])
            v[1] = math.asinh(v[1])
    stride = len(buf) // mels                        # impl.go:184
    max_val = 65535 if hdr else 255                  # impl.go:186-189
    mgc_max = [-math.inf, -math.inf]                 # impl.go:198
    mgc_min = [math.inf, math.inf]
    for x in range(stride):                          # impl.go:200-212
        for l in range(2):
            for y in range(mels):
                w = buf[y + x * mels][l]
                mgc_max[l] = max(mgc_max[l], w)
                mgc_min[l] = min(mgc_min[l], w)
    floats = (pack_float16(mgc_max[0]) + pack_float16(mgc_max[1])
              + pack_float16(0) + pack_float16(mgc_min[0])
              + pack_float16(mgc_min[1]) + pack_float16(0)
              + pack_float16(samples_in_mel) + pack_float16(sr))
    rows = [[None] * stride for _ in range(mels)]
    meta_start = mels - len(floats)                  # impl.go:232
    for x in range(stride):                          # impl.go:226-266
        for y in range(mels):
            val0 = ((buf[y + x * mels][0] - mgc_min[0])
                    / (mgc_max[0] - mgc_min[0]))
            val1 = ((buf[y + x * mels][1] - mgc_min[1])
                    / (mgc_max[1] - mgc_min[1]))
            val2 = -val0                             # impl.go:230
            wrap = 0x10000 if hdr else 0x100
            r = int(max_val * val0) % wrap           # Go int()+uint conv
            g = int(max_val * val1) % wrap
            if x == 0 and y >= meta_start:           # impl.go:238-242/255-258
                b = floats[y - meta_start]
            else:
                b = int(max_val * val2) % wrap       # wraparound hint
            a = max_val
            yy = mels - y - 1 if reverse else y      # impl.go:245-249/260-264
            rows[yy][x] = (r, g, b, a)
    write_png_rgba(path, rows, bit16=hdr)
    return rows


def expected_decode(rows, mels: int, reverse: bool, ihs_passes: int,
                    hdr: bool):
    """loadpng transcription (impl.go:51-153) applied to the written pixels
    — PNG is lossless so reading the grid back equals decoding the file."""
    stride = len(rows[0])
    max_val = 65535 if hdr else 255
    # metadata: blue of column 0 at logical rows >= mels-16 (reverse undone)
    floats = bytearray()
    meta_start = mels - 16
    for y in range(meta_start, mels):
        yy = mels - y - 1 if reverse else y
        b = rows[yy][0][2]
        floats.append(b & 0xFF if hdr else b)        # impl.go:91-96
    vals = [f16_round(struct.unpack("<e", bytes(floats[i:i + 2]))[0])
            for i in range(0, 16, 2)]
    max0, max1, _z0, min0, min1, _z1, samples_in_mel, sr = [
        float(v) for v in vals]
    spec = np.zeros((stride, mels, 2))
    for x in range(stride):
        for y in range(mels):
            yy = mels - y - 1 if reverse else y
            r, g = rows[yy][x][0], rows[yy][x][1]
            val0 = r / max_val                       # impl.go:100-110
            val1 = g / max_val
            spec[x, y, 0] = val0 * (max0 - min0) + min0   # impl.go:139-142
            spec[x, y, 1] = val1 * (max1 - min1) + min1
    for _ in range(ihs_passes):                      # impl.go:141-147
        spec = np.sinh(spec)
    samples = samples_in_mel * stride                # impl.go:149
    return spec, samples, sr


def main():
    buf = synth_buf()
    out = {}
    for name, ihs, hdr in (("phase_go_8bit", 0, False),
                           ("phase_go_8bit_ihs", 2, False),
                           ("phase_go_hdr", 0, True)):
        path = os.path.join(HERE, name + ".png")
        rows = dumpimage_go(path, buf, MELS, True, SAMPLES_IN_MEL, SR,
                            ihs, hdr)
        spec, samples, sr = expected_decode(rows, MELS, True, ihs, hdr)
        out[name + "_spec"] = spec
        out[name + "_samples"] = samples
        out[name + "_sr"] = sr
        print(f"{name}.png: {MELS}x{STRIDE} hdr={hdr} ihs={ihs} "
              f"samples={samples} sr={sr}")
    np.savez(os.path.join(HERE, "phase_go_expected.npz"), **out)


if __name__ == "__main__":
    main()
