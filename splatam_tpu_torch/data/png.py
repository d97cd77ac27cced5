"""PNG reading and writing in numpy and zlib, for machines without an
imaging library.

read_png decodes non-interlaced PNGs of bit depth 8 or 16 in grey, RGB or
RGBA (colour types 0, 2 and 6): the arrays Pillow gives for them (uint8 or
uint16, [H, W] for grey, [H, W, C] otherwise). Every scanline filter is
implemented. None, Sub and Up are vectorised over the row; Average and
Paeth depend on the reconstructed byte to their left, so they loop over a
row's bytes in Python (a few hundred ms for a 640x480 16-bit image whose
every row is Paeth-filtered; PERF.md gives the time chip_smoke.py measures). Interlaced and
palette images, and other bit depths and colour types, raise ValueError
naming the file.

write_png writes uint8 or uint16 [H, W] / [H, W, 3] / [H, W, 4] arrays, every
row with one filter type (0, None, by default; chip_smoke.py times read_png
on Paeth-filtered rows, 4, its slowest case).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels (grey, RGB, RGBA)


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length: pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter_slow(kind: int, raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): byte by byte, left to right."""
    out = [0] * len(raw)
    r, b = raw.tolist(), prior.tolist()
    for x in range(len(r)):
        a = out[x - bpp] if x >= bpp else 0
        if kind == 3:
            out[x] = (r[x] + ((a + b[x]) >> 1)) & 0xFF
            continue
        c = b[x - bpp] if x >= bpp else 0
        p = a + b[x] - c
        pa, pb, pc = abs(p - a), abs(p - b[x]), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b[x] if pb <= pc else c)
        out[x] = (r[x] + pred) & 0xFF
    return np.array(out, dtype=np.uint8)


def _unfilter(data: np.ndarray, height: int, stride: int, bpp: int, path: str) -> np.ndarray:
    rows = data.reshape(height, stride + 1)
    out = np.zeros((height, stride), dtype=np.uint8)
    prior = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        kind, raw = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = raw
        elif kind == 1:  # Sub: a running sum over each byte lane, mod 256
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = raw + prior
        elif kind in (3, 4):
            cur = _unfilter_slow(kind, raw, prior, bpp)
        else:
            raise ValueError(f"{path}: unknown filter type {kind} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            raise ValueError(f"{path}: palette PNGs are not supported by read_png")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _compression, _filter, interlace = header
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNGs are not supported by read_png")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not supported by read_png "
                         "(grey, RGB and RGBA are)")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth} is not supported by read_png")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, "
                         f"expected {height * (stride + 1)}")
    img = _unfilter(raw, height, stride, bpp, path)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(rows: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """Every row of `rows` (bytes [H, stride]) filtered with `kind`."""
    cur = rows.astype(np.int32)
    prior = np.zeros_like(cur)
    prior[1:] = cur[:-1]
    a, c = np.zeros_like(cur), np.zeros_like(cur)
    a[:, bpp:], c[:, bpp:] = cur[:, :-bpp], prior[:, :-bpp]
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (a + prior) >> 1
    elif kind == 4:
        p = a + prior - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
    else:
        raise ValueError(f"write_png: filter type {kind} (0-4 expected)")
    return ((cur - pred) % 256).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png: dtype {img.dtype} (uint8 or uint16 expected)")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"write_png: shape {img.shape} ([H, W], [H, W, 3] or [H, W, 4])")
    height, width, channels = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[channels]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    rows = rows.reshape(height, width * channels * img.dtype.itemsize)
    rows = _filter_rows(rows, filter_type, channels * img.dtype.itemsize)
    scan = np.concatenate([np.full((height, 1), filter_type, np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(scan.tobytes())))
        f.write(_chunk(b"IEND", b""))
