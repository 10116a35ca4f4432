"""PNG writer and reader in pure Python (zlib + struct).

The writer gives the format of the JAX package's native writer
(``native/src/pngio.cpp``) for RGB images: 8-bit RGB, one IDAT of filter-0
scanlines, IEND, CRCs by zlib.crc32.  The reader takes every PNG of the
spec (grey, RGB, palette, grey + alpha and RGBA at each of their bit
depths, either interlace, the five row filters) and returns RGB, as the JAX
package reads images through Pillow's ``Image.open(path).convert("RGB")``;
a corrupt PNG raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, compress_level: int = 1) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got shape {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, compress_level)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray, compress_level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image, compress_level))


# colour type -> (samples per pixel, the bit depths the PNG spec allows)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: (first column, first row, column step, row step) of each pass.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (H, 1 + stride) scanlines -> (H, stride);
    ``bpp`` is the filters' byte distance, the bytes of a pixel (at least 1)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along each byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one bpp before it
            raw, up, rec = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = rec[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                rec[x] = (raw[x] + pred) & 0xFF
            cur = np.array(rec, np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}; 0-4 are defined")
        out[y] = cur
        prev = out[y]
    return out


def _row_bytes(w: int, ch: int, depth: int) -> int:
    return (w * ch * depth + 7) // 8


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered (H, stride) bytes -> (H, W, ch) samples, uint16 at depth 16."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, w, ch)
    if depth == 16:
        return rows.reshape(h, w, ch, 2).astype(np.uint16) @ np.array([256, 1], np.uint16)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits @ weights).astype(np.uint8).reshape(h, w, 1)


def _pixels(raw: np.ndarray, w: int, h: int, ch: int, depth: int, interlace: int) -> np.ndarray:
    """The decompressed IDAT stream -> (H, W, ch) samples."""
    bpp = max(1, ch * depth // 8)
    if interlace == 0:
        passes = [(0, 0, 1, 1)]
    else:
        passes = _ADAM7
    sizes = [((w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy) for x0, y0, dx, dy in passes]
    need = sum(ph * (1 + _row_bytes(pw, ch, depth)) for pw, ph in sizes if pw and ph)
    if raw.size != need:
        raise ValueError(f"PNG pixel data of {raw.size} bytes; {w}x{h} at {ch} samples of "
                         f"{depth} bits{' (Adam7)' if interlace else ''} needs {need}")
    out = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (pw, ph) in zip(passes, sizes):
        if not (pw and ph):
            continue  # an empty pass has no rows, not even filter bytes
        n = ph * (1 + _row_bytes(pw, ch, depth))
        rows = _unfilter(raw[pos:pos + n].reshape(ph, -1), bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += n
    return out


def _to_rgb(px: np.ndarray, color: int, depth: int, palette) -> np.ndarray:
    """Samples -> (H, W, 3) uint8 as Pillow's ``convert("RGB")`` gives them:
    alpha and tRNS dropped, grey repeated, 16-bit samples by their high byte
    except 16-bit grey, which Pillow opens as ``I;16`` and clips at 255;
    grey below 8 bits scaled to 0-255."""
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG (colour type 3) without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)  # an index past PLTE's entries reads black, as in Pillow
        full[:len(palette)] = palette
        return full[px[:, :, 0]]
    if depth == 16:
        v = np.minimum(px, 255) if color == 0 else px >> 8
        px = v.astype(np.uint8)
    elif depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if color in (0, 4):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as Pillow's
    ``Image.open(...).convert("RGB")`` reads them: every colour type and bit
    depth of the spec, PLTE, Adam7; ancillary chunks (tRNS, gAMA, ...) are
    skipped.  A corrupt file, or one outside the spec, raises ValueError."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, header, idat, palette = 8, None, [], None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"PNG chunk {kind!r} runs past the end of the file")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            if n != 13:
                raise ValueError(f"PNG IHDR of {n} bytes; the spec's is 13")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if n % 3 or not 0 < n <= 768:
                raise ValueError(f"PNG PLTE of {n} bytes; 3 to 768, a multiple of 3, are allowed")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, compression, filtering, interlace = header
    if color not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[color][1]:
        raise ValueError(f"PNG of bit depth {depth} and colour type {color}: the spec allows "
                         + "; ".join(f"type {c} at {d}" for c, (_, d) in _COLOUR_TYPES.items()))
    if compression or filtering or interlace not in (0, 1) or not w or not h:
        raise ValueError(f"PNG of size {w}x{h}, compression {compression}, filter method "
                         f"{filtering}, interlace {interlace}: the spec defines nonzero sizes, "
                         "methods 0 and interlace 0 or 1")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG pixel data does not inflate: {e}") from None
    ch = _COLOUR_TYPES[color][0]
    return _to_rgb(_pixels(raw, w, h, ch, depth, interlace), color, depth, palette)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
