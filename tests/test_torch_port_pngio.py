"""The port's PNG reader against Pillow, on the CPU.

The JAX package reads every PNG through Pillow's
``Image.open(...).convert("RGB")`` (``sid_lsg_tpu/data/mscoco.py``,
``sid_lsg_tpu/cli/encode_latents.py``); the port's callers read PNGs through
``cli/pngio.py:decode_png``, which must give the same pixels bit for bit.
The files are built here by hand with ``zlib``: each colour type at each bit
depth the spec allows, rows filtered by turns with None, Sub, Up, Average
and Paeth, plain and Adam7 (Pillow writes no interlaced PNG), with PLTE and
tRNS chunks.  Corrupt files and files outside the spec must raise.
"""

import io
import struct
import zlib

import numpy as np
import pytest

from sid_lsg_torch.cli.pngio import decode_png, encode_png

Image = pytest.importorskip("PIL.Image")

# colour type -> samples per pixel, bit depths
SPEC = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
        6: (4, (8, 16))}
CASES = [(c, d) for c, (_, depths) in SPEC.items() for d in depths]
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, ch) samples -> (H, stride) bytes of one PNG image or pass."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return np.stack([flat >> 8, flat & 0xFF], axis=-1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[:, :, None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filter(rows: np.ndarray, bpp: int, first_kind: int) -> bytes:
    """Filter each row, the kinds 0-4 in turn from ``first_kind``."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = (first_kind + y) % 5
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (a + prev) >> 1
        else:
            pa, pb, pc = np.abs(prev - c), np.abs(a - c), np.abs(a + prev - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([kind]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def build_png(samples: np.ndarray, color: int, depth: int, interlace: int = 0,
              extra=(), first_kind: int = 0) -> bytes:
    """A PNG of ``samples`` (H, W, ch); ``extra``: (kind, body) chunks
    placed before IDAT."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub, depth), bpp, first_kind)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(k, b) for k, b in extra)
            + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b""))


def pillow_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def random_case(color: int, depth: int, seed: int, h: int = 11, w: int = 13):
    """Samples spanning the whole range, and the PLTE chunk of type 3."""
    rng = np.random.default_rng(seed)
    ch = SPEC[color][0]
    samples = rng.integers(0, 1 << depth, size=(h, w, ch), dtype=np.int64)
    samples.flat[0], samples.flat[-1] = 0, (1 << depth) - 1
    # Smooth rows too, where Average and Paeth predict from their neighbours.
    samples[h // 2:] = np.sort(samples[h // 2:], axis=1)
    extra = []
    if color == 3:
        extra.append((b"PLTE", rng.integers(0, 256, size=(1 << depth) * 3, dtype=np.uint8).tobytes()))
    return samples, extra


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color,depth", CASES)
def test_decode_png_equals_pillow(color, depth, interlace):
    samples, extra = random_case(color, depth, seed=10 * color + depth)
    for first_kind in range(5):
        data = build_png(samples, color, depth, interlace, extra, first_kind)
        got = decode_png(data)
        assert got.dtype == np.uint8 and got.shape == (11, 13, 3)
        np.testing.assert_array_equal(got, pillow_rgb(data))


def test_what_pillow_gives_for_16_bits_and_1_bit():
    """The readings the port matches: 16-bit RGB by the high byte, 16-bit
    grey clipped at 255 (Pillow's ``I;16``), 1-bit grey as 0 / 255."""
    rgb = np.array([[[1000, 40000, 65535]]])
    assert decode_png(build_png(rgb, 2, 16)).tolist() == [[[3, 156, 255]]]
    assert pillow_rgb(build_png(rgb, 2, 16)).tolist() == [[[3, 156, 255]]]
    grey = np.array([[[1000], [200], [0]]])
    for read in (decode_png, pillow_rgb):
        assert read(build_png(grey, 0, 16))[0, :, 0].tolist() == [255, 200, 0]
        assert read(build_png(np.array([[[0], [1]]]), 0, 1))[0, :, 0].tolist() == [0, 255]


def test_adam7_with_small_and_empty_passes():
    """Images narrower and shorter than the 8x8 Adam7 block, where some
    passes hold no pixel and so no rows."""
    for h, w in ((1, 1), (1, 5), (3, 2), (5, 9)):
        samples, extra = random_case(2, 8, seed=h * w, h=h, w=w)
        data = build_png(samples, 2, 8, interlace=1)
        np.testing.assert_array_equal(decode_png(data), pillow_rgb(data))
        np.testing.assert_array_equal(decode_png(data), samples.astype(np.uint8))


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("color,depth,trns", [
    (3, 8, bytes([0, 128, 255])),  # alpha of the first three palette entries
    (3, 2, bytes([7])),
    (0, 16, struct.pack(">H", 1000)),
    (2, 8, struct.pack(">HHH", 1, 2, 3)),
])
def test_trns_is_dropped_as_convert_rgb_drops_it(color, depth, trns):
    samples, extra = random_case(color, depth, seed=depth + 1)
    data = build_png(samples, color, depth, extra=extra + [(b"tRNS", trns)])
    with Image.open(io.BytesIO(data)) as img:
        assert "transparency" in img.info
    np.testing.assert_array_equal(decode_png(data), pillow_rgb(data))


def test_palette_shorter_than_the_index_range_and_split_idat():
    """A PLTE of 5 entries under 8-bit indices 0-6 (Pillow reads the two past
    its end as black), the pixel data split over three IDAT chunks, an
    ancillary chunk before them."""
    rng = np.random.default_rng(3)
    samples = rng.integers(0, 7, size=(9, 10, 1))
    plte = (b"PLTE", rng.integers(0, 256, size=15, dtype=np.uint8).tobytes())
    one = build_png(samples, 3, 8, extra=[plte])
    start = one.index(b"IDAT") - 4
    (n,) = struct.unpack(">I", one[start:start + 4])
    body = one[start + 8:start + 8 + n]
    parts = [body[:5], body[5:9], body[9:]]
    split = (one[:start] + _chunk(b"tEXt", b"k\x00v") + b"".join(_chunk(b"IDAT", p) for p in parts)
             + _chunk(b"IEND", b""))
    np.testing.assert_array_equal(decode_png(split), pillow_rgb(one))
    np.testing.assert_array_equal(decode_png(split), pillow_rgb(split))
    assert (decode_png(split)[samples[:, :, 0] >= 5] == 0).all()


def test_the_writer_round_trips():
    img = np.random.default_rng(4).integers(0, 256, size=(7, 6, 3), dtype=np.uint8)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(pillow_rgb(data), img)


def _with_ihdr(data: bytes, **fields) -> bytes:
    names = ("w", "h", "depth", "color", "compression", "filter", "interlace")
    values = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])), **fields)
    return data[:8] + _chunk(b"IHDR", struct.pack(">IIBBBBB", *values.values())) + data[33:]


def _bad_files():
    samples, extra = random_case(2, 8, seed=5)
    good = build_png(samples, 2, 8)
    crc = bytearray(good)
    crc[40] ^= 0xFF  # a byte of the IDAT body
    grey, _ = random_case(0, 8, seed=6)
    body = _filter(grey.reshape(11, 13).astype(np.uint8), 1, 0)
    bad_filter = body[:14] + bytes([5]) + body[15:]
    ihdr = struct.pack(">IIBBBBB", 13, 11, 8, 0, 0, 0, 0)
    raw = lambda payload: (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                           + _chunk(b"IDAT", payload) + _chunk(b"IEND", b""))
    return {
        "fails its CRC": bytes(crc),
        "not a PNG": b"GIF89a" + good[6:],
        "runs past the end": good[:-20],
        "bit depth 16 and colour type 3": _with_ihdr(good, depth=16, color=3),
        "bit depth 4 and colour type 2": _with_ihdr(good, depth=4),
        "colour type 5": _with_ihdr(good, color=5),
        "interlace 2": _with_ihdr(good, interlace=2),
        "compression 1": _with_ihdr(good, compression=1),
        "filter type 5": raw(zlib.compress(bad_filter)),
        "needs": raw(zlib.compress(body[:-1])),
        "does not inflate": raw(b"\x00not zlib"),
        "without a PLTE": build_png(random_case(3, 8, seed=7)[0], 3, 8),
        "without IHDR or IDAT": b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IEND", b""),
    }


@pytest.mark.parametrize("what", list(_bad_files()))
def test_corrupt_or_undefined_pngs_raise_and_say_what(what):
    with pytest.raises(ValueError, match=what):
        decode_png(_bad_files()[what])


def test_coco_caption_datasets_read_the_same_pixels(tmp_path):
    """The JAX ``CocoCaptionDataset`` (Pillow) and the port's
    (``decode_png``) on one folder of PNGs of every colour type."""
    pytest.importorskip("jax")
    from sid_lsg_torch.data.mscoco import CocoCaptionDataset
    from sid_lsg_tpu.data.mscoco import CocoCaptionDataset as JaxCocoCaptionDataset

    for i, (color, depth) in enumerate(CASES):
        samples, extra = random_case(color, depth, seed=i)
        (tmp_path / f"{i:02d}.png").write_bytes(build_png(samples, color, depth, i % 2, extra))
        (tmp_path / f"{i:02d}.txt").write_text(f"caption {i}")
    port, ref = CocoCaptionDataset(str(tmp_path)), JaxCocoCaptionDataset(str(tmp_path))
    assert len(port) == len(ref) == len(CASES)
    for i in range(len(CASES)):
        (img, cap), (img_ref, cap_ref) = port[i], ref[i]
        assert cap == cap_ref == f"caption {i}"
        np.testing.assert_array_equal(img, img_ref)
