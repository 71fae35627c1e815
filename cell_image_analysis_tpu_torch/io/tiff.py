"""Self-contained TIFF codec (reader and writer), pure Python + numpy + zlib.

Counterpart of `cell_image_analysis_tpu/io/tiff.py`, without its optional
C++ strip decoders: PackBits and LZW strips are decoded here in Python.

Supported on read: little/big endian, baseline strips (no tiles), bits 8/16/
32/64, sample formats uint/int/float, compression none/PackBits/LZW/Deflate,
horizontal-differencing predictor, planar configs chunky+separate, multi-page.
The writer emits uncompressed little-endian chunky TIFFs (any of the dtypes
above, 1..N channels) that round-trip through this reader and external
readers.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO

import numpy as np

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q", 17: "q"}


def _read_ifd_entries(f: BinaryIO, bo: str, offset: int) -> tuple[dict, int]:
    f.seek(offset)
    (n,) = struct.unpack(bo + "H", f.read(2))
    entries = {}
    for _ in range(n):
        tag, typ, count = struct.unpack(bo + "HHI", f.read(8))
        raw = f.read(4)
        size = _TYPE_SIZES.get(typ, 1) * count
        if size > 4:
            (ptr,) = struct.unpack(bo + "I", raw)
            pos = f.tell()
            f.seek(ptr)
            data = f.read(size)
            f.seek(pos)
        else:
            data = raw[:size]
        if typ in _TYPE_FMT:
            vals = struct.unpack(bo + _TYPE_FMT[typ] * count, data)
        elif typ == 5:  # RATIONAL
            flat = struct.unpack(bo + "I" * (2 * count), data)
            vals = tuple(flat[i] / max(flat[i + 1], 1) for i in range(0, 2 * count, 2))
        elif typ == 10:  # SRATIONAL
            flat = struct.unpack(bo + "i" * (2 * count), data)
            vals = tuple(flat[i] / max(flat[i + 1], 1) for i in range(0, 2 * count, 2))
        elif typ == 2:  # ASCII
            vals = (data.rstrip(b"\0").decode("ascii", "replace"),)
        else:
            vals = (data,)
        entries[tag] = vals
    (next_ifd,) = struct.unpack(bo + "I", f.read(4))
    return entries, next_ifd


def _unpackbits(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < expected:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i : i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i : i + 1] * (257 - n)
            i += 1
        # n == 128: no-op
    return bytes(out)


def _lzw_decode(data: bytes, expected: int) -> bytes:
    """TIFF-variant LZW (MSB-first codes, early change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list[bytes] = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    bitbuf = 0
    bitcnt = 0
    width = 9
    prev: bytes | None = None
    pos = 0
    n = len(data)
    while len(out) < expected:
        while bitcnt < width:
            if pos >= n:
                return bytes(out)
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
        bitcnt -= width
        if code == CLEAR:
            reset()
            width = 9
            prev = None
            continue
        if code == EOI:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF early-change: widen one code before the table is full
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _decompress(data: bytes, compression: int, expected: int) -> bytes:
    if compression == 1:
        return data
    if compression == 32773:
        return _unpackbits(data, expected)
    if compression == 5:
        return _lzw_decode(data, expected)
    if compression in (8, 32946):  # zlib/deflate
        return zlib.decompress(data)
    raise ValueError(f"unsupported TIFF compression {compression}")


def _undo_predictor(arr: np.ndarray, spp: int) -> np.ndarray:
    """Predictor 2: horizontal differencing per sample plane."""
    arr = arr.reshape(arr.shape[0], -1, spp)
    return np.cumsum(arr.astype(np.int64), axis=1).astype(arr.dtype).reshape(arr.shape[0], -1)


def _page_to_array(f: BinaryIO, bo: str, e: dict) -> np.ndarray:
    width = e[256][0]
    height = e[257][0]
    spp = e.get(277, (1,))[0]
    bits = e.get(258, (1,) * spp)[0]
    compression = e.get(259, (1,))[0]
    sample_format = e.get(339, (1,))[0]
    predictor = e.get(317, (1,))[0]
    planar = e.get(284, (1,))[0]
    rows_per_strip = e.get(278, (height,))[0]
    offsets = e[273]
    counts = e[279]

    kind = {1: "u", 2: "i", 3: "f"}[sample_format]
    dtype = np.dtype(f"{bo[0] if bo == '>' else '<'}{kind}{bits // 8}")

    if planar == 1:
        rows_done = 0
        chunks = []
        for off, cnt in zip(offsets, counts):
            rows = min(rows_per_strip, height - rows_done)
            expected = rows * width * spp * (bits // 8)
            f.seek(off)
            raw = _decompress(f.read(cnt), compression, expected)
            strip = np.frombuffer(raw[:expected], dtype=dtype).reshape(rows, width * spp)
            if predictor == 2:
                strip = _undo_predictor(strip, spp)
            chunks.append(strip)
            rows_done += rows
        img = np.concatenate(chunks, axis=0).reshape(height, width, spp)
    else:  # planar == 2: one set of strips per sample plane
        strips_per_plane = len(offsets) // spp
        planes = []
        for s in range(spp):
            rows_done = 0
            chunks = []
            for k in range(strips_per_plane):
                off, cnt = offsets[s * strips_per_plane + k], counts[s * strips_per_plane + k]
                rows = min(rows_per_strip, height - rows_done)
                expected = rows * width * (bits // 8)
                f.seek(off)
                raw = _decompress(f.read(cnt), compression, expected)
                strip = np.frombuffer(raw[:expected], dtype=dtype).reshape(rows, width)
                if predictor == 2:
                    strip = _undo_predictor(strip, 1).reshape(rows, width)
                chunks.append(strip)
                rows_done += rows
            planes.append(np.concatenate(chunks, axis=0))
        img = np.stack(planes, axis=-1)

    if spp == 1:
        img = img[:, :, 0]
    return np.ascontiguousarray(img.astype(img.dtype.newbyteorder("=")))


def imread(path: str, pages: str = "first") -> np.ndarray:
    """Read a TIFF.  pages='first' returns the first page; 'all' stacks
    pages along axis 0 when shapes agree."""
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:2] == b"II":
            bo = "<"
        elif head[:2] == b"MM":
            bo = ">"
        else:
            raise ValueError(f"{path}: not a TIFF file")
        (magic,) = struct.unpack(bo + "H", head[2:4])
        if magic != 42:
            raise ValueError(f"{path}: bad TIFF magic {magic}")
        (ifd,) = struct.unpack(bo + "I", head[4:8])
        arrays = []
        while ifd:
            entries, ifd = _read_ifd_entries(f, bo, ifd)
            arrays.append(_page_to_array(f, bo, entries))
            if pages == "first":
                return arrays[0]
        if not arrays:
            raise ValueError(f"{path}: no IFDs")
        return arrays[0] if len(arrays) == 1 else np.stack(arrays)


_DTYPE_SF = {"u": 1, "i": 2, "f": 3}


def imwrite(path: str, image: np.ndarray) -> None:
    """Write an uncompressed little-endian chunky TIFF."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, spp = img.shape
    img = np.ascontiguousarray(img.astype(img.dtype.newbyteorder("<")))
    bits = img.dtype.itemsize * 8
    sf = _DTYPE_SF[img.dtype.kind]
    photometric = 2 if (spp == 3 and img.dtype == np.uint8) else 1

    data_offset = 8
    data = img.tobytes()
    ifd_offset = data_offset + len(data)

    tags = []  # (tag, type, count, value_or_bytes)
    def tag_short(t, v): tags.append((t, 3, 1, struct.pack("<HH", v, 0)))
    def tag_long(t, v): tags.append((t, 4, 1, struct.pack("<I", v)))

    tag_long(256, w)
    tag_long(257, h)
    if spp == 1:
        tag_short(258, bits)
    else:
        tags.append((258, 3, spp, struct.pack("<" + "H" * spp, *([bits] * spp))))
    tag_short(259, 1)
    tag_short(262, photometric)
    tag_long(273, data_offset)
    tag_short(277, spp)
    tag_long(278, h)
    tag_long(279, len(data))
    tag_short(284, 1)
    tag_short(339, sf)
    if spp not in (1, 3):
        tags.append((338, 3, spp - (3 if photometric == 2 else 1),
                     struct.pack("<" + "H" * (spp - 1), *([0] * (spp - 1)))[:4].ljust(4, b"\0")))
    tags.sort(key=lambda x: x[0])

    # out-of-line values go after the IFD
    extra_offset = ifd_offset + 2 + 12 * len(tags) + 4
    extra = bytearray()
    entries = bytearray()
    for t, typ, cnt, payload in tags:
        if len(payload) <= 4:
            entries += struct.pack("<HHI", t, typ, cnt) + payload.ljust(4, b"\0")
        else:
            entries += struct.pack("<HHII", t, typ, cnt, extra_offset + len(extra))
            extra += payload

    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", ifd_offset))
        f.write(data)
        f.write(struct.pack("<H", len(tags)) + bytes(entries) + struct.pack("<I", 0))
        f.write(bytes(extra))
