"""PyTorch port: its TIFF codec against the JAX package's.

- the writer's files are byte-identical for every dtype the reader lists
  and 1, 2, 3 and 4 channels, and each reader reads the other's files;
- compressed files written by PIL (PackBits, LZW, Deflate) and TIFFs built
  by hand in this file (big endian, several strips, the horizontal
  predictor, separate planes, two pages, Deflate) decode to the same arrays
  through the port's pure-Python decoders and the JAX package's reader
  (which uses its C++ strip decoders where they are built);
- `make_dataset` writes byte-identical folders.
"""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from cell_image_analysis_tpu.io.tiff import imread as jax_imread
from cell_image_analysis_tpu.io.tiff import imwrite as jax_imwrite
from cell_image_analysis_tpu_torch.io.tiff import imread, imwrite

_DTYPES = ["uint8", "uint16", "uint32", "uint64", "int8", "int16", "int32", "int64",
           "float16", "float32", "float64"]


def _image(dtype: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(size=shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=shape, dtype=dt, endpoint=True)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_writer_bytes_and_round_trip_equal_jax(tmp_path, dtype, channels):
    shape = (17, 23) if channels == 1 else (17, 23, channels)
    img = _image(dtype, shape, seed=channels)
    a, b = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    imwrite(a, img)
    jax_imwrite(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for read in (imread, jax_imread):
        got = read(b)
        assert got.dtype == img.dtype and got.shape == img.shape
        assert got.tobytes() == img.tobytes()


@pytest.mark.parametrize("comp", ["packbits", "tiff_lzw", "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["rgb8", "gray16"])
def test_reads_pil_compressed_as_jax(tmp_path, comp, mode):
    rng = np.random.default_rng(3)
    if mode == "rgb8":
        img = (rng.uniform(size=(70, 90, 3)) * 255).astype(np.uint8)
        img[:, :30] = 7  # compressible region
        pil = Image.fromarray(img)
    else:
        img = (rng.uniform(size=(70, 90)) * 65535).astype(np.uint16)
        img[20:50] = 1234
        pil = Image.fromarray(img)
    p = str(tmp_path / f"{comp}.tif")
    pil.save(p, compression=comp)
    got = imread(p)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jax_imread(p))


def _pack(bo, fmt, *v):
    return struct.pack(bo + fmt, *v)


def _packbits(data: bytes) -> bytes:
    """Literal runs of at most 128 bytes, and a replicate run for each
    stretch of equal bytes from 3 up."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _build_tiff(pages, bo="<", compression=1, predictor=1, planar=1, rows_per_strip=None):
    """A baseline TIFF of the (H, W[, C]) pages, written by hand."""
    blob = bytearray(bo.replace("<", "II").replace(">", "MM").encode() + _pack(bo, "H", 42)
                     + _pack(bo, "I", 0))
    ifd_ptr_at = 4
    for page in pages:
        img = page if page.ndim == 3 else page[:, :, None]
        h, w, spp = img.shape
        dt = img.dtype.newbyteorder(bo)
        rps = rows_per_strip or h
        planes = [img[:, :, s:s + 1] for s in range(spp)] if planar == 2 else [img]
        offsets, counts = [], []
        for plane in planes:
            for r0 in range(0, h, rps):
                strip = plane[r0:r0 + rps].astype(dt)
                if predictor == 2:
                    d = strip.astype(np.int64)
                    d[:, 1:] -= d[:, :-1].copy()
                    strip = d.astype(dt)
                raw = strip.tobytes()
                if compression == 8:
                    raw = zlib.compress(raw)
                elif compression == 32773:
                    raw = _packbits(raw)
                offsets.append(len(blob))
                counts.append(len(raw))
                blob += raw
        tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [img.dtype.itemsize * 8] * spp),
                (259, 3, [compression]), (262, 3, [1]), (273, 4, offsets), (277, 3, [spp]),
                (278, 4, [rps]), (279, 4, counts), (284, 3, [planar]), (317, 3, [predictor]),
                (339, 3, [{"u": 1, "i": 2, "f": 3}[img.dtype.kind]] * spp)]
        extra, entries = bytearray(), bytearray()
        if len(blob) % 2:
            blob += b"\0"
        ifd_at = len(blob)
        extra_at = ifd_at + 2 + 12 * len(tags) + 4
        for tag, typ, vals in tags:
            payload = _pack(bo, ("H" if typ == 3 else "I") * len(vals), *vals)
            entries += _pack(bo, "HHI", tag, typ, len(vals))
            if len(payload) <= 4:
                entries += payload.ljust(4, b"\0")
            else:
                entries += _pack(bo, "I", extra_at + len(extra))
                extra += payload
        blob[ifd_ptr_at:ifd_ptr_at + 4] = _pack(bo, "I", ifd_at)
        blob += _pack(bo, "H", len(tags)) + entries
        ifd_ptr_at = len(blob)
        blob += _pack(bo, "I", 0) + extra
    return bytes(blob)


_HAND_CASES = {
    "big_endian_u16": dict(dtype="uint16", shape=(21, 30), bo=">"),
    "big_endian_f32_rgb": dict(dtype="float32", shape=(9, 14, 3), bo=">"),
    "strips_of_4_rows": dict(dtype="uint16", shape=(21, 30, 3), rows_per_strip=4),
    "deflate_strips": dict(dtype="int32", shape=(33, 12), compression=8, rows_per_strip=8),
    "deflate_predictor": dict(dtype="uint16", shape=(20, 31, 3), compression=8, predictor=2),
    "predictor_big_endian": dict(dtype="uint8", shape=(20, 31), bo=">", predictor=2),
    "separate_planes": dict(dtype="uint16", shape=(14, 19, 3), planar=2, rows_per_strip=5),
    "separate_planes_deflate_predictor": dict(dtype="uint8", shape=(14, 19, 3), planar=2,
                                              compression=8, predictor=2),
    "packbits_u8": dict(dtype="uint8", shape=(25, 40), compression=32773, runs=True),
    "packbits_u16_strips": dict(dtype="uint16", shape=(25, 40, 3), compression=32773,
                                rows_per_strip=6, runs=True),
    "float64": dict(dtype="float64", shape=(7, 9)),
    "int64_big_endian": dict(dtype="int64", shape=(7, 9, 2), bo=">"),
}


@pytest.mark.parametrize("case", sorted(_HAND_CASES))
def test_reads_hand_built_tiffs_as_jax(tmp_path, case):
    kw = dict(_HAND_CASES[case])
    img = _image(kw.pop("dtype"), kw.pop("shape"), seed=len(case))
    if kw.pop("runs", False):
        img[5:15] = img[5, 0]  # stretches of equal bytes
    p = str(tmp_path / "hand.tif")
    with open(p, "wb") as f:
        f.write(_build_tiff([img], **kw))
    got = imread(p)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    ref = jax_imread(p)
    assert ref.dtype == got.dtype
    np.testing.assert_array_equal(got, ref)


def test_pages_first_and_all(tmp_path):
    pages = [_image("uint16", (11, 13), seed=s) for s in (1, 2)]
    p = str(tmp_path / "pages.tif")
    with open(p, "wb") as f:
        f.write(_build_tiff(pages, compression=8))
    np.testing.assert_array_equal(imread(p), pages[0])
    np.testing.assert_array_equal(imread(p, pages="all"), np.stack(pages))
    np.testing.assert_array_equal(imread(p, pages="all"), jax_imread(p, pages="all"))


@pytest.mark.parametrize("payload", [b"hello world", b"II\x2b\x00\x08\x00\x00\x00"])
def test_rejects_non_tiff(tmp_path, payload):
    p = str(tmp_path / "bad.tif")
    with open(p, "wb") as f:
        f.write(payload)
    with pytest.raises(ValueError):
        imread(p)


def test_unsupported_compression_raises(tmp_path):
    p = str(tmp_path / "jpeg.tif")
    with open(p, "wb") as f:
        f.write(_build_tiff([_image("uint8", (8, 8))], compression=7))
    with pytest.raises(ValueError, match="unsupported TIFF compression 7"):
        imread(p)


@pytest.mark.parametrize("kw", [dict(n_frames=2, size=96, n_cells=3, seed=4),
                                dict(n_frames=3, size=128, n_cells=5, mutant_fraction=0.6,
                                     seed=9)])
def test_make_dataset_byte_identical(tmp_path, kw):
    from cell_image_analysis_tpu.utils.synthetic import make_dataset as jax_make
    from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

    a = make_dataset(str(tmp_path / "port"), **kw)
    b = jax_make(str(tmp_path / "jax"), **kw)
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
    assert len(a) == kw["n_frames"]
    for pa, pb in zip(a, b):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()
    frame = imread(a[0])
    assert frame.dtype == np.uint16 and frame.shape == (kw["size"], kw["size"], 3)
