"""PyTorch port: the C++ TIFF strip decoders (`native/tiff_codec.cpp`).

- PackBits and LZW strips of TIFFs written by PIL (8-bit RGB, 16-bit gray,
  one and several strips, random data that fills the LZW table and
  resets it): `io.tiff.native_decode` gives the bytes of the port's Python
  decoders, byte for byte, and `imread` the arrays of the JAX package's
  reader and of PIL;
- random PackBits streams, truncated ones included, and truncated LZW
  strips: the same bytes as the Python decoders;
- a malformed LZW strip raises (ValueError; the Python decoder's table
  lookup raises IndexError), in `imread` too;
- the library is built by g++ into `build/host_native/`, once, and the
  build raises where there is no compiler.
"""

import struct

import numpy as np
import pytest
from PIL import Image

from cell_image_analysis_tpu.io.tiff import imread as jax_imread
from cell_image_analysis_tpu_torch.io import tiff
from cell_image_analysis_tpu_torch.ops.cuda import _build

_PYTHON = {"lzw_decode": tiff._lzw_decode, "packbits_decode": tiff._unpackbits}
_COMPRESSION = {"tiff_lzw": (5, "lzw_decode"), "packbits": (32773, "packbits_decode")}


def _pil_tiff(path, img: np.ndarray, comp: str, rows_per_strip=None) -> None:
    kw = {"compression": comp}
    if rows_per_strip:
        kw["tiffinfo"] = {278: rows_per_strip}
    Image.fromarray(img).save(path, **kw)


def _strips(path):
    """(raw strip bytes, expected decoded size) of the first page."""
    with open(path, "rb") as f:
        bo = "<" if f.read(2) == b"II" else ">"
        f.seek(4)
        (ifd,) = struct.unpack(bo + "I", f.read(4))
        e, _ = tiff._read_ifd_entries(f, bo, ifd)
        width, height = e[256][0], e[257][0]
        row = width * e.get(277, (1,))[0] * (e.get(258, (8,))[0] // 8)
        rps = e.get(278, (height,))[0]
        out = []
        for k, (off, cnt) in enumerate(zip(e[273], e[279])):
            f.seek(off)
            out.append((f.read(cnt), min(rps, height - k * rps) * row))
    return out


def _images():
    rng = np.random.default_rng(3)
    rgb = (rng.uniform(size=(70, 90, 3)) * 255).astype(np.uint8)
    rgb[:, :30] = 7
    gray = (rng.uniform(size=(64, 80)) * 65535).astype(np.uint16)
    gray[10:40] = 1000
    noise = rng.integers(0, 256, size=(200, 300), dtype=np.uint8)   # fills the LZW table
    return {"rgb8": rgb, "gray16": gray, "noise8": noise}


@pytest.mark.parametrize("comp", sorted(_COMPRESSION))
@pytest.mark.parametrize("name", ["rgb8", "gray16", "noise8"])
@pytest.mark.parametrize("rows_per_strip", [None, 16])
def test_native_strips_equal_python_and_jax(tmp_path, comp, name, rows_per_strip):
    img = _images()[name]
    path = str(tmp_path / "x.tif")
    _pil_tiff(path, img, comp, rows_per_strip)
    code, fn = _COMPRESSION[comp]
    strips = _strips(path)
    if rows_per_strip:
        assert len(strips) > 1
    for raw, expected in strips:
        got = tiff.native_decode(fn, raw, expected)
        assert got == _PYTHON[fn](raw, expected)
        assert len(got) >= expected
        assert tiff._decompress(raw, code, expected) == got
    got = tiff.imread(path)
    ref = jax_imread(path)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    assert got.tobytes() == np.asarray(Image.open(path)).tobytes()


@pytest.mark.parametrize("seed", range(6))
def test_random_packbits_streams_equal_python(seed):
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(rng.integers(1, 60)):
        n = int(rng.integers(0, 256))
        parts.append(bytes([n]))
        if n < 128:
            parts.append(rng.integers(0, 256, n + 1, dtype=np.uint8).tobytes())
        elif n > 128:
            parts.append(bytes([int(rng.integers(0, 256))]))
    data = b"".join(parts)
    for cut in (len(data), len(data) - 1, len(data) // 2, 1):
        for expected in (10, 500, 5000):
            raw = data[:cut]
            assert tiff.native_decode("packbits_decode", raw, expected) == \
                tiff._unpackbits(raw, expected)


def test_truncated_lzw_strip_gives_the_python_bytes(tmp_path):
    path = str(tmp_path / "x.tif")
    _pil_tiff(path, _images()["noise8"], "tiff_lzw")
    (raw, expected), = _strips(path)
    for cut in (1, 2, 100, len(raw) // 3, len(raw) // 2):
        got = tiff.native_decode("lzw_decode", raw[:cut], expected)
        assert got == tiff._lzw_decode(raw[:cut], expected)
        assert len(got) < expected


def _bits(codes, width=9) -> bytes:
    v = 0
    for c in codes:
        v = (v << width) | c
    n = len(codes) * width
    v <<= (-n) % 8
    return v.to_bytes((n + 7) // 8, "big")


def test_malformed_lzw_strip_raises(tmp_path):
    bad = _bits([256, 300, 257])         # CLEAR, then a code the table does not hold
    with pytest.raises(ValueError, match="malformed LZW"):
        tiff.native_decode("lzw_decode", bad, 64)
    with pytest.raises(IndexError):
        tiff._lzw_decode(bad, 64)
    good = _bits([256, 65, 66, 258, 257])
    assert tiff.native_decode("lzw_decode", good, 4) == tiff._lzw_decode(good, 4) == b"ABAB"

    path = str(tmp_path / "x.tif")
    _pil_tiff(path, _images()["rgb8"], "tiff_lzw")
    (raw, _), = _strips(path)
    data = bytearray(open(path, "rb").read())
    at = bytes(data).index(raw)
    data[at:at + len(bad)] = bad
    broken = str(tmp_path / "broken.tif")
    with open(broken, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="malformed LZW"):
        tiff.imread(broken)


def test_codec_is_built_once_into_the_build_dir():
    tiff.codec()
    path = tiff.codec()._name
    assert "/build/host_native/libcia_tiff_codec_" in path.replace("\\", "/")
    assert tiff.codec() is tiff.codec()


def test_codec_build_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(tiff, "_CODEC", None)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "no-such-compiler-anywhere")
    with pytest.raises(RuntimeError, match="compiler"):
        tiff.native_decode("packbits_decode", b"\x00A", 1)
