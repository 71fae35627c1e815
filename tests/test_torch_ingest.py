"""PyTorch port: `io/ingest` against the JAX package's on the same folder:
the sorted listing, the channel split, `FrameStream`'s order, its arrays,
its prefetch bound and its error list."""

import os
import threading

import numpy as np
import pytest

from cell_image_analysis_tpu.io import ingest as jax_ingest
from cell_image_analysis_tpu_torch.io import ingest
from cell_image_analysis_tpu_torch.io.tiff import imwrite


def _folder(tmp_path, n=7, shape=(24, 32, 3)):
    rng = np.random.default_rng(1)
    folder = str(tmp_path / "frames")
    os.makedirs(folder)
    frames = {}
    for i in rng.permutation(n):
        name = f"frame_{i:03d}.tif"
        frames[name] = rng.integers(0, 65535, size=shape).astype(np.uint16)
        imwrite(os.path.join(folder, name), frames[name])
    with open(os.path.join(folder, "notes.txt"), "w") as f:
        f.write("not a frame")
    return folder, frames


def test_list_tiffs_sorted_as_jax(tmp_path):
    folder, frames = _folder(tmp_path)
    got = ingest.list_tiffs(folder)
    assert got == jax_ingest.list_tiffs(folder)
    assert [os.path.basename(p) for p in got] == sorted(frames)
    assert ingest.list_tiffs(str(tmp_path / "missing")) == []


@pytest.mark.parametrize("shape", [(8, 9), (8, 9, 1), (8, 9, 2), (8, 9, 3), (8, 9, 4)])
def test_split_channels_as_jax(shape):
    img = np.random.default_rng(2).integers(0, 255, size=shape).astype(np.uint8)
    seg, green = ingest.split_channels(img)
    ref_seg, ref_green = jax_ingest.split_channels(img)
    np.testing.assert_array_equal(seg, ref_seg)
    np.testing.assert_array_equal(green, ref_green)
    if len(shape) == 3 and shape[-1] >= 3:
        np.testing.assert_array_equal(seg, img[..., 2])
        np.testing.assert_array_equal(green, img[..., 1])
    else:
        assert seg is img and green is img


@pytest.mark.parametrize("n_workers,prefetch", [(1, 1), (2, 4), (4, 2)])
def test_frame_stream_order_and_arrays_as_jax(tmp_path, n_workers, prefetch):
    folder, frames = _folder(tmp_path)
    paths = ingest.list_tiffs(folder)
    got = list(ingest.FrameStream(paths, n_workers=n_workers, prefetch=prefetch))
    ref = list(jax_ingest.FrameStream(paths, n_workers=n_workers, prefetch=prefetch))
    assert [g[0] for g in got] == [r[0] for r in ref] == paths
    for (path, seg, green), (_, ref_seg, ref_green) in zip(got, ref):
        frame = frames[os.path.basename(path)]
        np.testing.assert_array_equal(seg, frame[..., 2])
        np.testing.assert_array_equal(green, frame[..., 1])
        np.testing.assert_array_equal(seg, ref_seg)
        np.testing.assert_array_equal(green, ref_green)


def test_frame_stream_skips_and_lists_bad_files(tmp_path):
    folder, _ = _folder(tmp_path, n=4)
    with open(os.path.join(folder, "corrupt.tif"), "wb") as f:
        f.write(b"not a tiff at all")
    with open(os.path.join(folder, "frame_001b_truncated.tif"), "wb") as f:
        f.write(b"II*\0\x08\0\0\0")
    paths = ingest.list_tiffs(folder)
    stream, ref = ingest.FrameStream(paths), jax_ingest.FrameStream(paths)
    got, want = list(stream), list(ref)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert len(got) == 4
    assert sorted(os.path.basename(p) for p, _ in stream.errors) == [
        "corrupt.tif", "frame_001b_truncated.tif"]
    assert sorted(stream.errors) == sorted(ref.errors)
    assert stream.decode_seconds > 0.0


def test_frame_stream_prefetch_is_bounded_and_empty_is_empty():
    assert list(ingest.FrameStream([])) == []
    lock, state = threading.Lock(), dict(read=0, taken=0, ahead=0)

    def reader(path):
        with lock:
            state["read"] += 1
            state["ahead"] = max(state["ahead"], state["read"] - state["taken"])
        return np.zeros((4, 4), np.uint8)

    stream = ingest.FrameStream([f"f{i}" for i in range(12)], n_workers=3, prefetch=2,
                                reader=reader)
    for _ in stream:
        with lock:
            state["taken"] += 1
    assert state["read"] == 12 and state["taken"] == 12
    # frames decoded but not yet taken never exceed the budget (+1: the
    # consumer frees a slot before it counts the frame as taken)
    assert state["ahead"] <= 2 + 1
