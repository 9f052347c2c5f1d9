"""The port's data layer against the JAX package's on the CPU: list-file
parsing, the native PNG codec (which the port builds from
native/mspl_io.cc itself) against `mspl_tpu.data.native_io`, the file-list
data sets (Cityscapes `raw_ids`, RGB-D greenhouse, `build_dataset`, the
decode cache), the label PNG writer and reader, `colorize_label`, and the
eval transforms and resizes."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data import datasets as jax_ds
from mspl_tpu.data import label_io as jax_label_io
from mspl_tpu.data import native_io as jax_native
from mspl_tpu.data import transforms as jax_tf
from mspl_tpu.data.label_space import convert_label_map as jax_convert
from mspl_tpu.ops import resize as jax_resize
from mspl_tpu_torch.data import datasets as port_ds
from mspl_tpu_torch.data import label_io, native_io
from mspl_tpu_torch.data import transforms as port_tf
from mspl_tpu_torch.data.label_space import convert_label_map
from mspl_tpu_torch.ops import resize as port_resize

pytestmark = pytest.mark.skipif(
    not (native_io.available() and jax_native.available()),
    reason="needs g++ and zlib to build the native codec")


def _write_set(root, n=5, size_hw=(24, 32), classes=19, depth=False,
               seed=0):
    """PNG images, labels (and depth maps) under `root`, written by the
    port; returns the file names."""
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        img = rng.integers(0, 256, (*size_hw, 3), dtype=np.uint8)
        lab = rng.integers(0, classes, size_hw).astype(np.uint8)
        lab[rng.random(size_hw) < 0.1] = 255
        native_io.encode_png(os.path.join(root, f"img_{i}.png"), img)
        label_io.save_label_png(lab, os.path.join(root, f"lab_{i}.png"))
        row = [f"img_{i}.png"]
        if depth:
            native_io.encode_png(os.path.join(root, f"dep_{i}.png"),
                                 rng.integers(0, 256, size_hw,
                                              dtype=np.uint8))
            row.append(f"dep_{i}.png")
        names.append(row + [f"lab_{i}.png"])
    return names


def test_list_parsing_matches_jax(tmp_path):
    """Relative and absolute paths, comma and whitespace separators,
    comments, blank lines and image-only lines parse as the reference."""
    lines = ["# a comment", "", "a.png b.png", "c.png,d.png",
             f"{tmp_path}/e.png   {tmp_path}/f.png", "g.png",
             "  h.png\tsub/i.png  "]
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(lines) + "\n")
    got = port_ds._read_list_file("root", str(lst))
    assert got == jax_ds._read_list_file("root", str(lst))
    assert got[1] == ("root/c.png", "root/d.png")
    assert got[2] == (f"{tmp_path}/e.png", f"{tmp_path}/f.png")
    assert got[3] == ("root/g.png", None)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("bilinear", [True, False],
                         ids=["bilinear", "nearest"])
def test_native_codec_matches_jax(tmp_path, channels, bilinear):
    """The port's encoder writes the JAX encoder's bytes, and both
    decoders (one file and a batch) give the same pixels at the file's
    size and resized up and down."""
    rng = np.random.default_rng(channels + 2 * bilinear)
    shape = (19, 23) if channels == 1 else (19, 23, 3)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    mine, ref = str(tmp_path / "mine.png"), str(tmp_path / "ref.png")
    native_io.encode_png(mine, img)
    jax_native.encode_png(ref, img)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    for size in ((19, 23), (40, 31), (8, 11)):
        got = native_io.decode_png(mine, size, channels, bilinear)
        np.testing.assert_array_equal(
            got, jax_native.decode_png(mine, size, channels, bilinear))
        if size == (19, 23):
            np.testing.assert_array_equal(got, img)
        batch = native_io.decode_png_batch([mine, ref, mine], size,
                                           channels, bilinear)
        np.testing.assert_array_equal(batch, jax_native.decode_png_batch(
            [mine, ref, mine], size, channels, bilinear))


def test_native_library_is_built_into_the_port(tmp_path):
    """The port loads its own build of native/mspl_io.cc from
    mspl_tpu_torch/_build/, named by the source's hash, never the tracked
    binary native/build/libmspl_io.so."""
    path = native_io.lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "mspl_tpu_torch"
    assert native_io._lib._name == str(path)


def test_save_label_png_decodes_alike_in_both_packages(tmp_path):
    """The repaired `save_label_png` writes through the native encoder
    (the reference's bytes), and the label PNG reads back as the same
    labels through the port's reader and the JAX package's (PIL)."""
    rng = np.random.default_rng(5)
    lab = rng.integers(0, 3, (21, 34)).astype(np.int32)
    lab[rng.random(lab.shape) < 0.2] = 255
    mine, ref = str(tmp_path / "mine.png"), str(tmp_path / "ref.png")
    label_io.save_label_png(lab, mine)
    jax_label_io.save_label_png(lab, ref)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    for read in (label_io.load_label_png, jax_label_io.load_label_png):
        got = read(mine)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, lab.astype(np.uint8))


def test_colorize_and_palette_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    lab = rng.integers(0, 3, (9, 13)).astype(np.uint8)
    lab[0, :4] = 255
    np.testing.assert_array_equal(label_io.colorize_label(lab),
                                  jax_label_io.colorize_label(lab))
    pal = rng.integers(0, 256, (5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        label_io.colorize_label(lab, pal, (9, 9, 9)),
        jax_label_io.colorize_label(lab, pal, (9, 9, 9)))
    mine, ref = str(tmp_path / "m.png"), str(tmp_path / "r.png")
    label_io.save_colorized_png(lab, mine)
    jax_label_io.save_colorized_png(lab, ref)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    np.testing.assert_array_equal(convert_label_map(lab, "forest"),
                                  jax_convert(lab, "forest"))


def _same_samples(a, b, indices):
    for i in indices:
        for x, y in zip(a.load(i), b.load(i)):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(a.load_batch(np.asarray(indices)),
                    b.load_batch(np.asarray(indices))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["camvid", "cityscapes", "forest",
                                  "greenhouse"])
def test_build_dataset_matches_jax(tmp_path, name):
    """`build_dataset` at a size other than the files' (bilinear images,
    nearest labels): samples one by one and as a batch, `shape_hw`,
    `num_classes` and `channels` as the reference's."""
    rows = _write_set(str(tmp_path))
    (tmp_path / "list.txt").write_text(
        "".join(" ".join(r) + "\n" for r in rows))
    args = (name, str(tmp_path), str(tmp_path / "list.txt"))
    a = port_ds.build_dataset(*args, size_wh=(40, 30))
    b = jax_ds.build_dataset(*args, size_wh=(40, 30))
    assert (len(a), a.shape_hw, a.num_classes, a.channels) == (
        len(b), b.shape_hw, b.num_classes, b.channels)
    _same_samples(a, b, [0, 3, 1])


def test_cityscapes_raw_ids_and_decode_cache(tmp_path):
    """Stock labelIds PNGs map to train ids (unmapped ids -> 255) as the
    reference maps them; the decode cache serves the same arrays."""
    rows = _write_set(str(tmp_path), classes=34, seed=1)
    (tmp_path / "list.txt").write_text(
        "".join(" ".join(r) + "\n" for r in rows))
    args = (str(tmp_path), str(tmp_path / "list.txt"), (32, 24))
    a = port_ds.CityscapesSegmentation(*args, raw_ids=True)
    b = jax_ds.CityscapesSegmentation(*args, raw_ids=True)
    _same_samples(a, b, [0, 1, 2, 3, 4])
    raw = label_io.load_label_png(str(tmp_path / "lab_0.png"))
    _, lab = a.load(0)
    np.testing.assert_array_equal(lab[raw == 7], 0)
    np.testing.assert_array_equal(lab[raw == 0], 255)
    a.enable_cache(1 << 20)
    first = a.load_batch(np.asarray([2, 0]))
    again = a.load_batch(np.asarray([0, 2]))
    np.testing.assert_array_equal(first[0][::-1], again[0])
    assert a._cache_used == 2 * (24 * 32 * 4)


def test_greenhouse_rgbd_matches_jax(tmp_path):
    """`GreenhouseRGBD(use_depth=True)`: 'rgb depth [label]' lines, a
    4-channel image whose last channel is the depth map, unlabeled lines
    all ignore, through `build_dataset` too."""
    rows = _write_set(str(tmp_path), classes=3, depth=True, seed=2)
    rows[1] = rows[1][:2]  # no label
    (tmp_path / "list.txt").write_text(
        "".join(" ".join(r) + "\n" for r in rows))
    args = (str(tmp_path), str(tmp_path / "list.txt"), (32, 24))
    a = port_ds.GreenhouseRGBD(*args, use_depth=True)
    b = jax_ds.GreenhouseRGBD(*args, use_depth=True)
    assert a.channels == 4
    _same_samples(a, b, [0, 1, 4])
    img, lab = a.load(1)
    assert img.shape == (24, 32, 4) and (lab == 255).all()
    c = port_ds.build_dataset("greenhouse", *args[:2], size_wh=(32, 24),
                              use_depth=True)
    _same_samples(a, c, [2])
    with pytest.raises(ValueError, match="greenhouse"):
        port_ds.build_dataset("camvid", *args[:2], use_depth=True)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_eval_transforms_match_jax(dtype):
    """`eval_transform` (normalize, then the half-pixel bilinear resize) in
    NCHW against the JAX NHWC one, and `eval_label_transform`."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, 24, 40, 3)).astype(dtype)
    got = port_tf.eval_transform(torch.from_numpy(imgs), (17, 29))
    want = np.asarray(jax_tf.eval_transform(jnp.asarray(imgs), (17, 29)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    labels = rng.integers(0, 5, (2, 24, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        port_tf.eval_label_transform(torch.from_numpy(labels),
                                     (17, 61)).numpy(),
        np.asarray(jax_tf.eval_label_transform(jnp.asarray(labels),
                                               (17, 61))))


@pytest.mark.parametrize("align_corners", [True, False])
def test_new_resizes_match_jax(align_corners):
    """`resize_bilinear_cm` and `resize_bilinear_to_cm` (f32, within 1e-6
    relative of the largest value) and `resize_nearest` (exact) against
    the JAX package's."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 13, 21)).astype(np.float32)
    for size in ((26, 42), (7, 9), (13, 30)):
        got = port_resize.resize_bilinear_cm(torch.from_numpy(x), size,
                                             align_corners)
        want = jax_resize.resize_bilinear_cm(jnp.asarray(x), size,
                                             align_corners)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6 * np.abs(x).max())
        nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        got = port_resize.resize_bilinear_to_cm(torch.from_numpy(nhwc),
                                                size, align_corners)
        want = jax_resize.resize_bilinear_to_cm(jnp.asarray(nhwc), size,
                                                align_corners)
        assert got.shape == (2, 5, *size) and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6 * np.abs(x).max())
        lab = rng.integers(0, 9, (3, 13, 21)).astype(np.int32)
        np.testing.assert_array_equal(
            port_resize.resize_nearest(torch.from_numpy(lab), size).numpy(),
            np.asarray(jax_resize.resize_nearest(jnp.asarray(lab), size)))
        np.testing.assert_array_equal(
            port_resize.resize_nearest(torch.from_numpy(x), size).numpy(),
            np.asarray(jax_resize.resize_nearest(
                jnp.asarray(nhwc), size)).transpose(0, 3, 1, 2))


def test_classification_list_matches_jax(tmp_path):
    """`image_path class_id` lines (relative and absolute paths, a blank
    line; the list named relative to the root) read as the JAX package's
    `ClassificationListDataset`: the pairs, `num_classes` (1 + the largest
    class), `shape_hw`, and each image resized to 40x30 with its int32
    class, byte for byte."""
    rng = np.random.default_rng(5)
    lines = []
    for i, cls in enumerate([3, 0, 7, 3]):
        name = f"c_{i}.png"
        native_io.encode_png(str(tmp_path / name),
                             rng.integers(0, 256, (24, 32, 3), np.uint8))
        lines.append(f"{tmp_path / name if i == 2 else name} {cls}")
    (tmp_path / "cls.txt").write_text("\n".join(lines[:2] + [""]
                                                + lines[2:]) + "\n")
    got = port_ds.ClassificationListDataset(str(tmp_path), "cls.txt",
                                            size_wh=(40, 30))
    want = jax_ds.ClassificationListDataset(str(tmp_path), "cls.txt",
                                            size_wh=(40, 30))
    assert got.pairs == want.pairs and len(got) == len(want) == 4
    assert got.num_classes == want.num_classes == 8
    assert got.shape_hw == want.shape_hw == (30, 40)
    for i in range(4):
        (gi, gc), (wi, wc) = got.load(i), want.load(i)
        assert gi.shape == (30, 40, 3) and gi.dtype == np.uint8
        assert gi.tobytes() == wi.tobytes()
        assert gc.dtype == np.int32 and gc == wc
