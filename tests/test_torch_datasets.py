"""The port's image, YAML and dataset readers against what the JAX package
reads with (imageio / Pillow, PyYAML, cv2) and against its loaders.

Tolerances: PNG, JPEG (against Pillow's libjpeg-turbo decode), YAML, the
tree functions and INTER_NEAREST are exact.  INTER_LINEAR holds to 1e-9 on
0-255 values: the port sums the same float64 terms as cv2, in another
order.  The Replica items are exact: the colour is Pillow's decode to the
bit and 1200x680 -> 1200x680 (or 64x48 -> 64x48) is a copy.
"""
import glob
import os
import struct
import sys
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from fabricate import REPLICA_TREE_JSON, fabricate_replica, fabricate_scannet, make_scene_images
from hierslam_torch.datasets import base as tbase
from hierslam_torch.datasets import get_dataset as t_get_dataset
from hierslam_torch.datasets import tree as ttree
from hierslam_torch.utils import image_io as iio
from hierslam_tpu.datasets import base as jbase
from hierslam_tpu.datasets import get_dataset as j_get_dataset
from hierslam_tpu.datasets import tree as jtree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _filtered_png(path, img, filters):
    """Write ``img`` as PNG with row r filtered by ``filters[r % len]``."""
    img = np.asarray(img)
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 * img.dtype.itemsize
    H = img.shape[0]
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1).view(np.uint8)
    rows = rows.astype(np.int64)
    bpp = ch * depth // 8
    out = []
    for r in range(H):
        x = rows[r]
        prior = rows[r - 1] if r else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        f = filters[r % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (a + prior) // 2
        else:
            p = a + prior - c
            pa, pb, pc = abs(p - a), abs(p - prior), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], H, depth, ctype, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_matches_imageio(tmp_path, dtype, channels):
    rng = np.random.default_rng(channels)
    shape = (13, 11) if channels == 1 else (13, 11, channels)
    img = rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)
    # smooth ramps as well, where Paeth and Average pick other neighbours
    img[:6] = (np.arange(11)[None] * 7 + np.arange(6)[:, None] * 3).reshape(
        (6, 11) + (1,) * (img.ndim - 2)).astype(dtype)
    for filters in ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0]):
        path = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        _filtered_png(path, img, filters)
        got = iio.read_png(path)
        assert got.dtype == img.dtype and np.array_equal(got, img), filters
        ref = imageio.imread(path)
        if dtype == np.uint16 and channels > 1:   # Pillow keeps 8 bits of 16-bit colour
            assert np.array_equal(ref, (got >> 8).astype(np.uint8))
        else:
            assert np.array_equal(got, ref), filters
    iio.write_png(str(tmp_path / "w.png"), img)
    assert np.array_equal(iio.read_png(str(tmp_path / "w.png")), img)


def test_read_png_real_files_and_refusals(tmp_path):
    d16 = (np.random.default_rng(0).uniform(0, 6, (48, 64)) * 6553.5).astype(np.uint16)
    imageio.imwrite(str(tmp_path / "d.png"), d16)              # Pillow's own filters
    assert np.array_equal(iio.read_png(str(tmp_path / "d.png")), d16)
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(str(tmp_path / "p.png"))
    with pytest.raises(ValueError, match="p.png.*palette"):
        iio.read_png(str(tmp_path / "p.png"))
    _filtered_png(str(tmp_path / "i.png"), d16[:8, :8].astype(np.uint8), [0])
    data = bytearray(open(str(tmp_path / "i.png"), "rb").read())
    data[28] = 1                        # the IHDR's interlace method: Adam7
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    open(str(tmp_path / "i.png"), "wb").write(bytes(data))
    with pytest.raises(ValueError, match="i.png: interlaced"):
        iio.read_png(str(tmp_path / "i.png"))


def _pillow_jpeg(path, img, **kw):
    Image.fromarray(img).save(path, **kw)
    return np.asarray(Image.open(path))


def test_read_jpeg_bit_equal_to_pillow(tmp_path):
    rng = np.random.default_rng(0)
    cases = [(c, dict(quality=95)) for c, _, _, _ in make_scene_images(4)]     # fabricate's
    cases += [
        (rng.integers(0, 256, (48, 64, 3)).astype(np.uint8), dict(quality=95)),
        (rng.integers(0, 256, (47, 61, 3)).astype(np.uint8), dict(quality=90, subsampling=0)),
        (rng.integers(0, 256, (47, 63, 3)).astype(np.uint8), dict(quality=90, subsampling=1)),
        (rng.integers(0, 256, (37, 45)).astype(np.uint8), dict(quality=80)),
        (rng.integers(0, 256, (48, 64, 3)).astype(np.uint8),
         dict(quality=95, restart_marker_blocks=3)),
    ]
    for i, (img, kw) in enumerate(cases):
        path = str(tmp_path / f"{i}.jpg")
        ref = _pillow_jpeg(path, img, **kw)
        if "restart_marker_blocks" in kw:
            assert b"\xff\xdd" in open(path, "rb").read()      # the file has a DRI
        assert np.array_equal(iio.read_jpeg(path), ref), kw
    _pillow_jpeg(str(tmp_path / "p.jpg"), cases[0][0], progressive=True)
    with pytest.raises(ValueError, match="p.jpg: progressive"):
        iio.read_jpeg(str(tmp_path / "p.jpg"))


def _room_frame():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import procedural_room

    return procedural_room.render_frame(0, 1200, 680, 600.0, 600.0, 599.5, 339.5, 200)[0]


def test_jpeg_full_frame_and_writer(tmp_path):
    frame = _room_frame()
    path = str(tmp_path / "room.jpg")
    imageio.imwrite(path, frame, quality=95)
    ref = imageio.imread(path)
    assert np.array_equal(iio.read_jpeg(path), ref)

    def psnr(a):
        return 10 * np.log10(255.0**2 / np.mean((a.astype(float) - frame.astype(float)) ** 2))

    mine = str(tmp_path / "mine.jpg")
    iio.write_jpeg(mine, frame, 95)
    back = np.asarray(Image.open(mine))
    assert psnr(back) >= psnr(ref) - 1.0, (psnr(back), psnr(ref))
    assert np.array_equal(iio.read_jpeg(mine), back)


def test_jpeg_writer_tables_are_libjpegs(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (16, 16, 3)).astype(np.uint8)
    for q in (50, 75, 95):
        Image.fromarray(img).save(str(tmp_path / "a.jpg"), quality=q)
        data = open(str(tmp_path / "a.jpg"), "rb").read()
        for t in iio.quality_tables(q):
            assert bytes(t[iio.ZIGZAG].astype(np.uint8)) in data
    for counts, syms in iio.STD_HUFFMAN.values():
        assert bytes(counts) + bytes(syms) in data


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "data",
                                                               "*.yaml"))),
                         ids=os.path.basename)
def test_load_dataset_config_matches(path):
    assert tbase.load_dataset_config(path) == jbase.load_dataset_config(path)


def test_yaml_inherit_and_scalars(tmp_path):
    (tmp_path / "base.yaml").write_text(
        "a: 1\nb:\n  c: 'x' # comment\n  d: [1, 2.5, \"s\"]\nn: ~\nt: true\nf: -1.5e+3\n")
    (tmp_path / "child.yaml").write_text(
        f"inherit_from: {tmp_path / 'base.yaml'}\nb:\n  c: y\n  e:\n")
    import yaml

    for name in ("base.yaml", "child.yaml"):
        p = str(tmp_path / name)
        assert tbase.load_dataset_config(p) == jbase.load_dataset_config(p)
    assert yaml.full_load(open(tmp_path / "base.yaml")) == iio.load_yaml(str(tmp_path / "base.yaml"))


@pytest.mark.parametrize("size", [(64, 48), (32, 24), (50, 37), (100, 70), (31, 23)])
@pytest.mark.parametrize("shape", [(48, 64, 3), (48, 64), (47, 63, 3)])
def test_resize_matches_cv2(size, shape):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, shape).astype(float)
    got = tbase.resize(img, *size, nearest=False)
    np.testing.assert_allclose(got, cv2.resize(img, size, interpolation=cv2.INTER_LINEAR),
                               rtol=0, atol=1e-9)
    assert np.array_equal(tbase.resize(img, *size, nearest=True),
                          cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))
    lab = rng.integers(0, 200, shape[:2]).astype(np.uint8)
    assert np.array_equal(tbase.resize(lab, *size, nearest=True),
                          cv2.resize(lab, size, interpolation=cv2.INTER_NEAREST))


def test_tree_functions_match(tmp_path):
    basedir, seq, _ = fabricate_replica(str(tmp_path / "r"), n_frames=1, semantic=True)
    path = os.path.join(basedir, seq, "info_semantic_tree.json")
    for lv in (2, 5):
        a, b = ttree.load_replica_tree(path, lv), jtree.load_replica_tree(path, lv)
        assert a == b
    assert ttree.read_tree_annotation(REPLICA_TREE_JSON, 2) == jtree.read_tree_annotation(
        REPLICA_TREE_JSON, 2)
    mapping = ttree.load_replica_tree(path, 2)[0]
    lab = np.random.default_rng(0).integers(0, 6, (12, 9))
    stack = ttree.remap_levels(lab, mapping, 2)
    assert np.array_equal(stack, jtree.remap_levels(lab, mapping, 2))
    assert np.array_equal(ttree.tree_onehot(stack, [2, 4, 4]), jtree.tree_onehot(stack, [2, 4, 4]))
    assert np.array_equal(ttree.flat_onehot(lab, 6), jtree.flat_onehot(lab, 6))
    assert np.array_equal(ttree.label_colormap(300), jtree.label_colormap(300))
    root = str(tmp_path / "s")
    fabricate_scannet(root, n_frames=1, semantic=True)
    raw = os.path.join(root, "scannetv2-labels.combined.tsv")
    assert ttree.load_scannet_raw_to_nyu40(raw) == jtree.load_scannet_raw_to_nyu40(raw)
    for name, lv, key in (("tree", 4, "nyu40"), ("tree-large", 5, "raw")):
        p = os.path.join(root, f"scannetv2-labels.combined.{name}.tsv")
        assert ttree.load_scannet_tree(p, lv, key) == jtree.load_scannet_tree(p, lv, key)


def _loader_kwargs(basedir, seq, cam, H, W):
    cfg = dict(cam, sem_mode="tree", num_tree_level=2)
    return dict(config_dict=cfg, basedir=basedir, sequence=seq, start=0, end=-1, stride=1,
                desired_height=H, desired_width=W, relative_pose=True)


@pytest.mark.parametrize("semantic", [True, False])
def test_replica_loader_matches(tmp_path, semantic):
    basedir, seq, cam = fabricate_replica(str(tmp_path / "d"), n_frames=4, semantic=semantic)
    kw = _loader_kwargs(basedir, seq, cam, 48, 64)
    t, j = t_get_dataset(**kw), j_get_dataset(**kw)
    assert len(t) == len(j) == 4
    if semantic:
        assert t.num_semantic == j.num_semantic == [2, 4, 4]
        assert t.num_semantic_class == j.num_semantic_class
        assert t.label_mapping_tree == j.label_mapping_tree
        assert np.array_equal(t.colors_map_all, j.colors_map_all)
    for i in range(len(t)):
        a, b = t[i], j[i]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_replica_loader_resized_and_strided(tmp_path):
    basedir, seq, cam = fabricate_replica(str(tmp_path / "d"), n_frames=5, semantic=True)
    kw = _loader_kwargs(basedir, seq, cam, 24, 32)
    kw.update(start=1, stride=2)
    t, j = t_get_dataset(**kw), j_get_dataset(**kw)
    assert len(t) == len(j) == 2
    for i in range(2):
        a, b = t[i], j[i]
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-4)   # float32 of cv2's sum
        for x, y in zip(a[1:], b[1:]):
            assert np.array_equal(x, y)


def test_unported_loaders_say_so(tmp_path):
    for name in ("scannet", "tum", "icl"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            t_get_dataset({"dataset_name": name}, str(tmp_path), "x")
    cfg = tbase.load_dataset_config(os.path.join(ROOT, "configs", "data", "tum.yaml"))
    cfg["dataset_name"] = "replica"
    with pytest.raises(NotImplementedError, match="distortion"):
        t_get_dataset(cfg, str(tmp_path), "x")
