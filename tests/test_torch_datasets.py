"""Port: the image-folder datasets (hesic_tpu_torch/datasets), their PNG
reader and resize (datasets/image_io.py, no PIL), and the homography
network (geometry/net.py) against the JAX package's.

Tolerances: the PNG reader's bytes equal PIL's decode; the 256-resize
equals PIL's BILINEAR bytes (image_io reproduces Pillow's fixed-point
resample), so with one seeded RandomState the crops, corners, patches,
delta_gt and batches equal the JAX package's (tolerance 0); the synthetic
dataset's warped img_b within SYN_ATOL of JAX's warp: the inverse and the
sampling coordinates round differently in float32 (a sound run read
2.5e-4, i.e. ~6e-5 px on noise images whose normalised gray changes by up
to ~4.4 between neighbours);
the homography net carried from JAX: delta and get_h within 1e-5 (eval),
photometric_loss and its gradients within 1e-5.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

import hesic_tpu.datasets as jds
from hesic_tpu.geometry import HomographyNet as JHomographyNet
from hesic_tpu.geometry import photometric_loss as j_photometric_loss
from hesic_tpu_torch import datasets as tds
from hesic_tpu_torch.datasets.image_io import (read_png, resize_bilinear,
                                               write_png)
from hesic_tpu_torch.geometry.net import HomographyNet, photometric_loss
from hesic_tpu_torch.utils.persist import load_jax_tree

torch.set_num_threads(2)

SYN_ATOL = 1e-3
NET_ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- PNG files with a chosen filter on every row ----

def _filter_row(kind, row, prior, bpp):
    row, prior = row.astype(np.int64), prior.astype(np.int64)
    out = np.zeros_like(row)
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (row[i] - pred) % 256
    return out.astype(np.uint8)


def _write_filtered(path, img, colour, kinds):
    h, w = img.shape[:2]
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    flat = img.reshape(h, w * ch)
    raw, prior = b"", np.zeros(w * ch, np.uint8)
    for y in range(h):
        kind = kinds[y % len(kinds)]
        raw += bytes([kind]) + _filter_row(kind, flat[y], prior,
                                           ch).tobytes()
        prior = flat[y]

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))


COLOURS = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}


@pytest.mark.parametrize("colour", sorted(COLOURS))
@pytest.mark.parametrize("kind", range(5))
def test_png_reader_equals_pil_per_filter(tmp_path, colour, kind):
    rng = np.random.RandomState(10 * colour + kind)
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    # a smooth field plus noise, so every filter has work to do
    ramp = np.add.outer(np.arange(13), np.arange(17))[..., None] * 9
    img = ((ramp + rng.randint(0, 40, (13, 17, ch))) % 256).astype(np.uint8)
    path = str(tmp_path / "f.png")
    _write_filtered(path, img, colour, [kind])
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(read_png(path), want)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA"])
def test_png_reader_equals_pil_on_pil_files(tmp_path, mode):
    rng = np.random.RandomState(1)
    arr = (rng.rand(31, 23, len(mode)) * 255).astype(np.uint8)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(
        path, optimize=True)
    np.testing.assert_array_equal(read_png(path),
                                  np.asarray(Image.open(path).convert("RGB")))


def test_png_mixed_filters_and_writer(tmp_path):
    rng = np.random.RandomState(2)
    img = (rng.rand(20, 9, 3) * 255).astype(np.uint8)
    _write_filtered(str(tmp_path / "mix.png"), img, 2, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(read_png(str(tmp_path / "mix.png")), img)
    write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(str(tmp_path / "w.png"))), img)


def test_png_reader_refuses_other_formats(tmp_path):
    arr = np.zeros((4, 4, 3), np.uint8)
    Image.fromarray(arr).save(str(tmp_path / "a.jpg"))
    with pytest.raises(ValueError, match="PNG"):
        read_png(str(tmp_path / "a.jpg"))
    Image.fromarray(arr[..., 0]).convert("P").save(str(tmp_path / "p.png"))
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(str(tmp_path / "p.png"))


@pytest.mark.parametrize("hw", [(64, 64), (96, 80), (300, 280), (512, 512),
                                (37, 100)])
def test_resize_equals_pil_bilinear(hw):
    img = (np.random.RandomState(hw[0]).rand(*hw, 3) * 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((256, 256),
                                                  Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(img, (256, 256)), want)


# ---- the datasets against the JAX package's ----

def _stereo_tree(root, n=3, size=(80, 72), single=False):
    rng = np.random.RandomState(0)
    for split in ("train", "test"):
        for eye in ((None,) if single else ("left", "right")):
            d = os.path.join(root, split, *(() if eye is None else (eye,)))
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                arr = (rng.rand(*size, 3) * 255).astype(np.uint8)
                write_png(os.path.join(d, f"{i:02d}.png"), arr)
    return root


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], (str, list)):
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("patch", [(64, 48), (256, 256)])
def test_stereo_items_equal_jax(tmp_path, patch):
    root = _stereo_tree(str(tmp_path))
    j = jds.StereoImageFolder(root, "train", patch, need_file_name=True,
                              rng=np.random.RandomState(3))
    t = tds.StereoImageFolder(root, "train", patch, need_file_name=True,
                              rng=np.random.RandomState(3))
    assert len(t) == len(j) == 3
    for i in (0, 2, 1, 0):
        _assert_items_equal(t[i], j[i])


def test_batches_and_single_images_equal_jax(tmp_path):
    root = _stereo_tree(str(tmp_path / "s"), n=5)
    kw = dict(need_file_name=True)
    j = jds.StereoImageFolder(root, "train", 48, rng=np.random.RandomState(
        4), **kw)
    t = tds.StereoImageFolder(root, "train", 48, rng=np.random.RandomState(
        4), **kw)
    jb = list(jds.batch_iterator(j, 2, seed=7))
    tb = list(tds.batch_iterator(t, 2, seed=7))
    assert len(tb) == len(jb) == 2
    for a, b in zip(tb, jb):
        _assert_items_equal(a, b)
    tail = list(tds.batch_iterator(t, 2, shuffle=False, drop_last=False))
    assert [b["name"] for b in tail] == [["00.png", "01.png"],
                                         ["02.png", "03.png"], ["04.png"]]

    single = _stereo_tree(str(tmp_path / "one"), n=3, single=True)
    js = jds.ImageFolder(single, "test", 40, rng=np.random.RandomState(5))
    ts = tds.ImageFolder(single, "test", 40, rng=np.random.RandomState(5))
    for a, b in zip(tds.batch_iterator(ts, 3, seed=1),
                    jds.batch_iterator(js, 3, seed=1)):
        _assert_items_equal(a, b)


@pytest.mark.parametrize("synthetic", [True, False])
def test_synthetic_dataset_matches_jax(tmp_path, synthetic):
    root = _stereo_tree(str(tmp_path), n=2)
    j = jds.SyntheticHomographyDataset(root, synthetic=synthetic,
                                       rng=np.random.RandomState(6))
    t = tds.SyntheticHomographyDataset(root, synthetic=synthetic,
                                       rng=np.random.RandomState(6))
    for i in (0, 1):
        a, b = t[i], j[i]
        for k in ("img_a", "patch_a", "corners", "delta_gt"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("img_b", "patch_b"):
            assert a[k].dtype == np.float32
            np.testing.assert_allclose(a[k], b[k], atol=SYN_ATOL, err_msg=k)
    if synthetic:
        assert np.abs(a["delta_gt"]).max() > 0


def test_classical_h_and_missing_dirs_raise(tmp_path):
    with pytest.raises(RuntimeError):      # classical_h is ported now
        tds.StereoImageFolder(str(tmp_path), classical_h=True,
                              h_device="cpu")
    with pytest.raises(RuntimeError):
        tds.StereoImageFolder(str(tmp_path), "train")
    for eye, name in (("left", "a.png"), ("right", "b.png")):
        os.makedirs(tmp_path / "train" / eye)
        write_png(str(tmp_path / "train" / eye / name),
                  np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="unpaired"):
        tds.StereoImageFolder(str(tmp_path), "train", 8)[0]


def test_datasets_import_neither_pil_nor_torchvision(tmp_path):
    root = _stereo_tree(str(tmp_path), n=1)
    code = ("import sys\n"
            "from hesic_tpu_torch.datasets import StereoImageFolder\n"
            f"StereoImageFolder({root!r}, 'train', 64)[0]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'torchvision', 'jax', 'hesic_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


# ---- the homography net against the JAX package's ----

def _net_pair(batch_norm):
    rng = np.random.RandomState(8)
    a = rng.randn(2, 128, 128, 1).astype(np.float32)
    b = (np.roll(a, 2, axis=2) + 0.1 * rng.randn(2, 128, 128, 1)
         ).astype(np.float32)
    jnet = JHomographyNet(batch_norm=batch_norm)
    variables = jnet.init({"params": jax.random.PRNGKey(1),
                           "dropout": jax.random.PRNGKey(2)},
                          jnp.asarray(a), jnp.asarray(b))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if batch_norm:
        # running statistics away from flax's init (mean 0, var 1)
        variables = dict(variables, batch_stats=jax.tree_util.tree_map(
            lambda v: (rng.rand(*v.shape) + 0.5).astype(np.float32),
            variables["batch_stats"]))
    net = HomographyNet(batch_norm=batch_norm, device="cpu", seed=3)
    load_jax_tree(net, variables)
    return jnet, variables, net, a, b


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("batch_norm", [False, True])
def test_homography_net_carried_from_jax(batch_norm):
    jnet, variables, net, a, b = _net_pair(batch_norm)
    corners = np.tile(np.array([[[40, 50], [168, 50], [168, 178],
                                 [40, 178]]], np.float32), (2, 1, 1))
    want = jnet.apply(variables, jnp.asarray(a), jnp.asarray(b))
    want_h = jnet.apply(variables, jnp.asarray(a), jnp.asarray(b),
                        jnp.asarray(corners), method="get_h")
    with torch.no_grad():
        got = net(_nchw(a), _nchw(b))
        got_h = net.get_h(_nchw(a), _nchw(b), torch.from_numpy(corners))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NET_ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               atol=NET_ATOL)
    # training mode: dropout draws from the generator, batch statistics
    gen = torch.Generator().manual_seed(0)
    d1 = net(_nchw(a), _nchw(b), training=True, generator=gen)
    d2 = net(_nchw(a), _nchw(b), training=True,
             generator=torch.Generator().manual_seed(0))
    assert torch.equal(d1, d2) and not torch.equal(d1, got)


def test_photometric_loss_and_gradients_match_jax():
    rng = np.random.RandomState(9)
    img_a = rng.randn(2, 256, 256, 1).astype(np.float32)
    patch_b = rng.randn(2, 128, 128, 1).astype(np.float32)
    corners = np.tile(np.array([[[45, 60], [173, 60], [173, 188],
                                 [45, 188]]], np.float32), (2, 1, 1))
    delta = (rng.rand(2, 4, 2) * 6 - 3).astype(np.float32)

    def jloss(d, img):
        return j_photometric_loss(d, img, jnp.asarray(patch_b),
                                  jnp.asarray(corners))

    want, (want_gd, want_gi) = jax.value_and_grad(jloss, (0, 1))(
        jnp.asarray(delta), jnp.asarray(img_a))
    d = torch.from_numpy(delta).requires_grad_(True)
    img = _nchw(img_a).requires_grad_(True)
    got = photometric_loss(d, img, _nchw(patch_b),
                           torch.from_numpy(corners))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= NET_ATOL
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want_gd),
                               atol=NET_ATOL)
    np.testing.assert_allclose(img.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_gi), atol=NET_ATOL)
