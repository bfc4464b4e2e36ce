"""The port's depth data pipeline (``depth/data.py``) against the JAX
package's on the CPU: ``augment`` and ``batches`` (with augmentation, one
host and two) bit for bit for the same seeds, every dataset walker and
``make_eval_dataset`` on tiny layouts written here (each sample equal),
VKitti2's split files byte for byte, ``hypersim_distance_to_depth``,
``kb_crop``, ``MixedDataset`` and ``DATASET_PRESETS``. Both packages read
the same files, so equal means equal bits."""

import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from priordepth_gaussiansplatting_torch.depth import data as P
from priordepth_gaussiansplatting_tpu.depth import data as J

torch.set_num_threads(2)


def png16(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.asarray(arr).astype(np.uint16)).save(path)


def rgb(path, h, w, rng, border=0):
    """A random RGB image, with a white frame `border` pixels wide."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    if border:
        arr[:border] = arr[-border:] = 255
        arr[:, :border] = arr[:, -border:] = 255
    Image.fromarray(arr).save(path)


def depth_png(path, h, w, rng, scale, hi=9.0):
    d = rng.random((h, w)) * hi
    d[0, :3] = 0.0  # invalid pixels
    png16(path, d * scale)


def write_folder(root, rng, n=6, h=20, w=24):
    for i in range(n):
        rgb(os.path.join(root, "images", f"im{i}.png"), h, w, rng)
        depth_png(os.path.join(root, "depths", f"im{i}.png"), h, w, rng,
                  1000.0)


# name -> (writer(root, rng), dataset(pkg, root)); each writer lays out
# two or three samples of the dataset's published layout.
def _kitti(root, rng):
    for k in range(2):
        frame = f"{k:010d}.png"
        rgb(os.path.join(root, "raw", "2011_09_26", "2011_09_26_drive_0001"
                         "_sync", "image_02", "data", frame), 360, 1230, rng)
        depth_png(os.path.join(root, "gt", "2011_09_26_drive_0001_sync",
                               "proj_depth", "groundtruth", "image_02",
                               frame), 360, 1230, rng, 256.0, 90.0)
    # A frame without ground truth is skipped.
    rgb(os.path.join(root, "raw", "2011_09_26", "2011_09_26_drive_0001_sync",
                     "image_02", "data", "0000000009.png"), 360, 1230, rng)


def _nyu(root, rng):
    for k in range(2):
        rgb(os.path.join(root, "scene_a", f"rgb_{k:05d}.jpg"), 48, 64, rng,
            border=8)
        depth_png(os.path.join(root, "scene_a", f"sync_depth_{k:05d}.png"),
                  48, 64, rng, 1000.0)


def _txt(root, rng):
    rgb(os.path.join(root, "d", "a.png"), 360, 1230, rng)
    depth_png(os.path.join(root, "g", "a_d.png"), 360, 1230, rng, 256.0, 90)
    rgb(os.path.join(root, "d", "b.png"), 360, 1230, rng)
    with open(os.path.join(root, "split.txt"), "w") as f:
        f.write("d/a.png g/a_d.png 721.5\n\n/d/b.png None\n")


def _ibims(root, rng):
    for b in ("i0", "i1"):
        rgb(os.path.join(root, "rgb", b + ".png"), 20, 30, rng)
        png16(os.path.join(root, "depth", b + ".png"),
              rng.random((20, 30)) * 65535)
        png16(os.path.join(root, "mask_invalid", b + ".png"),
              rng.random((20, 30)) > 0.2)
        png16(os.path.join(root, "mask_transp", b + ".png"),
              rng.random((20, 30)) > 0.1)
    with open(os.path.join(root, "imagelist.txt"), "w") as f:
        f.write("i0\ni1\n")


def _sunrgbd(root, rng):
    for b in ("a", "b"):
        rgb(os.path.join(root, "rgb", "rgb", b + ".jpg"), 16, 18, rng)
        depth_png(os.path.join(root, "gt", "gt", b + ".png"), 16, 18, rng,
                  1000.0, 12.0)


def _diml_indoor(root, rng):
    for sc in ("sc1", "sc2"):
        rgb(os.path.join(root, "LR", sc, "color", "f_c.png"), 12, 14, rng)
        depth_png(os.path.join(root, "LR", sc, "depth_filled",
                               "f_depth_filled.png"), 12, 14, rng, 1000.0)


def _diml_outdoor(root, rng):
    for s in ("s1", "s2"):
        rgb(os.path.join(root, s, "outleft", "x.png"), 12, 14, rng)
        depth_png(os.path.join(root, s, "depthmap", "x.png"), 12, 14, rng,
                  1000.0, 60.0)


def _diode(root, rng):
    for sc, scan in (("scene1", "scan1"), ("scene1", "scan2"),
                     ("scene2", "scan1")):
        d = os.path.join(root, sc, scan)
        rgb(os.path.join(d, "p.png"), 10, 12, rng)
        np.save(os.path.join(d, "p_depth.npy"),
                (rng.random((10, 12, 1)) * 30).astype(np.float32))
        np.save(os.path.join(d, "p_depth_mask.npy"), rng.random((10, 12)))


def _hypersim(root, rng):
    import h5py
    for cam in ("scene_cam_00", "scene_cam_01"):
        rgb(os.path.join(root, "ai_001", "images", cam + "_final_preview",
                         "frame.0000.tonemap.jpg"), 12, 16, rng)
        g = os.path.join(root, "ai_001", "images", cam + "_geometry_hdf5")
        os.makedirs(g, exist_ok=True)
        with h5py.File(os.path.join(g, "frame.0000.depth_meters.hdf5"),
                       "w") as f:
            f["dataset"] = (rng.random((12, 16)) * 12).astype(np.float16)
    os.makedirs(os.path.join(root, "ai_001", "images", "other_dir"))


def _vkitti2(root, rng):
    for scene in ("Scene01", "Scene02"):
        for k in range(5):
            base = os.path.join(root, "rgb", scene, "clone", "frames", "rgb",
                                "Camera_0")
            rgb(os.path.join(base, f"rgb_{k:05d}.jpg"), 356, 1220, rng)
            depth_png(os.path.join(root, "depth", scene, "clone", "frames",
                                   "depth", "Camera_0",
                                   f"depth_{k:05d}.png"), 356, 1220, rng,
                      100.0, 120.0)


def _ddad(root, rng):
    for k in range(2):
        rgb(os.path.join(root, f"{k:03d}_rgb.png"), 10, 10, rng)
        np.save(os.path.join(root, f"{k:03d}_depth.npy"),
                (rng.random((10, 10)) * 100).astype(np.float32))


WALKERS = {
    "folder": (write_folder, lambda m, r: m.FolderDepthDataset(r)),
    "make_dataset_kitti": (write_folder, lambda m, r: m.make_dataset(
        r, "kitti", max_depth=20.0)),
    "kitti": (_kitti, lambda m, r: m.KittiDepthDataset(
        os.path.join(r, "raw"), os.path.join(r, "gt"))),
    "kitti_no_crop": (_kitti, lambda m, r: m.KittiDepthDataset(
        os.path.join(r, "raw"), os.path.join(r, "gt"), do_kb_crop=False)),
    "nyu": (_nyu, lambda m, r: m.NyuDepthDataset(r)),
    "nyu_avoid_boundary": (_nyu, lambda m, r: m.NyuDepthDataset(
        r, avoid_boundary=True)),
    "txt_split": (_txt, lambda m, r: m.TxtSplitDepthDataset(
        r, r, os.path.join(r, "split.txt"), do_kb_crop=True)),
    "ibims": (_ibims, lambda m, r: m.IbimsDataset(r)),
    "sunrgbd": (_sunrgbd, lambda m, r: m.SunRGBDDataset(r)),
    "diml_indoor": (_diml_indoor, lambda m, r: m.DimlIndoorDataset(r)),
    "diml_outdoor": (_diml_outdoor, lambda m, r: m.DimlOutdoorDataset(r)),
    "diode": (_diode, lambda m, r: m.DiodeDataset(r)),
    "hypersim": (_hypersim, lambda m, r: m.HypersimDataset(r)),
    "vkitti2_train": (_vkitti2, lambda m, r: m.VKitti2Dataset(
        r, split="train")),
    "ddad": (_ddad, lambda m, r: m.DdadDataset(r)),
}


def same_samples(a, b):
    assert len(a) == len(b) > 0
    for i in range(len(a)):
        sa, sb = a[i], b[i]
        assert type(sa).__name__ == type(sb).__name__ == "DepthSample"
        for f in ("image", "depth", "mask"):
            x, y = getattr(sa, f), getattr(sb, f)
            assert x.dtype == y.dtype and x.shape == y.shape, (i, f)
            np.testing.assert_array_equal(x, y, err_msg=f"{i} {f}")


@pytest.mark.parametrize("name", sorted(WALKERS))
def test_walker_matches_jax(name, tmp_path):
    write, make = WALKERS[name]
    write(str(tmp_path), np.random.default_rng(len(name)))
    same_samples(make(P, str(tmp_path)), make(J, str(tmp_path)))


EVAL_LAYOUTS = {"ibims": _ibims, "sunrgbd": _sunrgbd,
                "diml_indoor": _diml_indoor, "diml_outdoor": _diml_outdoor,
                "diode_indoor": _diode, "diode_outdoor": _diode,
                "hypersim": _hypersim, "vkitti2": _vkitti2, "ddad": _ddad,
                "nyu": _nyu, "kitti": _kitti}


@pytest.mark.parametrize("name", sorted(EVAL_LAYOUTS))
def test_make_eval_dataset_matches_jax(name, tmp_path):
    """The nine named benchmarks with their preset depth caps, and KITTI
    and NYU through their train walkers."""
    EVAL_LAYOUTS[name](str(tmp_path), np.random.default_rng(len(name)))
    kw = ({"data_path": str(tmp_path / "raw"), "gt_path": str(tmp_path
                                                             / "gt")}
          if name == "kitti" else {})
    same_samples(P.make_eval_dataset(name, str(tmp_path), **dict(kw)),
                 J.make_eval_dataset(name, str(tmp_path), **dict(kw)))


def test_vkitti2_split_files_match_jax(tmp_path):
    """The split files as JAX writes them, byte for byte; then both walk
    them."""
    _vkitti2(str(tmp_path), np.random.default_rng(3))
    J.VKitti2Dataset(str(tmp_path))
    files = {n: (tmp_path / n).read_bytes() for n in ("train.txt",
                                                      "test.txt")}
    for n in files:
        os.remove(tmp_path / n)
    port = P.VKitti2Dataset(str(tmp_path))
    for n, want in files.items():
        assert (tmp_path / n).read_bytes() == want, n
    assert len(port) == 2
    same_samples(port, J.VKitti2Dataset(str(tmp_path)))


def test_hypersim_distance_and_kb_crop_match_jax():
    rng = np.random.default_rng(4)
    dist = (rng.random((30, 40)) * 10).astype(np.float32)
    np.testing.assert_array_equal(P.hypersim_distance_to_depth(dist),
                                  J.hypersim_distance_to_depth(dist))
    np.testing.assert_array_equal(
        P.hypersim_distance_to_depth(dist, focal=120.0),
        J.hypersim_distance_to_depth(dist, focal=120.0))
    for shape in ((375, 1242, 3), (300, 1000), (352, 1216)):
        arr = rng.random(shape)
        np.testing.assert_array_equal(P.kb_crop(arr), J.kb_crop(arr))


def test_presets_match_jax():
    assert P.DATASET_PRESETS == J.DATASET_PRESETS
    assert set(P._EVAL_DATASETS) == set(J._EVAL_DATASETS)
    import dataclasses
    assert (dataclasses.asdict(P.AugmentConfig())
            == dataclasses.asdict(J.AugmentConfig()))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("folder"))
    write_folder(root, np.random.default_rng(5), n=7, h=24, w=30)
    return root


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augment_matches_jax(folder, seed):
    """Rotation, crop, flip and colour, with the same draws in the same
    order for the same seed."""
    cfg = dict(crop_h=16, crop_w=20, degree=8.0)
    sample = J.FolderDepthDataset(folder)[seed]
    jr, pr = random.Random(seed), random.Random(seed)
    for _ in range(3):
        want = J.augment(sample, J.AugmentConfig(**cfg), jr)
        got = P.augment(P.DepthSample(sample.image, sample.depth,
                                      sample.mask),
                        P.AugmentConfig(**cfg), pr)
        for f in ("image", "depth", "mask"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert jr.random() == pr.random()


@pytest.mark.parametrize("hosts", [1, 2])
def test_batches_match_jax(folder, hosts):
    """Two epochs of batches of 2 with augmentation on every host index:
    the strided share of the shared permutation, bit for bit."""
    cfg = dict(crop_h=16, crop_w=20)
    for host in range(hosts):
        got = list(P.batches(P.FolderDepthDataset(folder), 2,
                             P.AugmentConfig(**cfg), seed=3,
                             host_count=hosts, host_index=host, epochs=2))
        want = list(J.batches(J.FolderDepthDataset(folder), 2,
                              J.AugmentConfig(**cfg), seed=3,
                              host_count=hosts, host_index=host, epochs=2))
        assert len(got) == len(want) == 2 * (len(range(host, 7, hosts))
                                             // 2)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_mixed_dataset_matches_jax(folder, tmp_path):
    write_folder(str(tmp_path), np.random.default_rng(6), n=3)
    port = P.MixedDataset([P.FolderDepthDataset(folder),
                           P.make_dataset(str(tmp_path), "nyu")])
    jaxd = J.MixedDataset([J.FolderDepthDataset(folder),
                           J.make_dataset(str(tmp_path), "nyu")])
    assert len(port) == len(jaxd) == 10
    pr, jr = random.Random(9), random.Random(9)
    for _ in range(5):
        (ps, pd), (js, jd) = port.sample(pr), jaxd.sample(jr)
        assert pd == jd
        np.testing.assert_array_equal(ps.depth, js.depth)
