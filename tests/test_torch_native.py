"""The port's native IO runtime (``data/native.py`` over its own
``native/pdgs_io.cpp``) on the CPU: its COLMAP readers equal the JAX
package's native readers and the port's Python readers field by field, its
PLY writer writes the bytes of both packages' Python writers, parallel
reads, ``read_model`` with and without the native readers, the build key,
a failing compiler, and a truncated file as in JAX."""

import os
import shutil

import numpy as np
import pytest

from priordepth_gaussiansplatting_torch.data import colmap as pcm
from priordepth_gaussiansplatting_torch.data import native as pnative
from priordepth_gaussiansplatting_torch.data import ply as pply
from priordepth_gaussiansplatting_tpu.data import native as jnative
from priordepth_gaussiansplatting_tpu.data import ply as jply
from tests.test_data import _toy_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_model(n_points: int = 2000, n_images: int = 12, seed: int = 0):
    """Images with up to 300 2D points, points with tracks of 0–9 entries,
    ids with gaps."""
    rng = np.random.default_rng(seed)
    images = {}
    for k in range(n_images):
        iid = 3 * k + 1
        m = int(rng.integers(0, 300))
        q = rng.standard_normal(4)
        images[iid] = pcm.ColmapImage(
            iid, q / np.linalg.norm(q), rng.standard_normal(3),
            1 + k % 2, f"frame_{k:05d}.jpg", rng.random((m, 2)) * 1000,
            rng.integers(-1, n_points, m).astype(np.int64))
    points = {}
    for k in range(n_points):
        pid = 2 * k + 5
        t = int(rng.integers(0, 10))
        points[pid] = pcm.ColmapPoint3D(
            pid, rng.standard_normal(3), rng.integers(0, 256, 3),
            float(rng.random()), rng.integers(1, 40, t).astype(np.int32),
            rng.integers(0, 300, t).astype(np.int32))
    return images, points


def assert_images_equal(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert (g.id, g.camera_id, g.name) == (w.id, w.camera_id, w.name)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert g.xys.shape == w.xys.shape


def assert_points_equal(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert (g.id, g.error) == (w.id, w.error)
        for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


@pytest.fixture(params=["toy", "random_2000"])
def model_files(request, tmp_path):
    if request.param == "toy":
        _, images, points = _toy_model()
    else:
        images, points = random_model()
    ipath, ppath = str(tmp_path / "images.bin"), str(tmp_path / "points3D.bin")
    pcm.write_images_binary(images, ipath)
    pcm.write_points3D_binary(points, ppath)
    return ipath, ppath


def test_readers_equal_jax_native_and_python(model_files):
    ipath, ppath = model_files
    assert pnative.have_native() and jnative.have_native()
    want_i = pcm.read_images_binary(ipath)
    want_p = pcm.read_points3D_binary(ppath)
    for got_i, got_p in ((pnative.read_images_binary(ipath),
                          pnative.read_points3D_binary(ppath)),
                         (jnative.read_images_binary(ipath),
                          jnative.read_points3D_binary(ppath))):
        assert_images_equal(got_i, want_i)
        assert_points_equal(got_p, want_p)
    assert_images_equal(pnative.read_images_binary(ipath),
                        jnative.read_images_binary(ipath))
    assert_points_equal(pnative.read_points3D_binary(ppath),
                        jnative.read_points3D_binary(ppath))


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_ply_bytes_equal_both_python_writers(tmp_path, sh_degree):
    rng = np.random.RandomState(0)
    n, k = 9, (sh_degree + 1) ** 2
    data = dict(
        xyz=rng.randn(n, 3).astype(np.float32),
        features_dc=rng.randn(n, 3).astype(np.float32),
        features_rest=rng.randn(n, (k - 1) * 3).astype(np.float32),
        opacity=rng.randn(n, 1).astype(np.float32),
        scaling=rng.randn(n, 3).astype(np.float32),
        rotation=rng.randn(n, 4).astype(np.float32))
    paths = {name: str(tmp_path / f"{name}.ply")
             for name in ("native", "port", "jax")}
    assert pnative.save_gaussian_ply(paths["native"], **data)
    pply.save_gaussian_ply(paths["port"], **data)
    jply.save_gaussian_ply(paths["jax"], **data)
    blobs = {name: open(p, "rb").read() for name, p in paths.items()}
    assert blobs["native"] == blobs["port"] == blobs["jax"]


def test_read_files_parallel(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(11):
        p = str(tmp_path / f"f{i}.bin")
        with open(p, "wb") as f:
            f.write(rng.bytes(1000 * i + 7))
        paths.append(p)
    missing = str(tmp_path / "missing.bin")
    got = pnative.read_files_parallel(paths + [missing], n_threads=4)
    assert got[-1] is None
    for p, d in zip(paths, got):
        with open(p, "rb") as f:
            assert f.read() == d
    assert got[:-1] == jnative.read_files_parallel(paths, n_threads=3)


@pytest.mark.parametrize("prefer_native", [True, False])
def test_read_model(tmp_path, monkeypatch, prefer_native):
    cameras, images, points = _toy_model()
    d = str(tmp_path)
    pcm.write_cameras_binary(cameras, f"{d}/cameras.bin")
    pcm.write_images_binary(images, f"{d}/images.bin")
    pcm.write_points3D_binary(points, f"{d}/points3D.bin")
    calls = []
    for name in ("read_images_binary", "read_points3D_binary"):
        fn = getattr(pnative, name)
        monkeypatch.setattr(pnative, name,
                            lambda p, fn=fn, name=name:
                            calls.append(name) or fn(p))
    c2, i2, p2 = pcm.read_model(d, prefer_native=prefer_native)
    assert calls == (["read_images_binary", "read_points3D_binary"]
                     if prefer_native else [])
    assert_images_equal(i2, pcm.read_images_binary(f"{d}/images.bin"))
    assert_points_equal(p2, pcm.read_points3D_binary(f"{d}/points3D.bin"))
    assert sorted(c2) == sorted(cameras)


def test_the_build_key_follows_the_source_and_the_flags(tmp_path,
                                                        monkeypatch):
    path = pnative.library_path()
    assert path.parent == pnative.BUILD_DIR
    assert str(pnative.BUILD_DIR).endswith(os.path.join("build", "native"))
    assert path.name.startswith("libpdgs_io-") and path.suffix == ".so"
    src = tmp_path / "pdgs_io.cpp"
    shutil.copy(pnative.SRC, src)
    monkeypatch.setattr(pnative, "SRC", src)
    assert pnative.library_path() == path
    src.write_text(src.read_text() + "\n// edited\n")
    edited = pnative.library_path()
    assert edited != path
    monkeypatch.setattr(pnative, "CXX_FLAGS", pnative.CXX_FLAGS + ("-g",))
    assert pnative.library_path() not in (path, edited)
    assert "-march=native" not in pnative.CXX_FLAGS


def test_the_library_is_the_ports_own(tmp_path):
    """Built from the port's source into build/native/, never the JAX
    package's native/libpdgs_io.so."""
    lib = pnative.load_library()
    assert pnative.library_path().exists()
    assert os.path.dirname(lib._name) == str(pnative.BUILD_DIR)
    assert str(pnative.SRC) == os.path.join(
        REPO, "priordepth_gaussiansplatting_torch", "native", "pdgs_io.cpp")


def test_a_failing_compiler_raises(tmp_path, monkeypatch):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'pdgs_io.cpp:1: error: no compiler' >&2"
                   "\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(pnative, "CXX", str(cxx))
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(pnative, "_ERROR", None)
    with pytest.raises(RuntimeError, match="no compiler"):
        pnative.load_library()
    with pytest.raises(RuntimeError, match="no compiler"):  # remembered
        pnative.load_library()
    assert not pnative.have_native()
    assert not list((tmp_path / "build").iterdir())  # no stray temp file
    # read_model falls back to the Python readers.
    cameras, images, points = _toy_model()
    pcm.write_cameras_binary(cameras, str(tmp_path / "cameras.bin"))
    pcm.write_images_binary(images, str(tmp_path / "images.bin"))
    pcm.write_points3D_binary(points, str(tmp_path / "points3D.bin"))
    _, got_i, got_p = pcm.read_model(str(tmp_path))
    assert_images_equal(got_i, images)
    assert_points_equal(got_p, pcm.read_points3D_binary(
        str(tmp_path / "points3D.bin")))


@pytest.mark.parametrize("stem", ["images", "points3D"])
@pytest.mark.parametrize("cut", [0.5, 0.9])
def test_a_truncated_file_behaves_as_in_jax(tmp_path, stem, cut):
    _, images, points = _toy_model()
    path = str(tmp_path / f"{stem}.bin")
    (pcm.write_images_binary(images, path) if stem == "images"
     else pcm.write_points3D_binary(points, path))
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:int(len(blob) * cut)])
    fn = f"read_{stem}_binary"
    errors = []
    for mod in (pnative, jnative):
        with pytest.raises(Exception) as e:
            getattr(mod, fn)(path)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
