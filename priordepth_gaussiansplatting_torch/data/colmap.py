"""COLMAP sparse-model readers/writers (binary + text), pure numpy; a copy
of the JAX package's ``data/colmap.py``.

Format-compatible replacement for the reference's `scene/colmap_loader.py` and
`utils/read_write_model.py`: cameras.bin/txt, images.bin/txt,
points3D.bin/txt, in both directions (writing is needed by the depth-scale
tool and the round-trip tests — the only unit tests the reference itself
ships, `external/scripts/test_read_write_model.py`).

Binary layout (COLMAP 3.x):
  cameras.bin : u64 count; per camera: i32 id, i32 model, u64 w, u64 h,
                f64 params[num_params(model)]
  images.bin  : u64 count; per image: i32 id, f64 qvec[4], f64 tvec[3],
                i32 camera_id, name\\0, u64 n2d, (f64 x, f64 y, i64 p3d)×n2d
  points3D.bin: u64 count; per point: u64 id, f64 xyz[3], u8 rgb[3],
                f64 error, u64 track_len, (i32 image_id, i32 p2d_idx)×len
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(qvec) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix
    (`scene/colmap_loader.py:43` convention)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


# ---------------------------------------------------------------- cameras
def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, nparam = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * nparam, "d" * nparam))
            out[cid] = ColmapCamera(cid, name, w, h, params)
    return out


def write_cameras_binary(cameras: Dict[int, ColmapCamera], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            out[cid] = ColmapCamera(cid, parts[1], int(parts[2]),
                                    int(parts[3]),
                                    np.array(tuple(map(float, parts[4:]))))
    return out


def write_cameras_text(cameras: Dict[int, ColmapCamera], path) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(map(str, cam.params))
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


# ---------------------------------------------------------------- images
def read_images_binary(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, 8, "Q")
            data = np.array(_read(f, 24 * n2d, "ddq" * n2d))
            xys = data.reshape(-1, 3)[:, :2] if n2d else np.zeros((0, 2))
            p3d = (data.reshape(-1, 3)[:, 2].astype(np.int64)
                   if n2d else np.zeros(0, np.int64))
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                   name.decode("utf-8"), xys, p3d)
    return out


def write_images_binary(images: Dict[int, ColmapImage], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n2d = len(im.point3D_ids)
            f.write(struct.pack("<Q", n2d))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def read_images_text(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        parts = meta.split()
        iid = int(parts[0])
        qvec = np.array(tuple(map(float, parts[1:5])))
        tvec = np.array(tuple(map(float, parts[5:8])))
        cam_id = int(parts[8])
        name = parts[9]
        el = pts.split()
        xys = (np.column_stack([
            np.array(el[0::3], float), np.array(el[1::3], float)])
            if el else np.zeros((0, 2)))
        p3d = np.array(el[2::3], np.int64) if el else np.zeros(0, np.int64)
        out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, p3d)
    return out


def write_images_text(images: Dict[int, ColmapImage], path) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for im in images.values():
            q = " ".join(map(str, im.qvec))
            t = " ".join(map(str, im.tvec))
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            f.write(" ".join(
                f"{x} {y} {int(p)}" for (x, y), p in
                zip(im.xys, im.point3D_ids)) + "\n")


# ---------------------------------------------------------------- points3D
def read_points3D_binary(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            pid = _read(f, 8, "Q")[0]
            xyz = np.array(_read(f, 24, "ddd"))
            rgb = np.array(_read(f, 3, "BBB"))
            (err,) = _read(f, 8, "d")
            (tlen,) = _read(f, 8, "Q")
            track = np.array(_read(f, 8 * tlen, "ii" * tlen)).reshape(-1, 2) \
                if tlen else np.zeros((0, 2), np.int64)
            out[pid] = ColmapPoint3D(pid, xyz, rgb, err,
                                     track[:, 0].astype(np.int32),
                                     track[:, 1].astype(np.int32))
    return out


def write_points3D_binary(points: Dict[int, ColmapPoint3D], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            f.write(struct.pack("<Q", pt.id))
            f.write(struct.pack("<ddd", *pt.xyz))
            f.write(struct.pack("<BBB", *pt.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", pt.error))
            f.write(struct.pack("<Q", len(pt.image_ids)))
            for iid, pidx in zip(pt.image_ids, pt.point2D_idxs):
                f.write(struct.pack("<ii", int(iid), int(pidx)))


def read_points3D_text(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pid = int(parts[0])
            xyz = np.array(tuple(map(float, parts[1:4])))
            rgb = np.array(tuple(map(int, parts[4:7])))
            err = float(parts[7])
            track = np.array(tuple(map(int, parts[8:]))).reshape(-1, 2) \
                if len(parts) > 8 else np.zeros((0, 2), np.int64)
            out[pid] = ColmapPoint3D(pid, xyz, rgb, err,
                                     track[:, 0].astype(np.int32),
                                     track[:, 1].astype(np.int32))
    return out


def write_points3D_text(points: Dict[int, ColmapPoint3D], path) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points)}\n")
        for pt in points.values():
            track = " ".join(f"{int(i)} {int(j)}" for i, j in
                             zip(pt.image_ids, pt.point2D_idxs))
            xyz = " ".join(map(str, pt.xyz))
            rgb = " ".join(map(str, pt.rgb.astype(int)))
            f.write(f"{pt.id} {xyz} {rgb} {pt.error} {track}\n")


def read_model(sparse_dir: str):
    """Auto-detect bin/txt and read (cameras, images, points3D) with the
    pure-Python readers (the native C++ reader is not part of the port)."""

    def pick(stem, bin_fn, txt_fn):
        b = os.path.join(sparse_dir, stem + ".bin")
        t = os.path.join(sparse_dir, stem + ".txt")
        if os.path.exists(b):
            return bin_fn(b)
        if os.path.exists(t):
            return txt_fn(t)
        raise FileNotFoundError(f"{stem}.bin/.txt not found in {sparse_dir}")

    cameras = pick("cameras", read_cameras_binary, read_cameras_text)
    images = pick("images", read_images_binary, read_images_text)
    points = pick("points3D", read_points3D_binary, read_points3D_text)
    return cameras, images, points
