"""Scene loading: COLMAP + Blender datasets, camera lists, depth priors (a
copy of the JAX package's ``data/dataset.py`` whose cameras are the port's
:class:`Camera`, with tensors on the chosen device).

Functional port of the reference scene layer (`scene/__init__.py`,
`scene/dataset_readers.py`, `utils/camera_utils.py`, `scene/cameras.py`) with
identical on-disk contracts:
  * COLMAP layout `{images/, sparse/0/{cameras,images,points3D}.{bin,txt}}`
    (+ optional `sparse/0/depth_params.json` and a depth-map dir of 16-bit
    inverse-depth PNGs);
  * Blender layout `transforms_{train,test}.json`;
  * eval split: LLFF hold-out (every 8th sorted image) or `test.txt`;
  * nerf++ normalisation: scene radius = 1.1 × max camera-centroid distance;
  * resolution: `-r {1,2,4,8}` divisors, or auto-cap at 1600 px width;
  * depth priors: PNG/65536 (COLMAP) or /512 (Blender), per-image
    scale/offset from depth_params.json, reliability gate
    scale ∈ [0.2, 5]×med_scale (`scene/cameras.py:60-78`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
from typing import List, Optional

import numpy as np
from PIL import Image

from ..core import cameras as camlib
from ..core.cameras import Camera
from . import colmap as colmap_io
from . import ply as ply_io


@dataclasses.dataclass
class CameraInfo:
    """Pre-load camera metadata (reference `dataset_readers.CameraInfo`)."""

    uid: int
    R: np.ndarray           # camera-to-world rotation
    T: np.ndarray           # world-to-camera translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    depth_path: str
    depth_params: Optional[dict]
    width: int
    height: int
    is_test: bool


@dataclasses.dataclass
class SceneInfo:
    point_cloud: tuple      # (xyz, colors, normals)
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str
    is_nerf_synthetic: bool


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """Camera-centroid diagonal ×1.1 -> scene radius
    (`scene/dataset_readers.py:48-69`)."""
    centers = []
    for cam in cam_infos:
        w2c = camlib.world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers)
    center = centers.mean(axis=0)
    diagonal = np.max(np.linalg.norm(centers - center, axis=1))
    radius = diagonal * 1.1
    return {"translate": -center, "radius": float(radius)}


def _focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


def store_point_ply_whole(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """Write a scene's initial point cloud through a temporary file renamed
    into place: the ranks of a multi-rank run load a fresh scene at once,
    and each must read a whole file, its own or another rank's."""
    tmp = f"{path}.{os.getpid()}.tmp"
    ply_io.store_point_ply(tmp, xyz, rgb)
    os.replace(tmp, path)


def read_colmap_scene(path: str, images_dir: str = "images",
                      depths_dir: str = "", eval_split: bool = False,
                      llffhold: int = 8) -> SceneInfo:
    """`readColmapSceneInfo` (`scene/dataset_readers.py:145-224`)."""
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    cameras, images, points = colmap_io.read_model(sparse)

    # depth_params.json + median scale (dataset_readers.py:157-177).
    depth_params = None
    dp_path = os.path.join(sparse, "depth_params.json")
    if depths_dir and os.path.exists(dp_path):
        with open(dp_path) as f:
            depth_params = json.load(f)
        scales = np.array([d["scale"] for d in depth_params.values()])
        med = np.median(scales[scales > 0]) if (scales > 0).any() else 0.0
        for d in depth_params.values():
            d["med_scale"] = med

    test_names: List[str] = []
    test_txt = os.path.join(sparse, "test.txt")
    if eval_split:
        if os.path.exists(test_txt):
            with open(test_txt) as f:
                test_names = [ln.strip() for ln in f if ln.strip()]
        else:
            names = sorted(im.name for im in images.values())
            test_names = [n for i, n in enumerate(names) if i % llffhold == 0]

    cam_infos = []
    for iid in sorted(images, key=lambda i: images[i].name):
        im = images[iid]
        cam = cameras[im.camera_id]
        R = colmap_io.qvec2rotmat(im.qvec).T  # cam-to-world
        T = im.tvec
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model}: undistort "
                "images first (convert.py pipeline)")
        fovx = _focal2fov(fx, cam.width)
        fovy = _focal2fov(fy, cam.height)
        stem = os.path.splitext(im.name)[0]
        dp = depth_params.get(stem) if depth_params else None
        cam_infos.append(CameraInfo(
            uid=iid, R=R, T=T, fovx=fovx, fovy=fovy,
            image_path=os.path.join(path, images_dir, im.name),
            image_name=stem,
            depth_path=(os.path.join(path, depths_dir, stem + ".png")
                        if depths_dir else ""),
            depth_params=dp, width=cam.width, height=cam.height,
            is_test=im.name in test_names or stem in test_names
            or (eval_split and not os.path.exists(test_txt)
                and im.name in test_names)))
    train = [c for c in cam_infos if not (eval_split and c.is_test)]
    test = [c for c in cam_infos if eval_split and c.is_test]

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        xyz = np.stack([p.xyz for p in points.values()]).astype(np.float32)
        rgb = np.stack([p.rgb for p in points.values()]).astype(np.uint8)
        store_point_ply_whole(ply_path, xyz, rgb)
    pcd = ply_io.fetch_point_ply(ply_path)

    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path, is_nerf_synthetic=False)


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = True,
                       depths_dir: str = "") -> SceneInfo:
    """`readNerfSyntheticInfo` (`scene/dataset_readers.py:226-310`)."""

    def read_split(fname, is_test):
        with open(os.path.join(path, fname)) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        infos = []
        for idx, frame in enumerate(meta["frames"]):
            file_path = frame["file_path"]
            image_path = os.path.join(path, file_path + ".png")
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            with Image.open(image_path) as im:
                width, height = im.size
            fovy = _focal2fov(camlib.fov_to_focal(fovx, width), height)
            name = os.path.basename(file_path)
            infos.append(CameraInfo(
                uid=idx, R=R, T=T, fovx=fovx, fovy=fovy,
                image_path=image_path, image_name=name,
                depth_path=(os.path.join(path, depths_dir, name + ".png")
                            if depths_dir else ""),
                depth_params=None, width=width, height=height,
                is_test=is_test))
        return infos

    train = read_split("transforms_train.json", False)
    test = (read_split("transforms_test.json", True)
            if os.path.exists(os.path.join(path, "transforms_test.json"))
            and eval_split else [])
    if not eval_split:
        train += test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # Random init: 100k points in [-1.3, 1.3]³ (dataset_readers.py:288-298).
        num_pts = 100_000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        rgb = (np.random.random((num_pts, 3)) * 255).astype(np.uint8)
        store_point_ply_whole(ply_path, xyz.astype(np.float32), rgb)
    pcd = ply_io.fetch_point_ply(ply_path)
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path, is_nerf_synthetic=True)


def detect_and_read_scene(path: str, images: str = "images",
                          depths: str = "", eval_split: bool = False,
                          white_background: bool = False) -> SceneInfo:
    """Scene type detection (`scene/__init__.py:43-49`)."""
    if os.path.exists(os.path.join(path, "sparse")):
        return read_colmap_scene(path, images, depths, eval_split)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return read_blender_scene(path, white_background, eval_split, depths)
    raise ValueError(f"Could not recognize scene type in {path}")


def _resolve_resolution(width, height, resolution_arg, scale=1.0):
    """`utils/camera_utils.py:26-66` resolution policy."""
    if resolution_arg in (1, 2, 4, 8):
        return (round(width / (resolution_arg * scale)),
                round(height / (resolution_arg * scale)))
    if resolution_arg == -1:
        if width > 1600:
            global_down = width / 1600
        else:
            global_down = 1.0
    else:
        global_down = width / resolution_arg
    s = float(global_down) * float(scale)
    return round(width / s), round(height / s)


def load_camera(info: CameraInfo, resolution_arg: int = -1,
                resolution_scale: float = 1.0, white_background: bool = False,
                train_test_exp: bool = False, exposure_id: int = -1,
                is_nerf_synthetic: bool = False,
                load_image: bool = True,
                device=None) -> Camera:
    """Materialise one Camera on `device` (the card unless the caller names
    the CPU): image, alpha mask, depth prior, matrices
    (`utils/camera_utils.py:20-75`, `scene/cameras.py:19-89`)."""
    with Image.open(info.image_path) as pil:
        w, h = _resolve_resolution(pil.width, pil.height, resolution_arg,
                                   resolution_scale)
        image = None
        alpha_mask = None
        if load_image:
            pil = pil.resize((w, h), Image.Resampling.LANCZOS)
            arr = np.asarray(pil, dtype=np.float32) / 255.0
            if arr.ndim == 2:
                arr = np.repeat(arr[..., None], 3, axis=2)
            if arr.shape[2] == 4:
                alpha = arr[..., 3]
                if is_nerf_synthetic or white_background:
                    bg = 1.0 if white_background else 0.0
                    arr = arr[..., :3] * alpha[..., None] \
                        + bg * (1.0 - alpha[..., None])
                    alpha_mask = None
                else:
                    alpha_mask = alpha
                    arr = arr[..., :3]
            else:
                arr = arr[..., :3]
            image = arr.transpose(2, 0, 1)  # (3, H, W)
            # train_test_exp: mask out the left half of test views
            # (`scene/cameras.py:50-54`).
            if train_test_exp and info.is_test:
                alpha_mask = (np.ones((h, w), np.float32) if alpha_mask is None
                              else alpha_mask)
                alpha_mask[:, : w // 2] = 0.0

    invdepth = None
    depth_reliable = False
    depth_mask = None
    if info.depth_path and os.path.exists(info.depth_path):
        with Image.open(info.depth_path) as dp:
            darr = np.asarray(dp, dtype=np.float32)
        divisor = 512.0 if is_nerf_synthetic else 65536.0
        darr = darr / divisor
        if darr.shape != (h, w):
            dimg = Image.fromarray(darr)
            darr = np.asarray(dimg.resize((w, h), Image.Resampling.BILINEAR))
        depth_reliable = True
        scale, offset = 1.0, 0.0
        if info.depth_params is not None:
            scale = info.depth_params["scale"]
            offset = info.depth_params["offset"]
            med = info.depth_params.get("med_scale", 0.0)
            if med > 0 and (scale < 0.2 * med or scale > 5 * med):
                depth_reliable = False
        if scale > 0:
            invdepth = darr * scale + offset
        else:
            invdepth = darr
        depth_mask = np.full((h, w), 1.0 if depth_reliable else 0.0,
                             np.float32)
        if alpha_mask is not None:
            depth_mask = depth_mask * alpha_mask

    return camlib.make_camera(
        info.R, info.T, info.fovx, info.fovy, w, h,
        image=image, invdepth=invdepth, depth_mask=depth_mask,
        alpha_mask=alpha_mask, exposure_id=exposure_id,
        image_name=info.image_name, depth_reliable=depth_reliable,
        uid=info.uid, device=device)


class Scene:
    """Training-time scene container (reference `scene/__init__.py:25-100`)."""

    def __init__(self, source_path: str, model_path: str = "",
                 images: str = "images", depths: str = "",
                 eval_split: bool = False, resolution: int = -1,
                 white_background: bool = False, train_test_exp: bool = False,
                 shuffle: bool = True, seed: int = 0,
                 load_images: bool = True, device=None):
        self.model_path = model_path
        self.train_test_exp = train_test_exp
        self.info = detect_and_read_scene(
            source_path, images, depths, eval_split, white_background)
        self.cameras_extent = self.info.nerf_normalization["radius"]

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            with open(self.info.ply_path, "rb") as src, \
                    open(os.path.join(model_path, "input.ply"), "wb") as dst:
                dst.write(src.read())
            cam_json = [camera_to_json(i, c) for i, c in enumerate(
                self.info.train_cameras + self.info.test_cameras)]
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        # Exposure ids follow the TRAIN image list order (gaussian_model
        # exposure_mapping, `gaussian_model.py:175-178`).
        self.exposure_ids = {c.image_name: i for i, c in
                             enumerate(self.info.train_cameras)}
        self.train_cameras = [
            load_camera(c, resolution, 1.0, white_background, train_test_exp,
                        exposure_id=self.exposure_ids[c.image_name],
                        is_nerf_synthetic=self.info.is_nerf_synthetic,
                        load_image=load_images, device=device)
            for c in self.info.train_cameras]
        self.test_cameras = [
            load_camera(c, resolution, 1.0, white_background, train_test_exp,
                        exposure_id=-1,
                        is_nerf_synthetic=self.info.is_nerf_synthetic,
                        load_image=load_images, device=device)
            for c in self.info.test_cameras]
        if shuffle:
            rng = random.Random(seed)
            rng.shuffle(self.train_cameras)
            rng.shuffle(self.test_cameras)

    def point_cloud(self):
        return self.info.point_cloud

    def num_train_images(self) -> int:
        return len(self.train_cameras)


def camera_to_json(idx: int, cam: CameraInfo) -> dict:
    """`utils/camera_utils.py:77-96` cameras.json entry."""
    w2c = camlib.world_to_view(cam.R, cam.T)
    c2w = np.linalg.inv(w2c)
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": camlib.fov_to_focal(cam.fovy, cam.height),
        "fx": camlib.fov_to_focal(cam.fovx, cam.width),
    }
