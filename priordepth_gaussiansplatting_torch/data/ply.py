"""PLY I/O — byte-compatible with the reference's interchange formats; a
copy of the JAX package's ``data/ply.py``.

Two formats:
  * Gaussian-model PLY (`scene/gaussian_model.py:228-259`): the format SIBR
    viewers and the reference's own `load_ply` consume. Attribute order is
    x,y,z,nx,ny,nz,f_dc_0..2,f_rest_0..3(K-1)-1,opacity,scale_0..2,rot_0..3
    with f_dc/f_rest flattened CHANNEL-major ((N,K,3) -> transpose -> (N,3K)).
  * plain point-cloud PLY (`scene/dataset_readers.py:196-218` fetchPly/
    storePly): float xyz+normals + uchar RGB.

Implemented directly on numpy structured arrays (binary little-endian 1.0) —
no third-party plyfile dependency.
"""

from __future__ import annotations

import os

import numpy as np


def _write_ply(path: str, elements: np.ndarray, comments=()) -> None:
    """Write a structured array as a binary_little_endian 'vertex' element."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    type_map = {"f4": "float", "u1": "uchar", "f8": "double", "i4": "int"}
    lines = ["ply", "format binary_little_endian 1.0"]
    lines += [f"comment {c}" for c in comments]
    lines.append(f"element vertex {len(elements)}")
    for name in elements.dtype.names:
        code = elements.dtype[name].str[1:]  # strip byte order
        lines.append(f"property {type_map[code]} {name}")
    lines.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(lines).encode("ascii"))
        f.write(elements.tobytes())


def _read_ply(path: str) -> np.ndarray:
    """Read a single-element binary/ascii PLY into a structured array."""
    inv_map = {"float": "f4", "float32": "f4", "uchar": "u1", "uint8": "u1",
               "double": "f8", "float64": "f8", "int": "i4", "int32": "i4",
               "short": "i2", "ushort": "u2"}
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(ln.split()[1] for ln in header if ln.startswith("format"))
        count = int(next(ln.split()[2] for ln in header
                         if ln.startswith("element vertex")))
        props = [(ln.split()[2], inv_map[ln.split()[1]]) for ln in header
                 if ln.startswith("property") and not ln.startswith("property list")]
        if fmt == "binary_little_endian":
            dtype = np.dtype([(n, "<" + t) for n, t in props])
            return np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype,
                                 count=count)
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=count)
            out = np.zeros(count, dtype=np.dtype(props))
            for i, (n, _) in enumerate(props):
                out[n] = data[:, i]
            return out
        raise ValueError(f"unsupported PLY format {fmt}")


def save_gaussian_ply(path: str, xyz, features_dc, features_rest,
                      opacity, scaling, rotation) -> None:
    """Write the Gaussian-model PLY (reference `save_ply` layout).

    Args use storage-space values: features either FLAT channel-minor
    ((N, 3) dc / (N, 3(K-1)) rest — the model-store layout) or legacy
    (N, K, 3); opacity (N, 1) logit, scaling (N, 3) log, rotation (N, 4)
    unnormalised. On disk f_rest is CHANNEL-major (f_rest_{c*(K-1)+k}),
    byte-compatible with the reference `save_ply`.
    """
    n = xyz.shape[0]
    features_dc = np.asarray(features_dc)
    features_rest = np.asarray(features_rest)
    if features_dc.ndim == 2:  # flat (N, 3) -> (N, 1, 3)
        features_dc = features_dc.reshape(n, 1, 3)
    if features_rest.ndim == 2:  # flat k-major (N, 3(K-1)) -> (N, K-1, 3)
        features_rest = features_rest.reshape(n, -1, 3)
    f_dc = features_dc.transpose(0, 2, 1).reshape(n, -1)
    f_rest = features_rest.transpose(0, 2, 1).reshape(n, -1)
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    attrs = np.concatenate(
        [np.asarray(xyz), np.zeros((n, 3), np.float32), f_dc, f_rest,
         np.asarray(opacity).reshape(n, 1), np.asarray(scaling),
         np.asarray(rotation)], axis=1).astype(np.float32)
    elements = np.rec.fromarrays(
        attrs.T, dtype=np.dtype([(nme, "<f4") for nme in names]))
    _write_ply(path, np.asarray(elements))


def load_gaussian_ply(path: str):
    """Read a Gaussian-model PLY -> dict of storage-space numpy arrays
    (reference `load_ply` semantics, `gaussian_model.py:267-324`)."""
    el = _read_ply(path)
    n = len(el)
    xyz = np.stack([el["x"], el["y"], el["z"]], axis=1).astype(np.float32)
    opacity = np.asarray(el["opacity"], np.float32).reshape(n, 1)
    f_dc = np.stack([el[f"f_dc_{i}"] for i in range(3)], axis=1)  # (N,3)
    rest_names = sorted((nm for nm in el.dtype.names
                         if nm.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    k_rest = len(rest_names) // 3
    rest = np.stack([el[nm] for nm in rest_names], axis=1)  # (N, 3*k) ch-major
    features_rest = rest.reshape(n, 3, k_rest).transpose(0, 2, 1)
    scale_names = sorted((nm for nm in el.dtype.names
                          if nm.startswith("scale_")),
                         key=lambda s: int(s.split("_")[-1]))
    rot_names = sorted((nm for nm in el.dtype.names if nm.startswith("rot_")),
                       key=lambda s: int(s.split("_")[-1]))
    return {
        "xyz": xyz,
        # FLAT channel-minor model-store layout (see save_gaussian_ply).
        "features_dc": f_dc.reshape(n, 3).astype(np.float32),
        "features_rest": np.ascontiguousarray(
            features_rest.reshape(n, -1)).astype(np.float32),
        "opacity": opacity,
        "scaling": np.stack([el[nm] for nm in scale_names], 1).astype(np.float32),
        "rotation": np.stack([el[nm] for nm in rot_names], 1).astype(np.float32),
    }


def store_point_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Point-cloud PLY with uchar colours (reference `storePly`)."""
    n = xyz.shape[0]
    dtype = np.dtype([(nm, "<f4") for nm in
                      ("x", "y", "z", "nx", "ny", "nz")]
                     + [(nm, "u1") for nm in ("red", "green", "blue")])
    el = np.zeros(n, dtype=dtype)
    for i, nm in enumerate(("x", "y", "z")):
        el[nm] = xyz[:, i]
    rgbu = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8) \
        if rgb.dtype != np.uint8 else rgb
    for i, nm in enumerate(("red", "green", "blue")):
        el[nm] = rgbu[:, i]
    _write_ply(path, el)


def fetch_point_ply(path: str):
    """Read a point-cloud PLY -> (xyz f32, colors in [0,1], normals)."""
    el = _read_ply(path)
    xyz = np.stack([el["x"], el["y"], el["z"]], axis=1).astype(np.float32)
    colors = np.stack([el["red"], el["green"], el["blue"]],
                      axis=1).astype(np.float32) / 255.0
    if "nx" in (el.dtype.names or ()):
        normals = np.stack([el["nx"], el["ny"], el["nz"]],
                           axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(xyz)
    return xyz, colors, normals
