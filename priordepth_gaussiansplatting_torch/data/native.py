"""ctypes bindings of the native IO runtime (``native/pdgs_io.cpp``), the
counterpart of the JAX package's ``data/native.py``.

g++ builds the library at first use into ``build/native/`` at the root of
the checkout, named by a digest of the source and the flags, through a
temporary file renamed into place (so that processes may build it at once).
A failed build or load raises with the compiler's message; ``have_native``
says whether the library loaded, and ``colmap.read_model`` then falls back
to the pure-Python readers, as the JAX package does. The COLMAP readers
return the same dataclasses as the Python parsers; a reader that finds the
file malformed (``rc != 0``) hands it to the Python parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from . import colmap as cm

SRC = Path(__file__).resolve().parent.parent / "native" / "pdgs_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
# Without -march=native: a library keyed by source and flags must run on
# whichever CPU loads it.
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None


def library_path() -> Path:
    """Where the library goes: named by a digest of the source and the
    flags."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libpdgs_io-{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {out.name} failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {out.name} failed ({CXX} exited "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if need be. Raises RuntimeError
    (with the compiler's message) when it cannot be built or loaded; a
    failure is remembered for the process."""
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    if _ERROR is not None:
        raise RuntimeError(_ERROR)
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        _ERROR = f"the native IO library is unavailable: {e}"
        raise RuntimeError(_ERROR) from e
    lib.colmap_points3d_count.restype = ctypes.c_int64
    lib.colmap_points3d_count.argtypes = [ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_int64)]
    lib.colmap_points3d_read.restype = ctypes.c_int
    lib.colmap_images_count.restype = ctypes.c_int64
    lib.colmap_images_count.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int64),
                                        ctypes.POINTER(ctypes.c_int64)]
    lib.colmap_images_read.restype = ctypes.c_int
    lib.gaussian_ply_write.restype = ctypes.c_int
    lib.gaussian_ply_write.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_int32]
    lib.file_size.restype = ctypes.c_int64
    lib.file_size.argtypes = [ctypes.c_char_p]
    lib.read_files_parallel.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def have_native() -> bool:
    """Whether the library builds and loads."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def read_points3D_binary(path: str) -> Dict[int, cm.ColmapPoint3D]:
    lib = load_library()
    total_track = ctypes.c_int64()
    n = lib.colmap_points3d_count(path.encode(), ctypes.byref(total_track))
    if n < 0:
        return cm.read_points3D_binary(path)
    tt = total_track.value
    ids = np.empty(n, np.uint64)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    toff = np.empty(n + 1, np.uint64)
    pairs = np.empty((max(tt, 1), 2), np.int32)
    rc = lib.colmap_points3d_read(
        path.encode(), _ptr(ids, ctypes.c_uint64),
        _ptr(xyz, ctypes.c_double), _ptr(rgb, ctypes.c_uint8),
        _ptr(err, ctypes.c_double), _ptr(toff, ctypes.c_uint64),
        _ptr(pairs, ctypes.c_int32))
    if rc != 0:
        return cm.read_points3D_binary(path)
    out = {}
    for i in range(n):
        a, b = int(toff[i]), int(toff[i + 1])
        out[int(ids[i])] = cm.ColmapPoint3D(
            int(ids[i]), xyz[i], rgb[i], float(err[i]),
            pairs[a:b, 0].copy(), pairs[a:b, 1].copy())
    return out


def read_images_binary(path: str) -> Dict[int, cm.ColmapImage]:
    lib = load_library()
    p2d = ctypes.c_int64()
    nb = ctypes.c_int64()
    n = lib.colmap_images_count(path.encode(), ctypes.byref(p2d),
                                ctypes.byref(nb))
    if n < 0:
        return cm.read_images_binary(path)
    ids = np.empty(n, np.int32)
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cam = np.empty(n, np.int32)
    names = ctypes.create_string_buffer(int(nb.value))
    offs = np.empty(n + 1, np.uint64)
    xys = np.empty((max(p2d.value, 1), 2), np.float64)
    p3d = np.empty(max(p2d.value, 1), np.int64)
    rc = lib.colmap_images_read(
        path.encode(), _ptr(ids, ctypes.c_int32),
        _ptr(qvec, ctypes.c_double), _ptr(tvec, ctypes.c_double),
        _ptr(cam, ctypes.c_int32), names,
        _ptr(offs, ctypes.c_uint64), _ptr(xys, ctypes.c_double),
        _ptr(p3d, ctypes.c_int64))
    if rc != 0:
        return cm.read_images_binary(path)
    name_list = names.raw.split(b"\x00")[:n]
    out = {}
    for i in range(n):
        a, b = int(offs[i]), int(offs[i + 1])
        out[int(ids[i])] = cm.ColmapImage(
            int(ids[i]), qvec[i], tvec[i], int(cam[i]),
            name_list[i].decode("utf-8"), xys[a:b].copy(),
            p3d[a:b].copy())
    return out


def save_gaussian_ply(path: str, xyz, features_dc, features_rest,
                      opacity, scaling, rotation) -> bool:
    """The Gaussian-PLY writer of ``data/ply.py``, in C++; whether the file
    was written."""
    lib = load_library()
    n = xyz.shape[0]
    features_dc = np.asarray(features_dc)
    features_rest = np.asarray(features_rest)
    if features_dc.ndim == 2:  # flat model-store layout (see data/ply.py)
        features_dc = features_dc.reshape(n, 1, 3)
    if features_rest.ndim == 2:
        features_rest = features_rest.reshape(n, -1, 3)
    f_dc = features_dc.transpose(0, 2, 1).reshape(n, -1)
    f_rest = features_rest.transpose(0, 2, 1).reshape(n, -1)
    attrs = np.ascontiguousarray(np.concatenate(
        [np.asarray(xyz), np.zeros((n, 3), np.float32), f_dc, f_rest,
         np.asarray(opacity).reshape(n, 1), np.asarray(scaling),
         np.asarray(rotation)], axis=1).astype(np.float32))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rc = lib.gaussian_ply_write(path.encode(),
                                _ptr(attrs, ctypes.c_float), n,
                                f_dc.shape[1], f_rest.shape[1])
    return rc == 0


def read_files_parallel(paths, n_threads: int = 8):
    """Read whole files concurrently; a list of bytes (None for a file that
    cannot be opened)."""
    lib = load_library()
    sizes = np.array([lib.file_size(p.encode()) for p in paths], np.int64)
    bufs = [np.empty(max(int(s), 0), np.uint8) for s in sizes]
    c_paths = (ctypes.c_char_p * len(paths))(
        *[p.encode() for p in paths])
    c_bufs = (ctypes.POINTER(ctypes.c_uint8) * len(paths))(
        *[_ptr(b, ctypes.c_uint8) for b in bufs])
    lib.read_files_parallel(c_paths, c_bufs,
                            _ptr(sizes, ctypes.c_int64), len(paths),
                            n_threads)
    return [bytes(b) if s >= 0 else None for b, s in zip(bufs, sizes)]
