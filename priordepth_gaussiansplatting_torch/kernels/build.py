"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C entry point ``<name>_launch``
(pointers and the stream as ``void*``, sizes as ``int``) that returns
``cudaGetLastError()``, and ``<name>_error`` for the message; a source may
export a second form of its kernel under another ``<entry>_launch``. No PyTorch
header is included, so one source compiles in seconds. Libraries go to
``build/kernels/`` at the root of the checkout, named by a digest of the
source, the ``csrc/`` headers it includes and the flags, and are built at
first use. :func:`build` starts one nvcc per missing source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# No --use_fast_math (accurate expf/logf) and no multiply-add contraction,
# so the kernels round as their plain PyTorch versions do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources(path: Path, seen: list) -> list:
    """`path` and, depth first, every file of ``csrc/`` it includes with
    ``#include "..."``, each once."""
    if path not in seen:
        seen.append(path)
        for inc in re.findall(rb'^\s*#\s*include\s+"([^"]+)"',
                              path.read_bytes(), flags=re.M):
            _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    """Where kernel `name`'s library goes: named by a digest of its source,
    the headers it includes and the flags."""
    text = b"".join(p.read_bytes() for p in _sources(CSRC / f"{name}.cu", []))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names) -> dict:
    """Compile every listed kernel whose library is missing, in parallel.

    Returns {name: seconds spent compiling it} (0.0 when it was built
    already). The compiler's resource report (-Xptxas -v) is kept beside
    each library as ``<library>.ptxas.txt``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        Path(f"{out}.ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def ptxas_report(name: str) -> str:
    path = Path(f"{library_path(name)}.ptxas.txt")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if need be, with
    ``<name>_error`` declared."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        err = getattr(lib, f"{name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def entry(name: str, function: str, argtypes):
    """C function `function` of kernel `name`'s library, declared to take
    `argtypes` and return an int."""
    fn = getattr(load(name), function)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
