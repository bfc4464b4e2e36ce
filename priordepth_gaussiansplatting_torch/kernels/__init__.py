"""The hand-written CUDA kernels: launch, launch counts, error checks.

Each wrapper in ``ops/`` calls :func:`launch` for a CUDA tensor; that is the
only place a kernel is launched and the only place its count grows. A launch
is counted under its label: the kernel's name, or another name where one
kernel serves two places on the path (``gather_rows`` builds the forward's
pair table, ``gather_rows_bwd`` is the backward's sort-back), or the name of
a source's second entry point (``composite_fwd_bands`` and
``composite_bwd_bands``, K6: the compositor over one band of the tile grid;
``expand_tiles``, K7: the pair expansion without attributes or cull).
``project_fwd`` is K8, the projection of a store that autograd does not
record.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# The sources in csrc/, one library each.
KERNELS = ("expand_pairs", "gather_rows", "composite_fwd", "composite_bwd",
           "segment_reduce", "project_fwd")
# What the launch counts are kept under.
LABELS = KERNELS + ("gather_rows_bwd", "composite_fwd_bands",
                   "composite_bwd_bands", "expand_tiles")

_launches = dict.fromkeys(LABELS, 0)

ptr = ctypes.c_void_p
i32 = ctypes.c_int
f32 = ctypes.c_float


def launch_counts() -> dict:
    """{label: launches since the last reset}."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch(name: str, argtypes, *args, label: str | None = None,
           entry: str | None = None) -> None:
    """Launch kernel `name` through its C entry point ``<entry>_launch``
    (default: `name`) on the current stream and count it under `label`
    (default: the entry).

    `args` are the C entry point's arguments without the trailing stream:
    tensors are passed as their data pointers. Raises if the launch was
    refused (the C function returns cudaGetLastError())."""
    entry = entry or name
    fn = build.entry(name, f"{entry}_launch", list(argtypes) + [ptr])
    stream = torch.cuda.current_stream().cuda_stream
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*cargs, stream)
    if rc != 0:
        msg = getattr(build.load(name), f"{name}_error")(rc).decode()
        raise RuntimeError(f"{entry}: CUDA launch failed ({rc}): {msg}")
    _launches[label or entry] += 1


def check_cuda(name: str, **tensors) -> None:
    """Raise unless every tensor lies on one CUDA device and is contiguous."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
