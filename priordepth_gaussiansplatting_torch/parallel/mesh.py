"""The rank grid of multi-rank training over ``torch.distributed``
(counterpart of the JAX package's ``parallel/mesh.py``).

  data  — camera data parallelism: each data rank renders its own camera;
          parameter gradients are averaged over the data group.
  gauss — Gaussian sharding: each gauss rank holds a contiguous block of
          C / n_gauss rows of the fixed-capacity store (its shard) and their
          Adam moments; projection, Adam and densification run on the
          shard, and the projected attributes are all-gathered over the
          gauss group for rasterization.

World rank r is grid position (r // n_gauss, r % n_gauss), as the JAX
package reshapes its device list into (n_data, n_gauss). Ranks are
processes. The collective backend follows the device: NCCL for the card,
gloo for the CPU; a CUDA run without NCCL raises.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
GAUSS_AXIS = "gauss"


def backend_for(device) -> str:
    """The collective backend of `device`: NCCL for CUDA, gloo for the
    CPU. Raises if the card's backend is missing (no silent gloo)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available: a CUDA run needs it")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {dev}")


class Mesh:
    """This process's place in the (n_data, n_gauss) grid and the groups
    it reduces over. Every process must build the Mesh, in the same order
    relative to other collectives: it creates every gauss group (one per
    data row) and every data group (one per gauss column)."""

    def __init__(self, n_data: int, n_gauss: int, device=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised")
        world = dist.get_world_size()
        if world != n_data * n_gauss:
            raise ValueError(f"world size {world} != n_data {n_data} x "
                             f"n_gauss {n_gauss}")
        self.device = resolve_device(device)
        self.backend = dist.get_backend()
        if self.backend != backend_for(self.device):
            raise RuntimeError(f"process group backend {self.backend} does "
                               f"not serve {self.device}")
        self.n_data, self.n_gauss = n_data, n_gauss
        self.rank = dist.get_rank()
        self.data_rank, self.gauss_rank = divmod(self.rank, n_gauss)
        self.gauss_group = self.data_group = None
        for d in range(n_data):
            g = dist.new_group([d * n_gauss + k for k in range(n_gauss)])
            if d == self.data_rank:
                self.gauss_group = g
        for k in range(n_gauss):
            g = dist.new_group([d * n_gauss + k for d in range(n_data)])
            if k == self.gauss_rank:
                self.data_group = g

    def group(self, axis: str):
        return self.gauss_group if axis == GAUSS_AXIS else self.data_group

    def axis_size(self, axis: str) -> int:
        return self.n_gauss if axis == GAUSS_AXIS else self.n_data

    def axis_rank(self, axis: str) -> int:
        return self.gauss_rank if axis == GAUSS_AXIS else self.data_rank


# --- collectives over one axis of the mesh ----------------------------------
# Every rank of the group must make the same calls in the same order.

def _gather_list(x: torch.Tensor, mesh: Mesh, axis: str) -> list:
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return parts


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of `x` over the axis (a new tensor). NCCL all-reduces; on gloo
    the ranks' tensors are gathered and added in rank order, so a CPU run
    is deterministic and every rank holds the same bits."""
    if mesh.backend == "nccl":
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group(axis))
        return y
    parts = _gather_list(x, mesh, axis)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Elementwise maximum of `x` over the axis (a new tensor)."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return y


class _AllGatherRows(torch.autograd.Function):
    """all_gather along dim 0 over one axis (JAX's ``all_gather(tiled=
    True)``). Its transpose sums the cotangent over the group and keeps
    this rank's rows: reduce-scatter on NCCL, a rank-order sum then the
    slice on gloo."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return torch.cat(_gather_list(x, mesh, axis))

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, rows = ctx.mesh, ctx.axis, ctx.rows
        if mesh.backend == "nccl":
            out = grad.new_empty((rows,) + tuple(grad.shape[1:]))
            dist.reduce_scatter_tensor(out, grad.contiguous(),
                                       op=dist.ReduceOp.SUM,
                                       group=mesh.group(axis))
            return out, None, None
        r = mesh.axis_rank(axis)
        return psum(grad, mesh, axis)[r * rows:(r + 1) * rows], None, None


def gather_world(value: int, mesh: Mesh) -> list:
    """`value` of every rank of the grid, in rank order (a collective over
    the whole world)."""
    x = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    parts = [torch.empty_like(x) for _ in range(mesh.n_data * mesh.n_gauss)]
    dist.all_gather(parts, x)
    return [int(p) for p in parts]


def all_gather_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Differentiable all_gather of `x` along dim 0 over `axis`, in rank
    order."""
    return _AllGatherRows.apply(x, mesh, axis)


def initialize_multihost(init_method: str | None = None,
                         world_size: int | None = None,
                         rank: int | None = None, device=None) -> bool:
    """Join a multi-process run: ``torch.distributed.init_process_group``
    with the backend of `device` (the card unless the caller names the
    CPU). Arguments default to the usual environment (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; ``env://``). Returns True if
    a process group was initialised, False for the single-process case (no
    arguments and none of those variables), which callers treat as rank 0
    of 1."""
    if (init_method is None and world_size is None and rank is None
            and not any(v in os.environ
                        for v in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))):
        return False
    dist.init_process_group(
        backend=backend_for(resolve_device(device)),
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return True


def _child(rank: int, world: int, backend: str, store_path: str,
           timeout_s: float | None, results, fn, args) -> None:
    try:
        if backend == "nccl":  # one rank per card: rank r on card r
            torch.cuda.set_device(rank)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            **({} if timeout_s is None else
               {"timeout": datetime.timedelta(seconds=timeout_s)}))
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(world: int, fn, *args, backend: str, store_dir: str,
          timeout: float | None = 120.0) -> list:
    """Run ``fn(rank, world, *args)`` in `world` fresh processes (the
    ``spawn`` start method) that share a process group over a FileStore
    in `store_dir`, and return their results in rank order. With NCCL,
    rank r runs on card r.

    `fn` and its arguments and result must pickle (`fn` by its import
    path). Raises RuntimeError with the child's traceback if any rank
    raises, and TimeoutError if the ranks have not all finished within
    `timeout` seconds (None: no deadline, and the process group's default
    timeout for a collective); either way every child is stopped before it
    returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store_path = os.path.join(store_dir,
                              f"store-{os.getpid()}-{time.time_ns()}")
    procs = [ctx.Process(target=_child, args=(r, world, backend, store_path,
                                              timeout, results, fn, args),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    out = {}

    def failure(rank, tb):
        return RuntimeError(f"spawn: rank {rank} failed:\n{tb}")

    try:
        while len(out) < world:
            left = 1.0 if deadline is None else deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world)) - set(out))
                raise TimeoutError(f"spawn: ranks {missing} did not finish "
                                   f"within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    try:  # a rank that raised has sent its traceback
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"spawn: ranks {dead} died") from None
                    if not ok:
                        raise failure(rank, value) from None
                    out[rank] = value
                continue
            if not ok:
                raise failure(rank, value)
            out[rank] = value
        for p in procs:
            # A rank that has sent its result only leaves its group.
            p.join(60.0 if deadline is None
                   else max(deadline - time.monotonic(), 0.01))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
