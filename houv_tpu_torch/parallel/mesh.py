"""Meshes of ranks, exact collectives and the sharded solves (counterpart of
``houv_tpu/parallel/mesh.py``).

The JAX package's ``shard_map`` over a device mesh becomes one process per
rank over torch.distributed: a ``Mesh`` names this rank's place on each
axis and the process group along it. Every rank holds the same global
batch (each builds the same seeded split), takes its rows of it, and the
results come back gathered, so each rank ends with the whole batch's
answer.

Gathers are exact: one ``broadcast`` per rank, or ``all_gather`` where the
backend has it for the tensor's device (gloo has no gather for CUDA
tensors). A gather built as the SUM all-reduce of a zero-filled buffer
would turn a -0.0 entry into +0.0.

The sharded solves give each pair the transform, rmse and retry decision
the unsharded ``houv_solve`` gives it, bit for bit: the restarts of the
whole batch are drawn on the CPU and sliced, and the objective's mean runs
over the whole batch's B·K replicas (``divisor``), so Adam sees one
gradient scale at every mesh width. (The JAX package instead folds the
shard index into each shard's key, so a pair's restarts depend on the
mesh.)
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from houv_tpu_torch._device import resolve_device
from houv_tpu_torch.data.pipeline import shard_rows
from houv_tpu_torch.solvers.houv import (
    HOUVConfig,
    houv_candidate_pools,
    init_params,
    pick_restart,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a job: for each axis its size, this rank's
    index along it and the process group of the ranks that differ from it
    only there (None where the axis has one rank). ``device`` is the
    rank's device."""

    axes: tuple
    sizes: tuple
    indices: tuple
    groups: tuple
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def index(self, axis: str = "data") -> int:
        return self.indices[self.axes.index(axis)]

    def group(self, axis: str = "data"):
        return self.groups[self.axes.index(axis)]

    @property
    def rank(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0


def _mesh_device(device) -> torch.device:
    """``device`` on this rank: ``cuda`` (the default) is the rank's card,
    the current one (``init_distributed`` sets it)."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_mesh(device: str | torch.device | None = None,
               axis: str = "data") -> Mesh:
    """The mesh of this process alone, with no process group: its rows are
    the whole batch and every collective over it returns its input. A
    trainer or a sweep given no mesh runs on this one."""
    return Mesh((axis,), (1,), (0,), (None,), _mesh_device(device))


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device: str | torch.device | None = None) -> Mesh:
    """A 1-D mesh over every rank of the job: the world group, even of one
    rank (its collectives then run through the backend). Without a process
    group it is ``local_mesh``. ``n_devices`` must equal the job's size (1
    without a process group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} ranks in a job of {world} (start the "
            "ranks with launch or torchrun)")
    if not dist.is_initialized():
        return local_mesh(device, axis)
    return Mesh((axis,), (world,), (dist.get_rank(),), (dist.group.WORLD,),
                _mesh_device(device))


def make_mesh_2d(n_data: int, n_restart: int,
                 device: str | torch.device | None = None) -> Mesh:
    """A (data, restart) mesh for the HOUV sweep: pairs shard over 'data',
    each pair's restarts over 'restart'. Rank = data·n_restart + restart,
    as ``np.reshape`` lays out the JAX package's devices. Every rank of
    the job calls it (it creates the groups)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data * n_restart != world:
        raise ValueError(f"a {n_data} x {n_restart} mesh in a job of "
                         f"{world} ranks")
    rank = dist.get_rank() if world > 1 else 0
    di, ri = divmod(rank, n_restart)
    data_group = restart_group = None
    # every rank creates every group, in one order
    if n_data > 1:
        for r in range(n_restart):
            g = dist.new_group([d * n_restart + r for d in range(n_data)])
            if r == ri:
                data_group = g
    if n_restart > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_restart + r for r in range(n_restart)])
            if d == di:
                restart_group = g
    return Mesh(("data", "restart"), (n_data, n_restart), (di, ri),
                (data_group, restart_group), _mesh_device(device))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _has_all_gather(group, t: torch.Tensor) -> bool:
    backend = dist.get_backend(group)
    return backend == "nccl" or (backend == "gloo" and t.device.type == "cpu")


def group_gather_rows(t: torch.Tensor, group, index: int) -> torch.Tensor:
    """The tensors of one shape of ``group``'s ranks (this one the
    ``index``-th), concatenated on the leading axis in rank order, bit for
    bit: ``all_gather`` where the backend has one for the tensor's device,
    else a broadcast a rank."""
    t = t.contiguous()
    ranks = dist.get_process_group_ranks(group)
    if _has_all_gather(group, t):
        parts = [torch.empty_like(t) for _ in ranks]
        dist.all_gather(parts, t, group=group)
    else:
        parts = []
        for i, src in enumerate(ranks):
            buf = t if i == index else torch.empty_like(t)
            dist.broadcast(buf, src=src, group=group)
            parts.append(buf)
    return torch.cat(parts, 0)


def all_gather_rows(t: torch.Tensor, mesh: Mesh,
                    axis: str = "data") -> torch.Tensor:
    """The ranks' tensors of one shape along ``axis``, concatenated on the
    leading axis in rank order, bit for bit, on every rank."""
    group = mesh.group(axis)
    if group is None:
        return t
    return group_gather_rows(t, group, mesh.index(axis))


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str = "data",
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``axis`` (a new tensor; ``t`` as it is where the
    axis has one rank)."""
    group = mesh.group(axis)
    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def sum_int(value: int, mesh: Mesh, axis: str = "data") -> int:
    """A Python integer summed over ``axis``."""
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    return int(all_reduce(t, mesh, axis))


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows of a batch (a dict of arrays or tensors, or one):
    ValueError where a leading axis is not divisible by the mesh width."""
    return shard_rows(batch, mesh.index(axis), mesh.shape[axis])


def barrier(mesh: Mesh, axis: str = "data") -> None:
    """Wait for every rank along ``axis`` (nothing where it has no group)."""
    group = mesh.group(axis)
    if group is not None:
        dist.barrier(group=group)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers broadcast in place to every rank.
    Returns the module."""
    if mesh.size > 1:
        for t in module.state_dict().values():
            dist.broadcast(t, src=0)
    return module


def average_gradients(params, mesh: Mesh, axis: str = "data") -> None:
    """Each parameter's ``.grad`` replaced by its mean over ``axis``: one
    SUM all-reduce of the flattened gradients, divided by the width."""
    group = mesh.group(axis)
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= mesh.shape[axis]
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def data_parallel_grads(loss_fn, params, batch, mesh: Mesh,
                        axis: str = "data"):
    """Per-rank gradients of ``loss_fn(params, batch)`` (``params`` a dict
    of tensors), averaged over ``axis``; the loss averaged likewise.
    Returns (loss, grads), the inside of a data-parallel step."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for v, g in zip(leaves.values(), grads):
        v.grad = g
    average_gradients(leaves.values(), mesh, axis)
    loss = all_reduce(loss.detach(), mesh, axis) / mesh.shape[axis]
    return loss, {k: v.grad for k, v in leaves.items()}


# ---------------------------------------------------------------------------
# sharded solves
# ---------------------------------------------------------------------------

def _batch_params(src, cfg: HOUVConfig, params0, generator):
    """The whole batch's restarts, on the CPU: ``params0`` or a draw from
    ``generator`` (seed 0 when None)."""
    if params0 is None:
        generator = generator or torch.Generator().manual_seed(0)
        params0 = init_params(generator, src.shape[0], cfg.kernel,
                              cfg.lattice_init, cfg.two_bracket,
                              device="cpu")
    return params0


def rank_rows(n: int, mesh: Mesh, axis: str = "data") -> slice:
    """This rank's rows of a batch of ``n`` (or its columns of ``n``
    restarts, on 'restart'): ValueError unless the axis divides it."""
    width = mesh.shape[axis]
    if n % width:
        what = "kernel" if axis == "restart" else "batch"
        raise ValueError(f"{what} {n} not divisible by the {axis} axis's "
                         f"{width} ranks")
    i = mesh.index(axis)
    return slice(i * n // width, (i + 1) * n // width)


def sharded_houv_pools(src: torch.Tensor, tgt: torch.Tensor, mesh: Mesh,
                       cfg: HOUVConfig = HOUVConfig(),
                       params0: dict | None = None,
                       generator: torch.Generator | None = None,
                       axis: str = "data"):
    """This rank's pairs of the batch through ``houv_candidate_pools``:
    src, tgt (B, N, 3), the whole batch, B divisible by the mesh width;
    the restarts those of the whole batch (``params0``, or drawn from
    ``generator``), the objective's mean over all B·K replicas. Returns
    (the rank's rows, its pools)."""
    bsz = src.shape[0]
    rows = rank_rows(bsz, mesh, axis)
    params0 = _batch_params(src, cfg, params0, generator)
    dev = mesh.device
    local = {k: v[rows].to(dev) for k, v in params0.items()}
    pools = houv_candidate_pools(
        src[rows].to(dev), tgt[rows].to(dev), cfg, params0=local,
        device=dev, divisor=bsz * cfg.kernel)
    return rows, pools


def sharded_houv_solve(src: torch.Tensor, tgt: torch.Tensor, mesh: Mesh,
                       cfg: HOUVConfig = HOUVConfig(),
                       params0: dict | None = None,
                       generator: torch.Generator | None = None,
                       axis: str = "data") -> dict:
    """The sweep's batch split by pairs over the mesh (the reference's
    run_test.sh 4-way shard as one job): each rank solves B/W pairs, and
    every rank returns the whole batch's transform (B, 4, 4) and rmse (B,)
    and n_retry summed over the ranks, each equal to ``houv_solve``'s on
    the whole batch with the same restarts."""
    _, pools = sharded_houv_pools(src, tgt, mesh, cfg, params0, generator,
                                  axis)
    transform, rmse = pick_restart(*pools[:3], cfg)
    return {"transform": all_gather_rows(transform, mesh, axis),
            "rmse": all_gather_rows(rmse, mesh, axis),
            "n_retry": sum_int(pools[3], mesh, axis)}


def sharded_houv_solve_2d(src: torch.Tensor, tgt: torch.Tensor, mesh: Mesh,
                          cfg: HOUVConfig = HOUVConfig(),
                          params0: dict | None = None,
                          generator: torch.Generator | None = None) -> dict:
    """The sweep over a (data, restart) mesh: each rank runs
    kernel/n_restart restarts of B/n_data pairs, its slice of the whole
    batch's restarts (the 26 lattice axes partitioned across the restart
    shards, not repeated). The retry mask comes from the best over every
    restart shard (a MIN all-reduce), so the shards of a pair agree on
    whether the retry windows run, and n_retry is counted over 'data'
    only. The pick gathers the restart shards' pools and takes
    ``houv_solve``'s rule: the least loss, ties to the earlier window, then
    to the lower restart. ``two_bracket`` and ``window_select='consensus'``
    read a pair's whole restart axis, so a split one refuses them, as the
    JAX package's does. Returns what ``sharded_houv_solve`` returns."""
    if mesh.shape["restart"] > 1:
        if cfg.two_bracket:
            raise NotImplementedError(
                "two_bracket splits the restart axis itself — use the 1-D "
                "mesh")
        if cfg.window_select != "loss":
            raise NotImplementedError(
                "window_select='consensus' counts agreement across the "
                "FULL restart axis — use the 1-D mesh (pairs-only "
                "sharding)")
    bsz = src.shape[0]
    rows = rank_rows(bsz, mesh, "data")
    cols = rank_rows(cfg.kernel, mesh, "restart")
    lk = cols.stop - cols.start
    params0 = _batch_params(src, cfg, params0, generator)
    dev = mesh.device
    local = {k: v[rows, cols].to(dev) for k, v in params0.items()}

    def cross_shard_best(best):
        return all_reduce(best, mesh, "restart", dist.ReduceOp.MIN)

    pool_loss, pool_r, pool_t, n_retry = houv_candidate_pools(
        src[rows].to(dev), tgt[rows].to(dev),
        dataclasses.replace(cfg, kernel=lk), params0=local, device=dev,
        divisor=bsz * cfg.kernel, best_reduce=cross_shard_best)
    transform, rmse = pick_across_restarts(pool_loss, pool_r, pool_t, lk,
                                           mesh, cfg)
    return {"transform": all_gather_rows(transform, mesh, "data"),
            "rmse": all_gather_rows(rmse, mesh, "data"),
            "n_retry": sum_int(n_retry, mesh, "data")}


def _gather_restarts(pool: torch.Tensor, lk: int, mesh: Mesh):
    """A pool (Bl, W·lk, ...) of each restart shard, window-major, gathered
    into the unsharded layout (Bl, W·K, ...): window w holds the restarts
    of shard 0, then of shard 1, ..."""
    n_restart = mesh.shape["restart"]
    if n_restart == 1:
        return pool
    bl, wk = pool.shape[:2]
    tail = pool.shape[2:]
    parts = all_gather_rows(pool[None], mesh, "restart")   # (R, Bl, W·lk, ...)
    parts = parts.reshape(n_restart, bl, wk // lk, lk, *tail)
    return parts.movedim(0, 2).reshape(bl, wk * n_restart, *tail)


def pick_across_restarts(pool_loss, pool_r, pool_t, lk: int, mesh: Mesh,
                         cfg: HOUVConfig):
    """``houv_solve``'s pick over the pools of every restart shard, each
    (Bl, W·lk, ...): gathered into the unsharded layout, the least loss,
    ties to the earlier window, then to the lower restart (within a window
    that is the JAX package's rule, mesh.py:221-229: the least over the
    shards, then the lowest shard); ``cfg`` as ``pick_restart`` reads it.
    Returns (transform (Bl, 4, 4), rmse (Bl,)), the same on every restart
    shard."""
    return pick_restart(*(_gather_restarts(p, lk, mesh)
                          for p in (pool_loss, pool_r, pool_t)), cfg)
