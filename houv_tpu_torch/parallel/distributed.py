"""Process groups over torch.distributed (counterpart of
``houv_tpu/parallel/distributed.py``).

One process per rank. The backend is NCCL when every rank has a card of its
own, gloo on the CPU, or the backend the caller names: gloo on CUDA tensors
is how two ranks share one card, which NCCL refuses. ``init_distributed``
joins a job that ``torchrun`` (or the caller) describes and is a no-op for a
job of one process, as ``initialize_multihost`` is. ``launch`` starts the
ranks of a job from one process; they meet through a file in a temporary
directory of their own (a ``file://`` rendezvous), not a TCP port. A port
picked free and released before rank 0 binds it can be taken in between
by any socket bound to port 0, such as another job's gloo listener, and a
rank that then connects to it as its store breaks that other job's
collectives.
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from houv_tpu_torch._device import resolve_device
from houv_tpu_torch.parallel.mesh import make_mesh


def choose_backend(device: torch.device, local_ranks: int,
                   backend: str | None = None) -> str:
    """NCCL for CUDA, gloo for the CPU, or ``backend``. NCCL with more
    ranks on this host than visible cards, or on the CPU, raises
    ValueError: it never switches to gloo by itself."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices only")
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise ValueError(
                f"nccl needs a card per rank: {local_ranks} ranks on this "
                f"host, {cards} visible cards (ranks that share a card take "
                "backend='gloo')")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    return backend


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """The rank's device: ``cuda:<local_rank>``, shared round-robin where
    ranks outnumber the cards (gloo only), or the CPU."""
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(rank: int | None = None, world_size: int | None = None,
                     local_rank: int | None = None,
                     init_method: str | None = None,
                     device: str | torch.device = "cuda",
                     backend: str | None = None,
                     timeout: float | None = None) -> torch.device:
    """Join the job and return this rank's device. Arguments left None come
    from torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` (the rendezvous from ``MASTER_ADDR`` and
    ``MASTER_PORT``). A job of one process initialises nothing and returns
    ``device``; in a job already joined it returns the rank's device. On
    CUDA it sets the rank's card as the current one."""
    env = os.environ
    dev = resolve_device(device)
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    if world_size <= 1 and not dist.is_initialized():
        return dev
    rank = int(env.get("RANK", 0)) if rank is None else rank
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", world_size))
    return _join(dev, rank, world_size, local_rank, local_ranks, backend,
                 init_method or "env://", timeout)


def _join(dev, rank, world_size, local_rank, local_ranks, backend,
          init_method, timeout):
    """Set the rank's card and create the process group (even of one
    rank), unless the process has one. Returns the rank's device."""
    if not dist.is_initialized():
        backend = choose_backend(dev, local_ranks, backend)
    dev = rank_device(dev, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    return dev


def global_mesh(axis: str = "data", device: str | torch.device = "cuda"):
    """The mesh over every rank of the job (the world group)."""
    return make_mesh(axis=axis, device=device)


def _rank_main(rank, fn, args, nprocs, init_method, device, backend, threads,
               timeout, results):
    """One spawned rank: torchrun's environment (no ``MASTER_ADDR``: the
    ranks meet at ``init_method``), the process group (of one rank too),
    a barrier, ``fn``, rank 0's result on ``results``, and an exit that
    skips the interpreter's shutdown. The barrier keeps a rank whose ``fn``
    raises at once from closing its connections while a peer still makes
    its own, which would fail the peer first and report its connection
    error in place of the rank's. The exit: a rank whose work is done and
    whose process group is destroyed still died now and then in the
    interpreter's shutdown ("terminate called without an active
    exception", no Python frame: a C++ thread still joinable when its
    owner was destroyed), and the launch failed on that exit code. A
    rank that raises leaves its process group to its exit, after the
    launcher's error file is written."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs))
    if device.type == "cpu":
        torch.set_num_threads(threads)
    dev = _join(device, rank, nprocs, rank, nprocs, backend, init_method,
                timeout)
    dist.barrier(device_ids=[dev.index] if dev.type == "cuda"
                 and dist.get_backend() == "nccl" else None)
    out = fn(*args)
    if rank == 0:
        results.put(out)
    dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def launch(fn, nprocs: int, device: str | torch.device = "cuda",
           backend: str | None = None, args: tuple = (),
           timeout: float | None = None):
    """Run ``fn(*args)`` on ``nprocs`` ranks, each a process started with
    the ``spawn`` method (CUDA forbids fork), joined through a rendezvous
    file in a new temporary directory (removed when the job ends); returns
    rank 0's result (which must pickle, and hold no CUDA tensor: the rank
    is gone when it is read). A rank that raises makes this raise (the
    other ranks are ended). With ``timeout`` (seconds) the ranks are killed
    and TimeoutError raised when the job outlives it, and the process group's collectives time out after it.
    CPU ranks share the caller's threads. On CUDA the kernels are built
    here first, so that the ranks do not all run nvcc at once."""
    dev = resolve_device(device)
    if nprocs < 1:
        raise ValueError(f"nprocs {nprocs} < 1")
    choose_backend(dev, nprocs, backend)
    if dev.type == "cuda":
        from houv_tpu_torch import kernels

        kernels.load()
    results = mp.get_context("spawn").SimpleQueue()
    threads = max(1, torch.get_num_threads() // nprocs)
    rendezvous = tempfile.mkdtemp(prefix="houv_rendezvous_")
    try:
        return _run_job(fn, args, nprocs, dev, backend, threads, timeout,
                        results, f"file://{os.path.join(rendezvous, 'store')}")
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)


def _run_job(fn, args, nprocs, dev, backend, threads, timeout, results,
             init_method):
    """``launch``'s ranks, from their start to rank 0's result."""
    job = mp.start_processes(
        _rank_main, args=(fn, args, nprocs, init_method, dev, backend,
                          threads, timeout, results),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout is None else (
        datetime.datetime.now() + datetime.timedelta(seconds=timeout))
    out = None
    try:
        # rank 0's result is drained while the ranks run: a large one would
        # otherwise block its writer on the pipe and the join
        while not job.join(timeout=0.2):
            if not results.empty():
                out = results.get()
            if deadline is not None and datetime.datetime.now() > deadline:
                raise TimeoutError(
                    f"{nprocs} ranks still running after {timeout} s")
    finally:
        for proc in job.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    if not results.empty():
        out = results.get()
    return out
