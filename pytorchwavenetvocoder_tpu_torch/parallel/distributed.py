"""Data parallelism over processes: one rank per device.

Counterpart of ``pytorchwavenetvocoder_tpu/parallel/distributed.py`` (the
launcher's environment) and of the data axis of its ``parallel/mesh.py``.
Where the JAX package lays a ``data`` mesh axis over the devices of one
program, the port runs one process per device with ``torch.distributed``:

- ``initialize_distributed`` wires a process started by a launcher
  (torchrun, or SLURM's srun) into its process group; with no launcher in
  the environment it does nothing, as in JAX;
- ``spawn_local`` starts the ranks itself where the caller asked for
  ``--n_devices N`` and no launcher did: the single-host mesh of the JAX
  CLIs;
- ``clamp_ranks`` cuts ``--n_devices N`` with ``--device cuda`` to the
  cards this host has, with a warning, as the JAX CLIs cut it to their
  local devices;
- ``rank_device`` maps ``--device`` to a rank's device, ``choose_backend``
  picks the collective backend, ``all_reduce_mean`` is ``pmean`` and
  ``shard_rows`` is ``shard_global_batch``.

Any other refusal raises with its reason, and nothing falls back to the
CPU: a host with no card at all refuses ``--device cuda``.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

#: Seconds a collective, or the rendezvous, may wait for the other ranks
#: before it fails the run (a dead rank must not hang the others).
COLLECTIVE_TIMEOUT_S = 600.0

BACKENDS = ("auto", "nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """Where one rank runs: its rank and the world's size, its rank and the
    rank count on this host, its device, and how many of this host's ranks
    share that device (1 where each has its own)."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    device: torch.device
    ranks_on_device: int

    @classmethod
    def alone(cls, device) -> "RankInfo":
        """A one-process run on ``device``, in no process group."""
        return cls(0, 1, 0, 1, torch.device(device), 1)


def launcher_env(env=None) -> tuple[int, int, int, int] | None:
    """(rank, world, local_rank, local_world) from a launcher's variables,
    or None where no launcher set them.

    torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` (rendezvous at ``MASTER_ADDR``/``MASTER_PORT``);
    SLURM's srun sets ``SLURM_PROCID``, ``SLURM_NTASKS``,
    ``SLURM_LOCALID`` and ``SLURM_NTASKS_PER_NODE`` (a one-task SLURM job
    counts as no launcher, as in JAX).
    """
    env = os.environ if env is None else env
    if "WORLD_SIZE" in env and "RANK" in env:
        world = int(env["WORLD_SIZE"])
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        return (int(env["RANK"]), world, int(env.get("LOCAL_RANK", 0)),
                local_world)
    if int(env.get("SLURM_NTASKS", "1") or 1) > 1 and "SLURM_PROCID" in env:
        world = int(env["SLURM_NTASKS"])
        # SLURM_NTASKS_PER_NODE may read "4" or "4(x2)": tasks on each node
        per_node = env.get("SLURM_NTASKS_PER_NODE", str(world))
        local_world = int(per_node.split("(")[0].split(",")[0])
        return (int(env["SLURM_PROCID"]), world,
                int(env.get("SLURM_LOCALID", 0)), local_world)
    return None


def clamp_ranks(n: int, device_arg: str) -> int:
    """The ranks ``--n_devices n`` starts on this host: with ``--device cuda``
    (a rank per card) at most ``torch.cuda.device_count()``, with the JAX
    train CLI's warning; else ``n``.  A host with no card is not clamped:
    ``rank_device`` refuses it."""
    dev = torch.device(device_arg)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if 0 < count < n:
            logging.warning("requested %d devices but only %d available.",
                            n, count)
            return count
    return n


def rank_device(device_arg: str, local_rank: int,
                local_world: int) -> torch.device:
    """The device of this host's rank ``local_rank`` of ``local_world``.

    ``cuda``: rank r on ``cuda:r``; raises when this host's ranks outnumber
    ``torch.cuda.device_count()``.  ``cuda:K``: every rank on that card
    (the one-card plumbing check; logged).  ``cpu``: every rank on the CPU.
    """
    dev = torch.device(device_arg)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"--device {device_arg}: ranks run on cpu, cuda or "
                         "cuda:K")
    count = torch.cuda.device_count()
    if dev.index is None:
        if local_world > count:
            raise ValueError(
                f"--device cuda with {local_world} ranks on this host needs "
                f"{local_world} CUDA devices, but torch.cuda.device_count() "
                f"is {count}; pass --device cuda:K to run every rank on one "
                "card (a plumbing check, no scaling)")
        return torch.device("cuda", local_rank)
    if dev.index >= count:
        raise ValueError(f"--device {device_arg}: torch.cuda.device_count() "
                         f"is {count}")
    if local_world > 1:
        logging.info("all %d ranks of this host run on %s (one card shared: "
                     "checks the plumbing, not the scaling).", local_world,
                     dev)
    return dev


def choose_backend(backend: str, device: torch.device,
                   ranks_on_device: int) -> str:
    """The collective backend for ranks on ``device``: ``auto`` is NCCL
    where every rank has its own CUDA device and gloo on the CPU.  NCCL
    refuses two ranks on one GPU and serves no CPU tensors, so both raise,
    ``auto`` included, naming ``--dist_backend gloo`` (whose all-reduce
    takes CUDA tensors)."""
    if backend not in BACKENDS:
        raise ValueError(f"--dist_backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("--dist_backend nccl needs CUDA devices; the "
                             "ranks run on the CPU: use --dist_backend gloo")
        return "gloo"
    if backend == "gloo":
        return "gloo"
    if ranks_on_device > 1:
        raise ValueError(f"{ranks_on_device} ranks share {device}, and NCCL "
                         "refuses two ranks on one GPU: pass --dist_backend "
                         "gloo")
    return "nccl"


def _sharing(device_arg: str, local_world: int) -> int:
    """How many of this host's ranks share each one's device under
    ``--device device_arg``: all of them on the CPU or a named card
    (``cuda:K``), else one (``cuda``: a card each)."""
    dev = torch.device(device_arg)
    return local_world if dev.type == "cpu" or dev.index is not None else 1


def setup_rank(rank: int, world: int, local_rank: int, local_world: int,
               device_arg: str, backend: str | None,
               store: dist.Store | None = None,
               timeout_s: float = COLLECTIVE_TIMEOUT_S) -> RankInfo:
    """Place this process on its device (``torch.cuda.set_device`` before
    any CUDA work) and, unless ``backend`` is None (a rank with no
    collectives, such as a decode rank), join the process group through
    ``store``, else at the launcher's ``env://`` rendezvous.  Every
    collective of the group fails after ``timeout_s``."""
    device = rank_device(device_arg, local_rank, local_world)
    shared = _sharing(device_arg, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    info = RankInfo(rank, world, local_rank, local_world, device, shared)
    if backend is None:
        return info
    name = choose_backend(backend, device, shared)
    kw = dict(backend=name, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = "env://"
    if name == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    logging.info("rank %d / %d on %s, backend %s", rank, world, device, name)
    return info


def initialize_distributed(device_arg: str = "cuda",
                           backend: str | None = "auto",
                           timeout_s: float = COLLECTIVE_TIMEOUT_S
                           ) -> RankInfo | None:
    """Join the process group a launcher set up (``launcher_env``; the
    ``env://`` rendezvous at ``MASTER_ADDR``:``MASTER_PORT``, which torchrun
    sets and a SLURM job exports); returns this rank's ``RankInfo``, or
    None (and does nothing) where no launcher is configured.  ``backend``
    None places the rank without a group."""
    found = launcher_env()
    if found is None:
        return None
    rank, world, local_rank, local_world = found
    if backend is not None and not (os.environ.get("MASTER_ADDR")
                                    and os.environ.get("MASTER_PORT")):
        raise ValueError(f"rank {rank} of {world}: the rendezvous needs "
                         "MASTER_ADDR and MASTER_PORT in the environment "
                         "(torchrun sets them; export them under srun)")
    return setup_rank(rank, world, local_rank, local_world, device_arg,
                      backend, timeout_s=timeout_s)


def shutdown() -> None:
    """Leave the process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(rank: int, world: int, device_arg: str, backend: str | None,
                store_path: str | None, timeout_s: float, out_dir: str,
                fn: Callable, args: tuple) -> None:
    """A spawned rank: set up, run ``fn(info, *args)``, pickle its result
    (or its traceback) to ``out_dir``."""
    try:
        if torch.device(device_arg).type == "cpu":
            # the ranks split the cores (torchrun sets OMP_NUM_THREADS=1)
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        store = (dist.FileStore(store_path, world)
                 if store_path is not None else None)
        info = setup_rank(rank, world, rank, world, device_arg, backend,
                          store=store, timeout_s=timeout_s)
        try:
            result = fn(info, *args)
        finally:
            shutdown()
        with open(os.path.join(out_dir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)   # the parent reports the traceback


def spawn_local(n: int, fn: Callable, args: Sequence = (),
                device_arg: str = "cuda", backend: str | None = "auto",
                timeout_s: float = COLLECTIVE_TIMEOUT_S,
                deadline_s: float | None = None) -> list[Any]:
    """Run ``fn(info, *args)`` in ``n`` new processes on this host, ranks
    0..n-1, and return their results in rank order.

    The ranks start with the ``spawn`` method (a fresh interpreter: never a
    fork of a process whose CUDA may be up) and rendezvous on a
    ``FileStore`` in a temporary directory (no port to collide on); ``fn``
    must be importable by name and its arguments and result picklable.
    ``backend`` None runs the ranks without a process group.  A rank that
    fails fails the call: the others are stopped and the error carries the
    failed ranks' tracebacks.  A collective waits at most ``timeout_s``;
    where ``deadline_s`` is given, ranks still running after it are stopped
    and the call fails.  Every process started here has ended when it
    returns.
    """
    if n < 1:
        raise ValueError(f"spawn_local needs n >= 1, got {n}")
    # refuse a device or backend the ranks cannot have before any starts
    probe = rank_device(device_arg, 0, n)
    if backend is not None:
        choose_backend(backend, probe, _sharing(device_arg, n))
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="wnv_ranks_")
    store = os.path.join(tmp, "store") if backend is not None else None
    procs = []
    try:
        for r in range(n):
            p = ctx.Process(target=_rank_entry, name=f"rank{r}",
                            args=(r, n, device_arg, backend, store,
                                  timeout_s, tmp, fn, tuple(args)))
            p.start()
            procs.append(p)
        end = None if deadline_s is None else time.monotonic() + deadline_s
        live = list(procs)
        while live:
            left = None if end is None else end - time.monotonic()
            if left is not None and left <= 0:
                raise RuntimeError(f"ranks {[p.name for p in live]} still "
                                   f"running after {deadline_s:.0f} s")
            multiprocessing.connection.wait([p.sentinel for p in live],
                                            timeout=left)
            for p in [p for p in live if p.exitcode is not None]:
                live.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(_rank_failure(tmp, n, p))
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"result-{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_failure(tmp: str, n: int, failed) -> str:
    msg = [f"{failed.name} exited with code {failed.exitcode}"]
    for r in range(n):
        path = os.path.join(tmp, f"error-{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                msg.append(f"--- rank {r} ---\n{f.read()}")
    return "\n".join(msg)


def world_size() -> int:
    """The process group's size, 1 where this process joined none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 where it joined no process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank, where this process joined a group."""
    if dist.is_initialized():
        dist.barrier()


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> None:
    """``pmean`` in place: every tensor becomes its mean over the ranks.

    The tensors go into one flat bucket per dtype (in their order), one
    all-reduce sums each bucket, it is divided by the world size and copied
    back.  Every rank ends with the same bits.  Outside a process group it
    leaves the tensors as they are."""
    if not dist.is_initialized():
        return
    world = dist.get_world_size()
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        bucket = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(bucket, op=dist.ReduceOp.SUM)
        bucket.div_(world)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(bucket[offset:offset + n].view_as(t))
            offset += n


def shard_rows(batch, rank: int, world: int):
    """This rank's block of rows of every array in ``batch`` (a tuple or
    list of arrays sharing their leading dimension): rows
    ``[rank * B / world, (rank + 1) * B / world)``, the shard the JAX
    ``shard_global_batch`` puts on device ``rank`` of the data axis.
    Raises unless the world divides B."""
    B = len(batch[0])
    if B % world:
        raise ValueError(f"a batch of {B} rows does not split over {world} "
                         "ranks")
    per = B // world
    return type(batch)(a[rank * per:(rank + 1) * per] for a in batch)
