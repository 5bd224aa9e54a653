"""Process-group set-up for the port's SPMD parallelism (counterpart of
gcm_tpu/parallel/distributed.py).

JAX runs one program over many devices; here each rank is one process
holding one shard, joined by torch.distributed: NCCL between CUDA
devices, gloo between CPU ranks (and between several ranks sharing one
card, which NCCL refuses). Nothing on a machine announces a cluster, so
the caller names the coordinator (host:port), the world size and its
rank.

- `initialize_multihost`: init_process_group, idempotent as JAX's is.
- `global_mesh(tp)`: the (dp, tp) mesh over every rank of the world.
- `world_of_one`: a context with a one-rank world (tcp on a free local
  port), for a single process that runs the sharded code paths.
- `spawn_world(fn, world, ...)`: `world` processes started with the
  spawn method, each in the world, each calling fn(*args); returns each
  rank's result as numpy. A rank's exception, or the deadline, ends every
  rank and raises in the caller. fn must be importable by name (a
  module-level function), since the ranks start from a fresh import;
  `parallel/dryrun.py` holds the per-rank bodies that the tests and
  chip_smoke.py run.
"""

from __future__ import annotations

import contextlib
import datetime
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.parallel.mesh import make_mesh

TIMEOUT_S = 600.0


def _backend(device_type: str, backend: str | None) -> str:
    if device_type == "cuda":
        resolve_device(None)  # raises without a card
        return backend or "nccl"
    if device_type != "cpu":
        raise ValueError(f"unknown device_type {device_type!r}")
    if backend not in (None, "gloo"):
        raise ValueError(f"CPU ranks talk over gloo, not {backend!r}")
    return "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device_type: str = "cuda",
                         backend: str | None = None,
                         timeout_s: float = TIMEOUT_S) -> None:
    """Join the world: coordinator_address "host:port" (None: the env://
    variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), num_processes
    ranks, this one process_id. Backend: NCCL for device_type "cuda" (the
    default; raises without a card) unless given, gloo for "cpu". A CUDA
    rank takes card process_id mod the card count. Does nothing when the
    process is already in a world."""
    if dist.is_initialized():
        return
    backend = _backend(device_type, backend)
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    kw = {}
    if num_processes is not None:
        kw = dict(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, init_method=init,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def global_mesh(tp: int = 1, device_type: str = "cuda"):
    """The (dp, tp) mesh over every rank of the world: dp spans processes
    (and hosts), tp groups neighbouring ranks."""
    return make_mesh(tp=tp, device_type=device_type)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def world_of_one(device_type: str = "cuda", backend: str | None = None):
    """A world of one rank for the body of the with statement, then
    none."""
    if dist.is_initialized():
        raise RuntimeError("this process is already in a world")
    initialize_multihost(f"localhost:{free_port()}", 1, 0,
                         device_type=device_type, backend=backend)
    try:
        yield
    finally:
        dist.destroy_process_group()


def to_numpy(tree):
    """Tensors to numpy arrays through dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree) \
            if not hasattr(tree, "_fields") else \
            type(tree)(*(to_numpy(v) for v in tree))
    return tree


def _rank_main(fn, rank, world, port, device_type, backend, threads, args,
               out_q):
    try:
        if device_type == "cpu":
            torch.set_num_threads(threads)
        initialize_multihost(f"localhost:{port}", world, rank,
                             device_type=device_type, backend=backend)
        out_q.put((rank, True, to_numpy(fn(*args))))
    except Exception:  # reported to the parent, which fails the world
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _PortTaken(RuntimeError):
    """The free port picked for the world's store was taken meanwhile."""


def spawn_world(fn, world: int, device_type: str = "cuda", args=(),
                backend: str | None = None, threads: int = 1,
                timeout_s: float = TIMEOUT_S) -> list:
    """Run fn(*args) on `world` spawned ranks; returns [rank 0's result,
    rank 1's, ...] with tensors as numpy. device_type "cuda" (the default)
    puts rank r on card r mod count and raises without a card; backend
    defaults as `initialize_multihost`'s (pass "gloo" for several ranks
    on one card). CPU ranks use `threads` intra-op threads each. A store
    port taken between its pick and the bind (another world starting at
    once) is picked again, twice at most."""
    _backend(device_type, backend)
    for attempt in range(3):
        try:
            return _spawn_once(fn, world, device_type, args, backend,
                               threads, timeout_s)
        except _PortTaken:
            if attempt == 2:
                raise


def _spawn_once(fn, world, device_type, args, backend, threads, timeout_s):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, device_type, backend,
                               threads, args, out_q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout_s

    def take(timeout):
        rank, ok, value = out_q.get(timeout=timeout)
        if not ok:
            if "EADDRINUSE" in value or "ddress already in use" in value:
                raise _PortTaken(value)
            raise RuntimeError(f"spawn_world: rank {rank} failed:\n{value}")
        results[rank] = value

    try:
        while len(results) < world:
            try:
                take(1.0)
                continue
            except queue_mod.Empty:
                pass
            if any(p.exitcode is not None for p in procs):
                try:  # a rank's last result may still be in the pipe
                    while len(results) < world:
                        take(2.0)
                except queue_mod.Empty:
                    pass
                gone = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results}
                if gone:
                    raise RuntimeError(f"spawn_world: ranks exited with no "
                                       f"result (exit codes {gone})")
            if time.monotonic() > deadline:
                missing = sorted(set(range(world)) - set(results))
                raise RuntimeError(f"spawn_world: no result from ranks "
                                   f"{missing} within {timeout_s} s")
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
        out_q.cancel_join_thread()
        out_q.close()
    return [results[r] for r in range(world)]


__all__ = ["initialize_multihost", "global_mesh", "world_of_one",
           "spawn_world", "free_port", "to_numpy"]
