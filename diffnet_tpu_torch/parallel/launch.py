"""Run a function on every rank of a process group of spawned processes.

``run_ranks(fn, world, args)`` starts `world` processes (the ``spawn``
method), initialises ``torch.distributed`` in each (rank r of `world`, the
given backend, a ``file://`` rendezvous), calls ``fn(rank, world, *args)``
there and returns the ranks' results, rank 0's first. `fn` must be a
function at the top level of a module the children can import; what it
returns travels back pickled, by value (the standard library's
``multiprocessing``, not ``torch.multiprocessing``'s shared-memory
tensors). The arguments go to the ranks through one pickle file: handed to
``Process`` they go down a pipe that blocks the parent, for anything above
the pipe's buffer, until the child has started up, so the ranks would
start one after another. Any rank that raises, dies or outlives `timeout`
makes ``run_ranks`` raise (the others are killed); nothing is retried.

Torchrun-launched programs (``parallel.scaling``) initialise their process
group from torchrun's environment instead.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["run_ranks", "rank_device"]


def rank_device(backend: str, device: str | torch.device) -> torch.device:
    """This rank's device: for CUDA, card ``rank % device_count`` under
    NCCL (one rank a card) and `device` itself under gloo (ranks may share
    a card); the CPU as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if backend == "nccl":
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return device


def _rank_main(fn, rank, world, backend, init_method, args_path, results,
               threads, timeout):
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)   # written by run_ranks
        if threads is not None:
            torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported, then the rank exits 1
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn, world: int, args: tuple = (), *, backend: str = "gloo",
              init_method: str | None = None, timeout: float = 120.0,
              threads: int | None = None) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each run
    in its own spawned process of one process group.

    backend: ``"gloo"`` or ``"nccl"`` (NCCL: rank r on card ``r %
    device_count``); init_method: the rendezvous, a fresh ``file://`` path
    by default; timeout: seconds for the whole run (and the process group's
    own timeout); threads: ``torch.set_num_threads`` in each rank."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        if init_method is None:
            init_method = "file://" + os.path.join(tmp, "rendezvous")
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(args, f)
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, init_method,
                                   args_path, results, threads, timeout),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        out: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            # drain the queue before joining: a child blocks on exit until
            # what it put is read
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"run_ranks: {world - len(out)} of "
                                       f"{world} ranks still running after "
                                       f"{timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise RuntimeError(f"run_ranks: ranks {dead} exited "
                                           "without a result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} of {world} "
                                       f"failed:\n{payload}")
                out[rank] = payload
            for r, p in enumerate(procs):
                p.join(max(1.0, deadline - time.monotonic()))
                if p.exitcode != 0:
                    raise RuntimeError(f"run_ranks: rank {r} exited with "
                                       f"{p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            results.close()
    return [out[r] for r in range(world)]
