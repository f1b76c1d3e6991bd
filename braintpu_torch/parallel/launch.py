"""Start the ranks of a sharded run: one process per rank.

The reference runs one process over many devices and needs no launcher.
Here every rank is a process of its own that runs the same function (SPMD)
inside a ``torch.distributed`` process group:

* ``nccl`` between distinct cards;
* ``gloo`` on the CPU (the counterpart of the reference's virtual CPU
  devices), and for ranks that share one card (NCCL refuses two ranks on
  the same card).

:func:`spawn` starts the processes with the ``spawn`` start method, sets up
the group (the backend from the devices, :func:`choose_backend`; a
``file://`` rendezvous in a fresh temporary directory), runs ``fn(*args)``
on every rank and returns the ranks' results in rank order.  An exception in any rank stops every rank and
raises here with that rank's traceback (a rank's ``SystemExit`` exits here
with its message); a rank that dies without a word (killed, out of memory)
raises too.  ``fn`` must be importable by name (a
module-level function): the child imports its module, so bodies live in
this package, not in test modules.

Inside a rank, :func:`rank_device` is the rank's device.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

__all__ = ["choose_backend", "free_tcp_init", "init_rank", "rank_device", "spawn"]

_rank_device: Optional[torch.device] = None


def rank_device() -> torch.device:
    """This rank's device (set by :func:`spawn`; the CPU outside a spawned rank)."""
    return _rank_device if _rank_device is not None else torch.device("cpu")


def choose_backend(devices: Sequence[torch.device]) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({str(d) for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def free_tcp_init() -> str:
    """``tcp://127.0.0.1:<port>`` on a port free at the time of the call."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def init_rank(device: Union[str, torch.device], backend: str, init_method: str, rank: int,
              world_size: int) -> None:
    """Make this process rank ``rank`` of ``world_size`` on ``device`` (what
    :func:`spawn` does in each child; call it directly to run a process as a
    rank of a group it starts itself, e.g. one NCCL rank)."""
    global _rank_device
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _rank_device = device
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)


def _worker(rank: int, world: int, device: torch.device, backend: str, init_method: str,
            threads: int, fn: Callable, args: tuple, results) -> None:
    try:
        if threads > 0:
            torch.set_num_threads(threads)
        init_rank(device, backend, init_method, rank, world)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException as e:  # reported to the parent, which stops every rank
        exit_message = str(e.code) if isinstance(e, SystemExit) else None
        results.put((rank, False, (exit_message, traceback.format_exc())))
        results.close()
        results.join_thread()
        os._exit(1)
    dist.destroy_process_group()


def spawn(
    fn: Callable,
    world_size: int,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    args: tuple = (),
    timeout_s: Optional[float] = None,
    threads: Optional[int] = None,
) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks; returns their results.

    Args:
      devices: one device per rank (default: the CPU for every rank);
        ``nccl`` when each rank has a card of its own, else ``gloo``.
      timeout_s: raise when the ranks have not all reported by then.
      threads: CPU threads per rank (default: the cores shared out).
    """
    devs = [torch.device(d) for d in (devices or ["cpu"] * world_size)]
    if len(devs) != world_size:
        raise ValueError(f"{len(devs)} devices for {world_size} ranks")
    backend = choose_backend(devs)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world_size)
    tmpdir = tempfile.mkdtemp(prefix="braintpu_torch_rdzv_")
    init_method = "file://" + os.path.join(tmpdir, "rendezvous")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, name=f"braintpu_torch-rank{r}",
                         args=(r, world_size, devs[r], backend, init_method, threads, fn, args,
                               results))
             for r in range(world_size)]
    got: dict = {}
    error = exit_message = None
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(got) < world_size and error is None:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive() and p.exitcode != 0]
                if dead:
                    error = (f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                             "before it reported a result")
                elif deadline is not None and time.monotonic() > deadline:
                    error = f"the ranks did not all finish within {timeout_s} s"
                continue
            if ok:
                got[rank] = payload
            else:
                exit_message, tb = payload
                error = f"rank {rank} of {world_size} ({backend}) raised:\n{tb}"
    finally:
        for p in procs:
            if len(got) < world_size and p.is_alive():  # a failure, a timeout or an interrupt
                p.terminate()
        for p in procs:
            if p.pid is None:
                continue
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmpdir, ignore_errors=True)
    if exit_message is not None:  # a rank's SystemExit (a command's refusal) exits here too
        raise SystemExit(exit_message)
    if error is not None:
        raise RuntimeError(error)
    return [got[r] for r in range(world_size)]
