"""The ranks of a cell that runs on several cards. Rank 0 is the run's own
process: it spawns ranks 1 to n-1, one process a card, and every rank joins
the port's process group on localhost (``parallel/mesh.initialize_distributed``:
NCCL on the cards, gloo on the CPU) and a gloo group on the host, over which
rank 0 tells the others, before each step, whether the window goes on.

A watchdog thread in rank 0 ends the run, with exit code 1 and no result
line, where a rank ends with an error or the group outlasts its limit; a
rank whose parent is gone ends itself. A one-card cell runs as ``Solo``,
which tells, gathers and waits for nothing.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import socket
import sys
import threading
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

POLL_S = 0.5
HOST_TIMEOUT = datetime.timedelta(seconds=900)


def planted(plant):
    """``plant()``, a context manager that a run is made inside on every
    rank (a test's or a calibration's fault), or nothing."""
    return plant() if plant is not None else contextlib.nullcontext()


class Solo:
    """The one rank of a one-card cell."""

    rank, world = 0, 1

    def tell(self, go: bool) -> None:
        pass

    def max(self, value: int) -> int:
        return value

    def barrier(self) -> None:
        pass

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _cores(cpus: list[int]) -> list[list[int]]:
    """``cpus`` grouped by the physical core they are threads of (sysfs's
    ``thread_siblings_list``), in the order of their first CPU."""
    cores: dict[str, list[int]] = {}
    for c in sorted(cpus):
        try:
            key = Path(f"/sys/devices/system/cpu/cpu{c}/topology/thread_siblings_list").read_text()
        except OSError:
            key = str(c)
        cores.setdefault(key.strip(), []).append(c)
    return list(cores.values())


def _bind(cpus) -> None:
    """Every thread of this process onto ``cpus``; threads started later
    inherit it from the thread that starts them."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except (ProcessLookupError, PermissionError):
            pass  # a thread that has ended meanwhile


def pin(rank: int, world: int) -> int:
    """Bind this process to rank ``rank``'s share of the physical cores it
    may run on, whole cores in order, so that no two ranks' threads share a
    core or move between shares; its intra-op threads as many as its CPUs,
    as one card of a one-card machine has. Returns the CPUs bound."""
    cores = _cores(list(os.sched_getaffinity(0)))
    per = len(cores) // world
    if per:
        _bind([c for core in cores[rank * per:(rank + 1) * per] for c in core])
    cpus = sorted(os.sched_getaffinity(0))
    torch.set_num_threads(max(1, len(cpus) if per else len(cpus) // world))
    print(f"[ranks] rank {rank} on CPUs {cpus}", file=sys.stderr, flush=True)
    return len(cpus)


class Group:
    """This rank's end of a several-card cell: the port's process group
    and the host's gloo group beside it, the rank bound to its share of the
    host's cores (``pin``)."""

    def __init__(self, rank: int, world: int, device_type: str, port: int):
        from constructionsceneposeestimation_tpu_torch.parallel import mesh

        self.rank, self.world = rank, world
        self._unpinned = os.sched_getaffinity(0), torch.get_num_threads()
        pin(rank, world)
        dev = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
        self.device = mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, device=dev)
        self.host = dist.new_group(backend="gloo", timeout=HOST_TIMEOUT)
        self._flag = torch.zeros(1, dtype=torch.int32)

    def tell(self, go: bool) -> None:
        """Rank 0: whether the others run one more step."""
        self._flag.fill_(int(go))
        dist.broadcast(self._flag, 0, group=self.host)

    def follow(self, step) -> int:
        """Ranks 1 to n-1: ``step()`` for as long as rank 0 says go on; the
        steps run."""
        n = 0
        while True:
            dist.broadcast(self._flag, 0, group=self.host)
            if not int(self._flag):
                return n
            step()
            n += 1

    def max(self, value: int) -> int:
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host)
        return int(t)

    def barrier(self) -> None:
        dist.barrier(group=self.host)

    def gather(self, x: torch.Tensor) -> torch.Tensor | None:
        """Every rank's ``x`` concatenated in rank order, in host memory on
        rank 0; None on the others."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts).cpu() if self.rank == 0 else None

    def close(self) -> None:
        """Leave the groups; the process runs on all its CPUs again."""
        dist.destroy_process_group()
        _bind(self._unpinned[0])
        torch.set_num_threads(self._unpinned[1])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _end_with_parent(parent: int) -> None:
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(1)


def _rank_main(rank, world, device_type, port, parent, target, args):
    """Ranks 1 to n-1: standard output goes to standard error, so that rank
    0's result is the run's only line there. A rank leaves the group as
    rank 0 does, then ends at once: the interpreter's own teardown of the
    port's CUDA and NCCL state is not waited for."""
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    threading.Thread(target=_end_with_parent, args=(parent,), daemon=True).start()
    try:
        group = Group(rank, world, device_type, port)
        target(group, *args)
        group.close()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stderr.flush()
    os._exit(0)


class Ranks:
    """Rank 0's hold on ranks 1 to n-1: spawned on entry, each running
    ``target(group, *args)``; watched until they have ended; ended on exit
    where they have not. ``limit_s`` bounds the group's life from entry
    (``limit`` sets it again from now)."""

    def __init__(self, world: int, device_type: str, target, args: tuple, limit_s: float):
        self.world, self.device_type = world, device_type
        self.target, self.args = target, args
        self.deadline = time.time() + limit_s
        self.procs: list = []
        self._done = threading.Event()

    def __enter__(self) -> "Ranks":
        ctx = multiprocessing.get_context("spawn")
        self.port = _free_port()
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, self.world, self.device_type, self.port, os.getpid(),
                                        self.target, self.args))
                      for r in range(1, self.world)]
        for p in self.procs:
            p.start()
        threading.Thread(target=self._watch, daemon=True).start()
        return self

    def group(self) -> Group:
        """Rank 0's ``Group``, once every rank has joined."""
        return Group(0, self.world, self.device_type, self.port)

    def limit(self, seconds: float) -> None:
        self.deadline = time.time() + seconds

    def _watch(self) -> None:
        while not self._done.wait(POLL_S):
            failed = [(r, p.exitcode) for r, p in enumerate(self.procs, 1)
                      if p.exitcode not in (None, 0)]
            if failed or time.time() > self.deadline:
                why = (f"rank {failed[0][0]} ended with exit code {failed[0][1]}" if failed
                       else "the ranks outlasted their time limit")
                print(f"perfbench: {why}; the run ends with no result", file=sys.stderr,
                      flush=True)
                self._end()
                os._exit(1)

    def _end(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(10.0)

    def join(self, timeout: float) -> None:
        """Wait for ranks 1 to n-1 to end by themselves; raises where one
        does not within ``timeout`` seconds or ends with an error."""
        end = time.time() + timeout
        for p in self.procs:
            p.join(max(0.0, end - time.time()))
        bad = [(r, p.exitcode) for r, p in enumerate(self.procs, 1) if p.exitcode != 0]
        self._done.set()
        if bad:
            raise RuntimeError(f"ranks did not end cleanly (rank, exit code): {bad}")

    def __exit__(self, *exc) -> None:
        self._done.set()
        self._end()
