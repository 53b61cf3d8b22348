"""A cell of several cards never hangs and leaves nothing behind: where
rank 1 fails, or hangs past the group's limit, the run exits non-zero with
no result line, and rank 1's process is gone (each such run a process of
its own, on two gloo ranks on the CPU, since the watchdog ends the process
it runs in); after a run, rank 0's threads run on all its CPUs again."""

import contextlib
import os
import subprocess
import sys
import time

import pytest
import torch.distributed as dist

import perfbench_tiny as tiny

SHARDED = "world2-proxy-512.train-ddp4-b128"
RUN = """
import sys
sys.path.insert(0, {tests!r})
import perfbench_tiny as tiny
import test_perfbench_ranks as plants
from harness import training
training.SETUP_LIMIT_S = 20.0
result, checks = tiny.run(tiny.tiny({cell!r}), plant=getattr(plants, {plant!r}))
print(result)
"""


def _rank_1(then):
    if dist.is_initialized() and dist.get_rank() == 1:
        with open(os.environ["PERFBENCH_RANK_PID"], "w") as f:
            f.write(str(os.getpid()))
        then()
    return contextlib.nullcontext()


def _raise():
    raise RuntimeError("a planted failure of rank 1")


def fail_on_rank_1():
    return _rank_1(_raise)


def hang_on_rank_1():
    return _rank_1(lambda: time.sleep(3600))


def _gone(pid: int, within: float) -> bool:
    end = time.time() + within
    while time.time() < end:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.2)
    return False


@pytest.mark.parametrize("plant", ["fail_on_rank_1", "hang_on_rank_1"])
def test_a_failed_or_hung_rank_ends_the_run(plant, tmp_path):
    pid_file = tmp_path / "rank1.pid"
    env = dict(os.environ, PERFBENCH_RANK_PID=str(pid_file))
    code = RUN.format(tests=str(tiny.BENCH / "tests"), cell=SHARDED, plant=plant)
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout, out.stdout
    assert time.time() - t0 < 240
    assert "the run ends with no result" in out.stderr, out.stderr[-3000:]
    assert _gone(int(pid_file.read_text()), 10.0)


def test_rank_0_gets_all_its_cpus_back():
    """Rank 0 is bound to its share of the cores while its group lives;
    afterwards every thread of the process, those started meanwhile too,
    runs on all the CPUs it had, with as many intra-op threads."""
    import torch

    before = os.sched_getaffinity(0), torch.get_num_threads()
    result, checks = tiny.run(tiny.tiny(SHARDED))
    assert result["correct"], checks
    tasks = os.listdir("/proc/self/task")
    assert all(os.sched_getaffinity(int(t)) == before[0] for t in tasks)
    assert torch.get_num_threads() == before[1]
