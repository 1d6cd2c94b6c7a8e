"""Launch helpers for multi-process runs (port of `lego_loam_tpu/launch.py`).

- `init_from_args(...)`: join the process group (`distributed.
  init_distributed`); arguments left unset come from the variables torchrun
  sets (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK). Call it
  before building a pipeline, so the pipeline sees the world.
- `spawn_local(...)`: runs N copies of a script as OS processes on this
  machine, each one rank with those variables set. It is how the
  multi-rank paths run without a cluster: gloo ranks on the CPU, or one
  NCCL rank per visible card.

A rank drives one device, so `spawn_local` refuses `devices_per_process`
other than 1 (the reference gives each JAX process several devices).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time


def init_from_args(coordinator=None, num_processes=None, process_id=None, device="cuda"):
    """Join the process group; returns this rank's device. Unset arguments
    fall back to MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK (the
    device's index to LOCAL_RANK)."""
    from .distributed import init_distributed

    if coordinator is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    return init_distributed(coordinator, num_processes, process_id, device=device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local(script: str, n_processes: int, devices_per_process: int = 1, extra_args=(),
                timeout: float = 600.0):
    """Run `script` as n_processes ranks on this machine, each with
    MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK set (the script
    calls `launch.init_from_args()`). Returns each rank's output (stdout and
    stderr together); raises RuntimeError with a rank's last output where it
    exits non-zero or outlives `timeout` seconds, after stopping every rank."""
    if devices_per_process != 1:
        raise ValueError(f"spawn_local: a rank drives one device, not {devices_per_process}")
    port = _free_port()
    deadline = time.monotonic() + timeout
    procs, logs = [], []
    try:
        for rank in range(n_processes):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n_processes),
                       RANK=str(rank), LOCAL_RANK=str(rank))
            # a file, not a pipe: a rank that fills a pipe nobody reads yet
            # would stall the collectives of the others
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen([sys.executable, script, *extra_args], env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT, text=True))
        # the first rank to fail is reported: the others may only be
        # waiting for it at a collective
        while any(p.poll() is None for p in procs):
            for rank, p in enumerate(procs):
                if p.poll():
                    raise RuntimeError(f"rank {rank} exited {p.returncode}:\n{_tail(logs[rank])}")
            if time.monotonic() > deadline:
                rank = next(r for r, p in enumerate(procs) if p.poll() is None)
                raise RuntimeError(f"rank {rank} ran past {timeout} s:\n{_tail(logs[rank])}")
            time.sleep(0.05)
        for rank, p in enumerate(procs):
            if p.returncode:
                raise RuntimeError(f"rank {rank} exited {p.returncode}:\n{_tail(logs[rank])}")
        return [_tail(f, None) for f in logs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


def _tail(f, n=4000):
    f.seek(0)
    out = f.read()
    return out if n is None else out[-n:]
