"""One process a card for a cell on several chips.

``launch(chips, argv, t0)`` starts ``perfbench/run.py`` with ``argv`` once
a rank, each with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, a ``tcp://`` rendezvous on a free local port) and the
launcher's start time, so that every rank's set-up counts from it. Every
rank's standard error passes through; the first rank's standard output
is held and its last line returned once every rank has ended well. The
ranks gather their peak memory and trace summaries to the first rank
themselves (``run.py``). A rank that fails, or outlives ``DEADLINE_S``,
ends the others and the launch, with no result.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"
DEADLINE_S = 1150.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(chips: int, argv: list, t0: float):
    """(exit code, the first rank's last line or None)."""
    port = free_port()
    threads = max(1, (os.cpu_count() or chips) // chips)
    procs = []
    for rank in range(chips):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(chips),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(chips),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PERFBENCH_T0=repr(t0), OMP_NUM_THREADS=str(threads))
        procs.append(subprocess.Popen(
            [sys.executable, str(RUN), *argv], env=env,
            stdout=subprocess.PIPE if rank == 0 else subprocess.DEVNULL,
            text=True))
    out = ""
    try:
        out = procs[0].communicate(timeout=DEADLINE_S)[0]
        end = time.time() + 60
        for p in procs[1:]:
            p.wait(timeout=max(1.0, end - time.time()))
    except subprocess.TimeoutExpired:
        print("launch: a rank outlived its deadline", file=sys.stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        print(f"launch: ranks exited {codes}", file=sys.stderr)
        return 1, None
    lines = out.strip().splitlines()
    if not lines:
        print("launch: the first rank printed no result", file=sys.stderr)
        return 1, None
    return 0, lines[-1]
