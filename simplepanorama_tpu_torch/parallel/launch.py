"""Starting a world of ranks on one machine.

Each rank is a process of its own (parallel/multihost.py). ``run_world``
starts ``n`` copies of a Python command with SPT_COORDINATOR (localhost
and a free port), SPT_NUM_PROCS and SPT_PROC_ID set, waits for all of
them with a time limit, and kills every one that is left when a rank
fails or the limit passes, so no process outlives the call. The command
calls multihost.initialize() first.

    python -c "from simplepanorama_tpu_torch.parallel.launch import \\
        run_world; print(run_world(['my_script.py'], 2))"
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple


def free_port() -> int:
    """A TCP port on localhost that was free when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(argv: Sequence[str], n: int, timeout_s: float = 600.0,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[Tuple[int, str]]:
    """Run ``sys.executable *argv`` as ranks 0..n-1 of one world. Returns
    [(exit code, merged stdout and stderr)] in rank order; a rank killed
    because another failed, or because ``timeout_s`` passed, has a
    negative code (the signal), and its output says so at the end."""
    base = dict(os.environ if env is None else env)
    base["SPT_COORDINATOR"] = f"127.0.0.1:{free_port()}"
    base["SPT_NUM_PROCS"] = str(n)
    logs = [tempfile.TemporaryFile("w+") for _ in range(n)]
    procs = []
    why = ""
    try:
        for rank in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=logs[rank],
                stderr=subprocess.STDOUT, cwd=cwd,
                env=dict(base, SPT_PROC_ID=str(rank))))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                why = "\n[killed: another rank failed]"
                break
            if time.monotonic() > deadline:
                why = f"\n[killed: the world passed {timeout_s} s]"
                break
            time.sleep(0.1)
    finally:
        killed = []
        for p in procs:
            killed.append(p.poll() is None)
            if killed[-1]:
                p.kill()
            p.wait()
    out = []
    for p, log, k in zip(procs, logs, killed):
        log.seek(0)
        out.append((p.returncode, log.read() + (why if k else "")))
        log.close()
    return out
