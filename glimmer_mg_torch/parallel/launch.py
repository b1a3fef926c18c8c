"""Start a world of ranks on this machine, as a launcher (torchrun) does.

``run_local(argv, n)`` starts ``n`` processes of ``python argv...``, each
with the environment a launcher gives its ranks (``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port: ``rank_env``), so that
``parallel.mesh.init_distributed()`` joins them into one world; a
``{rank}`` in an argument becomes the rank's number. It waits
for all of them within ``timeout`` seconds. When one fails or the time
runs out, it kills the others by their process ids and raises with the
end of each rank's output.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listened on a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, n: int, port: int, env=None) -> dict:
    """The environment a launcher gives rank ``rank`` of ``n`` on this
    machine, whose rank 0 serves the rendezvous on ``port``: ``env`` (this
    process's when None) with the launcher's variables set."""
    out = dict(os.environ if env is None else env)
    out.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n), RANK=str(rank),
               LOCAL_RANK=str(rank))
    return out


def run_local(argv, n: int, *, timeout: float, env=None,
              cwd=None) -> list[str]:
    """Run ``n`` ranks of ``[sys.executable, *argv]``; returns each rank's
    output (stdout and stderr), in rank order. Raises RuntimeError when a
    rank exits non-zero or the ranks outlast ``timeout`` seconds; no rank
    outlives the call."""
    port = free_port()
    expired = False
    with tempfile.TemporaryDirectory(prefix="gmt_ranks_") as logs:
        procs, files = [], []
        try:
            for r in range(n):
                fh = open(os.path.join(logs, f"rank{r}.log"), "w+")
                files.append(fh)
                procs.append(subprocess.Popen(
                    [sys.executable, *(a.replace("{rank}", str(r))
                                       for a in argv)], stdout=fh,
                    stderr=subprocess.STDOUT, cwd=cwd,
                    env=rank_env(r, n, port, env)))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]  # every rank, each time
                if None not in codes or any(codes):
                    break
                expired = time.monotonic() > deadline
                if expired:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:  # exact PIDs, never by pattern
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for fh in files:
            fh.seek(0)
            outs.append(fh.read())
            fh.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        what = f"timed out after {timeout} s" if expired else "failed"
        raise RuntimeError(
            f"ranks {bad} of {n} {what} (exit codes "
            f"{[p.returncode for p in procs]}):\n"
            + "\n".join(f"--- rank {r} ---\n{outs[r][-4000:]}" for r in bad))
    return outs
