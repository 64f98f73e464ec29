"""Start one process a rank of a ``torch.distributed`` group on this host.

:func:`run_ranks` starts ``world_size`` copies of

    python -m repro_torch.launch.ranks TARGET RANK WORLD BACKEND STORE ARGS...

each of which joins the default process group from a ``FileStore`` at
``STORE`` (a fresh file, so runs that share a host share no TCP port),
calls ``TARGET`` (``module:function``) with ``ARGS`` as strings, and
destroys the group.  The parent waits for every rank, kills the rest as
soon as one fails or the time runs out, and raises with the failed
ranks' last output.

The backend is ``"nccl"``, for one GPU a rank, unless the caller asks
for ``"gloo"``: ranks on the CPU or sharing one card (gloo reaches a CUDA
tensor through the host).  Nothing switches from one to the other: NCCL
with two ranks on one card fails, and the failure shows.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

__all__ = ["run_ranks"]

_SRC = str(Path(__file__).resolve().parents[2])


def run_ranks(target: str, world_size: int, *, backend: str = "nccl",
              args=(), timeout: float = 600.0, env: dict | None = None,
              paths=(), store_dir: str | None = None) -> list:
    """Run ``target`` on ``world_size`` ranks; returns each rank's
    standard output.  ``paths`` go on the ranks' ``PYTHONPATH`` after
    the port's ``src``; ``env`` adds variables.  Raises
    ``RuntimeError`` if a rank exits non-zero or the ranks outlast
    ``timeout`` seconds (every rank is killed first)."""
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp, \
            contextlib.ExitStack() as stack:
        store = os.path.join(tmp, "store")
        child_env = dict(os.environ, **(env or {}))
        child_env["PYTHONPATH"] = os.pathsep.join(
            [_SRC, *map(str, paths)]
            + ([child_env["PYTHONPATH"]] if child_env.get("PYTHONPATH")
               else []))
        logs = [stack.enter_context(open(os.path.join(tmp, f"rank{r}.log"),
                                         "w+"))
                for r in range(world_size)]
        procs = []
        deadline = time.monotonic() + timeout
        try:
            for r in range(world_size):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.ranks",
                     target, str(r), str(world_size), backend, store,
                     *map(str, args)],
                    stdout=logs[r], stderr=subprocess.STDOUT, env=child_env))
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            running = [r for r, p in enumerate(procs) if p.poll() is None]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
        if failed or running:
            what = [f"rank {r} exited {procs[r].returncode}" for r in failed]
            if running:
                what.append(f"ranks {running} "
                            + ("stopped" if failed
                               else f"outlasted {timeout:.0f} s"))
            tails = "\n".join(f"--- rank {r} ---\n{outs[r][-3000:]}"
                              for r in failed + running)
            raise RuntimeError(f"{target}: {', '.join(what)}\n{tails}")
        return outs


def main(argv: list) -> int:
    from importlib import import_module

    import torch.distributed as dist

    target, rank, world, backend, store, *args = argv
    module, _, fn = target.partition(":")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=int(rank), world_size=int(world))
    try:
        getattr(import_module(module), fn)(*args)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
