"""Stamp each line a command prints with the seconds since it started.

A probe, not a path of the port: it shows where the time of a long run
such as ``chip_smoke.py`` goes, as the gaps between the records its
phases print when they end.  From the repository root:

    python3 src/repro_torch/probe_timeline.py python3 chip_smoke.py

prints ``<seconds> <line>`` for every line of the command's standard
output (its standard error passes through), then one JSON line
``{"timeline": [[label, seconds since the line before], ...],
"total_s": ...}`` over the lines that are JSON objects, each labelled by
its ``"phase"`` or else its first key, and exits with the command's code.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time


def label(line: str) -> str | None:
    """The label of a JSON object line, None for any other line."""
    try:
        rec = json.loads(line)
    except ValueError:
        return None
    if not isinstance(rec, dict) or not rec:
        return None
    return str(rec.get("phase", next(iter(rec))))


def main(argv: list) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    last, timeline = 0.0, []
    with subprocess.Popen(argv, stdout=subprocess.PIPE, text=True) as proc:
        for line in proc.stdout:
            t = time.perf_counter() - t0
            print(f"{t:.1f} {line}", end="", flush=True)
            name = label(line)
            if name is not None:
                timeline.append([name, t - last])
                last = t
    print(json.dumps({"timeline": timeline,
                      "total_s": time.perf_counter() - t0}), flush=True)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
