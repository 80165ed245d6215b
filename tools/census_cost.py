#!/usr/bin/env python3
"""Count what the verifier's census (``analysis/census.py``) costs a test
run: how many compiles run it, the seconds spent in it, and how many of
those runs repeat a body already censused on the same context (same
schedule, datapath, level, batch, aliasing and diagonal slots, padded
rotation count and chunk), which a memo of the verdict would skip.

    python3 tools/census_cost.py [pytest arguments ...]

Runs ``python -m pytest`` with the given arguments (``-n`` workers
included) and this module as a plugin; each pytest process sums its own
census runs into a file of a temporary directory, and the script prints
the totals as one JSON line.  Ranks that a test spawns are other
processes and are not counted.  Seconds are host seconds summed over the
pytest processes, not wall time.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
_ENV = "CENSUS_COST_DIR"


def pytest_configure(config) -> None:
    out = os.environ.get(_ENV)
    if not out:
        return
    from repro_torch.analysis import census
    lint = census.lint_compiled_hlt
    seen: set = set()
    tot = {"runs": 0, "seconds": 0.0, "repeat_runs": 0, "repeat_seconds": 0.0}

    def counted(run, **kw):
        p = run.plan
        key = (id(run.ctx), p.schedule, p.datapath, p.level, p.batch,
               p.ct_slots, p.diag_slots, p.d_pad, p.chunk)
        t0 = time.perf_counter()
        try:
            return lint(run, **kw)
        finally:
            dt = time.perf_counter() - t0
            tot["runs"] += 1
            tot["seconds"] += dt
            if key in seen:
                tot["repeat_runs"] += 1
                tot["repeat_seconds"] += dt
            seen.add(key)
            path = pathlib.Path(out) / f"{os.getpid()}.json"
            path.write_text(json.dumps(tot))

    census.lint_compiled_hlt = counted


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="census_cost_") as out:
        env = dict(os.environ, **{_ENV: out})
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "tools"), str(ROOT / "src")]
            + [p for p in [os.environ.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        rc = subprocess.call([sys.executable, "-m", "pytest", "-p",
                              "census_cost", *sys.argv[1:]], env=env,
                             cwd=ROOT)
        wall = time.perf_counter() - t0
        tot = {"runs": 0, "seconds": 0.0, "repeat_runs": 0,
               "repeat_seconds": 0.0}
        for f in pathlib.Path(out).glob("*.json"):
            for k, v in json.loads(f.read_text()).items():
                tot[k] += v
    print(json.dumps(dict(tot, pytest_wall_seconds=wall, pytest_rc=rc)))
    return rc


if __name__ == "__main__":
    sys.exit(main())
