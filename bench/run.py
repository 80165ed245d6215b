#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  ``BENCHMARK.json`` names the cell; the
harness finds everything else by name:

- the configuration: the cell's ``config`` entry's ``file``;
- the traffic: ``bench/traffic/<traffic>.json``; its ``kind`` names the
  module ``bench/kinds/<kind>.py`` that builds the program and runs one
  request;
- the cell's own settings (profiled requests, the size of the check's
  sample, the limits of the check):
  ``bench/workloads/<cell>.json``;
- each metric: ``bench/metrics/<metric>.py``, whose ``read(record)`` gives
  the value or None.

Set-up (from the harness's first line to the first timed request) builds
the program from the seed and runs one warm-up request.  The window is a
closed loop of one client: request i starts when request i − 1 has
returned, until ``--seconds`` have passed.  ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` times the stages of every
request (the device synchronised at each boundary) and profiles the cell's
``profile_requests`` whole requests after the first one, and reports its
per-layer metrics.  After the window the peak device memory is read, the
program is freed, and the products of a sample of the window's requests,
drawn from the seed, are decoded and compared with the reference
(``bench/reference``).  The last line of standard
output is the result as one JSON object; the numbers compared and their
limits are the last lines of standard error.

The host's thread pools (OpenMP, MKL, OpenBLAS, torch's own) get one
thread each.

Exits 2 without a CUDA device, or with fewer than the cell asks for, and 3
if JAX or the JAX package was loaded: neither prints a result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import os  # noqa: E402

# one thread for every host-side pool: the load is one process issuing the
# program's launches, and idle pools only contend for the host's cores
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
for _p in (str(BENCH), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from tracing import Trace  # noqa: E402

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """A cell as ``BENCHMARK.json`` and its files define it."""
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list; an end-to-end metric without the key is every cell's.  A
    per-layer metric has to list its cells."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "layer" in metric:
        raise SystemExit(f"bench: per-layer metric {metric['name']!r} "
                         "lists no workloads")
    return True


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files; the data
    files lie under the spec's first path."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"bench: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    data = root / spec["paths"][0]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    read = lambda p: json.loads(p.read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    layer = [m for m in spec["per_layer"] if _reports(m, name)]
    return Cell(name=name, chips=w["chips"], config=read(root / cfg["file"]),
                traffic=read(data / "traffic" / f"{w['traffic']}.json"),
                settings=read(data / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def kind_module(cell: Cell):
    return importlib.import_module(f"kinds.{cell.traffic['kind']}")


def reader(metric: str):
    return importlib.import_module(f"metrics.{metric}").read


@dataclasses.dataclass
class Record:
    """What one run measured, for the metric readers.  Times in seconds;
    ``spans`` holds, for each traced request that was not profiled, its
    spans' seconds, and ``spans_s`` those requests' host seconds;
    ``profiled`` counts the profiled requests and ``trace`` is their
    profile."""
    setup_s: float
    window_s: float
    requests: int
    peak_bytes: int
    counters: dict
    least: dict
    spans: list
    spans_s: float = 0.0
    profiled: int = 0
    trace: Optional[Trace] = None


class Marks:
    """A stage hook: synchronises the device at each mark, keeps the host
    clock, and in a profiled request opens and closes ``bench.<span>``
    ranges at the span's marks."""

    def __init__(self, spans: dict, device, profiled: bool):
        self.spans, self.device, self.profiled = spans, device, profiled
        self.at: dict = {}
        self.open: dict = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def __call__(self, name: str) -> None:
        self.sync()
        self.at[name] = time.perf_counter()
        if not self.profiled:
            return
        for span, (first, last) in self.spans.items():
            if last == name and span in self.open:
                self.open.pop(span).__exit__(None, None, None)
        for span, (first, _) in self.spans.items():
            if first == name:
                rf = torch.profiler.record_function(f"bench.{span}")
                rf.__enter__()
                self.open[span] = rf

    def seconds(self) -> dict:
        return {s: self.at[b] - self.at[a] for s, (a, b) in self.spans.items()}


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def window(sess, kind, seconds: float, trace: bool, n_profile: int, device):
    """The timed loop: requests until ``seconds`` have passed; traced, each
    with its stages marked, and then ``n_profile`` more under the profiler
    (started only now: once started, it slows every later launch).
    Returns (window seconds, requests, spans of the unprofiled requests,
    their seconds, profiler or None, each unprofiled request's seconds)."""
    spans, n, prof, ends = [], 0, None, []
    start = time.perf_counter()
    end = start
    while end - start < seconds or n == 0:
        hook = Marks(kind.SPANS, device, False) if trace else None
        sess.request(n, hook)
        if trace:
            spans.append(hook.seconds())
        n += 1
        end = time.perf_counter()
        ends.append(end)
    spans_s = end - start
    if trace and n_profile:
        prof = _profiler()
        prof.__enter__()
        torch.zeros(1, device=device).add_(1)   # start-up before any request
        for _ in range(n_profile):
            hook = Marks(kind.SPANS, device, True)
            hook.sync()
            with torch.profiler.record_function("bench.request"):
                sess.request(n, hook)
            n += 1
        prof.__exit__(None, None, None)
        end = time.perf_counter()
    return end - start, n, spans, spans_s, prof, np.diff([start] + ends)


def run(name: str, seed: int, seconds: float, trace: bool, device,
        root: pathlib.Path = ROOT, t0: float = T0, log=None) -> dict:
    """One run of cell ``name``; returns the result (the last line)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    device = torch.device(device)
    cell = load_cell(name, root)
    kind = kind_module(cell)
    n_profile = int(cell.settings["profile_requests"])
    sess = kind.Session(cell.config, cell.traffic, cell.settings, seed,
                        device)
    sess.request(-1, keep=False)
    setup_s = time.perf_counter() - t0
    log(f"setup stages s: {json.dumps(sess.setup_s)}")
    sess.reset_launches()
    window_s, n, spans, spans_s, prof, each = window(
        sess, kind, seconds, trace, n_profile, device)
    log("request ms: " + " ".join(f"{1e3 * t:.1f}" for t in each))
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    counters = sess.counters()
    log(f"counters: {json.dumps(counters)}")
    least = sess.least()
    sess.release()
    tr = Trace(prof.events()) if prof is not None else None
    rec = Record(setup_s=setup_s, window_s=window_s, requests=n,
                 peak_bytes=peak, counters=counters, least=least,
                 spans=spans, spans_s=spans_s,
                 profiled=n_profile if prof is not None else 0, trace=tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    judge = sess.judge(cell.settings["limits"])
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": judge.correct(), "attempted": n,
              "failed": judge.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_in("request") / 1e6,
                                window_s=tr.length("request") / 1e6)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    log(f"not compared: {json.dumps(judge.not_compared())}")
    got = judge.numbers()
    result["check"] = {k: {"value": got[k], "limit": judge.limits[k]}
                       for k in got}
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"bench: the cell needs {cell.chips} CUDA device(s), found "
              f"{have}; no result", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}; {power_limit()}",
          file=sys.stderr, flush=True)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
