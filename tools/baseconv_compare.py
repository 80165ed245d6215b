#!/usr/bin/env python3
"""Time ``csrc/baseconv.cu`` against other ``baseconv.cu`` files with the
same C entry point on one NVIDIA GPU, at the shapes ``chip_smoke.py``'s
phase 2 checks ``baseconv`` at.

    python3 tools/baseconv_compare.py [--source FILE ...] [--sass]

``--source`` adds another ``baseconv.cu`` (e.g. from a ``git archive`` of
another tree), built as it is.  Every file is built by nvcc in parallel
into ``repro_torch/_build/compare`` and bound with ctypes; each build is
held array-equal to ``baseconv_plain`` at every shape, then timed with
``chip_smoke.device_ms`` (a CUDA graph of k launches) in two turns, the
builds in order and then in reverse, beside the launch floor
(``chip_smoke.launch_floor_ms``).  ``--sass`` prints, for this tree's
build, ``cuobjdump -sass``'s instructions by opcode over each kernel and
over each of its loops (a backward branch).
Prints ptxas's lines, one JSON line per (build, shape, turn), then the
card's maximum and current SM clock, and its name and power limit.
Exits non-zero without a CUDA device."""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def build_all(sources: dict, out_dir: pathlib.Path) -> dict:
    """{name: source} -> {name: ctypes.CDLL}, nvcc in parallel."""
    from repro_torch.kernels import build
    procs = {}
    for name, src in sources.items():
        lib = out_dir / f"libbaseconv_{name}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        for ln in out.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[ptxas] {name}: {ln.split(':', 1)[-1].strip()}")
        libs[name] = ctypes.CDLL(str(lib))
        fn = libs[name].baseconv_launch
        fn.argtypes = build.SIGNATURES["baseconv_launch"][1] + [build.P]
        fn.restype = build.I
    return libs


def sass_summary(lib_path: pathlib.Path) -> None:
    """Opcode counts of each kernel in ``lib_path``, whole and per loop."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.splitlines()[0].strip()
        ins = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                             r"([^;]*);", fn):
            ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
        print(f"[sass] {name}: {len(ins)} instructions, "
              f"{json.dumps(collections.Counter(op for _, op, _ in ins))}")
        for addr, op, rest in ins:
            tgt = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if tgt and int(tgt.group(1), 16) < addr:
                lo = int(tgt.group(1), 16)
                body = [o for a, o, _ in ins if lo <= a <= addr]
                print(f"[sass]   loop {lo:#06x}-{addr:#06x}: {len(body)} "
                      f"instructions, {json.dumps(collections.Counter(body))}")


def launcher(fn, ptrs: list, S: int, T: int, N: int):
    """A call of ``fn`` on the current stream (a graph's capture stream
    inside ``device_ms``) that raises when the launch fails."""
    import torch

    def run():
        err = fn(*ptrs, S, T, N, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseconv_launch: CUDA error {err}")
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("baseconv_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.params import SET_B
    from repro_torch.kernels import baseconv as kbc, build

    sources = {"this": build.CSRC / "baseconv.cu"}
    for i, src in enumerate(args.source):
        sources[f"source{i}"] = pathlib.Path(src).resolve()
    out_dir = build.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build_all(sources, out_dir)
    if args.sass:
        sass_summary(out_dir / "libbaseconv_this.so")

    eng = CkksEngine(SET_B)
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(0xBC)
    print(json.dumps({"launch_floor_ms": cs.launch_floor_ms(eng.device)}),
          flush=True)
    for label, e, S, T, N, _ in cs.baseconv_cases(eng):
        bargs = cs.baseconv_operands(e, S, T)
        x = cs.rand_residues((len(S), N), bargs[1], gen)
        want = kbc.baseconv_plain(x, *bargs)
        out = torch.empty((len(T), N), dtype=torch.int32, device=eng.device)
        ptrs = [a.data_ptr() for a in (x, *bargs, out)]
        runs = {name: launcher(lib.baseconv_launch, ptrs, len(S), len(T), N)
                for name, lib in libs.items()}
        for name, run in runs.items():
            out.zero_()
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name} {label}: differs from "
                                     f"baseconv_plain")
        nbytes = ((len(S) + len(T)) * N + 5 * len(S) + len(T) * len(S)
                  + 3 * len(T)) * 4
        bms, _ = cs.bound(nbytes, 0)
        order = list(runs)
        for turn, names in enumerate((order, order[::-1])):
            for name in names:
                ms = cs.device_ms(runs[name], cs.cuda_ms(runs[name], 20))
                print(json.dumps({"build": name, "shape": label,
                                  "S": len(S), "T": len(T), "N": N,
                                  "turn": turn, "device_ms": ms,
                                  "bound_ms": bms}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
