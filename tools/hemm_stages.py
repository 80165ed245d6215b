#!/usr/bin/env python3
"""Time the stages of the Set-B hemm 128×128×128 (the batched ``pallas``
program on ``CkksEngine(SET_B, datapath="pallas")``) with the port
imported from a given source tree, on one NVIDIA GPU.

    python3 tools/hemm_stages.py [--src DIR] [--calls N]

``--src`` is the directory that holds ``repro_torch`` (default: this
checkout's ``src``), so two trees of the port can be compared on one card
in one session: run the script once per tree, in turns (A, B, B, A).
After plan, keygen, encrypt, compile and one warm-up call, each of the
``--calls`` calls is timed stage by stage on the host clock, the device
synchronised at each stage boundary (``chip_smoke.staged_call``).  Prints
one JSON line per timed call, then the card's name and power limit.
Exits non-zero without a CUDA device."""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hemm_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    from chip_smoke import nvidia_smi, staged_call
    from repro_torch.configs.fame_sets import MM_BENCHMARKS
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext, compile_hemm
    from repro_torch.core.hemm import encrypt_matrix, plan_hemm
    from repro_torch.core.params import SET_B

    m, l, n = MM_BENCHMARKS["set-b"]["type-iv"]
    rng = np.random.default_rng(20260)
    ctx = HEContext(CkksEngine(SET_B, datapath="pallas"))
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    ctA = encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (m, l)), rng)
    ctB = encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (l, n)), rng)
    prog = compile_hemm(ctx, plan, schedule="pallas", rotation_chunk=1)
    prog(ctA, ctB)
    for _ in range(args.calls):
        _, st = staged_call(prog, ctA, ctB)
        print(json.dumps({"src": args.src, "stages": st}), flush=True)
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
