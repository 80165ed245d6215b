#!/usr/bin/env python3
"""Device memory of the port's batched ``pallas`` hemm at a parameter set
and matrix shape, on one NVIDIA GPU.

    python3 tools/hemm_memory.py [--params set-c] [--shape M L N ...]

For each shape in turn (``--shape`` may repeat; default 32 32 32 at
Set-C): plan, keygen, encrypt and compile on a fresh
``CkksEngine(params, datapath="pallas")``, printing the device memory
held after each (``torch.cuda.memory_allocated``: the Galois keys, the
operand arena) and the peak over all of them; then the first call with
the peak (``max_memory_allocated``) read and reset at each stage boundary
(Step 1, the Step-2 hoist, Step 2, the mult → rescale loop), and the
stage times on the host clock.  A shape that does not fit prints where
it ran out, and the script goes on to the next.  Prints one JSON line per shape, then the card's
name and power limit.  Exits non-zero without a CUDA device."""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
PARAMS = ("set-a", "set-b", "set-c")


def run(params, shape, rng) -> dict:
    import torch
    from repro_torch.core.ckks import CkksEngine
    from repro_torch.core.compile import HEContext, compile_hemm
    from repro_torch.core.hemm import encrypt_matrix, plan_hemm

    m, l, n = shape
    out = {"params": params.name, "shape": list(shape), "gb": {}}
    gb = out["gb"]

    def mark(name):
        torch.cuda.synchronize()
        gb[name] = torch.cuda.memory_allocated() / 1e9

    state = {"stage": "setup"}
    t0 = time.perf_counter()
    try:
        ctx = HEContext(CkksEngine(params, datapath="pallas"))
        plan = plan_hemm(ctx.eng, m, l, n)
        mark("plan")
        state["stage"] = "keygen"
        ctx.keygen(rng, rot_steps=plan.rot_steps)
        mark("keys")
        out["galois_keys"] = len(ctx.keys.galois)
        state["stage"] = "compile"
        ctA = encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (m, l)), rng)
        ctB = encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (l, n)), rng)
        prog = compile_hemm(ctx, plan, schedule="pallas", rotation_chunk=1)
        mark("compiled")
        out["arena_gb"] = ctx.arena.nbytes / 1e9
        out["setup_s"] = time.perf_counter() - t0
        out["setup_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        peaks, ms = {}, {}

        def hook(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            if name != "start":
                peaks[name] = torch.cuda.max_memory_allocated() / 1e9
                ms[name] = (now - state["t"]) * 1e3
            state["stage"], state["t"] = name, now
            torch.cuda.reset_peak_memory_stats()

        prog.stage_hook = hook
        state["stage"] = "call"
        prog(ctA, ctB)
        out["stage_peak_gb"], out["stage_ms"] = peaks, ms
        out["call_peak_gb"] = max(peaks.values())
        out["fits"] = True
    except torch.cuda.OutOfMemoryError as e:
        out["fits"] = False
        out["out_of_memory_in"] = state["stage"]
        out["error"] = str(e).splitlines()[0]
        out["peak_gb_at_failure"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        # a context and its compiled programs refer to each other: only
        # the cycle collector frees them
        ctx = prog = ctA = ctB = plan = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", choices=PARAMS, default="set-c")
    ap.add_argument("--shape", type=int, nargs=3, action="append",
                    metavar=("M", "L", "N"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hemm_memory: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import nvidia_smi
    from repro_torch.core import params as P

    params = {"set-a": P.SET_A, "set-b": P.SET_B, "set-c": P.SET_C}[args.params]
    for shape in args.shape or [(32, 32, 32)]:
        res = run(params, tuple(shape), np.random.default_rng(20261))
        print(json.dumps(res), flush=True)
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
