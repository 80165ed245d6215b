"""CLI: compile representative HE programs over the verify parameter sets
and print the static verifier's report — counterpart of
``repro/analysis/lint.py``.

    PYTHONPATH=src python -m repro_torch.analysis.lint [--device cpu]
        [--schedules mo,hoisted,pallas] [--sets fame-s-rt,...]
        [--shape 4,3,5] [--grid 2,2,2] [--chain 8] [-v]

For every set of ``configs/fame_sets.py`` ``FAME_VERIFY_SETS`` it
compiles a hemm per schedule and a block MM over a tile grid with an
aliasing hint (the slot-table audit), runs ``verify_program`` on each,
and traces a chain of ``--chain`` hemm hops to report how many fit the
modulus chain.  Like every entry point of the port it runs on the card
(``cuda``) unless ``--device cpu`` is given.  Exit status 1 if any
error-severity diagnostic is found.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.analysis.diagnostics import errors
from repro_torch.analysis.level_scale import max_chain_depth, trace_chain
from repro_torch.analysis.verify import verify_program
from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.compile import HEContext, compile_blockmm, compile_hemm
from repro_torch.core.hemm import plan_hemm
from repro_torch.core.hlt import SCHEDULES

_DEFAULT_SCHEDULES = ("mo", "hoisted", "pallas")


def _ints(csv: str) -> tuple:
    return tuple(int(x) for x in csv.split(","))


def _report_row(name: str, program: str, schedule: str, diags,
                verbose: bool) -> list:
    errs = errors(diags)
    warns = [d for d in diags if d.severity == "warning"]
    infos = [d for d in diags if d.severity == "info"]
    status = "FAIL" if errs else ("warn" if warns else "ok")
    print(f"  {name:<12} {program:<8} {schedule:<12} {status:<5} "
          f"{len(errs)} error(s), {len(warns)} warning(s), "
          f"{len(infos)} note(s)")
    for d in (diags if verbose else errs):
        print(f"    - {d}")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="static verification sweep over the fame verify sets")
    ap.add_argument("--device", default="cuda",
                    help="device of the engines (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--sets", default=",".join(FAME_VERIFY_SETS),
                    help="comma-separated FAME_VERIFY_SETS names")
    ap.add_argument("--schedules", default=",".join(_DEFAULT_SCHEDULES),
                    help="comma-separated schedules to compile")
    ap.add_argument("--shape", default="4,3,5", type=_ints,
                    help="hemm m,l,n")
    ap.add_argument("--grid", default="2,2,2", type=_ints,
                    help="block-MM gm,gl,gn tile grid")
    ap.add_argument("--chain", default=8, type=int,
                    help="hemm hops to trace for the chain-depth report")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print warnings and notes, not only errors")
    args = ap.parse_args(argv)

    schedules = tuple(s for s in args.schedules.split(",") if s)
    for s in schedules:
        if s not in SCHEDULES:
            ap.error(f"unknown schedule {s!r} (have {SCHEDULES})")
    m, l, n = args.shape
    all_errs = []
    for name in args.sets.split(","):
        params = FAME_VERIFY_SETS[name]
        print(f"{name}: N=2^{params.logN} L={params.L} k={params.k} "
              f"beta={params.beta}  shape {m}x{l}@{l}x{n}")
        # verify="off": the sweep collects the diagnostics itself, so one
        # failing program cannot stop it
        ctx = HEContext(CkksEngine(params, device=args.device), verify="off")
        plan = plan_hemm(ctx.eng, m, l, n)
        ctx.keygen(np.random.default_rng(0), rot_steps=plan.rot_steps)
        for schedule in schedules:
            prog = compile_hemm(ctx, plan, schedule=schedule)
            all_errs += _report_row(name, "hemm", schedule,
                                    verify_program(prog), args.verbose)
        # block MM with an aliasing hint (a shared A row, a shared B column)
        gm, gl, gn = args.grid
        prog = compile_blockmm(
            ctx, plan, args.grid, schedule="pallas",
            a_slots=[k for _ in range(gm) for k in range(gl)],
            b_slots=[k for k in range(gl) for _ in range(gn)])
        all_errs += _report_row(name, "blockmm", f"pallas {args.grid}",
                                verify_program(prog), args.verbose)
        moduli = ctx.eng.ctx.moduli_host
        tr = trace_chain(moduli, [plan] * args.chain, level=params.L,
                         scale=params.scale)
        fit = max_chain_depth(moduli, plan, level=params.L,
                              scale=params.scale)
        print(f"  {name:<12} chain    x{args.chain:<11} "
              f"{'ok' if tr.ok else 'underflows'}  {fit} hop(s) fit "
              f"L={params.L} ({len(tr.steps)} ops traced)")
    if all_errs:
        print(f"\n{len(all_errs)} error diagnostic(s) — failing")
        return 1
    print("\nall programs verified clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
