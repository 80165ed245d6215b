"""Multi-pod dry-run: price every (architecture × input shape) cell's step
on the production meshes from counts, with nothing allocated — counterpart
of ``repro/launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh pod --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --he set-b --mesh pod

The reference lowers and compiles each cell's jitted step on 256 or 512
forced host devices and reads the compiled HLO.  The port has neither:
one process joins a ``"fake"`` process group of 256 ranks ((data 16 ×
model 16), ``--mesh pod``) or 512 ((pod 2 × data 16 × model 16),
``multipod``), builds ``launch/mesh.py``'s production mesh on it, makes
rank 0's parameters, state, cache and inputs under ``FakeTensorMode`` at
full width (shapes only), and runs rank 0's step once under
``distributed/hlo_cost.py``'s counter: the sharded serve steps
(``make_sharded_serve_steps``) for prefill and decode, the ZeRO-3 train
step with ``TrainConfig(microbatches=)`` for train.  Totals are per rank
× chips, as the reference's.  ``--he`` prices one rank's share of the
limb-sharded MO-HLT at d = 127 (``core/hlt_dist.py``
``lower_mo_hlt_spmd``) with its elementwise op count against the H100's
32-bit op rate.  ``--opt-cache`` is the reference's seq-sharded KV
variant: the ``seq_data`` axis it names is unmapped by the default rules
of both packages, so it moves no placement.

The record has the reference's keys, filled from counts:
``compile_s`` is the seconds the counted run took (set-up included),
``raw_cost_analysis`` ``FlopCounterMode``'s FLOPs (loop bodies the
counter folds counted once, as XLA's ``cost_analysis`` counts a
``while`` body) and the counter's bytes, and ``memory_analysis`` the
rank's argument, output, temporary (the peak of the bytes the run's own
fake tensors held) and donated bytes; ``generated_code_size_in_bytes``
has no counterpart and is left out, as the reference leaves out a key it
cannot read.  The roofline seconds are data-sheet terms
(``hlo_analysis.HW``), not measurements.

Results land in results/dryrun/<arch>__<shape>__<mesh><suffix>.json, the
reference's names and keys (``benchmarks/roofline_report.py`` reads
them).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.registry import SHAPES, cell_enabled
from repro_torch.distributed import hlo_analysis, hlo_cost
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import make_sharded_serve_steps
from repro_torch.train.train_step import (TrainConfig, abstract_train_state,
                                          make_sharded_train_step,
                                          param_shardings)
from repro_torch.tree import leaves, unflatten

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun")


def input_specs(arch: str, shape: str, device="cpu", cfg=None) -> dict:
    """Fresh tensors (made under the caller's ``FakeTensorMode``: shapes
    only) of every model input of this cell, global shapes and the
    reference's dtypes; ``cfg`` (default: the arch's) sets the widths."""
    cfg = registry.get_config(arch) if cfg is None else cfg
    s = SHAPES[shape]
    B, S = s["batch"], s["seq"]

    def t(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=device)

    f, i, bf = torch.float32, torch.int32, torch.bfloat16
    if s["step"] == "train":
        specs = {"targets": t((B, S), i)}
        if cfg.family == "audio":
            specs["embeds"] = t((B, S, cfg.d_model), f)
        else:
            specs["tokens"] = t((B, S), i)
        if cfg.family == "vlm":
            specs["frontend"] = t(
                (B, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model), bf)
        return specs
    if s["step"] == "prefill":
        if cfg.family == "audio":
            return {"embeds": t((B, S, cfg.d_model), bf)}
        return {"tokens": t((B, S), i)}
    # decode: one new token (or frame embedding) against a seq_len cache
    if cfg.family == "audio":
        return {"token": t((B, 1, cfg.d_model), bf)}
    return {"token": t((B, 1), i)}


@contextlib.contextmanager
def production_mesh(mesh_kind: str, device):
    """The production mesh (``"pod"``: 256 ranks, ``"multipod"``: 512)
    over a ``"fake"`` default process group of which this process is rank
    0, its rules installed; on exit the group is destroyed and the rules
    are the no-mesh default again."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process without a group")
    multi = mesh_kind == "multipod"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi, device=device,
                                    backend="fake")
        rules = sh.make_rules(mesh)
        sh.set_rules(rules)
        yield mesh, rules
    finally:
        sh.set_rules(sh.make_rules())
        dist.destroy_process_group()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _local(whole: dict, placements, device) -> dict:
    """Fresh tensors of this rank's blocks of the tree ``whole``."""
    return unflatten(whole, [
        torch.empty(q.local_shape(w.shape), dtype=w.dtype, device=device)
        for w, q in zip(leaves(whole), leaves(placements), strict=True)])


def _batch_rows(rules, t):
    """This rank's rows of a global batch leaf (all of them when the
    batch axes do not divide it: ``_batch_sharding``'s replication)."""
    R = sh.ranks(rules)
    if _batch_sharding(rules, t)[0] is None:
        return t
    per = t.shape[0] // R.D
    return t[R.d * per:(R.d + 1) * per]


def _batch_sharding(rules, spec) -> tuple:
    """The batch dimension's physical spec, replicated when it does not
    divide the data ranks (the reference's ``sanitize_spec``)."""
    axes = ("batch",) + (None,) * (spec.ndim - 1)
    return rules.spec(*sh.sanitize_spec(rules, axes, spec.shape))


def _mem_dict(args, outs, temp: int, alias: int) -> dict:
    """The reference's ``memory_analysis`` keys that have a counterpart."""
    return {"argument_size_in_bytes": _nbytes(args),
            "output_size_in_bytes": _nbytes(outs),
            "temp_size_in_bytes": int(temp),
            "alias_size_in_bytes": int(alias)}


def _counted(fn):
    """(out, hlo_cost counter, FlopCounterMode total) of one ``fn()``."""
    with hlo_cost.count() as c, FlopCounterMode(display=False) as fc:
        out = fn()
    return out, c, fc.get_total_flops()


def run_cell(arch: str, shape: str, mesh_kind: str, microbatches: int = 1,
             overrides: dict | None = None, seq_shard_kv: bool = False,
             device="cuda") -> dict:
    """Count one cell's step on rank 0; return the §Dry-run/§Roofline
    record.  ``overrides``: config fields to replace (a smoke-size cell);
    ``seq_shard_kv`` is accepted for the reference's signature and moves
    nothing (module docstring)."""
    cfg = registry.get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    s = SHAPES[shape]
    with production_mesh(mesh_kind, device) as (mesh, rules):
        chips = mesh.size(mesh.axis_names)
        t0 = time.time()
        # the layers' placements, cached at their first use: set-up, not
        # the step
        tf._placements(cfg)
        with FakeTensorMode(allow_non_fake_inputs=True):
            specs = input_specs(arch, shape, device, cfg)
            if s["step"] == "train":
                tcfg = TrainConfig(microbatches=microbatches)
                whole = abstract_train_state(cfg, tcfg)
                state = _local(whole, param_shardings(cfg, whole, rules),
                               device)
                batch = {k: _batch_rows(rules, v) for k, v in specs.items()}
                step = make_sharded_train_step(cfg, tcfg, mesh, state, batch)
                args = (state, batch)
                outs, c, raw = _counted(lambda: step(state, batch))
                alias = _nbytes(state)
            else:
                whole = tf.abstract_params(cfg)
                params = _local(whole, param_shardings(cfg, whole, rules),
                                device)
                cache = tf.init_cache(cfg, s["batch"], s["seq"],
                                      device=device)
                prefill, decode, _ = make_sharded_serve_steps(
                    cfg, mesh, params, s["batch"], s["seq"])
                with torch.no_grad():
                    if s["step"] == "prefill":
                        tok = specs.get("tokens", specs.get("embeds"))
                        args = (params, tok, cache)
                        outs, c, raw = _counted(
                            lambda: prefill(params, tok, cache))
                        alias = 0
                    else:
                        tok = specs["token"]
                        args = (params, tok, cache)
                        outs, c, raw = _counted(
                            lambda: decode(params, tok, cache,
                                           s["seq"] - 1))
                        alias = _nbytes(cache)
            mem = _mem_dict(args, outs, c.peak_bytes, alias)
        t1 = time.time()

    lc = c.cost()
    # the counts are rank 0's: totals = per rank × chips
    flops = lc.flops * chips
    hbm_bytes = lc.bytes_accessed * chips
    coll_bytes = lc.collective_bytes * chips
    terms = hlo_analysis.roofline_terms(flops, hbm_bytes, coll_bytes, chips)
    n_params = cfg.param_count()
    tokens = s["batch"] * (s["seq"] if s["step"] in ("train", "prefill")
                           else 1)
    mult = 6.0 if s["step"] == "train" else 2.0
    model_flops = mult * n_params * _active_frac(cfg) * tokens
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "chips": chips,
        "step": s["step"], "ok": True,
        "compile_s": round(t1 - t0, 2),
        "flops_total": flops,
        "hbm_bytes_total": hbm_bytes,
        "collective_bytes_total": int(coll_bytes),
        "collectives_by_op": {k: v * chips for k, v in
                              lc.collectives_by_op.items()},
        "raw_cost_analysis": {"flops": float(raw),
                              "bytes": float(lc.bytes_accessed)},
        "trip_counts": dict(list(lc.trip_counts.items())[:8]),
        "roofline": terms,
        "dominant": hlo_analysis.dominant_term(terms),
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / flops if flops else None,
        "memory_analysis": mem,
        "model_params": n_params,
    }


def _active_frac(cfg) -> float:
    """Active-parameter fraction for MoE (MODEL_FLOPS uses 6·N_active·D)."""
    if not cfg.num_experts:
        return 1.0
    total = cfg.param_count()
    dense_like = dataclasses.replace(
        cfg, num_experts=0, d_ff=cfg.d_ff * cfg.experts_per_token)
    return dense_like.param_count() / total


def run_he_cell(set_name: str, mesh_kind: str, unroll: int = 1,
                device="cuda") -> dict:
    """Count the paper's own workload: one MO-HLT step (Algorithm 3's body
    over all limbs) at full Set-B/C size, d = 127, limbs over ``model``
    and one ciphertext a ct rank over pod × data: rank 0's share."""
    from repro_torch.core import hlt_dist
    from repro_torch.core.params import PAPER_SETS
    p = PAPER_SETS[set_name]
    with production_mesh(mesh_kind, device) as (mesh, rules):
        chips = mesh.size(mesh.axis_names)
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            share = hlt_dist.lower_mo_hlt_spmd(p, mesh, rules, d=127,
                                               unroll=unroll, device=device)
            with torch.no_grad():
                outs, c, _ = _counted(share)
            mem = _mem_dict(share.args, outs, c.peak_bytes, 0)
        t1 = time.time()
    lc = c.cost()
    # integer workload: no dots — elementwise op elements are the compute
    flops = lc.int_elem_ops * chips
    hbm = lc.bytes_accessed * chips
    coll_bytes = lc.collective_bytes * chips
    terms = hlo_analysis.roofline_terms(flops, hbm, coll_bytes, chips,
                                        peak_flops=hlo_analysis.HW[
                                            "int32_ops"])
    return {"arch": f"he-mm-{set_name}", "shape": "mo-hlt-d127",
            "mesh": mesh_kind, "chips": chips, "ok": True,
            "compile_s": round(t1 - t0, 2), "flops_total": flops,
            "hbm_bytes_total": hbm,
            "collective_bytes_total": int(coll_bytes),
            "collectives_by_op": {k: v * chips for k, v in
                                  lc.collectives_by_op.items()},
            "roofline": terms,
            "dominant": hlo_analysis.dominant_term(terms),
            "memory_analysis": mem}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=[])
    ap.add_argument("--shape", nargs="+", default=[])
    ap.add_argument("--he", nargs="+", default=[],
                    help="HE set names (set-a/set-b/set-c)")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--he-unroll", type=int, default=1)
    ap.add_argument("--opt-cache", action="store_true",
                    help="seq-shard KV caches (decode §Perf variant)")
    ap.add_argument("--suffix", default="", help="result filename suffix")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu where no GPU is)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    # the reference's one --arch / --shape / --he, or several: the HE
    # cells, then every --arch × --shape (or --all's grid)
    cells = [("he", h, None) for h in args.he]
    if args.all:
        cells += [("lm", a, s) for (a, s) in registry.all_cells()]
    else:
        cells += [("lm", a, s) for a in args.arch for s in args.shape]

    failed = 0
    for kind, a, s in cells:
        for mk in meshes:
            name = f"{a}__{s or 'he'}__{mk}{args.suffix}"
            path = os.path.join(args.out, name + ".json")
            try:
                if kind == "he":
                    rec = run_he_cell(a, mk, unroll=args.he_unroll,
                                      device=args.device)
                elif not cell_enabled(a, s):
                    rec = {"arch": a, "shape": s, "mesh": mk,
                           "ok": True, "skipped":
                           "full-attention arch: long_500k requires "
                           "sub-quadratic attention (DESIGN.md §4)"}
                else:
                    rec = run_cell(a, s, mk, microbatches=args.microbatches,
                                   seq_shard_kv=args.opt_cache,
                                   device=args.device)
            except Exception as e:  # noqa: BLE001 — record failures as bugs
                rec = {"arch": a, "shape": s, "mesh": mk, "ok": False,
                       "error": repr(e),
                       "traceback": traceback.format_exc()[-3000:]}
            failed += not rec["ok"]
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            status = "OK " if rec.get("ok") else "FAIL"
            extra = ("skip: " + rec["skipped"][:40]) if "skipped" in rec else \
                (f"dom={rec.get('dominant', '?')} "
                 f"compile={rec.get('compile_s', '?')}s"
                 if rec.get("ok") else rec.get("error", "")[:80])
            print(f"[{status}] {name}: {extra}", flush=True)
    return failed


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
