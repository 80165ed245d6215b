"""Rank programs of the sharded-schedule tests (``test_torch_sharded*.py``).

Each function runs on every rank of ``repro_torch.launch.mesh.spawn``
(gloo on the CPU), builds the port's inputs from the same numpy seeds as
the test's reference run in the parent, and returns what the parent
compares: ciphertexts as ``(c0, c1, level, scale)`` with uint32 numpy
residues.  Only ``torch``, ``numpy`` and ``repro_torch`` are imported, so
a rank starts without JAX.
"""
import multiprocessing
import os
import shutil
import tempfile
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import VerificationError, census
from repro_torch.core import hlt_dist, ntt
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.compile import (HEContext, compile_hemm,
                                      compile_hemm_chain, compile_hlt)
from repro_torch.core.hemm import (decrypt_matrix, encrypt_matrix, plan_hemm,
                                   plan_hemm_chain)
from repro_torch.core.params import toy_params, u32_numpy
from repro_torch.distributed import collectives
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import make_mesh_for

CPU = "cpu"


def ct(c) -> tuple:
    return (u32_numpy(c.c0), u32_numpy(c.c1), c.level, c.scale)


def _mesh(model_parallel: int):
    return make_mesh_for(dist.get_world_size(), model_parallel, device=CPU,
                         backend="gloo")


def _pair(ctx, rng, shape_a=(4, 3), shape_b=(4, 3)):
    a = encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, shape_a), rng)
    b = encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, shape_b), rng)
    return a, b


def _census_of(run) -> list:
    c = census.take_census(run)["collectives"]
    return [c.get("all_reduce", 0),
            sum(v for k, v in c.items() if k != "all_reduce")]


# ---------------------------------------------------------------------------
# mesh (data 1 × model 4)
# ---------------------------------------------------------------------------


def hlt_on_model4(param_cases) -> dict:
    """The σ / τ / ε HLT batch on ``model`` 4 for each parameter set (seed
    7, verify="error"), and the census case (seed 13): the fused stages
    and ``HEContext(datapath="xla")``."""
    mesh = _mesh(4)
    out = {}
    for name, kw in param_cases:
        rng = np.random.default_rng(7)
        ctx = HEContext(CkksEngine(toy_params(**kw), device=CPU), mesh=mesh,
                        verify="error")
        plan = plan_hemm(ctx.eng, 4, 3, 5)
        ctx.keygen(rng, rot_steps=plan.rot_steps)
        ctA, ctB = _pair(ctx, rng)
        items = [(ctA, plan.ds_sigma), (ctB, plan.ds_tau),
                 (ctA, plan.ds_eps[0])]
        run = compile_hlt(ctx, [ds for _, ds in items], level=ctA.level,
                          schedule="sharded")
        tabs = run._sharded[0]
        out[name] = dict(outs=[ct(o) for o in run([it for it, _ in items])],
                         M=tabs.M, M_pad=tabs.M_pad, n_model=ctx.n_model,
                         coll=run.plan.collective_bytes)

    rng = np.random.default_rng(13)
    params = toy_params(logN=6, L=4, k=3, beta=2, scale_bits=26)
    ctx = HEContext(CkksEngine(params, device=CPU), mesh=mesh,
                    verify="error", datapath="pallas")
    plan = plan_hemm(ctx.eng, 4, 3, 5)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    ctA, ctB = _pair(ctx, rng)
    sets = [plan.ds_sigma, plan.ds_tau]
    res = {}
    for dp in ("pallas", "xla"):
        c = ctx if dp == "pallas" else HEContext(
            ctx.eng, ctx.keys, mesh=mesh, verify="error", datapath="xla")
        run = compile_hlt(c, sets, level=ctA.level, schedule="sharded")
        cen = census.take_census(run)
        res[dp] = dict(outs=[ct(o) for o in run([ctA, ctB])],
                       datapath=run.plan.datapath,
                       collectives=cen["collectives"], ntt=cen["ntt"],
                       calls=cen["calls"])
    out["census"] = res
    return out


# ---------------------------------------------------------------------------
# mesh (data 2 × model 2)
# ---------------------------------------------------------------------------


def hemm_on_2x2() -> dict:
    """compile_hemm on the 2 × 2 mesh (seed 3) and a 3-wide batch on the
    2-way ct axis (batch padding)."""
    mesh = _mesh(2)
    rng = np.random.default_rng(3)
    params = toy_params(logN=6, L=4, k=3, beta=2, scale_bits=26)
    ctx = HEContext(CkksEngine(params, device=CPU), mesh=mesh)
    m, l, n = 4, 3, 5
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    A, B = rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    ctA = encrypt_matrix(ctx.eng, ctx.keys, A, rng)
    ctB = encrypt_matrix(ctx.eng, ctx.keys, B, rng)
    prog = compile_hemm(ctx, plan, schedule="sharded")
    sh = prog(ctA, ctB)
    err = float(np.abs(decrypt_matrix(ctx.eng, ctx.keys, sh, m, n)
                       - A @ B).max())
    runb = compile_hlt(ctx, [plan.ds_sigma, plan.ds_tau, plan.ds_sigma],
                       level=ctA.level, schedule="sharded")
    outs = runb([ctA, ctB, ctB])
    return dict(hemm=ct(sh), err=err, batch3=[ct(o) for o in outs],
                b_pad=int(runb._slot_tables["diag"].shape[0]),
                coll=prog.plan.collective_bytes, n_ct=ctx.n_ct,
                n_model=ctx.n_model, ct_rank=ctx.ct_rank,
                model_rank=ctx.model_rank)


def fused_vs_xla_on_2x2() -> dict:
    """``"sharded"`` (rotation_chunk 2, an aliased batch) against
    ``"sharded_xla"`` (seed 5); a mostly distinct batch takes the element
    layout; a planted extra collective draws JX001 and a planted named
    NTT JX004."""
    mesh = _mesh(2)
    rng = np.random.default_rng(5)
    params = toy_params(logN=6, L=4, k=3, beta=2, scale_bits=26)
    ctx = HEContext(CkksEngine(params, device=CPU), mesh=mesh)
    plan = plan_hemm(ctx.eng, 4, 3, 5)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    ctA, ctB = _pair(ctx, rng)
    items = [ctA, ctB, ctA]
    sets = [plan.ds_sigma, plan.ds_tau, plan.ds_sigma]
    fused = compile_hlt(ctx, sets, level=ctA.level, schedule="sharded",
                        rotation_chunk=2, ct_slots=(0, 1, 0))
    xla = compile_hlt(ctx, sets, level=ctA.level, schedule="sharded_xla")
    dis = [encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (4, 3)), rng)
           for _ in range(4)]
    rund = compile_hlt(ctx, [plan.ds_sigma] * 4, level=ctA.level,
                       schedule="sharded", rotation_chunk=2)
    af, layf = fused._sharded_args(items)
    ax, _ = xla._sharded_args(items)
    ad, layd = rund._sharded_args(dis)
    out = dict(
        fused=[ct(o) for o in fused(items)], xla=[ct(o) for o in xla(items)],
        distinct=[ct(o) for o in rund(dis)],
        layout_aliased=layf, n_uniq_packed=int(af["c1rep"].shape[0]),
        layout_distinct=layd, distinct_packed=int(ad["c1rep"].shape[0]),
        distinct_slots=ad["ct_slots"].tolist(),
        xla_packed=int(ax["c1rep"].shape[0]),
        hoist=fused.plan.hoist_bytes, hoist_naive=fused.plan.hoist_bytes_naive,
        hoist_xla=xla.plan.hoist_bytes,
        census=[_census_of(r) for r in (fused, xla, rund)])

    # planted faults: the same compile on a fresh context whose body makes
    # one more collective, or calls a named int64 NTT
    orig = hlt_dist.make_sharded_hlt_fn
    group = mesh.group("model")

    def extra_gather(body, args):
        o = body(args)
        collectives.all_gather(o[0], group, 2)
        return o

    def named_ntt(body, args):
        o = body(args)
        q = torch.tensor([[97]], dtype=torch.int32)
        ntt.intt_mont(torch.zeros((1, 4), dtype=torch.int32),
                      torch.zeros((1, 4), dtype=torch.int32), q, q, q)
        return o

    for name, plant in (("extra_gather", extra_gather),
                        ("named_ntt", named_ntt)):
        def planted(*a, plant=plant, **k):
            body = orig(*a, **k)
            return lambda args: plant(body, args)
        hlt_dist.make_sharded_hlt_fn = planted
        try:
            bad = HEContext(ctx.eng, ctx.keys, mesh=mesh, verify="error")
            compile_hlt(bad, sets, level=ctA.level, schedule="sharded")
            out[name] = None
        except VerificationError as e:
            out[name] = sorted({(d.rule, d.severity) for d in e.diagnostics})
        finally:
            hlt_dist.make_sharded_hlt_fn = orig
    return out


def chain_on_2x2() -> dict:
    """The depth-3 chain (seed 17) under ``schedule="sharded"`` and
    verify="error": every hop, the decrypt count, the census of each HLT
    launch, levels and the trace."""
    mesh = _mesh(2)
    params = toy_params(logN=6, L=9, k=3, beta=5, scale_bits=26)
    rng = np.random.default_rng(17)
    ctx = HEContext(CkksEngine(params, device=CPU), mesh=mesh,
                    verify="error")
    chain = plan_hemm_chain(ctx.eng, (3, 3, 3, 3, 3))
    ctx.keygen(rng, rot_steps=chain.rot_steps)
    prog = compile_hemm_chain(ctx, chain, schedule="sharded")
    X = rng.uniform(-0.5, 0.5, (3, 3))
    Ws = [rng.uniform(-0.5, 0.5, (3, 3)) for _ in range(3)]
    ctX = encrypt_matrix(ctx.eng, ctx.keys, X, rng)
    w_cts = prog.encrypt_weights(Ws, rng)
    d0 = ctx.eng.op_counts["decrypts"]
    outs = prog.run_hops(ctX, w_cts)
    dz = ctx.eng.op_counts["decrypts"] - d0
    ref = X @ Ws[0] @ Ws[1] @ Ws[2]
    err = float(np.abs(decrypt_matrix(ctx.eng, ctx.keys, outs[-1], 3, 3)
                       - ref).max())
    return dict(
        outs=[ct(o) for o in outs], err=err, decrypts=dz,
        census=[_census_of(run) for hp in prog._hops
                for run in (hp._step1, hp._step2)],
        levels=[o.level for o in outs],
        exact=[o.level == s.level and o.scale == s.scale
               for o, s in zip(outs, prog.plan.hop_out, strict=True)],
        coll=prog.plan.collective_bytes, n_model=ctx.n_model)


def blockmm_on_2x2(shapes) -> dict:
    """``SecureMatmulEngine(mesh=)`` block MM at tile 4 for each (m, l, n)
    (A, B from seed 4, keys from seed 9)."""
    from repro_torch.secure import SecureMatmulEngine
    mesh = _mesh(2)
    toy = toy_params(logN=6, L=4, k=3, beta=2)
    out = {}
    for m, l, n in shapes:
        rng = np.random.default_rng(4)
        A, B = rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = SecureMatmulEngine(toy, tile=4, schedule="sharded",
                                     mesh=mesh)
        eng.keygen(np.random.default_rng(9))
        At, Bt = eng.encrypt_tiles(A, rng), eng.encrypt_tiles(B, rng)
        C = eng.matmul_encrypted(At, Bt, batched=True)
        out[(m, l, n)] = dict(
            tiles=[[ct(c) for c in row] for row in C],
            err=float(np.abs(eng.decrypt_tiles(C, m, n) - A @ B).max()),
            batched=eng.batched, device=str(eng.eng.device))
    return out


# ---------------------------------------------------------------------------
# the serving pool on 2 ranks
# ---------------------------------------------------------------------------


def pool_flush(model_parallel: int) -> dict:
    """One flush of two tenants' calls through ``SessionPool(mesh=)`` and
    through a one-device pool, from the same seeds, on each rank."""
    from repro_torch.serve.he_batcher import CrossRequestHEBatcher, SecureCall
    from repro_torch.serve.sessions import HEProgramCache, SessionPool
    mesh = _mesh(model_parallel)
    params = toy_params(logN=6, L=4, k=3, beta=2)
    W = np.random.default_rng(21).uniform(-1, 1, (6, 5))
    rows = np.random.default_rng(22).uniform(-1, 1, (3, 6))
    got = {}
    for name, kw in (("mesh", dict(mesh=mesh, schedule="sharded")),
                     ("one", dict(schedule="pallas"))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            pool = SessionPool(params, tile=4, device=CPU, **kw)
        pool.attach_weights({0: W})
        batcher = CrossRequestHEBatcher(pool, HEProgramCache(),
                                        rng=np.random.default_rng(23))
        for r, (x, tenant) in enumerate(zip(rows, ("A", "B", "A"),
                                            strict=True)):
            batcher.submit(SecureCall(r, 0, x, tenant))
        res = batcher.flush()
        st = batcher.steps[-1]
        got[name] = dict(rows=res,
                         launches=(st.program_launches, st.hlt_launches),
                         schedule=pool._sessions["A"].engine.schedule)
    got["x_w"] = rows @ W
    return got


def on_2x2() -> dict:
    """The HLT cases of the 2 × 2 mesh in one spawn."""
    return dict(hemm=hemm_on_2x2(), fused_vs_xla=fused_vs_xla_on_2x2())


# ---------------------------------------------------------------------------
# ranks started with different hash seeds
# ---------------------------------------------------------------------------


def start_with_hash_seeds(fn, hash_seeds, timeout: float = 60.0) -> list:
    """Run ``fn()`` on one gloo rank of the CPU per entry of
    ``hash_seeds``, each process under its own ``PYTHONHASHSEED`` (as
    ranks started by hand may be, where ``spawn`` gives them one); returns
    each rank's return value, by rank."""
    world = len(hash_seeds)
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    saved = os.environ.get("PYTHONHASHSEED")
    procs = []
    try:
        for rank, seed in enumerate(hash_seeds):
            os.environ["PYTHONHASHSEED"] = str(seed)
            p = multiprocessing.get_context("spawn").Process(
                target=mesh_mod._run_rank,
                args=(rank, fn, world, CPU, "gloo", timeout, tmp, ()))
            p.start()
            procs.append(p)
        for p in procs:
            p.join(timeout + 60)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"rank exit codes {codes}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        if saved is None:
            os.environ.pop("PYTHONHASHSEED", None)
        else:
            os.environ["PYTHONHASHSEED"] = saved
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_or_refusal() -> str:
    """A (1 × 2) mesh's construction on this rank: "mesh", or the
    refusal's message."""
    try:
        _mesh(2)
    except RuntimeError as e:
        return str(e)
    return "mesh"


def sharded_collectives_1x2() -> dict:
    """(data 1 × model 2): ``CompiledHLT.sharded_collectives`` of the σ /
    τ batch of a toy hemm (seed 11) beside the plan's reckoned bytes."""
    mesh = _mesh(2)
    rng = np.random.default_rng(11)
    ctx = HEContext(CkksEngine(toy_params(logN=6, L=4, k=3, beta=2),
                               device=CPU), mesh=mesh)
    plan = plan_hemm(ctx.eng, 4, 3, 5)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    ctA, ctB = _pair(ctx, rng)
    run = compile_hlt(ctx, [plan.ds_sigma, plan.ds_tau], level=ctA.level,
                      schedule="sharded")
    stats = run.sharded_collectives([ctA, ctB])
    return dict(total=stats.total_bytes, by_op=stats.by_op,
                count=stats.count, largest=stats.largest,
                plan=run.plan.collective_bytes)
