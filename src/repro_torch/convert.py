"""Carry the reference package's objects across to the port.

The JAX package's keys, ciphertexts, hoisting products, diagonal sets,
hemm plans, model parameters and train states hold arrays that
``np.asarray`` reads; these functions turn them into the port's objects
on a device, keeping every u32 residue bit for bit and every weight value
exactly.  They read attributes only and import nothing of JAX or of
``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ckks import Ciphertext, EvalKey, Keys
from repro_torch.core.hemm import HeMMPlan
from repro_torch.core.hlt import DiagSet, Hoisted
from repro_torch.core.params import u32_tensor
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import _block_structure
from repro_torch.tree import tree_map


def u32(a, device) -> torch.Tensor:
    """Any uint32 array (numpy, or an array numpy can read) -> int32 tensor."""
    return u32_tensor(np.asarray(a), device)


def eval_key(k, device) -> EvalKey:
    return EvalKey(k0=u32(k.k0, device), k1=u32(k.k1, device))


def keys(k, device) -> Keys:
    """Keys: ``rot`` and ``galois`` keep sharing one EvalKey per Galois
    element, as the reference's do."""
    galois = {int(g): eval_key(ek, device) for g, ek in k.galois.items()}
    by_id = {id(ek): galois[int(g)] for g, ek in k.galois.items()}
    rot = {int(r): by_id[id(ek)] if id(ek) in by_id else eval_key(ek, device)
           for r, ek in k.rot.items()}
    return Keys(s_eval=u32(k.s_eval, device),
                evk_mult=eval_key(k.evk_mult, device), rot=rot, galois=galois)


def ciphertext(ct, device) -> Ciphertext:
    return Ciphertext(c0=u32(ct.c0, device), c1=u32(ct.c1, device),
                      level=int(ct.level), scale=float(ct.scale))


def hoisted(h, device) -> Hoisted:
    return Hoisted(digits=u32(h.digits, device), c0_ext=u32(h.c0_ext, device),
                   c1_ext=u32(h.c1_ext, device), level=int(h.level),
                   scale=float(h.scale))


def diagset(ds, device) -> DiagSet:
    return DiagSet(zs=tuple(int(z) for z in ds.zs), pt=u32(ds.pt, device),
                   scale=float(ds.scale), shape=tuple(ds.shape))


def hemm_plan(plan, device) -> HeMMPlan:
    return HeMMPlan(
        m=plan.m, l=plan.l, n=plan.n,
        ds_sigma=diagset(plan.ds_sigma, device),
        ds_tau=diagset(plan.ds_tau, device),
        ds_eps=[diagset(ds, device) for ds in plan.ds_eps],
        ds_omega=[diagset(ds, device) for ds in plan.ds_omega],
        rot_steps=tuple(int(r) for r in plan.rot_steps))


def _localize(tree: dict, cfg: ModelConfig, mesh) -> dict:
    """A rank's blocks of a whole port tree on ``mesh`` (whose rules must
    be the current ones): ``param_shardings``' placements."""
    if mesh is None:
        return tree
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.train_step import param_shardings
    from repro_torch.tree import leaves, unflatten
    rules = sh.get_rules()
    if rules.mesh is not mesh:
        raise ValueError("install the mesh's rules first: "
                         "sharding.set_rules(sharding.make_rules(mesh))")
    pl = param_shardings(cfg, tree, rules)
    return unflatten(tree, [q.local(t) for t, q in
                            zip(leaves(tree), leaves(pl), strict=True)])


def model_params(ref_params: dict, cfg: ModelConfig, device,
                 mesh=None) -> dict:
    """The reference's ``transformer.init_params`` pytree -> the port's
    parameter dict on ``device``, each leaf in its reference dtype (the
    activation dtype, or float32 for the MoE router and the SSM scalars).
    Every leaf under ``layers`` carries the leading ``nb`` axis of the
    reference's ``jax.vmap`` (``cfg``'s block count); block b of the port
    takes index b of each, so block order is kept.  Values go through
    float32, which holds bf16 and f32 exactly.  With ``mesh`` (whose rules
    are installed), a rank's blocks (``train_step.param_shardings``)."""
    def tensor(a):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=getattr(torch, a.dtype.name))

    out = {k: tensor(v) for k, v in ref_params.items() if k != "layers"}
    stacked = tree_map(tensor, ref_params["layers"])
    nb, _ = _block_structure(cfg)
    out["layers"] = [tree_map(lambda t, b=b: t[b].contiguous(), stacked)
                     for b in range(nb)]
    return _localize(out, cfg, mesh)


def train_state(ref_state: dict, cfg: ModelConfig, device,
                mesh=None) -> dict:
    """The reference's ``init_train_state`` / ``train_step`` state
    ``{"params", "opt": {step, master, m, v[, ef]}}`` -> the port's on
    ``device``: every tree through ``model_params`` (blocks unstacked,
    dtypes kept), ``step`` a 0-d int32 tensor; with ``mesh``, a rank's
    blocks of every tree."""
    opt = ref_state["opt"]
    out = {"step": torch.tensor(int(np.asarray(opt["step"])),
                                dtype=torch.int32, device=device)}
    for name in ("master", "m", "v", "ef"):
        if name in opt:
            out[name] = model_params(opt[name], cfg, device, mesh)
    return {"params": model_params(ref_state["params"], cfg, device, mesh),
            "opt": out}
