"""Secure (HE) serving configuration and wiring — the secure-serving part
of ``repro/serve/engine.py``.

``ServeConfig`` keeps every field of the reference's; ``build_secure_serving``
builds the multi-tenant tier (``SessionPool``, ``HEProgramCache``,
``CrossRequestHEBatcher``) and ``build_secure_linears`` the single-engine
secure layers.  Both run on CUDA unless ``device="cpu"`` is asked for.

Not ported yet:
* ``he_mesh`` (a mesh for the multi-device schedule) and
  ``make_sharded_serve_steps`` / ``cache_shardings``: ROADMAP queue 1
  item 9; ``he_mesh`` other than ``None`` is refused;
* ``ContinuousBatcher`` and ``serve_prefill_step`` / ``serve_decode_step``
  (the LM decode loop that submits to the secure tier) and the models
  they step: item 10.  Until then the tier is driven directly, one
  ``SecureCall`` per request and layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.params import toy_params
from repro_torch.models.common import ModelConfig
from repro_torch.secure import SecureLinear, SecureMatmulEngine
from repro_torch.serve.he_batcher import CrossRequestHEBatcher
from repro_torch.serve.sessions import HEProgramCache, SessionPool


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    temperature: float = 0.0       # 0 = greedy; >0 = seeded categorical
    seed: int = 0                  # sampling rng seed (determinism tests)
    # secure (HE) layer serving.  he_schedule=None defers to the cost model
    # (select_schedule); setting it is the DEPRECATED override.  he_mesh is
    # the reference's multi-device schedule: not ported, must stay None.
    he_schedule: Optional[str] = None
    he_tile: int = 8
    he_rotation_chunk: Optional[int] = None   # None = the cost model's pick
    he_mesh: Optional[object] = None          # None = single device
    # multi-tenant secure serving (serve/sessions.py + serve/he_batcher.py)
    he_max_sessions: int = 4       # tenant arenas kept live (LRU eviction)
    he_max_programs: int = 32      # HEProgramCache capacity
    he_batch_requests: bool = True  # False = per-request launches (ablation)


def _check_mesh(scfg: ServeConfig) -> None:
    if scfg.he_mesh is not None:
        raise NotImplementedError(
            "ServeConfig(he_mesh=...): the multi-device schedule is not "
            "ported yet (ROADMAP queue 1 item 9)")


def _default_params():
    return toy_params(logN=7, L=4, k=3, beta=2)


def build_secure_linears(cfg: ModelConfig, scfg: ServeConfig, weights: dict,
                         rng: np.random.Generator, he_params=None,
                         device=None) -> dict:
    """Construct SecureLinear layers for ``cfg.secure_layers`` sharing ONE
    SecureMatmulEngine (one HEContext: CKKS engine + key set + operand
    arena), wired to the serving config's HE knobs. ``weights`` maps layer
    index -> (in, out) weight matrix; only indices flagged secure are lifted
    to HE."""
    if not cfg.secure_layers:
        return {}
    _check_mesh(scfg)
    engine = SecureMatmulEngine(
        he_params if he_params is not None else _default_params(),
        tile=scfg.he_tile, schedule=scfg.he_schedule,
        rotation_chunk=scfg.he_rotation_chunk, device=device)
    return {i: SecureLinear(engine, np.asarray(W), rng)
            for i, W in weights.items() if i in cfg.secure_layers}


@dataclasses.dataclass
class SecureServing:
    """The multi-tenant secure-serving bundle: session pool (per-tenant
    keysets), program cache, cross-request batcher."""
    pool: SessionPool
    cache: HEProgramCache
    batcher: CrossRequestHEBatcher

    def report(self) -> dict:
        return self.batcher.report()


def build_secure_serving(cfg: ModelConfig, scfg: ServeConfig, weights: dict,
                         rng: np.random.Generator, he_params=None,
                         verify: str = "warn",
                         device=None) -> Optional[SecureServing]:
    """Construct the secure-serving subsystem for ``cfg.secure_layers``:
    a SessionPool over shared HE params (each tenant keygens lazily on its
    first request and encrypts the secure layers' weights under its OWN
    keyset), an HEProgramCache, and the CrossRequestHEBatcher that folds
    every in-flight request's secure calls into one launch per
    (tenant, layer) each step.  ``verify`` is each tenant context's
    static-verifier mode (``SessionPool(verify=)``).  Returns None when no
    layer is flagged secure."""
    if not cfg.secure_layers:
        return None
    _check_mesh(scfg)
    pool = SessionPool(
        he_params if he_params is not None else _default_params(),
        tile=scfg.he_tile, max_live=scfg.he_max_sessions,
        schedule=scfg.he_schedule, rotation_chunk=scfg.he_rotation_chunk,
        verify=verify, device=device)
    pool.attach_weights({i: np.asarray(W) for i, W in weights.items()
                         if i in cfg.secure_layers})
    cache = HEProgramCache(capacity=scfg.he_max_programs)
    batcher = CrossRequestHEBatcher(pool, cache, rng=rng,
                                    batch_requests=scfg.he_batch_requests)
    return SecureServing(pool=pool, cache=cache, batcher=batcher)
