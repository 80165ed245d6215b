"""Multi-tenant secure-serving sessions: per-tenant keysets, pooled HE
contexts, and a compiled-program cache — counterpart of
``repro/serve/sessions.py``.

* **Tenant isolation** — every tenant gets its OWN CKKS keyset; a
  ciphertext produced under tenant A's keys is garbage under tenant B's.
  All keysets share ONE parameter set and ONE CkksEngine (NTT tables and
  basis views are key-independent), so adding a tenant costs a keygen,
  not an engine.

* **Bounded arena count** — each tenant's HEContext owns an operand arena
  (Montgomery diagonal tensors, compiled programs).  The pool keeps at
  most ``max_live`` arenas: touching a session beyond that evicts the
  least-recently-used session's ARENA (``HEContext.invalidate()``) while
  keeping its keys and encrypted weights, so a re-touched evicted tenant
  skips keygen and weight re-encryption and only re-runs operand
  precompute lazily on its next compile.  A program that
  ``HEProgramCache`` still holds keeps its own reference to its operands
  (``CompiledHLT._operands``) until the cache drops the stale entry, as
  in the reference: ``live_arena_bytes`` counts the arenas only.

* **Compile amortization** — ``HEProgramCache`` fronts
  ``compile_blockmm`` and ``compile_hemm_chain`` with a shape key and
  hit / miss / eviction counters, so every step after the first with a
  repeat shape skips planning and compilation.  The key deliberately
  EXCLUDES the aliasing hint: execution re-derives input aliasing from
  object identity (core/compile.py), so one cached program serves every
  shared-prompt pattern of the same shape.

The pool runs on CUDA unless ``device="cpu"`` is asked for (with
``mesh=``, on the mesh's device): a mesh (``launch/mesh.py``) goes to
every tenant's ``HEContext``, so ``"sharded"`` programs run over its
ranks.  The per-step batching lives in ``serve/he_batcher.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.ckks import CkksEngine
from repro_torch.core.compile import (HEContext, compile_blockmm,
                                      compile_hemm_chain)
from repro_torch.core.hemm import decrypt_matrix
from repro_torch.core.params import HEParams
from repro_torch.launch.mesh import check_mesh
from repro_torch.secure import SecureLinear, SecureMatmulEngine



@dataclasses.dataclass
class SessionStats:
    """Amortization counters for one tenant session (monotonic)."""
    keygens: int = 0          # keyset generations (1 unless keys rotated)
    touches: int = 0          # session() lookups — keygen amortization base
    arena_evictions: int = 0  # LRU arena drops (keys survived each one)
    weights_encrypted: int = 0  # secure-layer weight matrices lifted to HE

    @property
    def keygen_amortization_x(self) -> float:
        """Touches served per keygen (≥ 1 once the session is used)."""
        return self.touches / max(1, self.keygens)


class TenantSession:
    """One tenant's secure-serving state: keyset + context + HE linears.

    ``ctx`` is the tenant's HEContext (its keys, operand arena and compile
    memo); ``linears`` maps model layer index -> SecureLinear whose weight
    tiles are encrypted under THIS tenant's keys.  Sessions are built by
    SessionPool — construct directly only in tests.
    """

    def __init__(self, tenant: str, ctx: HEContext):
        self.tenant = tenant
        self.ctx = ctx
        self.engine = None              # SecureMatmulEngine (pool attaches)
        self.linears: dict = {}         # layer index -> SecureLinear
        self.stats = SessionStats()

    @property
    def keys(self):
        return self.ctx.keys

    def decrypt_row(self, ct, n: int) -> np.ndarray:
        """First matrix row of a result tile ciphertext (serving output)."""
        t = self.engine.tile
        return decrypt_matrix(self.ctx.eng, self.ctx.keys, ct, t, t)[0, :n]


class SessionPool:
    """Per-tenant TenantSessions on ONE shared engine, LRU arena eviction.

    ``session(tenant, rng)`` returns the tenant's session, creating it
    (keygen + weight encryption of the ``attach_weights`` layers) on first
    touch.  At most ``max_live`` sessions keep their operand arenas; the
    least-recently-used session past that is arena-evicted but never
    forgotten — its keyset and encrypted weights survive, so ciphertexts a
    client holds stay decryptable.

    The shared engine is ``CkksEngine(params, device=device,
    datapath="pallas")``, where the reference builds ``CkksEngine(params)``
    (its ``"xla"`` datapath): on the card the ``"xla"`` engine runs every
    product's NTTs in plain torch, which took the Set-B hemm's
    mult → rescale loop to ~8.8 s against ~0.7 s on the ``ntt``/``intt``
    kernels.  On the CPU the ``"pallas"`` engine runs the kernels' plain
    versions and gives the reference's residues.
    """

    def __init__(self, params: HEParams, *, tile: int = 8,
                 max_live: int = 4, schedule: Optional[str] = None,
                 rotation_chunk: Optional[int] = None, mesh=None,
                 verify: str = "warn", device=None):
        if check_mesh(mesh) is not None and device is None:
            device = mesh.device
        self.params = params
        self.tile = tile
        self.max_live = max(1, max_live)
        self.schedule = schedule
        self.rotation_chunk = rotation_chunk
        self.verify = verify            # static-verifier mode per session ctx
        self.mesh = mesh
        # shared: key-independent precompute
        self.eng = CkksEngine(params, device=device, datapath="pallas")
        self._sessions: dict = {}       # tenant -> TenantSession (LRU order)
        self._weights: dict = {}        # layer index -> plaintext W
        self.evictions = 0              # pool-level arena evictions

    def attach_weights(self, weights: dict) -> None:
        """Register the secure layers' plaintext weights (layer -> W); each
        NEW session encrypts them under its own keyset at creation."""
        self._weights = {i: np.asarray(W) for i, W in weights.items()}

    def session(self, tenant: str, rng: np.random.Generator) -> TenantSession:
        """Get-or-create the tenant's session; LRU-touch it; evict the
        coldest arena when more than ``max_live`` are resident."""
        sess = self._sessions.pop(tenant, None)
        if sess is None:
            sess = self._create(tenant, rng)
        self._sessions[tenant] = sess   # (re)insert as most-recently-used
        sess.stats.touches += 1
        self._evict_cold()
        return sess

    def _create(self, tenant: str, rng: np.random.Generator) -> TenantSession:
        ctx = HEContext(self.eng, verify=self.verify, mesh=self.mesh)
        sess = TenantSession(tenant, ctx)
        sess.engine = SecureMatmulEngine(
            self.params, tile=self.tile, schedule=self.schedule,
            rotation_chunk=self.rotation_chunk, mesh=self.mesh, ctx=ctx)
        sess.engine.keygen(rng)
        sess.stats.keygens += 1
        for i, W in self._weights.items():
            sess.linears[i] = SecureLinear(sess.engine, W, rng)
            sess.stats.weights_encrypted += 1
        return sess

    def _evict_cold(self) -> None:
        # the reference also counts its jit cache (ctx._jit); the port's
        # compiled programs are all in ctx._compiled
        live = [s for s in self._sessions.values()
                if len(s.ctx.arena) or s.ctx._compiled]
        # insertion order IS recency order (session() reinserts on touch)
        for sess in live[:max(0, len(live) - self.max_live)]:
            sess.ctx.invalidate()       # drop arena+programs, KEEP keys
            sess.stats.arena_evictions += 1
            self.evictions += 1

    @property
    def live_arena_bytes(self) -> int:
        return sum(s.ctx.arena.nbytes for s in self._sessions.values())

    def report(self) -> dict:
        """Pool-level amortization summary."""
        return {
            "tenants": len(self._sessions),
            "max_live": self.max_live,
            "arena_evictions": self.evictions,
            "live_arena_bytes": int(self.live_arena_bytes),
            "keygens": sum(s.stats.keygens for s in self._sessions.values()),
            "touches": sum(s.stats.touches for s in self._sessions.values()),
        }


class HEProgramCache:
    """LRU cache over ``compile_blockmm`` / ``compile_hemm_chain`` keyed by
    shape, not aliasing.

    Key: (tenant, tile m/l/n, grid, level, schedule, rotation_chunk, mesh
    factorization ``ctx.n_model, ctx.n_ct``, verify mode) — the
    reference's fields.  Toggling ``ctx.verify`` must never return a program compiled
    under different verification, so the mode is part of the key.  The
    per-step aliasing pattern (which requests share a prompt) is NOT in
    the key: BlockMMProgram re-derives aliasing from object identity at
    call time, so one cached program is bit-exact for every sharing
    pattern of the same shape.

    A cached program is only valid for its context generation: an arena
    eviction (SessionPool) or re-keygen bumps the generation, and the next
    lookup of that key drops the stale entry (counted as an eviction) and
    recompiles.  Until then the stale entry keeps its program, and with it
    the program's operands, as the reference's does.
    """

    def __init__(self, capacity: int = 32):
        self.capacity = max(1, capacity)
        self._entries: dict = {}        # key -> (program, generation)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _lookup(self, key, ctx: HEContext, compile_fn):
        hit = self._entries.pop(key, None)
        if hit is not None and hit[1] == ctx._generation:
            self.hits += 1
            self._entries[key] = hit    # reinsert as most-recently-used
            return hit[0]
        if hit is not None:             # stale generation: arena was evicted
            self.evictions += 1
        self.misses += 1
        prog = compile_fn()
        while len(self._entries) >= self.capacity:
            self._entries.pop(next(iter(self._entries)))
            self.evictions += 1
        self._entries[key] = (prog, ctx._generation)
        return prog

    def get(self, sess: TenantSession, plan, grid, *, level: int,
            schedule: Optional[str] = None,
            rotation_chunk: Optional[int] = None,
            a_slots=None, b_slots=None):
        """The serving entry point to compile_blockmm (counted)."""
        ctx = sess.ctx
        key = (sess.tenant, plan.m, plan.l, plan.n, tuple(grid), level,
               schedule, rotation_chunk, ctx.n_model, ctx.n_ct, ctx.verify)
        return self._lookup(key, ctx, lambda: compile_blockmm(
            ctx, plan, grid, level=level, schedule=schedule,
            rotation_chunk=rotation_chunk, a_slots=a_slots, b_slots=b_slots))

    def get_chain(self, sess: TenantSession, chain, *,
                  level: Optional[int] = None,
                  schedule: Optional[str] = None,
                  rotation_chunk: Optional[int] = None):
        """The serving entry point to ``compile_hemm_chain`` (counted):
        per-tenant compiled multi-hop programs, keyed by the chain dims +
        re-pack mode and generation-checked like ``get``.  The port's
        ``compile_hemm_chain`` forces one ``schedule`` on every hop where
        the reference takes a tuple of them; the key holds it in that
        field."""
        ctx = sess.ctx
        key = (sess.tenant, "chain", chain.dims, chain.repack, level,
               schedule, rotation_chunk, ctx.n_model, ctx.n_ct, ctx.verify)
        return self._lookup(key, ctx, lambda: compile_hemm_chain(
            ctx, chain, level=level, schedule=schedule,
            rotation_chunk=rotation_chunk))

    def report(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._entries),
                "capacity": self.capacity}
