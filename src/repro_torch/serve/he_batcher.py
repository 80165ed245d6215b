"""Cross-request HE batching: one program launch per (tenant, layer) a
step — counterpart of ``repro/serve/he_batcher.py``.

* each step, every in-flight request SUBMITs its secure-layer call (the
  activation row to be multiplied by that layer's encrypted weights);
* FLUSH groups the calls by (tenant, layer) — HE ops can only combine
  ciphertexts under one keyset — and runs each group as ONE
  ``BlockMMProgram`` over the stacked activation tile rows: every request
  is one tile row of a single (R × gl)·(gl × gn) block MM, so the whole
  group is 2 slot-indexed HLT launches instead of 2·R·gl·gn;
* identical activation tiles (requests sharing a prompt) are encrypted
  ONCE per flush and submitted as the SAME ciphertext object, so the
  program's identity dedup hoists them once, which StepStats reports as
  hoist bytes saved.

A step issues one program launch per (tenant, layer) group, never per
request; ``StepStats`` records both from ``HEContext.counters`` deltas.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.costmodel import serve_amortization
from repro_torch.core.hemm import decrypt_matrix, encrypt_matrix
from repro_torch.serve.sessions import HEProgramCache, SessionPool


@dataclasses.dataclass
class SecureCall:
    """One request's secure-layer call for the current step."""
    request_id: int
    layer: int                    # model layer index (ModelConfig.secure_layers)
    x: np.ndarray                 # (n_in,) activation row
    tenant: str = "default"


@dataclasses.dataclass
class StepStats:
    """What one flush did — the per-step amortization record."""
    step: int
    n_calls: int                  # secure calls folded into this step
    n_groups: int                 # (tenant, layer) groups = expected launches
    program_launches: int         # counter delta: MUST equal n_groups
    hlt_launches: int             # counter delta: 2 per group
    n_tiles: int                  # activation tiles submitted
    n_uniq_tiles: int             # after shared-prompt aliasing
    cache_hits: int               # HEProgramCache delta
    cache_misses: int
    amortization: dict            # costmodel.serve_amortization report


class CrossRequestHEBatcher:
    """Collects SecureCalls and flushes them as one launch per group.

    ``batch_requests=False`` is the ablation baseline: the same calls run
    as one BlockMMProgram PER REQUEST (grid 1×gl×gn each).

    ``stage_hook``, when set, is called with each flush stage's name as it
    ends, as ``BlockMMProgram.stage_hook`` is: ``"sessions"`` once (the
    tenants touched: keygen of a new one, arena evictions), then
    ``"encrypt"``, ``"program"``, ``"decrypt"`` for each group.
    """

    def __init__(self, pool: SessionPool, cache: Optional[HEProgramCache] = None,
                 rng: Optional[np.random.Generator] = None,
                 batch_requests: bool = True):
        self.pool = pool
        self.cache = HEProgramCache() if cache is None else cache
        self.rng = np.random.default_rng(0) if rng is None else rng
        self.batch_requests = batch_requests
        self.steps: list = []          # StepStats history
        self._pending: list = []
        self.stage_hook = None

    def submit(self, call: SecureCall) -> None:
        self._pending.append(call)

    def _mark(self, name: str) -> None:
        if self.stage_hook is not None:
            self.stage_hook(name)

    # -- one step ------------------------------------------------------------

    def flush(self) -> dict:
        """Run every pending call; returns {(request_id, layer): y row}.

        Empty flushes record nothing (idle steps don't count launches).
        """
        calls, self._pending = self._pending, []
        if not calls:
            return {}
        groups: dict = {}
        for c in calls:
            groups.setdefault((c.tenant, c.layer), []).append(c)
        sessions = {t: self.pool.session(t, self.rng)
                    for t in {c.tenant for c in calls}}
        self._mark("sessions")
        before = {t: dict(s.ctx.counters) for t, s in sessions.items()}
        ch, cm = self.cache.hits, self.cache.misses

        results: dict = {}
        n_tiles = n_uniq = naive = 0
        for (tenant, layer), group in groups.items():
            sess = sessions[tenant]
            stats = self._run_group(sess, layer, group, results)
            n_tiles += stats["tiles"]
            n_uniq += stats["uniq"]
            naive += stats["naive_launches"]

        launches = sum(sessions[t].ctx.counters["program_launches"]
                       - before[t]["program_launches"] for t in sessions)
        hlts = sum(sessions[t].ctx.counters["hlt_launches"]
                   - before[t]["hlt_launches"] for t in sessions)
        self.steps.append(StepStats(
            step=len(self.steps), n_calls=len(calls), n_groups=len(groups),
            program_launches=launches, hlt_launches=hlts,
            n_tiles=n_tiles, n_uniq_tiles=n_uniq,
            cache_hits=self.cache.hits - ch,
            cache_misses=self.cache.misses - cm,
            amortization=serve_amortization(
                self.pool.params, n_calls=len(calls), n_tiles=n_tiles,
                n_uniq_tiles=n_uniq, launches=launches,
                launches_naive=naive)))
        return results

    def _encrypt_group(self, sess, group: list, gl: int):
        """Each request's activation row as its own 1×gl tile row, drawn
        from ``self.rng``; identical tile content (shared prompts) encrypts
        ONCE and reuses the SAME ciphertext object, so the program hoists
        it once.  Returns (A_tiles, a_slots, unique tile count)."""
        t = sess.engine.tile
        enc_cache: dict = {}
        A_tiles, a_slots = [], []
        for c in group:
            x = np.zeros(gl * t)
            x[: len(c.x)] = np.asarray(c.x, dtype=np.float64)
            row = []
            for k in range(gl):
                tile = np.zeros((t, t))
                tile[0] = x[k * t:(k + 1) * t]
                key = tile.tobytes()
                if key not in enc_cache:
                    enc_cache[key] = (len(enc_cache), encrypt_matrix(
                        sess.ctx.eng, sess.ctx.keys, tile, self.rng))
                slot, ct = enc_cache[key]
                a_slots.append(slot)
                row.append(ct)
            A_tiles.append(row)
        return A_tiles, a_slots, len(enc_cache)

    def _run_group(self, sess, layer: int, group: list, results: dict) -> dict:
        """One (tenant, layer) group: stack request rows into one block MM."""
        eng = sess.engine
        lin = sess.linears[layer]
        w_tiles = lin._w_tiles                  # gl × gn (tenant-encrypted)
        gl, gn = len(w_tiles), len(w_tiles[0])
        t = eng.tile
        level = w_tiles[0][0].level
        A_tiles, a_slots, n_enc = self._encrypt_group(sess, group, gl)
        self._mark("encrypt")
        R = len(group)
        if self.batch_requests:
            prog = self.cache.get(
                sess, eng._plan, (R, gl, gn), level=level,
                schedule=eng.schedule, rotation_chunk=eng.rotation_chunk,
                a_slots=tuple(a_slots))
            C = prog(A_tiles, w_tiles)
        else:                           # per-request baseline
            C = []
            for r in range(R):
                prog = self.cache.get(
                    sess, eng._plan, (1, gl, gn), level=level,
                    schedule=eng.schedule,
                    rotation_chunk=eng.rotation_chunk)
                C.extend(prog([A_tiles[r]], w_tiles))
        self._mark("program")
        n_out = lin.W.shape[1]
        for r, c in enumerate(group):
            y = np.concatenate([
                decrypt_matrix(sess.ctx.eng, sess.ctx.keys, C[r][j], t, t)[0]
                for j in range(gn)])
            results[(c.request_id, c.layer)] = y[:n_out]
        self._mark("decrypt")
        return {"tiles": R * gl + gl * gn,
                "uniq": n_enc + gl * gn,
                "naive_launches": R * gl * gn}

    # -- reporting -----------------------------------------------------------

    def report(self) -> dict:
        """Aggregate over all steps."""
        if not self.steps:
            return {"steps": 0}
        return {
            "steps": len(self.steps),
            "calls": sum(s.n_calls for s in self.steps),
            "program_launches": sum(s.program_launches for s in self.steps),
            "launches_per_step": (sum(s.program_launches for s in self.steps)
                                  / len(self.steps)),
            "hoist_saved_bytes": sum(
                s.amortization["hoist_dedup_saved_bytes"] for s in self.steps),
            "cache": self.cache.report(),
            "pool": self.pool.report(),
        }
