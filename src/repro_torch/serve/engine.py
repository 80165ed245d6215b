"""Batched serving engine — counterpart of ``repro/serve/engine.py``:
prefill and decode steps over a KV cache, continuous-batching slot
management (host-side scheduler, device-side steps), and the secure (HE)
serving configuration and wiring.

``ServeConfig`` keeps every field of the reference's;
``build_secure_serving`` builds the multi-tenant tier (``SessionPool``,
``HEProgramCache``, ``CrossRequestHEBatcher``) and ``build_secure_linears``
the single-engine secure layers; ``ContinuousBatcher`` decodes every
family of ``models/transformer.py`` and, given a ``SecureServing`` bundle,
sends each decode step's secure-layer calls through the tier as one flush.
Everything runs on CUDA unless ``device="cpu"`` is asked for (the batcher
runs where its parameters lie).

``ServeConfig(he_mesh=)`` (a ``launch/mesh.py`` mesh) goes to the secure
tier's contexts: its programs may run ``"sharded"`` over the mesh's
ranks.

On a mesh (the current rules of ``distributed/sharding.py``) the model
runs on a rank's blocks (``models/``) and the cache holds a rank's blocks
of ``cache_shardings``: the batch over the batch axes, the KV heads over
``model`` (or the sequence, ``seq_sp``, when they do not divide it: in
blocks of ⌈L / model⌉ when the model axis does not divide L), the
SSM state's heads and the conv channels (packed x | B | C) over
``model``.  ``make_sharded_serve_steps`` returns prefill and decode
steps over that layout.  ``ContinuousBatcher`` runs the same ``step()``
on every rank: a one-request prefill runs whole on every data rank and
the rank holding the slot keeps it; a decode step runs each data rank's
slots, and the logits are gathered over ``model`` (the vocabulary) and
the batch axes, so every rank samples the same tokens from the same
seeded rng (a token that differed would hang the next collective).  With
``ServeConfig(he_mesh=)`` set to the LM's own mesh the secure flush runs
the sharded HLT on the same ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.params import toy_params
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.secure import SecureLinear, SecureMatmulEngine
from repro_torch.serve.he_batcher import CrossRequestHEBatcher, SecureCall
from repro_torch.serve.sessions import HEProgramCache, SessionPool


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    temperature: float = 0.0       # 0 = greedy; >0 = seeded categorical
    seed: int = 0                  # sampling rng seed (determinism tests)
    # secure (HE) layer serving.  he_schedule=None defers to the cost model
    # (select_schedule); setting it is the DEPRECATED override.  he_mesh (a
    # launch.mesh.Mesh with pod/data/model axes) makes schedule="sharded"
    # available to the secure tier; the cost model picks it when worthwhile.
    he_schedule: Optional[str] = None
    he_tile: int = 8
    he_rotation_chunk: Optional[int] = None   # None = the cost model's pick
    he_mesh: Optional[object] = None          # None = single device
    # multi-tenant secure serving (serve/sessions.py + serve/he_batcher.py)
    he_max_sessions: int = 4       # tenant arenas kept live (LRU eviction)
    he_max_programs: int = 32      # HEProgramCache capacity
    he_batch_requests: bool = True  # False = per-request launches (ablation)


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
    engine = SecureMatmulEngine(
        he_params if he_params is not None else _default_params(),
        tile=scfg.he_tile, schedule=scfg.he_schedule,
        rotation_chunk=scfg.he_rotation_chunk, mesh=scfg.he_mesh,
        device=device)
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
    pool = SessionPool(
        he_params if he_params is not None else _default_params(),
        tile=scfg.he_tile, max_live=scfg.he_max_sessions,
        schedule=scfg.he_schedule, rotation_chunk=scfg.he_rotation_chunk,
        mesh=scfg.he_mesh, verify=verify, device=device)
    pool.attach_weights({i: np.asarray(W) for i, W in weights.items()
                         if i in cfg.secure_layers})
    cache = HEProgramCache(capacity=scfg.he_max_programs)
    batcher = CrossRequestHEBatcher(pool, cache, rng=rng,
                                    batch_requests=scfg.he_batch_requests)
    return SecureServing(pool=pool, cache=cache, batcher=batcher)


def serve_prefill_step(cfg: ModelConfig, params, tokens, cache,
                       start: int = 0):
    """One prefill of the sequence (or of a chunk of it from position
    ``start``).  For [audio] archs the input is precomputed frame
    embeddings (float), not tokens."""
    if tokens.is_floating_point():
        return tf.prefill(cfg, params, None, cache, embeds=tokens,
                          start=start)
    return tf.prefill(cfg, params, tokens, cache, start=start)


def serve_decode_step(cfg: ModelConfig, params, token, cache, pos):
    """One new token (or frame embedding) against the cache."""
    if token.is_floating_point():
        return tf.decode_step_embeds(cfg, params, token, cache, pos)
    return tf.decode_step(cfg, params, token, cache, pos)


def _gather_rows(t: torch.Tensor) -> torch.Tensor:
    """A batch-split tensor's rows from every data rank (``t`` itself off
    a mesh or outside a batch split)."""
    R = sh.ranks()
    if R is None or R.D == 1:
        return t
    return coll.gather_cat(t, R.batch_group, R.D, 0)


def _local_rows(t, batch: int):
    R = sh.ranks()
    if R is None or R.D == 1 or batch % R.D:
        return t
    per = batch // R.D
    return t[R.d * per:(R.d + 1) * per]


def make_sharded_serve_steps(cfg: ModelConfig, mesh, params_shapes,
                             batch: int, max_len: int):
    """Prefill and decode steps on ``mesh`` (the current rules' mesh) for
    a cache of ``batch`` × ``max_len``: ``prefill(params, tokens, cache,
    start=0)`` and ``decode(params, token, cache, pos)`` take the global
    tokens (and positions), run the rank's rows (when the batch axes
    divide ``batch``) on the rank's blocks, write the rank's cache blocks
    in place and return every logit on every rank; and the cache's
    placements.  ``params_shapes`` is checked against
    ``param_shardings``."""
    from repro_torch.train.train_step import param_shardings
    from repro_torch.tree import leaves, leaves_with_paths
    rules = sh.get_rules()
    if rules.mesh is not mesh:
        raise ValueError("install the mesh's rules first: "
                         "sharding.set_rules(sharding.make_rules(mesh))")
    whole = tf.abstract_params(cfg)
    want = param_shardings(cfg, whole, rules)
    for (path, t), w, q in zip(leaves_with_paths(params_shapes),
                               leaves(whole), leaves(want), strict=True):
        if tuple(t.shape) != q.local_shape(w.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: {tuple(t.shape)}"
                             f" on this rank, its placement gives "
                             f"{q.local_shape(w.shape)}")
    cache_sh = tf.cache_placements(cfg, batch, max_len)
    R = sh.ranks(rules)
    split = R.D > 1 and batch % R.D == 0

    def prefill(params, tokens, cache, start=0):
        with sh.batch_split(split):
            logits, cache = serve_prefill_step(
                cfg, params, _local_rows(tokens, batch), cache, start)
            return (_gather_rows(logits) if split else logits), cache

    def decode(params, token, cache, pos):
        if isinstance(pos, torch.Tensor) and pos.ndim:
            pos = _local_rows(pos, batch)
        with sh.batch_split(split):
            logits, cache = serve_decode_step(
                cfg, params, _local_rows(token, batch), cache, pos)
            return (_gather_rows(logits) if split else logits), cache

    return prefill, decode, cache_sh


def cache_shardings(rules, cache_shapes, seq_shard_kv: bool = False,
                    cfg: Optional[ModelConfig] = None):
    """Path-aware cache placements (divisibility-checked), the
    reference's rules:
      kv k/v (nb, sub, B, S, KV, hd): batch over data; kv_heads over model,
        falling back to sequence-sharded KV (SP) when KV doesn't divide
        (where the reference would replicate a sequence the model axis
        does not divide, blocks of ⌈S / model⌉: ``Placement.ceil``);
      ssm h (nb, sub, B, H, hd, n): heads over model;
      ssm conv (nb, sub, B, K-1, C): channels over model (with ``cfg``, by
        the packed x | B | C segments, ``models/ssm.py``; whole when the
        SSM heads do not split the model axis).

    seq_shard_kv=True additionally shards the KV sequence over the
    ``seq_data`` logical axis (unmapped by the default rules).  Returns a
    tree of Placements (None leaves without a mesh)."""
    from repro_torch.distributed.sharding import (logical_axis_size,
                                                  sanitize_spec)
    from repro_torch.models.ssm import packed_segments, ssm_replicated
    from repro_torch.tree import leaves_with_paths, unflatten

    def to_sh(path, leaf):
        dims = tuple(leaf.shape)
        segments = ceil = None
        if "kv" in path:
            spec = [None, None, "batch", None, "kv_heads", None]
            if dims[4] % logical_axis_size(rules, "kv_heads") != 0:
                spec[4] = None
                spec[3] = "seq_sp"           # shard the KV sequence instead
                if dims[3] % logical_axis_size(rules, "seq_sp"):
                    ceil = (3, dims[3])      # in blocks of ⌈S / model⌉
            elif seq_shard_kv:
                spec[3] = "seq_data"         # data axis; heads keep model
        elif path[-1] == "h":
            spec = [None, None, "batch", "heads", None, None][: leaf.ndim]
        elif path[-1] == "conv":
            spec = [None, None, "batch", None, "ff"]
            if cfg is not None and ssm_replicated(
                    cfg, logical_axis_size(rules, "heads")):
                spec[4] = None               # the layer runs whole
            elif cfg is not None:
                segments = (4, packed_segments(cfg, "conv_w"))
        else:
            spec = [None] * leaf.ndim
        logical = sanitize_spec(rules, spec, dims)
        if segments is not None and logical[4] is None:
            segments = None
        if ceil is not None:                 # kept where sanitize drops it
            logical = logical[:3] + ("seq_sp",) + logical[4:]
        if rules.mesh is None:
            return None
        return rules.sharding(*logical, segments=segments, ceil=ceil)

    return unflatten(cache_shapes, [to_sh(path, leaf) for path, leaf
                                    in leaves_with_paths(cache_shapes)])


class ContinuousBatcher:
    """Host-side continuous batching: fixed device batch of slots; finished
    sequences are replaced by queued requests between decode steps.

    Each slot decodes at ITS OWN position (slots admitted at different
    prompt lengths pass a per-slot position vector to ``decode_step``), and
    sampling follows ``ServeConfig.temperature``: greedy at 0, seeded
    categorical above (a numpy rng seeded from ``ServeConfig.seed`` on the
    host, as the reference's, so seeded runs draw the same tokens).

    ``secure`` (a :class:`SecureServing` bundle from
    ``build_secure_serving``) turns on the secure-layer path: every decode
    step, each active request submits ONE SecureCall per layer in
    ``cfg.secure_layers`` — the just-decoded token's embedding row to be
    projected under that request's TENANT keyset — and a single flush runs
    them all as one launch per (tenant, layer).  Per-request secure outputs
    accumulate in ``secure_results``; per-step launch/dedup stats in
    ``secure.batcher.steps``.  The model, its cache and the sampling
    inputs live on the parameters' device.

    ``step()`` opens a scope (``core/trace.py``) on the batcher's own
    ``counters``: span ``lm.prefill`` a request admitted, ``lm.step`` the
    decode step after admission (the secure flush, the model, the logits'
    copy to the host and the sampling), the model's spans inside them
    (``lm.ssm``, ``lm.attn``, ``lm.moe``), counter ``lm.tokens`` (tokens
    decoded) and ``lm.moe.dropped`` (routed pairs past an expert's
    capacity, a device tensor).  ``last_logits`` holds the last decode
    step's float32 logits on the host, a row a slot.
    """

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params,
                 secure: Optional[SecureServing] = None):
        self.cfg, self.scfg, self.params = cfg, scfg, params
        self.device = params["embed"].device
        self.cache = tf.init_cache(cfg, scfg.max_batch, scfg.max_len,
                                   device=self.device)
        R = sh.ranks()
        # on a mesh, the batch axes hold the slots when they divide them
        self._split = (R is not None and R.D > 1
                       and scfg.max_batch % R.D == 0)
        self._per = scfg.max_batch // R.D if self._split else scfg.max_batch
        self._first = R.d * self._per if self._split else 0
        self.slots: list[Optional[dict]] = [None] * scfg.max_batch
        self.queue: list[dict] = []
        self.results: dict[int, list[int]] = {}
        self.secure = secure
        self.secure_results: dict[int, list] = {}
        self._next_id = 0
        self._rng = np.random.default_rng(scfg.seed)
        self.counters: dict = {}
        self.last_logits: Optional[np.ndarray] = None

    def submit(self, prompt_tokens: np.ndarray, max_new: int,
               tenant: str = "default") -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append({"id": rid, "prompt": prompt_tokens,
                           "max_new": max_new, "done": 0, "tenant": tenant})
        self.results[rid] = []
        self.secure_results[rid] = []
        return rid

    def _sample(self, logits_row: np.ndarray) -> int:
        """Greedy at temperature 0, seeded categorical above."""
        t = self.scfg.temperature
        if t <= 0:
            return int(np.argmax(logits_row))
        z = np.asarray(logits_row, np.float64) / t
        z -= z.max()                      # stable softmax
        p = np.exp(z)
        return int(self._rng.choice(len(p), p=p / p.sum()))

    def _admit(self):
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                req = self.queue.pop(0)
                # per-slot prefill into a batch-1 cache, copied into slot i
                cache1 = tf.init_cache(self.cfg, 1, self.scfg.max_len,
                                       device=self.device)
                prompt = torch.as_tensor(req["prompt"], device=self.device)
                with trace.span("lm.prefill"):
                    logits, cache1 = tf.prefill(self.cfg, self.params,
                                                prompt[None], cache1)
                j = i - self._first          # the slot on this rank
                if 0 <= j < self._per:
                    for g, tree in self.cache.items():   # kv and ssm leaves
                        for name, c in tree.items():
                            c[:, :, j:j + 1].copy_(cache1[g][name])
                tok = self._sample(logits[0, -1].cpu().numpy())
                self.results[req["id"]].append(tok)
                req["pos"] = req["prompt"].shape[0]
                req["last"] = tok
                self.slots[i] = req

    def _secure_step(self, active) -> None:
        """Fold every active request's secure-layer calls into one flush
        (one launch per tenant per layer — serve/he_batcher.py).  Only the
        active slots' embedding rows leave the device, as float64 (exact
        from bf16 and f32)."""
        last = torch.tensor([self.slots[i]["last"] for i in active],
                            device=self.device)
        if sh.get_rules().mesh is None:
            rows = self.params["embed"][last]
        else:
            rows = tf.embed_rows(self.cfg, self.params, last)
        rows = rows.double().cpu().numpy()
        for i, x in zip(active, rows):
            s = self.slots[i]
            for layer in self.cfg.secure_layers:
                self.secure.batcher.submit(
                    SecureCall(s["id"], layer, x, s["tenant"]))
        res = self.secure.batcher.flush()
        for i in active:
            s = self.slots[i]
            self.secure_results[s["id"]].append(
                {layer: res[(s["id"], layer)]
                 for layer in self.cfg.secure_layers})

    def step(self) -> bool:
        """One decode step over all active slots. Returns False when idle."""
        with trace.scope(self.counters):
            self._admit()
            active = [i for i, s in enumerate(self.slots) if s is not None]
            if not active:
                return False
            with trace.span("lm.step"):
                self._decode(active)
            trace.count("lm.tokens", len(active))
        return True

    def _decode(self, active: list) -> None:
        """The decode step of the ``active`` slots, sampled."""
        if self.secure is not None:
            self._secure_step(active)
        toks = np.zeros((self.scfg.max_batch, 1), np.int64)
        # per-slot positions: each slot decodes against ITS cache length —
        # inactive slots get 0 (their writes are overwritten by the next
        # admit's prefill, and their sampled tokens are never read)
        pos = np.zeros((self.scfg.max_batch,), np.int64)
        for i in active:
            toks[i, 0] = self.slots[i]["last"]
            pos[i] = self.slots[i]["pos"]
        toks = torch.as_tensor(toks, device=self.device)
        pos = torch.as_tensor(pos, device=self.device)
        if self._split:
            rows = slice(self._first, self._first + self._per)
            with sh.batch_split():
                logits, self.cache = tf.decode_step(
                    self.cfg, self.params, toks[rows], self.cache, pos[rows])
                logits = _gather_rows(logits)
        else:
            logits, self.cache = tf.decode_step(self.cfg, self.params, toks,
                                                self.cache, pos)
        logits = self.last_logits = logits[:, 0].cpu().numpy()
        for i in active:
            s = self.slots[i]
            s["last"] = self._sample(logits[i])
            s["pos"] += 1
            s["done"] += 1
            self.results[s["id"]].append(s["last"])
            if s["done"] >= s["max_new"] or s["pos"] >= self.scfg.max_len - 1:
                self.slots[i] = None
