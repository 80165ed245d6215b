"""Multi-tenant secure serving: the port's ``SessionPool`` /
``HEProgramCache`` / ``CrossRequestHEBatcher`` / ``build_secure_serving``
(``repro_torch.serve``) against the reference's (``repro.serve``).

One scripted session runs on each package from the same numpy seeds, at
the reference tests' size (``toy_params(logN=6, L=4, k=3, beta=2)``,
tile 4, W 8×4, ``he_max_sessions=2``): the pool is built by
``build_secure_serving`` as ``tests/test_serve_secure.py``'s two-tenant
case builds it, and its steps are that file's HE cases in turn — one
launch for all of a tenant's requests, program-cache hits on repeat
shapes, shared-prompt tiles hoisted once, one launch per tenant, LRU
arena eviction with keys kept, and the per-request ablation replayed on
the same ciphertexts.  Every step's decrypted rows are held array-equal,
every ``StepStats`` field (the amortization dict included) equal, and
``pool.report()`` (but ``live_arena_bytes``, which is the port's own
arena) and the cache's counters equal after every step.

The reference runs its kernel-free ``"mo"`` block MM (the deprecated
``he_schedule`` knob; its first XLA compiles are the file's cost, and its
``"pallas"`` block MM is held against the port's in
``test_torch_costmodel.py``); the port runs its default, the cost
model's ``"pallas"``, on ``device="cpu"``.  The two give the same
residues.
"""
import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.core.hemm import decrypt_matrix as j_decrypt_matrix
from repro.core.hemm import encrypt_matrix as j_encrypt_matrix
from repro.core.params import toy_params as j_toy_params
from repro.models.common import ModelConfig as JModelConfig
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import build_secure_linears as j_build_secure_linears
from repro.serve.engine import build_secure_serving as j_build_secure_serving
from repro.serve.he_batcher import SecureCall as JSecureCall

from repro_torch.configs.fame_sets import FAME_CHAIN_SETS
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.compile import HEContext, compile_hemm_chain
from repro_torch.core.hemm import decrypt_matrix, encrypt_matrix, plan_hemm_chain
from repro_torch.core.params import toy_params
from repro_torch.models.common import ModelConfig
from repro_torch.serve import (HEProgramCache, SecureCall, ServeConfig,
                               SessionPool, TenantSession,
                               build_secure_linears, build_secure_serving)
from test_torch_common import CPU

TOY = dict(logN=6, L=4, k=3, beta=2)
TOL = 0.1          # decrypted row against x @ W (the reference tests' bound)
REF = types.SimpleNamespace(
    ModelConfig=JModelConfig, ServeConfig=JServeConfig,
    build=j_build_secure_serving, build_linears=j_build_secure_linears,
    SecureCall=JSecureCall, encrypt=j_encrypt_matrix,
    decrypt=j_decrypt_matrix, params=j_toy_params(**TOY),
    scfg=dict(he_schedule="mo"), kw={})
PORT = types.SimpleNamespace(
    ModelConfig=ModelConfig, ServeConfig=ServeConfig,
    build=build_secure_serving, build_linears=build_secure_linears,
    SecureCall=SecureCall, encrypt=encrypt_matrix, decrypt=decrypt_matrix,
    params=toy_params(**TOY), scfg={}, kw=dict(device=CPU))

#: the scripted session's steps, by the reference case they stand for
CASES = {
    "one_launch": (0,),          # 3 requests of one tenant, one launch
    "cache_hits": (1, 2),        # the same shape again: hits only
    "shared_prompt": (3,),       # 3 identical rows: one ciphertext a tile
    "per_tenant": (4,),          # tenants A and B: one launch each
    "lru_eviction": (5, 6),      # evict the coldest arena, re-touch it
    "per_request": (7,),         # batch_requests=False, step 6 replayed
}


def _model_cfg(ns, secure=(0,)):
    return ns.ModelConfig(name="t", family="dense", num_layers=1, d_model=8,
                          num_heads=2, d_ff=16, vocab_size=16,
                          dtype="float32", remat=False, secure_layers=secure)


def _rows(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(8) for _ in range(n)]


def run_script(ns) -> dict:
    """The scripted session on one package: per step, its calls, decrypted
    rows, StepStats, reports and each tenant's keys and arena bytes."""
    with warnings.catch_warnings():
        # the reference's he_schedule="mo" warns at every session it makes
        warnings.simplefilter("ignore", DeprecationWarning)
        return _run_script(ns)


def _run_script(ns) -> dict:
    rng = np.random.default_rng(9)
    W = rng.standard_normal((8, 4)) * 0.4
    sv = ns.build(_model_cfg(ns), ns.ServeConfig(
        he_tile=4, he_max_sessions=2, **ns.scfg), {0: W}, rng,
        he_params=ns.params, **ns.kw)
    bat, pool = sv.batcher, sv.pool
    out = {"W": W, "pool": pool, "cache": sv.cache, "batcher": bat,
           "steps": []}

    def step(calls, note=""):
        for c in calls:
            bat.submit(c)
        res = bat.flush()
        out["steps"].append(dict(
            note=note, calls=calls, res=res,
            stats=dataclasses.asdict(bat.steps[-1]),
            pool=pool.report(), cache=sv.cache.report(),
            keys={t: s.keys for t, s in pool._sessions.items()},
            keygens={t: s.stats.keygens for t, s in pool._sessions.items()},
            arena={t: s.ctx.arena.nbytes for t, s in pool._sessions.items()},
            live=pool.live_arena_bytes))

    C = ns.SecureCall
    step([C(r, 0, x) for r, x in enumerate(_rows(2, 3))], "one_launch")
    for seed in (5, 6):
        step([C(r, 0, x) for r, x in enumerate(_rows(seed, 3))], "repeat")
    x = _rows(4, 1)[0]
    step([C(r, 0, x.copy()) for r in range(3)], "shared prompt")
    step([C(r, 0, x, tenant="AB"[r % 2])
          for r, x in enumerate(_rows(3, 6))], "tenants A, B")
    # tenant isolation: a ciphertext of A's under A's keys and B's
    sa, sb = pool._sessions["A"], pool._sessions["B"]
    ct = ns.encrypt(sa.ctx.eng, sa.keys, np.eye(4), np.random.default_rng(6))
    out["under_a"] = ns.decrypt(sa.ctx.eng, sa.keys, ct, 4, 4)
    out["under_b"] = ns.decrypt(sb.ctx.eng, sb.keys, ct, 4, 4)
    # the default tenant's touch evicts the coldest of A and B
    step([C(r, 0, x) for r, x in enumerate(_rows(7, 3))], "evict")
    state = bat.rng.bit_generator.state
    retouch = [C(r, 0, x, tenant="AB"[r % 2])
               for r, x in enumerate(_rows(8, 6))]
    step(retouch, "re-touch A, B")
    # A's group encrypted first in step 6: the same state, the same
    # ciphertexts, one program per request
    bat.rng.bit_generator.state = state
    bat.batch_requests = False
    step([c for c in retouch if c.tenant == "A"], "per request")
    bat.batch_requests = True
    return out


@pytest.fixture(scope="module")
def runs():
    return {"ref": run_script(REF), "port": run_script(PORT)}


def _assert_rows_equal(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def _report_wo_arena(rep: dict) -> dict:
    return {k: v for k, v in rep.items() if k != "live_arena_bytes"}


@pytest.mark.parametrize("case", list(CASES))
def test_steps_equal_reference(runs, case):
    ref, port = runs["ref"], runs["port"]
    W = port["W"]
    for i in CASES[case]:
        j, t = ref["steps"][i], port["steps"][i]
        _assert_rows_equal(j["res"], t["res"])
        assert t["stats"] == j["stats"], t["note"]
        assert _report_wo_arena(t["pool"]) == _report_wo_arena(j["pool"])
        assert t["cache"] == j["cache"]
        assert t["keygens"] == j["keygens"]
        s = t["stats"]
        assert s["n_calls"] == len(t["calls"])
        assert s["hlt_launches"] == 2 * s["program_launches"]
        for c in t["calls"]:
            np.testing.assert_allclose(t["res"][(c.request_id, 0)],
                                       c.x @ W, atol=TOL)


def test_one_launch_covers_every_request(runs):
    s = runs["port"]["steps"][0]["stats"]
    assert (s["n_calls"], s["n_groups"], s["program_launches"],
            s["hlt_launches"]) == (3, 1, 1, 2)
    assert s["amortization"]["launches_naive"] == 3 * 2 * 1
    sess = runs["port"]["pool"]._sessions["default"]
    assert sess.engine.schedule == "pallas"
    assert sess.ctx.eng.device.type == "cpu"
    assert sess.ctx.eng.datapath == "pallas"


def test_cache_hits_on_repeat_shapes_and_sharing_patterns(runs):
    steps = runs["port"]["steps"]
    assert (steps[0]["stats"]["cache_misses"],
            steps[0]["stats"]["cache_hits"]) == (1, 0)
    for i in (1, 2, 3):         # step 3 shares a prompt: same key, a hit
        assert (steps[i]["stats"]["cache_hits"],
                steps[i]["stats"]["cache_misses"]) == (1, 0)


def test_shared_prompt_hoists_once(runs):
    s = runs["port"]["steps"][3]["stats"]
    # 3 rows of 2 tiles + the 2 weight tiles; one row's tiles unique
    assert (s["n_tiles"], s["n_uniq_tiles"]) == (8, 4)
    assert s["amortization"]["hoist_dedup_saved_bytes"] > 0


def test_one_launch_per_tenant(runs):
    s = runs["port"]["steps"][4]
    assert (s["stats"]["n_groups"], s["stats"]["program_launches"]) == (2, 2)
    assert s["keygens"] == {"default": 1, "A": 1, "B": 1}
    assert s["stats"]["cache_misses"] == 2


def test_tenant_key_isolation(runs):
    ref, port = runs["ref"], runs["port"]
    np.testing.assert_array_equal(port["under_a"], ref["under_a"])
    np.testing.assert_array_equal(port["under_b"], ref["under_b"])
    np.testing.assert_allclose(port["under_a"], np.eye(4), atol=1e-2)
    assert np.max(np.abs(port["under_b"] - np.eye(4))) > 1.0


def test_lru_eviction_keeps_keys_and_recompiles(runs):
    steps = runs["port"]["steps"]
    s4, s5, s6 = steps[4], steps[5], steps[6]
    assert s5["pool"]["arena_evictions"] == 1
    evicted = [t for t in "AB" if s5["arena"][t] == 0]
    assert len(evicted) == 1
    for t in "AB":
        assert s6["keys"][t] is s4["keys"][t]       # keygen amortized
    assert s6["keygens"] == {"default": 1, "A": 1, "B": 1}
    # the evicted tenant's stale program is dropped and recompiled
    assert (s6["stats"]["cache_hits"], s6["stats"]["cache_misses"]) == (1, 1)
    assert s6["cache"]["evictions"] == 1
    assert s6["arena"][evicted[0]] > 0


def test_live_arena_bytes_is_the_ports_arena(runs):
    for st in runs["port"]["steps"]:
        assert st["live"] == st["pool"]["live_arena_bytes"] == \
            sum(st["arena"].values())
    s4, s5 = runs["port"]["steps"][4], runs["port"]["steps"][5]
    gone = [t for t in "AB" if s5["arena"][t] == 0][0]
    assert s5["live"] == s4["live"] - s4["arena"][gone] + \
        (s5["arena"]["default"] - s4["arena"]["default"])


def test_per_request_equals_batched_on_the_same_ciphertexts(runs):
    s6, s7 = runs["port"]["steps"][6], runs["port"]["steps"][7]
    st = s7["stats"]
    assert (st["n_groups"], st["program_launches"], st["hlt_launches"]) == \
        (1, 3, 6)
    assert (st["cache_misses"], st["cache_hits"]) == (1, 2)
    for k, y in s7["res"].items():
        np.testing.assert_array_equal(y, s6["res"][k])
    # and the batched rows equal the reference's per-request rows
    for k, y in runs["ref"]["steps"][7]["res"].items():
        np.testing.assert_array_equal(y, s6["res"][k])


def test_batcher_report_equals_reference(runs):
    want = runs["ref"]["batcher"].report()
    got = runs["port"]["batcher"].report()
    want["pool"] = _report_wo_arena(want["pool"])
    got["pool"] = _report_wo_arena(got["pool"])
    assert got == want


def test_build_secure_linears_equals_reference():
    rng = np.random.default_rng(11)
    W = rng.standard_normal((8, 4)) * 0.4
    x = rng.standard_normal((2, 8))
    got = {}
    for name, ns in (("ref", REF), ("port", PORT)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            lin = ns.build_linears(
                _model_cfg(ns), ns.ServeConfig(he_tile=4, **ns.scfg),
                {0: W, 1: W}, np.random.default_rng(12),
                he_params=ns.params, **ns.kw)
        assert sorted(lin) == [0]
        got[name] = lin[0](x, np.random.default_rng(13))
    np.testing.assert_array_equal(got["port"], got["ref"])
    np.testing.assert_allclose(got["port"], x @ W, atol=TOL)


def test_no_secure_layer_and_mesh_refused():
    cfg = _model_cfg(PORT, secure=())
    scfg = ServeConfig(he_tile=4)
    assert build_secure_serving(cfg, scfg, {}, np.random.default_rng(0),
                                device=CPU) is None
    assert build_secure_linears(cfg, scfg, {}, np.random.default_rng(0),
                                device=CPU) == {}
    meshed = ServeConfig(he_tile=4, he_mesh=object())
    for build in (build_secure_serving, build_secure_linears):
        with pytest.raises(TypeError, match="not a mesh"):
            build(_model_cfg(PORT), meshed, {0: np.eye(8)},
                  np.random.default_rng(0), he_params=PORT.params,
                  device=CPU)
    with pytest.raises(TypeError, match="not a mesh"):
        SessionPool(PORT.params, tile=4, mesh=object(), device=CPU)


def test_pool_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionPool(PORT.params, tile=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_secure_serving(_model_cfg(PORT), ServeConfig(he_tile=4),
                             {0: np.eye(8)}, np.random.default_rng(0),
                             he_params=PORT.params)


def test_model_config_matches_reference():
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    assert names == [f.name for f in dataclasses.fields(JModelConfig)]
    for kw in (dict(name="d", family="dense", num_layers=4, d_model=64,
                    num_heads=4, d_ff=256, vocab_size=100, num_kv_heads=2),
               dict(name="m", family="moe", num_layers=2, d_model=32,
                    num_heads=4, d_ff=64, vocab_size=50, num_experts=4,
                    mlp="gelu", tie_embeddings=True),
               dict(name="h", family="hybrid", num_layers=6, d_model=64,
                    num_heads=4, d_ff=128, vocab_size=64, ssm_state=16,
                    attn_period=3, ssm_head_dim=32)):
        got, want = ModelConfig(**kw), JModelConfig(**kw)
        assert got.param_count() == want.param_count()
        assert (got.kv_heads, got.hdim, got.num_attn_layers()) == \
            (want.kv_heads, want.hdim, want.num_attn_layers())
        assert got.adtype is torch.bfloat16
    assert _model_cfg(PORT).adtype is torch.float32


def test_program_cache_chain_hits_and_generation():
    """``get_chain`` keys a chain like ``get`` keys a block MM: a repeat
    hits (the context's memoized program), an invalidated context's entry
    is dropped as stale and recompiled, capacity evicts LRU-first."""
    params = FAME_CHAIN_SETS["fame-s-chain"]
    ctx = HEContext(CkksEngine(params, device=CPU, datapath="pallas"))
    chain = plan_hemm_chain(ctx.eng, (4, 4, 4, 4))
    ctx.keygen(np.random.default_rng(0), rot_steps=chain.rot_steps)
    sess = TenantSession("t", ctx)
    cache = HEProgramCache(capacity=1)
    p1 = cache.get_chain(sess, chain)
    assert p1 is compile_hemm_chain(ctx, chain)
    assert cache.get_chain(sess, chain) is p1
    assert (cache.hits, cache.misses, cache.evictions) == (1, 1, 0)
    ctx.invalidate()
    p2 = cache.get_chain(sess, chain)
    assert p2 is not p1
    assert (cache.hits, cache.misses, cache.evictions) == (1, 2, 1)
    cache.get_chain(sess, chain, level=params.L - 1)     # another key
    assert (cache.misses, cache.evictions, cache.report()["size"]) == (3, 2, 1)
