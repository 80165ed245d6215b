"""The kinds ``lm_decode`` and ``chain`` on the CPU: whole runs of toy cells
through the harness, their controls, and the new metrics' readers."""
import json
import time

import pytest
import torch

import run
from costs import granite_hybrid as costs
from kinds import chain as chain_kind
from kinds import lm_decode
from reference import chain as ref_chain
from reference import granite_hybrid as ref_granite

GRANITE = "granite-h-small-decode-b128"
CHAIN = "chain-setb-128x3"
SEEDS = [4100000001, 4100000002, 4100000003]


def _root(tmp_path, cell: str, config: dict, traffic: dict, limits: dict):
    """A root whose BENCHMARK.json holds one toy cell and the repo's
    metrics, listed for it where they list the real cell."""
    real = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    target = GRANITE if traffic["kind"] == "lm_decode" else CHAIN
    for sub in ("configs", "traffic", "workloads"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "toy.json").write_text(json.dumps(config))
    (tmp_path / "traffic" / "toy.json").write_text(json.dumps(traffic))
    (tmp_path / "workloads" / f"{cell}.json").write_text(json.dumps(
        {"profile_requests": 1, "sample": 16, "slots": 2, "limits": limits}))
    spec = dict(real, paths=["."], configs=[{
        "name": config["name"], "source": "toy", "file": "configs/toy.json",
        "reduced": [], "why": "CPU tests"}], workloads=[{
            "name": cell, "config": config["name"], "traffic": "toy",
            "chips": 1, "why": "CPU tests"}])
    spec["per_layer"] = [dict(m, workloads=[cell] if target in m["workloads"]
                              else []) for m in real["per_layer"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def _toy_granite() -> dict:
    cfg = run.load_cell(GRANITE).config
    return dict(cfg, hidden_size=32, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=16,
                shared_intermediate_size=24, vocab_size=128,
                num_local_experts=8, num_experts_per_tok=2, mamba_d_state=16,
                mamba_d_head=8, mamba_n_heads=8, mamba_chunk_size=8,
                attention_multiplier=0.25)


LM_TRAFFIC = {"kind": "lm_decode", "batch": 3, "prompt": 12, "room": 64,
              "sampling": "greedy", "clients": 1}
#: the toy's limits.  Over 2 slots and 16 kept steps its bf16 program reads
#: a median of 0.0099-0.0154 and a drift of -0.024-0.002 on five seeds, its
#: float8 control a median of 0.050-0.089; the toy's worst row swings with
#: a token routed to another of its 8 experts (0.03-0.22), so its limit
#: here is loose
LM_LIMITS = {"dropped": 0, "worst_rel_err": 0.5, "median_rel_err": 0.03,
             "drift_rel_err": 0.03}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_lm_decode_toy_run(tmp_path, trace):
    root = _root(tmp_path, "toy-lm", _toy_granite(), LM_TRAFFIC, LM_LIMITS)
    res = run.run("toy-lm", 2 ** 31 + 5, 0.3, trace, "cpu", root=root,
                  t0=time.perf_counter(), log=lambda *a: None)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res["check"]) == list(lm_decode.NUMBERS)
    want = ({"decode_mfu", "ssm_ms", "attn_ms", "moe_ms"} if trace
            else {"request_ms", "setup_s"})
    assert set(res["metrics"]) == want


def test_lm_decode_refuses_a_window_past_its_room(tmp_path):
    root = _root(tmp_path, "toy-lm", _toy_granite(),
                 dict(LM_TRAFFIC, room=16), LM_LIMITS)
    with pytest.raises(RuntimeError, match="outran the cache's room"):
        run.run("toy-lm", 7, 30.0, False, "cpu", root=root,
                t0=time.perf_counter(), log=lambda *a: None)


def test_lm_decode_control_is_not_correct():
    """The reference with float8 weights in the program's place, at the
    toy's size and limits, under which the toy's program is correct."""
    for seed in SEEDS[:2]:
        judge = lm_decode.control(_toy_granite(), LM_TRAFFIC, seed,
                                  LM_LIMITS, "cpu", steps=12, rows=8)
        assert not judge.correct()


def test_lm_decode_drift_reads_a_growing_error():
    """``drift_rel_err`` is the late third's median less the early
    third's; a window without rows in either third is not correct."""
    judge = lm_decode.Judge(dict(LM_LIMITS, worst_rel_err=1.0), 9)
    want = torch.linspace(-1.0, 1.0, 50)
    for step in range(9):
        judge.add(step, want * (1.0 + 0.01 * step), want)
    got = judge.numbers()
    # float32 rows
    assert got["drift_rel_err"] == pytest.approx(0.06, rel=1e-5)
    assert not judge.correct()          # over the drift limit of 0.03
    early = lm_decode.Judge(LM_LIMITS, 9)
    early.add(0, want, want)
    assert early.numbers()["drift_rel_err"] == 0.0 and not early.correct()


def test_lm_decode_state_control_runs_the_state_in_bfloat16():
    """The bf16-state control differs from the reference past the prompt
    alone: at the prompt's last position it reads 0."""
    cfg = _toy_granite()
    weights = ref_granite.draw(cfg, 3, "cpu")
    tokens = torch.arange(20) % cfg["vocab_size"]
    with torch.no_grad():
        want = ref_granite.forward(cfg, weights, tokens, [11, 19])
        got = ref_granite.forward(cfg, weights, tokens, [11, 19],
                                  state_dtype=torch.bfloat16, state_from=12)
    assert torch.equal(got[0], want[0]) and not torch.equal(got[1], want[1])


#: the published config.json of granite-4.0-h-small, number for number
GRANITE_SOURCE = {
    "attention_bias": False, "attention_multiplier": 0.0078125,
    "embedding_multiplier": 12, "hidden_act": "silu", "hidden_size": 4096,
    "intermediate_size": 768,
    "layer_types": (["mamba"] * 5 + ["attention"] + ["mamba"] * 4) * 4,
    "logits_scaling": 16, "mamba_chunk_size": 256, "mamba_conv_bias": True,
    "mamba_d_conv": 4, "mamba_d_head": 64, "mamba_d_state": 128,
    "mamba_expand": 2, "mamba_n_groups": 1, "mamba_n_heads": 128,
    "mamba_proj_bias": False, "max_position_embeddings": 131072,
    "model_type": "granitemoehybrid", "normalization_function": "rmsnorm",
    "num_attention_heads": 32, "num_experts_per_tok": 10,
    "num_hidden_layers": 40, "num_key_value_heads": 8,
    "num_local_experts": 72, "position_embedding_type": "nope",
    "residual_multiplier": 0.22, "rms_norm_eps": 1e-05, "rope_scaling": None,
    "rope_theta": 10000, "shared_intermediate_size": 1536,
    "tie_word_embeddings": True, "vocab_size": 100352}


def test_granite_configuration_keeps_the_source_but_what_it_reduces():
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in spec["configs"]}["granite-4.0-h-small"]
    cfg = json.loads((run.ROOT / entry["file"]).read_text())
    assert entry["reduced"] == ["num_hidden_layers"]
    for key, want in GRANITE_SOURCE.items():
        if key in entry["reduced"]:
            assert cfg[key] != want and cfg["source_shape"][key] == want
        else:
            assert cfg[key] == want, key


def test_lm_decode_traffic_is_exactly_the_kinds():
    c = run.load_cell(GRANITE)
    with pytest.raises(ValueError, match="traffic takes exactly"):
        lm_decode.prompts(c.config, dict(c.traffic, arrival="poisson"), 1)
    assert lm_decode.port_config(c.config).num_layers == 10


def test_chain_toy_run(tmp_path):
    toy = json.loads((run.BENCH / "tests" / "toy" / "configs" /
                      "toy-rt.json").read_text())
    toy.update(name="toy-chain", L=9, k=2, beta=5, m=4, l=4, n=4)
    root = _root(tmp_path, "toy-chain",
                 toy, {"kind": "chain", "hops": 2, "pool": 4, "low": -1.0,
                       "high": 1.0},
                 {"undecodable": 0, "worst_median_err": 0.002,
                  "worst_trimmed_err": 0.003, "worst_hop1_median_err": 0.002})
    res = run.run("toy-chain", 11, 0.2, True, "cpu", root=root,
                  t0=time.perf_counter(), log=lambda *a: None)
    assert res["correct"] is True
    assert list(res["check"]) == list(ref_chain.NUMBERS)
    assert set(res["metrics"]) == {"arena_gb", "keygen_s", "keyswitch_ms",
                                   "rescale_ms", "request_h2d"}


def test_chain_judge_leaves_out_the_bias_rows_and_reads_the_first_hop():
    """An output off in rows 0-2 alone reads 0, off in row 3 not; a first
    hop's output off in half its entries fails on its median."""
    want = torch.zeros((8, 8), dtype=torch.float64)
    limits = {"undecodable": 0, "worst_median_err": 1e-3,
              "worst_trimmed_err": 1e-3, "worst_hop1_median_err": 1e-3}
    judge = ref_chain.Judge(limits)
    judge.add(want.clone().index_fill_(0, torch.arange(3), 0.5), want,
              want, want)
    assert judge.correct() and judge.numbers()["worst_trimmed_err"] == 0
    judge.add(want.clone().index_fill_(0, torch.tensor([3]), 0.5), want,
              want, want)
    assert judge.numbers()["worst_trimmed_err"] > 1e-3 and judge.failed == 1
    hop1 = ref_chain.Judge(limits)
    hop1.add(want, want, want.clone().index_fill_(0, torch.arange(5), 0.5),
             want)
    assert hop1.numbers()["worst_hop1_median_err"] == 0.5
    assert hop1.failed == 1 and not hop1.correct()
    hop1.add(want, want, None, want)
    assert hop1.numbers()["undecodable"] == 1 and hop1.failed == 2


@pytest.mark.parametrize("seed", SEEDS)
def test_chain_control_is_not_correct(seed):
    """The chain in bfloat16 in the program's place, at the cell's own size
    and limits, on the CPU."""
    c = run.load_cell(CHAIN)
    assert not chain_kind.control(c.config, c.traffic, seed,
                                  c.settings["limits"], "cpu").correct()


@pytest.mark.parametrize("metric", ["decode_mfu", "ssm_ms", "attn_ms",
                                    "moe_ms"])
def test_new_readers_none_on_a_record_without_them(metric):
    rec = run.Record(setup_s=1.0, window_s=1.0, requests=1, peak_bytes=0,
                     counters={"arena_bytes": 1}, least={}, spans=[])
    assert run.reader(metric)(rec) is None


def test_step_least_time_is_bytes_bound_at_the_cell():
    c = run.load_cell(GRANITE)
    got = costs.step(c.config, 128, 2048)
    assert 27e9 < got["bytes"] < 29e9
    assert got["seconds"] == pytest.approx(got["bytes"] / 3.35e12)
