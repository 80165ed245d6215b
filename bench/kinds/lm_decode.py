"""Requests of kind ``lm_decode``: one request is one
``ContinuousBatcher.step()`` (``repro_torch.serve``) over every slot of a
full batch, greedy sampling as the batcher does it (the logits copied to
the host, an argmax a slot).

Set-up draws the weights on the card from the seed with the reference's
plain ``draw`` (``reference/granite_hybrid.py``, the init the configuration
states) and loads them into the program's tree through the program's own
checkpoint loader (``hybrid_moe_params``) for the configuration's model
(``repro_torch.configs``, the published keys of ``bench/configs`` applied
over it and its depth cut to ``num_hidden_layers``).  It submits
``batch`` prompts of ``prompt`` token ids uniform over the vocabulary from
the seed; the batcher's first step admits them all (a prefill each,
through its own admission) and decodes once.  No request ends in the
window: each may decode until its cache of ``room`` positions is full,
and a request that would fill it stops the run with an error.  The
traffic file holds ``kind``, ``batch``, ``prompt``, ``room``,
``sampling`` ("greedy") and ``clients`` (1: one client in a closed loop of
decode steps) and nothing else.

The check follows ``slots`` slots drawn from the seed.  Every step copies
their rows of logits into page-locked memory: into one of ``sample`` kept
steps if the seed's reservoir draw keeps the step, else into scratch rows,
so each step does the same work.  After the window the program is freed,
the reference draws the weights again from the seed (a copy of its own,
which nothing the program did can reach) and recomputes every kept row in
float32, one sequence at a time, from the prompt and the tokens the
program chose (``Judge``).

The request marks ``start`` and ``end`` (``SPANS``).  A traced request
that is not profiled also synchronises the device at each of the model's
spans (``core/trace.py`` ``synced``), so that ``lm.step``, ``lm.ssm``,
``lm.attn`` and ``lm.moe`` hold their device work; their sums over those
requests are the record's ``counters["traced"]``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import statistics
import time

import numpy as np
import torch

from costs import granite_hybrid as costs
from reference import granite_hybrid as ref

SPANS = {"step": ("start", "end")}
TRAFFIC_KEYS = {"kind", "batch", "prompt", "room", "sampling", "clients"}
NUMBERS = ("dropped", "worst_rel_err", "median_rel_err", "drift_rel_err")

#: published key -> the port's ``HybridMoEConfig`` field
FIELDS = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
          "num_key_value_heads": "num_kv_heads",
          "intermediate_size": "d_ff",
          "shared_intermediate_size": "shared_ff", "vocab_size": "vocab_size",
          "num_local_experts": "num_experts",
          "num_experts_per_tok": "experts_per_token",
          "mamba_d_state": "ssm_state", "mamba_d_head": "ssm_head_dim",
          "mamba_expand": "ssm_expand", "mamba_d_conv": "conv_kernel",
          "mamba_chunk_size": "ssm_chunk", "rms_norm_eps": "norm_eps",
          "attention_multiplier": "attention_multiplier",
          "embedding_multiplier": "embedding_multiplier",
          "residual_multiplier": "residual_multiplier",
          "logits_scaling": "logits_scaling",
          "tie_word_embeddings": "tie_embeddings",
          "position_embedding_type": "position_embedding"}


def generator(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run: 1 prompts, 4 the slots and
    steps the check compares, 5 the controls' continuations and steps."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def port_config(config: dict):
    """The program's configuration: the registry's, with every published
    key of ``config`` over it and ``num_hidden_layers`` layers, whose
    kinds must be whole periods of its layer pattern."""
    from repro_torch.configs import get_config
    base = get_config(config["name"])
    n = config["num_hidden_layers"]
    kinds = tuple(config["layer_types"][:n])
    period = base.layer_pattern
    if n % len(period) or kinds != period * (n // len(period)):
        raise ValueError(f"layers {kinds} are not whole periods of {period}")
    d, H = config["hidden_size"], config["mamba_n_heads"]
    if H * config["mamba_d_head"] != config["mamba_expand"] * d:
        raise ValueError("mamba_n_heads · mamba_d_head ≠ mamba_expand · "
                         "hidden_size")
    if config["mamba_n_groups"] != 1 or not config["mamba_conv_bias"]:
        raise ValueError("the SSD runs one group with a conv bias")
    return dataclasses.replace(
        base, num_layers=n, head_dim=d // config["num_attention_heads"],
        **{f: config[k] for k, f in FIELDS.items()})


def prompts(config: dict, traffic: dict, seed: int) -> np.ndarray:
    """(batch, prompt) token ids uniform over the vocabulary."""
    if set(traffic) != TRAFFIC_KEYS:
        raise ValueError(f"lm_decode traffic takes exactly "
                         f"{sorted(TRAFFIC_KEYS)}, got {sorted(traffic)}")
    if traffic["sampling"] != "greedy" or traffic["clients"] != 1:
        raise ValueError("lm_decode serves one client, greedy")
    return generator(seed, 1).integers(
        0, config["vocab_size"], (traffic["batch"], traffic["prompt"]),
        dtype=np.int64).astype(np.int32)


def load_params(cfg, weights: dict) -> dict:
    """The program's tree of the reference's draw, through the program's
    checkpoint loader."""
    from repro_torch.models import transformer as tf
    return tf.hybrid_moe_params(cfg, weights)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ over ‖want − mean(want)‖ of one row of logits."""
    got, want = got.double(), want.double().to(got.device)
    return float((got - want).norm() / (want - want.mean()).norm())


class Judge:
    """The comparison over a window of ``steps`` decode steps, each kept
    row of logits (``add``: its step and ``rel_err``) against the
    reference's:

    - ``dropped``: routed pairs past an expert's capacity over the run
      (limit 0);
    - ``worst_rel_err``, ``median_rel_err``: over the kept rows;
    - ``drift_rel_err``: the median of the rows of the window's last third
      less that of its first third.  The program's error from its
      bfloat16 arithmetic is flat over the window; an error that grows
      step by step, as a Mamba state kept one precision down makes it,
      reads here where the two others would drown it.

    ``failed`` counts rows over the worst limit, and a run with a dropped
    pair; a window with no kept row in its first or last third is not
    correct."""

    def __init__(self, limits: dict, steps: int, dropped: int = 0):
        self.limits, self.steps = limits, int(steps)
        self.dropped = int(dropped)
        self.rows: list = []            # (step, rel err)
        self.top1 = 0
        self.max_abs = 0.0

    @property
    def failed(self) -> int:
        over = sum(e > self.limits["worst_rel_err"] for _, e in self.rows)
        return over + (self.dropped > self.limits["dropped"])

    def add(self, step: int, got: torch.Tensor, want: torch.Tensor) -> None:
        self.rows.append((int(step), rel_err(got, want)))
        self.top1 += int(int(got.argmax()) == int(want.argmax()))
        self.max_abs = max(self.max_abs, float(
            (got.double() - want.double().to(got.device)).abs().max()))

    def _thirds(self) -> tuple:
        early = [e for j, e in self.rows if 3 * j < self.steps]
        late = [e for j, e in self.rows if 3 * j >= 2 * self.steps]
        return early, late

    def numbers(self) -> dict:
        errs = [e for _, e in self.rows]
        early, late = self._thirds()
        drift = (statistics.median(late) - statistics.median(early)
                 if early and late else 0.0)
        return {"dropped": self.dropped,
                "worst_rel_err": max(errs, default=0.0),
                "median_rel_err": statistics.median(errs) if errs else 0.0,
                "drift_rel_err": drift}

    def not_compared(self) -> dict:
        early, late = self._thirds()
        return {"rows": len(self.rows), "steps": self.steps,
                "early_rows": len(early), "late_rows": len(late),
                "early_median": statistics.median(early) if early else None,
                "late_median": statistics.median(late) if late else None,
                "top1_agree": self.top1, "max_abs_err": self.max_abs}

    def correct(self) -> bool:
        got = self.numbers()
        early, late = self._thirds()
        return bool(early and late) and all(got[k] <= self.limits[k]
                                            for k in NUMBERS)


class Session:
    """The program under test at one cell, built from the seed."""

    def __init__(self, config: dict, traffic: dict, settings: dict,
                 seed: int, device):
        from repro_torch.core import trace
        from repro_torch.serve import ContinuousBatcher, ServeConfig

        self.config, self.seed, self.device = config, seed, device
        self.trace = trace
        self.cfg = port_config(config)
        self.prompts = prompts(config, traffic, seed)
        self.batch, self.room = traffic["batch"], traffic["room"]
        self.setup_s: dict = {}
        t = time.perf_counter()
        self.params = load_params(self.cfg, ref.draw(config, seed, device))
        _sync(device)
        t = self._lap("weights", t)
        self.batcher = ContinuousBatcher(
            self.cfg, ServeConfig(max_batch=self.batch, max_len=self.room),
            self.params)
        self.rids = [self.batcher.submit(p, max_new=self.room)
                     for p in self.prompts]
        with torch.no_grad():
            self.batcher.step()         # admits every prompt, decodes once
        _sync(device)
        self._lap("prefill", t)
        self.n_sample = int(settings["sample"])
        self.draw = generator(seed, 4)
        self.slots = sorted(int(s) for s in self.draw.choice(
            self.batch, int(settings["slots"]), replace=False))
        self.kept: list = []    # (step, each slot's position) a kept step
        self.rows = torch.empty(
            (self.n_sample + 1, len(self.slots), config["vocab_size"]),
            dtype=torch.float32,
            pin_memory=torch.device(device).type == "cuda")
        self.seen = 0
        self.traced: dict = {}
        self.traced_steps = 0
        self.traced_kv: list = []

    def _lap(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.setup_s[name] = now - t
        return now

    def request(self, i: int, hook=None, keep: bool = True) -> None:
        """Request ``i``: one decode step of every slot, the check's
        slots' rows of logits copied."""
        b = self.batcher
        pos = [s["pos"] for s in b.slots]
        if max(pos) + 1 >= self.room - 1:
            raise RuntimeError(f"the window outran the cache's room of "
                               f"{self.room} positions at step {i}")
        traced = hook is not None and not hook.profiled
        if hook is not None:
            hook("start")
        before = dict(b.counters) if traced else None
        sync = (self.trace.synced(lambda: _sync(self.device)) if traced
                else contextlib.nullcontext())
        with torch.no_grad(), sync:
            b.step()
        at = self._target() if keep else self.n_sample
        self.rows[at].copy_(torch.from_numpy(b.last_logits[self.slots]))
        if at < self.n_sample:
            self.kept[at] = (self.seen - 1, [pos[s] for s in self.slots])
        if hook is not None:
            hook("end")
        if traced:
            for k, v in b.counters.items():
                self.traced[k] = self.traced.get(k, 0) + int(
                    v - before.get(k, 0))
            self.traced_steps += 1
            self.traced_kv.append(sum(pos) / len(pos))

    def _target(self) -> int:
        """Where the window's next rows go: Algorithm R over the steps
        seen so far, drawn from the seed's stream 4 (``n_sample``: the
        scratch rows)."""
        j, self.seen = self.seen, self.seen + 1
        if j < self.n_sample:
            self.kept.append(None)
            return j
        at = int(self.draw.integers(0, j + 1))
        return at if at < self.n_sample else self.n_sample

    def counters(self) -> dict:
        """The batcher's counts over the run, and the traced requests'
        span sums and count."""
        lm = {k: int(v) for k, v in self.batcher.counters.items()}
        return {"lm": lm, "traced": dict(self.traced),
                "traced_steps": self.traced_steps,
                "dropped": lm.get("lm.moe.dropped", 0)}

    def reset_launches(self) -> None:
        pass

    def least(self) -> dict:
        """``step``: the least seconds of a traced step (``costs``), the
        mean over the traced requests that were not profiled."""
        kv = self.traced_kv or [sum(s["pos"] for s in self.batcher.slots)
                                / self.batch]
        return {"step": statistics.fmean(
            costs.step(self.config, self.batch, k)["seconds"] for k in kv)}

    def release(self) -> None:
        """Drop the program and the cached device memory."""
        self.tokens = {slot: list(self.batcher.results[rid])
                       for slot, rid in enumerate(self.rids)}
        self.dropped = self.counters()["dropped"]
        self.batcher = self.params = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, limits: dict) -> Judge:
        """Each kept row against the reference's logits at its position,
        from the prompt and the tokens the program chose, on weights the
        reference draws anew from the seed."""
        judge = Judge(limits, self.seen, self.dropped)
        weights = ref.draw(self.config, self.seed, self.device)
        P = self.prompts.shape[1]
        for i, slot in enumerate(self.slots):
            rows = [(j, ps[i], at) for at, (j, ps) in enumerate(self.kept)]
            last = max(p for _, p, _ in rows)
            seq = np.concatenate([self.prompts[slot],
                                  self.tokens[slot][: last - P + 1]])
            with torch.no_grad():
                want = ref.forward(self.config, weights,
                                   torch.as_tensor(seq, device=self.device),
                                   [p for _, p, _ in rows])
            for (j, _, at), w in zip(rows, want):
                judge.add(j, self.rows[at, i], w)
        return judge


def fp8_rows(t: torch.Tensor) -> torch.Tensor:
    """A bfloat16 weight rounded through float8 e4m3 with a scale a row
    (its largest magnitude to 448); float32 leaves (router, SSD scalars)
    unchanged."""
    if t.dtype == torch.float32:
        return t
    x = t.float()
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def control(config: dict, traffic: dict, seed: int, limits: dict, device,
            state: bool = False, sequences=None, steps: int = 720,
            rows: int = 48) -> Judge:
    """A control in the program's place, judged as the program's rows are,
    at ``rows`` steps drawn from the seed, on ``sequences``: token arrays
    of a prompt and its continuation (the tokens a program chose from it
    make a window of the program's), by default the seed's first 4
    prompts each continued by ``steps`` tokens drawn from the seed (720:
    the cell's 51 s at ~71 ms a step).  The control is the reference with
    every bfloat16 weight rounded through float8 e4m3 (``fp8_rows``), or,
    with ``state``, the reference with the Mamba recurrence past the
    prompt in bfloat16 (the state one precision below the
    configuration's)."""
    weights = ref.draw(config, seed, device)
    rng = generator(seed, 5)
    P = traffic["prompt"]
    if sequences is None:
        sequences = [np.concatenate([p, rng.integers(
            0, config["vocab_size"], steps).astype(np.int32)])
            for p in prompts(config, traffic, seed)[:4]]
    steps = min(len(s) for s in sequences) - P
    judge = Judge(limits, steps)
    at = sorted(int(j) for j in rng.choice(steps, min(rows, steps),
                                           replace=False))
    low = ({"state_dtype": torch.bfloat16, "state_from": P} if state
           else {"cast": fp8_rows})
    for seq in sequences:
        tokens = torch.as_tensor(np.asarray(seq[:P + steps]), device=device)
        positions = [P + j for j in at]
        with torch.no_grad():
            want = ref.forward(config, weights, tokens, positions)
            got = ref.forward(config, weights, tokens, positions, **low)
        for j, g, w in zip(at, got, want):
            judge.add(j, g, w)
    return judge
