"""Requests of kind ``hemm``: one request is one call of the program that
``repro_torch.core.compile.compile_hemm`` returns for the configuration's
(m, l, n), with the schedule and rotation chunk the program's cost model
picks, on an encrypted pair (A, B), ended by a device synchronise and the
product's copy to the host.

Set-up builds one ``HEContext`` on a ``CkksEngine`` of the configuration's
parameter set and ``engine_datapath``, plans the product (``plan_hemm``),
generates the secret, relinearisation and the plan's rotation keys, and
encrypts a pool of ``traffic["pool"]`` pairs drawn uniform in [low, high)
from the seed.  Request i takes pair i mod pool, so no request repeats the
ciphertexts of the one before it.  Every run of a seed draws the same
pairs, keys and encryption noise.  The traffic file holds ``kind``,
``pool``, ``low`` and ``high`` and nothing else: one client in a closed
loop is the only arrival this kind serves.

Every request copies its product into page-locked host memory: into one
of the cell's ``sample`` slots if the seed's reservoir draw keeps it for
the check, else into a scratch pair of the same size, so each request
does the same work whichever it is.

The program's stage hook marks ``start``, ``step1``, ``step2_hoist``,
``step2`` and ``mult_rescale``; ``SPANS`` names the two spans that the
per-layer metrics read.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from costs import hemm as costs
from reference import ckks as ref_ckks
from reference import hemm as ref_hemm

#: span -> (first mark, last mark) of the program's stage hook
SPANS = {"hlt": ("start", "step2"), "loop": ("step2", "mult_rescale")}

SIZE_KEYS = ("logN", "L", "k", "beta", "scale_bits", "q0_bits", "sp_bits")
TRAFFIC_KEYS = {"kind", "pool", "low", "high"}


def generator(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run: 1 inputs, 2 keys, 3
    encryption, 4 the sample the check compares."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def pairs(config: dict, traffic: dict, seed: int) -> list:
    """The pool of (A, B) pairs, float64, drawn from the seed."""
    if set(traffic) != TRAFFIC_KEYS:
        raise ValueError(f"hemm traffic takes exactly {sorted(TRAFFIC_KEYS)}"
                         f", got {sorted(traffic)}")
    rng = generator(seed, 1)
    m, l, n = config["m"], config["l"], config["n"]
    lo, hi = traffic["low"], traffic["high"]
    return [(rng.uniform(lo, hi, (m, l)), rng.uniform(lo, hi, (l, n)))
            for _ in range(traffic["pool"])]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Session:
    """The program under test at one cell, built from the seed."""

    def __init__(self, config: dict, traffic: dict, settings: dict,
                 seed: int, device):
        from repro_torch.core.ckks import CkksEngine
        from repro_torch.core.compile import HEContext, compile_hemm
        from repro_torch.core.hemm import encrypt_matrix, plan_hemm
        from repro_torch.core.params import HEParams
        from repro_torch.kernels import ops

        self.config, self.seed, self.device = config, seed, device
        self.sizes = {k: config[k] for k in SIZE_KEYS}
        self.shape = (config["m"], config["l"], config["n"])
        self.pool = pairs(config, traffic, seed)
        self.setup_s: dict = {}
        params = HEParams(config["name"], logq_paper=config["logq_paper"],
                          **self.sizes)
        t = time.perf_counter()
        if torch.device(device).type == "cuda":
            from repro_torch.kernels import build
            build.load()
        t = self._lap("kernels", t)
        ctx = HEContext(CkksEngine(params, device=device,
                                   datapath=config["engine_datapath"]))
        t = self._lap("engine", t)
        plan = plan_hemm(ctx.eng, *self.shape)
        t = self._lap("plan", t)
        ctx.keygen(generator(seed, 2), rot_steps=plan.rot_steps)
        _sync(device)
        t = self._lap("keygen", t)
        rng = generator(seed, 3)
        self.cts = [(encrypt_matrix(ctx.eng, ctx.keys, A, rng),
                     encrypt_matrix(ctx.eng, ctx.keys, B, rng))
                    for A, B in self.pool]
        _sync(device)
        t = self._lap("encrypt", t)
        self.prog = compile_hemm(ctx, plan)
        _sync(device)
        self._lap("compile", t)
        self.ctx, self.ops = ctx, ops
        self.n_sample = int(settings["sample"])
        self.draw = generator(seed, 4)
        self.slots: list = []           # (pair, c0, c1) kept for the check
        self.buffers: list = []         # the sample's page-locked slots
        self.scratch = None
        self.seen = 0

    def _lap(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.setup_s[name] = now - t
        return now

    def request(self, i: int, hook=None, keep: bool = True) -> None:
        """Request ``i`` (pair i mod pool): the program's call, its product
        copied to the host, synchronised.  Unless ``keep`` is false, the
        reservoir draw may keep the product for the check."""
        ctA, ctB = self.cts[i % len(self.cts)]
        self.prog.stage_hook = hook
        try:
            out = self.prog(ctA, ctB)
        finally:
            self.prog.stage_hook = None
        if self.scratch is None:
            self._host_buffers(out)
        c0, c1 = self._target(i % len(self.cts)) if keep else self.scratch
        c0.copy_(out.c0, non_blocking=True)
        c1.copy_(out.c1, non_blocking=True)
        _sync(self.device)

    def _host_buffers(self, out) -> None:
        """The scratch pair and the sample's slots, page-locked on a CUDA
        run, each the size of one product."""
        pin = torch.device(self.device).type == "cuda"
        pair = lambda: tuple(torch.empty(c.shape, dtype=c.dtype,
                                         pin_memory=pin)
                             for c in (out.c0, out.c1))
        self.scratch = pair()
        self.buffers = [pair() for _ in range(self.n_sample)]

    def _target(self, pair: int):
        """Where the window's next product goes: Algorithm R over the
        requests seen so far, drawn from the seed's stream 4."""
        j, self.seen = self.seen, self.seen + 1
        if j < self.n_sample:
            at = j
            self.slots.append(None)
        else:
            at = int(self.draw.integers(0, j + 1))
            if at >= self.n_sample:
                return self.scratch
        c0, c1 = self.buffers[at]
        self.slots[at] = (pair, c0, c1)
        return c0, c1

    def counters(self) -> dict:
        """The program's own counts: arena bytes, program and HLT calls,
        kernel launches by name (since ``reset_launches``)."""
        out = {"arena_bytes": self.ctx.arena.nbytes,
               "schedule": self.prog.plan.schedule}
        out.update(self.ctx.counters)
        out["kernel_launches"] = {k: v for k, v in
                                  self.ops.launch_counts().items() if v}
        return out

    def reset_launches(self) -> None:
        self.ops.reset_launch_counts()

    def least(self) -> dict:
        """Span -> least seconds on the chip (``costs.hemm``)."""
        return {k: v["seconds"]
                for k, v in costs.least(self.sizes, *self.shape).items()}

    def release(self) -> None:
        """Drop the program, its keys and ciphertexts, and the cached
        device memory."""
        self.prog = self.ctx = self.cts = self.scratch = None
        gc.collect()            # a context and its programs cite each other
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, limits: dict) -> ref_hemm.Judge:
        """Decode every product of the sample with the reference and
        compare it with A·B of its pair."""
        judge = ref_hemm.Judge(limits)
        L = self.sizes["L"]
        qs = ref_ckks.moduli(*(self.sizes[k] for k in
                               ("logN", "L", "k", "q0_bits", "scale_bits",
                                "sp_bits")))
        dec = ref_ckks.Decryptor(self.sizes, generator(self.seed, 2), L - 3,
                                 ref_ckks.output_scale(self.sizes, qs),
                                 self.device)
        m, _, n = self.shape
        want = [ref_hemm.product(A, B) for A, B in self.pool]
        for j, c0, c1 in self.slots:
            slots = dec.decode(c0, c1, m * n)
            judge.add(None if slots is None
                      else ref_hemm.as_matrix(slots, m, n), want[j])
        return judge


def control(config: dict, traffic: dict, seed: int, limits: dict,
            device) -> ref_hemm.Judge:
    """The control: the reference in bfloat16 put in the program's place,
    over the seed's pool, judged as the program's products are."""
    judge = ref_hemm.Judge(limits)
    for A, B in pairs(config, traffic, seed):
        judge.add(ref_hemm.control(A, B, device), ref_hemm.product(A, B))
    return judge
