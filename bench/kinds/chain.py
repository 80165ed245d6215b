"""Requests of kind ``chain``: one request is one call of the program that
``repro_torch.core.compile.compile_hemm_chain`` returns for a chain of
``hops`` products of the configuration's (m, l, n) shape (the dims
(m, l, n, …, n), every hop at l = n), with the schedules the program's
cost model picks, on an encrypted input X and the server's encrypted
weights W1…Wk (``run_hops``), ended by a device synchronise and the
copy of the output and of the first hop's output to the host.  No
decrypt between the hops: FAME's consecutive HE MM, the encrypted linear
block of ``SecureLinear(chain=…)``.

Set-up builds one ``HEContext`` on a ``CkksEngine`` of the configuration's
parameter set and ``engine_datapath``, plans the chain
(``plan_hemm_chain``), generates the secret, relinearisation and the
chain's rotation keys, encrypts a pool of ``traffic["pool"]`` inputs X
drawn uniform in [low, high) from the seed, and the k weights once, each
at its hop's input level (``encrypt_weights``), with entries uniform in
(−1, 1)·√(3/l): a standard deviation of 1/√l, which keeps every hop's
output of the order of X.  Request i takes input i mod pool.  The traffic
file holds ``kind``, ``hops``, ``pool``, ``low`` and ``high`` and
nothing else: one client in a closed loop.

Every request copies both outputs into page-locked host memory, into one
of the cell's ``sample`` slots if the seed's reservoir draw keeps it for
the check, else into scratch buffers of the same size.  The check decodes
each kept pair at its hop's (level, scale) (``plan.hop_out``) and
compares the output with X·W1·…·Wk and the first hop's with X·W1, in
float64 (``reference/chain.py`` ``Judge``).

The request marks ``start`` and ``end`` (``SPANS``).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from reference import chain as ref_chain
from reference import ckks as ref_ckks
from reference import hemm as ref_hemm

SPANS = {"chain": ("start", "end")}

SIZE_KEYS = ("logN", "L", "k", "beta", "scale_bits", "q0_bits", "sp_bits")
TRAFFIC_KEYS = {"kind", "hops", "pool", "low", "high"}


def generator(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run: 1 inputs and weights, 2 keys,
    3 encryption, 4 the sample the check compares."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def dims(config: dict, traffic: dict) -> tuple:
    """(m, l, n, …, n): ``hops`` products of X (m×l) by l×n weights."""
    if config["l"] != config["n"]:
        raise ValueError("a chain of one shape needs l = n")
    return (config["m"], config["l"]) + (config["n"],) * traffic["hops"]


def inputs(config: dict, traffic: dict, seed: int):
    """The pool of inputs X and the weights W1…Wk, float64, from the
    seed."""
    if set(traffic) != TRAFFIC_KEYS:
        raise ValueError(f"chain traffic takes exactly "
                         f"{sorted(TRAFFIC_KEYS)}, got {sorted(traffic)}")
    rng = generator(seed, 1)
    d = dims(config, traffic)
    lo, hi = traffic["low"], traffic["high"]
    pool = [rng.uniform(lo, hi, (d[0], d[1])) for _ in range(traffic["pool"])]
    Ws = [rng.uniform(-1, 1, (d[h + 1], d[h + 2])) * np.sqrt(3.0 / d[h + 1])
          for h in range(traffic["hops"])]
    return pool, Ws


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Session:
    """The program under test at one cell, built from the seed."""

    def __init__(self, config: dict, traffic: dict, settings: dict,
                 seed: int, device):
        from repro_torch.core.ckks import CkksEngine
        from repro_torch.core.compile import HEContext, compile_hemm_chain
        from repro_torch.core.hemm import encrypt_matrix, plan_hemm_chain
        from repro_torch.core.params import HEParams
        from repro_torch.kernels import ops

        self.config, self.seed, self.device = config, seed, device
        self.sizes = {k: config[k] for k in SIZE_KEYS}
        self.dims = dims(config, traffic)
        self.pool, self.Ws = inputs(config, traffic, seed)
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
        chain = plan_hemm_chain(ctx.eng, self.dims)
        t = self._lap("plan", t)
        ctx.keygen(generator(seed, 2), rot_steps=chain.rot_steps)
        _sync(device)
        t = self._lap("keygen", t)
        self.prog = compile_hemm_chain(ctx, chain)
        _sync(device)
        t = self._lap("compile", t)
        rng = generator(seed, 3)
        self.cts = [encrypt_matrix(ctx.eng, ctx.keys, X, rng)
                    for X in self.pool]
        self.w_cts = self.prog.encrypt_weights(self.Ws, rng)
        _sync(device)
        self._lap("encrypt", t)
        self.ctx, self.ops = ctx, ops
        self.out_state = self.prog.plan.hop_out[-1]
        self.hop1_state = self.prog.plan.hop_out[0]
        self.n_sample = int(settings["sample"])
        self.draw = generator(seed, 4)
        self.slots: list = []   # (input, (output pair, hop 1 pair)) kept
        self.buffers: list = []         # the sample's page-locked slots
        self.scratch = None
        self.seen = 0

    def _lap(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.setup_s[name] = now - t
        return now

    def request(self, i: int, hook=None, keep: bool = True) -> None:
        """Request ``i`` (input i mod pool): the chain's call, its output
        and its first hop's copied to the host, synchronised.  Unless
        ``keep`` is false, the reservoir draw may keep them for the
        check."""
        if hook is not None:
            hook("start")
        outs = self.prog.run_hops(self.cts[i % len(self.cts)], self.w_cts)
        outs = (outs[-1], outs[0])
        if self.scratch is None:
            self._host_buffers(outs)
        bufs = self._target(i % len(self.cts)) if keep else self.scratch
        for (c0, c1), out in zip(bufs, outs, strict=True):
            c0.copy_(out.c0, non_blocking=True)
            c1.copy_(out.c1, non_blocking=True)
        _sync(self.device)
        if hook is not None:
            hook("end")

    def _host_buffers(self, outs) -> None:
        """The scratch buffers and the sample's slots: a (c0, c1) pair of
        each of ``outs``' ciphertexts."""
        pin = torch.device(self.device).type == "cuda"
        pairs = lambda: tuple(
            tuple(torch.empty(c.shape, dtype=c.dtype, pin_memory=pin)
                  for c in (out.c0, out.c1)) for out in outs)
        self.scratch = pairs()
        self.buffers = [pairs() for _ in range(self.n_sample)]

    def _target(self, x: int):
        """Algorithm R over the requests seen so far, drawn from the seed's
        stream 4."""
        j, self.seen = self.seen, self.seen + 1
        if j < self.n_sample:
            at = j
            self.slots.append(None)
        else:
            at = int(self.draw.integers(0, j + 1))
            if at >= self.n_sample:
                return self.scratch
        self.slots[at] = (x, self.buffers[at])
        return self.buffers[at]

    def counters(self) -> dict:
        """The program's own counts: arena bytes, the schedules, program
        and HLT calls, the context's spans, kernel launches by name."""
        out = {"arena_bytes": self.ctx.arena.nbytes,
               "schedules": list(self.prog.plan.schedules)}
        out.update(self.ctx.counters)
        out["kernel_launches"] = {k: v for k, v in
                                  self.ops.launch_counts().items() if v}
        return out

    def reset_launches(self) -> None:
        self.ops.reset_launch_counts()

    def least(self) -> dict:
        return {}

    def release(self) -> None:
        self.prog = self.ctx = self.cts = self.w_cts = self.scratch = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, limits: dict) -> ref_chain.Judge:
        """Decode every kept pair with the reference at its hop's (level,
        scale) and compare it with X·W1·…·Wk and X·W1 of its input."""
        judge = ref_chain.Judge(limits)
        decs = [ref_ckks.Decryptor(self.sizes, generator(self.seed, 2),
                                   st.level, st.scale, self.device)
                for st in (self.out_state, self.hop1_state)]
        m, n, n1 = self.dims[0], self.dims[-1], self.dims[2]
        want = [(ref_chain.product(X, self.Ws),
                 ref_chain.product(X, self.Ws[:1])) for X in self.pool]
        for j, pairs in self.slots:
            got = []
            for dec, (c0, c1), cols in zip(decs, pairs, (n, n1)):
                slots = dec.decode(c0, c1, m * cols)
                got.append(None if slots is None
                           else ref_hemm.as_matrix(slots, m, cols))
            judge.add(got[0], want[j][0], got[1], want[j][1])
        return judge


def control(config: dict, traffic: dict, seed: int, limits: dict,
            device) -> ref_chain.Judge:
    """The control: the chain in bfloat16 put in the program's place, over
    the seed's pool, judged as the program's outputs are."""
    judge = ref_chain.Judge(limits)
    pool, Ws = inputs(config, traffic, seed)
    for X in pool:
        judge.add(ref_chain.control(X, Ws, device), ref_chain.product(X, Ws),
                  ref_chain.control(X, Ws[:1], device),
                  ref_chain.product(X, Ws[:1]))
    return judge
