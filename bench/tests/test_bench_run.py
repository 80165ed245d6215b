"""Whole runs of the harness on the toy cell (``tests/toy``) on the CPU,
past the harness's look for a chip: the last line's shape, the import check,
the faults that the check has to catch, and the control."""
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import run
from helpers import TOY_CELL, need_chip
from kinds import hemm as kind
from reference import hemm as ref


def _run(toy, trace=False, seed=20261018):
    return run.run(TOY_CELL, seed, 0.5, trace, "cpu", root=toy,
                   t0=time.perf_counter(), log=lambda *a: None)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_last_line_shape(toy, trace):
    res = _run(toy, trace)
    assert list(res)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= (2 if trace else 1)
    cell = run.load_cell(TOY_CELL, toy)
    listed = {m["name"]: m["unit"]
              for m in (cell.per_layer if trace else cell.end_to_end)}
    for name, got in res["metrics"].items():
        assert got["unit"] == listed[name]
        assert isinstance(got["value"], float)
    # the CPU has no device trace and no allocator peak: those are absent
    want = ({"arena_gb", "request_mfu", "hlt_ms", "loop_ms"} if trace
            else {"request_ms", "setup_s"})
    assert set(res["metrics"]) == want
    assert list(res["check"]) == list(ref.NUMBERS)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    json.loads(json.dumps(res))


def test_a_run_loads_no_jax(toy):
    """A toy run in a fresh process leaves no module whose top-level name is
    jax, jaxlib, flax or repro in ``sys.modules`` (``repro_torch`` passes:
    names are compared whole)."""
    code = ("import sys, time; sys.path[:0] = [%r, %r]; import run; "
            "run.run(%r, 5, 0.2, True, 'cpu', root=run.pathlib.Path(%r), "
            "t0=time.perf_counter(), log=lambda *a: None); "
            "print(sorted(k for k in sys.modules if k.split('.')[0] == "
            "'repro_torch')[:1], run.forbidden_modules())"
            % (str(run.BENCH), str(run.ROOT / "src"), TOY_CELL, str(toy)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    assert out.strip().splitlines()[-1] == "['repro_torch'] []"


def _faulty(monkeypatch, fault):
    from repro_torch.core.compile import HEMMProgram
    call = HEMMProgram.__call__
    calls = {"n": 0}

    def unchanged(self, ctA, ctB):
        return ctA

    def half_batch(self, ctA, ctB):
        """Every stage as the program runs it, but the mean of half the
        products (their sum, doubled) in place of the whole sum."""
        eng, keys, l = self.ctx.eng, self.ctx.keys, self.mm_plan.l
        a0, b0 = self._step1([ctA, ctB])
        from repro_torch.core.hlt import hoist_batched
        inA, inB = hoist_batched(eng, [a0, b0],
                                 datapath=self.plan.step2.datapath)
        outs = self._step2([inA] * l + [inB] * l)
        acc = None
        for k in range(l // 2):
            prod = eng.rescale(eng.mult(outs[k], outs[l + k], keys))
            acc = prod if acc is None else eng.add(acc, prod)
        return eng.add(acc, acc)

    def altered(self, ctA, ctB):
        """The second request's answer is B·A."""
        calls["n"] += 1
        return call(self, ctB, ctA) if calls["n"] == 3 else call(self,
                                                                  ctA, ctB)

    def one_row(self, ctA, ctB):
        """Every answer with one row of C off by 0.3, added where the
        product is produced."""
        out = call(self, ctA, ctB)
        eng, (m, n) = self.ctx.eng, (self.mm_plan.m, self.mm_plan.n)
        delta = np.zeros(m * n)
        delta[m // 2::m] = 0.3          # row m/2, column-major
        pt = eng.encode(delta, level=out.level, scale=out.scale)
        return eng.add(out, eng.encrypt(pt, self.ctx.keys,
                                        np.random.default_rng(1)))

    monkeypatch.setattr(HEMMProgram, "__call__",
                        {"unchanged": unchanged, "half_batch": half_batch,
                         "altered": altered, "one_row": one_row}[fault])


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "one_row"])
def test_a_broken_program_is_not_correct(toy, monkeypatch, fault):
    """The timed path broken underneath; the rest of the run as it is."""
    _faulty(monkeypatch, fault)
    res = _run(toy)
    assert res["attempted"] >= 2
    assert res["correct"] is False
    assert res["failed"] >= 1
    if fault == "one_row":              # past the median, caught by the mean
        got = res["check"]["worst_median_err"]
        assert got["value"] <= got["limit"]


CELLS = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [4100000001, 4100000002, 4100000003]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(cell, seed):
    """The reference in bfloat16 put in the program's place, at the cell's
    own size and limits, on the CPU."""
    c = run.load_cell(cell)
    judge = kind.control(c.config, c.traffic, seed, c.settings["limits"],
                         "cpu")
    assert not judge.correct()


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    need_chip()
    c = run.load_cell(cell)
    for seed in SEEDS:
        judge = kind.control(c.config, c.traffic, seed, c.settings["limits"],
                             "cuda")
        print(cell, seed, judge.numbers())
        assert not judge.correct()


def test_inputs_are_fixed_by_the_seed():
    c = run.load_cell(CELLS[0])
    a = kind.pairs(c.config, c.traffic, 2 ** 31 + 7)
    b = kind.pairs(c.config, c.traffic, 2 ** 31 + 7)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(a, b, strict=True))
    assert len(a) == c.traffic["pool"]
    assert not np.array_equal(a[0][0], a[1][0])
    assert torch.tensor(a[0][0]).abs().max() < 1


@pytest.mark.parametrize("seen", [3, 8, 40])
def test_the_check_keeps_a_sample_drawn_from_the_seed(seen):
    """Algorithm R over the window's requests: every request copies into a
    slot or the scratch pair; min(sample, seen) slots are filled, the same
    requests for the same seed."""
    def keep(seed):
        s = kind.Session.__new__(kind.Session)
        s.n_sample, s.draw, s.slots, s.seen = 8, kind.generator(seed, 4), [], 0
        s.scratch = (torch.zeros(1), torch.zeros(1))
        s.buffers = [(torch.zeros(1), torch.zeros(1)) for _ in range(8)]
        for i in range(seen):
            c0, _ = s._target(i)
            c0.fill_(i)
        assert len(s.slots) == min(8, seen)
        return sorted(int(c0) for _, c0, _ in s.slots)
    got = keep(2 ** 31 + 9)
    assert got == keep(2 ** 31 + 9)
    assert len(set(got)) == len(got) and set(got) <= set(range(seen))
    if seen > 8:                        # later requests displace early ones
        assert max(got) >= 8
