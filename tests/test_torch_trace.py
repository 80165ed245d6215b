"""The spans and counters inside the port (``core/trace.py``): what one call
of a compiled ``pallas`` hemm adds to ``HEContext.counters``, its profiler
ranges on and off, ``keygen``'s span, and the scope rules.  On a CUDA
device (``-m chip``), the copy counter against the profiler's
``Memcpy HtoD`` events.  Imports no JAX: counts and the program's own
outputs are the subject."""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core import trace
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.compile import HEContext, compile_hemm
from repro_torch.core.costmodel import loop_chunk
from repro_torch.core.hemm import encrypt_matrix, plan_hemm

SHAPE = (4, 4, 4)
SPANS = ("he.call", "he.loop_chunk", "he.key_switch", "he.rescale")
STAGES = ("he.step1", "he.step2_hoist", "he.step2", "he.loop")


def _build(device: str) -> dict:
    """fame-m-rt, engine datapath "pallas", a compiled "pallas" hemm at 4³
    and one warm-up call."""
    rng = np.random.default_rng(30)
    ctx = HEContext(CkksEngine(FAME_VERIFY_SETS["fame-m-rt"], device=device,
                               datapath="pallas"))
    plan = plan_hemm(ctx.eng, *SHAPE)
    before = dict(ctx.counters)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    after_keygen = dict(ctx.counters)
    m, l, n = SHAPE
    cts = (encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (m, l)), rng),
           encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (l, n)), rng))
    prog = compile_hemm(ctx, plan, schedule="pallas")
    prog(*cts)                                  # the first call's tables
    return dict(ctx=ctx, prog=prog, cts=cts, before=before,
                after_keygen=after_keygen)


def _call(s: dict):
    """One call; (output, counter deltas)."""
    c0 = dict(s["ctx"].counters)
    out = s["prog"](*s["cts"])
    return out, {k: v - c0.get(k, 0) for k, v in s["ctx"].counters.items()}


def _expected_h2d(s: dict) -> int:
    """Nothing copies once the first call has built its tables: the key
    switch reads its rows as slices (it made 1 + 2·d copies a product
    while it built a row table and two list indices a digit)."""
    return 0


def _chunks(s: dict) -> int:
    """The loop's chunks a call: l products at the loop's level in chunks
    of ``costmodel.loop_chunk``, beside Step 2's 2·l HLTs."""
    prog = s["prog"]
    l, level = prog.mm_plan.l, prog.plan.level - 2
    return -(-l // loop_chunk(s["ctx"].eng.params, level, l, 2 * l))


@pytest.fixture(scope="module")
def s():
    return _build("cpu")


def test_keygen_adds_one_span(s):
    before, after = s["before"], s["after_keygen"]
    assert not any(k.startswith("he.") for k in before)
    assert after["he.keygen.calls"] == 1
    assert after["he.keygen.ns"] > 0 and after["he.keygen.h2d"] > 0
    assert {k: after[k] for k in before} == before


def test_one_call_adds_its_spans(s):
    chunks = _chunks(s)
    _, got = _call(s)
    assert got["he.call.calls"] == 1
    assert chunks > 1 and got["he.loop_chunk.calls"] == chunks
    assert got["he.key_switch.calls"] == got["he.rescale.calls"] == chunks
    assert got["he.call.h2d"] == got["he.key_switch.h2d"] == _expected_h2d(s)
    assert got["he.rescale.h2d"] == 0
    assert got["he.call.ns"] >= got["he.loop_chunk.ns"] >= \
        got["he.key_switch.ns"] + got["he.rescale.ns"]
    assert got["he.key_switch.ns"] > 0 and got["he.rescale.ns"] > 0
    # the context's own counters count as before; keygen's stay put
    assert got["hlt_launches"] == 2 and got["program_launches"] == 1
    assert got["he.keygen.calls"] == got["he.keygen.ns"] == 0


def test_spans_record_nothing_outside_a_scope(s):
    """The engine's ops called bare (as plan and encryption are) add no
    key; a scope on another table takes them."""
    ctx, (ctA, _) = s["ctx"], s["cts"]
    c0 = dict(ctx.counters)
    ctx.eng.rescale(ctA)
    assert dict(ctx.counters) == c0
    table = {}
    with trace.scope(table), trace.scope(table):       # nested: one table
        ctx.eng.rescale(ctA)
        trace.h2d(3)
    assert table == {"he.rescale.ns": table["he.rescale.ns"],
                     "he.rescale.calls": 1, "he.rescale.h2d": 0}
    with trace.scope(table), trace.span("outer"):
        trace.h2d(2)
        with trace.span("inner"):
            trace.h2d()
    assert (table["outer.h2d"], table["inner.h2d"]) == (3, 1)
    assert table["outer.ns"] >= table["inner.ns"]


def _profile(s: dict, on: bool, hook=None):
    prog = s["prog"]
    prog.stage_hook = hook
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
                trace.ranges(on):
            out = prog(*s["cts"])
    finally:
        prog.stage_hook = None
    return out, prof.events()


def test_ranges_on_and_off(s):
    """Profiler ranges: the same outputs either way; with them on every
    span and stage is a host range inside ``he.call``, the loop's spans
    inside ``he.loop``, and the stage hook outside every stage range; with
    them off no event carries a span's or a stage's name."""
    chunks = _chunks(s)

    def hook(name):
        with torch.profiler.record_function(f"test.hook.{name}"):
            pass

    off, ev_off = _profile(s, False, hook)
    on, ev_on = _profile(s, True, hook)
    for a, b in ((off.c0, on.c0), (off.c1, on.c1)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    names = SPANS + STAGES
    assert not [e.name for e in ev_off if e.name in names]
    got = {n: [(e.time_range.start, e.time_range.end) for e in ev_on
               if e.name == n] for n in names}
    hooks = [(e.time_range.start, e.time_range.end) for e in ev_on
             if e.name.startswith("test.hook.")]
    assert len(got["he.call"]) == 1 and len(hooks) == 5
    assert all(len(got[n]) == 1 for n in STAGES)
    assert len(got["he.loop_chunk"]) == len(got["he.key_switch"]) == \
        len(got["he.rescale"]) == chunks
    inside = lambda iv, out: out[0] <= iv[0] and iv[1] <= out[1]  # noqa: E731
    call, loop = got["he.call"][0], got["he.loop"][0]
    for n in names[1:]:
        assert all(inside(iv, call) for iv in got[n]), n
    for n in ("he.loop_chunk", "he.key_switch", "he.rescale"):
        assert all(inside(iv, loop) for iv in got[n]), n
    for h in hooks:
        assert not any(a < h[1] and h[0] < b
                       for n in STAGES for a, b in got[n]), h


def test_a_call_that_raises_closes_its_ranges(s):
    """An error inside the loop: the open stage range and the spans close,
    and the call is counted, as ``program_launches`` counts it."""
    ctx, prog, (ctA, ctB) = s["ctx"], s["prog"], s["cts"]
    c0 = dict(ctx.counters)

    def fail(*args):
        raise RuntimeError("key switch")

    ctx.eng.key_switch = fail
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
                trace.ranges(), pytest.raises(RuntimeError, match="key"):
            prog(ctA, ctB)
    finally:
        del ctx.eng.key_switch
    names = [e.name for e in prof.events()]
    assert names.count("he.call") == names.count("he.loop") == 1
    assert ctx.counters["he.call.calls"] == c0["he.call.calls"] + 1
    assert ctx.counters["program_launches"] == c0["program_launches"] + 1
    assert ctx.counters["he.key_switch.calls"] == c0["he.key_switch.calls"]
    bad = ctx.eng.mod_drop(ctB, ctB.level - 1)
    with pytest.raises(ValueError, match="input levels"):
        prog(ctA, bad)
    assert ctx.counters["he.call.calls"] == c0["he.call.calls"] + 2


@pytest.mark.chip
def test_chip_h2d_counter_matches_memcpy_events():
    """On the card: one warm call's ``he.call.h2d`` equals the profiler's
    ``Memcpy HtoD`` device events, and how many of those copies
    synchronise the stream (``set_sync_debug_mode("warn")``) is printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import build
    build.load()
    s = _build("cuda")
    _call(s)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, got = _call(s)
        torch.cuda.synchronize()
    copies = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "HtoD" in e.name]
    assert got["he.call.h2d"] == len(copies) == _expected_h2d(s)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _call(s)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    print(f"h2d {got['he.call.h2d']}, Memcpy HtoD {len(copies)}, "
          f"synchronising calls {len(syncs)}")
