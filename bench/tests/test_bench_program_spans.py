"""The readers of the program's own spans and counters (``he.*`` keys of
``HEContext.counters``, copied into the record's ``counters``): None on a
program without them, the right ratio on a toy record."""
import pytest

import run

#: reader -> its value on ``COUNTS``
WANT = {"keyswitch_ms": 24e6 / 4 / 1e6, "rescale_ms": 8e6 / 4 / 1e6,
        "request_h2d": 2562 / 4, "keygen_s": 17.5}

COUNTS = {"arena_bytes": 1, "schedule": "pallas", "hlt_launches": 8,
          "program_launches": 4, "kernel_launches": {},
          "he.call.ns": 40_000_000, "he.call.calls": 4, "he.call.h2d": 2562,
          "he.key_switch.ns": 24_000_000, "he.key_switch.calls": 512,
          "he.key_switch.h2d": 2560, "he.rescale.ns": 8_000_000,
          "he.rescale.calls": 512, "he.rescale.h2d": 0,
          "he.keygen.ns": 17_500_000_000, "he.keygen.calls": 1,
          "he.keygen.h2d": 900}


def _record(counters: dict) -> run.Record:
    return run.Record(setup_s=30.0, window_s=51.0, requests=4, peak_bytes=0,
                      counters=counters, least={}, spans=[])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_values(metric):
    got = run.reader(metric)(_record(COUNTS))
    assert isinstance(got, float)
    assert got == pytest.approx(WANT[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_none_without_its_keys(metric):
    """The parent's counters: the two context counts alone."""
    old = {k: v for k, v in COUNTS.items() if not k.startswith("he.")}
    assert run.reader(metric)(_record(old)) is None


@pytest.mark.parametrize("metric", ["keyswitch_ms", "rescale_ms",
                                    "request_h2d"])
def test_per_call_readers_none_without_a_call(metric):
    """Keys present but no program call closed: no average."""
    assert run.reader(metric)(_record(dict(COUNTS, **{"he.call.calls": 0}))) \
        is None


def test_readers_listed_in_both_cells():
    for metric in WANT:
        for cell in ("hemm-setb-128", "hemm-setc-75"):
            names = [m["name"] for m in run.load_cell(cell).per_layer]
            assert metric in names, (metric, cell)
