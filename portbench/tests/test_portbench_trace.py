"""The trace reader on a made-up window: device time as a union of
intervals, gaps labelled by the host's innermost op, the breakdown."""

import pytest

from portbench.trace import WINDOW_SPAN, Trace


def ev(name, start, dur, device=False, thread=1, annotation=False):
    return {"name": name, "start": start, "dur": dur, "device": device,
            "thread": thread, "annotation": annotation}


EVENTS = [
    ev(WINDOW_SPAN, 0, 1_000_000, annotation=True),
    ev("portbench.train_step", 100_000, 300_000, annotation=True),
    ev("aten::mm", 150_000, 200_000),
    ev("portbench.ot_pair", 500_000, 400_000, annotation=True),
    ev("lap_solve", 600_000, 100_000, thread=2),
    ev("k1", 0, 200_000, device=True),
    ev("k2", 100_000, 300_000, device=True),      # overlaps k1
    ev("k1", 410_000, 5_000, device=True),        # a 10 us gap before it
    ev("k3", 950_000, 100_000, device=True),      # runs past the window
    ev(WINDOW_SPAN, 0, 1_000_000, device=True, annotation=True),
]


def test_busy_is_a_union_clipped_to_the_window():
    t = Trace(EVENTS, window_s=1e-3)
    assert t.busy_s() == pytest.approx((400_000 + 5_000 + 50_000) / 1e9)
    assert t.kernel_seconds("k1") == pytest.approx(205_000 / 1e9)
    assert t.kernel_count("k") == 4


def test_gaps_take_the_window_threads_innermost_op():
    t = Trace(EVENTS, window_s=1e-3)
    assert t.gaps() == [(400_000, 410_000), (415_000, 950_000)]
    assert t.host_label(700_000) == "portbench.ot_pair: Python"
    assert t.host_label(200_000) == "portbench.train_step: aten::mm"
    assert t.host_label(450_000) == "window: Python"
    b = t.breakdown()
    assert b["device_ops"][0] == ["k2", pytest.approx(3e-4)]
    assert ["gaps under 20 us", pytest.approx(1e-5)] in b["idle_gaps"]
    assert b["idle_gaps"][0][0] == "portbench.ot_pair: Python"


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(RuntimeError):
        Trace(EVENTS[1:-1], window_s=1e-3)
