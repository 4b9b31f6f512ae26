"""The readers of the program's own spans and counters on known inputs:
idle gaps split by time over the `ldpc.*` host spans, the shares inside
and outside them making up the device's idle share, the superstep turn
and drain from known DecodeStats, and no reading without the spans."""

from types import SimpleNamespace

import numpy as np
import pytest

from pbcore import cell
from pbcore.trace import DeviceEvent, Trace


def _spanless_trace():
    # what a program without the spans leaves: the benchmark's own range
    # and a runtime call over an idle gap
    dev = [DeviceEvent("void cn_kernel<x>", 0, 1000),
           DeviceEvent("void vn_kernel<x>", 5000, 6000)]
    host = [(0, 20000, "portbench.decode_call"),
            (1200, 4800, "cudaEventSynchronize")]
    return Trace(window_s=0.02, device=dev, host=host)


def _spans_trace():
    # four busy stretches, three idle gaps of 2 ms; the program's spans:
    # the first gap straddles the end of ldpc.flag_wait, all of
    # ldpc.retire and the start of ldpc.refill; the second is half the
    # bare ldpc.decode, half ldpc.sync; the third half ldpc.sync, then
    # the caller, with a stream's ldpc.stage inside the caller's time
    dev = [DeviceEvent("void cn_kernel<x>", 0, 1000),
           DeviceEvent("void vn_kernel<x>", 3000, 4000),
           DeviceEvent("void cn_kernel<x>", 6000, 7000),
           DeviceEvent("void vn_kernel<x>", 9000, 10000)]
    host = [(0, 10000, "portbench.decode_call"),
            (500, 7500, "ldpc.decode"),
            (800, 2000, "ldpc.flag_wait"),
            (2000, 2600, "ldpc.retire"),
            (2600, 3500, "ldpc.refill"),
            (5000, 7500, "ldpc.sync"),
            (7500, 9000, "portbench.check"),
            (7600, 8600, "ldpc.stage"),
            (7700, 8000, "cudaEventSynchronize")]
    return Trace(window_s=0.01, device=dev, host=host)


def test_idle_gaps_split_by_time_over_the_programs_spans():
    from pbcore import spans

    t = _spans_trace()
    split = spans.idle_split(t)
    assert split == {"ldpc.flag_wait": pytest.approx(0.001),
                     "ldpc.retire": pytest.approx(0.0006),
                     "ldpc.refill": pytest.approx(0.0004),
                     "ldpc.decode": pytest.approx(0.001),
                     "ldpc.sync": pytest.approx(0.0015),
                     "ldpc.stage": pytest.approx(0.001),
                     "": pytest.approx(0.0005)}
    assert sum(split.values()) == pytest.approx(spans.idle_seconds(t))
    # Trace.idle_gaps names the whole first gap after ldpc.flag_wait,
    # open at its start
    assert dict(t.idle_gaps())["ldpc.flag_wait"] == pytest.approx(0.002)


def test_idle_inside_and_outside_the_spans_make_up_device_idle():
    t = _spans_trace()
    run = SimpleNamespace(window=SimpleNamespace(trace=t))
    device = cell.reader("device.idle_share")(run)
    superstep = cell.reader("superstep.idle_share")(run)
    driver = cell.reader("driver.idle_share")(run)
    stage = cell.reader("stream.stage_idle_share")(run)
    assert (device, superstep, driver, stage) == (
        pytest.approx(60.0), pytest.approx(45.0), pytest.approx(5.0),
        pytest.approx(10.0))
    assert superstep + stage + driver == pytest.approx(device, abs=1e-9)
    assert cell.reader("stream.stage_ms")(run) == pytest.approx(1.0)


def test_turns_and_drain_from_known_stats():
    st = [SimpleNamespace(turn_ms=[1.0, 3.0], drain_supersteps=2,
                          total_supersteps=5),
          SimpleNamespace(turn_ms=None, drain_supersteps=1,
                          total_supersteps=5),
          SimpleNamespace(turn_ms=[5.0], drain_supersteps=0,
                          total_supersteps=10)]
    run = SimpleNamespace(window=SimpleNamespace(stats=st))
    assert cell.reader("superstep.turn_ms")(run) == pytest.approx(3.0)
    assert cell.reader("superstep.drain_share")(run) == pytest.approx(15.0)


NEW_READERS = ("superstep.turn_ms", "superstep.drain_share",
               "superstep.idle_share", "driver.idle_share",
               "stream.stage_idle_share", "stream.stage_ms")


@pytest.mark.parametrize("name", NEW_READERS)
def test_the_new_readers_find_nothing_without_their_spans(name):
    # a program without the spans, turns and counters: a trace with no
    # ldpc.* range, and stats as DecodeStats had them before
    old = SimpleNamespace(iterations=np.array([3]), total_supersteps=1,
                          total_iterations=3, batch_size=1)
    untimed = SimpleNamespace(turn_ms=None, drain_supersteps=0,
                              total_supersteps=1)
    reader = cell.reader(name)
    for stats in ([old], []):
        assert reader(SimpleNamespace(window=SimpleNamespace(
            trace=_spanless_trace(), stats=stats))) is None
    assert reader(SimpleNamespace(window=SimpleNamespace(
        trace=None, stats=[old]))) is None
    if name != "superstep.drain_share":
        assert reader(SimpleNamespace(window=SimpleNamespace(
            trace=None, stats=[untimed]))) is None
