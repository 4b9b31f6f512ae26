"""The metric arithmetic on known inputs: the percentile, lane use from
known DecodeStats, the device's busy and idle shares, the idle gaps by
host activity and a roofline share from a synthetic trace."""

from types import SimpleNamespace

import numpy as np
import pytest

from pbcore import cell, yardstick
from pbcore.graph import Graph
from pbcore.readers import percentile
from pbcore.trace import DeviceEvent, Trace


def test_p90_is_the_nearest_rank():
    values = list(range(1, 101))
    assert percentile(values, 90) == 90
    assert percentile([5.0, 1.0, 3.0], 90) == 5.0
    assert percentile(list(range(1, 11)), 90) == 9
    p90 = cell.reader("chunk_latency_p90_ms", "end_to_end")
    run = SimpleNamespace(window=SimpleNamespace(
        latencies=[0.001 * v for v in values]))
    assert p90(run) == pytest.approx(90.0)
    assert p90(SimpleNamespace(window=SimpleNamespace(latencies=[]))) is None


def test_decoded_rate_and_setup():
    run = SimpleNamespace(cfg={"n_vars": 1 << 20}, setup_s=12.5,
                          window=SimpleNamespace(frames=600, seconds=2.0))
    assert cell.reader("decoded_mbps", "end_to_end")(run) == 300.0
    assert cell.reader("setup_s", "end_to_end")(run) == 12.5


def test_lane_use_from_known_stats():
    st = [SimpleNamespace(iterations=np.array([10, 20, 30, 40]),
                          total_iterations=40, batch_size=2),
          SimpleNamespace(iterations=np.array([14]), total_iterations=14,
                          batch_size=2)]
    run = SimpleNamespace(window=SimpleNamespace(stats=st))
    got = cell.reader("superstep.lane_use_share")(run)
    assert got == pytest.approx(100.0 * 114 / (80 + 28))


def _trace():
    # two CN launches of 1 ms, a VN of 2 ms, a parity and a packing kernel,
    # a copy overlapping the VN; a 4 ms idle gap under a host span
    dev = [DeviceEvent("void cn_kernel<__nv_bfloat16, 6, 8, PhiFast>(x)",
                       0, 1000),
           DeviceEvent("_Z17cn_regular_kernelIfLi30ELi2E7PhiFastEvPKT_",
                       1000, 2000),
           DeviceEvent("void vn_kernel<__nv_bfloat16, 4, 8, PhiFast>(x)",
                       2000, 4000),
           DeviceEvent("Memcpy DtoH (Device -> Pinned)", 3000, 4500),
           DeviceEvent("void parity_kernel<6, 16, GroupedSlots>(x)",
                       8500, 9000),
           DeviceEvent("void at::native::index_elementwise_kernel<x>",
                       9000, 10000)]
    host = [(0, 20000, "portbench.decode_call"),
            (4200, 8600, "cudaEventSynchronize")]
    return Trace(window_s=0.02, device=dev, host=host)


def test_busy_idle_and_gaps_of_a_synthetic_trace():
    t = _trace()
    assert t.busy_s == pytest.approx(0.006)
    run = SimpleNamespace(window=SimpleNamespace(trace=t))
    assert cell.reader("device.idle_share")(run) == pytest.approx(70.0)
    assert t.idle_gaps() == [["cudaEventSynchronize", pytest.approx(0.004)]]
    assert t.top_ops(1)[0][1] == pytest.approx(0.002)
    got = cell.reader("superstep.outside_bp_share")(run)
    assert got == pytest.approx(100.0 * 0.001 / 0.006)


def test_roofline_share_of_a_synthetic_trace():
    # one check degree: a check pass is one launch; two passes in 2 ms
    g = Graph(n_vars=8, n_checks=4, n_punctured=0,
              check_degrees=np.full(4, 4), var_degrees=np.full(8, 2),
              adjacency=np.repeat(np.arange(8), 2))
    cfg = {"Z": 4, "B": 16, "message_dtype": "bfloat16"}
    run = SimpleNamespace(cfg=cfg, graph=g,
                          window=SimpleNamespace(trace=_trace()))
    want = 2 * yardstick.pass_bytes(g, 4, 16, "bfloat16")["cn"]
    got = cell.reader("kernels.cn_roofline_share")(run)
    assert got == pytest.approx(100.0 * want / 3.35e12 / 0.002)
    got = cell.reader("kernels.vn_roofline_share")(run)
    want = 2 * yardstick.pass_bytes(g, 4, 16, "bfloat16")["vn"]
    assert got == pytest.approx(100.0 * want / 3.35e12 / 0.002)


def test_readers_find_nothing_without_a_trace():
    run = SimpleNamespace(window=SimpleNamespace(
        trace=None, upload_ms=[], compute_gap_ms=[]), window_peak_bytes=0)
    for m in ("kernels.cn_roofline_share", "superstep.outside_bp_share",
              "device.idle_share", "stream.upload_ms",
              "stream.compute_gap_ms", "device.peak_gib"):
        assert cell.reader(m)(run) is None


def test_trace_from_the_profilers_events():
    from pbcore.trace import from_profiler

    def ev(name, a, b, dev, annotation=False):
        return SimpleNamespace(
            name=name, is_user_annotation=annotation,
            time_range=SimpleNamespace(start=a, end=b),
            device_type=SimpleNamespace(name=dev))

    prof = SimpleNamespace(events=lambda: [
        ev("portbench.decode_call", 0, 9000, "CPU", True),
        ev("portbench.decode_call", 500, 8500, "CUDA", True),
        ev("void cn_kernel<x>", 1000, 2000, "CUDA"),
        ev("void vn_kernel<x>", 3000, 5000, "CUDA")])
    t = from_profiler(prof, window_s=0.009)
    assert [e.name for e in t.device] == ["void cn_kernel<x>",
                                          "void vn_kernel<x>"]
    assert t.window_s == pytest.approx(0.004)   # first start to last end
    assert t.busy_s == pytest.approx(0.003)
    assert t.host == [(0.0, 9000.0, "portbench.decode_call")]
