"""The decode loop's and the stream's host spans (``runtime/tracing.py``)
and ``DecodeStats``' counters, on the CPU.

With no profiler running the loop enters no profiler range and times no
turn. Under ``torch.profiler`` a ``decode_presorted`` shows
``ldpc.decode`` enclosing ``ldpc.start``, then ``ldpc.iterate``,
``ldpc.flag_wait``, ``ldpc.retire`` and ``ldpc.refill`` once per
superstep, then ``ldpc.sync``; a ``decode_streamed`` shows ``ldpc.stage``
and its three children once per chunk. Results, iteration counts and
counters are the same with and without the profiler. ``refills`` is
n_pool − B (every frame after the first fill), and ``drain_supersteps`` is
recounted through ``progress``: the supersteps launched while the frames
not yet retired were fewer than B. Tolerance: exact throughout.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from ldpc_decoder_tpu_torch.channels import BIAWGNChannel  # noqa: E402
from ldpc_decoder_tpu_torch.codes.generate import (  # noqa: E402
    make_regular_code,
)
from ldpc_decoder_tpu_torch.codes.protographs import p41_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.qc import make_qc_code  # noqa: E402
from ldpc_decoder_tpu_torch.parallel.mesh import make_batch_mesh  # noqa: E402
from ldpc_decoder_tpu_torch.runtime import tracing  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.datagen import create_data  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.params import (  # noqa: E402
    DynamicParams,
    StaticParams,
)

B = 16
N_POOL = 3 * B
# first check = k: no burst, so every ldpc.iterate is a superstep's
DYN = DynamicParams(num_iter_max=60, num_iter_check_parity=4,
                    num_iter_first_check=4)
SUPERSTEP = ("ldpc.iterate", "ldpc.flag_wait", "ldpc.retire",
             "ldpc.refill")
STAGE = ("ldpc.stage.slot_wait", "ldpc.stage.cast", "ldpc.stage.upload")


def _family(name):
    if name == "grouped":
        return p41_code(Z=128, m=4, coarse=64, fine_mod=16)
    if name == "regular":
        return make_qc_code(np.ones((3, 6), np.int8), Z=64, seed=1)
    return make_regular_code(512, 3, 6, seed=21), None


@pytest.fixture(scope="module")
def families():
    """Per family: a CPU decoder at B lanes and N_POOL frames."""
    out = {}
    ch = BIAWGNChannel(0.72)
    for name in ("grouped", "regular", "general"):
        code, s = _family(name)
        dec = LDPCDecoder(code, ch, StaticParams(
            parallel_factor_user=B, qc_autodetect=False,
            message_dtype="float32"), qc=s, device="cpu")
        batch = create_data(code, ch, 0, N_POOL, backend="numpy")
        out[name] = (dec, batch)
    return out


def _decode(dec, batch, n=N_POOL, progress=None):
    pv, ps = dec.upload_pools(batch.values[:, :n], batch.syndromes[:, :n])
    return dec.decode_presorted(DYN, n, pv, ps, progress=progress)


def _spans(prof):
    """(start, end, name) of the ldpc.* spans, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith("ldpc."))


def _counting(monkeypatch):
    """The profiler's ranges (the span's light one, and record_function),
    counting the ranges they make."""
    made = []
    for owner, attr in ((torch._C._profiler, "_RecordFunctionFast"),
                        (torch.profiler, "record_function")):
        def counted(name, *args, real=getattr(owner, attr), **kwargs):
            made.append(name)
            return real(name, *args, **kwargs)

        monkeypatch.setattr(owner, attr, counted)
    return made


def test_the_gate_follows_the_profiler():
    assert not tracing.active()
    assert tracing.span("ldpc.a") is tracing.span("ldpc.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.active()
        assert isinstance(tracing.span("ldpc.a"),
                          torch._C._profiler._RecordFunctionFast)
    assert not tracing.active()


@pytest.mark.parametrize("name", ["grouped", "general"])
def test_no_profiler_no_range_and_no_turns(families, monkeypatch, name):
    dec, batch = families[name]
    made = _counting(monkeypatch)
    _, st = _decode(dec, batch)
    for _ in dec.decode_streamed(DYN, iter([
            (batch.values[:, :B], batch.syndromes[:, :B])] * 2)):
        pass
    assert made == []
    assert st.turn_ms is None
    with profile(activities=[ProfilerActivity.CPU]):  # the count is live
        _decode(dec, batch)
    assert "ldpc.decode" in made


@pytest.mark.parametrize("name", ["grouped", "regular", "general"])
def test_decode_spans_nest_once_per_superstep(families, name):
    dec, batch = families[name]
    pv, ps = dec.upload_pools(batch.values, batch.syndromes)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, st = dec.decode_presorted(DYN, N_POOL, pv, ps)
    spans = _spans(prof)
    names = [n for _, _, n in spans]
    assert st.total_supersteps > 2 and st.turn_ms is None
    assert names == (["ldpc.decode", "ldpc.start"]
                     + list(SUPERSTEP) * st.total_supersteps
                     + ["ldpc.sync"])
    a, b, _ = spans[0]
    assert all(a <= s and e <= b for s, e, _ in spans[1:])
    # one superstep's spans follow each other without overlap
    for (_, e, _), (s, _, _) in zip(spans[1:], spans[2:]):
        assert e <= s


def test_stream_spans_once_per_chunk(families):
    dec, batch = families["regular"]
    chunks = [(batch.values[:, a:a + B], batch.syndromes[:, a:a + B])
              for a in range(0, N_POOL, B)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = list(dec.decode_streamed(DYN, iter(chunks)))
    assert len(out) == len(chunks)
    spans = _spans(prof)
    stages = [(a, b) for a, b, n in spans if n == "ldpc.stage"]
    assert len(stages) == len(chunks)
    for child in STAGE:
        inner = [(a, b) for a, b, n in spans if n == child]
        assert len(inner) == len(chunks)
        assert all(sa <= a and b <= sb
                   for (a, b), (sa, sb) in zip(inner, stages))
    assert sum(n == "ldpc.chunk_wait" for _, _, n in spans) == len(chunks)


@pytest.mark.parametrize("name", ["grouped", "regular", "general"])
def test_the_profiler_changes_no_result(families, name):
    dec, batch = families[name]
    words, st = _decode(dec, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        traced_words, traced = _decode(dec, batch)
    np.testing.assert_array_equal(traced_words, words)
    np.testing.assert_array_equal(traced.iterations, st.iterations)
    assert (traced.total_supersteps, traced.refills,
            traced.drain_supersteps) == (st.total_supersteps, st.refills,
                                         st.drain_supersteps)


@pytest.mark.parametrize("n", [N_POOL, B + 5, B, B - 5])
@pytest.mark.parametrize("name", ["grouped", "regular", "general"])
def test_refills_and_drain_supersteps(families, name, n):
    dec, batch = families[name]
    remaining = []
    _, st = _decode(dec, batch, n, progress=remaining.append)
    assert st.refills == n - min(B, n)
    before = [n] + remaining[:-1]  # the frames left at each launch
    assert len(before) == st.total_supersteps
    assert st.drain_supersteps == sum(r < B for r in before)
    assert 0 < st.drain_supersteps <= st.total_supersteps


def test_sharded_counters_sum_the_positions(families):
    dec, batch = families["regular"]
    mesh = make_batch_mesh(2, "cpu")
    _, st = dec.decode_sharded(DYN, N_POOL, batch.values, batch.syndromes,
                               mesh)
    assert st.refills == N_POOL - 2 * B
    assert 0 < st.drain_supersteps <= 2 * st.total_supersteps
    assert st.turn_ms is None
