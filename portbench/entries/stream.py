"""Entry ``stream``: frames from host memory through one stream.

The bank made on the card, then held in host memory as chunks of
``chunk_frames``; the window hands chunk after chunk, cycling the bank, to
one ``decode_streamed(..., depth)`` and takes each chunk's words in host
memory as the stream yields them. Each chunk's latency runs from its
hand-over to its words yielded; the program's CUDA events give each
chunk's upload span and the compute stream's gap before it. Parameters:
``bank_frames``, ``chunk_frames``, ``depth``, ``sample_frames``,
``trace_from``, ``trace_count``.
"""

import time

import numpy as np
import torch

from pbcore import drive


def make_bank(prog, graph, buckets, cfg, mix, seed, device) -> drive.Bank:
    return drive.make_bank(graph, buckets, cfg, mix, seed, device,
                           mix["chunk_frames"],
                           lambda v, s: (v.cpu().numpy(), s.cpu().numpy()),
                           "cpu")


def warm_up(prog, b: drive.Bank, mix) -> None:
    """Every shape the window uses: a stream over ``depth`` chunks (its
    pinned ring then comes from PyTorch's cached host blocks)."""
    for _ in prog.decoder.decode_streamed(
            prog.dyn, iter(b.groups[:mix["depth"]]), depth=mix["depth"]):
        pass


def window(prog, b: drive.Bank, mix, seconds, trace,
           answers: drive.Answers) -> drive.Window:
    dec, dyn, n_groups = prog.decoder, prog.dyn, len(b.groups)
    prof = drive.Profiler(trace)
    first, last = mix["trace_from"], mix["trace_from"] + mix["trace_count"]
    handed = []
    t0 = time.perf_counter()

    def feed():
        i = 0
        while (i < n_groups or time.perf_counter() - t0 < seconds
               or prof.pending and i < last):
            if i == first:
                prof.start()
            handed.append(time.perf_counter())
            yield b.groups[i % n_groups]
            i += 1

    w = drive.Window(0.0, 0, 0, [])
    prev = None
    stream = dec.decode_streamed(dyn, feed(), depth=mix["depth"])
    try:
        while True:
            with drive.span("portbench.stream_next", trace):
                item = next(stream, None)
            if item is None:
                break
            t_end = time.perf_counter()
            j = w.calls
            res, st = item
            w.latencies.append(t_end - handed[j])
            with drive.span("portbench.check", trace):
                answers.add(j % n_groups, torch.from_numpy(
                    res.view(np.int32)), st.iterations)
            if st.events is not None:
                ev = st.events
                w.upload_ms.append(ev["upload_start"].elapsed_time(
                    ev["upload_end"]))
                # the gaps before the first traced chunk and after the last
                # hold the profiler's own start and stop
                if prev is not None and not (trace and j in (first,
                                                             last + 1)):
                    w.compute_gap_ms.append(prev["decode_end"].elapsed_time(
                        ev["decode_start"]))
                prev = ev
            w.stats.append(st)
            w.calls += 1
            w.frames += res.shape[0]
            if w.calls == last:
                prof.stop()
    finally:
        stream.close()
    w.seconds = t_end - t0
    w.trace, w.traced_calls = prof.trace, (mix["trace_count"] if trace
                                           else 0)
    return w
