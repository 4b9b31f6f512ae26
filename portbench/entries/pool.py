"""Entry ``pool``: frames on the card, decoded call after call.

A bank of ``bank_frames`` frames made on the card from the seed and staged
once, in set-up, by the program's ``upload_pools`` as pools of
``call_frames``; the window calls ``decode_presorted(...,
fetch_results=False)`` on pool after pool, cycling the bank. A call's
frames have reached the caller when the call returns (it synchronises its
stream). Parameters: ``bank_frames``, ``call_frames``, ``sample_frames``,
``trace_from``, ``trace_count``.
"""

import time

import torch

from pbcore import drive


def make_bank(prog, graph, buckets, cfg, mix, seed, device) -> drive.Bank:
    pinned = torch.device(device).type == "cuda"
    bounce = []

    def stage(v, s):
        # one host buffer for every pool: upload_pools takes host arrays and
        # has copied them into its own pinned slot when it returns
        if not bounce:
            bounce.extend(torch.empty(x.shape, dtype=x.dtype,
                                      pin_memory=pinned) for x in (v, s))
        bounce[0].copy_(v)
        bounce[1].copy_(s)
        return prog.decoder.upload_pools(bounce[0].numpy(),
                                         bounce[1].numpy())

    return drive.make_bank(graph, buckets, cfg, mix, seed, device,
                           mix["call_frames"], stage, device)


def warm_up(prog, b: drive.Bank, mix) -> None:
    """The one shape the window uses: a call on one pool."""
    prog.decoder.decode_presorted(prog.dyn, b.group_frames, *b.groups[0],
                                  fetch_results=False)


def window(prog, b: drive.Bank, mix, seconds, trace,
           answers: drive.Answers) -> drive.Window:
    dec, dyn, n = prog.decoder, prog.dyn, b.group_frames
    prof = drive.Profiler(trace)
    first, last = mix["trace_from"], mix["trace_from"] + mix["trace_count"]
    stats, calls = [], 0
    t0 = time.perf_counter()
    while True:
        if calls == first:
            prof.start()
        g = calls % len(b.groups)
        with drive.span("portbench.decode_call", trace):
            words, st = dec.decode_presorted(dyn, n, *b.groups[g],
                                             fetch_results=False)
        t_end = time.perf_counter()
        with drive.span("portbench.check", trace):
            answers.add(g, words, st.iterations)
        del words
        stats.append(st)
        calls += 1
        if calls == last:
            prof.stop()
        if (t_end - t0 >= seconds and calls >= len(b.groups)
                and not prof.pending):
            break
    return drive.Window(t_end - t0, calls, calls * n, stats, trace=prof.trace,
                        traced_calls=mix["trace_count"] if trace else 0)
