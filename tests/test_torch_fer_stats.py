"""``scripts/fer_stats_torch.py`` on the CPU at a tiny size: the JAX
script's environment variables and JSON keys, FER 0 below threshold on
every channel, and points equal to a decode of the same frames driven by
hand."""

import importlib.util
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoder_tpu_torch.codes.generate import (  # noqa: E402
    make_regular_code,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FER = _load("fer_stats_torch")


def _jax_point_keys():
    """The keys of a point in scripts/fer_stats.py's record, read from its
    source (running it needs the full-size code and a TPU)."""
    with open(os.path.join(REPO, "scripts", "fer_stats.py")) as f:
        src = f.read()
    block = src[src.index("pt = {"):]
    block = block[:block.index("}")]
    return set(re.findall(r'"(\w+)":', block))


@pytest.fixture(scope="module")
def alist(tmp_path_factory):
    path = tmp_path_factory.mktemp("fer") / "reg36_512.alist"
    make_regular_code(512, 3, 6, seed=7).to_alist(str(path))
    return str(path)


@pytest.mark.parametrize("channel,xs", [("0", "0.6,0.65"), ("1", "0.02"),
                                        ("2", "0.25")])
def test_main_writes_the_jax_record(monkeypatch, tmp_path, alist, channel,
                                    xs):
    out = tmp_path / "fer.json"
    for k, v in {"FRAMES": "64", "SIGMAS": xs, "CHANNEL": channel,
                 "FER_ALIST": alist, "FER_OUT": str(out)}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("FIRST_CHECK", raising=False)
    assert FER.main(["--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert {"n_vars", "n_erased", "max_iter", "channel", "points"} <= set(rec)
    assert rec["n_vars"] == 512 and rec["channel"] == int(channel)
    assert rec["device"] == "cpu"
    assert [p["sigma"] for p in rec["points"]] == [float(x) for x in
                                                  xs.split(",")]
    for p in rec["points"]:
        assert set(p) == _jax_point_keys() | {"datagen_s"}
        assert p["frames"] == 64 and p["fer1"] == 0.0 and p["ber"] == 0.0
        assert p["fer1_events"] == p["bit_errors"] == 0
        assert 1 <= p["avg_iters"] <= p["max_iters"] <= FER.MAX_ITER
        assert p["first_check"] == 0 and p["datagen_s"] >= 0.0


def test_first_check_rule():
    assert FER.first_check_for(0, 0.94) == 70
    assert FER.first_check_for(0, 0.93) == 0
    assert FER.first_check_for(1, 0.95) == 0
    assert FER.first_check_for(0, 0.5, "12") == 12


def test_point_equals_a_hand_driven_decode(alist):
    """Over the BSC (exact values) a point is the decode of the same
    frames driven by hand from the host datagen, with the script's
    decoder: the same iterations, no error; the first check delays every
    frame's retirement."""
    from ldpc_decoder_tpu_torch.channels import BSCChannel
    from ldpc_decoder_tpu_torch.codes.qc import load_qc_alist
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    code, qc = load_qc_alist(alist)
    pt = FER.qualify_point(code, qc, 1, 0.03, 96, 20, "cpu",
                           log=lambda m: None)
    ch = BSCChannel(0.03)
    dec = LDPCDecoder(code, ch, StaticParams(
        max_log_parallel_factor_user=8, message_dtype="bfloat16",
        device_memory_bytes=FER.CPU_MEMORY_BYTES), qc=qc, device="cpu")
    batch = create_data(code, ch, 0, 96, backend="numpy")
    res, st = dec.decode(DynamicParams(num_iter_max=FER.MAX_ITER,
                                       num_iter_check_parity=14,
                                       num_iter_first_check=20,
                                       loading_factor=2), 96,
                         batch.values, batch.syndromes)
    assert (res == batch.ref_bits_packed()).all()
    assert pt["frames"] == 96 and pt["first_check"] == 20
    assert pt["fer1"] == 0.0 and pt["bit_errors"] == 0
    assert st.min_iter >= 20
    assert pt["avg_iters"] == round(float(np.mean(st.iterations)), 2)
    assert pt["max_iters"] == st.max_iter


# ---- against the JAX script's protocol -------------------------------------

def _jax_record(jcode, js, channel_idx, x, frames, first_check, dtype):
    """A point of scripts/fer_stats.py's record, computed as that script
    computes it (the JAX decoder at max_log_parallel_factor_user=8, pools
    of 2B frames from create_pool_device, k = 14, loading factor 2), its QC
    passes through the XLA ops that the Pallas kernels are held to (the
    Pallas kernels in interpret mode take minutes at these shapes)."""
    from ldpc_decoder_tpu.channels import (
        BIAWGNChannel,
        BSCChannel,
        ErasureChannel,
    )
    from ldpc_decoder_tpu.runtime.datagen_device import (
        count_bit_errors,
        create_pool_device,
    )
    from ldpc_decoder_tpu.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu.runtime.params import DynamicParams, StaticParams

    ch = {0: BIAWGNChannel, 1: BSCChannel, 2: ErasureChannel}[channel_idx](x)
    dec = LDPCDecoder(jcode, ch, StaticParams(
        max_log_parallel_factor_user=8, message_dtype=dtype,
        kernel_impl="xla"), qc=js)
    B = dec.parallel_factor()
    dyn = DynamicParams(num_iter_max=120, num_iter_check_parity=14,
                        num_iter_first_check=first_check, loading_factor=2)
    errs, iters = [], []
    for lo in range(0, frames, 2 * B):
        n = min(2 * B, frames - lo)
        pool = create_pool_device(dec.cc, dec.tables, ch, lo, n)
        res, st = dec.decode_presorted(dyn, n, pool.values_sorted,
                                       pool.syn_sorted, fetch_results=False)
        errs.append(np.asarray(count_bit_errors(res, pool.ref_packed)))
        iters.append(st.iterations)
    errors, iters = np.concatenate(errs), np.concatenate(iters)
    return {"frames": int(errors.size),
            "fer1_events": int((errors > 0).sum()),
            "fer15_events": int((errors > 15).sum()),
            "bit_errors": int(errors.sum()),
            "avg_iters": round(float(iters.mean()), 2),
            "max_iters": int(iters.max())}, B


def test_regular_dc30_bsc_point_equals_the_jax_record():
    """The rate-0.9 code's base (regular_base(8, 80, 3, 30, seed=3),
    d_c = 30) lifted at Z = 256 by the girth repair: the port's regular
    family at its d_c = 30 instantiations, the BSC at p = 0.0058 (iterations
    14 to 56, no frame error), equal to the JAX script's record of the same
    code and frames, exactly (BSC values are exact)."""
    from ldpc_decoder_tpu.codes import qc as jqc
    from ldpc_decoder_tpu.codes.protographs import regular_base as jrb

    from ldpc_decoder_tpu_torch.codes.protographs import regular_base
    from ldpc_decoder_tpu_torch.codes.qc import (
        make_qc_structure_repair,
        qc_to_code,
    )
    from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables

    s = make_qc_structure_repair(regular_base(8, 80, 3, 30, seed=3), Z=256,
                                 seed=1)
    js = jqc.make_qc_structure_repair(jrb(8, 80, 3, 30, seed=3), Z=256,
                                      seed=1)
    np.testing.assert_array_equal(s.edge_shift, js.edge_shift)
    code = qc_to_code(s)
    dec, _ = FER.qualification_decoder(code, s, 1, 0.0058, "cpu")
    assert isinstance(dec.tables, QCRegularTables)
    assert dec.tables.d_c == 30 and dec.tables.d_v == 3
    pt = FER.qualify_point(code, s, 1, 0.0058, 64, 0, "cpu",
                           log=lambda m: None)
    want, B = _jax_record(jqc.qc_to_code(js), js, 1, 0.0058, 64, 0,
                          "bfloat16")
    assert B == dec.parallel_factor() == 256
    assert {k: pt[k] for k in want} == want
    assert pt["fer1"] == 0.0 and pt["max_iters"] > 14


def test_fp8_point_matches_the_jax_decoder():
    """qualify_point(message_dtype="float8_e5m2") on the small p41 (the
    grouped family) at sigma 0.8 against the JAX decoder's float8_e5m2
    decode of the same pool, by tests/test_torch_qc_fp8.py's decode rule:
    equal words (every frame decoded to its reference bits on both sides,
    the same error counts) and iterations equal or one check period (14)
    apart; the bfloat16 point of the same frames beside it."""
    from ldpc_decoder_tpu.codes.protographs import p41_code as jax_p41

    from ldpc_decoder_tpu_torch.codes.protographs import p41_code
    from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables

    small = dict(Z=128, m=4, coarse=64, fine_mod=16)
    code, s = p41_code(**small)
    dec, _ = FER.qualification_decoder(code, s, 0, 0.8, "cpu",
                                       message_dtype="float8_e5m2")
    assert isinstance(dec.tables, GroupedQCTables)
    assert dec.msg_dtype == torch.float8_e5m2
    pt = FER.qualify_point(code, s, 0, 0.8, 64, 0, "cpu", log=lambda m: None,
                           message_dtype="float8_e5m2")
    jcode, js = jax_p41(**small)
    want, _ = _jax_record(jcode, js, 0, 0.8, 64, 0, "float8_e5m2")
    for k in ("frames", "fer1_events", "fer15_events", "bit_errors"):
        assert pt[k] == want[k], k
    assert pt["bit_errors"] == 0
    assert abs(pt["avg_iters"] - want["avg_iters"]) <= 14
    assert abs(pt["max_iters"] - want["max_iters"]) <= 14
    bf16 = FER.qualify_point(code, s, 0, 0.8, 64, 0, "cpu",
                             log=lambda m: None)
    assert bf16["bit_errors"] == 0 and bf16["frames"] == pt["frames"]
