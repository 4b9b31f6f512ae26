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
