"""The port's ``LDPCDecoder.decode_sharded`` against the JAX package's.

The JAX side decodes on a 4-device mesh of the virtual CPU devices that
tests/conftest.py makes; the port on a ``BatchMesh`` of four CPU replicas.
Both deal the frames round-robin and pad them with -1.0 frames, and each
position refills its lanes from its own pool, so per-frame iteration
counts depend on the deal: the two are held to each other at the same mesh
size and B, never to one unsharded decode. Settings per family are those
of the port's other decoder tests: float32 sum-product with the JAX
decoder's XLA kernels for the grouped (a small p41 lift, first check at
iteration 10) and regular (3,6) families (tests/test_torch_decoder.py),
its Pallas general path for a random (3,6) code
(tests/test_torch_general.py), and its XLA path for float8_e5m2 on that
code (tests/test_torch_general_fp8.py). Words, per-frame iterations and the
statistics must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402
from ldpc_decoder_tpu.codes.generate import (  # noqa: E402
    make_regular_code as jmake_regular,
)
from ldpc_decoder_tpu.codes.protographs import p41_code as jax_p41  # noqa: E402
from ldpc_decoder_tpu.codes.qc import make_qc_code as jax_make_qc  # noqa: E402
from ldpc_decoder_tpu.parallel.mesh import (  # noqa: E402
    make_batch_mesh as jax_mesh,
)
from ldpc_decoder_tpu.runtime import params as jparams  # noqa: E402
from ldpc_decoder_tpu.runtime.datagen import create_data  # noqa: E402
from ldpc_decoder_tpu.runtime.decoder import (  # noqa: E402
    LDPCDecoder as JaxLDPCDecoder,
)

from ldpc_decoder_tpu_torch.channels import BIAWGNChannel  # noqa: E402
from ldpc_decoder_tpu_torch.codes.generate import make_regular_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.protographs import p41_code  # noqa: E402
from ldpc_decoder_tpu_torch.codes.qc import make_qc_code  # noqa: E402
from ldpc_decoder_tpu_torch.ops.general import GeneralTables  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables  # noqa: E402
from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables  # noqa: E402
from ldpc_decoder_tpu_torch.parallel import mesh as M  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder  # noqa: E402
from ldpc_decoder_tpu_torch.runtime.params import (  # noqa: E402
    DynamicParams,
    StaticParams,
)

N_DEV = 4
B = 8


def _p41():
    kw = dict(Z=128, m=4, coarse=64, fine_mod=16)
    return jax_p41(**kw), p41_code(**kw)


def _regular():
    base = np.ones((3, 6), np.int8)
    return (jax_make_qc(base, Z=128, seed=1),
            make_qc_code(base, Z=128, seed=1))


def _general():
    return ((jmake_regular(512, 3, 6, seed=21), None),
            (make_regular_code(512, 3, 6, seed=21), None))


# (codes, port static params, JAX-only static params, sigma, first check,
# the port's tables)
CASES = {
    "grouped": (_p41, dict(message_dtype="float32"),
                dict(kernel_impl="xla"), 0.7, 10, GroupedQCTables),
    "regular": (_regular, dict(message_dtype="float32"),
                dict(kernel_impl="xla"), 0.7, 0, QCRegularTables),
    "general": (_general, dict(message_dtype="float32",
                               qc_autodetect=False),
                dict(kernel_impl="pallas"), 0.72, 0, GeneralTables),
    "general-fp8": (_general, dict(message_dtype="float8_e5m2",
                                   qc_autodetect=False),
                    {}, 0.72, 0, GeneralTables),
}


def _decoders(case):
    codes, kw, jkw, sigma, first, tables = CASES[case]
    (jcode, js), (code, s) = codes()
    jdec = JaxLDPCDecoder(jcode, JaxBIAWGN(sigma), jparams.StaticParams(
        parallel_factor_user=B, **kw, **jkw), qc=js)
    dec = LDPCDecoder(code, BIAWGNChannel(sigma), StaticParams(
        parallel_factor_user=B, **kw), qc=s, device="cpu")
    assert isinstance(dec.tables, tables)
    dyn = dict(num_iter_max=40, num_iter_check_parity=5,
               num_iter_first_check=first)
    return jdec, dec, jcode, sigma, dyn


@pytest.mark.parametrize("n", [B * 3 * N_DEV + 5, B * 2 * N_DEV])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_sharded_matches_jax(case, n):
    """Words, per-frame iterations and statistics equal to the JAX
    decoder's ``decode_sharded`` on a 4-device mesh; 3B + 2 frames a
    position with pads (B x 3 x 4 + 5 frames), or exactly 2B."""
    jdec, dec, jcode, sigma, dyn = _decoders(case)
    batch = create_data(jcode, JaxBIAWGN(sigma), 0, n, backend="numpy")
    jres, jst = jdec.decode_sharded(jparams.DynamicParams(**dyn), n,
                                    batch.values, batch.syndromes,
                                    jax_mesh(N_DEV))
    res, st = dec.decode_sharded(DynamicParams(**dyn), n, batch.values,
                                 batch.syndromes,
                                 M.make_batch_mesh(N_DEV, "cpu"))
    assert res.dtype == np.uint32 and res.shape == (n, dec.n_words)
    np.testing.assert_array_equal(res, np.asarray(jres))
    np.testing.assert_array_equal(st.iterations, jst.iterations)
    assert (st.total_supersteps, st.total_iterations, st.batch_size) == (
        jst.total_supersteps, jst.total_iterations, jst.batch_size)
    assert st.total_supersteps > 2
    if case != "grouped":  # the p41 lift's punctured tail leaves none
        assert not np.bitwise_count(batch.ref_bits_packed() ^ res).any()


def test_sharded_equals_decode_of_each_replica():
    """Each position decodes its dealt frames (pads at its pool's tail) as
    ``decode()`` of those frames alone does: same words and per-frame
    iterations; the loop's superstep count is the largest."""
    _, dec, jcode, sigma, dyn = _decoders("regular")
    n = B * 3 * N_DEV + 5
    batch = create_data(jcode, JaxBIAWGN(sigma), 0, n, backend="numpy")
    res, st = dec.decode_sharded(DynamicParams(**dyn), n, batch.values,
                                 batch.syndromes,
                                 M.make_batch_mesh(N_DEV, "cpu"))
    order = M.deal(n, N_DEV)
    most = 0
    for idx in order:
        real = idx[idx < n]
        r, s = dec.decode(DynamicParams(**dyn), real.size,
                          np.ascontiguousarray(batch.values[:, real]),
                          np.ascontiguousarray(batch.syndromes[:, real]))
        np.testing.assert_array_equal(res[real], r)
        np.testing.assert_array_equal(st.iterations[real], s.iterations)
        most = max(most, s.total_supersteps)
    assert st.total_supersteps == most


def test_replicas_share_tables_and_keep_their_state():
    """Two positions on one device are two replicas (their own streams and
    lane state) over this decoder's tables; they are cached."""
    _, dec, _, _, _ = _decoders("general")
    a, b = dec._replica(M.canonical_device("cpu"), 0), dec._replica(
        M.canonical_device("cpu"), 1)
    assert a is not b and a is not dec
    assert a.tables is dec.tables and b.tables is dec.tables
    assert dec._replica(torch.device("cpu"), 0) is a
    dec.set_erased_variables(0)  # new tables: the replicas go
    assert dec._replica(torch.device("cpu"), 0) is not a


def test_batch_mesh():
    """A mesh may repeat a device; its positions belong to this process;
    it refuses to be empty."""
    mesh = M.BatchMesh(("cpu", "cpu", torch.device("cpu")))
    assert mesh.size == 3
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.processes == (0, 0, 0) and mesh.local_positions() == [0, 1,
                                                                       2]
    assert M.BatchMesh(("cpu",) * 2, (0, 1)).local_positions(1) == [1]
    with pytest.raises(ValueError):
        M.BatchMesh(())
    with pytest.raises(ValueError, match="ranks"):
        M.BatchMesh(("cpu",) * 2, (0,))
    assert M.make_batch_mesh(device="cpu").size == 1


def test_make_batch_mesh_refuses_too_many_devices():
    """As the JAX function does, asking for more CUDA cards than exist
    raises; with none at all, the default mesh raises too (no CPU
    fallback)."""
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {have + 1} devices, "
                                         f"have {have}"):
        M.make_batch_mesh(have + 1)
    if have == 0:
        with pytest.raises(ValueError, match="have 0"):
            M.make_batch_mesh()


@pytest.mark.parametrize("n,n_dev", [(13, 4), (16, 4), (5, 8), (7, 1)])
def test_deal_and_reassemble(n, n_dev):
    """The round-robin deal of decoder.py:783-787 (position g takes frames
    g, g + n_dev, ...; pads at every pool's tail) and its inverse."""
    order = M.deal(n, n_dev)
    n_local = -(-n // n_dev)
    assert order.shape == (n_dev, n_local)
    np.testing.assert_array_equal(order[:, 0], np.arange(n_dev))
    np.testing.assert_array_equal(order[0], np.arange(n_local) * n_dev)
    for row in order:
        pads = row >= n
        assert not pads[:pads.argmax()].any() if pads.any() else True
    frames = np.arange(order.size) * 10
    got = M.reassemble([frames[row] for row in order], order, n)
    np.testing.assert_array_equal(got, np.arange(n) * 10)
    v, s = M.pad_frames(6, 2, 3, 2)
    np.testing.assert_array_equal(v[:, 0], [-1, -1, -1, -1, 0, 0])
    assert not s.any()


def test_sharded_rejects_a_mesh_across_processes():
    _, dec, jcode, sigma, dyn = _decoders("regular")
    batch = create_data(jcode, JaxBIAWGN(sigma), 0, 4, backend="numpy")
    with pytest.raises(ValueError, match="decode_multiprocess"):
        dec.decode_sharded(DynamicParams(**dyn), 4, batch.values,
                           batch.syndromes, M.BatchMesh(("cpu",) * 2,
                                                        (0, 1)))
