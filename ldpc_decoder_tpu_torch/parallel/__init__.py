"""Multi-device decoding: frame-batch meshes (:mod:`.mesh`) and decodes
across processes on ``torch.distributed`` (:mod:`.multiprocess`). The
single-process sharded decode is
:meth:`ldpc_decoder_tpu_torch.runtime.decoder.LDPCDecoder.decode_sharded`."""

from ldpc_decoder_tpu_torch.parallel.mesh import (
    BatchMesh,
    deal,
    make_batch_mesh,
    reassemble,
)

__all__ = ["BatchMesh", "deal", "make_batch_mesh", "reassemble"]
