from ldpc_tpu_torch.decode.engine import (
    DecodeResult,
    VariantSpec,
    decode_batch,
    decode_batch_layered,
    make_layers,
)
from ldpc_tpu_torch.decode.bucketed_engine import (
    BucketedGraph,
    bucketed_decode_batch,
    build_bucketed_graph,
)
from ldpc_tpu_torch.decode.variants import (
    Decoder,
    basic_min_sum,
    make_decoder,
    neural_2d_min_sum,
    neural_2d_offset_min_sum,
    neural_min_sum,
    neural_offset_min_sum,
    param_count,
    rcq_min_sum,
    weighted_oms_rcq,
    weighted_rcq,
)
from ldpc_tpu_torch.decode.qc_engine import (
    QCGraph,
    build_qc_graph,
    qc_decode_batch,
    qc_decode_batch_layered,
)
from ldpc_tpu_torch.decode.qc_rowcol import qc_pallas_decode_batch
from ldpc_tpu_torch.decode.fused import (
    qc_fused_decode_batch,
    qc_fused_decode_batch_layered,
)
from ldpc_tpu_torch.decode.early_exit import (
    make_two_checkpoint_decoder,
    two_checkpoint_stages,
)
