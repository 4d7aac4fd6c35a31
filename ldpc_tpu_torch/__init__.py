"""ldpc_tpu_torch — the PyTorch/CUDA port of ``ldpc_tpu`` for NVIDIA Hopper.

It imports torch and numpy and never jax; module names follow the JAX
package so each counterpart is easy to find. Ported so far: the code model,
the RCQ quantizers, the decoder registry, the AWGN channel, the systematic
encoder, the fused layered and flooding decodes (hand-written CUDA
kernels, each with a plain PyTorch version for CPU tensors), the QC
engines and the general, layered and degree-bucketed engines for any code
as torch ops, the flooding QC decode through one kernel per base row and
column, the two-checkpoint early exit, the pretrained-decoder zoo, the
Monte-Carlo simulator and importance-sampled error floors (``sim``),
training (the straight-through quantizers, autograd through every engine,
the posterior-joint trainer, the gradient analyzer), the design tools
(density evolution, ladder design, trapping sets: ``design``), reports and
plots (``report``), checkpoints and profiling (``utils``). Decoders,
simulations and trainers run on the card unless given ``device="cpu"``.
What is still to come (``parallel/`` and the root scripts) is listed in
ROADMAP.md.
"""

from ldpc_tpu_torch.codes import (
    DecoderGraph,
    LDPCCode,
    build_graph,
    create_array_code,
    create_dvbs2_like_code,
    create_dvbs2_qc_protograph,
    create_pbrl_family,
    create_pbrl_like_code,
    create_pbrl_qc_protograph,
    create_peg_code,
    create_qc_code,
    create_random_regular_code,
    create_tanner_155,
    create_test_ldpc_code,
    gf2_rank,
    load_alist,
    load_protograph,
    save_alist,
    save_protograph,
    tanner_155_base,
)
from ldpc_tpu_torch.channel import (awgn_llr, bpsk_modulate, puncture_llr,
                                    simulate_awgn_channel)
from ldpc_tpu_torch.encode import Encoder, make_encoder
from ldpc_tpu_torch.quantizer import (
    NonUniformQuantizer,
    dequantize,
    phase_schedule,
    power_qdq,
    power_qdq_ste,
    power_thresholds,
    qdq_ste,
    quantize,
    quantize_dequantize,
    staircase_qdq,
    staircase_qdq_ste,
    uniform_qdq,
    uniform_qdq_ste,
)
from ldpc_tpu_torch.decode import (
    BucketedGraph,
    DecodeResult,
    Decoder,
    QCGraph,
    basic_min_sum,
    bucketed_decode_batch,
    build_bucketed_graph,
    build_qc_graph,
    decode_batch,
    decode_batch_layered,
    make_decoder,
    make_two_checkpoint_decoder,
    neural_2d_min_sum,
    neural_2d_offset_min_sum,
    neural_min_sum,
    neural_offset_min_sum,
    param_count,
    qc_decode_batch,
    qc_decode_batch_layered,
    qc_fused_decode_batch,
    qc_fused_decode_batch_layered,
    qc_pallas_decode_batch,
    rcq_min_sum,
    weighted_oms_rcq,
    weighted_rcq,
)
from ldpc_tpu_torch.interop import weights_from_numpy
from ldpc_tpu_torch.sim import (
    LDPCSimulator,
    SimulationConfig,
    SimulationResult,
    create_test_decoders,
    simulate_single_snr,
)
from ldpc_tpu_torch.train import (
    GradientExplosionAnalyzer,
    PosteriorJointTrainer,
    TrainingConfig,
    posterior_joint_loss,
)
from ldpc_tpu_torch.zoo import list_pretrained, load_pretrained, save_pretrained

__version__ = "0.1.0"
