"""The throughput programs' twins (``ldpc_tpu_torch.cli.bench``,
``.throughput_matrix``, ``.ee_batch``) on the card: K1 at the matrix's
new shapes held to its plain version, and the bench twin's last line.
Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

The fused entries of the matrix that only the matrix runs on the card:
the DVB-S2-structure (16200, 7200) protograph (lift 360, B=4096), Tanner
(155, 64) (lift 31: 31 threads a CTA, B=16384) and the QC PBRL (3096,
1032) (lift 86, T=10, B=8192). For each, the first 64 frames of the
entry's own LLRs go through the kernel and the plain version, bit for bit
(bits, success, posteriors) in f32 and bf16."""

import json

import pytest
import torch

from ldpc_tpu_torch.cli import bench, throughput_matrix as tm
from ldpc_tpu_torch.decode import _build, fused
from ldpc_tpu_torch.decode.engine import qdq_mode

pytestmark = pytest.mark.cuda

ENTRIES = ["dvbs2_16200_layered6_fused", "tanner155_layered6_fused",
           "pbrl3096_qc_layered10_fused"]


@pytest.fixture(scope="module")
def decoders():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return tm.matrix_decoders("cuda")


def _onchip(dec, dtype):
    """Whether the wrapper keeps K1's check state in shared memory for
    ``dec`` in ``dtype`` on this card."""
    qc, spec = dec.qc, dec.spec
    sizes = (qc.nb, qc.mb, qc.num_blocks, qc.lift,
             max(len(r) for r in qc.row_blocks), int(dtype == torch.bfloat16),
             fused._QMODES[qdq_mode(spec.qparams, spec.q_levels)],
             spec.q_levels,
             fused._QMODES[qdq_mode(spec.v2c_qparams, spec.v2c_levels)],
             spec.v2c_levels)
    return _build.load_library().ldpc_fused_layered_smem(*sizes, 1) <= \
        torch.cuda.get_device_properties(0).shared_memory_per_block_optin


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ENTRIES)
def test_matrix_entry_kernel_equals_plain(decoders, name, dtype):
    dec, B, snr = decoders[name]
    if name.startswith("dvbs2"):
        # f32 keeps the check state in the device scratch, bf16 on chip
        assert _onchip(dec, dtype) == (dtype == torch.bfloat16)
    llr = tm.make_llr(dec, B, snr)[:64].to(dtype)
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=dec.max_iterations,
                dtype=dtype)
    before = fused.LAYERED_LAUNCHES
    out = fused.qc_fused_decode_batch_layered(llr, dec.weights, **args)
    ref = fused._fused_layered_plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    assert fused.LAYERED_LAUNCHES == before + 1
    assert torch.equal(out.bits, ref.bits)
    assert torch.equal(out.success, ref.success)
    assert torch.equal(out.iterations, ref.iterations)
    nan = torch.isnan(ref.posterior)
    assert torch.equal(torch.isnan(out.posterior), nan)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dtype]
    assert torch.equal(out.posterior[~nan].view(ints),
                       ref.posterior[~nan].view(ints))


def test_bench_line_parses(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    bench.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    line, stats = json.loads(lines[-1]), json.loads(lines[-2])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == bench.METRIC and line["unit"] == bench.UNIT
    assert line["value"] > 0
    assert stats["max_survivors"] <= bench.S
    assert len(stats["trial_cw_per_sec"]) == bench.TRIALS
