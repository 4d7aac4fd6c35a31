"""The FER campaign programs' twins (``ldpc_tpu_torch.cli.deep_fer``,
``.deep_fer_trained_l6``) on the card. Run on a machine with an NVIDIA
GPU:

    python -m pytest tests_gpu -m cuda -q

K1 at the four layered T=6 specs of the campaigns (RCQ bc=3, RCQ bc=4 and
float min-sum from ``deep_fer``, the trained W-OMS-RCQ from
``deep_fer_trained_l6``) and K4 at the trained flooding T=10 spec, each at
both depths of its two-checkpoint compaction, on 64 frames at 6.5 dB:
bits, success, iterations and the posteriors' bit patterns equal to the
plain version's in f32 and bf16. Then one compacting wave of the campaign
(32768 frames, budget 2048) counts the same frame errors, bit errors,
iterations, successes and survivors through the kernels as through the
plain versions on the card."""

import dataclasses

import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import deep_fer
from ldpc_tpu_torch.cli import deep_fer_trained_l6 as l6
from ldpc_tpu_torch.decode import fused
from ldpc_tpu_torch.sim.montecarlo import _CompactingWave

pytestmark = pytest.mark.cuda

SPECS = ["RCQ-bc3-L6", "RCQ-bc4-L6", "float-MS-L6", l6.NAME,
         "W-OMS-RCQ-bc3-trained"]
WAVE, BUDGET = 32768, 2048


@pytest.fixture(scope="module")
def decoders():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    out = {name: (dec, deep_fer.T1_LAYERED) for name, dec in
           deep_fer.layered_decoders(256, "cuda").items()}
    out[l6.NAME] = (l6.trained_layered_decoder(device="cuda"), l6.T1)
    out["W-OMS-RCQ-bc3-trained"] = (deep_fer.trained_flooding_decoder(
        device="cuda"), deep_fer.T1_FLOODING)
    return out


def _llr(n, B, snr, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return lt.awgn_llr(gen, torch.zeros((B, n), device="cuda"), snr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("stage", ["t1", "T"])
@pytest.mark.parametrize("name", SPECS)
def test_campaign_kernel_equals_plain(decoders, name, stage, dtype):
    dec, t1 = decoders[name]
    if stage == "t1":
        dec = dataclasses.replace(dec, qc_options=None).truncated(t1)
    flooding = not dec.layered
    llr = _llr(dec.code.n, 64, 6.5, seed=11).to(dtype)
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=dec.max_iterations,
                dtype=dtype)
    kernel = (fused.qc_fused_decode_batch if flooding
              else fused.qc_fused_decode_batch_layered)
    plain = (fused._fused_flooding_plain if flooding
             else fused._fused_layered_plain)
    before = (fused.FLOODING_LAUNCHES, fused.LAYERED_LAUNCHES)
    out = kernel(llr, dec.weights, **args)
    ref = plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    assert (fused.FLOODING_LAUNCHES, fused.LAYERED_LAUNCHES) == (
        before[0] + flooding, before[1] + (not flooding))
    assert torch.equal(out.bits, ref.bits)
    assert torch.equal(out.success, ref.success)
    assert torch.equal(out.iterations, ref.iterations)
    nan = torch.isnan(ref.posterior)
    assert torch.equal(torch.isnan(out.posterior), nan)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dtype]
    assert torch.equal(out.posterior[~nan].view(ints),
                       ref.posterior[~nan].view(ints))


def test_compacting_wave_counts_equal_plain(decoders, monkeypatch):
    """RCQ-bc3-L6 at 6.6 dB, where about 5% of the frames survive stage 1
    and the wave is compacted."""
    dec, t1 = decoders["RCQ-bc3-L6"]
    llr = _llr(dec.code.n, WAVE, 6.6, seed=66)
    wave = _CompactingWave(dec, WAVE, torch.device("cuda"), t1, BUDGET)
    before = fused.LAYERED_LAUNCHES
    got = wave.counts(llr)
    out, n_surv = wave.compacted(llr, dec.weights)
    assert fused.LAYERED_LAUNCHES == before + 4
    assert 0 < int(n_surv) <= BUDGET
    monkeypatch.setattr(fused, "_decode", _plain_decode)
    plain = _CompactingWave(dec, WAVE, torch.device("cuda"), t1, BUDGET)
    launches = fused.LAYERED_LAUNCHES
    want = plain.counts(llr)
    out2, n2 = plain.compacted(llr, dec.weights)
    assert fused.LAYERED_LAUNCHES == launches
    assert got == want and int(n_surv) == int(n2)
    assert torch.equal(out.bits, out2.bits)
    assert dict(wave.kinds) == dict(plain.kinds) == {"compacted": 1}


def _plain_decode(flooding, llr, weights, qc, spec, max_iterations, dtype,
                  lean, closed_qdq, tpu_keys):
    """The wrappers' CPU branch on a CUDA tensor: the plain versions."""
    plain = (fused._fused_flooding_plain if flooding
             else fused._fused_layered_plain)
    return plain(llr, weights, qc=qc, spec=spec,
                 max_iterations=max_iterations, dtype=dtype, lean=lean,
                 closed_qdq=closed_qdq, **tpu_keys)
