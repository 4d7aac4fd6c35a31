"""The W-RCQ training and rate-specific programs' twins
(``ldpc_tpu_torch.cli.train_wrcq``, ``.rate_specific``,
``.train_wrcq_qc9472``, ``.rate_specific_deep``) on the card. Run on a
machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

K1 at every spec, iteration count and batch ``chip_smoke.py`` phase 17
launches on the QC PBRL (3096, 1032) code (lift 86, layered T=10, full
output): OMS-6bit (beta = 0.5, alpha = 0 in every bucket), W-NMS-RCQ on
the port's initial tables and W-OMS-RCQ on tables drawn around the OMS
constants (both vary across each row, so every row takes K1's per-block
route), each at stage 1 (T=3, B=32768), stage 2 (T=10, B=4096) and the
fallback's whole decode (T=10, B=32768): bits, success, iterations and
the posteriors' bit patterns equal to the plain version's in f32 and
bf16, on frames at 3.2 dB. Then one OMS-6bit compacting wave (32768
frames at 2.8 dB, budget 4096) counts the same through the kernels as
through the plain versions on the card, and one training step of
W-NMS-RCQ (B=16, the engines in f32) on the card matches the same step on
a CPU copy to float tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import rate_specific_deep as rsd
from ldpc_tpu_torch.decode import fused
from ldpc_tpu_torch.sim.montecarlo import _CompactingWave
from test_bench_programs_cuda import _plain_decode

pytestmark = pytest.mark.cuda

NMS, OMS_RCQ = (name for _, name in rsd.CANDIDATES)
# (iterations, batch) of each K1 launch of the campaign
SHAPES = {"stage 1": (rsd.T1, rsd.WAVE), "stage 2": (rsd.T, rsd.BUDGET),
          "fallback": (rsd.T, rsd.WAVE)}


@pytest.fixture(scope="module")
def decoders():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    decs = rsd.decoders("cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    w = decs[OMS_RCQ].weights
    decs[OMS_RCQ] = decs[OMS_RCQ].replace_weights({
        k: v + 0.05 * torch.randn(v.shape, generator=gen, device="cuda")
        for k, v in w.items()})
    return decs


def _llr(n, B, snr, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return lt.awgn_llr(gen, torch.zeros((B, n), device="cuda"), snr)


def test_tables_vary_across_rows(decoders):
    """OMS-6bit shares (beta, alpha) on every row; the two RCQ decoders'
    ``[10, 2]`` and ``[10, 7]`` tables differ from bucket to bucket."""
    oms = decoders[rsd.OMS].weights
    assert torch.all(oms["beta"] == 0.5) and torch.all(oms["alpha"] == 0)
    for name in (NMS, OMS_RCQ):
        w = decoders[name].weights
        assert w["beta"].shape == (10, 2) and w["alpha"].shape == (10, 7)
        assert not torch.equal(w["alpha"][:, 0], w["alpha"][:, 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", [rsd.OMS, NMS, OMS_RCQ])
def test_k1_equals_plain_at_the_phase_17_specs(decoders, name, shape,
                                                dtype):
    T, B = SHAPES[shape]
    dec = decoders[name]
    llr = _llr(dec.code.n, B, 3.2, seed=17).to(dtype)
    d = dec if T == dec.max_iterations else dataclasses.replace(
        dec, qc_options=None).truncated(T)
    args = dict(qc=d.qc, spec=d.spec, max_iterations=T, dtype=dtype,
                lean=False)
    before = fused.LAYERED_LAUNCHES
    out = fused.qc_fused_decode_batch_layered(llr, d.weights, **args)
    ref = fused._fused_layered_plain(llr, d.weights, **args)
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


def test_compacting_wave_counts_equal_plain(decoders, monkeypatch):
    """OMS-6bit at 2.8 dB, 32768 frames, budget 4096: the wave's counts,
    survivors and bits are the same through the kernels and the plain
    versions."""
    dec = decoders[rsd.OMS]
    llr = _llr(dec.code.n, rsd.WAVE, 2.8, seed=28)
    wave = _CompactingWave(dec, rsd.WAVE, torch.device("cuda"), rsd.T1,
                           rsd.BUDGET)
    before = fused.LAYERED_LAUNCHES
    got = wave.counts(llr)
    kinds = dict(wave.kinds)
    out, n_surv = wave.compacted(llr, dec.weights)
    assert fused.LAYERED_LAUNCHES - before in (4, 6)
    monkeypatch.setattr(fused, "_decode", _plain_decode)
    plain = _CompactingWave(dec, rsd.WAVE, torch.device("cuda"), rsd.T1,
                            rsd.BUDGET)
    launches = fused.LAYERED_LAUNCHES
    want = plain.counts(llr)
    out2, n2 = plain.compacted(llr, dec.weights)
    assert fused.LAYERED_LAUNCHES == launches
    assert got == want and int(n_surv) == int(n2)
    assert torch.equal(out.bits, out2.bits)
    assert kinds == dict(plain.kinds)


def test_training_step_card_equals_cpu(decoders):
    """One step of W-NMS-RCQ on the PBRL code (B=16 at 3.3 dB, the
    program's learning rate): loss, accuracy and gradient norm, and the
    updated tables, on the card and on a CPU copy."""
    dec = decoders[NMS].replace_weights(decoders[NMS].weights)
    cfg = dataclasses.replace(rsd.training_config(1), batch_size=16)
    cpu = dec.to("cpu")
    trainers = [lt.PosteriorJointTrainer(d, cfg) for d in (dec, cpu)]
    gen = torch.Generator().manual_seed(33)
    llr = lt.awgn_llr(gen, torch.zeros((16, dec.code.n)), 3.3)
    stats = [tr.train_step(llr.to(tr.device),
                           torch.zeros_like(llr).to(tr.device))
             for tr in trainers]
    (l1, a1, g1), (l0, a0, g0) = stats
    np.testing.assert_allclose(float(l1), float(l0), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(float(a1), float(a0), rtol=1e-6)
    np.testing.assert_allclose(float(g1), float(g0), rtol=1e-4)
    for k, w in trainers[0].decoder.weights.items():
        np.testing.assert_allclose(w.cpu().numpy(),
                                   trainers[1].decoder.weights[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        assert w.device.type == "cuda" and not w.requires_grad
