"""The bench-knob and short-schedule programs' twins
(``ldpc_tpu_torch.cli.bench_ab_s``, ``.ee_trained``, ``.bench_dde``,
``.train_layered_short``) on the card. Run on a machine with an NVIDIA
GPU:

    python -m pytest tests_gpu -m cuda -q

K1 at every spec, iteration count and batch ``chip_smoke.py`` phase 16
launches: the bench wave's stage 1 (B=32768) and stage 2 at S = 512, 256
and 128; ee_trained's survey (stage 1 at t1 = 2 and 3 and stage 2 on
8192 rows) for its three decoders and every arm's stages (S=1024 and 128
at B=8192, the plain decoder's t1=3 at B=16384 and S=256), lean;
bench_dde's stage 1 and whole decode on a wave of 32768 and stage 2 at
the budget B=4096 for RCQ-dde-L6 and the zoo's W-ORCQ-dde-L6;
train_layered_short's RCQ-L6, RCQ-L5, the zoo's T=5 and T=4 tables and
per-layer [T, 5] tables (the port's initial weights, which differ from
row to row) whole on a wave of 16384, full: bits, success, iterations
and the posteriors' bit patterns equal to the plain version's in f32 and
bf16, on frames at 6.5 dB. Then the bench wave at B=32768 gives the same
bits under S = 512, 256 and 128, and one bench_dde compacting wave (32768
frames at 6.6 dB, budget 4096) counts the same through the kernels as
through the plain versions on the card."""

import dataclasses

import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import bench, bench_ab_s, bench_dde, deep_fer
from ldpc_tpu_torch.cli import ee_trained as ee
from ldpc_tpu_torch.cli import train_layered_short as short
from ldpc_tpu_torch.decode import fused
from ldpc_tpu_torch.sim.montecarlo import _CompactingWave

pytestmark = pytest.mark.cuda

# (spec, iterations, batch, lean)
SPECS = {
    f"bench t1=3 B={bench.B}": ("dde", bench.T1, bench.B, True),
    **{f"bench S={S}": ("dde", bench.T, S, True)
       for S in bench_ab_s.BUDGETS},
    **{f"{key} T={t} B={B}": (key, t, B, True)
       for key in ("plain", "trained", "dde")
       for t, B in ((2, ee.B), (3, ee.B), (6, ee.SURVEY_BUDGET))},
    "trained S=1024": ("trained", 6, 1024, True),
    "dde S=1024": ("dde", 6, 1024, True),
    **{f"{key} S=128": (key, 6, 128, True)
       for key in ("plain", "trained", "dde")},
    f"plain t1=3 B={ee.B_BIG}": ("plain", 3, ee.B_BIG, True),
    "plain S=256": ("plain", 6, 256, True),
    **{f"{key} T={t} B={B}": (key, t, B, False)
       for key in ("RCQ-dde-L6", "W-ORCQ-dde-L6")
       for t, B in ((bench_dde.T1, bench_dde.WAVE),
                    (bench_dde.T, bench_dde.BUDGET),
                    (bench_dde.T, bench_dde.WAVE))},
    **{key: (key, T, short.WAVE, False)
       for key, T in (("RCQ-L6", 6), ("RCQ-L5", 5), ("zoo t5", 5),
                      ("zoo t4", 4), ("per-layer t5", 5),
                      ("per-layer t4", 4))},
}


@pytest.fixture(scope="module")
def decoders():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    out = ee.decoders("cuda")
    out["RCQ-dde-L6"] = bench_dde.make("rcq", "cuda")
    out["RCQ-L6"] = short.make(6, "rcq", "cuda")
    out["RCQ-L5"] = short.make(5, "rcq", "cuda")
    out["W-ORCQ-dde-L6"] = lt.load_pretrained(
        bench_dde.ZOO_ENTRY, qc_options=dict(deep_fer.FUSED), device="cuda")
    for T in (5, 4):
        out[f"zoo t{T}"] = lt.load_pretrained(
            f"worcq_bc3_layered_t{T}", qc_options=dict(deep_fer.FUSED),
            device="cuda")
        out[f"per-layer t{T}"] = short.make(T, "orcq", device="cuda",
                                            per_layer=True)
    return out


def _llr(n, B, snr, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return lt.awgn_llr(gen, torch.zeros((B, n), device="cuda"), snr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_k1_equals_plain_at_the_phase_16_specs(decoders, spec, dtype):
    key, T, B, lean = SPECS[spec]
    dec = decoders[key]
    if key.startswith("per-layer"):
        w = dec.weights["beta"]
        assert w.shape == (T, 5) and not torch.equal(w[:, 0], w[:, 1])
    llr = _llr(dec.code.n, B, 6.5, seed=16).to(dtype)
    d = dec if T == dec.max_iterations else dataclasses.replace(
        dec, qc_options=None).truncated(T)
    args = dict(qc=d.qc, spec=d.spec, max_iterations=T, dtype=dtype,
                lean=lean)
    before = fused.LAYERED_LAUNCHES
    out = fused.qc_fused_decode_batch_layered(llr, d.weights, **args)
    ref = fused._fused_layered_plain(llr, d.weights, **args)
    torch.cuda.synchronize()
    assert fused.LAYERED_LAUNCHES == before + 1
    assert torch.equal(out.bits, ref.bits)
    assert torch.equal(out.success, ref.success)
    assert torch.equal(out.iterations, ref.iterations)
    if not lean:
        nan = torch.isnan(ref.posterior)
        assert torch.equal(torch.isnan(out.posterior), nan)
        ints = {torch.float32: torch.int32,
                torch.bfloat16: torch.int16}[dtype]
        assert torch.equal(out.posterior[~nan].view(ints),
                           ref.posterior[~nan].view(ints))


def test_bench_wave_bits_do_not_depend_on_the_budget(decoders):
    """The bench decoder at B=32768, 7.0 dB: every budget holds the
    survivors and gives the same bits."""
    dec = decoders["dde"]
    llr = _llr(dec.code.n, bench.B, bench.SNR_DB, seed=0)
    outs = {S: fn(llr) for S, fn in bench_ab_s.budget_decoders(dec).items()}
    bits = outs[512][0].bits
    for S, (out, n) in outs.items():
        assert 0 < int(n) <= S and torch.equal(out.bits, bits)


def test_bench_dde_compacting_wave_counts_equal_plain(decoders,
                                                      monkeypatch):
    """RCQ-dde-L6 at 6.6 dB, 32768 frames, budget 4096: the wave is
    compacted and counts the same through the kernels and the plain
    versions."""
    dec = decoders["RCQ-dde-L6"]
    llr = _llr(dec.code.n, bench_dde.WAVE, 6.6, seed=66)
    wave = _CompactingWave(dec, bench_dde.WAVE, torch.device("cuda"),
                           bench_dde.T1, bench_dde.BUDGET)
    before = fused.LAYERED_LAUNCHES
    got = wave.counts(llr)
    out, n_surv = wave.compacted(llr, dec.weights)
    assert fused.LAYERED_LAUNCHES == before + 4
    assert 0 < int(n_surv) <= bench_dde.BUDGET
    monkeypatch.setattr(fused, "_decode", _plain_decode)
    plain = _CompactingWave(dec, bench_dde.WAVE, torch.device("cuda"),
                            bench_dde.T1, bench_dde.BUDGET)
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
