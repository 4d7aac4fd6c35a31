"""The PBRL floor programs' twins (``ldpc_tpu_torch.cli.pbrl_bc5``,
``.pbrl_lift_floor``, ``.pbrl_precode``) on the card. Run on a machine
with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

K1 against its plain version in the four regimes ``chip_smoke.py`` phase
18 drives, at small batches (256 frames at 2.8 dB, full output), in f32
and bf16, at both depths of each program's two-checkpoint schedule:
bits, success, iterations and the posteriors' bit patterns equal.

- bc=5 with ``closed_qdq``: K2's power mode (the CN ladder's closed form)
  on the QC PBRL (3096, 1032) code, T=10 and T=20 (stage 1 at T=5);
- lift 258: ``pbrl_lift_floor``'s ``k=3096`` code (24x36 base, n = 9288),
  T=10 (stage 1 at T=2);
- T=20 under the staircase quantizer (bc=4);
- the precoded code (25x37 base, n = 3182), its RCQ and pinned OMS
  decoders, on LLRs whose 86 punctured positions were multiplied by zero
  as the simulator's mask does (the negative ones -0.0).

Then a precoded compacting wave (4096 frames at 2.6 dB, budget 512)
counts the same through the kernels as through the plain versions, and
every batch it hands K1, the gathered survivors included, is zero at the
punctured positions."""

import dataclasses

import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import pbrl_bc5 as bc5
from ldpc_tpu_torch.cli import pbrl_lift_floor as lf
from ldpc_tpu_torch.cli import pbrl_precode as pc
from ldpc_tpu_torch.decode import fused
from ldpc_tpu_torch.decode.engine import qdq_mode
from ldpc_tpu_torch.sim.montecarlo import _CompactingWave
from test_bench_programs_cuda import _plain_decode

pytestmark = pytest.mark.cuda

# name -> (decoder maker, stage 1's iterations, punctured positions)
REGIMES = ("RCQ-bc5-T10", "RCQ-bc5-T20", "RCQ-bc4-T20", "lift258_n9288",
           "precoded-bc4-T10", "precoded-oms6-T10")


@pytest.fixture(scope="module")
def decoders():
    """{name: (decoder, t1, punctured positions or None)}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    a = bc5.decoders("cuda")
    out = {k: (a[k], bc5.T1, None) for k in REGIMES[:3]}
    out["lift258_n9288"] = (lf.decoders("cuda")["lift258_n9288"], lf.T1,
                            None)
    for name, dec, punct in pc.arms("cuda")[1:]:
        out[name] = (dec, pc.T1, punct)
    return out


def _llr(n, B, snr, seed, punct=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = lt.awgn_llr(gen, torch.zeros((B, n), device="cuda"), snr)
    return x if punct is None else lt.puncture_llr(x, punct)


def test_the_regimes_are_the_programs():
    """bc=5's CN ladder takes the power mode, bc=4's the staircase; the
    lift-258 code is n = 9288; the precoded code punctures 86 bits and its
    OMS tables are the constants."""
    a = bc5.decoders("cpu")
    for name, mode in (("RCQ-bc5-T20", "power"),
                       ("RCQ-bc4-T20", "staircase")):
        d = a[name]
        assert qdq_mode(d.spec.qparams, d.spec.q_levels,
                        d.qc_options["closed_qdq"]) == mode
    assert lf.decoders("cpu")["lift258_n9288"].code.n == 9288
    (_, oms, punct), = pc.arms("cpu")[2:]
    assert oms.code.n == 3182 and punct == tuple(range(86))
    assert torch.all(oms.weights["beta"] == 0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("stage", ["stage 1", "whole"])
@pytest.mark.parametrize("name", REGIMES)
def test_k1_equals_plain(decoders, name, stage, dtype):
    dec, t1, punct = decoders[name]
    T = t1 if stage == "stage 1" else dec.max_iterations
    d = dec if T == dec.max_iterations else dataclasses.replace(
        dataclasses.replace(dec, qc_options=None).truncated(T),
        qc_options=dec.qc_options)
    llr = _llr(dec.code.n, 256, 2.8, 18, punct).to(dtype)
    if punct is not None:
        assert torch.signbit(llr[:, list(punct)]).any()
    args = dict(qc=d.qc, spec=d.spec, max_iterations=T, dtype=dtype,
                lean=False, closed_qdq=bool(d.qc_options.get("closed_qdq")))
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


@pytest.mark.parametrize("name", ["precoded-bc4-T10", "precoded-oms6-T10"])
def test_precoded_compacting_wave_equals_plain(decoders, name,
                                               monkeypatch):
    """4096 frames at 2.6 dB, budget 512: the wave's counts, survivors and
    bits are the same through the kernels and the plain versions, and
    every batch reaching K1 is zero at the punctured positions."""
    dec, t1, punct = decoders[name]
    wave = _CompactingWave(dec, 4096, torch.device("cuda"), t1, 512,
                           punctured=punct)
    llr = wave.llr(torch.Generator(device="cuda").manual_seed(26), 2.6)
    seen = []
    real = fused._launch

    def spy(flooding, x, *args):
        seen.append(int((x[:, list(punct)] != 0).sum()))
        return real(flooding, x, *args)

    monkeypatch.setattr(fused, "_launch", spy)
    got = wave.counts(llr)
    kinds = dict(wave.kinds)
    out, n_surv = wave.compacted(llr, dec.weights)
    assert len(seen) in (4, 6) and set(seen) == {0}
    monkeypatch.setattr(fused, "_decode", _plain_decode)
    plain = _CompactingWave(dec, 4096, torch.device("cuda"), t1, 512,
                            punctured=punct)
    want = plain.counts(llr)
    out2, n2 = plain.compacted(llr, dec.weights)
    assert got == want and int(n_surv) == int(n2)
    assert torch.equal(out.bits, out2.bits)
    assert kinds == dict(plain.kinds)
