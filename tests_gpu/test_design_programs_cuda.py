"""The bench-code design studies' twins (``ldpc_tpu_torch.cli.ladder_bc4``,
``.bc4_refine``, ``.quantizer_count``, ``.dde_ladders``) on the card. Run
on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

K1 against its plain version at the shapes ``chip_smoke.py`` phase 19
drives, at 256 frames, in f32 and bf16, at both depths of each program's
two-checkpoint schedule (or its whole decode): bits, success, iterations
and the posteriors' bit patterns equal.

- the two-pair ladders: ``rcq-q2`` (bc=3, T=6: pair 1 at iterations 0-1,
  pair 2 at 2-5) on the bench code and ``p2`` (bc=4, T=10: 0-2 and 3-9) on
  the precoded PBRL code;
- the mixed-gamma bc=4 ladder of ``bc4_refine``'s ``bc4`` arm (gamma 2.2,
  2.2, 1.5), lean as the program runs it;
- lift 43 on the precoded 49x73 base (n = 3139), ``p2`` and ``p3``, on
  LLRs whose 43 punctured positions were multiplied by zero as the
  simulator's mask does (the negative ones -0.0);
- the full against the lean instance on a pair that differs only in the
  V2C ladder (``dde_ladders``' bc4_dde and bc4_dde_cn_only with the
  hand V2C ladder 4-8-12 and the designed 40.9-31.6-33.2): equal bits,
  success and iterations across all four."""

import dataclasses

import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import bc4_refine as br
from ldpc_tpu_torch.cli import dde_ladders as dl
from ldpc_tpu_torch.cli import quantizer_count as qcn
from ldpc_tpu_torch.decode import fused

pytestmark = pytest.mark.cuda

# name -> (stage 1's iterations, SNR of the check LLRs)
REGIMES = {"rcq-q2": (3, 6.4), "bc4": (3, 6.4), "p2": (5, 2.0),
           "p3": (5, 2.0)}
# the designed bc=4 ladders of chip_smoke.P19_DESIGN_BC4
DDE_BC4 = (((6.9657, 1.3), (4.8879, 1.3), (8.4285, 1.3)),
           ((40.9447, 1.0), (31.6042, 1.0), (33.1652, 1.0)))


@pytest.fixture(scope="module")
def decoders():
    """{name: (decoder, punctured positions or None)}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    out = {"rcq-q2": (qcn._mk("rcq-q2", "cuda")[0], None),
           "bc4": (br._mk("bc4", "cuda")[0], None)}
    for arm in ("p2", "p3"):
        out[arm] = qcn._mk13(arm, "cuda")
    return out


def _llr(n, B, snr, seed, punct=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = lt.awgn_llr(gen, torch.zeros((B, n), device="cuda"), snr)
    return x if punct is None else lt.puncture_llr(x, punct)


def _held(out, ref, dtype, lean):
    assert torch.equal(out.bits, ref.bits)
    assert torch.equal(out.success, ref.success)
    assert torch.equal(out.iterations, ref.iterations)
    if lean:
        return
    nan = torch.isnan(ref.posterior)
    assert torch.equal(torch.isnan(out.posterior), nan)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dtype]
    assert torch.equal(out.posterior[~nan].view(ints),
                       ref.posterior[~nan].view(ints))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("stage", ["stage 1", "whole"])
@pytest.mark.parametrize("name", list(REGIMES))
def test_k1_equals_plain(decoders, name, stage, dtype):
    dec, punct = decoders[name]
    t1, snr = REGIMES[name]
    T = t1 if stage == "stage 1" else dec.max_iterations
    d = dec if T == dec.max_iterations else dataclasses.replace(
        dataclasses.replace(dec, qc_options=None).truncated(T),
        qc_options=dec.qc_options)
    llr = _llr(dec.code.n, 256, snr, 19, punct).to(dtype)
    if punct is not None:
        assert dec.qc.lift == 43 and (dec.qc.mb, dec.qc.nb) == (49, 73)
        assert torch.signbit(llr[:, list(punct)]).any()
    lean = bool(dec.qc_options.get("lean"))
    args = dict(qc=d.qc, spec=d.spec, max_iterations=T, dtype=dtype,
                lean=lean)
    before = fused.LAYERED_LAUNCHES
    out = fused.qc_fused_decode_batch_layered(llr, d.weights, **args)
    ref = fused._fused_layered_plain(llr, d.weights, **args)
    torch.cuda.synchronize()
    assert fused.LAYERED_LAUNCHES == before + 1
    _held(out, ref, dtype, lean)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_full_and_lean_on_a_v2c_only_pair(dtype):
    """K1 full and lean on bc4_dde and bc4_dde_cn_only: each held to its
    plain version, and all four equal in bits, success and iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    arms = dl.arms({3: DDE_BC4, 4: DDE_BC4}, {3: DDE_BC4, 4: DDE_BC4},
                   device="cuda")
    a, b = arms["bc4_dde"], arms["bc4_dde_cn_only"]
    assert torch.equal(torch.as_tensor(a.spec.qparams),
                       torch.as_tensor(b.spec.qparams))
    llr = _llr(a.code.n, 256, 6.4, 191).to(dtype)
    outs = []
    for d in (a, b):
        for lean in (False, True):
            args = dict(qc=d.qc, spec=d.spec, max_iterations=6,
                        dtype=dtype, lean=lean)
            out = fused.qc_fused_decode_batch_layered(llr, d.weights, **args)
            _held(out, fused._fused_layered_plain(llr, d.weights, **args),
                  dtype, lean)
            outs.append(out)
    for o in outs[1:]:
        assert torch.equal(o.bits.to(torch.int8), outs[0].bits.to(
            torch.int8))
        assert torch.equal(o.success, outs[0].success)
        assert torch.equal(o.iterations, outs[0].iterations)
