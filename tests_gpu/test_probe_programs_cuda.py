"""The PBRL V2C/CN probe twins (``ldpc_tpu_torch.cli.pbrl_bv10``,
``.pbrl_cn_probe``, ``.pbrl_vqp_sweep``, ``.pbrl_vqp_gamma``) on the card.
Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

K1 against its plain version at 256 frames, in f32 and bf16, at both
depths of the programs' {5, 10} schedule, on the precoded PBRL code
(k=1032, rate 1/3, 25x37 base at lift 86, n = 3182) with the 86 LLRs of
base column 0 multiplied by zero as the simulator's mask does: bits,
success, iterations and the posteriors' bit patterns equal, for every arm
of the four programs. They put on K1 V2C quantizers no other program
launches (uniform at bv=10 and 12, M = 511 and 2047, in K2's closed form;
power laws at gamma 1.5 and 2.0, K2's 128-entry level table) and bc=5's
closed form with CN_REF3 on the precoded code. Then the identity the
probes rest on, through K1 on the same LLRs in both types: only the
posterior passes through the V2C quantizer, so the bc=4 arms on CN_REF3
decode as ``pbrl_wrcq``'s ``rcq-ref3`` and ``bc5_vr96`` as ``bc5_bv10``
(bits, success and iterations)."""

import dataclasses
import importlib

import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import pbrl_wrcq as pw
from ldpc_tpu_torch.decode import fused

pytestmark = pytest.mark.cuda

SNR = 2.0
PROGRAMS = ("pbrl_bv10", "pbrl_cn_probe", "pbrl_vqp_sweep", "pbrl_vqp_gamma")
ARMS = ("pbrl_bv10/bc4_bv10", "pbrl_bv10/bc4_bv12", "pbrl_bv10/bc5_bv10",
        "pbrl_cn_probe/cn_8.5-16-16", "pbrl_cn_probe/cn_6-12-12",
        "pbrl_cn_probe/cn_8.5-12-16", "pbrl_vqp_sweep/bc4_vr48",
        "pbrl_vqp_sweep/bc4_vr96", "pbrl_vqp_sweep/bc4_vr192",
        "pbrl_vqp_sweep/bc4_vref3", "pbrl_vqp_sweep/bc5_vr96",
        "pbrl_vqp_gamma/bc4_g1.5_C300", "pbrl_vqp_gamma/bc4_g2.0_C300",
        "pbrl_vqp_gamma/bc4_g1.5_ref3C")
REF3_CLASS = tuple(a for a in ARMS if "/bc4_" in a)


@pytest.fixture(scope="module")
def decoders():
    """{"program/arm": decoder} on the card, and ``rcq-ref3``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    out = {}
    for prog in PROGRAMS:
        arms, punct = importlib.import_module(
            f"ldpc_tpu_torch.cli.{prog}").build_arms("cuda")
        assert punct == tuple(range(86))
        out.update({f"{prog}/{k}": v for k, v in arms.items()})
    assert sorted(out) == sorted(ARMS)
    out["rcq-ref3"] = pw.build_arms(("rcq-ref3",), "cuda")[0]["rcq-ref3"]
    return out


def _stage(dec, T):
    return dec if T == dec.max_iterations else dataclasses.replace(
        dataclasses.replace(dec, qc_options=None).truncated(T),
        qc_options=dec.qc_options)


def _llr(dec, dtype, seed=22):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    llr = lt.puncture_llr(lt.awgn_llr(gen, torch.zeros(
        (256, dec.code.n), device="cuda"), SNR), tuple(range(86)))
    return llr.to(dtype)


def _k1(d, llr, T):
    before = fused.LAYERED_LAUNCHES
    out = fused.qc_fused_decode_batch_layered(
        llr, d.weights, qc=d.qc, spec=d.spec, max_iterations=T,
        dtype=llr.dtype)
    torch.cuda.synchronize()
    assert fused.LAYERED_LAUNCHES == before + 1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [5, 10], ids=["stage 1", "whole"])
@pytest.mark.parametrize("arm", ARMS)
def test_k1_equals_plain(decoders, arm, T, dtype):
    dec = decoders[arm]
    d = _stage(dec, T)
    llr = _llr(dec, dtype)
    assert dec.qc.lift == 86 and dec.code.n == 3182
    assert torch.signbit(llr[:, :86]).any() and not llr[:, :86].any()
    assert d.spec.closed_qdq == arm.split("/")[1].startswith("bc5")
    out = _k1(d, llr, T)
    ref = fused._fused_layered_plain(llr, d.weights, qc=d.qc, spec=d.spec,
                                     max_iterations=T, dtype=dtype)
    assert torch.equal(out.bits, ref.bits)
    assert torch.equal(out.success, ref.success)
    assert torch.equal(out.iterations, ref.iterations)
    nan = torch.isnan(ref.posterior)
    assert torch.equal(torch.isnan(out.posterior), nan)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dtype]
    assert torch.equal(out.posterior[~nan].view(ints),
                       ref.posterior[~nan].view(ints))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [5, 10], ids=["stage 1", "whole"])
def test_v2c_ladder_is_decode_neutral(decoders, T, dtype):
    """Every bc=4 CN_REF3 arm decodes as ``rcq-ref3``, and bc5_vr96 as
    bc5_bv10: bits, success and iterations equal through K1."""
    for ref_name, members in (("rcq-ref3", REF3_CLASS),
                              ("pbrl_bv10/bc5_bv10",
                               ("pbrl_vqp_sweep/bc5_vr96",))):
        llr = _llr(decoders[ref_name], dtype, seed=23)
        want = _k1(_stage(decoders[ref_name], T), llr, T)
        for name in members:
            got = _k1(_stage(decoders[name], T), llr, T)
            assert torch.equal(got.bits, want.bits), name
            assert torch.equal(got.success, want.success), name
            assert torch.equal(got.iterations, want.iterations), name
