"""The encoder, the importance sampler, the design and report tools and K1
on the error-floor decoder, on the card against the CPU or against K1's
plain version. Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

These tests import no JAX. The encoder's products are sums of 0/1 in
float32 (exact), the sampler's arithmetic is float32 operations with no
reduction whose order could differ, and the design and report tools read
the card's tensors on the host, so each is bit for bit with the CPU. K1
equals its plain version bit for bit in f32 and bf16."""

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
import ldpc_tpu_torch.sim.importance as tis
from ldpc_tpu_torch.decode import fused
from ldpc_tpu_torch.design import analyze_decoder
from ldpc_tpu_torch.report import analyze_weight_patterns

pytestmark = pytest.mark.cuda

# experiments/floor_is.py's decoder: RCQ bc=4 6-11-16 @ 1.3, bv=8 uniform
FLOOR_KW = dict(kind="rcq", bc=4, bv=8,
                quantizer_params=((6.0, 1.3), (11.0, 1.3), (16.0, 1.3)),
                v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
                max_iterations=10, layered=True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ints(x):
    return x.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[x.dtype])


def _floor_decoder(device, precode, dtype=torch.bfloat16):
    """The PBRL QC rate-1/3 floor decoder (lift 86), fused, on ``device``,
    and its punctured positions (None for the random arm)."""
    B, L, *pc = lt.create_pbrl_qc_protograph(k=1032, rate=1 / 3,
                                             precode=precode)
    code = lt.create_qc_code(B, lift=L, max_iterations=10)
    dec = lt.make_decoder(code, qc=lt.build_qc_graph(B, L),
                          qc_options=dict(fused=True, dtype=dtype),
                          device=device, **FLOOR_KW)
    punct = np.arange(L * pc[0][0], L * (pc[0][0] + 1)) if precode else None
    return dec, punct


def test_encode_and_syndrome_equal_the_cpu(card):
    base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    enc = lt.make_encoder(lt.create_qc_code(base, lift=256))
    assert enc.k_eff == 8196
    u = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, size=(96, enc.k_eff), dtype=np.int32))
    c = enc(u.to(card))
    assert c.device.type == "cuda" and torch.equal(c.cpu(), enc(u))
    assert torch.equal(c[:, torch.from_numpy(enc.info_positions).to(card)],
                       u.to(card))
    ok = enc.syndrome_ok(c)
    assert bool(ok.all()) and torch.equal(ok.cpu(), enc.syndrome_ok(c.cpu()))
    c[5, 100] ^= 1
    assert enc.syndrome_ok(c).tolist() == [i != 5 for i in range(96)]


def test_log_w_against_its_own_noise(card):
    """``biased_awgn_llr`` on the card equals ``biased_llr_from_noise`` on
    the CPU from the same noise: LLRs and log_w bit for bit, punctured
    positions zero."""
    pos, shift, snr = [3, 90, 1000, 2047], 1.6, 3.6
    punct = np.arange(2100, 2186)
    llr, log_w = tis.biased_awgn_llr(
        torch.Generator(device=card).manual_seed(4), 2048, 3182, snr, pos,
        shift, punctured=punct)
    sigma = torch.sqrt(torch.full((), 10.0 ** (-snr / 10.0),
                                  dtype=torch.float32, device=card))
    noise = torch.randn((2048, 3182), dtype=torch.float32, device=card,
                        generator=torch.Generator(device=card).manual_seed(4))
    llr_c, log_w_c = tis.biased_llr_from_noise((noise * sigma).cpu(), snr,
                                               pos, shift, punctured=punct)
    assert torch.equal(_ints(llr.cpu()), _ints(llr_c))
    assert torch.equal(_ints(log_w.cpu()), _ints(log_w_c))
    assert bool((llr[:, punct] == 0).all())


@pytest.mark.parametrize("localized", [True, False])
def test_event_indicators_equal_the_cpu(card, localized):
    """The floor decoder's localized-failure indicators on the same biased
    LLRs: K1 on the card (f32) against the plain version on the CPU."""
    dec, _ = _floor_decoder(card, False, torch.float32)
    cpu = lt.make_decoder(dec.code, qc=dec.qc, qc_options=dec.qc_options,
                          device="cpu", **FLOOR_KW)
    members = [1806, 1892, 1978]  # a (3, 1) trapping set of this code
    llr, _ = tis.biased_awgn_llr(torch.Generator(device=card).manual_seed(5),
                                 512, dec.code.n, 2.0, members, 2.0)
    before = fused.LAYERED_LAUNCHES
    got = tis.localized_failure(dec, members, localized)(llr)
    assert fused.LAYERED_LAUNCHES == before + 1
    want = tis.localized_failure(cpu, members, localized)(llr.cpu())
    assert torch.equal(got.cpu(), want) and 0 < int(want.sum()) < 512


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("precode", [False, True], ids=["random",
                                                        "precoded"])
def test_k1_on_the_floor_decoder_matches_plain(card, precode, dtype):
    """The PBRL QC base (irregular rows, degree-1 columns, lift 86: partial
    warps) with the bc=4 staircase, 256 frames of biased LLRs at 3.6 dB:
    bits, success and the posterior bit for bit."""
    dec, punct = _floor_decoder(card, precode)
    llr, _ = tis.biased_awgn_llr(
        torch.Generator(device=card).manual_seed(6), 256, dec.code.n, 3.6,
        [86 * 2 + 9, 86 * 17 + 3], 1.6, punctured=punct)
    x = llr.to(dtype)
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=10, dtype=dtype)
    out = lt.qc_fused_decode_batch_layered(x, dec.weights, **args)
    ref = fused._fused_layered_plain(x, dec.weights, **args)
    torch.cuda.synchronize()
    for k in ("bits", "success", "iterations"):
        assert torch.equal(getattr(out, k), getattr(ref, k)), k
    assert torch.equal(_ints(out.posterior), _ints(ref.posterior))


def test_analyzers_read_decoders_on_the_card(card):
    """``analyze_decoder`` and ``analyze_weight_patterns`` of decoders on
    the card (weights that need grad) equal their CPU copies'."""
    zoo = lt.load_pretrained("worcq_bc3_qc9472", device=card)
    zoo = zoo.replace_weights({
        k: None if v is None else v.clone().requires_grad_(True)
        for k, v in zoo.weights.items()})
    cpu = lt.load_pretrained("worcq_bc3_qc9472", device="cpu")
    assert analyze_weight_patterns(zoo) == analyze_weight_patterns(cpu)
    a = analyze_decoder(zoo, snr_db=6.0, max_iterations=4)
    b = analyze_decoder(cpu, snr_db=6.0, max_iterations=4)
    np.testing.assert_array_equal(a.error_prob, b.error_prob)
