"""The fused layered CUDA kernel against its plain PyTorch version, on the
card (the kernel has no CPU mode). Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

These tests import no JAX. The kernel is built with -fmad=false and IEEE
division and keeps the plain version's op order and rounding points, so
it equals the plain version bit for bit in f32 and bf16: bits, success
and posteriors (NaN where the plain version has NaN)."""

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.decode import fused

pytestmark = pytest.mark.cuda

T = 5
KINDS = {
    "ms": dict(kind="ms", factor=0.7),
    "rcq_bc3_bv8": dict(kind="rcq", bc=3, bv=8),
    "nms_t2": dict(kind="nms", sharing_type=2, init="nms", seed=1),
    "oms_t2": dict(kind="oms", sharing_type=2, seed=5),
    "wrcq_t2": dict(kind="wrcq", bc=3, sharing_type=2, init="nms", seed=6),
    "orcq_t2": dict(kind="orcq", bc=3, sharing_type=2, seed=7),
    "rcq_bc5_closed": dict(kind="rcq", bc=5, bv=8, closed_qdq=True),
}


def _same(out, ref, lean):
    """The kernel's result equals the plain version's bit for bit."""
    assert out.bits.dtype == ref.bits.dtype
    assert torch.equal(out.iterations, ref.iterations)
    assert torch.equal(out.bits, ref.bits)
    assert torch.equal(out.success, ref.success)
    if not lean:
        nan = torch.isnan(ref.posterior)
        assert torch.equal(torch.isnan(out.posterior), nan)
        ints = {torch.float32: torch.int32,
                torch.bfloat16: torch.int16}[ref.posterior.dtype]
        assert torch.equal(out.posterior[~nan].view(ints),
                           ref.posterior[~nan].view(ints))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _decoder(lift, **kw):
    rng = np.random.default_rng(3)
    base = rng.integers(0, lift, size=(3, 7))
    base[rng.random((3, 7)) < 0.15] = -1
    base[:, 0] = np.maximum(base[:, 0], 0)  # every row keeps a block
    base[0] = np.maximum(base[0], 0)        # every column keeps a block
    code = lt.create_qc_code(base, lift=lift, max_iterations=T)
    return lt.make_decoder(code, max_iterations=T,
                           qc=lt.build_qc_graph(base, lift), **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
@pytest.mark.parametrize("name", list(KINDS))
def test_kernel_matches_plain(card, name, lean, dtype):
    dec = _decoder(16, **KINDS[name])
    gen = torch.Generator(device=card).manual_seed(2)
    llr = lt.awgn_llr(gen, torch.zeros((37, dec.code.n), device=card), 2.5)
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=T, dtype=dtype,
                lean=lean)
    before = fused.LAYERED_LAUNCHES
    out = lt.qc_fused_decode_batch_layered(llr, dec.weights, **args)
    assert fused.LAYERED_LAUNCHES == before + 1
    ref = fused._fused_layered_plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    assert fused.LAYERED_LAUNCHES == before + 1  # the plain version counts 0
    _same(out, ref, lean)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(KINDS))
def test_hard_inputs_match_plain(card, name, dtype):
    """NaN and -0.0 LLRs and all-equal magnitudes (ties), bit for bit: the
    shared quantizer keeps a NaN through its uniform and power clamps, as
    the plain quantizers do."""
    dec = _decoder(16, **KINDS[name])
    gen = torch.Generator(device=card).manual_seed(6)
    llr = torch.round(2.0 * lt.awgn_llr(
        gen, torch.zeros((29, dec.code.n), device=card), 2.0)) / 2.0
    llr[0, 3] = llr[4, 17] = llr[9, 40] = float("nan")
    llr[1, :8] = -0.0
    llr[2, :] = 1.5
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=T, dtype=dtype)
    out = lt.qc_fused_decode_batch_layered(llr, dec.weights, **args)
    ref = fused._fused_layered_plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    _same(out, ref, False)
    assert torch.isnan(ref.posterior.float()).any()


def test_odd_lift_and_tiny_batch(card):
    """A lift that is not a multiple of 32, one frame, and an empty batch."""
    dec = _decoder(45, kind="rcq", bc=3, bv=8)
    gen = torch.Generator(device=card).manual_seed(3)
    llr = lt.awgn_llr(gen, torch.zeros((1, dec.code.n), device=card), 3.0)
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=T,
                dtype=torch.float32)
    out = lt.qc_fused_decode_batch_layered(llr, dec.weights, **args)
    ref = fused._fused_layered_plain(llr, dec.weights, **args)
    assert torch.equal(out.posterior, ref.posterior)
    empty = lt.qc_fused_decode_batch_layered(llr[:0], dec.weights, **args)
    assert empty.bits.shape == (0, dec.code.n)


def test_refuses_lift_over_1024(card):
    dec = _decoder(1030, kind="ms", factor=0.7)
    llr = torch.zeros((2, dec.code.n), device=card)
    with pytest.raises(ValueError, match="1024"):
        lt.qc_fused_decode_batch_layered(llr, dec.weights, qc=dec.qc,
                                         spec=dec.spec, max_iterations=T)
