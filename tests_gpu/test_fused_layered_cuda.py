"""The fused layered CUDA kernel against its plain PyTorch version, on the
card (the kernel has no CPU mode). Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

These tests import no JAX. The kernel is built with -fmad=false and IEEE
division and keeps the plain version's op order and rounding points, so
it equals the plain version bit for bit in f32 and bf16: bits, success
and posteriors (NaN where the plain version has NaN)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.codes import load_protograph
from ldpc_tpu_torch.decode import fused

ROOT = Path(__file__).resolve().parent.parent

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
    """The kernel no longer refuses a lift above 1024 threads per block: a
    lift of 1030 runs the instance whose 1024 threads take one or two
    checks each, bit for bit with the plain version."""
    dec = _decoder(1030, kind="ms", factor=0.7)
    gen = torch.Generator(device=card).manual_seed(4)
    llr = lt.awgn_llr(gen, torch.zeros((2, dec.code.n), device=card), 3.0)
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=T,
                dtype=torch.float32)
    out = lt.qc_fused_decode_batch_layered(llr, dec.weights, **args)
    ref = fused._fused_layered_plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    _same(out, ref, False)


def _alternating(weights):
    """``weights`` with alpha one value at even iterations: there a row
    that shares beta shares (beta, alpha), at odd iterations it does not,
    so the kernel's check state switches kind between iterations."""
    alt = {k: (None if v is None else v.clone()) for k, v in weights.items()}
    alt["alpha"][::2] = alt["alpha"][::2, :1]
    return alt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["nms_t2", "oms_t2", "wrcq_t2", "orcq_t2"])
def test_shared_and_per_block_rows_match_plain(card, name, dtype):
    """Irregular rows (degrees 8, 7 and 1) of trained kinds: rows whose
    blocks share (beta, alpha) (the check keeps its four c2v) and rows
    that do not (it keeps min1, min2), switching between iterations, with
    NaN, -0.0 and ties among the LLRs; bit for bit."""
    rng = np.random.default_rng(8)
    base = rng.integers(0, 16, size=(3, 8))
    base[1, 3] = -1
    base[2, 1:] = -1                     # a degree-1 row
    code = lt.create_qc_code(base, lift=16, max_iterations=T)
    dec = lt.make_decoder(code, max_iterations=T,
                          qc=lt.build_qc_graph(base, 16), **KINDS[name])
    gen = torch.Generator(device=card).manual_seed(9)
    llr = torch.round(2.0 * lt.awgn_llr(
        gen, torch.zeros((41, dec.code.n), device=card), 2.0)) / 2.0
    llr[0, 3] = float("nan")
    llr[1, :8] = -0.0
    llr[2, :] = 1.5
    for weights in (dec.weights, _alternating(dec.weights)):
        args = dict(qc=dec.qc, spec=dec.spec, max_iterations=T, dtype=dtype)
        out = lt.qc_fused_decode_batch_layered(llr, weights, **args)
        ref = fused._fused_layered_plain(llr, weights, **args)
        torch.cuda.synchronize()
        _same(out, ref, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["rcq_bc3_bv8", "orcq_t2"])
def test_wide_rows_match_plain(card, name, dtype):
    """Rows of degree 70 and 66: three sign words per check, the last
    shared with the meta bits; bit for bit."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 8, size=(2, 70))
    base[1, :4] = -1
    code = lt.create_qc_code(base, lift=8, max_iterations=T)
    dec = lt.make_decoder(code, max_iterations=T,
                          qc=lt.build_qc_graph(base, 8), **KINDS[name])
    gen = torch.Generator(device=card).manual_seed(11)
    llr = lt.awgn_llr(gen, torch.zeros((19, code.n), device=card), 4.0)
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=T, dtype=dtype)
    out = lt.qc_fused_decode_batch_layered(llr, dec.weights, **args)
    ref = fused._fused_layered_plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    _same(out, ref, False)


def _placement(dec, dtype):
    """(on chip, shared memory per CTA): where the library puts the
    decoder's check state on this card."""
    from ldpc_tpu_torch.decode import _build
    from ldpc_tpu_torch.decode.engine import qdq_mode

    qc, spec = dec.qc, dec.spec
    sizes = (qc.nb, qc.mb, qc.num_blocks, qc.lift,
             max(len(r) for r in qc.row_blocks), int(dtype == torch.bfloat16),
             fused._QMODES[qdq_mode(spec.qparams, spec.q_levels)],
             spec.q_levels,
             fused._QMODES[qdq_mode(spec.v2c_qparams, spec.v2c_levels)],
             spec.v2c_levels)
    lib = _build.load_library()
    limit = torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin
    onchip = lib.ldpc_fused_layered_smem(*sizes, 1)
    if onchip <= limit:
        return True, onchip
    return False, lib.ldpc_fused_layered_smem(*sizes, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["rcq_bc3_bv8", "orcq_t2"])
def test_dvbs2_protograph_decodes(card, name, dtype):
    """The DVB-S2-structure (16200, 7200) protograph (lift 360, row degrees
    5 and 6; a cell of experiments/throughput_matrix.py) decodes and does
    not raise: in bf16 its check state fits in shared memory, in f32 it
    lives in the per-frame device scratch. Bit for bit with the plain
    version either way, and at 2.5 dB the decode corrects all but a few
    of the channel's bit errors (RCQ at T=6 leaves some)."""
    b, lift = load_protograph(str(ROOT / "codes" /
                                  "dvbs2_like_16200_7200.proto"))
    code = lt.create_qc_code(b, lift=lift, max_iterations=6)
    dec = lt.make_decoder(code, max_iterations=6,
                          qc=lt.build_qc_graph(b, lift), **KINDS[name])
    onchip, smem = _placement(dec, dtype)
    assert onchip == (dtype == torch.bfloat16), (onchip, smem)
    gen = torch.Generator(device=card).manual_seed(10)
    llr = lt.awgn_llr(gen, torch.zeros((12, code.n), device=card), 2.5)
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=6, dtype=dtype)
    out = lt.qc_fused_decode_batch_layered(llr, dec.weights, **args)
    ref = fused._fused_layered_plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    _same(out, ref, False)
    channel_ber = (llr < 0).float().mean().item()
    assert (out.bits != 0).float().mean().item() < 0.05 * channel_ber


def test_occupancy_entry_point(card):
    """The library reports K1's shared memory and resident CTAs per SM at
    the bench shape (5x37, lift 256), as chip_smoke prints them: on chip
    in both types, at least 3 CTAs per SM in bf16."""
    from ldpc_tpu_torch.decode import _build

    lib = _build.load_library()
    for bf16, least in ((1, 3), (0, 1)):
        sizes = (37, 5, 185, 256, 37, bf16, fused._QMODES["staircase"], 4,
                 fused._QMODES["uniform"], 128)
        assert lib.ldpc_fused_layered_smem(*sizes, 1) <= \
            torch.cuda.get_device_properties(0).shared_memory_per_block_optin
        assert lib.ldpc_fused_layered_occupancy(
            *sizes[:6], fused._KINDS["rcq"], *sizes[6:], 1) >= least
