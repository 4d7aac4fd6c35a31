"""The fused flooding CUDA kernel (K4) against its plain PyTorch version, on
the card (the kernel has no CPU mode). Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

These tests import no JAX. The kernel is built with -fmad=false and IEEE
division and recomputes each c2v from its compressed check state with the
plain version's operands, so it equals the plain version bit for bit in
f32 and bf16: bits, success and posteriors (NaN where the plain version
has NaN)."""

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
    before = (fused.FLOODING_LAUNCHES, fused.LAYERED_LAUNCHES)
    out = lt.qc_fused_decode_batch(llr, dec.weights, **args)
    ref = fused._fused_flooding_plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    # one K4 launch; the plain version and K1 count nothing
    assert (fused.FLOODING_LAUNCHES, fused.LAYERED_LAUNCHES) == (
        before[0] + 1, before[1])
    _same(out, ref, lean)


@pytest.mark.parametrize("lift", [768, 1024])
@pytest.mark.parametrize("name", ["orcq_t2", "rcq_bc5_closed"])
def test_both_register_caps_match_plain(card, name, lift):
    """Lifts up to 768 run the instance with 80 registers a thread, larger
    ones the instance with 64: both bit for bit, in bf16."""
    dec = _decoder(lift, **KINDS[name])
    gen = torch.Generator(device=card).manual_seed(9)
    llr = lt.awgn_llr(gen, torch.zeros((5, dec.code.n), device=card), 2.5)
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=T,
                dtype=torch.bfloat16)
    out = lt.qc_fused_decode_batch(llr, dec.weights, **args)
    ref = fused._fused_flooding_plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    _same(out, ref, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(KINDS))
def test_hard_inputs_match_plain(card, name, dtype):
    """NaN and -0.0 LLRs, all-equal magnitudes (ties) and a degree-1 row."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 16, size=(3, 7))
    base[2, 1:] = -1  # row 2 keeps one block
    code = lt.create_qc_code(base, lift=16, max_iterations=T)
    dec = lt.make_decoder(code, max_iterations=T,
                          qc=lt.build_qc_graph(base, 16), **KINDS[name])
    gen = torch.Generator(device=card).manual_seed(6)
    llr = torch.round(2.0 * lt.awgn_llr(
        gen, torch.zeros((29, dec.code.n), device=card), 2.0)) / 2.0
    llr[0, 3] = llr[4, 17] = llr[9, 40] = float("nan")
    llr[1, :8] = -0.0
    llr[2, :] = 1.5
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=T, dtype=dtype)
    out = lt.qc_fused_decode_batch(llr, dec.weights, **args)
    ref = fused._fused_flooding_plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    _same(out, ref, False)


def test_zoo_decoder_f32_and_tiny_batches(card):
    """The zoo's flooding decoder at full width in f32 (114,272 B of
    shared memory per frame), one frame and an empty batch; and in bf16 at
    its own T = 10 (66,144 B)."""
    dec = lt.load_pretrained("worcq_bc3_qc9472", max_iterations=4,
                             qc_options=dict(fused=True, dtype=torch.float32))
    gen = torch.Generator(device=card).manual_seed(4)
    llr = lt.awgn_llr(gen, torch.zeros((9, dec.code.n), device=card), 6.25)
    out = dec(llr)
    ref = fused._fused_flooding_plain(llr, dec.weights, qc=dec.qc,
                                      spec=dec.spec, max_iterations=4,
                                      dtype=torch.float32)
    _same(out, ref, False)
    zdec = lt.load_pretrained("worcq_bc3_qc9472")
    args = dict(qc=zdec.qc, spec=zdec.spec, max_iterations=10,
                dtype=torch.bfloat16)
    wide = lt.awgn_llr(gen, torch.zeros((300, dec.code.n), device=card), 6.0)
    _same(lt.qc_fused_decode_batch(wide, zdec.weights, **args),
          fused._fused_flooding_plain(wide, zdec.weights, **args), False)
    one = dec(llr[0])
    assert torch.equal(one.bits, out.bits[0])
    assert dec(llr[:0]).bits.shape == (0, dec.code.n)


def test_refuses_state_over_shared_memory(card):
    """A 5x37 full base at lift 1024 needs 37 * 1024 * 4 B of f32 LLRs and
    as much of column sums per frame, more than the 232,448 B a block may
    hold."""
    base = np.random.default_rng(0).integers(0, 1024, size=(5, 37))
    code = lt.create_qc_code(base, lift=1024, max_iterations=T)
    dec = lt.make_decoder(code, kind="ms", qc=lt.build_qc_graph(base, 1024))
    llr = torch.zeros((2, dec.code.n), device=card)
    with pytest.raises(ValueError, match="shared memory"):
        lt.qc_fused_decode_batch(llr, dec.weights, qc=dec.qc, spec=dec.spec,
                                 max_iterations=T, dtype=torch.float32)


def test_smem_and_occupancy(card):
    """The library's shared memory per CTA and resident CTAs per SM: at the
    zoo decoder 66,144 B in bf16, 3 CTAs in the SM's 228 KB, each with
    1 KB reserved (the uncompressed state, 113,664 B, fit 2), and
    114,272 B in f32, 2 CTAs (was 1); the closed-form quantizers (the CN
    ladder's power law has a table as large as its staircase, the uniform
    V2C ladder none) take as much; a small code's CTAs fit too."""
    from ldpc_tpu_torch.decode._build import load_library
    from ldpc_tpu_torch.decode.engine import qdq_mode

    lib = load_library()
    dec = lt.load_pretrained("worcq_bc3_qc9472")
    small = _decoder(16, **KINDS["rcq_bc5_closed"])
    sm = 228 * 1024
    for d, closed, want in ((dec, False, {2: (66144, 3), 4: (114272, 2)}),
                            (dec, True, {2: (66144, 3), 4: (114272, 2)}),
                            (small, True, {})):
        spec, qc = d.spec, d.qc
        modes = [fused._QMODES[qdq_mode(qp, lv, closed)] for qp, lv
                 in ((spec.qparams, spec.q_levels),
                     (spec.v2c_qparams, spec.v2c_levels))]
        for elt in (2, 4):
            sizes = (qc.nb, qc.mb, qc.num_blocks, qc.lift, int(elt == 2))
            qargs = (modes[0], spec.q_levels, modes[1], spec.v2c_levels)
            smem = lib.ldpc_fused_flooding_smem(*sizes, *qargs)
            ctas = lib.ldpc_fused_flooding_occupancy(
                *sizes, fused._KINDS[spec.kind], *qargs)
            assert (smem, ctas) == want.get(elt, (smem, ctas)) and ctas >= 1
            if want:  # the zoo's CTAs are bound by shared memory
                assert (ctas * (smem + 1024) <= sm <
                        (ctas + 1) * (smem + 1024))
    assert 2 * (113664 + 1024) <= sm < 3 * (113664 + 1024)


def test_steady_state_call_copies_nothing_from_host(card):
    """After the first call has built the device tables, a decode (and a
    two-checkpoint decode) makes no host-to-device copy."""
    from torch.profiler import ProfilerActivity, profile

    dec = lt.load_pretrained("worcq_bc3_qc9472", qc_options=dict(
        fused=True, dtype=torch.bfloat16, lean=True))
    two = lt.make_two_checkpoint_decoder(dec, t1=6, survivor_budget=64)
    gen = torch.Generator(device=card).manual_seed(5)
    llr = lt.awgn_llr(gen, torch.zeros((256, dec.code.n), device=card), 6.5)
    dec(llr)
    two(llr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec(llr)
        two(llr)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any("fused_flooding_kernel" in n for n in names), \
        "the profiler saw no kernel; it cannot show copies either"
    assert not [n for n in names if "HtoD" in n]
