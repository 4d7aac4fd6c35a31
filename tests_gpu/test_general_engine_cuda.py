"""The general, layered and degree-bucketed engines on the card against the
same engines on the CPU, and the fused kernels K1 and K4 at a lift above
1024. Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

These tests import no JAX. The engines are plain PyTorch ops whose sums
add one message at a time in a fixed order, so the card gives the CPU's
results bit for bit: bits, success, iterations and posteriors (NaN where
the CPU has NaN). K1 and K4 equal their plain versions bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.decode import fused, qc_rowcol

pytestmark = pytest.mark.cuda

QP = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
RCQ = dict(kind="rcq", bc=3, bv=8, quantizer_params=QP,
           v2c_quantizer_params=VQP)
# route: (make_decoder arguments, qc_options)
ROUTES = {
    "general": (dict(), None),
    "layered": (dict(layered=True), None),
    "bucketed_f32": (dict(bucketed=True), None),
    "bucketed_bf16": (dict(bucketed=True),
                      {"dtype": torch.bfloat16, "check_every": 2}),
}
# the quantized kinds take the staircase (bc=3) and the uniform V2C
# quantizer (bv=8, gamma 1): torch.pow, which the power-law quantizer
# calls, may round differently on the card and on the CPU
KINDS = {
    "ms": dict(kind="ms", factor=0.7),
    "nms_t0": dict(kind="nms", sharing_type=0, seed=1),
    "oms_t2": dict(kind="oms", sharing_type=2, seed=2),
    "rcq_bv8": RCQ,
    "wrcq_t2_bv8": dict(RCQ, kind="wrcq", sharing_type=2, init="nms",
                        seed=3),
    "orcq_t3_bv8": dict(RCQ, kind="orcq", sharing_type=3, seed=4),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(out, ref):
    """A decode on the card equals the same decode on the CPU bit for
    bit."""
    for k in ("bits", "iterations", "success"):
        assert torch.equal(getattr(out, k).cpu(), getattr(ref, k)), k
    got, want = out.posterior.cpu(), ref.posterior
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _counts():
    return (fused.LAYERED_LAUNCHES, fused.FLOODING_LAUNCHES,
            qc_rowcol.CN_LAUNCHES, qc_rowcol.VN_LAUNCHES)


def _decoder(code, route, device, kind="rcq_bv8", T=8, **kw):
    args, opts = ROUTES[route]
    return lt.make_decoder(code, max_iterations=T, qc_options=opts,
                           device=device, **args, **KINDS[kind], **kw)


def _pair(code, route, card, B, snr, **kw):
    """(card decoder, CPU decoder with the card's weights, LLRs on the
    card)."""
    dec = _decoder(code, route, card, **kw)
    cpu = dataclasses.replace(dec, device=torch.device("cpu")
                              ).replace_weights(dec.weights)
    gen = torch.Generator(device=card).manual_seed(7)
    llr = lt.awgn_llr(gen, torch.zeros((B, code.n), device=card), snr)
    return dec, cpu, llr


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("route", list(ROUTES))
def test_small_code_card_equals_cpu(card, route, kind):
    """Every route and kind on a PBRL-like code (k=96: check degrees 2-6,
    variable degrees 1-13), with NaN, -0.0 and tied LLRs; no fused or
    row/column kernel launches."""
    code = lt.create_pbrl_like_code(k=96, rate=1 / 3, max_iterations=8)
    dec, cpu, llr = _pair(code, route, card, 61, 1.5, kind=kind)
    llr = torch.round(2.0 * llr) / 2.0
    llr[0, 5] = float("nan")
    llr[1] = float("nan")
    llr[2, :9] = -0.0
    before = _counts()
    out = dec(llr)
    torch.cuda.synchronize()
    assert _counts() == before
    _same(out, cpu(llr.cpu()))


@pytest.mark.parametrize("route", list(ROUTES))
def test_pbrl_full_width_card_equals_cpu(card, route):
    """PBRL (3096, 1032), RCQ bc=3 bv=8, T=10, 1.2 dB, 128 frames."""
    code = lt.create_pbrl_like_code(k=1032, rate=1 / 3, max_iterations=10)
    dec, cpu, llr = _pair(code, route, card, 128, 1.2, T=10)
    out = dec(llr)
    ref = cpu(llr.cpu())
    _same(out, ref)
    assert 0 < int(ref.success.sum()) < 128


def test_colliding_layers_are_deterministic(card):
    """``num_layers`` below what the greedy layering needs puts checks that
    share variables into one layer: their differences add to a variable in
    slot order, never by atomics, so two runs on the card and the CPU run
    agree bit for bit."""
    code = lt.create_pbrl_like_code(k=1032, rate=1 / 3, max_iterations=10)
    dec, cpu, llr = _pair(code, "layered", card, 256, 1.2, T=10,
                          num_layers=8)
    assert len(dec.layer_checks) == 8
    a, b = dec(llr), dec(llr)
    _same(a, cpu(llr.cpu()))
    for k in ("bits", "posterior", "iterations", "success"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_peg_and_single_frame(card):
    """A PEG code on every route, one frame at a time and as a batch."""
    code = lt.create_peg_code(n=256, m=128, dv=3, seed=0, max_iterations=10)
    for route in ROUTES:
        dec, cpu, llr = _pair(code, route, card, 9, 2.0, T=10)
        out = dec(llr)
        _same(out, cpu(llr.cpu()))
        one = dec(llr[3])
        assert torch.equal(one.bits, out.bits[3])


def test_steady_state_call_copies_nothing_from_host(card):
    """After the first call has built the device tables, a decode on each
    route makes no host-to-device copy."""
    from torch.profiler import ProfilerActivity, profile

    code = lt.create_pbrl_like_code(k=96, rate=1 / 3, max_iterations=8)
    decs = [_decoder(code, r, card, kind=k) for r in ROUTES
            for k in ("rcq_bv8", "nms_t0")]
    gen = torch.Generator(device=card).manual_seed(5)
    llr = lt.awgn_llr(gen, torch.zeros((64, code.n), device=card), 1.5)
    for d in decs:
        d(llr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for d in decs:
            d(llr)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any("index_select" in n or "indexSelect" in n for n in names), \
        "the profiler saw no gather; it cannot show copies either"
    assert not [n for n in names if "HtoD" in n]


# -- K1 and K4 at a lift above 1024 ----------------------------------------

FUSED_KINDS = {
    "ms": dict(kind="ms", factor=0.7),
    "rcq_bc3_bv8": dict(kind="rcq", bc=3, bv=8),
    "nms_t2": dict(kind="nms", sharing_type=2, init="nms", seed=1),
    "oms_t2": dict(kind="oms", sharing_type=2, seed=5),
    "wrcq_t2": dict(kind="wrcq", bc=3, sharing_type=2, init="nms", seed=6),
    "orcq_t2": dict(kind="orcq", bc=3, sharing_type=2, seed=7),
    "rcq_bc5_closed": dict(kind="rcq", bc=5, bv=8, closed_qdq=True),
}


def _qc_decoder(mb, nb, lift, T=5, **kw):
    rng = np.random.default_rng(11)
    base = rng.integers(0, lift, size=(mb, nb))
    base[rng.random((mb, nb)) < 0.2] = -1
    base[:, 0] = np.maximum(base[:, 0], 0)  # every row keeps a block
    base[0] = np.maximum(base[0], 0)        # every column keeps a block
    code = lt.create_qc_code(base, lift=lift, max_iterations=T)
    return lt.make_decoder(code, max_iterations=T,
                           qc=lt.build_qc_graph(base, lift), **kw)


def _fused_same(out, ref):
    assert torch.equal(out.bits, ref.bits)
    assert torch.equal(out.success, ref.success)
    nan = torch.isnan(ref.posterior)
    assert torch.equal(torch.isnan(out.posterior), nan)
    ints = {torch.float32: torch.int32,
            torch.bfloat16: torch.int16}[ref.posterior.dtype]
    assert torch.equal(out.posterior[~nan].view(ints),
                       ref.posterior[~nan].view(ints))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FUSED_KINDS))
@pytest.mark.parametrize("flooding", [False, True], ids=["K1", "K4"])
def test_lift_2048_matches_plain(card, flooding, name, dtype):
    """A 3x6 base at lift 2048: 1024 threads a block, each taking two
    checks or variables of a block, bit for bit with the plain version
    (NaN and -0.0 among the LLRs); one launch."""
    dec = _qc_decoder(3, 6, 2048, **FUSED_KINDS[name])
    gen = torch.Generator(device=card).manual_seed(12)
    llr = lt.awgn_llr(gen, torch.zeros((5, dec.code.n), device=card), 2.5)
    llr[0, 7] = float("nan")
    llr[1, :40] = -0.0
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=dec.max_iterations,
                dtype=dtype)
    kern = lt.qc_fused_decode_batch if flooding else \
        lt.qc_fused_decode_batch_layered
    plain = fused._fused_flooding_plain if flooding else \
        fused._fused_layered_plain
    before = (fused.FLOODING_LAUNCHES, fused.LAYERED_LAUNCHES)
    out = kern(llr, dec.weights, **args)
    ref = plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    assert (fused.FLOODING_LAUNCHES, fused.LAYERED_LAUNCHES) == (
        before[0] + flooding, before[1] + (not flooding))
    _fused_same(out, ref)


def test_lift_2048_state_placement_and_limit(card):
    """A 4x8 base at lift 2048 in f32: K1's check state does not fit beside
    the LLRs and column sums, so it goes to the per-frame device scratch,
    bit for bit; an odd lift of 1500 (threads own 1 or 2 units); K4's
    state does not fit the card's shared memory and it refuses, as
    ``ldpc_tpu`` refuses a state over VMEM."""
    from ldpc_tpu_torch.decode._build import load_library
    from ldpc_tpu_torch.decode.engine import qdq_mode

    dec = _qc_decoder(4, 8, 2048, **FUSED_KINDS["orcq_t2"])
    qc, spec = dec.qc, dec.spec
    sizes = (qc.nb, qc.mb, qc.num_blocks, qc.lift,
             max(len(r) for r in qc.row_blocks), 0)
    modes = (fused._QMODES[qdq_mode(spec.qparams, spec.q_levels)],
             spec.q_levels,
             fused._QMODES[qdq_mode(spec.v2c_qparams, spec.v2c_levels)],
             spec.v2c_levels)
    limit = torch.cuda.get_device_properties(card).shared_memory_per_block_optin
    lib = load_library()
    assert lib.ldpc_fused_layered_smem(*sizes, *modes, 1) > limit
    assert lib.ldpc_fused_layered_smem(*sizes, *modes, 0) <= limit
    gen = torch.Generator(device=card).manual_seed(13)
    llr = lt.awgn_llr(gen, torch.zeros((3, dec.code.n), device=card), 2.5)
    args = dict(qc=qc, spec=spec, max_iterations=dec.max_iterations,
                dtype=torch.float32)
    _fused_same(lt.qc_fused_decode_batch_layered(llr, dec.weights, **args),
                fused._fused_layered_plain(llr, dec.weights, **args))
    with pytest.raises(ValueError, match="shared memory"):
        lt.qc_fused_decode_batch(llr, dec.weights, **args)
    odd = _qc_decoder(3, 6, 1500, **FUSED_KINDS["rcq_bc3_bv8"])
    llr = lt.awgn_llr(gen, torch.zeros((3, odd.code.n), device=card), 2.5)
    for kern, plain in ((lt.qc_fused_decode_batch,
                         fused._fused_flooding_plain),
                        (lt.qc_fused_decode_batch_layered,
                         fused._fused_layered_plain)):
        a = dict(qc=odd.qc, spec=odd.spec,
                 max_iterations=odd.max_iterations, dtype=torch.bfloat16)
        _fused_same(kern(llr, odd.weights, **a),
                    plain(llr, odd.weights, **a))
