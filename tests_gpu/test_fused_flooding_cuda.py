"""The fused flooding CUDA kernel (K4) against its plain PyTorch version, on
the card (the kernel has no CPU mode). Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

These tests import no JAX. Tolerances: f32 hard outputs exact and
posteriors to rtol 1e-6 / atol 1e-5 (the kernel is built with
-fmad=false, so they are expected to be equal); bf16 bits >= 99.99% and
frames >= 99.9% equal."""

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
    assert out.bits.dtype == ref.bits.dtype
    assert torch.equal(out.iterations, ref.iterations)
    if dtype == torch.float32:
        assert torch.equal(out.bits, ref.bits)
        assert torch.equal(out.success, ref.success)
        if not lean:
            torch.testing.assert_close(out.posterior, ref.posterior,
                                       rtol=1e-6, atol=1e-5)
    else:
        assert (out.bits == ref.bits).float().mean().item() >= 0.9999
        assert (out.success == ref.success).float().mean().item() >= 0.999


def test_zoo_decoder_f32_and_tiny_batches(card):
    """The zoo's flooding decoder at full width in f32 (227,328 B of
    shared memory per frame), one frame and an empty batch."""
    dec = lt.load_pretrained("worcq_bc3_qc9472", max_iterations=4,
                             qc_options=dict(fused=True, dtype=torch.float32))
    gen = torch.Generator(device=card).manual_seed(4)
    llr = lt.awgn_llr(gen, torch.zeros((9, dec.code.n), device=card), 6.25)
    out = dec(llr)
    ref = fused._fused_flooding_plain(llr, dec.weights, qc=dec.qc,
                                      spec=dec.spec, max_iterations=4,
                                      dtype=torch.float32)
    assert torch.equal(out.bits, ref.bits)
    assert torch.equal(out.success, ref.success)
    torch.testing.assert_close(out.posterior, ref.posterior, rtol=1e-6,
                               atol=1e-5)
    one = dec(llr[0])
    assert torch.equal(one.bits, out.bits[0])
    assert dec(llr[:0]).bits.shape == (0, dec.code.n)


def test_refuses_state_over_shared_memory(card):
    """A 5x37 full base at lift 512 needs (37 + 185) * 512 * 4 B of f32
    state per frame, twice what a block may hold."""
    base = np.random.default_rng(0).integers(0, 512, size=(5, 37))
    code = lt.create_qc_code(base, lift=512, max_iterations=T)
    dec = lt.make_decoder(code, kind="ms", qc=lt.build_qc_graph(base, 512))
    llr = torch.zeros((2, dec.code.n), device=card)
    with pytest.raises(ValueError, match="shared memory"):
        lt.qc_fused_decode_batch(llr, dec.weights, qc=dec.qc, spec=dec.spec,
                                 max_iterations=T, dtype=torch.float32)


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
