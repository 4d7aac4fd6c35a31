"""The port's two-checkpoint early exit against ``ldpc_tpu``'s on the same
LLRs: layered fused decoders (the JAX one in interpret mode, the port on
its plain version), f32, one survivor budget above the survivor count and
one below it. Bits, success, iterations and the survivor count are exact;
posteriors agree to rtol 1e-6 / atol 1e-5 (XLA:CPU contracts ``a + b*c``
into FMAs; see ``test_torch_fused_layered.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu.decode.early_exit import \
    make_two_checkpoint_decoder as jax_two_checkpoint
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import channel_llr, decoder_pair, make_base

T, T1, B = 6, 3, 40
KW = dict(kind="rcq", bc=3, bv=8, layered=True,
          quantizer_params=((2.0, 1.3), (4.0, 1.3), (6.0, 1.3)),
          v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)))


def _pair(lean=False):
    return decoder_pair(
        make_base(2, 6, 16, seed=4), 16, T,
        jax_options={"fused": True, "batch_tile": 16, "interpret": True,
                     "dtype": jnp.float32, "lean": lean},
        torch_options={"fused": True, "dtype": torch.float32, "lean": lean},
        **KW)


@pytest.mark.parametrize("budget", [24, 4], ids=["in_budget", "overflow"])
def test_two_checkpoint_matches_jax(budget):
    jdec, tdec = _pair()
    llr = channel_llr(B, tdec.code.n, 4.0, seed=2)
    ref, ref_n = jax_two_checkpoint(jdec, t1=T1, survivor_budget=budget)(
        jnp.asarray(llr))
    out, n = lt.make_two_checkpoint_decoder(
        tdec, t1=T1, survivor_budget=budget)(torch.from_numpy(llr))
    assert n.ndim == 0 and int(n) == int(ref_n)
    # both populations, and the overflow case really overflows
    assert 0 < int(n) < B
    assert (int(n) > budget) == (budget == 4)
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(out.posterior.numpy(),
                               np.asarray(ref.posterior),
                               rtol=1e-6, atol=1e-5)


def test_two_checkpoint_lean_and_overflow_semantics():
    """Lean merges int8 bits equal to the full merge; out-of-budget frames
    keep their stage-1 output with success=False."""
    _, full_dec = _pair()
    _, lean_dec = _pair(lean=True)
    llr = torch.from_numpy(channel_llr(B, full_dec.code.n, 4.0, seed=2))
    full, n_full = lt.make_two_checkpoint_decoder(
        full_dec, t1=T1, survivor_budget=4)(llr)
    lean, n_lean = lt.make_two_checkpoint_decoder(
        lean_dec, t1=T1, survivor_budget=4)(llr)
    assert int(n_full) == int(n_lean) > 4
    assert lean.posterior is None and lean.bits.dtype == torch.int8
    np.testing.assert_array_equal(lean.bits.numpy(), full.bits.numpy())
    np.testing.assert_array_equal(lean.success.numpy(),
                                  full.success.numpy())
    np.testing.assert_array_equal(lean.iterations.numpy(),
                                  full.iterations.numpy())

    stage1 = dataclasses.replace(full_dec, qc_options=None).truncated(T1)
    short = lt.qc_fused_decode_batch_layered(
        llr, stage1.weights, qc=stage1.qc, spec=stage1.spec,
        max_iterations=T1, dtype=torch.float32)
    unconv = ~short.success.numpy()
    overflow = unconv & (np.cumsum(unconv) - 1 >= 4)
    assert overflow.any()
    np.testing.assert_array_equal(full.posterior.numpy()[overflow],
                                  short.posterior.numpy()[overflow])
    assert not full.success.numpy()[overflow].any()
    assert (full.iterations.numpy()[overflow] == T1).all()


def test_two_checkpoint_validation():
    _, tdec = _pair()
    with pytest.raises(ValueError):
        lt.make_two_checkpoint_decoder(tdec, t1=T, survivor_budget=8)
    with pytest.raises(ValueError):
        lt.make_two_checkpoint_decoder(tdec, t1=2, survivor_budget=0)
    # a fused decoder refuses truncation itself (its check schedule is {T})
    with pytest.raises(ValueError):
        tdec.truncated(T1)


def test_nan_frame_does_not_reach_a_survivor():
    """A batch of one all-NaN frame (converged at t1: its posterior is NaN,
    so its bits are 0 and its syndrome passes) and one stage-1 survivor.
    The port gathers the survivor by index, so its stage-2 decode is that
    frame's decode alone. ``ldpc_tpu`` gathers with a one-hot matmul
    (``ldpc_tpu/decode/early_exit.py:96-98``), and 0 * NaN = NaN spreads
    the NaN frame into every column of the survivor's row: the survivor
    decodes to a NaN posterior, all-zero bits and success=True, and the
    scatter ``P.T @ out2.posterior`` (``:109-111``) brings that back
    (ROADMAP.md Queue 3, known differences of the reference)."""
    from ldpc_tpu_torch.decode import two_checkpoint_stages
    jdec, tdec = _pair()
    llr = channel_llr(B, tdec.code.n, 4.0, seed=2)
    stage1, full = two_checkpoint_stages(tdec, T1)
    surv = int(np.flatnonzero(
        ~stage1(torch.from_numpy(llr), tdec.weights).success.numpy())[0])
    batch = np.stack([np.full(tdec.code.n, np.nan, np.float32), llr[surv]])
    out, n = lt.make_two_checkpoint_decoder(tdec, t1=T1, survivor_budget=4)(
        torch.from_numpy(batch))
    alone = full(torch.from_numpy(batch[1:]), tdec.weights)
    assert int(n) == 1
    assert bool(out.success[0]) and not out.bits[0].any()
    assert torch.isnan(out.posterior[0]).all()
    assert torch.equal(out.posterior[1:], alone.posterior)
    assert torch.equal(out.bits[1:], alone.bits)
    assert torch.equal(out.success[1:], alone.success)
    assert out.iterations.tolist() == [T1, T]
    assert not torch.isnan(out.posterior[1]).any()
    ref, ref_n = jax_two_checkpoint(jdec, t1=T1, survivor_budget=4)(
        jnp.asarray(batch))
    assert int(ref_n) == 1
    assert np.isnan(np.asarray(ref.posterior)).all()
    assert not np.asarray(ref.bits).any() and np.asarray(ref.success).all()
