"""The port's fused layered decode (``ldpc_tpu_torch.decode.fused``) against
the JAX layered whole-decode kernel run in interpret mode.

On the CPU the port runs the kernel's plain PyTorch version. Tolerances:
hard outputs (bits, success, iterations) are exact. f32 posteriors agree to
rtol 1e-6 / atol 1e-5, not bit for bit, because XLA:CPU compiles the
interpret-mode kernel with FMA contraction (``a + b*c`` in one rounding)
and turns the division by a constant ``C / M`` of the uniform quantizer
into a reciprocal multiply, while the port rounds every operation as
written. bf16 is held to >= 99.99% bit agreement, with XLA's excess
precision turned off for the JAX compile so that both sides round to bf16
where the kernel's source says (left on, XLA keeps bf16 intermediates in
f32 and the two drift apart on frames that do not converge).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch_layered
from ldpc_tpu_torch.decode import fused
from ldpc_tpu_torch.decode.engine import qdq_mode
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import channel_llr, decoder_pair, make_base

T = 5
RCQ_PARAMS = ((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))


def _pair(**kw):
    return decoder_pair(make_base(3, 7, 16, seed=4, density=0.85), 16, T,
                        **kw)


def _jax(jdec, llr, dtype=jnp.float32):
    x = jnp.asarray(llr)
    return qc_fused_decode_batch_layered.lower(
        x, jdec.weights, qc=jdec.qc, spec=jdec.spec, max_iterations=T,
        dtype=dtype, batch_tile=16, interpret=True,
    ).compile(compiler_options={"xla_allow_excess_precision": False})(
        x, jdec.weights)


def _port(tdec, llr, dtype=torch.float32, **kw):
    return lt.qc_fused_decode_batch_layered(
        torch.from_numpy(llr), tdec.weights, qc=tdec.qc, spec=tdec.spec,
        max_iterations=T, dtype=dtype, **kw)


@pytest.mark.parametrize("kw", [
    dict(kind="ms", factor=0.7),
    dict(kind="rcq", bc=3, bv=8, quantizer_params=RCQ_PARAMS),
    dict(kind="orcq", bc=3, sharing_type=2, seed=3),
    dict(kind="wrcq", bc=3, sharing_type=2, seed=6,
         quantizer_params=RCQ_PARAMS),
    dict(kind="nms", sharing_type=2, seed=1, init="nms"),
    dict(kind="rcq", bc=5, bv=8, closed_qdq=True,
         quantizer_params=RCQ_PARAMS),
], ids=["ms", "rcq_bc3_bv8", "orcq_t2", "wrcq_t2", "nms_t2",
        "rcq_bc5_closed"])
def test_fused_layered_matches_jax_f32(kw):
    """B=37 (not a tile multiple: JAX pads to 48 and slices back)."""
    jdec, tdec = _pair(**kw)
    llr = channel_llr(37, tdec.code.n, 2.5, seed=6)
    ref = _jax(jdec, llr)
    out = _port(tdec, llr)
    assert out.bits.dtype == torch.int32 and out.posterior.dtype == \
        torch.float32
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(out.posterior.numpy(),
                               np.asarray(ref.posterior),
                               rtol=1e-6, atol=1e-5)


def test_fused_layered_bf16_bit_agreement():
    """The bench's variant in the bench's storage type."""
    jdec, tdec = _pair(kind="rcq", bc=3, bv=8, quantizer_params=RCQ_PARAMS)
    llr = channel_llr(48, tdec.code.n, 3.0, seed=8)
    ref = _jax(jdec, llr, dtype=jnp.bfloat16)
    out = _port(tdec, llr, dtype=torch.bfloat16)
    assert out.posterior.dtype == torch.bfloat16
    agree = (out.bits.numpy() == np.asarray(ref.bits)).mean()
    assert agree >= 0.9999, agree
    assert (out.success.numpy() == np.asarray(ref.success)).mean() >= 0.999
    # a mixed population makes the success comparison meaningful
    assert 0 < int(out.success.sum()) < 48


def test_lean_equals_full_and_any_batch():
    """lean returns int8 bits and no posterior, equal to the full output;
    a batch decodes the same frames the same way at any size."""
    _, tdec = _pair(kind="rcq", bc=3, bv=8, quantizer_params=RCQ_PARAMS)
    llr = channel_llr(37, tdec.code.n, 2.5, seed=9)
    for dtype in (torch.float32, torch.bfloat16):
        full = _port(tdec, llr, dtype=dtype)
        lean = _port(tdec, llr, dtype=dtype, lean=True)
        assert lean.posterior is None and lean.bits.dtype == torch.int8
        np.testing.assert_array_equal(lean.bits.numpy(), full.bits.numpy())
        np.testing.assert_array_equal(lean.success.numpy(),
                                      full.success.numpy())
        np.testing.assert_array_equal(lean.iterations.numpy(),
                                      np.full(37, T, np.int32))
        part = _port(tdec, llr[:5], dtype=dtype)
        np.testing.assert_array_equal(part.bits.numpy(),
                                      full.bits.numpy()[:5])
        np.testing.assert_array_equal(part.posterior.float().numpy(),
                                      full.posterior.float().numpy()[:5])


def test_closed_qdq_option_equals_spec_flag():
    """closed_qdq given to the wrapper routes the quantizer exactly as the
    spec flag does, and changes the routing of a small LUT."""
    _, plain = _pair(kind="rcq", bc=5, quantizer_params=RCQ_PARAMS)
    _, closed = _pair(kind="rcq", bc=5, quantizer_params=RCQ_PARAMS,
                      closed_qdq=True)
    llr = channel_llr(16, plain.code.n, 2.5, seed=10)
    a = _port(plain, llr, closed_qdq=True)
    b = _port(closed, llr)
    np.testing.assert_array_equal(a.posterior.numpy(), b.posterior.numpy())
    assert qdq_mode(plain.spec.qparams, plain.spec.q_levels) == "staircase"
    assert qdq_mode(plain.spec.qparams, plain.spec.q_levels, True) == "power"


def test_tpu_keys_accepted_and_bad_arguments_refused():
    _, tdec = _pair(kind="ms", factor=0.7)
    llr = channel_llr(4, tdec.code.n, 2.5, seed=11)
    ref = _port(tdec, llr)
    out = _port(tdec, llr, batch_tile=64, natural=True, interpret=False)
    np.testing.assert_array_equal(out.posterior.numpy(),
                                  ref.posterior.numpy())
    with pytest.raises(TypeError):
        _port(tdec, llr, unroll=2)
    with pytest.raises(ValueError, match="dtype"):
        _port(tdec, llr, dtype=torch.float16)
    with pytest.raises(ValueError, match="columns"):
        _port(tdec, llr[:, :-1])
