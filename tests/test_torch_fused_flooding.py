"""The port's fused flooding decode (``ldpc_tpu_torch.decode.fused.
qc_fused_decode_batch``, kernel K4) against the JAX flooding whole-decode
kernel run in interpret mode, and its ``Decoder`` route.

On the CPU the port runs the kernel's plain PyTorch version. Tolerances:
hard outputs (bits, success, iterations) are exact. f32 posteriors agree
to rtol 1e-6 / atol 1e-5, not bit for bit, because XLA:CPU contracts
``llr + alpha*ext`` and the nms products into FMAs and turns the uniform
quantizer's ``C / M`` into a reciprocal multiply, while the port rounds
every operation as written. bf16 is held to >= 99.99% bit agreement with
XLA's excess precision turned off for the JAX compile, so that both sides
round to bf16 where the kernel's source says.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch
from ldpc_tpu_torch.decode import engine, qc_engine
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (SMALL_KINDS, channel_llr, decoder_pair,
                                make_base)

T = 5


def _pair(**kw):
    return decoder_pair(make_base(3, 8, 16, seed=0, density=0.8), 16, T,
                        **kw)


def _jax(jdec, llr, dtype=jnp.float32):
    x = jnp.asarray(llr)
    return qc_fused_decode_batch.lower(
        x, jdec.weights, qc=jdec.qc, spec=jdec.spec, max_iterations=T,
        dtype=dtype, batch_tile=16, interpret=True,
    ).compile(compiler_options={"xla_allow_excess_precision": False})(
        x, jdec.weights)


def _port(tdec, llr, dtype=torch.float32, **kw):
    return lt.qc_fused_decode_batch(
        torch.from_numpy(llr), tdec.weights, qc=tdec.qc, spec=tdec.spec,
        max_iterations=T, dtype=dtype, **kw)


@pytest.mark.parametrize("name", list(SMALL_KINDS))
def test_fused_flooding_matches_jax_f32(name):
    """B=37 (not a tile multiple: JAX pads to 48 and slices back)."""
    jdec, tdec = _pair(**SMALL_KINDS[name])
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


def test_fused_flooding_bf16_bit_agreement():
    """The zoo decoder's variant (W-OMS-RCQ, bc=3, bv=8) in bf16."""
    jdec, tdec = _pair(kind="orcq", bc=3, bv=8, sharing_type=2, seed=3,
                       quantizer_params=((2.0, 1.3), (4.0, 1.3), (6.0, 1.3)),
                       v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0),
                                             (12.0, 1.0)))
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
    a batch decodes the same frames the same way at any size, and an
    empty batch is a valid call."""
    _, tdec = _pair(**SMALL_KINDS["rcq_bc3_bv8"])
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
        for lo, hi in ((0, 5), (5, 6)):
            part = _port(tdec, llr[lo:hi], dtype=dtype)
            np.testing.assert_array_equal(
                part.posterior.float().numpy(),
                full.posterior.float().numpy()[lo:hi])
    assert _port(tdec, llr[:0]).bits.shape == (0, tdec.code.n)


def test_decoder_route_and_check_every():
    """A flooding QC decoder with fused=True decodes through K4's wrapper
    (the plain version here); check_every other than T is refused, T and
    the TPU keys (and unroll) are accepted."""
    opts = dict(fused=True, dtype=torch.float32, batch_tile=64,
                natural=False, interpret=True, unroll=2)
    _, tdec = _pair(torch_options=opts, **SMALL_KINDS["orcq_t2"])
    llr = channel_llr(9, tdec.code.n, 2.5, seed=11)
    out = tdec(torch.from_numpy(llr))
    ref = _port(tdec, llr)
    np.testing.assert_array_equal(out.posterior.numpy(), ref.posterior.numpy())
    one = tdec(torch.from_numpy(llr[3]))
    np.testing.assert_array_equal(one.bits.numpy(), out.bits.numpy()[3])
    same = dataclasses.replace(tdec, qc_options=dict(opts, check_every=T))
    np.testing.assert_array_equal(same(torch.from_numpy(llr)).bits.numpy(),
                                  out.bits.numpy())
    for ce in (1, T - 1, None):
        bad = dataclasses.replace(tdec, qc_options=dict(opts, check_every=ce))
        with pytest.raises(ValueError, match="check_every"):
            bad(torch.from_numpy(llr))


def test_tables_built_once_and_bad_arguments_refused():
    """The spec's device tables are built once per (spec, T, device) and
    reused; a new weight table is gathered afresh on every call."""
    _, tdec = _pair(**SMALL_KINDS["wrcq_t2"])
    llr = channel_llr(4, tdec.code.n, 2.5, seed=12)
    a = engine._spec_tables(tdec.spec, T, tdec.qc.num_blocks, "cpu")
    _port(tdec, llr)
    assert engine._spec_tables(tdec.spec, T, tdec.qc.num_blocks,
                               torch.device("cpu")) is a
    assert qc_engine._graph_tables(tdec.qc, "cpu") is \
        qc_engine._graph_tables(tdec.qc, torch.device("cpu"))
    w2 = {k: (None if w is None else w * 0.5) for k, w in tdec.weights.items()}
    tabs = engine._tables(w2, tdec.spec, T, tdec.qc.num_blocks, "cpu")
    idx = torch.as_tensor(tdec.spec.beta_idx, dtype=torch.int64)
    assert torch.equal(tabs["beta"], w2["beta"][:, idx])
    with pytest.raises(TypeError):
        _port(tdec, llr, unroll=2)
    with pytest.raises(ValueError, match="dtype"):
        _port(tdec, llr, dtype=torch.float16)
    with pytest.raises(ValueError, match="columns"):
        _port(tdec, llr[:, :-1])
