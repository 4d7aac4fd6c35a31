"""The port's QC engines (``ldpc_tpu_torch.decode.qc_engine``:
``qc_decode_batch`` and ``qc_decode_batch_layered``) against ``ldpc_tpu``'s
XLA engines on shared LLRs and weights, and the ``Decoder`` routes that
reach them.

Tolerances: hard outputs (bits, success, iterations) are exact. f32
posteriors agree to rtol 1e-6 / atol 1e-5, not bit for bit, because
XLA:CPU contracts ``llr + alpha*ext`` and the nms products into FMAs and
turns the uniform quantizer's ``C / M`` into a reciprocal multiply, while
the port rounds every operation as written. bf16 is held to >= 99.99% bit
agreement (bit-exact on these cases) with XLA's excess precision turned
off for the JAX compile, so that both sides round to bf16 where the
source says.

Graphs: a 3x8 protograph at density 0.8 (irregular rows, JAX's per-row CN
path) and a full 5x12 one (row-regular, JAX's row-batched CN path; the
port has one CN implementation for both), lift 16.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu.decode.qc_engine import qc_decode_batch as jax_flooding
from ldpc_tpu.decode.qc_engine import \
    qc_decode_batch_layered as jax_layered
from torch_port_helpers import (SMALL_KINDS, ZOO_LIKE, channel_llr,
                                decoder_pair, make_base)

T = 6
NO_EXCESS = {"xla_allow_excess_precision": False}
GRAPHS = {"irregular": (3, 8, 0.8), "row_regular": (5, 12, 1.0)}


def _pair(graph="irregular", **kw):
    mb, nb, density = GRAPHS[graph]
    return decoder_pair(make_base(mb, nb, 16, seed=0, density=density), 16,
                        T, **kw)


def _jax(fn, jdec, llr, **kw):
    x = jnp.asarray(llr)
    return fn.lower(x, jdec.weights, qc=jdec.qc, spec=jdec.spec,
                    max_iterations=T, **kw).compile(
        compiler_options=NO_EXCESS)(x, jdec.weights)


def _same(out, ref, f32=True):
    if f32:
        np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
        np.testing.assert_array_equal(out.success.numpy(),
                                      np.asarray(ref.success))
        np.testing.assert_allclose(out.posterior.numpy(),
                                   np.asarray(ref.posterior),
                                   rtol=1e-6, atol=1e-5)
    else:
        agree = (out.bits.numpy() == np.asarray(ref.bits)).mean()
        assert agree >= 0.9999, agree
        assert (out.success.numpy() ==
                np.asarray(ref.success)).mean() >= 0.999
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    assert out.bits.dtype == torch.int32


@pytest.mark.parametrize("check_every", [1, 3])
@pytest.mark.parametrize("name", list(SMALL_KINDS))
def test_flooding_matches_jax(name, check_every):
    jdec, tdec = _pair(**SMALL_KINDS[name])
    llr = channel_llr(64, tdec.code.n, 2.5, seed=6)
    ref = _jax(jax_flooding, jdec, llr, check_every=check_every)
    out = lt.qc_decode_batch(torch.from_numpy(llr), tdec.weights,
                             qc=tdec.qc, spec=tdec.spec, max_iterations=T,
                             check_every=check_every)
    assert out.posterior.dtype == torch.float32
    _same(out, ref)


@pytest.mark.parametrize("name", ["ms", "rcq_bc3_bv8", "nms_t2", "orcq_t2"])
def test_flooding_row_regular_matches_jax(name):
    """JAX runs its row-batched CN on a row-regular graph; the port's
    per-row CN gives the same results."""
    jdec, tdec = _pair("row_regular", **SMALL_KINDS[name])
    llr = channel_llr(48, tdec.code.n, 3.0, seed=7)
    ref = _jax(jax_flooding, jdec, llr)
    out = lt.qc_decode_batch(torch.from_numpy(llr), tdec.weights,
                             qc=tdec.qc, spec=tdec.spec, max_iterations=T)
    _same(out, ref)
    assert 0 < int(out.success.sum()) < 48


@pytest.mark.parametrize("graph,check_every", [("irregular", 1),
                                               ("row_regular", 3)])
def test_flooding_bf16_matches_jax(graph, check_every):
    jdec, tdec = _pair(graph, **ZOO_LIKE)
    llr = channel_llr(64, tdec.code.n, 3.0, seed=8)
    ref = _jax(jax_flooding, jdec, llr, check_every=check_every,
               dtype=jnp.bfloat16)
    out = lt.qc_decode_batch(torch.from_numpy(llr), tdec.weights,
                             qc=tdec.qc, spec=tdec.spec, max_iterations=T,
                             check_every=check_every, dtype=torch.bfloat16)
    assert out.posterior.dtype == torch.bfloat16
    _same(out, ref, f32=False)
    assert 0 < int(out.success.sum()) < 64


@pytest.mark.parametrize("name", list(SMALL_KINDS))
def test_layered_matches_jax(name):
    jdec, tdec = _pair(**SMALL_KINDS[name])
    llr = channel_llr(64, tdec.code.n, 2.5, seed=9)
    ref = _jax(jax_layered, jdec, llr)
    out = lt.qc_decode_batch_layered(torch.from_numpy(llr), tdec.weights,
                                     qc=tdec.qc, spec=tdec.spec,
                                     max_iterations=T)
    _same(out, ref)


def test_layered_bf16_matches_jax():
    jdec, tdec = _pair("row_regular", **ZOO_LIKE)
    llr = channel_llr(48, tdec.code.n, 3.0, seed=10)
    ref = _jax(jax_layered, jdec, llr, dtype=jnp.bfloat16)
    out = lt.qc_decode_batch_layered(torch.from_numpy(llr), tdec.weights,
                                     qc=tdec.qc, spec=tdec.spec,
                                     max_iterations=T, dtype=torch.bfloat16)
    _same(out, ref, f32=False)


def test_decoder_routes_match_jax():
    """A non-fused QC decoder runs the engine through ``Decoder.__call__``
    on both packages: flooding with the engine options (and the fused-only
    keys dropped), layered always in f32 whatever its options say."""
    opts = dict(check_every=3, dtype=jnp.float32, unroll=True, lean=True,
                natural=True, closed_qdq=True)
    topts = dict(opts, dtype=torch.float32)
    for layered in (False, True):
        jdec, tdec = _pair(jax_options=opts, torch_options=topts,
                           layered=layered, **SMALL_KINDS["orcq_t2"])
        llr = channel_llr(32, tdec.code.n, 2.5, seed=11)
        ref = jdec(jnp.asarray(llr))
        out = tdec(torch.from_numpy(llr))
        assert out.posterior.dtype == torch.float32
        _same(out, ref)
        one = tdec(torch.from_numpy(llr[5]))
        np.testing.assert_array_equal(one.bits.numpy(), out.bits.numpy()[5])
    # a layered decoder's bf16 option is not passed on: f32 messages
    _, tdec = _pair(torch_options=dict(dtype=torch.bfloat16), layered=True,
                    **SMALL_KINDS["ms"])
    assert tdec(torch.from_numpy(llr)).posterior.dtype == torch.float32


def test_decoder_route_options_and_refusals():
    _, tdec = _pair(**SMALL_KINDS["rcq_bc3_bv8"])
    llr = torch.from_numpy(channel_llr(12, tdec.code.n, 2.5, seed=12))
    args = dict(qc=tdec.qc, spec=tdec.spec, max_iterations=T)
    bf = dataclasses.replace(tdec, qc_options=dict(dtype=torch.bfloat16,
                                                   check_every=2))
    want = lt.qc_decode_batch(llr, tdec.weights, check_every=2,
                              dtype=torch.bfloat16, **args)
    got = bf(llr)
    assert torch.equal(got.posterior, want.posterior)
    assert torch.equal(got.iterations, want.iterations)
    # the TPU kernels' keys are not engine options, as in ldpc_tpu
    tiled = dataclasses.replace(tdec, qc_options=dict(batch_tile=64))
    with pytest.raises(TypeError):
        tiled(llr)
    with pytest.raises(ValueError, match="check_every"):
        lt.qc_decode_batch(llr, tdec.weights, check_every=4, **args)
    with pytest.raises(ValueError, match="dtype"):
        lt.qc_decode_batch(llr, tdec.weights, dtype=torch.float16, **args)
    with pytest.raises(ValueError, match="columns"):
        lt.qc_decode_batch_layered(llr[:, :-1], tdec.weights, **args)
    # a training call drops the storage type and check_every, as in
    # ldpc_tpu: f32 messages and the syndrome every iteration
    for kw in (dict(ste=True), dict(return_trajectory=True)):
        got = bf(llr, **kw)
        want = lt.qc_decode_batch(llr, tdec.weights, **kw, **args)
        assert got.posterior.dtype == torch.float32
        assert torch.equal(got.posterior, want.posterior)
        assert torch.equal(got.iterations, want.iterations)
        assert (got.posteriors_all is None) == ("ste" in kw)
    empty = lt.qc_decode_batch(llr[:0], tdec.weights, **args)
    assert empty.bits.shape == (0, tdec.code.n)
