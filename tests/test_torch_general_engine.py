"""The port's general engines (``ldpc_tpu_torch.decode.engine``:
``decode_batch`` and ``decode_batch_layered``) against ``ldpc_tpu``'s on
shared LLRs and weights, the port's copy of the numpy oracle against
``ldpc_tpu``'s, and the port's engine against that oracle.

Tolerances: hard outputs (bits, success, iterations) are exact. Float32
posteriors agree to rtol 1e-6 / atol 1e-5, not bit for bit: XLA:CPU
contracts ``llr + alpha*ext`` and the nms products into FMAs and turns
the uniform quantizer's ``C / M`` into a reciprocal multiply, while the
port rounds every operation as written. Against the float64 oracle the
engine is held to the reference's atol 1e-4.

Codes: a small PBRL-like code (k=96, rate 1/3: check degrees 2-6,
variable degrees 1-13, as the full-width family), the mid-size PEG code
of ``tests/conftest.py`` and the (7, 4) test code; one case at the full
width of PBRL (3096, 1032).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu.decode.oracle import oracle_decode as jax_oracle
from ldpc_tpu_torch.decode.oracle import oracle_decode
from ldpc_tpu_torch.quantizer import (QDQ_SIGN_TINY, phase_schedule,
                                      power_thresholds)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import channel_llr, general_pair

T = 8
QP = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
PBRL = ("create_pbrl_like_code", dict(k=96, rate=1 / 3))
PEG = ("create_peg_code", dict(n=128, m=64, dv=3, seed=1))
# every kind, with per-edge (type 0) weights for nms/oms and bv=8 on the
# quantized kinds
KINDS = {
    "ms": dict(kind="ms", factor=0.7),
    "nms_t0": dict(kind="nms", sharing_type=0, seed=1),
    "oms_t0": dict(kind="oms", sharing_type=0, seed=2),
    "nms_t1": dict(kind="nms", sharing_type=1, init="nms", seed=3),
    "oms_t2": dict(kind="oms", sharing_type=2, seed=4),
    "rcq_bv8": dict(kind="rcq", bc=3, bv=8, quantizer_params=QP,
                    v2c_quantizer_params=VQP),
    "wrcq_t2_bv8": dict(kind="wrcq", bc=3, bv=8, sharing_type=2,
                        init="nms", seed=5, quantizer_params=QP),
    "orcq_t3_bv8": dict(kind="orcq", bc=3, bv=8, sharing_type=3, seed=6,
                        quantizer_params=QP, v2c_quantizer_params=VQP),
}


def _same(out, ref):
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(out.posterior.numpy(),
                               np.asarray(ref.posterior),
                               rtol=1e-6, atol=1e-5)
    assert out.bits.dtype == torch.int32
    assert out.posterior.dtype == torch.float32


def _both(jdec, tdec, llr):
    return jdec(jnp.asarray(llr)), tdec(torch.from_numpy(llr))


@pytest.mark.parametrize("code", ["pbrl", "peg"])
@pytest.mark.parametrize("name", list(KINDS))
def test_flooding_matches_jax(name, code):
    jdec, tdec = general_pair(*(PBRL if code == "pbrl" else PEG), T,
                              **KINDS[name])
    llr = channel_llr(48, tdec.code.n, 1.5 if code == "pbrl" else 2.0,
                      seed=3)
    ref, out = _both(jdec, tdec, llr)
    _same(out, ref)


@pytest.mark.parametrize("num_layers", [None, 4], ids=["greedy", "collide"])
@pytest.mark.parametrize("name", list(KINDS))
def test_layered_matches_jax(name, num_layers):
    """``num_layers=4`` forces checks that share variables into one layer
    (the greedy layering of this code has 12), so the layer's column-sum update adds
    several differences to one variable."""
    jdec, tdec = general_pair(*PBRL, T, layered=True, num_layers=num_layers,
                              **KINDS[name])
    np.testing.assert_array_equal(tdec.layer_checks, jdec.layer_checks)
    if num_layers is not None:
        assert len(tdec.layer_checks) == num_layers
    llr = channel_llr(48, tdec.code.n, 1.5, seed=4)
    ref, out = _both(jdec, tdec, llr)
    _same(out, ref)


def _np_qdq(bc, quantizer_params, T_):
    sched = phase_schedule(T_, len(quantizer_params))
    luts = [power_thresholds(bc, C, g) for C, g in quantizer_params]

    def qdq(x, t):
        thr = luts[sched[t]]
        idx = np.maximum((np.abs(x)[..., None] >= thr).sum(-1) - 1, 0)
        return (np.where(x < 0, -1.0, 1.0)
                * np.maximum(thr[idx], QDQ_SIGN_TINY))

    return qdq


def _oracle_case(case, dec):
    """The oracle's arguments for a decoder of ``case``."""
    g = dec.graph
    w = {k: (None if v is None else v.numpy()) for k, v in
         dec.weights.items()}
    edge_of = {(int(g.edge_check[e]), int(g.edge_var[e])): e
               for e in range(g.num_edges)}
    dcs, dvs = g.unique_dc, g.unique_dv
    if case == "nms_t0":
        return dict(beta_fn=lambda t, i, j: float(
            w["beta"][t, edge_of[(i, j)]]))
    if case == "oms_t0":
        return dict(transform="oms", alpha_in_cn=True,
                    beta_fn=lambda t, i, j: float(
                        w["beta"][t, edge_of[(i, j)]]),
                    alpha_fn=lambda t, i, j: 0.0)
    if case == "nms_t2":
        return dict(
            beta_fn=lambda t, i, j: float(w["beta"][
                t, dcs.index(int(g.check_degree[i]))]),
            alpha_fn=lambda t, i, j: float(w["alpha"][
                t, dvs.index(int(g.var_degree[j]))]))
    if case == "rcq":
        return dict(transform="rcq", qdq=_np_qdq(3, QP, dec.max_iterations))
    # orcq, sharing type 2, bc=4 with a bv=6 V2C quantizer
    return dict(
        transform="orcq", alpha_in_cn=True,
        beta_fn=lambda t, i, j: float(w["beta"][
            t, dcs.index(int(g.check_degree[i]))]),
        alpha_fn=lambda t, i, j: float(w["alpha"][
            t, dvs.index(int(g.var_degree[j]))]),
        qdq=_np_qdq(4, QP, dec.max_iterations),
        quantize_v2c=_np_qdq(6, [(2 * C, gm) for C, gm in QP],
                             dec.max_iterations))


ORACLE_CASES = {
    "nms_t0": dict(kind="nms", sharing_type=0, seed=3),
    "oms_t0": dict(kind="oms", sharing_type=0, seed=4),
    "nms_t2": dict(kind="nms", sharing_type=2, init="nms", seed=5),
    "rcq": dict(kind="rcq", bc=3, quantizer_params=QP),
    "orcq_bv6": dict(kind="orcq", bc=4, bv=6, sharing_type=2, seed=10,
                     quantizer_params=QP),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_engine_matches_oracle(case):
    """The port's flooding engine against the port's oracle (the
    reference's atol 1e-4), and the port's oracle copy against
    ``ldpc_tpu``'s, on the (7, 4) code."""
    code = lt.create_test_ldpc_code()
    dec = lt.make_decoder(code, device="cpu", **ORACLE_CASES[case])
    llr = np.random.default_rng(7).normal(0, 2.0, (12, code.n)).astype(
        np.float32)
    out = dec(torch.from_numpy(llr))
    kw = _oracle_case(case, dec)
    for b in range(llr.shape[0]):
        bits, post, iters, ok = oracle_decode(code.H, llr[b],
                                              dec.max_iterations, **kw)
        jbits, jpost, jiters, jok = jax_oracle(code.H, llr[b],
                                               dec.max_iterations, **kw)
        np.testing.assert_array_equal(bits, jbits)
        np.testing.assert_array_equal(post, jpost)
        assert (iters, ok) == (jiters, jok)
        np.testing.assert_array_equal(out.bits[b].numpy(), bits)
        np.testing.assert_allclose(out.posterior[b].numpy(), post,
                                   atol=1e-4)
        assert int(out.iterations[b]) == iters
        assert bool(out.success[b]) == ok


@pytest.mark.parametrize("layered", [False, True], ids=["flooding",
                                                         "layered"])
def test_nan_frame_decodes_to_zero_with_success(layered):
    """A NaN frame's posterior is NaN, so its bits are 0 and its syndrome
    passes at iteration 1 ("NaN LLRs decode to all-zero with
    success=True"); a frame with some NaN LLRs decodes as in ``ldpc_tpu``,
    whose ``jnp.min``/``jnp.argmin`` take a NaN as the minimum; the other
    frames decode as alone."""
    jdec, tdec = general_pair(*PBRL, T, layered=layered,
                              **KINDS["rcq_bv8"])
    llr = channel_llr(6, tdec.code.n, 1.5, seed=5)
    llr[2] = np.nan
    llr[4, :17] = np.nan
    ref, out = _both(jdec, tdec, llr)
    assert bool(out.success[2]) and int(out.iterations[2]) == 1
    assert not out.bits[2].any()
    post = out.posterior.numpy()
    np.testing.assert_array_equal(np.isnan(post),
                                  np.isnan(np.asarray(ref.posterior)))
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    alone = tdec(torch.from_numpy(llr[[0, 1, 3, 5]]))
    assert torch.equal(alone.posterior, out.posterior[[0, 1, 3, 5]])


def test_single_vector_call_and_routes():
    """[n] LLRs decode as one frame on every non-QC route, the training
    calls too: their trajectory is [T, n]."""
    code = lt.create_test_ldpc_code()
    for kw in (dict(), dict(layered=True), dict(bucketed=True)):
        dec = lt.basic_min_sum(code, device="cpu", **kw)
        out = dec(torch.full((7,), 5.0))
        assert out.bits.shape == (7,) and bool(out.success)
        bits, success, iters = dec.decode(torch.full((7,), 5.0))
        assert bits.shape == (7,) and bool(success) and int(iters) == 1
        for call in (dict(ste=True), dict(return_trajectory=True)):
            got = dec(torch.full((7,), 5.0), **call)
            assert torch.equal(got.bits, out.bits)
            traj = got.posteriors_all
            assert (traj is None if "ste" in call else
                    traj.shape == (dec.max_iterations, 7))


def test_pbrl_full_width_matches_jax():
    """PBRL (3096, 1032): n=3096, m=2064, E=9287, the configuration of
    ``experiments/throughput_matrix.py`` (RCQ bc=3, bv=8, T=10) at
    1.2 dB, B=64."""
    jdec, tdec = general_pair("create_pbrl_like_code",
                              dict(k=1032, rate=1 / 3), 10,
                              **KINDS["rcq_bv8"])
    g = tdec.graph
    assert (g.n, g.m, g.num_edges) == (3096, 2064, 9287)
    assert g.unique_dc == (2, 3, 4, 5, 6) and g.max_dv == 13
    llr = channel_llr(64, g.n, 1.2, seed=8)
    ref, out = _both(jdec, tdec, llr)
    _same(out, ref)
    assert 0 < int(out.success.sum()) < 64
