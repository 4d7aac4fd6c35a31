"""The port's host-side code model, decoder specs and quantizers against
the JAX package: graph and spec arrays equal, quantize-dequantize forms
bit for bit on random inputs and on knife edges.

Not compared: subnormal inputs (XLA:CPU flushes them to zero before a
compare, torch does not), and ``power_qdq`` with a float32-array gamma of
exactly 2.0, where XLA:CPU's ``pow`` is not the correctly rounded square
that torch computes."""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu_torch as lt
from ldpc_tpu import quantizer as jq
from ldpc_tpu.decode.qc_engine import build_qc_graph as jax_build_qc_graph
from ldpc_tpu_torch import quantizer as tq
from torch_port_helpers import assert_same_fields as _assert_same_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_BASE = np.random.default_rng(0).integers(0, 256, size=(5, 37))


@pytest.mark.parametrize("source", ["bench"] + sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "codes",
                                                        "*.proto"))))
def test_graphs_equal(source):
    if source == "bench":
        base, lift = BENCH_BASE, 256
    else:
        path = os.path.join(REPO, "codes", source)
        base, lift = lt.load_protograph(path)
        jbase, jlift = ldpc_tpu.load_protograph(path)
        np.testing.assert_array_equal(base, jbase)
        assert lift == jlift
    _assert_same_fields(lt.build_qc_graph(base, lift),
                        jax_build_qc_graph(base, lift))
    tcode = lt.create_qc_code(base, lift=lift, max_iterations=6)
    jcode = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=6)
    np.testing.assert_array_equal(tcode.H, jcode.H)
    assert (tcode.n, tcode.k, tcode.m) == (jcode.n, jcode.k, jcode.m)
    _assert_same_fields(lt.build_graph(tcode), ldpc_tpu.build_graph(jcode))


@pytest.mark.parametrize("kw", [
    dict(kind="rcq", bc=3, bv=8,
         quantizer_params=((2.6474, 1.3), (3.0869, 1.3), (5.3767, 1.3)),
         v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
         layered=True, qc_options=dict(fused=True, lean=True)),
    dict(kind="orcq", bc=3, bv=6, sharing_type=2, seed=3),
    dict(kind="wrcq", bc=4, sharing_type=2, seed=6, init="nms",
         closed_qdq=True),
    dict(kind="nms", sharing_type=1, layered=True, per_layer=True),
    dict(kind="ms", factor=0.5),
], ids=["bench_rcq", "orcq_t2", "wrcq_t2_closed", "nms_t1_perlayer", "ms"])
def test_decoder_specs_equal(kw):
    base = BENCH_BASE[:3, :8] % 32
    T = 6
    jdec = ldpc_tpu.make_decoder(
        ldpc_tpu.create_qc_code(base, lift=32, max_iterations=T),
        qc=jax_build_qc_graph(base, 32), **kw)
    tdec = lt.make_decoder(lt.create_qc_code(base, lift=32, max_iterations=T),
                           qc=lt.build_qc_graph(base, 32), device="cpu",
                           **kw)
    _assert_same_fields(tdec.spec, jdec.spec)
    assert tdec.name == jdec.name and tdec.recipe == jdec.recipe
    assert tdec.max_iterations == jdec.max_iterations == T
    assert tdec.param_count() == jdec.param_count()
    for k, w in jdec.weights.items():
        tw = tdec.weights[k]
        assert (tw is None) == (w is None)
        if w is not None:
            assert tuple(tw.shape) == w.shape and tw.dtype == torch.float32
    # the same holds after truncation (the early exit's stage 1)
    j3, t3 = (dataclasses.replace(d, qc_options=None).truncated(3)
              for d in (jdec, tdec))
    _assert_same_fields(t3.spec, j3.spec)


def test_general_layers_and_constructors_equal(test_code):
    tcode = lt.create_test_ldpc_code()
    np.testing.assert_array_equal(tcode.H, test_code.H)
    for ctor in ("basic_min_sum", "neural_min_sum", "neural_offset_min_sum",
                 "neural_2d_min_sum", "neural_2d_offset_min_sum",
                 "rcq_min_sum", "weighted_rcq", "weighted_oms_rcq"):
        j = getattr(ldpc_tpu, ctor)(test_code, max_iterations=10,
                                    layered=True)
        t = getattr(lt, ctor)(tcode, max_iterations=10, layered=True,
                              device="cpu")
        _assert_same_fields(t.spec, j.spec)
        np.testing.assert_array_equal(t.layer_checks, j.layer_checks)
        assert t.param_count() == j.param_count() and t.name == j.name
    # the reference's parameter goldens (N-NMS / 2D types 1-4, T=10)
    counts = [lt.neural_min_sum(tcode, max_iterations=10,
                                device="cpu").param_count()] + [
        lt.neural_2d_min_sum(tcode, st, max_iterations=10,
                             device="cpu").param_count()
        for st in (1, 2, 3, 4)]
    assert counts == [130, 40, 40, 20, 20]


def test_weights_from_numpy_roundtrip():
    w = {"beta": np.arange(6, dtype=np.float64).reshape(2, 3), "alpha": None}
    t = lt.weights_from_numpy(w, device="cpu")
    assert t["alpha"] is None and t["beta"].dtype == torch.float32
    assert t["beta"].device == torch.device("cpu")
    np.testing.assert_array_equal(t["beta"].numpy(), w["beta"])


def test_weights_from_numpy_defaults_to_the_card(monkeypatch):
    """Like make_decoder, the default device is the card: without one the
    call raises instead of leaving the weights on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.weights_from_numpy({"beta": np.ones((2, 3)), "alpha": None})


def _bits_equal(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _inputs(thr, C, seed, n=4000):
    """Random inputs plus knife edges: exact thresholds (both signs), one
    ulp either side, +-0.0, beyond C, and around the 1e-30 floor."""
    rng = np.random.default_rng(seed)
    pos = thr[1:]
    return np.concatenate([
        rng.normal(0, C, n), thr, -thr,
        np.nextafter(pos, np.inf), np.nextafter(pos, -np.inf),
        -np.nextafter(pos, np.inf), -np.nextafter(pos, -np.inf),
        [0.0, -0.0, C, -C, 1.5 * C, -1.5 * C, 2 * C, -2 * C, 1e-9, -1e-9,
         1e-30, -1e-30, 1e-31, -1e-31],
    ]).astype(np.float32)


def test_stacked_tables_equal():
    qp = [(3.0, 1.3), (5.0, 1.3), (7.0, 1.3)]
    for T in (1, 6, 10):
        for nq in (1, 2, 3, 5):
            np.testing.assert_array_equal(tq.phase_schedule(T, nq),
                                          jq.phase_schedule(T, nq))
        np.testing.assert_array_equal(
            tq.stack_quantizer_thresholds(3, qp, T),
            jq.stack_quantizer_thresholds(3, qp, T))
        np.testing.assert_array_equal(tq.stack_quantizer_params(qp, T),
                                      jq.stack_quantizer_params(qp, T))
    np.testing.assert_array_equal(tq.power_thresholds(5, 10.0, 2.0),
                                  jq.power_thresholds(5, 10.0, 2.0))
    assert tq.QDQ_SIGN_TINY == jq.QDQ_SIGN_TINY


@pytest.mark.parametrize("bc,C,gamma", [(2, 2.0, 1.0), (3, 5.0, 1.3),
                                        (4, 7.0, 1.5), (5, 10.0, 2.0)])
def test_staircase_qdq_bit_exact(bc, C, gamma):
    thr = jq.power_thresholds(bc, C, gamma)
    x = _inputs(thr, C, seed=bc)
    _bits_equal(tq.staircase_qdq(torch.from_numpy(x), torch.from_numpy(thr)),
                jq.staircase_qdq(jnp.asarray(x), jnp.asarray(thr)))
    # inclusive compare: a magnitude equal to a threshold snaps to it
    out = tq.staircase_qdq(torch.from_numpy(thr[1:]), torch.from_numpy(thr))
    np.testing.assert_allclose(out.numpy(), thr[1:], rtol=1e-6)


@pytest.mark.parametrize("bv,C", [(8, 10.0), (6, 4.0), (5, 1.5), (8, 12.0)])
def test_uniform_qdq_bit_exact(bv, C):
    levels = 2 ** (bv - 1)
    thr = jq.power_thresholds(bv, C, 1.0)
    x = _inputs(thr, C, seed=bv)
    for c in (C, np.float32(C)):
        _bits_equal(tq.uniform_qdq(torch.from_numpy(x), c, levels),
                    jq.uniform_qdq(jnp.asarray(x), c, levels))
    # a float32 tensor parameter, as the decoders pass it
    _bits_equal(tq.uniform_qdq(torch.from_numpy(x), torch.tensor(C), levels),
                jq.uniform_qdq(jnp.asarray(x), np.float32(C), levels))


@pytest.mark.parametrize("bc,C,gamma", [(3, 5.0, 1.3), (3, 3.0, 1.3),
                                        (4, 7.0, 1.5), (5, 3.0, 1.3),
                                        (8, 10.0, 1.3), (8, 14.0, 2.0)])
def test_power_qdq_bit_exact(bc, C, gamma):
    levels = 2 ** (bc - 1)
    thr = jq.power_thresholds(bc, C, gamma)
    x = _inputs(thr, C, seed=bc + 10)
    _bits_equal(tq.power_qdq(torch.from_numpy(x), C, gamma, levels),
                jq.power_qdq(jnp.asarray(x), C, gamma, levels))
    if gamma != 2.0:
        _bits_equal(tq.power_qdq(torch.from_numpy(x), torch.tensor(C),
                                 torch.tensor(gamma), levels),
                    jq.power_qdq(jnp.asarray(x), np.float32(C),
                                 np.float32(gamma), levels))
