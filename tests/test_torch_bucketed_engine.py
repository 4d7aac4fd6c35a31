"""The port's degree-bucketed engine (``ldpc_tpu_torch.decode.
bucketed_engine``) against ``ldpc_tpu``'s on shared LLRs and weights, and
against the port's general flooding engine; the bucketed ``Decoder``
route, the zoo round trip of a bucketed decoder, and the simulator's
compacting wave over general and bucketed decoders.

Tolerances: against ``ldpc_tpu`` hard outputs are exact and f32
posteriors agree to rtol 1e-6 / atol 1e-5 (XLA:CPU's FMA contraction and
reciprocal division; see ``test_torch_general_engine.py``). bf16 message
state is held to >= 99.99% bit agreement with XLA's excess precision
turned off for the JAX compile, so that both round the state to bf16
where the source says. The port's bucketed and general engines add each
node's messages one by one in slot order, so in f32 they agree exactly.

Code: a small PBRL-like code (k=96, rate 1/3: check degrees 2-6,
variable degrees 1-13), the family this engine exists for.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu.decode.bucketed_engine import \
    bucketed_decode_batch as jax_bucketed
from ldpc_tpu.decode.bucketed_engine import \
    build_bucketed_graph as jax_build_bucketed_graph
from ldpc_tpu_torch.sim.montecarlo import _build_wave
from torch_port_helpers import assert_same_fields, channel_llr, general_pair

T = 8
NO_EXCESS = {"xla_allow_excess_precision": False}
QP = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
PBRL = ("create_pbrl_like_code", dict(k=96, rate=1 / 3))
KINDS = {
    "ms": dict(kind="ms", factor=0.7),
    "nms_t0": dict(kind="nms", sharing_type=0, seed=1),
    "nms_t2": dict(kind="nms", sharing_type=2, seed=2, init="nms"),
    "oms_t1": dict(kind="oms", sharing_type=1, seed=3),
    "rcq_bv8": dict(kind="rcq", bc=3, bv=8, quantizer_params=QP,
                    v2c_quantizer_params=VQP),
    "wrcq_t2": dict(kind="wrcq", bc=4, sharing_type=2, seed=4, init="nms"),
    "orcq_t3_bv8": dict(kind="orcq", bc=3, bv=8, sharing_type=3, seed=5,
                        quantizer_params=QP, v2c_quantizer_params=VQP),
}


def _pair(name, **kw):
    return general_pair(*PBRL, T, **KINDS[name], **kw)


def _jax(jdec, llr, **kw):
    x = jnp.asarray(llr)
    args = dict(bg=jax_build_bucketed_graph(jdec.graph), spec=jdec.spec,
                max_iterations=jdec.max_iterations, **kw)
    return jax_bucketed.lower(x, jdec.weights, **args).compile(
        compiler_options=NO_EXCESS)(x, jdec.weights)


def _port(tdec, llr, **kw):
    return lt.bucketed_decode_batch(
        torch.from_numpy(llr), tdec.weights,
        bg=lt.build_bucketed_graph(tdec.graph), spec=tdec.spec,
        max_iterations=tdec.max_iterations, **kw)


def _hard_equal(out, ref):
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))


def test_bucketed_graph_fields_equal_jax():
    jdec, tdec = _pair("ms")
    bg = lt.build_bucketed_graph(tdec.graph)
    assert_same_fields(bg, jax_build_bucketed_graph(jdec.graph))
    assert [d for d, _, _ in bg.cn_buckets] == [2, 3, 4, 5, 6]
    assert [d for d, _, _ in bg.vn_buckets][0] == 1


@pytest.mark.parametrize("name", list(KINDS))
def test_f32_matches_jax_and_general_engine(name):
    jdec, tdec = _pair(name)
    llr = channel_llr(48, tdec.code.n, 1.5, seed=11)
    out = _port(tdec, llr)
    ref = _jax(jdec, llr)
    _hard_equal(out, ref)
    np.testing.assert_allclose(out.posterior.numpy(),
                               np.asarray(ref.posterior),
                               rtol=1e-6, atol=1e-5)
    gen = tdec(torch.from_numpy(llr))  # the general flooding engine
    for k in ("bits", "posterior", "iterations", "success"):
        assert torch.equal(getattr(out, k), getattr(gen, k)), k


@pytest.mark.parametrize("name", ["nms_t2", "rcq_bv8", "orcq_t3_bv8"])
def test_bf16_state_matches_jax(name):
    """bf16 message state: rounded at the two permutations only."""
    jdec, tdec = _pair(name)
    llr = channel_llr(48, tdec.code.n, 1.5, seed=12)
    out = _port(tdec, llr, dtype=torch.bfloat16)
    ref = _jax(jdec, llr, dtype=jnp.bfloat16)
    agree = (out.bits.numpy() == np.asarray(ref.bits)).mean()
    assert agree >= 0.9999, agree
    assert (out.success.numpy() == np.asarray(ref.success)).mean() >= 0.99
    assert out.posterior.dtype == torch.float32
    f32 = _port(tdec, llr)
    assert (out.bits == f32.bits).float().mean() > 0.99


@pytest.mark.parametrize("check_every", [2, 4])
def test_check_every_matches_jax(check_every):
    """The syndrome is checked (and outputs frozen) every ``check_every``
    iterations: iterations lie in {k, 2k, ..., T}."""
    jdec, tdec = _pair("rcq_bv8")
    llr = channel_llr(48, tdec.code.n, 1.5, seed=13)
    out = _port(tdec, llr, check_every=check_every)
    _hard_equal(out, _jax(jdec, llr, check_every=check_every))
    assert set(out.iterations.tolist()) <= set(
        range(check_every, T + 1, check_every))
    assert 0 < int(out.success.sum()) < 48
    with pytest.raises(ValueError, match="check_every"):
        _port(tdec, llr, check_every=3)
    with pytest.raises(ValueError, match="dtype"):
        _port(tdec, llr, dtype=torch.float16)


def test_decoder_bucketed_route():
    """``make_decoder(bucketed=True)`` builds the layouts and decodes
    through them with ``qc_options``' dtype and check_every, on the CPU
    when asked; bucketed with layered or qc is refused."""
    _, tdec = _pair("rcq_bv8")
    _, bdec = _pair("rcq_bv8", bucketed=True,
                    torch_options={"dtype": torch.bfloat16,
                                   "check_every": 2})
    assert isinstance(bdec.bucketed_graph, lt.BucketedGraph)
    assert bdec.recipe["bucketed"] and tdec.bucketed_graph is None
    assert_same_fields(bdec.bucketed_graph,
                       lt.build_bucketed_graph(tdec.graph))
    llr = channel_llr(16, tdec.code.n, 1.5, seed=14)
    out = bdec(torch.from_numpy(llr))
    want = _port(tdec, llr, dtype=torch.bfloat16, check_every=2)
    for k in ("bits", "posterior", "iterations", "success"):
        assert torch.equal(getattr(out, k), getattr(want, k)), k
    code = tdec.code
    with pytest.raises(ValueError, match="bucketed"):
        lt.make_decoder(code, kind="ms", bucketed=True, layered=True,
                        device="cpu")
    base = np.array([[0, 1, 2], [2, 0, 1]])
    with pytest.raises(ValueError, match="bucketed"):
        lt.make_decoder(lt.create_qc_code(base, lift=4), kind="ms",
                        bucketed=True, qc=lt.build_qc_graph(base, 4),
                        device="cpu")


def test_zoo_round_trip_of_bucketed_decoder(tmp_path):
    """A non-QC bucketed decoder saves as alist + recipe and loads with
    ``bucketed`` kept, in the port and in ``ldpc_tpu``."""
    from ldpc_tpu import zoo as jzoo
    _, tdec = _pair("orcq_t3_bv8", bucketed=True)
    path = str(tmp_path / "pbrl96")
    lt.save_pretrained(path, tdec, meta={"note": "test"})
    back = lt.load_pretrained(path, device="cpu",
                              qc_options={"check_every": 4})
    assert back.qc is None and back.bucketed_graph is not None
    assert back.recipe == tdec.recipe
    np.testing.assert_array_equal(back.code.H, tdec.code.H)
    for k, w in tdec.weights.items():
        assert (w is None and back.weights[k] is None) or torch.equal(
            w, back.weights[k])
    llr = torch.from_numpy(channel_llr(16, tdec.code.n, 1.5, seed=15))
    assert torch.equal(back(llr).bits,
                       dataclasses.replace(tdec, qc_options={
                           "check_every": 4})(llr).bits)
    j = jzoo.load_pretrained(path)
    assert j.bucketed_graph is not None and j.recipe == tdec.recipe


@pytest.mark.parametrize("route", ["general", "bucketed", "layered"])
def test_compacting_wave_over_non_qc_decoder(route):
    """The simulator's compacting wave over a general, bucketed (with
    check_every) or layered decoder, stage 1 truncated: the plain wave's
    counts exactly, compacted and on overflow."""
    kw = {"general": {}, "layered": dict(layered=True),
          "bucketed": dict(bucketed=True,
                           torch_options={"check_every": 2})}[route]
    _, dec = _pair("rcq_bv8", **kw)
    cfg = dict(wave_size=96, device="cpu")
    plain = _build_wave(dec, lt.SimulationConfig(**cfg))
    comp = _build_wave(dec, lt.SimulationConfig(
        **cfg, early_exit_iters=3, survivor_budget=48))
    assert comp.t1 == (4 if route == "bucketed" else 3)
    llr = plain.llr(torch.Generator().manual_seed(3), 4.0)
    assert comp.counts(llr) == plain.counts(llr)
    llr = plain.llr(torch.Generator().manual_seed(4), 0.0)
    assert comp.counts(llr) == plain.counts(llr)
    assert dict(comp.kinds) == {"compacted": 1, "fallback": 1}
    with pytest.raises(ValueError, match="QC"):
        _build_wave(dec, lt.SimulationConfig(
            **cfg, early_exit_iters=2, stage1_fused=True))
