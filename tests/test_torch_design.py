"""The port's design tools (``ldpc_tpu_torch.design``, numpy copies)
against ``ldpc_tpu.design`` on the same inputs.

The copies are deterministic numpy, so every result must be equal:
density-evolution arrays with ``assert_array_equal``, designed ladders and
thresholds with ``==``, trapping-set reports set for set. The sizes are
the JAX tests' small ones; the designer runs on ``examples.py``'s 4x16
base with a short schedule and a coarse grid (the full bench design is
held to the JAX package's numbers on the card by ``chip_smoke.py``
phase 12)."""

import dataclasses

import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu.design as jd
import ldpc_tpu_torch as lt
import ldpc_tpu_torch.design as td
from torch_port_helpers import (one_torch_thread,  # noqa: F401 (autouse)
                                ZOO_LIKE, decoder_pair, make_base)

RCQ = dict(kind="rcq", bc=3,
           quantizer_params=((2.0, 1.3), (4.0, 1.3), (6.0, 1.3)),
           bv=8, v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)))
QP0 = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))
VQP0 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))


def _equal_de(a, b):
    """Two DEResults hold equal arrays and fields."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _small_base(seed=0):
    return np.random.default_rng(seed).integers(0, 64, size=(3, 10))


@pytest.mark.parametrize("case", [
    dict(profile="reg36", snr_db=1.75, max_iterations=20, kind="ms",
         beta=1.0, grid_max=80.0),
    dict(profile="bench", snr_db=6.0, max_iterations=6, **RCQ),
    dict(profile="bench", snr_db=6.0, max_iterations=6, kind="orcq", bc=3,
         beta=0.25, quantizer_params=QP0),
], ids=["ms_reg36", "rcq_bv8_bench", "orcq_bench"])
def test_density_evolution_equal(case):
    case = dict(case)
    name = case.pop("profile")

    def profile(mod):
        if name == "reg36":
            return mod.DegreeProfile(rho=((6, 1.0),), lam=((3, 1.0),),
                                     var_nodes=((3, 1.0),))
        base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
        return mod.degree_profile_from_base(base)

    assert dataclasses.astuple(profile(jd)) == \
        dataclasses.astuple(profile(td))
    _equal_de(td.density_evolution(profile(td), **case),
              jd.density_evolution(profile(jd), **case))


@pytest.mark.parametrize("schedule,punctured", [
    ("layered", ()), ("flooding", ()), ("layered", (0,))])
def test_protograph_density_evolution_equal(schedule, punctured):
    kw = dict(snr_db=4.0, max_iterations=6, schedule=schedule,
              punctured_cols=punctured, **RCQ)
    base = _small_base()
    _equal_de(td.protograph_density_evolution(base, **kw),
              jd.protograph_density_evolution(base, **kw))


def test_design_rcq_ladders_equal():
    """``examples.py:272``'s base and designer call, cut to T=4 without a
    V2C ladder on a 1/16 grid (the full call takes ~30 s a package)."""
    base = np.random.default_rng(0).integers(0, 64, size=(4, 16))
    kw = dict(bc=3, bv=None, max_iterations=4, snr_db=5.0, phases=3,
              passes=0, grid_step=1.0 / 16.0)
    qp, vqp, res = td.design_rcq_ladders(td.degree_profile_from_base(base),
                                         **kw)
    jqp, jvqp, jres = jd.design_rcq_ladders(
        jd.degree_profile_from_base(base), **kw)
    assert (qp, vqp, res.threshold_db) == (jqp, jvqp, jres.threshold_db)
    _equal_de(res, jres)


def test_estimate_threshold_and_iterate_refine_equal():
    base = _small_base()
    kw = dict(bc=3, bv=8, max_iterations=4, grid_step=1.0 / 16.0)
    assert td.estimate_threshold(base, QP0, VQP0, **kw) == \
        jd.estimate_threshold(base, QP0, VQP0, **kw)
    kw.update(snr_db=None, max_passes=2, sweep=(0.5, 2.0), gammas=None)
    hist = td.iterate_refine(base, QP0, VQP0, **kw)
    jhist = jd.iterate_refine(base, QP0, VQP0, **kw)
    assert hist.to_dict() == jhist.to_dict()
    # the first pass moved the ladder: the refinement itself is compared
    assert hist.passes[1].cn != hist.passes[0].cn


def test_refine_and_dynamic_designers_equal():
    base = _small_base()
    kw = dict(bc=3, bv=8, max_iterations=4, snr_db=4.0, sweep=(1.1,),
              grid_step=1.0 / 16.0)
    assert td.refine_ladders_protograph(base, QP0, VQP0, **kw) == \
        jd.refine_ladders_protograph(base, QP0, VQP0, **kw)
    kw = dict(snr_db=3.2, max_iterations=4, bc=4, bv=8,
              v2c_quantizer_params=VQP0, init_params=QP0, passes=1,
              C_factors=(1.25,), gammas=(1.3,))
    base = np.random.default_rng(1).integers(0, 16, size=(3, 10))
    ps, res = td.design_dynamic_quantizers(base, **kw)
    jps, jres = jd.design_dynamic_quantizers(base, **kw)
    assert ps == jps
    _equal_de(res, jres)


@pytest.mark.parametrize("n,m,seed,a_max", [(96, 48, 1, 6), (48, 24, 2, 4)])
def test_trapping_sets_equal_set_for_set(n, m, seed, a_max):
    H = ldpc_tpu.create_peg_code(n=n, m=m, dv=3, seed=seed,
                                 max_iterations=10).H
    np.testing.assert_array_equal(
        lt.create_peg_code(n=n, m=m, dv=3, seed=seed, max_iterations=10).H,
        H)
    for kw in (dict(a_max=a_max, b_max=3, restarts=2),
               dict(a_max=a_max, b_max=2, restarts=3, seed=5, max_sets=7)):
        rep = td.find_trapping_sets(H, **kw)
        jrep = jd.find_trapping_sets(H, **kw)
        assert [dataclasses.astuple(s) for s in rep.sets] == \
            [dataclasses.astuple(s) for s in jrep.sets]
        assert (rep.spectrum, rep.counts, rep.summary()) == \
            (jrep.spectrum, jrep.counts, jrep.summary())
        assert rep.sets
    assert td.trapping_set_profile(H, a_max=4) == \
        jd.trapping_set_profile(H, a_max=4)


@pytest.mark.parametrize("layered", [True, False])
def test_analyze_decoder_equal(layered):
    """The protograph DE of a built decoder, read off port and JAX decoders
    carrying the same (trained-style, per-block) weights; the port's
    weights may need grad and are read on the host."""
    base = make_base(3, 8, 16, seed=4, density=0.8)
    jdec, tdec = decoder_pair(base, 16, 5, layered=layered, **ZOO_LIKE)
    tdec = tdec.replace_weights(
        {k: v if v is None else v.clone().requires_grad_(True)
         for k, v in tdec.weights.items()})
    res = td.analyze_decoder(tdec, snr_db=3.0)
    _equal_de(res, jd.analyze_decoder(jdec, snr_db=3.0))
    assert res.error_prob.shape == (5,) and np.isfinite(res.error_prob).all()
    _equal_de(td.analyze_decoder(tdec, snr_db=3.0, max_iterations=3),
              jd.analyze_decoder(jdec, snr_db=3.0, max_iterations=3))
    with pytest.raises(ValueError, match="QC decoder"):
        td.analyze_decoder(lt.make_decoder(tdec.code, device="cpu"),
                           snr_db=3.0)
    assert isinstance(tdec.weights["beta"], torch.Tensor)
