"""The PBRL floor programs' twins (``ldpc_tpu_torch.cli.pbrl_bc5``,
``.pbrl_lift_floor``, ``.pbrl_precode``, ``.floor_is``,
``.trapping_spectrum``) on the CPU.

Each JAX program's ``run``/``main`` runs here in a temporary directory
with recorders in place of its simulator (``LDPCSimulator`` or
``simulate_single_snr``), ``estimate_trapping_floor`` and
``enable_compilation_cache``, and so does its twin with the port's
recorders: what each would have simulated or sampled (codes, decoder
specs with ``closed_qdq`` and T, every ``SimulationConfig`` field with
``punctured_positions``, ``seed`` and ``min_frames``, arm names and order,
the IS calls and their seeds) is held field for field, and the two
reports, written from the same recorded numbers, are equal. ``floor_is``
runs on the PBRL bases at lift 8 (shifts mod 8), where the trapping-set
search takes well under a second.

K1's plain version is held to ``ldpc_tpu``'s general layered engine given
the base rows as its layers (the schedule of its layered QC engine), read
at iteration T of its trajectory (the kernel never freezes a frame), on
the PBRL base with its shifts taken mod 8, f32, numpy LLRs: bc=5 with the
closed-form quantizer at T=20. Hard outputs exactly, posteriors
to rtol 1e-6 / atol 1e-5. On the precoded code the engines round the
column sums in another order than the kernel, which parts their hard
outputs where the punctured column's zero LLRs make sums cancel, so the
precoded OMS arm is held to ``ldpc_tpu``'s fused layered kernel itself in
interpret mode, on the precoded base's last two rows (≈ 2 s to
compile). ``ldpc_tpu``'s QC engines and interpret-mode kernels are not
run at full width: they cost 18-24 s a compile here.

``trapping_spectrum.profile`` equals the JAX program's on Tanner (155,
64); ``floor_is`` and ``pbrl_precode`` run for real at a tiny size and
write the JAX records' keys, the punctured LLRs reaching K1 as zeros in
every call of the compacting wave.
"""

import dataclasses
import json
import logging
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.floor_is as jax_fi
import experiments.pbrl_bc5 as jax_bc5
import experiments.pbrl_lift_floor as jax_lf
import experiments.pbrl_precode as jax_pc
import experiments.trapping_spectrum as jax_ts
import ldpc_tpu
import ldpc_tpu.sim
import ldpc_tpu.utils.cache
import ldpc_tpu_torch as lt
from ldpc_tpu.decode.engine import decode_batch_layered as jax_layered
from ldpc_tpu.sim import SimulationResult as JaxSimulationResult
from ldpc_tpu_torch.cli import floor_is as fi
from ldpc_tpu_torch.cli import pbrl_bc5 as bc5
from ldpc_tpu_torch.cli import pbrl_lift_floor as lf
from ldpc_tpu_torch.cli import pbrl_precode as pc
from ldpc_tpu_torch.cli import trapping_spectrum as ts
from ldpc_tpu_torch.decode import engine, fused
from ldpc_tpu_torch.sim import SimulationResult
from torch_port_helpers import (assert_same_config, assert_same_decoder,
                                channel_llr,
                                one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
# TPU scaffolding the twins leave behind
TPU_ONLY = ("batch_tile", "interpret")
FLOOR_ARGS = dict(samples=256, exemplars=2, shift=1.6, snrs=(3.2, 3.6),
                  n_classes=2)
SIM_PROGRAMS = ("pbrl_bc5", "pbrl_lift_floor", "pbrl_precode")


def _record(name):
    with open(os.path.join(EXP, f"{name}_results.json")) as f:
        return json.load(f)


def _narrowed(fn, lift=8):
    """``create_pbrl_qc_protograph`` with its shifts taken mod ``lift``
    and that lift."""
    def narrowed(*args, **kw):
        out = fn(*args, **kw)
        return (np.where(out[0] >= 0, out[0] % lift, -1), lift, *out[2:])
    return narrowed


def _fake_p(snr, members):
    """The IS recorders' (p, rel): the same in both packages."""
    return 1e-4 * (1 + int(np.sum(members)) % 7) / snr, 0.25


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{(package, program): {"sim": [...], "snr": [...], "is": [...],
    "report": {...}}}``: each program and its twin run with recorders for
    their simulators (config, {name: decoder}, checkpoint paths), their
    ``simulate_single_snr`` calls (decoder, SNR, config) and their
    ``estimate_trapping_floor`` calls (decoder, classes and arguments),
    and the report each wrote."""
    rec = {}

    def simulator(result_cls):
        class Simulator:
            def __init__(self, config=None):
                self.config = config
                rec["sim"].append(dict(config=config, decoders={},
                                       checkpoints={}))

            def simulate_decoder(self, decoder, decoder_name=None,
                                 verbose=True, checkpoint=None):
                rec["sim"][-1]["decoders"][decoder_name] = decoder
                rec["sim"][-1]["checkpoints"][decoder_name] = checkpoint
                r = result_cls(decoder_name, [
                    float(s) for s in self.config.snr_points()])
                for i in range(len(r.snr_values)):
                    r.add_result(i, 0.5, 0.1, 1.0, 0.0, 2, 1)
                return r
        return Simulator

    def single(decoder, snr_db, config, *args, **kw):
        rec["snr"].append((decoder, snr_db, config))
        return 0.25, 0.01, 3.0, 65536, 16384

    def estimate(decoder, classes, *, snr_db, shift, n_samples, batch,
                 punctured=None, **kw):
        [(ab, mult, members)] = classes
        rec["is"].append(dict(decoder=decoder, classes=classes, snr=snr_db,
                              shift=shift, n_samples=n_samples, batch=batch,
                              punctured=punctured, **kw))
        p, rel = _fake_p(snr_db, members)
        return types.SimpleNamespace(per_class={ab: (mult, p, rel)})

    jax_calls = {
        "pbrl_bc5": lambda out: jax_bc5.run(out_path=out, verbose=False),
        "pbrl_lift_floor": lambda out: jax_lf.run(out_path=out,
                                                  verbose=False),
        "pbrl_precode": lambda out: jax_pc.run(out_path=out, verbose=False),
        "floor_is": lambda out: jax_fi.main(out_path=out, **FLOOR_ARGS),
    }
    twin_calls = {
        "pbrl_bc5": lambda out: bc5.run(out_path=out, verbose=False,
                                        device="cpu"),
        "pbrl_lift_floor": lambda out: lf.run(out_path=out, verbose=False,
                                              device="cpu"),
        "pbrl_precode": lambda out: pc.run(out_path=out, verbose=False,
                                           device="cpu"),
        "floor_is": lambda out: fi.main(out_path=out, device="cpu",
                                        verbose=False, **FLOOR_ARGS),
    }
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ldpc_tpu.sim, "LDPCSimulator",
                   simulator(JaxSimulationResult))
        mp.setattr(ldpc_tpu.sim, "simulate_single_snr", single)
        mp.setattr(ldpc_tpu.sim, "estimate_trapping_floor", estimate)
        mp.setattr(ldpc_tpu.utils.cache, "enable_compilation_cache",
                   lambda *a, **k: None)
        mp.setattr(lt, "LDPCSimulator", simulator(SimulationResult))
        mp.setattr(lt, "simulate_single_snr", single)
        mp.setattr(fi, "estimate_trapping_floor", estimate)
        mp.setattr(logging, "basicConfig", lambda **kw: None)
        tmp = tmp_path_factory.mktemp("runs")
        mp.chdir(tmp)
        for pkg, calls in (("jax", jax_calls), ("torch", twin_calls)):
            for name, call in calls.items():
                with pytest.MonkeyPatch.context() as narrow:
                    if name == "floor_is":
                        for mod in (ldpc_tpu, lt):
                            narrow.setattr(mod, "create_pbrl_qc_protograph",
                                           _narrowed(
                                               mod.create_pbrl_qc_protograph))
                    rec = out[pkg, name] = {"sim": [], "snr": [], "is": []}
                    path = str(tmp / f"{pkg}_{name}.json")
                    call(path)
                    with open(path) as f:
                        rec["report"] = json.load(f)
    return out


def _strip(jdec):
    """``jdec`` without the TPU-only ``qc_options`` keys."""
    opts = jdec.qc_options and {k: v for k, v in jdec.qc_options.items()
                                if k not in TPU_ONLY}
    return dataclasses.replace(jdec, qc_options=opts)


# -- configurations ----------------------------------------------------------

@pytest.mark.parametrize("name", SIM_PROGRAMS + ("floor_is",))
def test_reports_equal_the_jax_programs(runs, name):
    """From the same recorded numbers the twin writes the JAX program's
    report, key for key and value for value, with the committed record's
    keys."""
    got, want = runs["torch", name]["report"], runs["jax", name]["report"]
    assert got == want
    rec = _record(name)
    assert list(got) == list(rec)
    if name in ("pbrl_bc5", "pbrl_precode"):
        assert list(got["curves"]) == list(rec["curves"])
        for k, c in got["curves"].items():
            assert list(c) == list(rec["curves"][k])
    elif name == "pbrl_lift_floor":
        assert list(got["results"]) == list(rec["results"])
    else:
        for arm, v in got.items():
            assert list(v) == list(rec[arm]) == ["classes", "floor"]
            for snr, classes in v["classes"].items():
                for c in classes.values():
                    assert list(c) == list(next(iter(
                        rec[arm]["classes"]["3.6"].values())))


@pytest.mark.parametrize("name", SIM_PROGRAMS)
def test_simulations_equal_the_jax_programs(runs, name):
    """Every simulator and ``simulate_single_snr`` call in the program's
    order: each ``SimulationConfig`` field, each decoder (code, QC tables,
    spec with ``closed_qdq``, T, options without the TPU-only keys, the
    pinned OMS tables), the arm names, the SNRs."""
    jrun, trun = runs["jax", name], runs["torch", name]
    assert len(trun["sim"]) == len(jrun["sim"])
    assert len(trun["snr"]) == len(jrun["snr"])
    for t, j in zip(trun["sim"], jrun["sim"]):
        assert_same_config(t["config"], j["config"])
        assert list(t["decoders"]) == list(j["decoders"])
        for key, jdec in j["decoders"].items():
            assert_same_decoder(t["decoders"][key], _strip(jdec))
    held = set()
    for (tdec, tsnr, tcfg), (jdec, jsnr, jcfg) in zip(trun["snr"],
                                                     jrun["snr"]):
        assert tsnr == jsnr
        assert_same_config(tcfg, jcfg)
        if id(tdec) not in held:  # each arm's decoder once
            assert_same_decoder(tdec, _strip(jdec))
            held.add(id(tdec))
    assert len(held) == len({id(j) for j, _, _ in jrun["snr"]})


def test_pbrl_bc5_arms_and_checkpoints(runs):
    """Four arms (bc=4: 8 CN levels, bc=5: 16), ``closed_qdq`` exactly at
    bc=5, T=10 and 20, one
    simulator; each curve checkpointed under ``pbrl_bc5_torch_ck/``
    (``experiments/pbrl_bc5_ck/`` in the program)."""
    [t], [j] = runs["torch", "pbrl_bc5"]["sim"], runs["jax",
                                                     "pbrl_bc5"]["sim"]
    assert [(k, d.spec.q_levels, d.max_iterations,
             d.qc_options["closed_qdq"])
            for k, d in t["decoders"].items()] == [
        ("RCQ-bc4-T10", 8, 10, False), ("RCQ-bc5-T10", 16, 10, True),
        ("RCQ-bc4-T20", 8, 20, False), ("RCQ-bc5-T20", 16, 20, True)]
    assert t["config"].early_exit_iters == 5
    assert t["config"].min_frames == 65536
    assert j["checkpoints"] == {k: f"experiments/pbrl_bc5_ck/{k}.json"
                                for k in t["decoders"]}
    assert t["checkpoints"] == {k: f"pbrl_bc5_torch_ck/{k}.json"
                                for k in t["decoders"]}


def test_pbrl_lift_floor_codes(runs):
    """lift86_n3096 (``k=1032``) and lift258_n9288 (``k=3096, lift=258``):
    the 24x36 base at both lifts, n = 3096 and 9288, seed 11, no minimum
    frames."""
    calls = runs["torch", "pbrl_lift_floor"]["snr"]
    assert [(d.code.n, d.qc.lift, d.qc.mb, d.qc.nb, s)
            for d, s, _ in calls] == [
        (n, lift, 24, 36, s) for s in lf.SNRS
        for n, lift in ((3096, 86), (9288, 258))]
    cfg = calls[0][2]
    assert (cfg.seed, cfg.min_frames, cfg.early_exit_iters,
            cfg.survivor_budget) == (11, 0, 2, 4096)


def test_pbrl_precode_arms_and_puncturing(runs):
    """Three simulators; the precoded arms puncture base column 0's 86
    bits of the 25x37 base (n = 3182); the OMS arm keeps no quantizer
    (``bv=6`` and its ladder are ignored for ``oms`` in both packages) and
    its pinned tables share (beta, alpha) on every (iteration, row), so
    every row takes K1's shared-pair route."""
    sims = runs["torch", "pbrl_precode"]["sim"]
    (rname, rdec), = sims[0]["decoders"].items()
    assert rname == "random-bc4-T10" and rdec.code.n == 3096
    assert sims[0]["config"].punctured_positions is None
    for s, name in zip(sims[1:], ("precoded-bc4-T10", "precoded-oms6-T10")):
        (k, dec), = s["decoders"].items()
        assert k == name and dec.code.n == 3182
        assert (dec.qc.mb, dec.qc.nb, dec.qc.lift) == (25, 37, 86)
        assert s["config"].punctured_positions == tuple(range(86))
        assert s["checkpoints"] == {k: f"pbrl_precode_torch_ck/{k}.json"}
    oms = sims[2]["decoders"]["precoded-oms6-T10"]
    jspec = runs["jax", "pbrl_precode"]["sim"][2]["decoders"][
        "precoded-oms6-T10"].spec
    for spec in (oms.spec, jspec):
        assert spec.kind == "oms" and spec.alpha_in_cn
        assert spec.v2c_qparams is None and spec.v2c_thresholds is None
        assert spec.v2c_levels == 0 and spec.q_levels == 0
    tabs = engine._tables(oms.weights, oms.spec, oms.max_iterations,
                          oms.qc.num_blocks, oms.device)
    assert torch.all(tabs["beta"] == 0.5) and torch.all(tabs["alpha"] == 0)


def test_floor_is_samples_what_the_program_samples(runs):
    """The same IS calls in the same order (arm, SNR, class, exemplar):
    decoder (``None`` options on the CPU, as the JAX program's off the
    TPU), exemplar, multiplicity 1, SNR, shift, samples, batch 2^11 and
    the punctured positions; the twin's seed is ``SeedSequence([20260818,
    arm, a, b, i])``'s where the program folds the same numbers into
    ``PRNGKey(20260818)``."""
    jcalls, tcalls = runs["jax", "floor_is"]["is"], runs["torch",
                                                        "floor_is"]["is"]
    assert len(tcalls) == len(jcalls) > 4
    seen = {}
    for t, j in zip(tcalls, jcalls):
        assert_same_decoder(t["decoder"], j["decoder"])
        [(tab, tm, tv)], [(jab, jm, jv)] = t["classes"], j["classes"]
        assert (tab, tm) == (jab, jm) and tm == 1
        np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv))
        for k in ("snr", "shift", "n_samples", "batch", "punctured"):
            assert t[k] == j[k], k
        arm_i = int(t["punctured"] is not None)
        i = seen[arm_i, t["snr"], tab] = seen.get((arm_i, t["snr"], tab),
                                                  -1) + 1
        assert t["seed"] == fi.exemplar_seed(arm_i, tab, i)
        key = jax.random.PRNGKey(20260818)
        for part in (arm_i, tab[0], tab[1], i):
            key = jax.random.fold_in(key, part)
        np.testing.assert_array_equal(np.asarray(j["key"]), np.asarray(key))
    assert {a for a, _, _ in seen} == {0, 1}
    assert tcalls[-1]["punctured"] == tuple(range(8))


def test_outputs_stay_out_of_experiments():
    for twin in (bc5, lf, pc, fi, ts):
        assert os.path.dirname(twin.DEFAULT_OUT) == ""
        assert twin.DEFAULT_OUT.endswith("_torch.json")
    assert (bc5.CHECKPOINTS, pc.CHECKPOINTS) == ("pbrl_bc5_torch_ck",
                                                 "pbrl_precode_torch_ck")


# -- K1's plain version at the new regimes -----------------------------------

def _base(precode):
    out = lt.create_pbrl_qc_protograph(k=1032, rate=1 / 3, precode=precode)
    return np.where(out[0] >= 0, out[0] % 8, -1)


def test_plain_k1_at_bc5_closed_t20_equals_ldpc_tpu_layered_engine():
    """``pbrl_bc5``'s RCQ-bc5-T20 at lift 8 through the fused wrapper (K1's
    plain version on the CPU), f32, 64 frames at 0 dB, against
    ``ldpc_tpu``'s general layered engine over the base rows with the same
    ladders and ``closed_qdq`` in its spec (the CN quantizer's power law),
    read at iteration 20: bits and success equal, posteriors to rtol 1e-6
    / atol 1e-5."""
    bc, T = 5, 20
    tdec = bc5.make(_base(False), 8, bc, T, "cpu")
    closed = bool(tdec.qc_options.get("closed_qdq"))
    H = tdec.code.H
    jdec = ldpc_tpu.make_decoder(
        ldpc_tpu.create_qc_code(_base(False), lift=8, max_iterations=T),
        kind="rcq", bc=bc, bv=8, quantizer_params=bc5.QP,
        v2c_quantizer_params=bc5.VQP8, closed_qdq=closed, max_iterations=T,
        layered=True)
    np.testing.assert_array_equal(jdec.code.H, H)
    assert jdec.spec.closed_qdq and closed
    assert tdec.spec.q_levels == jdec.spec.q_levels == 2 ** (bc - 1)
    llr = channel_llr(64, tdec.code.n, 0.0, seed=15 + T)
    layers = np.arange(H.shape[0]).reshape(-1, 8)
    post = np.asarray(jax_layered(
        jnp.asarray(llr), jdec.weights, layers, graph=jdec.graph,
        spec=jdec.spec, max_iterations=T,
        return_trajectory=True).posteriors_all[-1])
    bits = (post < 0).astype(np.int8)
    ok = ~((bits.astype(np.int64) @ H.T.astype(np.int64)) % 2).any(axis=1)
    before = fused.LAYERED_LAUNCHES
    out = tdec(torch.from_numpy(llr))
    assert fused.LAYERED_LAUNCHES == before
    assert out.posterior.dtype == torch.float32
    assert 0 < ok.sum() < 64
    np.testing.assert_array_equal(out.bits.numpy(), bits)
    np.testing.assert_array_equal(out.success.numpy(), ok)
    np.testing.assert_allclose(out.posterior.numpy(), post, rtol=1e-6,
                               atol=1e-5)


def test_plain_k1_on_the_punctured_precoded_code_equals_ldpc_tpus_kernel():
    """The precoded arm's pinned OMS (every (iteration, row) on K1's
    shared-pair route) on the precoded base's last two rows and the 8
    columns they touch (the precode column, punctured, among them) at lift
    8, T=10, f32, 64 frames at 4.0 dB whose punctured LLRs are multiplied
    by zero as the simulator's mask does (the negative ones become -0.0):
    K1's plain version against ``ldpc_tpu``'s fused layered kernel (the
    function K1 ports, in interpret mode; ≈ 2 s to compile here), hard
    outputs exactly and posteriors to rtol 1e-6 / atol 1e-5.

    ``ldpc_tpu``'s layered engines are not the reference here: they fold
    a new c2v into a column sum as ``colsum + (new - old)`` where its
    kernel forms ``colsum - old`` first, and the punctured column's v2c
    starts at exactly 0, so on this code sums cancel to 0 in one order and
    to an ulp in the other and the engines' hard outputs part from the
    kernel's on some frames (ROADMAP Queue 3)."""
    from ldpc_tpu.decode.pallas_fused import \
        qc_fused_decode_batch_layered as jax_kernel
    from ldpc_tpu.decode.qc_engine import build_qc_graph

    sub = lt.create_pbrl_qc_protograph(k=1032, rate=1 / 3,
                                       precode=True)[0][23:]
    sub = sub[:, (sub >= 0).any(axis=0)]
    base = np.where(sub >= 0, sub % 8, -1)
    assert base.shape == (2, 8) and (base[:, 0] >= 0).all()
    tdec = pc.decoder_for(base, 8, "oms", "cpu")
    tabs = engine._tables(tdec.weights, tdec.spec, tdec.max_iterations,
                          tdec.qc.num_blocks, tdec.device)
    assert torch.all(tabs["beta"] == 0.5) and torch.all(tabs["alpha"] == 0)
    jdec = ldpc_tpu.make_decoder(
        ldpc_tpu.create_qc_code(base, lift=8, max_iterations=pc.T),
        kind="oms", sharing_type=2, max_iterations=pc.T,
        qc=build_qc_graph(base, 8), layered=True)
    mask = np.ones(tdec.code.n, np.float32)
    mask[:8] = 0.0
    llr = channel_llr(64, tdec.code.n, 4.0, seed=25) * mask
    assert np.signbit(llr[:, :8]).any() and not llr[:, :8].any()
    ref = jax_kernel(jnp.asarray(llr), {k: jnp.asarray(v.numpy())
                                        for k, v in tdec.weights.items()},
                     qc=jdec.qc, spec=jdec.spec, max_iterations=pc.T,
                     dtype=jnp.float32, interpret=True, batch_tile=64)
    out = tdec(torch.from_numpy(llr))
    ok = np.asarray(ref.success)
    assert 0 < ok.sum() < 64
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(), ok)
    np.testing.assert_allclose(out.posterior.numpy(),
                               np.asarray(ref.posterior), rtol=1e-6,
                               atol=1e-5)


def _chip_smoke():
    """``chip_smoke.py`` as a module. Its import blocks ``jax`` in
    ``sys.modules``; this process needs it, so it is put back."""
    saved = sys.modules["jax"]
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
        sys.modules["jax"] = saved
    return chip_smoke


def test_chip_smoke_holds_k1_at_the_decoders_closed_form(monkeypatch):
    """``chip_smoke``'s kernel and plain calls and its bound take the
    ``closed_qdq`` that ``pbrl_bc5``'s bc=5 arms carry in their fused
    options (not in their spec), so the card's checks run K2's power mode,
    the mode the campaign runs, and not the 16-level staircase: on
    RCQ-bc5-T20 at lift 8, cut to its first 2 iterations as stage 1 is
    (options kept), every quantizer both build is the closed form, both
    equal the decoder's own call bit for bit, and the bound counts the
    power-mode quantizer."""
    cs = _chip_smoke()
    full = bc5.make(_base(False), 8, 5, 20, "cpu")
    dec = dataclasses.replace(dataclasses.replace(
        full, qc_options=None).truncated(2), qc_options=full.qc_options)
    assert not dec.spec.closed_qdq and cs.closed_of(dec)
    x = torch.from_numpy(channel_llr(16, dec.code.n, 0.0, seed=5))
    want = dec(x)
    seen, real = [], fused._qdq_at

    def spy(spec, tabs, t, v2c, closed, *args, **kw):
        seen.append(closed)
        return real(spec, tabs, t, v2c, closed, *args, **kw)

    monkeypatch.setattr(fused, "_qdq_at", spy)
    for fn in (cs.kernel_on, cs.plain_on):
        seen.clear()
        got = fn(x, dec, 2, False)
        assert len(seen) == 3 and all(seen)
        assert torch.equal(got.posterior, want.posterior)
        assert torch.equal(got.success, want.success)
    closed_ops = cs.edge_ops(dec.spec, False, closed=True)
    assert closed_ops[1] - cs.edge_ops(dec.spec, False)[1] == \
        cs.qdq_ops("power", 16) - cs.qdq_ops("staircase", 16)
    assert cs.bound(dec, 64, 2, False)[0] < cs.bound(
        dataclasses.replace(dec, qc_options=None), 64, 2, False)[0]


# -- the twins at a tiny size ------------------------------------------------

@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run in ``tmp_path`` with no logging set-up and the PBRL bases at
    lift 8; afterwards nothing under ``experiments/`` or ``zoo/`` has
    changed."""
    def snapshot():
        return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                for top in ("experiments", "zoo")
                for d, _, fs in os.walk(os.path.join(REPO, top)) for f in fs}

    before = snapshot()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    monkeypatch.setattr(lt, "create_pbrl_qc_protograph",
                        _narrowed(lt.create_pbrl_qc_protograph))
    yield tmp_path
    assert snapshot() == before


def test_pbrl_precode_run_punctures_every_k1_call(in_tmp, monkeypatch):
    """Waves of 64 (budget 32) at 2.6 dB, one a point: each arm's curve
    written and checkpointed with the record's keys, and every batch the
    precoded arms hand K1 (stage 1, the gathered survivors, a fallback's
    two decodes) has zeros at the punctured positions."""
    calls = []
    real = fused._decode

    def spy(flooding, llr, *args):
        calls.append(llr[:, :8].abs().max().item() if llr.shape[1] == 296
                     else None)
        return real(flooding, llr, *args)

    monkeypatch.setattr(fused, "_decode", spy)
    rep = pc.run(frames=64, errors=1, snr_lo=2.6, snr_hi=2.6, wave_size=64,
                 survivor_budget=32, verbose=False, device="cpu")
    with open(in_tmp / pc.DEFAULT_OUT) as f:
        assert json.load(f) == rep
    rec = _record("pbrl_precode")
    assert list(rep) == list(rec)
    assert list(rep["curves"]) == list(rec["curves"])
    for c in rep["curves"].values():
        assert list(c) == list(rec["curves"]["random-bc4-T10"])
        assert c["total_frames"] == [64]
    precoded = [c for c in calls if c is not None]
    assert len(precoded) >= 4 and set(precoded) == {0.0}
    assert len(calls) - len(precoded) >= 2
    assert sorted(os.listdir(in_tmp / pc.CHECKPOINTS)) == sorted(
        f"{k}.json" for k in rec["curves"])


def test_floor_is_main_writes_the_jax_keys(in_tmp):
    """2^8 samples, one class, one exemplar at 3.6 dB on the layered QC
    engine (the CPU decoder): the record's keys, a probability in [0, 1]
    and the floor the class's contribution."""
    rep = fi.main(samples=2 ** 8, exemplars=1, n_classes=1, snrs=(3.6,),
                  device="cpu", verbose=False)
    with open(in_tmp / fi.DEFAULT_OUT) as f:
        assert json.load(f) == rep
    rec = _record("floor_is")
    assert list(rep) == list(rec)
    for arm, v in rep.items():
        assert list(v) == list(rec[arm])
        [(cls, c)] = v["classes"]["3.6"].items()
        assert list(c) == list(rec[arm]["classes"]["3.6"][
            next(iter(rec[arm]["classes"]["3.6"]))])
        assert len(c["exemplars"]) == 1 and 0.0 <= c["p_mean"] <= 1.0
        assert v["floor"]["3.6"] == c["contribution"] == \
            c["multiplicity"] * c["p_mean"]


def test_trapping_spectrum_profile_equals_the_jax_programs(capsys):
    """Tanner (155, 64): the same spectrum, fingerprint and printed
    lines."""
    base, lift = lt.load_protograph(os.path.join(ts.CODES,
                                                 "tanner_155_64.proto"))
    H = lt.create_qc_code(base, lift=lift, max_iterations=5).H
    got = ts.profile("Tanner (155,64)", H)
    printed = capsys.readouterr().out
    want = jax_ts.profile("Tanner (155,64)", H)
    assert capsys.readouterr().out == printed
    assert got == want
    assert json.loads(json.dumps(got)) == _record(
        "trapping_spectrum")["tanner_155_64"]


def test_trapping_spectrum_codes_are_the_programs():
    """The five codes in the program's order, each H equal to the one the
    program builds: the "lift 258" code is ``k=1032`` (n = 3096), not
    ``pbrl_lift_floor``'s ``k=3096``."""
    got = ts.codes()
    assert [k for k, *_ in got] == list(_record("trapping_spectrum"))
    want = [ldpc_tpu.create_pbrl_qc_protograph(k=1032, rate=1 / 3, lift=86),
            ldpc_tpu.create_pbrl_qc_protograph(k=1032, rate=1 / 3,
                                               lift=258),
            ldpc_tpu.create_pbrl_qc_protograph(k=1032, rate=1 / 3, lift=86,
                                               precode=True)[:2],
            (np.random.default_rng(0).integers(0, 256, size=(5, 37)), 256),
            ldpc_tpu.load_protograph(os.path.join(REPO, "codes",
                                                  "tanner_155_64.proto"))]
    for (key, _, H, restarts), (base, lift) in zip(got, want):
        np.testing.assert_array_equal(
            H, ldpc_tpu.create_qc_code(base, lift=lift).H, key)
        assert restarts == (2 if key == "bench_qc_9472" else 3)
    assert got[1][2].shape == (2064, 3096)


@pytest.mark.parametrize("call", [
    lambda: bc5.main([]), lambda: lf.main([]), lambda: pc.main([]),
    lambda: fi.cli([])], ids=["pbrl_bc5", "pbrl_lift_floor", "pbrl_precode",
                              "floor_is"])
def test_twin_needs_a_card_unless_told_cpu(call, monkeypatch):
    """Each decoding twin runs on the card by default: without one it
    raises before it decodes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    with pytest.raises(RuntimeError, match="CUDA card"):
        call()
