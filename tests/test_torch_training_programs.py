"""The W-RCQ training and rate-specific programs' twins
(``ldpc_tpu_torch.cli.train_wrcq``, ``.rate_specific``,
``.train_wrcq_qc9472``, ``.rate_specific_deep``) on the CPU.

Each JAX program's ``run()`` is run here in a temporary directory with
recorders in place of its trainer, simulator, ``save_checkpoint`` and
``enable_compilation_cache``: what it would have trained, simulated and
saved (codes, decoders, ``TrainingConfig``, ``SimulationConfig``,
``num_samples``, checkpoint names) is held to the twin's, field for field.
The program's module constants are imported from ``experiments/``.

Decoding is held to ``ldpc_tpu`` on numpy LLRs, hard outputs exactly:
W-RCQ t2 on PEG(256, 128) with ``ldpc_tpu``'s seed-0 tables on both
packages' general engines; the ``train_wrcq_qc9472`` decoder at lift 16
in f32 on the port's QC engine against ``ldpc_tpu``'s general flooding
engine on the same H; and the JAX program's trained PBRL tables
(``experiments/{wnms,worcq}rcq_pbrl_qc_ck``, read with orbax here) through
K1's plain version against ``ldpc_tpu``'s general layered engine given
the base rows as its layers, the schedule of its layered QC engine, on
the PBRL base with its shifts taken mod 8 (n = 288), T=10. ``ldpc_tpu``'s
QC engines are not run: jit-compiled they take ≈ 18-24 s a decoder on
the CPU, op by op ≈ 1.1-1.3 s an iteration, and the general engines
compile in ≈ 1 s. The twins' ``run`` functions write the JAX programs'
keys at a tiny size in a temporary directory, never under
``experiments/`` or ``zoo/``, and ``rate_specific_deep`` resumes with
identical statistics.
"""

import ast
import dataclasses
import functools
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.bc4_refine as jax_br
import experiments.dde_ladders as jax_dl
import experiments.floor_is as jax_fi
import experiments.ladder_bc4 as jax_lb
import experiments.pbrl_bc5 as jax_bc5
import experiments.pbrl_rates as jax_pr
import experiments.pbrl_lift_floor as jax_lf
import experiments.pbrl_precode as jax_pc
import experiments.quantizer_count as jax_qc
import experiments.rate_specific as jax_rs
import experiments.rate_specific_deep as jax_rsd
import experiments.tighten89 as jax_t89
import experiments.train_wrcq as jax_tw
import experiments.train_wrcq_qc9472 as jax_tq
import experiments.trapping_spectrum as jax_ts
import ldpc_tpu
import ldpc_tpu.sim
import ldpc_tpu.train
import ldpc_tpu.utils.cache
import ldpc_tpu.utils.checkpoint
import ldpc_tpu_torch as lt
from ldpc_tpu.decode.engine import decode_batch_layered as jax_layered
from ldpc_tpu.sim import SimulationResult as JaxSimulationResult
from ldpc_tpu_torch.cli import bc4_refine, dde_ladders, ladder_bc4
from ldpc_tpu_torch.cli import deep_fer, floor_is, pbrl_bc5
from ldpc_tpu_torch.cli import pbrl_lift_floor, pbrl_precode, pbrl_rates
from ldpc_tpu_torch.cli import quantizer_count, tighten89
from ldpc_tpu_torch.cli import rate_specific as rs
from ldpc_tpu_torch.cli import rate_specific_deep as rsd
from ldpc_tpu_torch.cli import train_wrcq as tw
from ldpc_tpu_torch.cli import train_wrcq_qc9472 as tq
from ldpc_tpu_torch.cli import trapping_spectrum
from ldpc_tpu_torch.sim import SimulationResult
from torch_port_helpers import (assert_same_config, assert_same_decoder,
                                carry_weights, channel_llr,
                                one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
TWINS = {"train_wrcq": tw, "rate_specific": rs, "train_wrcq_qc9472": tq,
         "rate_specific_deep": rsd}
# the JAX run of each program: its module and run() arguments (the
# defaults; train_wrcq_qc9472 at lift 16, its own parameter)
PROGRAMS = {"train_wrcq": (jax_tw, {}),
            "rate_specific": (jax_rs, {}),
            "train_wrcq_qc9472": (jax_tq, dict(lift=16)),
            "rate_specific_deep": (jax_rsd, {})}
# TPU scaffolding the twins leave behind
TPU_ONLY = ("batch_tile", "interpret")
# the PBRL (3096, 1032) base and lift, before any test narrows them
PBRL = rsd.protograph()


def _record(name):
    with open(os.path.join(EXP, f"{name}_results.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """``{program: {"train": [...], "sim": [...], "saved": [...]}}``: each
    JAX program's run() with recorders for its trainers (decoder, config,
    num_samples), simulators (config, {name: decoder}, checkpoint paths)
    and saved checkpoints (path, tree)."""
    rec = {}

    class Trainer:
        def __init__(self, decoder, config=None):
            rec["train"].append(dict(decoder=decoder, config=config))

        def train(self, num_samples=3200, val_samples=640, verbose=True):
            rec["train"][-1]["num_samples"] = num_samples
            return {"training_losses": [0.5], "training_accuracies": [0.5],
                    "validation_losses": [0.5]}

    class Simulator:
        def __init__(self, config=None):
            self.config = config
            rec["sim"].append(dict(config=config, decoders={},
                                   checkpoints={}))

        def simulate_decoder(self, decoder, decoder_name=None, verbose=True,
                             checkpoint=None):
            rec["sim"][-1]["decoders"][decoder_name] = decoder
            rec["sim"][-1]["checkpoints"][decoder_name] = checkpoint
            r = JaxSimulationResult(decoder_name, [
                float(s) for s in self.config.snr_points()])
            for i in range(len(r.snr_values)):
                r.add_result(i, 0.5, 0.1, 1.0, 0.0, 2, 1)
            return r

        def simulate_multiple_decoders(self, decoders, verbose=True):
            return {k: self.simulate_decoder(d, k)
                    for k, d in decoders.items()}

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ldpc_tpu.train, "PosteriorJointTrainer", Trainer)
        mp.setattr(ldpc_tpu.sim, "LDPCSimulator", Simulator)
        mp.setattr(ldpc_tpu.utils.checkpoint, "save_checkpoint",
                   lambda path, tree: rec["saved"].append((path, tree)))
        mp.setattr(ldpc_tpu.utils.cache, "enable_compilation_cache",
                   lambda *a, **k: None)
        mp.setattr(logging, "basicConfig", lambda **kw: None)
        tmp = tmp_path_factory.mktemp("jax_runs")
        mp.chdir(tmp)
        for name, (mod, kw) in PROGRAMS.items():
            rec = runs[name] = {"train": [], "sim": [], "saved": []}
            mod.run(out_path=str(tmp / f"{name}.json"), verbose=False, **kw)
    return runs


def _strip(jdec):
    """``jdec`` without the TPU-only ``qc_options`` keys."""
    opts = jdec.qc_options and {k: v for k, v in jdec.qc_options.items()
                                if k not in TPU_ONLY}
    return dataclasses.replace(jdec, qc_options=opts)


def _twin_arms(name):
    """(the twin's trainings [(TrainingConfig, num_samples)], its
    simulations [({name: decoder trained or simulated},
    SimulationConfig)]), built by its own functions on the CPU."""
    if name == "train_wrcq":
        code = tw.make_code()
        wrcq = tw.make_wrcq(code, "cpu")
        return [(tw.training_config(12), tw.NUM_SAMPLES)], [({
            "float-MS": lt.basic_min_sum(code, factor=tw.MS_FACTOR,
                                         max_iterations=tw.T, device="cpu"),
            "W-RCQ-t2-untrained": wrcq, "W-RCQ-t2-trained": wrcq},
            tw.sim_config(32768, "cpu"))]
    if name == "rate_specific":
        trains, sims = [], []
        for rate, code in sorted(rs.family(96).items()):
            code = rs.rate_code(code)
            mid = rs.snr_mid(rate)
            trains.append((rs.training_config(10, mid), rs.NUM_SAMPLES))
            sims.append(({
                "MS": lt.basic_min_sum(code, max_iterations=rs.T,
                                       device="cpu"),
                "W-RCQ-trained": rs.make_wrcq(code, "cpu")},
                rs.sim_config(16384, mid, "cpu")))
        return trains, sims
    if name == "train_wrcq_qc9472":
        code, qc = tq.make_code(16)
        wrcq = tq.make_wrcq(code, qc, "cpu")
        return [(tq.training_config(8), tq.NUM_SAMPLES)], [({
            "float-MS": tq.make_ms(code, qc, "cpu"),
            "W-RCQ-bc4-untrained": wrcq, "W-RCQ-bc4-trained": wrcq},
            tq.sim_config(16384, "cpu"))]
    return ([(rsd.training_config(24), rsd.NUM_SAMPLES)] *
            len(rsd.CANDIDATES),
            [(rsd.decoders("cpu"), rsd.campaign_config(device="cpu"))])


# -- configurations ----------------------------------------------------------

def test_codes_equal_the_jax_programs():
    """PEG(256, 128); the PBRL family at k=96 with the same float keys in
    the same sorted order (``.get(rate, 2.0)`` would move every SNR range
    on other floats); the PBRL QC base and lift; the bench base."""
    np.testing.assert_array_equal(
        tw.make_code().H, ldpc_tpu.create_peg_code(n=256, m=128, dv=3,
                                                   seed=0).H)
    jfam = ldpc_tpu.create_pbrl_family(k=96, rates=(1 / 3, 1 / 2, 2 / 3))
    tfam = rs.family(96)
    assert list(sorted(tfam)) == list(sorted(jfam)) == sorted(rs.RATES)
    assert [rs.snr_mid(r) for r in sorted(tfam)] == [1.0, 2.0, 3.0]
    for rate in jfam:
        np.testing.assert_array_equal(tfam[rate].H, jfam[rate].H)
        assert rs.rate_code(tfam[rate]).max_iterations == 10
    base, lift = rsd.protograph()
    jbase, jlift = ldpc_tpu.create_pbrl_qc_protograph(k=1032, rate=1 / 3)
    np.testing.assert_array_equal(base, jbase)
    assert lift == jlift == 86 and base.shape == (24, 36)
    np.testing.assert_array_equal(
        tq.make_code(256)[0].H, ldpc_tpu.create_qc_code(
            np.random.default_rng(0).integers(0, 256, size=(5, 37)),
            lift=256).H)


def test_constants_equal_the_jax_programs():
    assert (rsd.QP4, rsd.VQP8, rsd.VQP6) == (jax_rsd.QP4, jax_rsd.VQP8,
                                             jax_rsd.VQP6)
    assert tw.QP == rs.QP == tq.QP == ((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))
    assert rs.SNR_MID == {1 / 3: 1.0, 1 / 2: 2.0, 2 / 3: 3.0}
    assert rs.snr_mid(0.4) == 2.0
    for twin in TWINS.values():
        assert os.path.dirname(twin.DEFAULT_OUT) == ""
    assert rsd.CHECKPOINTS == "rsd_torch_ck"
    assert [rsd.checkpoint_dir(t) for t, _ in rsd.CANDIDATES] == [
        "wnmsrcq_pbrl_qc_torch_ck", "worcqrcq_pbrl_qc_torch_ck"]


def _options(module):
    """The option strings of ``module``'s ``add_argument`` calls."""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    return {a.value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"
            for a in node.args if isinstance(a, ast.Constant)}


# (twin, JAX program) of the PBRL floor programs, whose other tests are in
# tests/test_torch_floor_programs.py
FLOOR_TWINS = {"pbrl_bc5": (pbrl_bc5, jax_bc5),
               "pbrl_lift_floor": (pbrl_lift_floor, jax_lf),
               "pbrl_precode": (pbrl_precode, jax_pc),
               "floor_is": (floor_is, jax_fi),
               "trapping_spectrum": (trapping_spectrum, jax_ts),
               # the bench-code design studies, whose other tests are in
               # tests/test_torch_design_programs.py
               "ladder_bc4": (ladder_bc4, jax_lb),
               "bc4_refine": (bc4_refine, jax_br),
               "quantizer_count": (quantizer_count, jax_qc),
               "dde_ladders": (dde_ladders, jax_dl),
               # the section VII-C rate-family programs, whose other tests
               # are in tests/test_torch_rates_programs.py
               "pbrl_rates": (pbrl_rates, jax_pr),
               "tighten89": (tighten89, jax_t89)}
# options a twin adds besides --device: quantizer_count's deep phase reads
# rcq-q2's ladder from --design (the program's fixed path by default),
# pbrl_rates' deep and train phases the twin's own designs from
# --design-dir (the committed ones by default)
PLUMBING = {"quantizer_count": {"--design"}, "pbrl_rates": {"--design-dir"}}
# programs that run on the host alone: their twins have no command line
# (tighten89 has none either, but decodes: its twin takes --device)
HOST_ONLY = ("trapping_spectrum",)


@pytest.mark.parametrize("name", list(TWINS) + list(FLOOR_TWINS))
def test_command_line_is_the_jax_programs_plus_device(name):
    """Each twin's options are its program's plus ``--device`` (and
    :data:`PLUMBING`'s); a host-only program with no command line
    (``trapping_spectrum``, host numpy) has a twin with none."""
    twin, prog = (FLOOR_TWINS[name] if name in FLOOR_TWINS
                  else (TWINS[name], PROGRAMS[name][0]))
    want = _options(prog)
    assert _options(twin) == (set() if name in HOST_ONLY else
                              want | {"--device"} | PLUMBING.get(name, set()))


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_decoders_and_configs_equal_the_jax_programs(jax_runs, name):
    """Every decoder the program trains or simulates (spec, QC tables,
    options without the TPU-only keys; weights where they are not drawn at
    random: min-sum and the pinned OMS constants), each TrainingConfig and
    num_samples, each SimulationConfig."""
    run = jax_runs[name]
    trains, sims = _twin_arms(name)
    assert len(run["train"]) == len(trains) and len(run["sim"]) == len(sims)
    for (tcfg, n), tr in zip(trains, run["train"]):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(tr["config"])
        assert n == tr["num_samples"]
    for (decs, scfg), sim in zip(sims, run["sim"]):
        assert_same_config(scfg, sim["config"])
        assert list(decs) == list(sim["decoders"])
        for key, jdec in sim["decoders"].items():
            drawn = key.startswith(("W-RCQ", "W-NMS"))
            assert_same_decoder(decs[key], _strip(jdec), weights=not drawn)
        trained = [k for k, d in sim["decoders"].items()
                   if any(d is t["decoder"] for t in run["train"])]
        assert trained == [k for k in decs if k.endswith("-trained")]


def test_rate_specific_deep_saves_and_resumes_where_the_program_does(
        jax_runs):
    """The same candidates saved (``experiments/<tag>rcq_pbrl_qc_ck`` in
    the program, ``<tag>rcq_pbrl_qc_torch_ck`` here), and one resumable
    curve a decoder (``experiments/rsd_ck/`` there, ``rsd_torch_ck/``
    here)."""
    run = jax_runs["rate_specific_deep"]
    assert [p for p, _ in run["saved"]] == [
        f"experiments/{tag}rcq_pbrl_qc_ck" for tag, _ in rsd.CANDIDATES]
    assert [rsd.checkpoint_dir(t) for t, _ in rsd.CANDIDATES] == [
        os.path.basename(p).replace("_ck", "_torch_ck")
        for p, _ in run["saved"]]
    assert all(set(tree) == {"beta", "alpha"} for _, tree in run["saved"])
    assert run["sim"][0]["checkpoints"] == {
        k: f"experiments/rsd_ck/{k}.json" for k in rsd.decoders("cpu")}


def test_oms_6bit_is_a_float_oms_in_both_packages(jax_runs):
    """The program's ``bv=6`` and 6-bit ladder are ignored for ``oms``:
    neither package's decoder holds a V2C (or CN) quantizer, so the arm
    is a float OMS; its tables are pinned to beta = 0.5, alpha = 0."""
    jdec = jax_runs["rate_specific_deep"]["sim"][0]["decoders"][rsd.OMS]
    tdec = rsd.decoders("cpu")[rsd.OMS]
    for spec in (jdec.spec, tdec.spec):
        assert spec.kind == "oms" and spec.alpha_in_cn
        assert spec.v2c_thresholds is None and spec.v2c_qparams is None
        assert spec.thresholds is None and spec.qparams is None
        assert spec.v2c_levels == 0 and spec.q_levels == 0
    assert tuple(tdec.weights["beta"].shape) == (10, 2)
    assert tuple(tdec.weights["alpha"].shape) == (10, 7)
    assert torch.all(tdec.weights["beta"] == 0.5)
    assert torch.all(tdec.weights["alpha"] == 0.0)


# -- decoding ----------------------------------------------------------------

def test_peg_wrcq_with_jax_tables_equals_ldpc_tpu():
    """W-RCQ t2 on PEG(256, 128) with ``ldpc_tpu``'s seed-0 initial
    tables, 64 frames at 3.5 dB through both general flooding engines."""
    jdec = ldpc_tpu.weighted_rcq(
        ldpc_tpu.create_peg_code(n=256, m=128, dv=3, seed=0,
                                 max_iterations=10),
        bc=3, weight_sharing_type=2, quantizer_params=tw.QP,
        max_iterations=10, init="nms", seed=0)
    tdec = carry_weights(jdec, tw.make_wrcq(tw.make_code(), "cpu"))
    llr = channel_llr(64, 256, 3.5, seed=14)
    ref = jdec(jnp.asarray(llr))
    out = tdec(torch.from_numpy(llr))
    ok = np.asarray(ref.success)
    assert 0 < ok.sum() < 64
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(), ok)
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))


def test_qc9472_decoder_at_lift_16_equals_ldpc_tpu():
    """The program's W-RCQ bc=4 at lift 16 in f32 with ``ldpc_tpu``'s
    seed-0 tables, 64 frames at 6.0 dB: the port's QC flooding engine
    under the twin's ``check_every=10`` (one syndrome check, at T) against
    ``ldpc_tpu``'s general flooding engine on the same H read at iteration
    10 of its trajectory."""
    code, qc = tq.make_code(16)
    jdec = ldpc_tpu.make_decoder(
        ldpc_tpu.create_qc_code(deep_fer.bench_base(16), lift=16,
                                max_iterations=10),
        kind="wrcq", bc=4, sharing_type=2, quantizer_params=tq.QP,
        max_iterations=10, init="nms", seed=0)
    twin = tq.make_wrcq(code, qc, "cpu")
    twin = dataclasses.replace(twin, qc_options=dict(twin.qc_options,
                                                     dtype=torch.float32))
    tdec = carry_weights(jdec, twin)
    llr = channel_llr(64, code.n, 6.0, seed=72)
    post = np.asarray(jdec(jnp.asarray(llr),
                           return_trajectory=True).posteriors_all[-1])
    bits = (post < 0).astype(np.int8)
    ok = ~((bits.astype(np.int64) @ code.H.T.astype(np.int64)) % 2).any(
        axis=1)
    out = tdec(torch.from_numpy(llr))
    assert 0 < ok.sum() < 64
    np.testing.assert_array_equal(out.bits.numpy(), bits)
    np.testing.assert_array_equal(out.success.numpy(), ok)
    np.testing.assert_allclose(out.posterior.numpy(), post, rtol=1e-6,
                               atol=1e-5)


def _pbrl_mod(lift):
    base, _ = PBRL
    return np.where(base >= 0, base % lift, -1), lift


@pytest.mark.parametrize("tag,kind", [("wnms", "wrcq"), ("worcq", "orcq")])
def test_pbrl_trained_tables_through_plain_k1_equal_ldpc_tpu(tag, kind,
                                                             monkeypatch):
    """The JAX program's trained ``[10, 2]`` / ``[10, 7]`` tables, which
    differ across every row (K1's per-block route), on the PBRL base at
    lift 8, T=10, f32, 64 frames at 1.5 dB: K1's plain version (the twin's
    decoder) against ``ldpc_tpu``'s layered engine over the base rows read
    at iteration 10 of its trajectory (the kernel's contract is the engine
    without early freezing, ``ldpc_tpu/decode/pallas_fused.py:29-31``:
    W-NMS-RCQ's V2C ladder widens from 8 to 12 at the last phase and
    unsettles some frames the engine froze at iteration 9). Bits and
    success equal, the degree-1 columns included; posteriors to the layered
    contract's tolerance."""
    ck = {k: np.asarray(v) for k, v in
          ldpc_tpu.utils.checkpoint.load_checkpoint(
              os.path.join(EXP, f"{tag}rcq_pbrl_qc_ck")).items()}
    assert {k: v.shape for k, v in ck.items()} == {"beta": (10, 2),
                                                   "alpha": (10, 7)}
    monkeypatch.setattr(rsd, "protograph", lambda: _pbrl_mod(8))
    name = dict(rsd.CANDIDATES)[tag]
    tdec = rsd.decoders("cpu")[name].replace_weights(
        lt.weights_from_numpy(ck, device="cpu"))
    jdec = ldpc_tpu.make_decoder(
        ldpc_tpu.create_qc_code(*_pbrl_mod(8), max_iterations=10),
        kind=kind, bc=4, bv=8, sharing_type=2, quantizer_params=rsd.QP4,
        v2c_quantizer_params=rsd.VQP8, max_iterations=10, layered=True)
    H = tdec.code.H
    np.testing.assert_array_equal(jdec.code.H, H)
    assert jdec.code.n == 288
    layers = np.arange(H.shape[0]).reshape(24, 8)
    llr = channel_llr(64, 288, 1.5, seed=86)
    post = np.asarray(jax_layered(
        jnp.asarray(llr), {k: jnp.asarray(v) for k, v in ck.items()},
        layers, graph=jdec.graph, spec=jdec.spec, max_iterations=10,
        return_trajectory=True).posteriors_all[-1])
    bits = (post < 0).astype(np.int8)
    ok = ~((bits.astype(np.int64) @ H.T.astype(np.int64)) % 2).any(axis=1)
    out = lt.qc_fused_decode_batch_layered(
        torch.from_numpy(llr), tdec.weights, qc=tdec.qc, spec=tdec.spec,
        max_iterations=10, dtype=torch.float32)
    assert 0 < ok.sum() < 64
    np.testing.assert_array_equal(out.bits.numpy(), bits)
    np.testing.assert_array_equal(out.success.numpy(), ok)
    np.testing.assert_allclose(out.posterior.numpy(), post, rtol=1e-6,
                               atol=1e-5)
    # the 12 incremental-redundancy columns and the staircase's last
    deg1 = np.flatnonzero(H.sum(axis=0) == 1)
    assert len(deg1) == 13 * 8
    np.testing.assert_array_equal(out.bits.numpy()[:, deg1], bits[:, deg1])


# -- the pure functions ------------------------------------------------------

def test_gain_db_on_the_jax_record():
    """The record's curves give its ``gain_db`` (all None: OMS-6bit starts
    below 1e-4 and the candidates stop above 1e-5)."""
    rec = _record("rate_specific_deep")
    curves = {k: SimulationResult.from_dict(v)
              for k, v in rec["curves"].items()}
    assert rsd.gain_db(curves, verbose=False) == rec["gain_db"]
    assert rsd.snr_at(curves[rsd.OMS], 1e-6) == pytest.approx(
        3.6 + 0.2 * (np.log10(1e-6) - np.log10(39 / 20021248)) /
        (np.log10(19 / 20021248) - np.log10(39 / 20021248)))


def test_snr_at_on_a_two_point_curve():
    c = SimulationResult("c", [1.0, 2.0, 3.0])
    for i, fer in enumerate([1e-2, 1e-4, 0.0]):
        c.add_result(i, fer, 0.0, 1.0, 0.0, 100, 1)
    assert rsd.snr_at(c, 1e-3) == pytest.approx(1.5)
    assert rsd.snr_at(c, 1e-2) == pytest.approx(1.0)
    assert rsd.snr_at(c, 1e-5) is None and rsd.snr_at(c, 0.1) is None
    d = SimulationResult("d", [1.0, 2.0])
    for i, fer in enumerate([1e-2, 1e-3]):
        d.add_result(i, fer, 0.0, 1.0, 0.0, 100, 1)
    gains = rsd.gain_db({rsd.OMS: c, rsd.CANDIDATES[0][1]: d,
                         rsd.CANDIDATES[1][1]: c}, verbose=False)
    assert gains[rsd.CANDIDATES[0][1]] == {"0.0001": None, "1e-05": None,
                                           "1e-06": None}
    assert gains[rsd.CANDIDATES[1][1]]["0.0001"] == 0.0


# -- the twins at a tiny size ------------------------------------------------

@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run in ``tmp_path`` with a trainer that validates on 8 frames and
    no logging set-up; afterwards nothing under ``experiments/`` or
    ``zoo/`` has changed."""
    def snapshot():
        return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                for top in ("experiments", "zoo")
                for d, _, fs in os.walk(os.path.join(REPO, top)) for f in fs}

    before = snapshot()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(lt.PosteriorJointTrainer, "train",
                        functools.partialmethod(lt.PosteriorJointTrainer.train,
                                                val_samples=8))
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    yield tmp_path
    assert snapshot() == before


def _same_keys(report, record):
    assert list(report) == list(record)
    for name, c in report["curves"].items():
        assert list(c) == list(record["curves"][name])


def test_train_wrcq_run_writes_the_jax_keys(in_tmp, monkeypatch):
    """One step of 16 frames, waves of 32, one wave a point; the untrained
    arm keeps the initial tables."""
    for k, v in dict(BATCH=16, NUM_SAMPLES=16, WAVE=32).items():
        monkeypatch.setattr(tw, k, v)
    init = tw.make_wrcq(tw.make_code(), "cpu").weights
    rep = tw.run(frames=32, epochs=1, device="cpu", verbose=False)
    with open(in_tmp / tw.DEFAULT_OUT) as f:
        assert json.load(f) == rep
    rec = _record("train_wrcq")
    _same_keys(rep, rec)
    assert list(rep["curves"]) == list(rec["curves"])
    assert rep["train_epochs"] == 1
    for c in rep["curves"].values():
        assert c["snr_values"] == rec["curves"]["float-MS"]["snr_values"]
        assert c["total_frames"] == [32] * 5
    assert sorted(os.listdir(in_tmp)) == [tw.DEFAULT_OUT]
    assert all(torch.equal(w, tw.make_wrcq(tw.make_code(), "cpu").weights[k])
               for k, w in init.items())


def test_rate_specific_run_writes_the_jax_keys(in_tmp, monkeypatch):
    """k=96, one step of 16 frames a rate, waves of 32."""
    for k, v in dict(BATCH=16, NUM_SAMPLES=16, WAVE=32).items():
        monkeypatch.setattr(rs, k, v)
    rep = rs.run(k=96, frames=32, epochs=1, device="cpu", verbose=False)
    with open(in_tmp / rs.DEFAULT_OUT) as f:
        assert json.load(f) == rep
    rec = _record("rate_specific")
    assert list(rep) == list(rec) and rep["k"] == rec["k"]
    assert list(rep["rates"]) == list(rec["rates"]) == ["0.333", "0.500",
                                                        "0.667"]
    for r, v in rep["rates"].items():
        assert list(v) == list(rec["rates"][r])
        assert v["n"] == rec["rates"][r]["n"]
        _same_keys(v, rec["rates"][r])
        for name, c in v["curves"].items():
            assert c["snr_values"] == rec["rates"][r]["curves"][name][
                "snr_values"]


def test_train_wrcq_qc9472_run_writes_the_jax_keys(in_tmp, monkeypatch):
    """At lift 8 on the bench base's first 12 columns, 2 epochs of one
    step of 16 frames, waves of 32: the trainer's accuracy early stop
    (0.99, the config's default, which the program keeps) ends training
    after the first epoch, as the JAX record's ``"train_epochs": 1`` of
    the program's 8."""
    full = deep_fer.bench_base
    monkeypatch.setattr(deep_fer, "bench_base",
                        lambda lift: full(lift)[:, :12])
    for k, v in dict(BATCH=16, NUM_SAMPLES=16, WAVE=32).items():
        monkeypatch.setattr(tq, k, v)
    rep = tq.run(lift=8, frames=32, epochs=2, device="cpu", verbose=False)
    with open(in_tmp / tq.DEFAULT_OUT) as f:
        assert json.load(f) == rep
    rec = _record("train_wrcq_qc9472")
    _same_keys(rep, rec)
    assert list(rep["curves"]) == list(rec["curves"])
    assert rep["params"] == rec["params"] == 20
    assert rep["train_epochs"] == rec["train_epochs"] == 1
    assert tq.training_config(8).early_stop_accuracy == 0.99


def _narrow_pbrl():
    """The PBRL base's last six incremental-redundancy rows and the
    columns they touch (their degree-1 columns included), shifts mod 8."""
    sub = PBRL[0][18:]
    sub = sub[:, (sub >= 0).any(axis=0)]
    return np.where(sub >= 0, sub % 8, -1), 8


def test_rate_specific_deep_run_resumes(in_tmp, monkeypatch):
    """Narrowed (6 rows, 17 columns, lift 8), one step of 16 frames a
    candidate, waves of 64 under the {3, 10} compaction at 2.6 and 2.8
    dB: the report has the program's keys, the candidates' tables are
    saved, and a second run (OMS-6bit's curve cut to its first point)
    recomputes its second point with the same statistics."""
    monkeypatch.setattr(rsd, "protograph", _narrow_pbrl)
    for k, v in dict(BATCH=16, NUM_SAMPLES=16, WAVE=64, BUDGET=32,
                     MIN_FRAMES=64).items():
        monkeypatch.setattr(rsd, k, v)
    run = functools.partial(rsd.run, frames=64, errors=1, epochs=1,
                            snr_lo=2.6, snr_hi=2.8, device="cpu",
                            verbose=False)
    first = run()
    with open(in_tmp / rsd.DEFAULT_OUT) as f:
        assert json.load(f) == first
    rec = _record("rate_specific_deep")
    _same_keys(first, rec)
    assert list(first["curves"]) == list(rec["curves"])
    assert list(first["gain_db"]) == list(rec["gain_db"])
    for tag, _ in rsd.CANDIDATES:
        w = lt.utils.checkpoint.load_checkpoint(rsd.checkpoint_dir(tag))
        assert set(w) == {"beta", "alpha"}
    path = os.path.join(rsd.CHECKPOINTS, f"{rsd.OMS}.json")
    with open(path) as f:
        c = json.load(f)
    with open(path, "w") as f:
        json.dump({k: (v[:1] if isinstance(v, list) and k != "snr_values"
                       else v) for k, v in c.items()}, f)
    again = run()
    for name in first["curves"]:
        a, b = first["curves"][name], again["curves"][name]
        assert {k: v for k, v in a.items() if k != "simulation_times"} == \
            {k: v for k, v in b.items() if k != "simulation_times"}
        assert (a["simulation_times"][1:] == b["simulation_times"][1:]) == \
            (name != rsd.OMS)
    assert sorted(os.listdir(in_tmp)) == sorted(
        [rsd.DEFAULT_OUT, rsd.CHECKPOINTS] +
        [rsd.checkpoint_dir(t) for t, _ in rsd.CANDIDATES])


@pytest.mark.parametrize("twin", list(TWINS.values()),
                         ids=lambda m: m.__name__.split(".")[-1])
def test_twin_needs_a_card_unless_told_cpu(twin, monkeypatch):
    """Each twin runs on the card by default: without one it raises before
    it decodes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    with pytest.raises(RuntimeError, match="CUDA card"):
        twin.main([])
