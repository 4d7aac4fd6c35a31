"""The bench-knob and short-schedule programs' twins
(``ldpc_tpu_torch.cli.bench_ab_s``, ``.ee_trained``, ``.bench_dde``,
``.train_layered_short``) on the CPU.

Each twin's constants, decoders, ``SimulationConfig`` and
``TrainingConfig`` are held to the JAX program's: the module constants
imported from ``experiments/``, the values local to a program's function
copied here with their lines. ``bench_dde`` and ``train_layered_short``
are compared at lift 16 (the twins' ``LIFT``, monkeypatched); the
``ee_trained`` decoders at lift 256, the lift of the zoo entry it loads
(building them decodes nothing). The per-layer wiring equals
``ldpc_tpu``'s, and a per-layer decoder with the JAX program's trained
``[4, 5]`` tables (``experiments/orcq_layered_t4_pl_ck``, read with orbax
here) decodes through K1's plain version as ``ldpc_tpu``'s layered QC
engine does, run op by op (``jax.disable_jit``), in f32. The arm and
verdict rules give the committed JSONs' arms and verdicts. The two-
checkpoint decode gives the same bits under every survivor budget. Each
twin runs at a tiny size in a temporary directory and writes the JAX
program's keys there, never under ``experiments/`` or ``zoo/``; a second
``bench_dde`` deep run resumes with identical statistics. That the twins
import without jax is checked with the campaign twins'
(``test_torch_campaigns.py``).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.bench_dde as jax_bench_dde
import experiments.ee_trained as jax_ee
import experiments.train_layered_short as jax_short
import ldpc_tpu
import ldpc_tpu_torch as lt
from ldpc_tpu.decode.qc_engine import build_qc_graph as jax_build_qc_graph
from ldpc_tpu.decode.qc_engine import qc_decode_batch_layered
from ldpc_tpu.sim import SimulationConfig as JaxSimulationConfig
from ldpc_tpu.train import TrainingConfig as JaxTrainingConfig
from ldpc_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from ldpc_tpu_torch.cli import bench, bench_ab_s, bench_dde, deep_fer
from ldpc_tpu_torch.cli import ee_trained as ee
from ldpc_tpu_torch.cli import train_layered_short as short
from torch_port_helpers import (assert_same_config, assert_same_decoder,
                                channel_llr,
                                one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
LIFT = 16
FUSED = dict(fused=True, batch_tile=64, dtype=jnp.bfloat16)
LEAN = dict(FUSED, lean=True, natural=True)


def _record(name):
    with open(os.path.join(EXP, f"{name}_results.json")) as f:
        return json.load(f)


def _jax_decoder(lift, T, kind, qp, options, **kw):
    """A layered decoder of the JAX programs on the bench code: their
    ``mk`` (``ee_trained.py:66-70``, ``bench_dde.py:52-57``,
    ``train_layered_short.py:59-70``)."""
    base = np.random.default_rng(0).integers(0, lift, size=(5, 37))
    return ldpc_tpu.make_decoder(
        ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T),
        kind=kind, bc=3, bv=8, quantizer_params=qp,
        v2c_quantizer_params=jax_ee.VQP, max_iterations=T,
        qc=jax_build_qc_graph(base, lift), layered=True, qc_options=options,
        **kw)


def _small_bench(device="cpu", qp=bench.QP_DDE):
    """``bench.bench_decoder`` at lift 16."""
    base = deep_fer.bench_base(LIFT)
    return lt.make_decoder(
        lt.create_qc_code(base, lift=LIFT, max_iterations=6), kind="rcq",
        bc=3, bv=8, quantizer_params=qp, v2c_quantizer_params=jax_ee.VQP,
        max_iterations=6, qc=lt.build_qc_graph(base, LIFT), layered=True,
        qc_options=dict(fused=True, batch_tile=64, dtype=torch.bfloat16,
                        lean=True, natural=True), device=device)


# -- configurations ----------------------------------------------------------

def test_bench_ab_s_and_ee_trained_constants_equal_the_jax_programs():
    """``bench_ab_s.py:39-55`` (local to its ``main``, copied here) and
    ``ee_trained.py``'s module constants and ``:105-127``."""
    assert bench_ab_s.BUDGETS == (512, 256, 128) and bench_ab_s.T1 == 3
    assert (bench.B, bench.SNR_DB, bench.T) == (32768, 7.0, 6)
    assert (bench_ab_s.SETS, bench_ab_s.TRIALS, bench.REPS) == (2, 4, 10)
    assert ee.QP == jax_ee.QP and ee.QP_DDE == jax_ee.QP_DDE == bench.QP_DDE
    assert bench.VQP == jax_ee.VQP and bench.T == jax_ee.T
    assert (ee.B, ee.B_BIG, ee.T1S, ee.SURVEY_BUDGET) == (8192, 16384,
                                                          (2, 3), 8192)
    assert (bench.WARMUP, bench.TRIALS) == (2, 3)  # ee_trained.py:81-95
    assert ee.WEIGHTS == "worcq_bc3_layered_t6"
    for twin in (bench_ab_s, ee, bench_dde, short):
        assert os.path.dirname(twin.DEFAULT_OUT) == ""


@pytest.fixture(scope="module")
def ee_decoders():
    return ee.decoders("cpu")


@pytest.mark.parametrize("name", ["plain", "trained", "dde"])
def test_ee_trained_decoders_equal_the_jax_program(ee_decoders, name):
    """At lift 256 (``ee_trained.py:66-74``): the trained decoder from the
    zoo entry with the program's options, weights and all."""
    if name == "trained":
        jdec = ldpc_tpu.load_pretrained("worcq_bc3_layered_t6",
                                        qc_options=dict(LEAN))
    else:
        qp = jax_ee.QP if name == "plain" else jax_ee.QP_DDE
        jdec = _jax_decoder(256, jax_ee.T, "rcq", qp, dict(LEAN))
    assert_same_decoder(ee_decoders[name], jdec)


@pytest.mark.parametrize("kind", ["rcq", "orcq"])
def test_bench_dde_decoders_equal_the_jax_program(kind, monkeypatch):
    """At lift 16 (``bench_dde.py:52-57``); the orcq weights are drawn by
    each package's own generator (shapes only)."""
    monkeypatch.setattr(bench_dde, "LIFT", LIFT)
    kw = {} if kind == "rcq" else dict(sharing_type=2)
    jdec = _jax_decoder(LIFT, jax_bench_dde.T, kind, jax_bench_dde.QP_DDE,
                        dict(FUSED), **kw)
    assert_same_decoder(bench_dde.make(kind, "cpu"), jdec,
                        weights=kind == "rcq")


@pytest.mark.parametrize("T,kind,per_layer", [
    (6, "rcq", False), (5, "rcq", False), (5, "orcq", False),
    (5, "orcq", True), (4, "orcq", False), (4, "orcq", True)])
def test_short_schedule_decoders_equal_the_jax_program(T, kind, per_layer,
                                                      monkeypatch):
    """At lift 16 (``train_layered_short.py:59-70``): every decoder of the
    FER table, the per-layer ones with ``ldpc_tpu``'s per-layer wiring
    (``ldpc_tpu/decode/variants.py:445-455``: ``[T, 5]`` tables, one
    bucket per base row)."""
    kw = {} if kind == "rcq" else dict(sharing_type=2, per_layer=per_layer)
    jdec = _jax_decoder(LIFT, T, kind, jax_short.QP, dict(FUSED), **kw)
    monkeypatch.setattr(short, "LIFT", LIFT)
    tdec = short.make(T, kind, "cpu", per_layer=per_layer)
    assert_same_decoder(tdec, jdec, weights=kind == "rcq")
    if kind == "orcq":
        spec = tdec.spec
        assert (spec.n_beta, spec.n_alpha) == ((5, 5) if per_layer
                                               else (1, 1))
        assert tdec.weights["beta"].shape == (T, spec.n_beta)
        want = tdec.qc.block_row if per_layer else 0
        np.testing.assert_array_equal(spec.beta_idx, want * np.ones_like(
            spec.beta_idx))
        np.testing.assert_array_equal(spec.alpha_idx, spec.beta_idx)


def test_configs_equal_the_jax_programs():
    """``bench_dde.py:66-71, 103-107`` and ``train_layered_short.py:85-90,
    108-111``, by their own arguments; the committed curves' SNR lists, as
    resuming compares them."""
    assert_same_config(bench_dde.deep_config(device="cpu"),
                       JaxSimulationConfig(
                           snr_range=(6.4, 6.7), snr_step=0.1,
                           max_frames=5 * 10 ** 7, max_errors=100,
                           min_frames=131072, wave_size=32768,
                           early_exit_iters=3, survivor_budget=4096,
                           save_results=False))
    for c in _record("bench_dde")["curves"].values():
        assert c["snr_values"] == [float(s) for s in bench_dde.deep_config(
            device="cpu").snr_points()]
    for epochs in (30, 24):
        steps = epochs * (2048 // 128)
        assert dataclasses.asdict(bench_dde.training_config(epochs)) == \
            dataclasses.asdict(JaxTrainingConfig(
                batch_size=128, num_epochs=epochs, learning_rate=2e-3,
                snr_range=(5.5, 7.5), lr_schedule="cosine", warmup_steps=8,
                decay_steps=steps, early_stop_accuracy=2.0, seed=0))
    assert_same_config(short.fer_config(65536, "cpu"), JaxSimulationConfig(
        snr_range=(0, 0), max_frames=65536, max_errors=10 ** 9,
        min_frames=0, wave_size=16384, seed=11))
    assert short.POINTS == (6.25, 6.5) and short.QP == jax_short.QP
    assert short.VQP == jax_short.VQP == jax_bench_dde.VQP
    assert bench_dde.QP_DDE == jax_bench_dde.QP_DDE
    assert (bench_dde.T, bench_dde.ZOO_ENTRY) == (
        jax_bench_dde.T, os.path.basename(jax_bench_dde.ZOO_PATH))
    assert bench_dde.NUM_SAMPLES == 2048
    assert list(_record("train_layered_short")["fers"]) == [
        short.BENCH, "RCQ-L5"] + [short.candidate_name(T, pl)
                                  for T in (5, 4) for pl in (False, True)]


# -- the pure rules ----------------------------------------------------------

def test_arm_rule_on_the_jax_counts():
    """The JAX run's survivor counts select the JAX run's arms, in order;
    counts at the thresholds select every arm, one past them none of the
    optional ones."""
    rec = _record("ee_trained")
    counts = {k: v for k, v in rec.items() if k.startswith("survivors_")}
    assert [a[0] for a in ee.arms(counts)] == [
        k for k in rec if not k.startswith("survivors_")]
    edge = {k: (768 if "t1=2" in k else 96) for k in counts}
    names = [a[0] for a in ee.arms(edge)]
    assert names == ["bench_plain_t1=3_S128_B8192",
                     "trained_t1=2_S1024_B8192", "trained_t1=3_S128_B8192",
                     "dde_t1=2_S1024_B8192", "dde_t1=3_S128_B8192",
                     "bench_plain_t1=3_S256_B16384"]
    for name, tag, t1, S, B in ee.arms(edge):
        assert name == (f"{'bench_' if tag == 'plain' else ''}{tag}_t1={t1}_"
                        f"S{S}_B{B}")
    over = {k: v + 1 for k, v in edge.items()}
    assert [a[0] for a in ee.arms(over)] == [names[0], names[-1]]


def test_verdict_rule_on_the_jax_fers():
    rec = _record("train_layered_short")
    cands = [k for k in rec["fers"] if k.startswith("W-")]
    assert short.verdicts(rec["fers"], cands) == rec["verdicts"]
    fers = dict(rec["fers"], **{cands[0]: rec["fers"][short.BENCH]})
    assert short.verdicts(fers, cands)[cands[0]].startswith("REPLACES")


# -- decoding ----------------------------------------------------------------

def test_per_layer_k1_equals_the_jax_layered_engine(monkeypatch):
    """T=4 per-layer W-OMS-RCQ with the JAX program's trained [4, 5]
    tables, at lift 16, f32, 64 frames at 6.5 dB: K1's plain version and
    ``ldpc_tpu``'s layered QC engine give the same hard outputs."""
    ck = {k: np.asarray(v) for k, v in jax_load_checkpoint(
        os.path.join(EXP, "orcq_layered_t4_pl_ck")).items()}
    assert {k: v.shape for k, v in ck.items()} == {"beta": (4, 5),
                                                   "alpha": (4, 5)}
    jdec = _jax_decoder(LIFT, 4, "orcq", jax_short.QP, None, sharing_type=2,
                        per_layer=True)
    jdec.weights = {k: jnp.asarray(v) for k, v in ck.items()}
    monkeypatch.setattr(short, "LIFT", LIFT)
    tdec = short.make(4, "orcq", "cpu", per_layer=True)
    tdec = tdec.replace_weights(lt.weights_from_numpy(ck, device="cpu"))
    llr = channel_llr(64, tdec.code.n, 6.5, seed=45)
    with jax.disable_jit():
        ref = qc_decode_batch_layered(jnp.asarray(llr), jdec.weights,
                                      qc=jdec.qc, spec=jdec.spec,
                                      max_iterations=4)
    out = lt.qc_fused_decode_batch_layered(
        torch.from_numpy(llr), tdec.weights, qc=tdec.qc, spec=tdec.spec,
        max_iterations=4, dtype=torch.float32)
    ok = np.asarray(ref.success)
    assert 0 < ok.sum() < 64
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(), ok)


def test_budget_does_not_change_the_bits():
    """The bench decoder at lift 16 under {3, 6}, 256 frames at 6.5 dB:
    the survivors fit every budget, and S = 512, 256, 128 give the same
    bits and survivor count (stage 2 decodes each survivor alone)."""
    dec = _small_bench()
    llr = torch.from_numpy(channel_llr(256, dec.code.n, 6.5, seed=12))
    outs = {S: fn(llr) for S, fn in bench_ab_s.budget_decoders(dec).items()}
    bits0, n0 = outs[512][0].bits, int(outs[512][1])
    assert 0 < n0 <= 128
    for S, (out, n) in outs.items():
        assert int(n) == n0 and torch.equal(out.bits, bits0), S


def test_time_arm_records_an_overflow():
    """An arm whose survivors overflow its budget is recorded as
    ``(None, the count)`` (its first warm-up wave)."""
    dec = _small_bench()
    llrs = [torch.from_numpy(channel_llr(64, dec.code.n, 6.0, seed=s))
            for s in (1, 2)]
    n = ee.survivors_at(dec, 3, llrs[0], 64)
    tight = lt.make_two_checkpoint_decoder(dec, t1=3, survivor_budget=n - 1)
    assert n > 1 and ee.time_arm(tight, llrs, n - 1) == (None, n)


# -- the twins at a tiny size ------------------------------------------------

@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run in ``tmp_path`` on the bench protograph's first 12 columns at
    lift 16 (a third of its blocks, so a third of the plain K1's
    operations), one trial of one wave; afterwards nothing under
    ``experiments/`` or ``zoo/`` has changed."""
    def snapshot():
        return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                for top in ("experiments", "zoo")
                for d, _, fs in os.walk(os.path.join(REPO, top)) for f in fs}

    before = snapshot()
    monkeypatch.chdir(tmp_path)
    full = deep_fer.bench_base
    monkeypatch.setattr(deep_fer, "bench_base", lambda lift: full(lift)[:, :12])
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.setattr(bench, "TRIALS", 1)
    yield tmp_path
    assert snapshot() == before


def test_bench_ab_s_run_writes_the_jax_keys(in_tmp, monkeypatch, capsys):
    """The bench decoder (narrowed), B=64, one LLR set, one trial of one
    wave a budget."""
    monkeypatch.setattr(bench, "bench_decoder", _small_bench)
    monkeypatch.setattr(bench, "B", 64)
    monkeypatch.setattr(bench_ab_s, "SETS", 1)
    monkeypatch.setattr(bench_ab_s, "TRIALS", 1)
    bench_ab_s.main(["--device", "cpu"])
    with open(in_tmp / bench_ab_s.DEFAULT_OUT) as f:
        res = json.load(f)
    assert list(res) == list(_record("bench_ab_s")) == ["512", "256", "128"]
    assert all(v > 0 for v in res.values())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res


def test_ee_trained_run_writes_the_jax_keys(in_tmp, monkeypatch):
    """The three decoders (narrowed; the trained one with the zoo entry's
    tables), B=64 and 128 (the survey's budget 64), one trial of
    one wave an arm; the optional arms left out (each costs seconds of the
    plain K1 on the CPU; :func:`test_arm_rule_on_the_jax_counts` holds the
    rule), which leaves the two the program always times."""
    def small(device="cpu"):
        trained = short.make(6, "orcq", device)
        trained = dataclasses.replace(trained, qc_options=dict(ee.LEAN))
        return {"plain": _small_bench(device, ee.QP),
                "trained": trained.replace_weights(
                    deep_fer.load_weights(ee.WEIGHTS)),
                "dde": _small_bench(device)}

    monkeypatch.setattr(short, "LIFT", LIFT)
    monkeypatch.setattr(ee, "decoders", small)
    monkeypatch.setattr(ee, "B", 64)
    monkeypatch.setattr(ee, "B_BIG", 128)
    monkeypatch.setattr(ee, "SURVEY_BUDGET", 64)
    monkeypatch.setattr(ee, "T1_2_MAX", -1)
    monkeypatch.setattr(ee, "T1_3_MAX", -1)
    res = ee.run("cpu", verbose=False)
    with open(in_tmp / ee.DEFAULT_OUT) as f:
        assert json.load(f) == res
    rec = _record("ee_trained")
    survey = [k for k in rec if k.startswith("survivors_")]
    assert list(res) == survey + ["bench_plain_t1=3_S128_B8192",
                                  "bench_plain_t1=3_S256_B16384"]
    for name in list(res)[len(survey):]:
        assert list(res[name]) == list(rec[name]) == ["cw_per_sec",
                                                      "max_survivors"]
        assert res[name]["cw_per_sec"] > 0
    assert all(0 <= res[k] <= 64 for k in survey)


def _cut(path, keep):
    with open(path) as f:
        c = json.load(f)
    for k, v in c.items():
        if isinstance(v, list) and k != "snr_values":
            c[k] = v[:keep]
    with open(path, "w") as f:
        json.dump(c, f)


def test_bench_dde_trains_then_resumes_deep(in_tmp, monkeypatch):
    """Narrowed: ``--phase train`` (one epoch of one batch of 128) writes
    the entry in the working directory, ``deep`` (waves of 64, budget 64,
    64 frames a point at 6.4 and 6.5 dB) then reads it, not the zoo's; a
    second deep run, W-ORCQ-dde-L6's curve cut to its first point,
    recomputes the second with the same statistics."""
    monkeypatch.setattr(bench_dde, "LIFT", LIFT)
    for k in ("WAVE", "BUDGET", "MIN_FRAMES"):
        monkeypatch.setattr(bench_dde, k, 64)
    monkeypatch.setattr(bench_dde, "SNR_HI", 6.5)
    monkeypatch.setattr(bench_dde, "train", functools.partial(
        bench_dde.train, num_samples=128))
    monkeypatch.setattr(lt.PosteriorJointTrainer, "train",
                        functools.partialmethod(lt.PosteriorJointTrainer.train,
                                                val_samples=8))
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    assert bench_dde.trained_source() == bench_dde.ZOO_ENTRY
    bench_dde.main(["--phase", "train", "--epochs", "1", "--device", "cpu"])
    assert bench_dde.trained_source() == bench_dde.TRAINED_DIR
    saved = lt.load_pretrained(bench_dde.TRAINED_DIR, device="cpu")
    assert saved.weights["beta"].shape == (6, 1)
    assert saved.recipe["quantizer_params"] == [list(p) for p in
                                                bench_dde.QP_DDE]
    deep = functools.partial(bench_dde.deep, frames=64, device="cpu",
                             verbose=False)
    first = deep()
    with open(in_tmp / bench_dde.DEFAULT_OUT) as f:
        assert json.load(f) == first
    rec = _record("bench_dde")
    assert list(first) == list(rec)
    assert list(first["curves"]) == list(rec["curves"])
    for name, c in first["curves"].items():
        assert list(c) == list(rec["curves"][name])
        assert c["total_frames"] == [64] * 2
    _cut(os.path.join(bench_dde.CHECKPOINTS, "W-ORCQ-dde-L6.json"), 1)
    again = deep()
    for name in first["curves"]:
        a, b = first["curves"][name], again["curves"][name]
        assert {k: v for k, v in a.items() if k != "simulation_times"} == \
            {k: v for k, v in b.items() if k != "simulation_times"}
        assert (a["simulation_times"][1:] == b["simulation_times"][1:]) == \
            (name == "RCQ-dde-L6")
    assert sorted(os.listdir(in_tmp)) == sorted([
        bench_dde.TRAINED_DIR, bench_dde.CHECKPOINTS, bench_dde.DEFAULT_OUT])


def test_train_layered_short_run_writes_the_jax_keys(in_tmp, monkeypatch):
    """Narrowed, one epoch of one batch of 128 an arm, 32 frames a
    point: the report's keys and decoders are the JAX run's, each arm's
    checkpoint holds its tables ([T, 5] per layer)."""
    monkeypatch.setattr(short, "LIFT", LIFT)
    monkeypatch.setattr(short, "train_candidates", functools.partial(
        short.train_candidates, num_samples=128))
    monkeypatch.setattr(short, "WAVE", 32)
    monkeypatch.setattr(lt.PosteriorJointTrainer, "train",
                        functools.partialmethod(lt.PosteriorJointTrainer.train,
                                                val_samples=8))
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    rep = short.run(epochs=1, frames=32, device="cpu", verbose=False)
    with open(in_tmp / short.DEFAULT_OUT) as f:
        assert json.load(f) == rep
    rec = _record("train_layered_short")
    assert list(rep) == list(rec)
    assert list(rep["fers"]) == list(rec["fers"])
    assert list(rep["verdicts"]) == list(rec["verdicts"])
    assert all(list(v) == ["6.25", "6.5"] for v in rep["fers"].values())
    for T in (5, 4):
        for pl in (False, True):
            w = lt.utils.checkpoint.load_checkpoint(
                short.checkpoint_dir(T, pl))
            assert {k: tuple(v.shape) for k, v in w.items()} == {
                k: (T, 5 if pl else 1) for k in ("beta", "alpha")}
    assert len(os.listdir(in_tmp)) == 5


@pytest.mark.parametrize("twin", [bench_ab_s, ee, bench_dde, short],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_twin_needs_a_card_unless_told_cpu(twin, monkeypatch):
    """Each twin runs on the card by default: without one it raises before
    it decodes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    with pytest.raises(RuntimeError, match="CUDA card"):
        twin.main([])
