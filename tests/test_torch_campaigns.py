"""The FER campaign programs' twins (``ldpc_tpu_torch.cli.fer_parity``,
``.accuracy_bc3``, ``.deep_fer``, ``.deep_fer_trained_l6``) on the CPU.

Each twin's decoders and configurations are held to the JAX program's,
built by its own arguments (``experiments/fer_parity.py:50-67``,
``accuracy_bc3.py:54-131``, ``deep_fer.py:59-98``,
``deep_fer_trained_l6.py:42-61``, copied here) at lift 16 where the
program takes a lift, without decoding: H, the QC tables, the variant
spec (quantizer thresholds and parameters), the weights where they are
not drawn at random, the ``SimulationConfig`` and ``TrainingConfig``
fields. The zoo entries the twins read hold the tables of the JAX
programs' orbax checkpoints. The deep-FER wave (K1's plain version under
the {3, 6} compaction) is held to ``ldpc_tpu``'s layered QC engine on the
same numpy LLRs: hard outputs and counts exactly, in f32 (in bf16 the
engine rounds at other points than the kernel; the kernel is held to its
plain version bit for bit on the card, ``tests_gpu/
test_campaigns_cuda.py``). The engine runs op by op
(``jax.disable_jit``): compiling its unrolled graph at lift 16 takes
about a minute. The twins' ``run`` functions write the JAX programs' keys
at a tiny size in a temporary directory, never under ``experiments/``,
and the deep-FER twins resume with identical statistics.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu_torch as lt
from experiments.fer_parity import snr_at_fer as jax_snr_at_fer
from ldpc_tpu.decode.qc_engine import build_qc_graph as jax_build_qc_graph
from ldpc_tpu.decode.qc_engine import qc_decode_batch_layered
from ldpc_tpu.sim import SimulationConfig as JaxSimulationConfig
from ldpc_tpu.train import TrainingConfig as JaxTrainingConfig
from ldpc_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from ldpc_tpu_torch.cli import accuracy_bc3 as acc
from ldpc_tpu_torch.cli import deep_fer, fer_parity
from ldpc_tpu_torch.cli import deep_fer_trained_l6 as l6
from ldpc_tpu_torch.sim.montecarlo import _CompactingWave
from torch_port_helpers import (assert_same_config, assert_same_decoder,
                                assert_same_fields, channel_llr,
                                one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
LIFT = 16
QP = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
RESULTS = {"fer_parity": "fer_parity_results.json",
           "accuracy_bc3": "accuracy_bc3_results.json",
           "deep_fer": "deep_fer_results.json",
           "deep_fer_trained_l6": "deep_fer_trained_l6_results.json"}


def _jax_result(program):
    with open(os.path.join(EXP, RESULTS[program])) as f:
        return json.load(f)


def _curves(report):
    return report["curves"] if "curves" in report else {
        "curve": report["curve"]}


# -- the JAX programs' decoders, by their own arguments ---------------------

def _bench(lift, T):
    base = np.random.default_rng(0).integers(0, lift, size=(5, 37))
    return (ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T),
            jax_build_qc_graph(base, lift))


def _jax_parity():
    """``experiments/fer_parity.py:50-64``."""
    code = ldpc_tpu.create_peg_code(n=256, m=128, dv=3, seed=0,
                                    max_iterations=20)
    qparams = ((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))
    return {
        "float-MS": ldpc_tpu.basic_min_sum(code, factor=0.7,
                                           max_iterations=20),
        "RCQ-bc3": ldpc_tpu.rcq_min_sum(code, bc=3, quantizer_params=qparams,
                                        max_iterations=20),
        "RCQ-bc3-bv8": ldpc_tpu.rcq_min_sum(code, bc=3, bv=8,
                                            quantizer_params=qparams,
                                            max_iterations=20),
        "RCQ-bc4": ldpc_tpu.rcq_min_sum(code, bc=4, quantizer_params=qparams,
                                        max_iterations=20),
    }


def _jax_accuracy(qparams):
    """``experiments/accuracy_bc3.py:54-131``'s decoders on ``qparams``:
    the dev sweep's RCQ, the two before training, and the waterfall's
    three untrained ones."""
    code, qc = _bench(LIFT, 10)
    perf = dict(fused=True, batch_tile=64, dtype=jnp.bfloat16)

    def mk(kind, qp, **kw):
        return ldpc_tpu.make_decoder(
            code, kind=kind, bc=3, bv=8, quantizer_params=qp,
            max_iterations=10, qc=qc, qc_options=perf, **kw)

    vqp_uni = tuple((2.0 * C, 1.0) for C, _ in qparams)
    return {
        "dev": mk("rcq", qparams),
        "W-OMS-RCQ": mk("orcq", qparams, sharing_type=2,
                        v2c_quantizer_params=vqp_uni, init="reference",
                        seed=0),
        "W-RCQ": mk("wrcq", qparams, sharing_type=2,
                    v2c_quantizer_params=vqp_uni, init="nms", seed=0),
        "float-MS": ldpc_tpu.make_decoder(code, kind="ms", qc=qc,
                                          max_iterations=10,
                                          qc_options=perf),
        "RCQ-bc3-bv8": mk("rcq", qparams),
        "RCQ-bc3-bv8uni": mk("rcq", qparams, v2c_quantizer_params=tuple(
            (2.0 * C, 1.0) for C, _ in qparams)),
    }


def _jax_deep_fer():
    """``experiments/deep_fer.py:59-91`` and
    ``deep_fer_trained_l6.py:42-53``, each trained decoder with its orbax
    checkpoint's weights."""
    fused = dict(fused=True, batch_tile=64, dtype=jnp.bfloat16)
    code6, qc = _bench(LIFT, 6)
    code10, _ = _bench(LIFT, 10)
    rcq = dict(kind="rcq", bv=8, quantizer_params=QP,
               v2c_quantizer_params=VQP, max_iterations=6, qc=qc,
               layered=True, qc_options=fused)
    out = {
        "RCQ-bc3-L6": ldpc_tpu.make_decoder(code6, bc=3, **rcq),
        "RCQ-bc4-L6": ldpc_tpu.make_decoder(code6, bc=4, **rcq),
        "float-MS-L6": ldpc_tpu.make_decoder(
            code6, kind="ms", max_iterations=6, qc=qc, layered=True,
            qc_options=fused),
    }
    orcq = dict(kind="orcq", bc=3, bv=8, sharing_type=2, quantizer_params=QP,
                v2c_quantizer_params=VQP, qc=qc, qc_options=fused)
    for name, code, T, layered, ck in (
            ("W-OMS-RCQ-bc3-trained", code10, 10, False, "orcq_bc3_ck"),
            (l6.NAME, code6, 6, True, "orcq_layered_t6_ck")):
        dec = ldpc_tpu.make_decoder(code, max_iterations=T, layered=layered,
                                    **orcq)
        dec.weights = {k: jnp.asarray(v) for k, v in
                       jax_load_checkpoint(os.path.join(EXP, ck)).items()}
        out[name] = dec
    return out


@pytest.fixture(scope="module")
def deep_jax():
    return _jax_deep_fer()


@pytest.mark.parametrize("name", ["float-MS", "RCQ-bc3", "RCQ-bc3-bv8",
                                  "RCQ-bc4"])
def test_fer_parity_decoders_equal_the_jax_program(name):
    assert_same_decoder(fer_parity.parity_decoders("cpu")[name],
                        _jax_parity()[name])


@pytest.mark.parametrize("ladder", list(acc.LADDERS))
def test_accuracy_dev_decoders_equal_the_jax_program(ladder):
    """The dev sweep's RCQ on each ladder; the JAX program's ladders."""
    code, qc = acc.bench_code(LIFT)
    qp = acc.LADDERS[ladder]
    assert_same_decoder(acc.make(code, qc, "rcq", qp, "cpu"),
                        _jax_accuracy(qp)["dev"])


@pytest.mark.parametrize("ladder", ["2-4-6@1.3", "3-5-7@1.6"])
def test_accuracy_trained_and_waterfall_decoders(ladder):
    """The pair before training (weights drawn by each package's own
    generator: shapes only) and the waterfall's three untrained decoders,
    on the ladder the JAX run selected and on the runner-up."""
    code, qc = acc.bench_code(LIFT)
    qp = acc.LADDERS[ladder]
    jax_decs = _jax_accuracy(qp)
    pair = acc.untrained_pair(code, qc, qp, "cpu")
    for name, dec in pair.items():
        assert_same_decoder(dec, jax_decs[name], weights=False)
    falls = acc.waterfall_decoders(code, qc, qp, {
        k: (d, 0.0) for k, d in pair.items()}, "cpu")
    assert list(falls) == list(_jax_result("accuracy_bc3")["curves"])
    for name in ("float-MS", "RCQ-bc3-bv8", "RCQ-bc3-bv8uni"):
        assert_same_decoder(falls[name], jax_decs[name])
    assert falls["W-OMS-RCQ-bc3-trained"] is pair["W-OMS-RCQ"]


@pytest.mark.parametrize("name", ["RCQ-bc3-L6", "RCQ-bc4-L6", "float-MS-L6",
                                  "W-OMS-RCQ-bc3-trained", l6.NAME])
def test_deep_fer_decoders_equal_the_jax_programs(deep_jax, name):
    """The three layered decoders, and the two trained ones with the zoo
    entries' weights against the orbax checkpoints' (equal element for
    element)."""
    if name == l6.NAME:
        tdec = l6.trained_layered_decoder(lift=LIFT, device="cpu")
    elif name.endswith("trained"):
        tdec = deep_fer.trained_flooding_decoder(lift=LIFT, device="cpu")
    else:
        tdec = deep_fer.layered_decoders(LIFT, "cpu")[name]
    assert_same_decoder(tdec, deep_jax[name])


def test_configs_equal_the_jax_programs():
    """Every ``SimulationConfig`` and the ``TrainingConfig`` of the four
    programs, by their own arguments."""
    for frames in (65536, 16384):  # fer_parity.py:65-67
        assert_same_config(fer_parity.parity_config(frames, "cpu"),
                           JaxSimulationConfig(
                               snr_range=(1.0, 4.0), snr_step=0.5,
                               max_frames=frames,
                               max_errors=max(200, frames // 64),
                               min_frames=min(8192, frames),
                               wave_size=4096))
    assert_same_config(acc.dev_config("cpu"), JaxSimulationConfig(
        snr_range=(6.4, 6.4), snr_step=1.0, max_frames=16384,
        max_errors=10 ** 9, min_frames=0, wave_size=4096, seed=7))
    for frames in (131072, 16384):  # accuracy_bc3.py:116-118
        assert_same_config(acc.waterfall_config(frames, "cpu"),
                           JaxSimulationConfig(
                               snr_range=(5.75, 7.25), snr_step=0.25,
                               max_frames=frames, max_errors=2000,
                               min_frames=min(16384, frames),
                               wave_size=8192))
    assert_same_fields(acc.training_config(24), JaxTrainingConfig(
        batch_size=128, num_epochs=24, learning_rate=2e-3,
        snr_range=(5.5, 7.5), early_stop_accuracy=2.0, seed=0))
    frames, errors, wave = 5 * 10 ** 7, 100, 32768

    def jax_cfg(t1, lo, hi, step):  # deep_fer.py:92-98
        return JaxSimulationConfig(
            snr_range=(lo, hi), snr_step=step, max_frames=frames,
            max_errors=errors, min_frames=min(wave * 4, frames),
            wave_size=wave, early_exit_iters=t1,
            survivor_budget=max(64, wave // 16), stage1_batch_tile=64,
            save_results=False)

    assert (deep_fer.T1_LAYERED, deep_fer.T1_FLOODING, l6.T1) == (3, 5, 2)
    for t1 in (3, 5):
        assert_same_config(deep_fer.campaign_config(t1, device="cpu"),
                           jax_cfg(t1, 6.4, 6.7, 0.1))
    snrs = (6.4, 6.5, 6.6, 6.7)  # deep_fer_trained_l6.py:55-61
    assert_same_config(l6.trained_l6_config(device="cpu"),
                       jax_cfg(2, min(snrs), max(snrs),
                               round(snrs[1] - snrs[0], 6)))
    # the committed curves' SNR lists, as resuming compares them
    for program in ("deep_fer", "deep_fer_trained_l6"):
        for c in _curves(_jax_result(program)).values():
            assert c["snr_values"] == [
                float(s) for s in deep_fer.campaign_config(
                    3, device="cpu").snr_points()]


@pytest.mark.parametrize("program", list(RESULTS))
def test_snr_at_fer_equals_the_jax_programs(program):
    """On every committed curve, at FER targets inside and outside its
    range."""
    for c in _curves(_jax_result(program)).values():
        for target in (1e-1, 1e-2, 3e-3, 1e-3, 1e-5, 1e-7, 1e-9):
            assert fer_parity.snr_at_fer(
                c["snr_values"], c["frame_error_rates"], target) == \
                jax_snr_at_fer(c["snr_values"], c["frame_error_rates"],
                               target)


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


def test_fisher_p_equals_scipy():
    """On every committed FER point against a draw around it, and on
    tables with zero, all and equal errors."""
    from scipy.stats import fisher_exact
    rng = np.random.default_rng(7)
    tables = [(0, 1024, 67, 65536), (16379, 16384, 16384, 16384),
              (100, 54034432, 100, 54034432), (5, 10, 5, 10)]
    for program in RESULTS:
        for c in _curves(_jax_result(program)).values():
            for e, f in zip(c["total_errors"], c["total_frames"]):
                g = int(rng.integers(1024, 4 * f + 1024))
                tables.append((int(rng.binomial(g, e / f)), g, e, f))
    fisher_p = _chip_smoke().fisher_p
    for e1, f1, e2, f2 in tables:
        want = fisher_exact([[e1, f1 - e1], [e2, f2 - e2]])[1]
        assert fisher_p(e1, f1, e2, f2) == pytest.approx(
            want, rel=1e-7, abs=1e-300)


@pytest.mark.parametrize("entry,ck", [("worcq_bc3_qc9472", "orcq_bc3_ck"),
                                      ("worcq_bc3_layered_t6",
                                       "orcq_layered_t6_ck")])
def test_zoo_weights_equal_the_orbax_checkpoints(entry, ck):
    ours = deep_fer.load_weights(entry)
    theirs = jax_load_checkpoint(os.path.join(EXP, ck))
    assert ours.keys() == theirs.keys() == {"alpha", "beta"}
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
        assert ours[k].dtype == torch.float32


def _jax_deep_fer_engine():
    """RCQ-bc3-L6 of ``experiments/deep_fer.py:67-70`` at lift 16 on the
    XLA layered engine (no fused options)."""
    code, qc = _bench(LIFT, 6)
    return ldpc_tpu.make_decoder(code, kind="rcq", bc=3, bv=8,
                                 quantizer_params=QP,
                                 v2c_quantizer_params=VQP, max_iterations=6,
                                 qc=qc, layered=True)


def test_compacting_wave_equals_the_jax_layered_engine():
    """RCQ-bc3-L6 at lift 16 in f32, 128 frames at 6.5 dB (about a third
    survive stage 1): the simulator's {3, 6} wave through K1's plain
    version gives the hard outputs and the four counts of ``ldpc_tpu``'s
    layered QC engine read at iterations 3 and 6 (its trajectory) and
    combined by the T=3 syndrome."""
    dec = deep_fer.layered_decoders(LIFT, "cpu")["RCQ-bc3-L6"]
    dec = dataclasses.replace(dec, qc_options=dict(dec.qc_options,
                                                   dtype=torch.float32))
    jdec = _jax_deep_fer_engine()
    llr = channel_llr(128, dec.code.n, 6.5, seed=65)
    with jax.disable_jit():
        ys = np.asarray(qc_decode_batch_layered(
            jnp.asarray(llr), jdec.weights, qc=jdec.qc, spec=jdec.spec,
            max_iterations=6, return_trajectory=True).posteriors_all)
    H = np.asarray(jdec.code.H)
    bits1, bits2 = (ys[2] < 0).astype(np.int8), (ys[5] < 0).astype(np.int8)
    ok1 = ~((bits1.astype(np.int64) @ H.T) % 2).any(axis=1)
    ok2 = ~((bits2.astype(np.int64) @ H.T) % 2).any(axis=1)
    bits = np.where(ok1[:, None], bits1, bits2)
    wrong = bits.sum(axis=1)
    want = [int((wrong > 0).sum()), int(wrong.sum()),
            int(np.where(ok1, 3, 6).sum()), int((ok1 | ok2).sum())]
    wave = _CompactingWave(dec, 128, torch.device("cpu"), 3, 128)
    x = torch.from_numpy(llr)
    out, n_surv = wave.compacted(x, dec.weights)
    assert 16 < int(n_surv) == int((~ok1).sum()) < 64
    np.testing.assert_array_equal(out.bits.numpy(), bits)
    np.testing.assert_array_equal(out.success.numpy(), ok1 | ok2)
    assert wave.counts(x) == want and want[0] > 0
    assert dict(wave.kinds) == {"compacted": 1}


# -- the twins' runs at a tiny size ------------------------------------------

@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run in ``tmp_path``; afterwards nothing under ``experiments/`` has
    changed."""
    def snapshot():
        return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                for d, _, fs in os.walk(EXP) for f in fs}

    before = snapshot()
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    assert snapshot() == before


def _keys(report):
    """The report's keys, with its curves' keys and its per-decoder
    tables' keys."""
    out = {"": sorted(report)}
    for k, v in report.items():
        if isinstance(v, dict):
            out[k] = sorted(v)
    for name, c in _curves(report).items():
        out[f"curve {name}"] = sorted(c)
    return out


def _stats(curve):
    return {k: v for k, v in curve.items() if k != "simulation_times"}


def test_fer_parity_run_writes_the_jax_keys(in_tmp, monkeypatch):
    small = lt.SimulationConfig(snr_range=(1.0, 4.0), snr_step=0.5,
                                max_frames=32, max_errors=8, min_frames=32,
                                wave_size=32, device="cpu")
    monkeypatch.setattr(fer_parity, "parity_config", lambda *a: small)
    report = fer_parity.run(65536, verbose=False, device="cpu")
    with open(in_tmp / fer_parity.DEFAULT_OUT) as f:
        assert json.load(f) == report
    assert _keys(report) == _keys(_jax_result("fer_parity"))
    assert report["target_fer"] == 1e-2 and report["gaps_db"]["float-MS"] \
        in (0.0, None)


def test_accuracy_run_writes_the_jax_keys_and_its_checkpoint(in_tmp,
                                                             monkeypatch):
    """Every step at lift 16 on the CPU: a 32-frame dev sweep of two
    ladders, one epoch of one step of 8 frames a decoder, a 32-frame
    waterfall at 6.25 dB; the trained
    W-OMS-RCQ weights land in ``orcq_bc3_torch_ck/``, which the deep-FER
    twin reads."""
    dev = lt.SimulationConfig(snr_range=(6.4, 6.4), snr_step=1.0,
                              max_frames=32, max_errors=10 ** 9,
                              min_frames=0, wave_size=32, seed=7,
                              device="cpu")
    fall = dataclasses.replace(acc.waterfall_config(32, "cpu"),
                               snr_range=(6.25, 6.25), wave_size=32)
    two = {k: acc.LADDERS[k] for k in ("3-5-7@1.3", "2-4-6@1.3")}
    monkeypatch.setattr(acc, "dev_config", lambda *a: dev)
    monkeypatch.setattr(acc, "waterfall_config", lambda *a: fall)
    full = acc.training_config
    monkeypatch.setattr(acc, "training_config", lambda epochs: dataclasses.
                        replace(full(epochs), batch_size=8))
    assert list(acc.LADDERS) == list(
        _jax_result("accuracy_bc3")["quantizer_ladder"]["dev_fers"])
    monkeypatch.setattr(acc, "LADDERS", two)
    monkeypatch.setattr(acc, "train_pair", functools.partial(
        acc.train_pair, num_samples=8))
    monkeypatch.setattr(lt.PosteriorJointTrainer, "train",
                        functools.partialmethod(lt.PosteriorJointTrainer.train,
                                                val_samples=8))
    report = acc.run(32, epochs=1, lift=LIFT, device="cpu", verbose=False)
    with open(in_tmp / acc.DEFAULT_OUT) as f:
        assert json.load(f) == report
    jax_report = _jax_result("accuracy_bc3")
    assert _keys(report) == _keys(jax_report)
    assert report["quantizer_ladder"]["selected"] in two
    assert list(report["quantizer_ladder"]["dev_fers"]) == list(two)
    saved = deep_fer.load_weights(acc.CHECKPOINT)
    dec = deep_fer.trained_flooding_decoder(acc.CHECKPOINT, LIFT, "cpu")
    assert saved.keys() == dec.weights.keys() == {"alpha", "beta"}
    for k in saved:
        assert torch.equal(saved[k], dec.weights[k])
        assert saved[k].shape == (10, 1)
    assert sorted(os.listdir(in_tmp)) == sorted([acc.DEFAULT_OUT,
                                                 acc.CHECKPOINT])


def _resumed(run, ckdir, names, keep):
    """Cut each checkpoint to its first ``keep`` points, run again, and
    return the new report."""
    for name in names:
        path = os.path.join(ckdir, f"{name}.json")
        with open(path) as f:
            c = json.load(f)
        for k, v in c.items():
            if isinstance(v, list) and k != "snr_values":
                c[k] = v[:keep]
        with open(path, "w") as f:
            json.dump(c, f)
    return run()


def test_deep_fer_run_resumes_with_identical_statistics(in_tmp):
    """Lift 16, waves of 64 frames (budget 64), 6.4 and 6.5 dB: the report
    has the JAX program's keys, each curve is checkpointed in
    ``deep_fer_torch_ck/``; a second run skips the points done and, for
    the decoder whose checkpoint is cut to the first point, recomputes the
    second with the same statistics."""
    run = functools.partial(deep_fer.run, frames=64, errors=4, lift=LIFT,
                            wave=64, snr_lo=6.4, snr_hi=6.5, device="cpu",
                            verbose=False)
    first = run()
    with open(in_tmp / deep_fer.DEFAULT_OUT) as f:
        assert json.load(f) == first
    assert _keys(first) == _keys(_jax_result("deep_fer"))
    names = list(first["curves"])
    assert names == list(_jax_result("deep_fer")["curves"])
    assert sorted(os.listdir(in_tmp / deep_fer.CHECKPOINTS)) == sorted(
        f"{n}.json" for n in names)
    again = _resumed(run, deep_fer.CHECKPOINTS, names[:1], keep=1)
    for name in names:
        a, b = first["curves"][name], again["curves"][name]
        assert _stats(a) == _stats(b)
        times = a["simulation_times"] == b["simulation_times"]
        assert a["simulation_times"][0] == b["simulation_times"][0]
        assert times == (name != names[0])  # skipped, or recomputed
        assert a["total_frames"] == [64, 64]


def test_deep_fer_trained_l6_run_resumes(in_tmp, monkeypatch):
    monkeypatch.setattr(l6, "SNRS", (6.4, 6.5))
    monkeypatch.setattr(l6, "WAVE", 64)
    run = functools.partial(l6.run, frames=64, errors=4, lift=LIFT,
                            device="cpu", verbose=False)
    first = run()
    with open(in_tmp / l6.DEFAULT_OUT) as f:
        assert json.load(f) == first
    assert _keys(first) == _keys(_jax_result("deep_fer_trained_l6"))
    assert first["weights"] == l6.WEIGHTS == "worcq_bc3_layered_t6"
    again = _resumed(run, deep_fer.CHECKPOINTS, [l6.NAME], keep=1)
    assert _stats(again["curve"]) == _stats(first["curve"])
    assert os.listdir(in_tmp / deep_fer.CHECKPOINTS) == [f"{l6.NAME}.json"]


@pytest.mark.parametrize("twin", [fer_parity, acc, deep_fer, l6],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_twin_needs_a_card_unless_told_cpu(twin, monkeypatch):
    """Each twin runs on the card by default: without one it raises before
    it decodes (``--device cpu`` runs the plain versions, as above)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    with pytest.raises(RuntimeError, match="CUDA card"):
        twin.main([])
    assert not twin.DEFAULT_OUT.startswith("experiments")
    assert os.path.dirname(twin.DEFAULT_OUT) == ""


def test_twins_import_without_jax():
    """This file's twins and those of ``test_torch_bench_programs.py``,
    ``test_torch_training_programs.py``, ``test_torch_floor_programs.py``,
    ``test_torch_design_programs.py`` and ``test_torch_rates_programs.py``
    (one interpreter start for all)."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import ldpc_tpu_torch.cli.fer_parity, "
            "ldpc_tpu_torch.cli.accuracy_bc3, ldpc_tpu_torch.cli.deep_fer, "
            "ldpc_tpu_torch.cli.deep_fer_trained_l6, "
            "ldpc_tpu_torch.cli.bench_ab_s, ldpc_tpu_torch.cli.ee_trained, "
            "ldpc_tpu_torch.cli.bench_dde, "
            "ldpc_tpu_torch.cli.train_layered_short, "
            "ldpc_tpu_torch.cli.train_wrcq, ldpc_tpu_torch.cli.rate_specific, "
            "ldpc_tpu_torch.cli.train_wrcq_qc9472, "
            "ldpc_tpu_torch.cli.rate_specific_deep, "
            "ldpc_tpu_torch.cli.pbrl_bc5, ldpc_tpu_torch.cli.pbrl_lift_floor, "
            "ldpc_tpu_torch.cli.pbrl_precode, ldpc_tpu_torch.cli.floor_is, "
            "ldpc_tpu_torch.cli.trapping_spectrum, "
            "ldpc_tpu_torch.cli.ladder_bc4, ldpc_tpu_torch.cli.bc4_refine, "
            "ldpc_tpu_torch.cli.quantizer_count, "
            "ldpc_tpu_torch.cli.dde_ladders, "
            "ldpc_tpu_torch.cli.pbrl_rates, ldpc_tpu_torch.cli.tighten89; "
            "assert 'ldpc_tpu' not in sys.modules; "
            "assert 'experiments' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=REPO))
