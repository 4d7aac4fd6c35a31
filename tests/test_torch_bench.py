"""The throughput programs' twins (``ldpc_tpu_torch.cli.bench``,
``.throughput_matrix``, ``.ee_batch``) on the CPU.

Each twin's decoders are built by the JAX programs' own arguments
(``bench.py:56-72``, ``experiments/throughput_matrix.py:87-157``,
``experiments/ee_batch.py:13-20``, copied here) in ``ldpc_tpu`` and held
equal, exactly: H, the QC tables or the Tanner graph, the variant spec
(quantizer thresholds and parameters), the weights, the batch and SNR.
Tanner (155, 64) is the one matrix entry small enough for ``ldpc_tpu``'s
interpret-mode K1 at full width: there the port's plain version equals it
(hard outputs exactly; f32 posteriors to rtol 1e-6 / atol 1e-5 for
XLA:CPU's FMA contraction; bf16 bit for bit with XLA's excess precision
off, as ``test_torch_fused_layered.py`` compiles it). The twins' waves,
overflow guard, timing loops and output lines run at small batches.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu_torch as lt
from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch_layered
from ldpc_tpu.decode.qc_engine import build_qc_graph as jax_build_qc_graph
from ldpc_tpu_torch.cli import bench, ee_batch, throughput_matrix as tm
from torch_port_helpers import (assert_same_fields, channel_llr,
                                one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QP = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))
QP_DDE = ((2.6474, 1.3), (3.0869, 1.3), (5.3767, 1.3))
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))


@pytest.fixture(scope="module")
def matrix():
    return tm.matrix_decoders("cpu")


def _jax_qc(base, lift, T, options, qp=QP, **kw):
    code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T)
    return ldpc_tpu.make_decoder(
        code, kind="rcq", bc=3, bv=8, quantizer_params=qp,
        v2c_quantizer_params=VQP, max_iterations=T,
        qc=jax_build_qc_graph(base, lift), qc_options=options, **kw)


def _jax_decoder(name):
    """``(decoder, B, snr_db)`` of a JAX program, by its own arguments."""
    bench_base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    fused = dict(fused=True, batch_tile=64, dtype=jnp.bfloat16)
    lean = dict(fused, lean=True, natural=True)
    if name in ("bench", "ee_batch"):  # bench.py:57-72, ee_batch.py:13-20
        return _jax_qc(bench_base, 256, 6, lean, qp=QP_DDE,
                       layered=True), 32768, 7.0
    if name == "bench_qc9472_layered6_fused":
        return _jax_qc(bench_base, 256, 6, fused, layered=True), 8192, 7.0
    if name == "bench_qc9472_flooding10_fused":
        return _jax_qc(bench_base, 256, 10, fused), 8192, 7.0
    if name == "dvbs2_16200_layered6_fused":
        b, lift = ldpc_tpu.load_protograph(
            os.path.join(REPO, "codes", "dvbs2_like_16200_7200.proto"))
        return _jax_qc(b, lift, 6, dict(fused, batch_tile=None),
                       layered=True), 4096, 1.6
    if name == "tanner155_layered6_fused":
        b, lift = ldpc_tpu.load_protograph(
            os.path.join(REPO, "codes", "tanner_155_64.proto"))
        return _jax_qc(b, lift, 6, dict(fused, batch_tile=512),
                       layered=True), 16384, 4.0
    if name == "pbrl3096_qc_layered10_fused":
        b, lift = ldpc_tpu.create_pbrl_qc_protograph(k=1032, rate=1 / 3)
        return _jax_qc(b, lift, 10, dict(fused, batch_tile=None),
                       layered=True), 8192, 1.2
    code = ldpc_tpu.create_pbrl_like_code(k=1032, rate=1 / 3,
                                          max_iterations=10)
    return ldpc_tpu.make_decoder(
        code, kind="rcq", bc=3, bv=8, quantizer_params=QP,
        v2c_quantizer_params=VQP, max_iterations=10,
        bucketed=name == "pbrl3096_bucketed"), 2048, 1.2


def _options(opts, to_name):
    if opts is None:
        return None
    return {k: (to_name(v) if k == "dtype" else v) for k, v in opts.items()}


@pytest.mark.parametrize("name", ["bench", "ee_batch"] + [
    "bench_qc9472_layered6_fused", "bench_qc9472_flooding10_fused",
    "dvbs2_16200_layered6_fused", "tanner155_layered6_fused",
    "pbrl3096_qc_layered10_fused", "pbrl3096_general", "pbrl3096_bucketed"])
def test_twin_decoders_equal_the_jax_programs(matrix, name):
    """The twin's decoder (``ee_batch.run`` decodes with the bench twin's
    ``bench_decoder``) equals the JAX program's, field by field."""
    jdec, jB, jsnr = _jax_decoder(name)
    if name in ("bench", "ee_batch"):
        tdec, tB, tsnr = bench.bench_decoder("cpu"), bench.B, bench.SNR_DB
        assert ee_batch.POINTS[1] == (bench.B, 512)
    else:
        tdec, tB, tsnr = matrix[name]
    assert (tB, tsnr) == (jB, jsnr)
    np.testing.assert_array_equal(tdec.code.H, jdec.code.H)
    assert (tdec.code.n, tdec.code.k) == (jdec.code.n, jdec.code.k)
    assert (jdec.qc is None) == (tdec.qc is None)
    if jdec.qc is not None:
        assert_same_fields(tdec.qc, jdec.qc)
    else:
        assert_same_fields(tdec.graph, jdec.graph)
    assert (jdec.bucketed_graph is None) == (tdec.bucketed_graph is None)
    if jdec.bucketed_graph is not None:
        assert_same_fields(tdec.bucketed_graph, jdec.bucketed_graph)
    assert_same_fields(tdec.spec, jdec.spec)
    assert tdec.spec.thresholds is not None and tdec.spec.q_levels == 4
    assert (tdec.name, tdec.recipe) == (jdec.name, jdec.recipe)
    assert (tdec.layered, tdec.max_iterations) == (jdec.layered,
                                                   jdec.max_iterations)
    assert _options(tdec.qc_options, lambda d: str(d).split(".")[-1]) == \
        _options(jdec.qc_options, lambda d: np.dtype(d).name)
    assert tdec.weights.keys() == jdec.weights.keys()
    for k, w in jdec.weights.items():
        assert (w is None) == (tdec.weights[k] is None)
        if w is not None:
            np.testing.assert_array_equal(tdec.weights[k].numpy(),
                                          np.asarray(w))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tanner_plain_k1_equals_jax_interpret_kernel(matrix, dtype):
    """Tanner (155, 64) at full width, 16 frames at the entry's 4.0 dB:
    the port's K1 plain version against the JAX package's K1 in interpret
    mode, on the same numpy LLRs."""
    tdec = matrix["tanner155_layered6_fused"][0]
    jdec = _jax_decoder("tanner155_layered6_fused")[0]
    T = tdec.max_iterations
    jt, tt = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    llr = channel_llr(16, tdec.code.n, 4.0, seed=31)
    x = jnp.asarray(llr)
    ref = qc_fused_decode_batch_layered.lower(
        x, jdec.weights, qc=jdec.qc, spec=jdec.spec, max_iterations=T,
        dtype=jt, batch_tile=16, interpret=True,
    ).compile(compiler_options={"xla_allow_excess_precision": False})(
        x, jdec.weights)
    out = lt.qc_fused_decode_batch_layered(
        torch.from_numpy(llr), tdec.weights, qc=tdec.qc, spec=tdec.spec,
        max_iterations=T, dtype=tt)
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    if dtype == "f32":
        np.testing.assert_allclose(out.posterior.numpy(),
                                   np.asarray(ref.posterior),
                                   rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_array_equal(
            out.posterior.view(torch.int16).numpy(),
            np.asarray(ref.posterior).view(np.int16))


@pytest.fixture(scope="module")
def bench_cpu():
    """The bench decoder on the CPU and 32 frames at 6.25 dB, where some
    frames survive stage 1."""
    dec = bench.bench_decoder("cpu")
    return dec, torch.from_numpy(channel_llr(32, dec.code.n, 6.25, seed=5))


def test_bench_wave_is_the_two_checkpoint_decode(bench_cpu):
    """A wave's bits are stage 1's (T=3) for the frames it decodes and the
    full decode's (T=6) for its survivors, and its survivor count is stage
    1's unconverged frames, decoded here without the early exit."""
    dec, llr = bench_cpu
    two = lt.make_two_checkpoint_decoder(dec, t1=bench.T1,
                                         survivor_budget=32)
    bits, n_surv = bench.wave(two, llr)
    args = dict(qc=dec.qc, spec=dec.spec, dtype=torch.bfloat16, lean=True)
    s1 = lt.qc_fused_decode_batch_layered(llr, dec.weights,
                                          max_iterations=bench.T1, **args)
    full = lt.qc_fused_decode_batch_layered(llr, dec.weights,
                                            max_iterations=bench.T, **args)
    assert 0 < int(n_surv) == int((~s1.success).sum()) < 32
    want = torch.where(s1.success[:, None], s1.bits, full.bits)
    assert bits.dtype == torch.int8 and torch.equal(bits, want)


def test_overflow_guard_and_measure(bench_cpu):
    """The guard raises on a warm-up or a timed wave past the budget;
    within it, ``measure`` returns each trial's rate and the largest
    survivor count."""
    dec, llr = bench_cpu
    tight = lt.make_two_checkpoint_decoder(dec, t1=bench.T1,
                                           survivor_budget=1)
    with pytest.raises(bench.BudgetOverflow, match="warm-up"):
        bench.warm_up(tight, [llr], 1)
    with pytest.raises(bench.BudgetOverflow, match="timed"):
        bench.measure(tight, [llr], 1, reps=1, trials=1)
    two = lt.make_two_checkpoint_decoder(dec, t1=bench.T1,
                                         survivor_budget=32)
    n = bench.warm_up(two, [llr, llr[:16]], 32)
    best, rates, worst = bench.measure(two, [llr[:16], llr], 32, reps=2,
                                       trials=2)
    assert len(rates) == 2 and best == max(rates) > 0
    assert worst == n[0] == max(n)
    errors, counts = bench.frame_errors(two, [llr])
    assert counts == n[:1] and 0 <= errors[0] <= counts[0]


def test_measure_counts_frames_per_second():
    """A wave that takes 20 ms of B=1000 frames measures about 50,000
    frames/s: the rate is frames over the trial's seconds."""
    import time

    def two_ck(llr):
        time.sleep(0.02)
        out = lt.DecodeResult(bits=torch.zeros(llr.shape, dtype=torch.int8),
                              posterior=None, iterations=None, success=None)
        return out, torch.tensor(3, dtype=torch.int32)

    llrs = [torch.zeros((1000, 4)), torch.zeros((1000, 4))]
    best, rates, worst = bench.measure(two_ck, llrs, 3, reps=5, trials=2)
    assert worst == 3 and len(rates) == 2
    assert 30_000 < best <= 50_000


def test_bench_main_prints_bench_py_line(monkeypatch, capsys):
    """The twin's lines at B=16 (one trial of one wave): the device, the
    waves' statistics, and last bench.py's four keys with its metric name
    (read from bench.py) and unit. Without a card it raises unless given
    ``--device cpu``."""
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    assert f'"metric": "{bench.METRIC}"' in src
    assert f'"unit": "{bench.UNIT}"' in src
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.main([])
    monkeypatch.setattr(bench, "B", 16)
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.setattr(bench, "TRIALS", 1)
    bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-3] == "device: cpu"
    stats, line = json.loads(lines[-2]), json.loads(lines[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == bench.METRIC and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] * 0.0546,
                                                abs=0.06)
    assert stats["batch"] == 16 and stats["survivor_budget"] == 128
    assert stats["frame_errors_per_set"] == [0, 0, 0]
    assert len(stats["trial_cw_per_sec"]) == 1


def test_twins_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import ldpc_tpu_torch.cli.bench, "
            "ldpc_tpu_torch.cli.throughput_matrix, "
            "ldpc_tpu_torch.cli.ee_batch; "
            "assert 'ldpc_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=REPO))


def test_matrix_run_writes_outside_experiments(matrix, tmp_path,
                                               monkeypatch):
    """``--out`` defaults to a file in the working directory, never under
    ``experiments/``; ``run`` writes the JAX program's fields there, with
    ``bucketed_speedup`` when both engine entries ran. Without a card the
    twin raises unless given ``--device cpu``."""
    assert os.path.dirname(tm.DEFAULT_OUT) == ""
    assert not tm.DEFAULT_OUT.startswith("experiments")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tm.main([])
    monkeypatch.chdir(tmp_path)
    entries = {k: (matrix[k][0], 8, matrix[k][2]) for k in
               ("tanner155_layered6_fused",) + tm.ENGINE_ENTRIES}
    res = tm.run(reps=1, verbose=False, device="cpu", entries=entries)
    with open(tmp_path / tm.DEFAULT_OUT) as f:
        assert json.load(f) == res
    assert set(res) == set(entries) | {"bucketed_speedup"}
    for k, (dec, B, snr) in entries.items():
        r = res[k]
        assert (r["batch"], r["n"], r["snr_db"]) == (8, dec.code.n, snr)
        assert r["info_bits_per_sec"] == pytest.approx(
            r["cw_per_sec"] * dec.code.k, abs=0.06 * dec.code.k)
    assert res["bucketed_speedup"] == round(
        res["pbrl3096_bucketed"]["cw_per_sec"]
        / res["pbrl3096_general"]["cw_per_sec"], 2)


def test_ee_batch_skips_an_overflowing_batch(tmp_path, monkeypatch):
    """A batch whose survivors overflow its budget is reported and left
    out; the next is timed. Without a card the study raises unless given
    ``--device cpu``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        ee_batch.main([])
    monkeypatch.setattr(bench, "SNR_DB", 6.25)
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.setattr(bench, "TRIALS", 1)
    out = tmp_path / "ee.json"
    res = ee_batch.run("cpu", points=((16, 1), (24, 24)), out_path=str(out))
    assert list(res) == ["dde_t1=3_B24"] and res["dde_t1=3_B24"] > 0
    with open(out) as f:
        assert json.load(f) == res
