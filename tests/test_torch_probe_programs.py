"""The PBRL V2C/CN probe twins (``ldpc_tpu_torch.cli.pbrl_bv10``,
``.pbrl_cn_probe``, ``.pbrl_vqp_sweep``, ``.pbrl_vqp_gamma``) and the
importance sampler's draws, on the CPU.

Held to the JAX programs (``experiments/pbrl_bv10.py``,
``pbrl_cn_probe.py``, ``pbrl_vqp_sweep.py``, ``pbrl_vqp_gamma.py``),
each run with a recorder in place of ``simulate_single_snr`` (and
``pbrl_cn_probe``, which runs at import from the repo root, with
``os.chdir`` recorded):

- every arm (code, QC tables, spec, options without the TPU-only keys,
  weights), each ``SimulationConfig`` and SNR, and the results file's
  keys; on the CPU both packages decode in float32 (``pbrl_cn_probe``
  has no CPU switch: its bf16 is the twin's on the card);
- each twin's command line is ``--device`` alone, naming the card by
  default;
- the V2C-neutral identity the probes rest on, on the precoded piece
  (base rows 0 and 1 at lift 8, float32, 64 frames): on CN_REF3 the
  gamma 2.0 power V2C ladder decodes as the bv=12 uniform one, and bc=5's
  closed form the same under a 10-bit and an 8-bit uniform V2C ladder, in
  bits, success and iterations, through K1's plain version and through
  ``ldpc_tpu``'s fused kernel in interpret mode (four interpret-mode
  compiles, ≈ 4 s each); each of the port's decoders equal to
  ``ldpc_tpu``'s there (posteriors to rtol 1e-6 / atol 1e-5; at bc=5 the
  success flags, iterations, frame errors and the successful frames'
  bits, as XLA's ``pow`` and torch's part by an ulp);
- ``pbrl_probe_reference.json`` (``tests/jax_reference_probes.py``)
  names the twins' decoders;
- ``sim.importance.biased_awgn_llr`` draws its noise with
  ``jax.random.normal``'s transform: from the same random bits its noise
  equals ``jax.random.normal``'s (rtol 1e-5, the two erfinv
  approximations), and from the same noise its ``llr`` and ``log_w``
  equal ``ldpc_tpu``'s.
"""

import dataclasses
import hashlib
import importlib
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.pbrl_bv10 as jax_bv10
import experiments.pbrl_vqp_gamma as jax_gamma
import experiments.pbrl_vqp_sweep as jax_sweep
import ldpc_tpu
import ldpc_tpu.sim
import ldpc_tpu.sim.importance as jis
import ldpc_tpu.utils.cache
import ldpc_tpu_torch as lt
import ldpc_tpu_torch.decode.variants as lt_variants
import ldpc_tpu_torch.sim.importance as tis
from ldpc_tpu.decode import variants as jax_variants
from ldpc_tpu.decode.qc_engine import build_qc_graph as jax_qc_graph
from ldpc_tpu_torch.cli import pbrl_bv10, pbrl_cn_probe, pbrl_vqp_gamma
from ldpc_tpu_torch.cli import pbrl_vqp_sweep
from ldpc_tpu_torch.cli import pbrl_wrcq as pw
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (assert_same_config, assert_same_decoder,
                                assert_same_fields, channel_llr)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
TPU_ONLY = ("batch_tile", "interpret")
TWINS = {"pbrl_bv10": (pbrl_bv10, jax_bv10),
         "pbrl_cn_probe": (pbrl_cn_probe, None),
         "pbrl_vqp_sweep": (pbrl_vqp_sweep, jax_sweep),
         "pbrl_vqp_gamma": (pbrl_vqp_gamma, jax_gamma)}
CALL = dict(frames=123456, errors=77, snrs=(2.0, 2.4))


@pytest.fixture(autouse=True, scope="module")
def shared_graphs():
    """Both packages' decoders of one code share its graph (a dense scan
    of H, ≈ 0.08 s at n = 3182, which these tests would repeat ≈ 30
    times a package)."""
    def memo(build):
        seen = {}

        def graph(code):
            H = np.ascontiguousarray(code.H)
            key = (H.shape, hashlib.sha1(H.tobytes()).hexdigest())
            if key not in seen:
                seen[key] = build(code)
            return seen[key]
        return graph

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_variants, lt_variants):
            mp.setattr(mod, "build_graph", memo(mod.build_graph))
        yield


def _record(mp, module, name):
    """Replace ``module.<name>`` (a ``simulate_single_snr``) by a recorder;
    returns its list of (decoder, SNR, config)."""
    calls = []

    def sim(dec, snr, cfg, *a, **k):
        calls.append((dec, snr, cfg))
        return 1e-4, 1e-7, 5.5, 65536, len(calls)
    mp.setattr(module, name, sim)
    return calls


def _jax_run(name, tmp_path, mp):
    """The JAX program's simulations and its results file."""
    calls = _record(mp, ldpc_tpu.sim, "simulate_single_snr")
    mp.setattr(ldpc_tpu.utils.cache, "enable_compilation_cache",
               lambda *a, **k: None)
    mp.setattr("logging.basicConfig", lambda **kw: None)
    out = tmp_path / "jax.json"
    if name == "pbrl_cn_probe":   # runs at import, from the repo root
        dirs = []
        mp.chdir(tmp_path)
        mp.setattr(os, "chdir", dirs.append)
        mp.setattr(sys, "path", list(sys.path))
        os.makedirs("experiments")
        runpy.run_path(os.path.join(EXP, "pbrl_cn_probe.py"))
        assert len(dirs) == 1   # its one chdir was caught, not made
        out = tmp_path / "experiments" / "pbrl_cn_probe_results.json"
    else:
        TWINS[name][1].main(out_path=str(out), **CALL)
    return calls, json.loads(out.read_text())


def _strip(jdec):
    """``jdec`` without the TPU-only ``qc_options`` keys."""
    opts = {k: v for k, v in jdec.qc_options.items() if k not in TPU_ONLY}
    return dataclasses.replace(jdec, qc_options=opts)


@pytest.mark.parametrize("name", list(TWINS))
def test_arms_and_configs_equal_the_jax_programs(name, tmp_path,
                                                 monkeypatch):
    """The same simulations in the same order: each arm, SNR and
    ``SimulationConfig``; the results files have the same keys."""
    twin = TWINS[name][0]
    with pytest.MonkeyPatch.context() as mp:
        jcalls, jres = _jax_run(name, tmp_path, mp)
    tcalls = _record(monkeypatch, lt, "simulate_single_snr")
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    monkeypatch.chdir(tmp_path)
    kw = {} if name == "pbrl_cn_probe" else CALL
    tres = twin.main(device="cpu", **kw)
    assert os.path.exists(twin.DEFAULT_OUT)
    assert os.path.dirname(twin.DEFAULT_OUT) == ""
    assert json.loads(open(twin.DEFAULT_OUT).read()) == tres == jres
    assert len(tcalls) == len(jcalls) == 2 * len(twin.build_arms("cpu")[0])
    for (tdec, tsnr, tcfg), (jdec, jsnr, jcfg) in zip(tcalls, jcalls):
        assert tsnr == jsnr and tcfg.device == "cpu"
        assert_same_config(tcfg, jcfg)
        jdec = _strip(jdec)
        if name == "pbrl_cn_probe":   # bf16 on the TPU and on the card
            assert jdec.qc_options == dict(fused=True, dtype=jnp.bfloat16)
            assert pw.fused_options("cuda") == dict(fused=True,
                                                    dtype=torch.bfloat16)
            jdec = dataclasses.replace(jdec, qc_options=dict(
                fused=True, dtype=jnp.float32))
        assert_same_decoder(tdec, jdec)
        assert tdec.qc_options == dict(fused=True, dtype=torch.float32)
        assert tdec.code.n == 3182 and tdec.qc.lift == 86
        assert tcfg.punctured_positions == tuple(range(86))


@pytest.mark.parametrize("name", list(TWINS))
def test_command_line_is_device_alone(name, monkeypatch):
    """No option but ``--device``, which names the card by default:
    without one the twin raises before it decodes."""
    twin = TWINS[name][0]
    import ast
    with open(twin.__file__) as f:
        tree = ast.parse(f.read())
    opts = [a.value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"
            for a in node.args if isinstance(a, ast.Constant)]
    assert opts == ["--device"]
    with open(os.path.join(EXP, f"{name}.py")) as f:
        assert "add_argument" not in f.read()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    with pytest.raises(RuntimeError, match="CUDA card"):
        twin.cli([])


# -- the V2C-neutral identity on the precoded piece ---------------------------

ROWS, LIFT = (0, 1), 8
CN_REF3, VQP_REF3 = pbrl_bv10.CN_REF3, pbrl_bv10.VQP_REF3
# arm -> (the arm it decodes as, bc, bv, V2C ladder)
# arm -> (the arm it decodes as, bc, bv, V2C ladder): the uniform bv=12
# and the power-law gamma 2.0 V2C quantizers; bc=5's closed form under a
# 10-bit and an 8-bit uniform V2C ladder
PIECE = {"bc4_bv12": (None, 4, 12, VQP_REF3),
         "bc4_g2.0_C300": ("bc4_bv12", 4, 8,
                           pbrl_vqp_gamma.LADDERS["bc4_g2.0_C300"]),
         "bc5_vr96": (None, 5, 8, pbrl_vqp_sweep.ladder(96)),
         "bc5_bv10": ("bc5_vr96", 5, 10, VQP_REF3)}


def _piece():
    """The precoded base's rows ROWS and the columns they touch at lift
    LIFT (shifts mod LIFT), and its punctured bits."""
    base, _, pc = ldpc_tpu.create_pbrl_qc_protograph(k=1032, rate=1 / 3,
                                                     precode=True)
    cols = np.flatnonzero((base[list(ROWS)] >= 0).any(axis=0))
    sub = base[list(ROWS)][:, cols]
    assert pc[0] == 0 and cols[0] == 0
    return np.where(sub >= 0, sub % LIFT, -1), tuple(range(LIFT))


@pytest.fixture(scope="module")
def piece_runs():
    """{arm: (port result, JAX result)} on 64 punctured frames at 1.5 dB:
    the twins' ``mk`` on the piece (K1's plain version) and ``ldpc_tpu``'s
    fused kernel in interpret mode at the programs' settings."""
    base, punct = _piece()
    tcode = lt.create_qc_code(base, lift=LIFT, max_iterations=10)
    jcode = ldpc_tpu.create_qc_code(base, lift=LIFT, max_iterations=10)
    real = lt.create_pbrl_qc_protograph
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lt, "create_pbrl_qc_protograph",
                   lambda **kw: (base, LIFT, (0,)))
        tmk, tpunct, _ = pw._mk_setup("cpu")
    assert tpunct == punct and real is lt.create_pbrl_qc_protograph
    llr = channel_llr(64, tcode.n, 1.5, seed=41)
    llr[:, list(punct)] *= 0.0
    out = {}
    for arm, (_, bc, bv, vqp) in PIECE.items():
        tdec = tmk("rcq", CN_REF3, vqp=vqp, bc=bc, bv=bv)
        assert tdec.code.n == tcode.n and tdec.spec.closed_qdq == (bc == 5)
        jdec = ldpc_tpu.make_decoder(
            jcode, kind="rcq", bc=bc, bv=bv, quantizer_params=CN_REF3,
            v2c_quantizer_params=vqp, max_iterations=10,
            qc=jax_qc_graph(base, LIFT), layered=True, closed_qdq=bc >= 5,
            qc_options=dict(fused=True, batch_tile=None, interpret=True,
                            dtype=jnp.float32))
        out[arm] = (tdec(torch.from_numpy(llr)), jdec(jnp.asarray(llr)))
    return out, llr


@pytest.mark.parametrize("arm", ["bc4_g2.0_C300", "bc5_bv10"])
def test_v2c_ladder_is_decode_neutral_on_the_piece(piece_runs, arm):
    runs, llr = piece_runs
    assert not llr[:, :LIFT].any() and np.signbit(llr[:, :LIFT]).any()
    same = PIECE[arm][0]
    for a in (arm, same):
        got, want = runs[a]
        ok = np.asarray(want.success)
        np.testing.assert_array_equal(got.success.numpy(), ok)
        np.testing.assert_array_equal(got.iterations.numpy(),
                                      np.asarray(want.iterations))
        np.testing.assert_array_equal(got.bits.numpy().any(1),
                                      np.asarray(want.bits).any(1))
        if PIECE[a][1] == 5:
            # the closed power form's levels C (i / M)^gamma part by an
            # ulp between torch's pow and XLA's (ROADMAP Queue 3), which
            # moves values of frames that fail: their hard outputs are held
            # frame by frame (in error in both), the others bit by bit
            np.testing.assert_array_equal(got.bits.numpy()[ok],
                                          np.asarray(want.bits)[ok])
            continue
        np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
        np.testing.assert_allclose(got.posterior.numpy(),
                                   np.asarray(want.posterior), rtol=1e-6,
                                   atol=1e-5)
    ok = runs[arm][0].success.numpy()
    assert 0 < ok.sum() < 64
    for route in (0, 1):   # K1's plain version, ldpc_tpu's kernel
        a, b = runs[arm][route], runs[same][route]
        for field in ("bits", "success", "iterations"):
            np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                          np.asarray(getattr(b, field)))
        assert (np.asarray(a.posterior) != np.asarray(b.posterior)).any()


def test_reference_names_the_twins_decoders():
    """Each entry of ``pbrl_probe_reference.json``: the arm it is counted
    as and the arms that decode as it are the twins' arms with its
    ladders, bc, bv and closed form; at least 262,144 frames at 2.0 dB
    under {5, 10}; its routes held frame for frame on 2048 frames; its
    command."""
    with open(os.path.join(os.path.dirname(pbrl_bv10.__file__),
                           "pbrl_probe_reference.json")) as f:
        ref = json.load(f)
    mk = pw._mk_setup("cpu")[0]
    assert sorted(ref) == sorted(["bc5_bv10", "cn_8.5-16-16", "cn_6-12-12",
                                  "cn_8.5-12-16"])
    for name, e in ref.items():
        assert (e["snr"], e["T"], e["t1"], e["closed_qdq"]) == (
            2.0, 10, 5, e["bc"] >= 5)
        assert e["frames"] >= 262144 and 0 < e["errors"] < e["frames"]
        assert e["held"] >= 2048 and e["apart"] == 0
        assert e["command"].startswith("JAX_PLATFORMS=cpu python "
                                       "tests/jax_reference_probes.py")
        want = mk("rcq", tuple(map(tuple, e["cn"])),
                  vqp=tuple(map(tuple, e["v2c"])), bc=e["bc"], bv=e["bv"])
        assert want.spec.closed_qdq == e["closed_qdq"]
        assert want.max_iterations == e["T"]
        counted = importlib.import_module(
            f"ldpc_tpu_torch.cli.{e['counted_as'].split('/')[0]}")
        assert_same_fields(counted.build_arms("cpu")[0][
            e["counted_as"].split("/")[1]].spec, want.spec)
        for arm in e["same_decode"]:   # another V2C ladder, the same CN
            prog, key = arm.split("/")
            spec = importlib.import_module(
                f"ldpc_tpu_torch.cli.{prog}").build_arms("cpu")[0][key].spec
            assert (spec.kind, spec.q_levels, spec.closed_qdq) == (
                want.spec.kind, want.spec.q_levels, want.spec.closed_qdq)
            np.testing.assert_array_equal(spec.qparams, want.spec.qparams)
        assert e["counted_as"].endswith(name)


# -- the importance sampler's draws -------------------------------------------

def test_biased_draws_are_jax_random_normals_transform(monkeypatch):
    """From the same random bits (``jax.random.normal`` keeps the top 23
    of 32) the sampler's noise equals ``jax.random.normal``'s within the
    erfinv approximations (rtol 1e-5); from that noise its ``llr`` and
    ``log_w`` equal ``ldpc_tpu.sim.importance.biased_awgn_llr``'s."""
    key = jax.random.PRNGKey(5)
    B, n, snr, shift, pos, punct = 64, 96, 3.0, 1.4, [3, 17, 40], [90, 95]
    bits = np.asarray(jax.random.bits(key, (B, n), np.uint32)) >> 9
    real_randint = torch.randint

    def randint(lo, hi, shape, **kw):
        assert (lo, hi, tuple(shape), kw["dtype"]) == (0, 2 ** 23, (B, n),
                                                       torch.int32)
        return torch.from_numpy(bits.astype(np.int32))
    seen = []
    real = tis.biased_llr_from_noise

    def spy(noise, *a, **k):
        seen.append(noise.clone())
        return real(noise, *a, **k)
    monkeypatch.setattr(torch, "randint", randint)
    monkeypatch.setattr(tis, "biased_llr_from_noise", spy)
    llr, log_w = tis.biased_awgn_llr(torch.Generator(), B, n, snr, pos,
                                     shift, punctured=punct)
    monkeypatch.setattr(torch, "randint", real_randint)
    sigma = np.sqrt(np.float32(10.0 ** (-snr / 10.0)))
    want = np.array(jax.random.normal(key, (B, n), jnp.float32) *
                    jnp.sqrt(jnp.float32(10.0 ** (-snr / 10.0))))
    np.testing.assert_allclose(seen[0].numpy(), want, rtol=1e-5,
                               atol=2e-7 * sigma)
    jllr, jlog_w = jis.biased_awgn_llr(key, B, n, snr, pos, shift,
                                       punctured=punct)
    tllr, tlog_w = real(torch.from_numpy(want), snr, pos, shift,
                        punctured=punct)
    np.testing.assert_allclose(tllr.numpy(), np.asarray(jllr), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tlog_w.numpy(), np.asarray(jlog_w),
                               rtol=1e-5, atol=1e-5)
    assert not tllr[:, punct].any() and not llr[:, punct].any()
    np.testing.assert_allclose(log_w.numpy(), np.asarray(jlog_w), rtol=1e-4,
                               atol=1e-4)
