"""The section VII-C rate-family twins (``ldpc_tpu_torch.cli.pbrl_rates``,
``.tighten89``) on the CPU.

Held to the JAX programs (``experiments/pbrl_rates.py``,
``experiments/tighten89.py``), which read and write ``experiments/...``
relative to the working directory and so run here in a directory of their
own holding copies of the committed designs and trained checkpoints:

- the four rates' codes (base, lift, punctured column, n, wave) and every
  arm of ``_mk_setup`` at every rate (code, QC tables, spec with the
  per-iteration quantizer tables, options without the TPU-only keys,
  weight tables: the pinned OMS constants, the trained W-OMS-RCQ tables);
  nothing is decoded there;
- ``pbrl_rates_tables.npz`` against the eight orbax checkpoints, element
  for element, and the ``save_checkpoint`` directories made from it;
- the programs' phases with recorders in place of ``simulate_single_snr``,
  the trainer, ``save_checkpoint``, the designers and
  ``enable_compilation_cache``: the same calls with the same
  configurations, in the same SNR order, with the same resumes and files;
  ``report`` on a copy of the committed scans.

K1's plain version is held to ``ldpc_tpu``'s fused layered kernel (the
function K1 ports) in interpret mode, hard outputs exactly and posteriors
to rtol 1e-6 / atol 1e-5, on the 4-pair ladder with the trained type-2
tables of ``wrcq-89-q4`` (T=10) and on rate 2/3's 5-pair ladder (T=5,
one pair an iteration): on a 12-block piece of the rate-8/9 base (its
four rows, base columns 0, 1, 25, 26 and 27, shifts mod 8) whose check
and variable degrees fall in 3 and 4 buckets, the trained tables'
shapes, with base column 0 punctured (≈ 3-4 s a compile here; the whole
84-block base takes ≈ 31 s). The twins also run for real at lift 8
(tighten89: one compacted wave an arm), every batch K1 is handed with
zeros at the punctured positions.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.pbrl_rates as jax_pr
import experiments.tighten89 as jax_t89
import ldpc_tpu
import ldpc_tpu.design
import ldpc_tpu.design.proto_dde
import ldpc_tpu.sim
import ldpc_tpu.train
import ldpc_tpu.utils.cache
import ldpc_tpu.utils.checkpoint
import ldpc_tpu_torch as lt
import ldpc_tpu_torch.design
import ldpc_tpu_torch.design.proto_dde
from ldpc_tpu.quantizer import phase_schedule as jax_phase_schedule
from ldpc_tpu_torch.cli import pbrl_rates as pr
from ldpc_tpu_torch.cli import tighten89 as t89
from ldpc_tpu_torch.decode import engine, fused
from ldpc_tpu_torch.quantizer import phase_schedule, power_thresholds
from ldpc_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_helpers import (assert_same_config, assert_same_decoder,
                                channel_llr,
                                one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
RECORD_CK = os.path.join(EXP, "pbrl_rates_ck")
TPU_ONLY = ("batch_tile", "interpret")
# (n, wave) of each rate
SHAPES = {"13": (3139, 98304), "12": (2107, 131072), "23": (1591, 196608),
          "89": (1204, 262144)}
# every arm the committed files give each rate
ARMS = {
    "89": ["oms6", "rcq-seed", "rcq-best", "rcq-pol", "rcq-q4", "rcq-p0",
           "wrcq-89", "wrcq-89-q4"],
    "23": ["oms6", "rcq-seed", "rcq-best", "rcq-pol", "rcq-q4", "rcq-q5",
           "rcq-p1", "wrcq-23-q4"],
    "12": ["oms6", "rcq-seed", "rcq-best", "rcq-pol", "rcq-pol3", "rcq-q4",
           "rcq-q5", "rcq-p0", "wrcq-12-q4"],
    "13": ["oms6", "rcq-seed", "rcq-best", "rcq-pol", "rcq-pol3", "rcq-q4",
           "rcq-p2", "wrcq-13", "wrcq-13-q4", "wrcq-13pl", "wrcq-13-q4pl"],
}
CHECKPOINTS = ("orcq_12_q4", "orcq_13", "orcq_13_q4", "orcq_13_q4pl",
               "orcq_13pl", "orcq_23_q4", "orcq_89", "orcq_89_q4")


def _read(path):
    with open(path) as f:
        return json.load(f)


def _jax_dir(root, records=False):
    """A working directory for the JAX programs: copies of the committed
    designs and trained checkpoints (and, with ``records``, the scans)
    under ``root/experiments``."""
    exp = os.path.join(root, "experiments")
    os.makedirs(os.path.join(exp, "pbrl_rates_ck"))
    for fn in os.listdir(EXP):
        if fn.startswith("pbrl_rates_design_"):
            shutil.copy(os.path.join(EXP, fn), exp)
    for fn in os.listdir(RECORD_CK):
        src = os.path.join(RECORD_CK, fn)
        dst = os.path.join(exp, "pbrl_rates_ck", fn)
        if fn.startswith("orcq_"):
            shutil.copytree(src, dst)
        elif records:
            shutil.copy(src, dst)
    return root


def _strip(jdec):
    """``jdec`` without the TPU-only ``qc_options`` keys."""
    opts = jdec.qc_options and {k: v for k, v in jdec.qc_options.items()
                                if k not in TPU_ONLY}
    return dataclasses.replace(jdec, qc_options=opts)


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    return _jax_dir(str(tmp_path_factory.mktemp("jax")))


# -- codes, arms and tables ---------------------------------------------------

@pytest.mark.parametrize("tag", list(pr.RATES))
def test_family_equals_the_jax_programs(tag):
    """Each rate's base, lift and punctured column as the JAX program's
    ``family``; the leading submatrix of the mother, n and the wave."""
    base, lift, punct = pr.family(tag)
    jbase, jlift, jpunct = jax_pr.family(tag)
    np.testing.assert_array_equal(base, jbase)
    assert (lift, punct) == (jlift, jpunct) == (43, (0,))
    mother = pr.family("13")[0]
    np.testing.assert_array_equal(base, mother[:base.shape[0],
                                               :base.shape[1]])
    n = base.shape[1] * lift
    assert (n, pr.wave_size(n)) == SHAPES[tag]
    assert pr.wave_size(n) == min(262144, 32768 * max(1, round(9472 / n)))


def test_constants_equal_the_jax_programs():
    for name in ("K", "LIFT", "CORE_RATE", "T", "BC", "BV", "RATES",
                 "CN_SEED", "SEED_SCALE", "VQP8", "VQP6", "FER_TARGET"):
        assert getattr(pr, name) == getattr(jax_pr, name), name
    for tag in pr.RATES:
        assert pr.seed_ladders(tag) == jax_pr.seed_ladders(tag)
    assert (pr.BATCH, pr.NUM_SAMPLES, pr.LEARNING_RATE, pr.WARMUP_STEPS,
            pr.MIN_FRAMES, pr.EARLY_EXIT, pr.BUDGET) == (
        128, 2048, 2e-3, 8, 65536, 5, 4096)
    assert (t89.ARMS, t89.SNRS, t89.MAX_FRAMES, t89.MAX_ERRORS,
            t89.SEED) == (("oms6", "rcq-pol", "wrcq-89"), (9.0, 9.2),
                          250_000_000, 500, 99)


@pytest.mark.parametrize("tag", list(pr.RATES))
def test_arms_equal_the_jax_programs(jax_root, tmp_path, monkeypatch, tag):
    """Every arm of ``_mk_setup(tag)`` built by both packages (no decode):
    code, QC tables, spec (kind, bc, bv, the per-iteration [T, L] and
    [T, 2] quantizer tables), sharing, ``per_layer``, options (float32 on
    the CPU) and weight tables; the punctured bits are base column 0's.
    The twin installs the trained tables it reads into its own checkpoint
    directory."""
    monkeypatch.chdir(jax_root)
    jmk, jpunct, jcode = jax_pr._mk_setup(tag)
    jdecs = {arm: jmk(arm) for arm in ARMS[tag]}
    monkeypatch.chdir(tmp_path)
    tmk, tpunct, tcode = pr._mk_setup(tag, "cpu")
    assert tpunct == jpunct == tuple(range(43))
    np.testing.assert_array_equal(tcode.H, jcode.H)
    for arm, jdec in jdecs.items():
        tdec = tmk(arm)
        assert_same_decoder(tdec, _strip(jdec))
        assert tdec.qc_options == dict(fused=True, dtype=torch.float32)
        if arm.startswith("wrcq-"):
            spec = tdec.spec
            assert (spec.kind, tdec.recipe.get("sharing_type"),
                    tdec.recipe.get("per_layer")) == (
                "orcq", 2, arm.endswith("pl"))
    want = sorted({"orcq_" + a[5:].replace("-", "_") for a in ARMS[tag]
                   if a.startswith("wrcq-")})
    assert sorted(os.listdir(pr.CK_DIR)) == want


def test_even_spread_of_4_and_5_pairs():
    """Above three pairs ``phase_schedule`` spreads them evenly, in both
    packages: T=10 gives [0,0,0,1,1,2,2,2,3,3] and [0,0,1,1,2,2,3,3,4,4];
    the tables K1 indexes by iteration are the pairs' rows in that
    order."""
    want = {4: [0, 0, 0, 1, 1, 2, 2, 2, 3, 3],
            5: [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]}
    for q, sched in want.items():
        assert phase_schedule(10, q).tolist() == sched
        assert np.asarray(jax_phase_schedule(10, q)).tolist() == sched
    for tag, arm in (("12", "rcq-q4"), ("23", "rcq-q5")):
        ladder = pr._ladder(pr._committed(tag, arm[4:]))[0]
        mk, _, _ = pr._mk_setup(tag, "cpu")
        dec = mk(arm)
        tabs = engine._tables(dec.weights, dec.spec, 10, dec.qc.num_blocks,
                              "cpu")
        sched = want[len(ladder)]
        assert tabs["qp"].tolist() == np.asarray(
            ladder, np.float32)[sched].tolist()
        thr = np.stack([power_thresholds(4, c, g) for c, g in ladder])
        np.testing.assert_array_equal(tabs["thr"].numpy(), thr[sched])


def test_tables_npz_equals_the_orbax_checkpoints(tmp_path):
    """The committed ``pbrl_rates_tables.npz`` (under 60 KiB) holds the
    eight checkpoints' float32 ``beta`` and ``alpha``, equal element for
    element to ``ldpc_tpu``'s ``load_checkpoint`` of the orbax
    directories; ``install_tables`` writes each as a ``save_checkpoint``
    directory that ``load_checkpoint`` reads back equal, and leaves an
    existing one (a table ``train`` wrote) alone."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import jax_reference_pbrl_rates as ref
    finally:
        sys.path.pop(0)
    want = ref.tables()
    assert os.path.getsize(pr.TABLES) < 60 * 1024
    with np.load(pr.TABLES) as f:
        assert sorted(f.files) == sorted(want) == sorted(
            f"{c}/{k}" for c in CHECKPOINTS for k in ("beta", "alpha"))
        for key, v in want.items():
            assert f[key].dtype == np.float32
            np.testing.assert_array_equal(f[key], v)
    assert want["orcq_13pl/beta"].shape == (10, 147)
    assert want["orcq_13pl/alpha"].shape == (10, 588)
    assert want["orcq_89/alpha"].shape == (10, 4)
    ck = str(tmp_path / "ck")
    assert pr.install_tables(ck) == list(CHECKPOINTS)
    for c in CHECKPOINTS:
        tree = load_checkpoint(os.path.join(ck, c))
        assert set(tree) == {"beta", "alpha"}
        for k, v in tree.items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), want[f"{c}/{k}"])
    assert pr.install_tables(ck) == []
    shutil.rmtree(os.path.join(ck, "orcq_89"))
    assert pr.install_tables(ck, ["orcq_89", "orcq_13"]) == ["orcq_89"]


# -- K1's plain version against ldpc_tpu's kernel -----------------------------

def _piece():
    """Rows 0-3 and base columns 0, 1, 25, 26, 27 of the rate-8/9 base,
    shifts mod 8: check degrees 2, 3, 4 and variable degrees 1-4."""
    base = pr.family("89")[0][:, [0, 1, 25, 26, 27]]
    return np.where(base >= 0, base % 8, -1)


# (rate and file of the CN ladder, kind, checkpoint of its trained tables,
# iterations, SNR)
K1_CASES = {"q4_type2": ("89", "q4", "orcq", "orcq_89_q4", 10, 1.0),
            "q5": ("23", "q5", "rcq", None, 5, 1.0)}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_plain_k1_equals_ldpc_tpus_kernel(case):
    """K1's plain version (the fused wrapper on CPU tensors, no launch),
    f32, 64 frames with base column 0's LLRs multiplied by zero (the
    negative ones become -0.0), against ``ldpc_tpu``'s fused layered
    kernel in interpret mode on the same tables: bits and success equal,
    posteriors to rtol 1e-6 / atol 1e-5. Every pair of the ladder is
    used: [0,0,0,1,1,2,2,2,3,3] at T=10, [0,1,2,3,4] at T=5."""
    from ldpc_tpu.decode.pallas_fused import \
        qc_fused_decode_batch_layered as jax_kernel
    from ldpc_tpu.decode.qc_engine import build_qc_graph

    tag, ladder, kind, ck, T, snr = K1_CASES[case]
    qp, vqp = pr._ladder(pr._committed(tag, ladder))
    assert sorted(set(phase_schedule(T, len(qp)).tolist())) == list(
        range({"q4": 4, "q5": 5}[ladder]))
    base = _piece()
    kw = dict(kind=kind, bc=4, bv=8, quantizer_params=qp,
              v2c_quantizer_params=vqp, max_iterations=T)
    if kind == "orcq":
        kw["sharing_type"] = 2
    tdec = lt.make_decoder(
        lt.create_qc_code(base, lift=8, max_iterations=T),
        qc=lt.build_qc_graph(base, 8), layered=True,
        qc_options=dict(fused=True, dtype=torch.float32), device="cpu", **kw)
    jdec = ldpc_tpu.make_decoder(
        ldpc_tpu.create_qc_code(base, lift=8, max_iterations=T),
        qc=build_qc_graph(base, 8), layered=True, **kw)
    if ck is not None:
        with np.load(pr.TABLES) as f:
            w = {k: f[f"{ck}/{k}"] for k in ("beta", "alpha")}
        assert {k: v.shape for k, v in w.items()} == {
            k: tuple(v.shape) for k, v in tdec.weights.items()}
        tdec = tdec.replace_weights(w)
    assert_same_decoder(dataclasses.replace(tdec, qc_options=None),
                        dataclasses.replace(jdec, weights={
                            k: (None if v is None else jnp.asarray(
                                tdec.weights[k].numpy()))
                            for k, v in jdec.weights.items()}))
    mask = np.ones(tdec.code.n, np.float32)
    mask[:8] = 0.0
    llr = channel_llr(64, tdec.code.n, snr, seed=17) * mask
    assert np.signbit(llr[:, :8]).any() and not llr[:, :8].any()
    ref = jax_kernel(jnp.asarray(llr), {k: (None if v is None else
                                            jnp.asarray(v.numpy()))
                                        for k, v in tdec.weights.items()},
                     qc=jdec.qc, spec=jdec.spec, max_iterations=T,
                     dtype=jnp.float32, interpret=True, batch_tile=64)
    before = fused.LAYERED_LAUNCHES
    out = tdec(torch.from_numpy(llr))
    assert fused.LAYERED_LAUNCHES == before
    ok = np.asarray(ref.success)
    assert 0 < ok.sum() < 64
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(), ok)
    np.testing.assert_allclose(out.posterior.numpy(),
                               np.asarray(ref.posterior), rtol=1e-6,
                               atol=1e-5)


# -- the phases with recorders ------------------------------------------------

# each rate's waterfall (dB where the recorded FER is 1) by code length
CENTER = {1204: 6.0, 1591: 4.5, 2107: 1.5, 3139: 0.2}
# a point each package finds in its files before it starts
SEEDED_SCAN = {"arm": "oms6", "rate_tag": "89",
               "points": {"6.8": {"fer": 2e-3, "frames": 65536,
                                  "errors": 131}}}
SEEDED_T89 = {"rcq-pol": {"9.0": {"fer": 2e-6, "frames": 1, "errors": 1}}}


def _fake_point(dec, snr, cfg):
    """A recorded point: FER 10^(-2.5 (snr - centre)), frames to the
    error target or the cap."""
    fer = min(0.5, 10 ** (-(snr - CENTER[dec.code.n]) * 2.5))
    nf = (cfg.max_frames if fer * cfg.max_frames < cfg.max_errors
          else max(cfg.min_frames, cfg.wave_size))
    ne = int(round(fer * nf))
    return ne / nf, 1e-4, 5.0, nf, ne


def _history(mod, cn, v2c):
    """A two-pass refine history of the design package ``mod``."""
    cn = tuple(tuple(p) for p in cn)
    v2c = tuple(tuple(p) for p in v2c)
    return mod.RefineHistory([
        mod.RefinePass(0, cn, v2c, 6.25),
        mod.RefinePass(1, tuple((c * 1.125, g) for c, g in cn), v2c, 6.125,
                       de_floor=1e-9)], "threshold")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: {"sim": [(decoder, SNR, config)], "train": [...], "saved":
    [...], "design": [...], "out": {...}}, plus each package's working
    directory}: both programs' phases run with recorders."""
    rec = {}

    def single(decoder, snr_db, config, *args, **kw):
        rec["sim"].append((decoder, snr_db, config))
        return _fake_point(decoder, snr_db, config)

    class Trainer:
        def __init__(self, decoder, config=None):
            rec["train"].append(dict(decoder=decoder, config=config))

        def train(self, num_samples=3200, val_samples=640, verbose=True):
            rec["train"][-1]["num_samples"] = num_samples
            return {"training_losses": [0.25]}

    def designers(mod):
        def iterate_refine(base, cn, v2c, **kw):
            rec["design"].append(("iterate_refine", (base, cn, v2c), kw))
            return _history(mod, cn, v2c)

        def de(base, **kw):
            rec["design"].append(("density_evolution", (base,), kw))
            err = 1e-8 * kw["snr_db"] if base.shape[0] == 4 else 1e-14
            return types.SimpleNamespace(error_prob=np.array([0.5, err]))

        def refine(base, qp, vqp, **kw):
            rec["design"].append(("refine_ladders_protograph",
                                  (base, qp, vqp), kw))
            return (tuple((c * 1.25, g) for c, g in qp),
                    tuple((c, g) for c, g in vqp), 3e-9)
        return iterate_refine, de, refine

    root = tmp_path_factory.mktemp("runs")
    jdir = _jax_dir(str(root / "jax"))
    tdir = str(root / "torch")
    os.makedirs(os.path.join(tdir, pr.CK_DIR))
    for path in (os.path.join(jdir, jax_pr.CK_DIR, "89_oms6.json"),
                 os.path.join(tdir, pr.CK_DIR, "89_oms6.json")):
        with open(path, "w") as f:
            json.dump(SEEDED_SCAN, f)
    for path in (os.path.join(jdir, jax_t89.OUT),
                 os.path.join(tdir, t89.OUT)):
        with open(path, "w") as f:
            json.dump(SEEDED_T89, f)
    out = {pkg: {"sim": [], "train": [], "saved": [], "design": [],
                 "out": {}} for pkg in ("jax", "torch")}
    deeps = (("89", ("oms6", "rcq-pol", "wrcq-89-q4"), None),
             ("12", ("rcq-q4",), None), ("23", ("rcq-q5",), 4.8),
             ("13", ("wrcq-13pl",), 0.6))
    trains = (("89", "best", False), ("13", "q4", True),
              ("12", "pol3", False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ldpc_tpu.sim, "simulate_single_snr", single)
        mp.setattr(lt, "simulate_single_snr", single)
        mp.setattr(ldpc_tpu.train, "PosteriorJointTrainer", Trainer)
        mp.setattr(lt, "PosteriorJointTrainer", Trainer)
        mp.setattr(ldpc_tpu.utils.checkpoint, "save_checkpoint",
                   lambda path, tree: rec["saved"].append((path, tree)))
        mp.setattr(ldpc_tpu.utils.cache, "enable_compilation_cache",
                   lambda *a, **k: None)
        mp.setattr("logging.basicConfig", lambda **kw: None)
        for pkg, dmod, pmod in (("jax", ldpc_tpu.design,
                                 ldpc_tpu.design.proto_dde),
                                ("torch", ldpc_tpu_torch.design,
                                 ldpc_tpu_torch.design.proto_dde)):
            ir, de, refine = designers(dmod)
            mp.setattr(dmod, "iterate_refine", ir)
            mp.setattr(pmod, "protograph_density_evolution", de)
            mp.setattr(pmod, "refine_ladders_protograph", refine)
        rec.update(out["jax"])
        mp.chdir(jdir)
        for tag, arms, start in deeps:
            jax_pr.deep(tag, arms, snr_start=start, frames=2 ** 20,
                        verbose=False)
        out["jax"]["out"]["tighten89"] = jax_t89.main()
        for tag, ladder, pl in trains:
            jax_pr.train(tag, ladder=ladder, per_layer=pl, verbose=False)
        for tag in ("89", "13"):
            jax_pr.design(tag, verbose=False)
        for tag in ("89", "23"):
            jax_pr.polish(tag, verbose=False)
        rec.update(out["torch"])
        mp.chdir(tdir)
        for tag, arms, start in deeps:
            pr.deep(tag, arms, snr_start=start, frames=2 ** 20,
                    verbose=False, device="cpu")
        out["torch"]["out"]["tighten89"] = t89.main(device="cpu")
        for tag, ladder, pl in trains:
            pr.train(tag, ladder=ladder, per_layer=pl, verbose=False,
                     device="cpu")
        for tag in ("89", "13"):
            pr.design(tag, verbose=False)
        # the program's polish reads what its design phase wrote
        pr.polish("89", verbose=False, design_dir=".")
        pr.polish("23", verbose=False)
    return out, jdir, tdir


def test_simulations_equal_the_jax_programs(runs):
    """Every ``simulate_single_snr`` call of ``deep`` (four rates, five
    arms) and ``tighten89.main`` in the programs' order: the SNR, each
    ``SimulationConfig`` field (the wave of the rate, {5, 10}, budget
    4096, the punctured bits; tighten89's seed 99) and each decoder."""
    out, _, _ = runs
    jsim, tsim = out["jax"]["sim"], out["torch"]["sim"]
    assert len(tsim) == len(jsim) > 40
    for (tdec, tsnr, tcfg), (jdec, jsnr, jcfg) in zip(tsim, jsim):
        assert tsnr == jsnr
        assert_same_config(tcfg, jcfg)
        assert tcfg.device == "cpu"
        assert tcfg.wave_size == SHAPES[{v[0]: k for k, v in SHAPES.items()}[
            tdec.code.n]][1]
        assert (tcfg.early_exit_iters, tcfg.survivor_budget,
                tcfg.punctured_positions) == (5, 4096, tuple(range(43)))
        assert_same_decoder(tdec, _strip(jdec))
    assert out["torch"]["out"]["tighten89"] == out["jax"]["out"]["tighten89"]
    seeds = {c.seed for d, _, c in tsim if d.code.n == 1204 and
             c.max_errors == 500}
    assert seeds == {99}


def test_scan_walks_and_resumes_as_the_program(runs):
    """The adaptive walk in both packages: rate 8/9 from the design's
    6.4 dB, its resumed 6.8 dB point taken from the file; rate 1/2 from
    3.1 dB walking down to 2.7 dB first; each arm's file the program's;
    tighten89 skips the point its file holds."""
    out, jdir, tdir = runs
    for pkg in ("jax", "torch"):
        snrs = {}
        for dec, snr, cfg in out[pkg]["sim"]:
            if cfg.max_errors == 100:
                snrs.setdefault(dec.code.n, []).append(round(snr, 1))
        assert snrs[2107][:3] == [3.1, 2.7, 2.9]
        assert snrs[1204][:3] == [6.4, 7.0, 7.2]
    for fn in os.listdir(os.path.join(jdir, jax_pr.CK_DIR)):
        if fn.endswith(".json"):
            assert _read(os.path.join(tdir, pr.CK_DIR, fn)) == _read(
                os.path.join(jdir, jax_pr.CK_DIR, fn))
    got = _read(os.path.join(tdir, pr.CK_DIR, "89_oms6.json"))
    assert got["points"]["6.8"] == SEEDED_SCAN["points"]["6.8"]
    assert _read(os.path.join(tdir, t89.OUT)) == _read(
        os.path.join(jdir, jax_t89.OUT))
    assert out["torch"]["out"]["tighten89"]["rcq-pol"]["9.0"] == \
        SEEDED_T89["rcq-pol"]["9.0"]


def test_train_equals_the_jax_programs(runs):
    """``train`` on the best (polished), 4-pair per-layer and polish3
    ladders: the decoder (spec, sharing type 2, ``per_layer``), every
    ``TrainingConfig`` field (batch 128, cosine from 2e-3 with 8 warm-up
    updates and 480 decay steps, SNR threshold + 1 to + 3 dB, the 43
    punctured bits), 2048 frames an epoch, and the checkpoint's name under
    the twin's checkpoint directory."""
    out, _, tdir = runs
    jt, tt = out["jax"]["train"], out["torch"]["train"]
    assert len(tt) == len(jt) == 3
    for t, j in zip(tt, jt):
        assert dataclasses.asdict(t["config"]) == dataclasses.asdict(
            j["config"])
        assert t["num_samples"] == j["num_samples"] == 2048
        assert_same_decoder(t["decoder"], _strip(j["decoder"]),
                            weights=False)
        assert t["config"].decay_steps == 480
    assert tt[1]["decoder"].recipe.get("per_layer") is True
    assert tt[0]["config"].snr_range == (
        _read(pr.DESIGN_RECORD.format(tag="89"))["passes"][2][
            "threshold_db"] + 1.0,
        _read(pr.DESIGN_RECORD.format(tag="89"))["passes"][2][
            "threshold_db"] + 3.0)
    names = [os.path.basename(p) for p, _ in out["jax"]["saved"]]
    assert names == ["orcq_89", "orcq_13_q4pl", "orcq_12_pol3"]
    assert all(os.path.dirname(p) == jax_pr.CK_DIR
               for p, _ in out["jax"]["saved"])
    for name, (_, tree) in zip(names, out["jax"]["saved"]):
        got = load_checkpoint(os.path.join(tdir, pr.CK_DIR, name))
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: np.shape(v) for k, v in tree.items()}


def test_design_and_polish_equal_the_jax_programs(runs):
    """``design`` (rates 8/9 and 1/3, whose grid is 1/8) and ``polish``
    (rate 8/9 probed and refined twice at its floor's peak; rate 2/3 clean,
    skipped): the designer calls with equal arguments in the same order
    and equal files, the twin's in the working directory."""
    out, jdir, tdir = runs
    jd, td = out["jax"]["design"], out["torch"]["design"]
    assert [c[0] for c in td] == [c[0] for c in jd]
    assert [c[0] for c in td] == (["iterate_refine"] * 2 +
                                  ["density_evolution"] * 5 +
                                  ["refine_ladders_protograph"] * 2 +
                                  ["density_evolution"] * 5)
    for (_, targs, tkw), (_, jargs, jkw) in zip(td, jd):
        assert tkw == jkw
        for t, j in zip(targs, jargs):
            if isinstance(j, np.ndarray):
                np.testing.assert_array_equal(t, j)
            else:
                assert t == j
    assert td[1][2]["grid_step"] == 1 / 8
    for tag in ("89", "13"):
        assert _read(os.path.join(tdir, pr.DESIGN_PATH.format(tag=tag))) == \
            _read(os.path.join(jdir, "experiments",
                               f"pbrl_rates_design_{tag}.json"))
    for tag in ("89", "23"):
        assert _read(os.path.join(tdir, pr.POLISH_PATH.format(tag=tag))) == \
            _read(os.path.join(jdir, "experiments",
                               f"pbrl_rates_design_{tag}_polish.json"))


def test_report_on_the_committed_scans_equals_the_jax_programs(
        tmp_path, monkeypatch, capsys):
    """``report`` on copies of ``experiments/pbrl_rates_ck/*.json``: the
    same table and lines; the record's gaps (rate 1/3's rcq-pol +0.076 dB,
    rate 8/9's rcq-pol -0.022 dB)."""
    jdir = _jax_dir(str(tmp_path / "jax"), records=True)
    tdir = tmp_path / "torch"
    os.makedirs(tdir / pr.CK_DIR)
    for fn in os.listdir(RECORD_CK):
        if fn.endswith(".json"):
            shutil.copy(os.path.join(RECORD_CK, fn), tdir / pr.CK_DIR)
    monkeypatch.chdir(jdir)
    want = jax_pr.report(str(tmp_path / "jax.json"))
    jlines = capsys.readouterr().out
    monkeypatch.chdir(tdir)
    got = pr.report()
    assert capsys.readouterr().out == jlines
    assert got == want == _read(tdir / pr.OUT_PATH)
    assert _read(tmp_path / "jax.json") == want
    assert want["13"]["arms"]["rcq-pol"]["gap_vs_oms6_db"] == 0.076
    assert want["89"]["arms"]["rcq-pol"]["gap_vs_oms6_db"] == -0.022
    assert want["89"]["arms"]["rcq-best"]["snr_at_1e-6"] is None


def test_outputs_stay_out_of_experiments():
    for path in (pr.DESIGN_PATH, pr.POLISH_PATH, pr.CK_DIR, pr.OUT_PATH,
                 t89.OUT):
        assert os.path.dirname(path) == "" and "torch" in path
    for tag in pr.RATES:
        for path in (pr.DESIGN_RECORD.format(tag=tag),
                     pr.POLISH_RECORD.format(tag=tag)):
            assert os.path.dirname(path) == EXP and os.path.exists(path)
    assert os.path.dirname(pr.TABLES) == os.path.dirname(pr.__file__)


# -- the twins at lift 8 ------------------------------------------------------

def test_tighten89_runs_tiny_with_punctured_zeros(tmp_path, monkeypatch):
    """``tighten89.main`` at lift 8 (the rate-8/9 base's shifts mod 8, n =
    224) with waves of 256 (budget 64), one SNR and one compacted wave an
    arm: the JAX record's keys, and every batch K1 is handed, the wave's
    stage 1 and the gathered survivors' stage 2, with zeros at the 8
    punctured positions."""
    real = lt.create_pbrl_qc_protograph

    def narrowed(*args, **kw):
        b, _, punct = real(*args, **kw)
        return np.where(b >= 0, b % 8, -1), 8, punct

    calls, dec = [], fused._decode

    def spy(flooding, llr, *args):
        calls.append((llr.shape[0], llr[:, :8].abs().max().item()))
        return dec(flooding, llr, *args)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(lt, "create_pbrl_qc_protograph", narrowed)
    monkeypatch.setattr(pr, "wave_size", lambda n: 256)
    monkeypatch.setattr(pr, "BUDGET", 64)
    monkeypatch.setattr(pr, "MIN_FRAMES", 256)
    monkeypatch.setattr(t89, "SNRS", (9.0,))
    monkeypatch.setattr(t89, "MAX_FRAMES", 256)
    monkeypatch.setattr(fused, "_decode", spy)
    res = t89.main(device="cpu")
    rec = _read(os.path.join(EXP, "tighten89_results.json"))
    assert list(res) == list(rec)
    for arm in res:
        assert list(res[arm]["9.0"]) == list(rec[arm]["9.0"])
        assert res[arm]["9.0"]["frames"] == 256
    assert _read(tmp_path / t89.OUT) == res
    assert [b for b, _ in calls] == [256, 64] * 3
    assert {m for _, m in calls} == {0.0}


@pytest.mark.parametrize("call", [
    lambda: pr.main(["--phase", "deep", "--rates", "89"]),
    lambda: pr.main(["--phase", "train", "--rates", "89"]),
    lambda: t89.cli([])], ids=["pbrl_rates_deep", "pbrl_rates_train",
                               "tighten89"])
def test_twin_needs_a_card_unless_told_cpu(call, tmp_path, monkeypatch):
    """Each twin runs on the card by default: without one it raises
    before it decodes or trains."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    with pytest.raises(RuntimeError, match="CUDA card"):
        call()


# -- the port as a whole ------------------------------------------------------

def test_every_port_module_imports_without_jax_and_defaults_to_the_card():
    """In a process where ``jax`` cannot be imported, every module of
    ``ldpc_tpu_torch`` imports, none brings in ``ldpc_tpu``, every
    function with a ``device`` default names the card (or None: each
    rank's own card) and every ``--device`` option defaults to the card;
    so do ``chip_smoke.py``'s imports."""
    code = r"""
import ast, importlib, inspect, json, pkgutil, sys
sys.modules["jax"] = None
import ldpc_tpu_torch
bad, names = [], []
for m in pkgutil.walk_packages(ldpc_tpu_torch.__path__, "ldpc_tpu_torch."):
    mod = importlib.import_module(m.name)
    names.append(m.name)
    for cname, obj in [("", mod)] + inspect.getmembers(mod, inspect.isclass):
        for name, fn in inspect.getmembers(obj, inspect.isfunction):
            if fn.__module__ != m.name:
                continue
            p = inspect.signature(fn).parameters.get("device")
            if p is not None and p.default is not p.empty and \
                    str(p.default) != "cuda" and p.default is not None:
                bad.append(f"{m.name} {cname}.{name}: {p.default}")
    with open(mod.__file__) as f:
        for node in ast.walk(ast.parse(f.read())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "attr", None) == "add_argument" and any(
                    isinstance(a, ast.Constant) and a.value == "--device"
                    for a in node.args):
                kw = {k.arg: k.value for k in node.keywords}
                if getattr(kw.get("default"), "value", None) != "cuda":
                    bad.append(f"{m.name} --device")
sys.path.insert(0, sys.argv[1])
import chip_smoke
leaked = sorted(k for k in sys.modules if k == "ldpc_tpu" or
                k.startswith("ldpc_tpu."))
print(json.dumps(dict(count=len(names), names=names, bad=bad,
                      leaked=leaked)))
"""
    r = subprocess.run([sys.executable, "-c", code, REPO],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["count"] >= 60
    assert {f"ldpc_tpu_torch.cli.{m}" for m in (
        "pbrl_bv10", "pbrl_cn_probe", "pbrl_vqp_sweep",
        "pbrl_vqp_gamma")} <= set(got["names"])
    assert got["bad"] == [] and got["leaked"] == []
