"""The bench-code design studies' twins (``ldpc_tpu_torch.cli.ladder_bc4``,
``.bc4_refine``, ``.quantizer_count``, ``.dde_ladders``) on the CPU.

Each JAX program's ``run`` or phase functions run here with recorders in
place of ``simulate_single_snr``, the designers (``iterate_refine``,
``design_rcq_ladders``, ``refine_ladders_protograph``) and
``enable_compilation_cache``, and so do the twins with the port's
recorders, each package in a directory of its own (the JAX programs read
and write ``experiments/...`` relative to the working directory: that
directory holds copies of the committed inputs). Held field for field:
codes (base, lift, punctured bits), decoder specs with the CN and V2C
ladders, bc, bv, T, ``lean`` and dtype, every ``SimulationConfig`` field,
arm names and order, the design calls, the files written and the resume
and stop rules (``bc4_refine`` stops an arm at a point it measures with
no error, ``quantizer_count`` at a cached one too).

K1's plain version is held to ``ldpc_tpu``'s general layered engine given
the base rows as its layers (the schedule of its layered QC engine), read
at iteration T of its trajectory (the kernel never freezes a frame), in
f32 on numpy LLRs: the two-pair ``p2`` ladder at T=10 on the precoded
49x73 PBRL base (shifts mod 8, lift 8) with base column 0's LLRs
multiplied by zero, ``rcq-q2``'s two-pair ladder at T=6 and the mixed-gamma
bc=4 ladder (2.2, 2.2, 1.5) on the bench base at lift 16. Hard outputs
exactly, posteriors to rtol 1e-6 / atol 1e-5. The same engine runs give
the decode-neutral V2C ladder: with one CN ladder, the V2C ladders 4-8-12
and 64-41-45 give equal bits, success and iterations in both packages.
``ldpc_tpu``'s QC engines and interpret-mode kernels are not run: they
cost 18-24 s a compile at full width here.

Each twin also runs for real at a tiny size (waves of 256 frames, one
SNR, the bench base at lift 16 and the PBRL base at lift 8) and writes the
JAX record's keys.
"""

import dataclasses
import hashlib
import inspect
import json
import os
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.bc4_refine as jax_br
import experiments.dde_ladders as jax_dl
import experiments.ladder_bc4 as jax_lb
import experiments.quantizer_count as jax_qc
import ldpc_tpu
import ldpc_tpu.design
import ldpc_tpu.sim
import ldpc_tpu.utils.cache
import ldpc_tpu_torch as lt
import ldpc_tpu_torch.design
from ldpc_tpu.decode import variants as jax_variants
from ldpc_tpu.decode.engine import decode_batch_layered as jax_layered
from ldpc_tpu_torch.cli import bc4_refine as br
from ldpc_tpu_torch.cli import deep_fer
from ldpc_tpu_torch.cli import dde_ladders as dl
from ldpc_tpu_torch.cli import ladder_bc4 as lb
from ldpc_tpu_torch.cli import quantizer_count as qcn
from ldpc_tpu_torch.decode import engine, fused
from ldpc_tpu_torch.decode import variants as lt_variants
from ldpc_tpu_torch.quantizer import phase_schedule, power_thresholds
from torch_port_helpers import (assert_same_config, assert_same_decoder,
                                assert_same_fields, channel_llr,
                                one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
TPU_ONLY = ("batch_tile", "interpret", "natural")
# the committed files the JAX programs read relative to the working
# directory
INPUTS = ("bc4_floor_polish.json", "quantizer_count_design.json",
          "quantizer_count_design13_polish.json",
          "pbrl_rates_design_13_polish.json")
# the point each deep phase finds in its file before it starts: a cached
# zero stops quantizer_count's arm there and not bc4_refine's
CACHED = {"bc3": {"6.2": {"fer": 0.0, "frames": 65536, "errors": 0}}}
CACHED_Q = {"rcq-q3": CACHED["bc3"]}


def _record(name):
    with open(os.path.join(EXP, f"{name}_results.json")) as f:
        return json.load(f)


def _read(path):
    with open(path) as f:
        return json.load(f)


def _memo_graph(build):
    """``build_graph`` remembering each parity-check matrix's graph."""
    seen = {}

    def memo(code):
        H = np.ascontiguousarray(code.H)
        key = (H.shape, hashlib.sha1(H.tobytes()).hexdigest())
        if key not in seen:
            seen[key] = build(code)
        return seen[key]
    return memo


def _history(mod, cn, v2c):
    """A two-pass refine history of the design package ``mod`` from the
    recorded seed ladders: the same in both packages."""
    cn = tuple(tuple(p) for p in cn)
    v2c = tuple(tuple(p) for p in v2c)
    return mod.RefineHistory([
        mod.RefinePass(0, cn, v2c, 6.25),
        mod.RefinePass(1, tuple((c * 1.125, g) for c, g in cn), v2c, 6.125,
                       de_floor=1e-9)], "threshold")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(``{(package, program): {"sim": [(decoder, SNR, config)],
    "design": [(name, args, kwargs)], "out": [each part's return]}}``,
    ``{package: {file: JSON}, "ck": (checkpoint directory made in each)}``):
    each program and its twin run with recorders in their own working
    directories."""
    rec = {}

    def single(decoder, snr_db, config, *args, **kw):
        i = len(rec["sim"])
        rec["sim"].append((decoder, snr_db, config))
        ne = 0 if snr_db >= rec["zero_at"] else 100 + i
        fer = ne / 65536 if ne else 0.0
        if rec["zero_at"] > 90:   # the dev sweeps: distinct FERs
            fer = ((7 * i + 3) % 11 + 1) / 1000
        return fer, 1e-4, 3.0, 65536, ne

    def designers(mod):
        def iterate_refine(base, cn, v2c, **kw):
            rec["design"].append(("iterate_refine", (base, cn, v2c), kw))
            return _history(mod, cn, v2c)

        def design_rcq_ladders(profile, **kw):
            rec["design"].append(("design_rcq_ladders", (profile,), kw))
            bc = kw["bc"]
            return (((1.0 + bc, 1.3), (2.0 + bc, 1.3), (3.0 + bc, 1.3)),
                    ((40.0 + bc, 1.0), (5.5, 1.0), (80.0, 1.0)),
                    types.SimpleNamespace(threshold_db=6.0 + bc / 10))

        def refine(base, qp, vqp, **kw):
            rec["design"].append(("refine_ladders_protograph",
                                  (base, qp, vqp), kw))
            return (tuple((c * 1.25, g) for c, g in qp),
                    tuple((c, g) for c, g in vqp), 6.05)
        return dict(iterate_refine=iterate_refine,
                    design_rcq_ladders=design_rcq_ladders,
                    refine_ladders_protograph=refine)

    def part(key, zero_at, fn):
        rec.update(rec_of[key])
        rec["zero_at"] = zero_at
        rec_of[key]["out"].append(fn())

    tmp = tmp_path_factory.mktemp("runs")
    jdir, tdir = tmp / "jax", tmp / "torch"
    os.makedirs(jdir / "experiments")
    os.makedirs(tdir)
    for name in INPUTS:
        shutil.copy(os.path.join(EXP, name), jdir / "experiments" / name)
    with open(jdir / "experiments" / "bc4_refine_results.json", "w") as f:
        json.dump(CACHED, f)
    with open(jdir / "experiments" / "quantizer_count_results.json",
              "w") as f:
        json.dump(CACHED_Q, f)
    with open(tdir / br.OUT, "w") as f:
        json.dump(CACHED, f)
    with open(tdir / qcn.OUT, "w") as f:
        json.dump(CACHED_Q, f)

    programs = ("ladder_bc4", "bc4_refine", "quantizer_count",
                "dde_ladders")
    rec_of = {(pkg, p): {"sim": [], "design": [], "out": []}
              for pkg in ("jax", "torch") for p in programs}
    cpu = dict(device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        # both packages' decoders share their code's graph (a dense scan of
        # H, a quarter of a second at lift 256)
        for mod in (jax_variants, lt_variants):
            mp.setattr(mod, "build_graph", _memo_graph(mod.build_graph))
        mp.setattr(ldpc_tpu.sim, "simulate_single_snr", single)
        mp.setattr(lt, "simulate_single_snr", single)
        mp.setattr(ldpc_tpu.utils.cache, "enable_compilation_cache",
                   lambda *a, **k: None)
        mp.setattr("logging.basicConfig", lambda **kw: None)
        for mod in (ldpc_tpu.design, ldpc_tpu_torch.design):
            for k, v in designers(mod).items():
                mp.setattr(mod, k, v)
        mp.chdir(jdir)
        j = "jax"
        part((j, "ladder_bc4"), 99.0, lambda: jax_lb.run(
            out_path="ladder_bc4.json", verbose=False))
        part((j, "bc4_refine"), 6.4, lambda: jax_br.design(verbose=False))
        part((j, "bc4_refine"), 6.4, lambda: jax_br.deep(
            arms=("bc4", "bc3", "bc4-seed"), verbose=False))
        part((j, "bc4_refine"), 6.4, jax_br.report)
        part((j, "quantizer_count"), 6.4,
             lambda: jax_qc.design(verbose=False))
        part((j, "quantizer_count"), 6.4,
             lambda: jax_qc.design13(verbose=False))
        part((j, "quantizer_count"), 6.4, lambda: jax_qc.deep(
            verbose=False))
        part((j, "quantizer_count"), 1.8, lambda: jax_qc.deep13(
            verbose=False))
        part((j, "dde_ladders"), 99.0, lambda: jax_dl.run(
            out_path="dde_ladders.json", verbose=False))
        mp.chdir(tdir)
        t = "torch"
        part((t, "ladder_bc4"), 99.0, lambda: lb.run(
            out_path="ladder_bc4.json", verbose=False, **cpu))
        part((t, "bc4_refine"), 6.4, lambda: br.design(verbose=False))
        part((t, "bc4_refine"), 6.4, lambda: br.deep(
            arms=("bc4", "bc3", "bc4-seed"), verbose=False, **cpu))
        part((t, "bc4_refine"), 6.4, br.report)
        part((t, "quantizer_count"), 6.4,
             lambda: qcn.design(verbose=False))
        part((t, "quantizer_count"), 6.4,
             lambda: qcn.design13(verbose=False))
        # the program's deep phase reads the design its design phase wrote
        part((t, "quantizer_count"), 6.4, lambda: qcn.deep(
            verbose=False, design=qcn.DESIGN_PATH, **cpu))
        part((t, "quantizer_count"), 1.8, lambda: qcn.deep13(
            verbose=False, **cpu))
        part((t, "dde_ladders"), 99.0, lambda: dl.run(
            out_path="dde_ladders.json", verbose=False, **cpu))
    files = {
        "jax": {k: _read(jdir / p) for k, p in (
            ("ladder_bc4", "ladder_bc4.json"),
            ("bc4_refine_design", "experiments/bc4_refine_design.json"),
            ("bc4_refine", "experiments/bc4_refine_results.json"),
            ("quantizer_count_design",
             "experiments/quantizer_count_design.json"),
            ("quantizer_count_design13",
             "experiments/quantizer_count_design13.json"),
            ("quantizer_count", "experiments/quantizer_count_results.json"),
            ("quantizer_count13",
             "experiments/quantizer_count13_results.json"),
            ("dde_ladders", "dde_ladders.json"))},
        "torch": {k: _read(tdir / p) for k, p in (
            ("ladder_bc4", "ladder_bc4.json"),
            ("bc4_refine_design", br.DESIGN_PATH),
            ("bc4_refine", br.OUT),
            ("quantizer_count_design", qcn.DESIGN_PATH),
            ("quantizer_count_design13", qcn.PBRL_DESIGN),
            ("quantizer_count", qcn.OUT),
            ("quantizer_count13", qcn.OUT13),
            ("dde_ladders", "dde_ladders.json"))},
        "ck": (os.path.isdir(jdir / "experiments" / "quantizer_count_ck"),
               os.path.isdir(tdir / qcn.CK_DIR)),
    }
    return rec_of, files


def _strip(jdec):
    """``jdec`` without the TPU-only ``qc_options`` keys."""
    opts = jdec.qc_options and {k: v for k, v in jdec.qc_options.items()
                                if k not in TPU_ONLY}
    return dataclasses.replace(jdec, qc_options=opts)


PROGRAMS = ("ladder_bc4", "bc4_refine", "quantizer_count", "dde_ladders")


# -- configurations ----------------------------------------------------------

@pytest.mark.parametrize("name", PROGRAMS)
def test_simulations_equal_the_jax_programs(runs, name):
    """Every ``simulate_single_snr`` call in the program's order: the SNR,
    each ``SimulationConfig`` field and each decoder (code, QC tables,
    spec with both ladders, bc, bv, T, options without the TPU-only keys:
    ``lean`` and float32 on the CPU)."""
    rec_of, _ = runs
    jsim, tsim = rec_of["jax", name]["sim"], rec_of["torch", name]["sim"]
    assert len(tsim) == len(jsim) > 1
    held = {}
    for (tdec, tsnr, tcfg), (jdec, jsnr, jcfg) in zip(tsim, jsim):
        assert tsnr == jsnr
        assert_same_config(tcfg, jcfg)
        assert tcfg.device == "cpu"
        if id(jdec) not in held:
            assert_same_decoder(tdec, _strip(jdec))
            assert tdec.qc_options["dtype"] == torch.float32
            held[id(jdec)] = id(tdec)
        assert held[id(jdec)] == id(tdec)


@pytest.mark.parametrize("name", PROGRAMS)
def test_design_calls_equal_the_jax_programs(runs, name):
    """The designer calls in the program's order with equal arguments:
    bases, seed ladders, degree profiles, bc, bv, T, SNRs, schedules,
    sweeps, grids, passes and punctured columns."""
    rec_of, _ = runs
    jd, td = rec_of["jax", name]["design"], rec_of["torch", name]["design"]
    assert [c[0] for c in td] == [c[0] for c in jd]
    for (_, targs, tkw), (_, jargs, jkw) in zip(td, jd):
        assert tkw == jkw
        for t, j in zip(targs, jargs):
            if isinstance(j, np.ndarray):
                np.testing.assert_array_equal(t, j)
            elif dataclasses.is_dataclass(j):
                assert_same_fields(t, j)
            else:
                assert t == j
    want = {"ladder_bc4": [], "bc4_refine": ["iterate_refine"],
            "quantizer_count": ["iterate_refine"] * 2,
            "dde_ladders": ["design_rcq_ladders",
                            "refine_ladders_protograph"] * 2}[name]
    assert [c[0] for c in td] == want


@pytest.mark.parametrize("name", ["ladder_bc4", "bc4_refine_design",
                                  "bc4_refine", "quantizer_count_design",
                                  "quantizer_count_design13",
                                  "quantizer_count", "quantizer_count13",
                                  "dde_ladders"])
def test_files_equal_the_jax_programs(runs, name):
    """From the same recorded numbers each twin writes the file its
    program writes, key for key and value for value; the results files
    with the committed records' keys."""
    _, files = runs
    got, want = files["torch"][name], files["jax"][name]
    assert got == want
    if name in ("ladder_bc4", "dde_ladders"):
        assert list(got) == list(_record(name))
    elif name in ("bc4_refine", "quantizer_count", "quantizer_count13"):
        rec = _record(name)
        for arm, pts in got.items():
            ref = next(iter(rec.values()))
            assert all(list(p) == list(next(iter(ref.values())))
                       for p in pts.values())
    else:
        assert list(got) == ["passes", "stopped_by", "best_index"]


def test_stop_and_resume_rules(runs):
    """bc4_refine: the cached 0-error point of bc3 is kept and does not
    stop the arm, the first measured 0-error point does (6.0, 6.2 cached,
    6.4); quantizer_count stops at the cached one (6.0, 6.2 cached) and
    its rcq-q2 at 6.4; deep13 at 1.8 dB. The twins' ``report`` returns
    the file; ``quantizer_count``'s checkpoint directory is made, in the
    working directory."""
    rec_of, files = runs
    for pkg in ("jax", "torch"):
        sims = rec_of[pkg, "bc4_refine"]["sim"]
        assert [round(s, 1) for _, s, _ in sims] == [6.0, 6.2, 6.4, 6.0,
                                                     6.4, 6.0, 6.2, 6.4]
        q = rec_of[pkg, "quantizer_count"]["sim"]
        assert [round(s, 1) for _, s, _ in q] == [6.0, 6.2, 6.4, 6.0,
                                                  1.4, 1.6, 1.8, 1.4, 1.6,
                                                  1.8]
        assert rec_of[pkg, "bc4_refine"]["out"][2] == files[pkg][
            "bc4_refine"]
    assert files["ck"] == (True, True)
    assert files["torch"]["bc4_refine"]["bc3"]["6.2"] == CACHED["bc3"]["6.2"]
    assert list(files["torch"]["quantizer_count"]["rcq-q3"]) == ["6.2",
                                                                "6.0"]


def _stacked(ladder, T):
    """The [T, 2] per-iteration (C, gamma) table of ``ladder``."""
    return np.asarray(ladder, np.float32)[
        phase_schedule(T, len(ladder))].tolist()


def test_arms_ladders_and_codes(runs):
    """The arms the twins decode: ladder_bc4's six CN ladders then the
    selected one; bc4_refine's polished ``bc4`` ladder (mixed gamma 2.2,
    2.2, 1.5, lean), bc3 and the seed; quantizer_count's two-pair
    ``rcq-q2`` from the committed design's best pass, the PBRL arms on
    the 49x73 precoded base at lift 43 (n = 3139) with base column 0's 43
    bits punctured and waves of 98304; dde_ladders' ten arms, whose
    ``dde`` and ``dde_cn_only`` share the CN ladder."""
    rec_of, files = runs
    sims = rec_of["torch", "ladder_bc4"]["sim"]
    qps = [d.spec.qparams.tolist() for d, _, _ in sims]
    assert qps[:6] == [_stacked(v, 6) for v in lb.LADDERS.values()]
    sel = files["torch"]["ladder_bc4"]["selected"]
    assert sel == "4-7-10@1.3" and qps[6] == qps[7] == qps[3]
    assert [s for _, s, _ in sims[6:]] == [6.5, 6.6]
    assert (sims[6][2].early_exit_iters, sims[6][2].seed) == (2, 13)

    br_decs = [d for d, _, _ in rec_of["torch", "bc4_refine"]["sim"]]
    assert br_decs[0].spec.qparams.tolist() == _stacked(
        ((1.2708, 2.2), (6.7912, 2.2), (6.6537, 1.5)), 6)
    assert br_decs[0].spec.q_levels == 8 and br_decs[3].spec.q_levels == 4
    assert all(d.qc_options["lean"] for d in br_decs)

    q = rec_of["torch", "quantizer_count"]["sim"]
    # the deep phases read the design their design phase wrote: the
    # recorded best pass, the seed's C times 1.125
    assert q[0][0].spec.qparams.tolist() == _stacked(
        ((2.6474 * 1.125, 1.3), (5.3767 * 1.125, 1.3)), 6)
    # by default the twin's reads the committed design
    d = _read(qcn.DESIGN_RECORD)
    assert d["passes"][d["best_index"]]["cn"] == [[2.6474, 1.3],
                                                  [5.3767, 1.3]]
    assert inspect.signature(qcn.deep).parameters["design"].default == \
        qcn.DESIGN_RECORD
    pb, _, pcfg = q[4]
    assert (pb.qc.mb, pb.qc.nb, pb.qc.lift, pb.code.n) == (49, 73, 43, 3139)
    assert pcfg.punctured_positions == tuple(range(43))
    assert (pcfg.wave_size, pcfg.early_exit_iters, pcfg.survivor_budget,
            pb.max_iterations, "lean" in pb.qc_options) == (98304, 5, 4096,
                                                           10, False)

    dd = [d for d, _, _ in rec_of["torch", "dde_ladders"]["sim"]]
    names = list(files["torch"]["dde_ladders"]["fers"])
    assert [n.split("@")[1] for n in names] == ["6.4"] * 10 + ["6.5"] * 10
    assert [n.split("@")[0] for n in names[:10]] == [
        f"bc{b}_{a}" for b in (3, 4) for a in ("hand", "dde", "dde_cn_only",
                                               "dde_refined")] + [
        "bc3_dyn", "bc4_dyn"]
    for i in (1, 5):
        assert torch.equal(torch.as_tensor(dd[i].spec.qparams),
                           torch.as_tensor(dd[i + 1].spec.qparams))


def test_outputs_stay_out_of_experiments():
    for path in (lb.DEFAULT_OUT, br.DESIGN_PATH, br.OUT, qcn.DESIGN_PATH,
                 qcn.OUT, qcn.PBRL_DESIGN, qcn.OUT13, qcn.CK_DIR,
                 dl.DEFAULT_OUT):
        assert os.path.dirname(path) == "" and "torch" in path
    for path in (br.POLISH, qcn.DESIGN_RECORD, dl.DYNAMIC,
                 *qcn.POLISH13.values()):
        assert os.path.dirname(path) == EXP and os.path.exists(path)


# -- K1's plain version at the studies' new shapes ----------------------------

def _precoded8():
    b, lift, punct = lt.create_pbrl_qc_protograph(
        k=1032, rate=1 / 3, lift=43, precode=True, core_rate=8 / 9)
    assert (b.shape, lift, punct) == ((49, 73), 43, (0,))
    return np.where(b >= 0, b % 8, -1)


def _bench16():
    return np.random.default_rng(0).integers(0, 256, size=(5, 37)) % 16


V2C_64 = ((64.1855, 1.0), (40.9447, 1.0), (45.0392, 1.0))
# (base, lift, bc, T, CN ladder, V2C ladder, SNR, punctured base column)
CASES = {
    "p2_precoded": (_precoded8, 8, 4, 10, "p2", qcn.VQP, 0.5, 0),
    "rcq_q2": (_bench16, 16, 3, 6, ((2.6474, 1.3), (5.3767, 1.3)), qcn.VQP,
               5.0, None),
    "bc4_polish": (_bench16, 16, 4, 6, "polish", qcn.VQP, 6.0, None),
    "bc4_polish_v64": (_bench16, 16, 4, 6, "polish", V2C_64, 6.0, None),
}


def _ladder(qp):
    if qp == "p2":
        return tuple(tuple(x) for x in _read(qcn.POLISH13["p2"])["cn"])
    if qp == "polish":
        return br.ladder("bc4")[1]
    return qp


@pytest.fixture(scope="module")
def engine_runs():
    """{case: (port decoder, numpy LLRs, JAX engine result, posterior at
    iteration T)}: ``ldpc_tpu``'s general layered engine over the base
    rows, one compile a case, computed on first use."""
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        mk_base, lift, bc, T, qp, vqp, snr, punct = CASES[case]
        base, qp = mk_base(), _ladder(qp)
        kw = dict(kind="rcq", bc=bc, bv=8, quantizer_params=qp,
                  v2c_quantizer_params=vqp, max_iterations=T)
        tdec = lt.make_decoder(
            lt.create_qc_code(base, lift=lift, max_iterations=T),
            qc=lt.build_qc_graph(base, lift), layered=True,
            qc_options=dict(fused=True, dtype=torch.float32), device="cpu",
            **kw)
        jdec = ldpc_tpu.make_decoder(
            ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T),
            layered=True, **kw)
        H = tdec.code.H
        np.testing.assert_array_equal(jdec.code.H, H)
        llr = channel_llr(64, tdec.code.n, snr, seed=16 + T)
        if punct is not None:
            mask = np.ones(tdec.code.n, np.float32)
            mask[punct * lift:(punct + 1) * lift] = 0.0
            llr = llr * mask
        layers = np.arange(H.shape[0]).reshape(-1, lift)
        res = jax_layered(jnp.asarray(llr), jdec.weights, layers,
                          graph=jdec.graph, spec=jdec.spec, max_iterations=T,
                          return_trajectory=True)
        cache[case] = (tdec, llr, res, np.asarray(res.posteriors_all[-1]))
        return cache[case]
    return get


@pytest.mark.parametrize("case", ["p2_precoded", "rcq_q2", "bc4_polish"])
def test_plain_k1_equals_ldpc_tpu_layered_engine(engine_runs, case):
    """K1's plain version (the fused wrapper on CPU tensors, no launch)
    at the case's ladder, f32, 64 frames, against the engine's posterior
    at iteration T: bits and success equal, posteriors to rtol 1e-6 /
    atol 1e-5; on the precoded code the punctured LLRs are ±0 and stay
    so in the wrapper's storage."""
    tdec, llr, _, post = engine_runs(case)
    H = tdec.code.H
    bits = (post < 0).astype(np.int8)
    ok = ~((bits.astype(np.int64) @ H.T.astype(np.int64)) % 2).any(axis=1)
    before = fused.LAYERED_LAUNCHES
    out = tdec(torch.from_numpy(llr))
    assert fused.LAYERED_LAUNCHES == before
    assert 0 < ok.sum() < 64
    np.testing.assert_array_equal(out.bits.numpy(), bits)
    np.testing.assert_array_equal(out.success.numpy(), ok)
    np.testing.assert_allclose(out.posterior.numpy(), post, rtol=1e-6,
                               atol=1e-5)
    if case == "p2_precoded":
        assert np.signbit(llr[:, :8]).any() and not llr[:, :8].any()


@pytest.mark.parametrize("case,T", [("rcq_q2", 6), ("p2_precoded", 10)])
def test_two_pair_tables_follow_the_thirds_rule(engine_runs, case, T):
    """``phase_schedule(T, 2)`` gives the first pair to t < T // 3 and the
    second after (not halves): the [T, 2] (C, gamma) and [T, L] threshold
    tables K1 indexes by iteration are the pairs' rows in that order."""
    tdec = engine_runs(case)[0]
    sched = phase_schedule(T, 2)
    assert sched.tolist() == [0] * (T // 3) + [1] * (T - T // 3)
    ladder, bc = _ladder(CASES[case][4]), CASES[case][2]
    tabs = engine._tables(tdec.weights, tdec.spec, T, tdec.qc.num_blocks,
                          "cpu")
    assert tuple(tabs["qp"].shape) == (T, 2)
    assert tabs["qp"].tolist() == _stacked(ladder, T)
    thr = np.stack([power_thresholds(bc, c, g) for c, g in ladder])
    assert tuple(tabs["thr"].shape) == (T, 2 ** (bc - 1))
    np.testing.assert_array_equal(tabs["thr"].numpy(), thr[sched])


def test_v2c_ladder_is_decode_neutral_in_both_packages(engine_runs):
    """One mixed-gamma bc=4 CN ladder with the V2C ladders 4-8-12 and
    64-41-45: ``ldpc_tpu``'s engine gives equal bits, success and
    iterations; K1's plain version equal bits, success and iterations,
    full and lean alike."""
    a, b = engine_runs("bc4_polish"), engine_runs("bc4_polish_v64")
    np.testing.assert_array_equal(a[1], b[1])
    for f in ("bits", "success", "iterations"):
        np.testing.assert_array_equal(np.asarray(getattr(a[2], f)),
                                      np.asarray(getattr(b[2], f)))
    assert not np.array_equal(np.asarray(a[2].posterior),
                              np.asarray(b[2].posterior))
    x = torch.from_numpy(a[1])
    outs = [fused._fused_layered_plain(
        x, d.weights, qc=d.qc, spec=d.spec, max_iterations=6,
        dtype=torch.float32, lean=lean) for d in (a[0], b[0])
        for lean in (False, True)]
    for o in outs[1:]:
        assert torch.equal(o.bits.to(torch.int8), outs[0].bits.to(torch.int8))
        assert torch.equal(o.success, outs[0].success)
        assert torch.equal(o.iterations, outs[0].iterations)


# -- the twins at a tiny size ------------------------------------------------

def _small(cfg_fn, **over):
    """``cfg_fn`` with waves of 256 frames, a survivor budget of 64 and
    ``over``."""
    def small(*args, **kw):
        cfg = cfg_fn(*args, **kw)
        fields = dict(wave_size=256)
        if cfg.early_exit_iters is not None:
            fields.update(survivor_budget=64)
        return dataclasses.replace(cfg, **fields, **over)
    return small


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run in ``tmp_path`` with no logging set-up and the bench base cut to
    its first 12 columns (K1's plain version costs ≈ 0.25 s a call there,
    whatever the batch); afterwards nothing under ``experiments/`` has
    changed."""
    def snapshot():
        return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                for d, _, fs in os.walk(EXP) for f in fs}

    before = snapshot()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    full = deep_fer.bench_base
    monkeypatch.setattr(deep_fer, "bench_base",
                        lambda lift=256: full(lift)[:, :12])
    yield tmp_path
    assert snapshot() == before


def test_ladder_bc4_and_dde_ladders_run_tiny(in_tmp, monkeypatch):
    """ladder_bc4 at lift 16 (one wave of 256 a ladder at 4.5 dB, the
    deep point in one compacting wave) and dde_ladders at lift 16 with
    the designers' results given (each arm one wave at 4.5 dB): the
    records' keys; the ``dde`` and ``dde_cn_only`` arms, which differ only
    in the V2C ladder, count the same frame errors."""
    monkeypatch.setattr(lb, "deep_config", _small(lb.deep_config))
    rep = lb.run(frames=256, lift=16, dev_snr=4.5, deep_snrs=(4.5,),
                 deep_frames=256, verbose=False, device="cpu")
    assert _read(in_tmp / lb.DEFAULT_OUT) == rep
    rec = _record("ladder_bc4")
    assert list(rep) == list(rec) and list(rep["dev_fers_bc4"]) == list(
        rec["dev_fers_bc4"])
    assert list(rep["deep"]["4.5"]) == list(rec["deep"]["6.5"])
    assert rep["deep"]["4.5"]["frames"] == 256

    def design_rcq_ladders(profile, *, bc, **kw):
        return ((2.0, 1.3), (3.0, 1.3), (5.0, 1.3)), V2C_64, \
            types.SimpleNamespace(threshold_db=6.1)

    monkeypatch.setattr(ldpc_tpu_torch.design, "design_rcq_ladders",
                        design_rcq_ladders)
    monkeypatch.setattr(ldpc_tpu_torch.design, "refine_ladders_protograph",
                        lambda base, qp, vqp, **kw: (qp, qp, 6.0))
    rep = dl.run(frames=256, lift=16, dev_snrs=(4.5,), verbose=False,
                 device="cpu")
    assert _read(in_tmp / dl.DEFAULT_OUT) == json.loads(json.dumps(rep))
    rec = _record("dde_ladders")
    assert list(rep) == list(rec)
    assert list(rep["fers"]) == [k.replace("@6.4", "@4.5")
                                 for k in rec["fers"] if "@6.4" in k]
    fers = {k.split("@")[0]: v for k, v in rep["fers"].items()}
    assert 0 < fers["bc4_dde"] < 1
    for bc in (3, 4):
        assert fers[f"bc{bc}_dde"] == fers[f"bc{bc}_dde_cn_only"]


def test_bc4_refine_and_quantizer_count_run_tiny(in_tmp, monkeypatch):
    """bc4_refine's deep phase at lift 16 (arms bc4 and bc3 at 4.6 dB,
    one compacting wave of 256 each) then ``report``; quantizer_count's
    deep13 on the precoded base at lift 8 (shifts mod 8; p2 at 0.5 dB),
    every batch K1 is handed with zeros at the 8 punctured positions;
    the records' keys."""
    monkeypatch.setattr(br, "LIFT", 16)
    monkeypatch.setattr(br, "deep_config", _small(br.deep_config,
                                                  min_frames=256))
    res = br.deep(snr_lo=4.6, snr_hi=4.6, frames=256, verbose=False,
                  device="cpu")
    assert _read(in_tmp / br.OUT) == res == br.report()
    rec = _record("bc4_refine")
    assert list(res) == list(rec)
    for arm in res:
        assert list(res[arm]["4.6"]) == list(rec[arm]["6.0"])

    real = lt.create_pbrl_qc_protograph

    def narrowed(*args, **kw):
        out = real(*args, **kw)
        return (np.where(out[0] >= 0, out[0] % 8, -1), 8, *out[2:])

    calls, dec = [], fused._decode

    def spy(flooding, llr, *args):
        calls.append(llr[:, :8].abs().max().item())
        return dec(flooding, llr, *args)

    monkeypatch.setattr(lt, "create_pbrl_qc_protograph", narrowed)
    monkeypatch.setattr(qcn, "deep13_config", _small(qcn.deep13_config,
                                                     min_frames=256))
    monkeypatch.setattr(fused, "_decode", spy)
    res = qcn.deep13(arms=("p2",), snr_lo=0.5, snr_hi=0.5, frames=256,
                     verbose=False, device="cpu")
    assert _read(in_tmp / qcn.OUT13) == res
    assert list(res["p2"]["0.5"]) == list(_record("quantizer_count13")[
        "p2"]["1.4"])
    assert res["p2"]["0.5"]["frames"] == 256
    assert len(calls) >= 2 and set(calls) == {0.0}


@pytest.mark.parametrize("call", [
    lambda: lb.main([]), lambda: br.main(["--phase", "deep"]),
    lambda: qcn.main(["--phase", "deep13"]), lambda: dl.main([])],
    ids=["ladder_bc4", "bc4_refine", "quantizer_count", "dde_ladders"])
def test_twin_needs_a_card_unless_told_cpu(call, in_tmp, monkeypatch):
    """Each decoding twin runs on the card by default: without one it
    raises before it decodes (dde_ladders before its designs)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        call()
