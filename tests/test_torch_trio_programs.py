"""The precoded-PBRL training twins (``ldpc_tpu_torch.cli.pbrl_wrcq``,
``.train_matched``, ``.pbrl_honest_train``) on the CPU.

Held to the JAX programs (``experiments/pbrl_wrcq.py``,
``train_matched.py``, ``pbrl_honest_train.py``), imported from
``experiments/`` (their module level imports no jax). The programs read
and write ``experiments/...`` relative to the working directory, so the
phases that write run in a directory of their own holding copies of the
committed designs and trained checkpoints:

- ``pbrl_wrcq_tables.npz`` against the seven orbax checkpoints, element
  for element, and the ``save_checkpoint`` directories made from it;
- the constants, every ladder tag, every arm of ``build_arms`` and of
  the other two programs' ``mk`` (code, QC tables, spec, options without
  the TPU-only keys, weight tables where they are not drawn at random);
- ``dev_fer``, ``deep_fer``, ``train_arms``, ``train_arm`` and ``dev``
  with recorders in place of the simulator, the trainer and
  ``save_checkpoint``: the same calls with the same configurations;
- each program's ``__main__`` block run with recorders in place of its
  phases against the twin's ``main``: the same phases with the same
  arguments.

Outside the npz test the JAX programs read their trained tables from the
npz (:func:`_carried`; an orbax restore costs ≈ 1.5 s), and both
packages' decoders of one code share its graph (:func:`shared_graphs`).

K1's plain version (the fused wrapper on CPU tensors) is held to
``ldpc_tpu``'s fused layered kernel in interpret mode, the function K1
ports, through each program's own ``mk`` (which takes that route on the
CPU): ``rcq-dde`` (the 10-pair ladder), ``oms6`` and ``wrcq-ref3pl``
(the carried per-layer tables [10, 50] and [10, 225]) at T=10 on base
rows 0 and 1 of the precoded code and the 7 columns they touch (the
precode column among them, punctured), shifts mod 8, 64 frames at 4-5
dB (17-20 of them decoded): bits,
success and iterations exactly, posteriors to rtol 1e-6 / atol 1e-5.
The whole base is not compiled (over 48 s a decoder in interpret mode
on the CPU), and ``ldpc_tpu``'s layered engines are not the reference: they
fold column sums in another order, and on this code the 10-pair
ladder's quantizers turn that into other hard decisions on failing
frames. The per-layer tables keep their shapes on the piece: each block
reads the entry of its own base row and degree bucket in the full code.

One training step of each configuration the programs train (W-OMS-RCQ
type 2 with bv=None and ``weight_decay`` 1e-3, W-RCQ type 2, per-layer
tables) is held to ``ldpc_tpu``'s trainer on the QC code of the trainer
parity tests (2x4 base, lift 4, T=5, B=16) with the first column's
LLRs zero. The two identities the programs rest on are held on K1's
plain version and on ``ldpc_tpu``'s general layered engine: W-OMS-RCQ
with all-zero tables decodes as plain RCQ, and ``rcq-ref3`` decodes the
same under the uniform V2C ladder as under design3's refined one.
"""

import ast
import dataclasses
import hashlib
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.pbrl_honest_train as jax_ht
import experiments.pbrl_wrcq as jax_pw
import experiments.train_matched as jax_tm
import ldpc_tpu
import ldpc_tpu.design
import ldpc_tpu.sim
import ldpc_tpu.train
import ldpc_tpu.utils.cache
import ldpc_tpu.utils.checkpoint
import ldpc_tpu_torch as lt
import ldpc_tpu_torch.decode.variants as lt_variants
from ldpc_tpu.decode import variants as jax_variants
from ldpc_tpu.decode.engine import decode_batch_layered as jax_layered
from ldpc_tpu.sim import SimulationResult as JaxSimulationResult
from ldpc_tpu_torch.cli import pbrl_honest_train as ht
from ldpc_tpu_torch.cli import pbrl_wrcq as pw
from ldpc_tpu_torch.cli import train_matched as tm
from ldpc_tpu_torch.decode import fused
from ldpc_tpu_torch.sim import SimulationResult
from ldpc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from torch_port_helpers import (assert_same_config, assert_same_decoder,
                                channel_llr, decoder_pair, make_base,
                                one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
RECORD_CK = os.path.join(EXP, "pbrl_wrcq_ck")
TPU_ONLY = ("batch_tile", "interpret")
CHECKPOINTS = ("orcq_dde", "orcq_hand", "orcq_ref2", "orcq_ref2pl",
               "orcq_ref3", "orcq_ref3it", "orcq_ref3pl")
TAGS = ("hand", "dde", "ref3", "ref3pl", "ref2", "ref2pl", "ref3it",
        "ref3itpl", "ref4", "ref4pl", "ref5", "ref5pl")
# every plain arm the committed files give pbrl_wrcq, and the trained arms
# of its default dev sweep (every carried table is held to its checkpoint
# by the npz test)
WRCQ_ARMS = ("oms6", "rcq-hand", "rcq-dde", "rcq-ref2", "rcq-ref3",
             "rcq-ref3it", "rcq-ref4", "rcq-ref5", "rcq5-ref3",
             "wrcq-hand", "wrcq-dde", "wrcq-ref3", "wrcq-ref3pl")


@pytest.fixture(autouse=True, scope="module")
def shared_graphs():
    """Both packages' decoders of one code share its graph (a dense scan
    of H, ≈ 0.08 s at n = 3182, which these tests would repeat ≈ 50 times
    a package)."""
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


def _carried(path):
    """``ldpc_tpu``'s ``load_checkpoint`` of a copy of
    ``experiments/pbrl_wrcq_ck/orcq_<tag>``, read from
    ``pbrl_wrcq_tables.npz`` (equal to the orbax checkpoints element for
    element: :func:`test_tables_npz_equals_the_orbax_checkpoints`; an orbax
    restore costs ≈ 1.5 s); the trained arms of ``train_matched`` and
    ``pbrl_honest_train`` read ``orcq_ref2`` (per layer ``orcq_ref3pl``)."""
    name = os.path.basename(os.path.normpath(path))
    if not name.startswith("orcq_"):
        name = "orcq_ref3pl" if name.endswith("pl") else "orcq_ref2"
    with np.load(pw.TABLES) as f:
        return {k: f[f"{name}/{k}"] for k in ("beta", "alpha")}


def _strip(jdec):
    """``jdec`` without the TPU-only ``qc_options`` keys."""
    opts = jdec.qc_options and {k: v for k, v in jdec.qc_options.items()
                                if k not in TPU_ONLY}
    return dataclasses.replace(jdec, qc_options=opts)


def _jax_dir(root, checkpoints=False):
    """A working directory for the JAX programs: copies of the committed
    designs (and, with ``checkpoints``, the trained tables) under
    ``root/experiments``."""
    exp = os.path.join(root, "experiments")
    os.makedirs(exp, exist_ok=True)
    for fn in ("pbrl_wrcq_design.json", "pbrl_wrcq_design3.json"):
        shutil.copy(os.path.join(EXP, fn), exp)
    if checkpoints:
        for name in CHECKPOINTS:
            shutil.copytree(os.path.join(RECORD_CK, name),
                            os.path.join(exp, "pbrl_wrcq_ck", name))
    return root


# -- tables, constants, ladders and arms -------------------------------------

def test_tables_npz_equals_the_orbax_checkpoints(tmp_path):
    """The committed ``pbrl_wrcq_tables.npz`` (under 30 KiB) holds the
    seven checkpoints' float32 ``beta`` and ``alpha``, equal element for
    element to ``ldpc_tpu``'s ``load_checkpoint`` of the orbax
    directories; ``install_tables`` writes each as a ``save_checkpoint``
    directory that ``load_checkpoint`` reads back equal, and leaves an
    existing one alone."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import jax_reference_pbrl_wrcq as ref
    finally:
        sys.path.pop(0)
    want = ref.tables()
    assert os.path.getsize(pw.TABLES) < 30 * 1024
    with np.load(pw.TABLES) as f:
        assert sorted(f.files) == sorted(want) == sorted(
            f"{c}/{k}" for c in CHECKPOINTS for k in ("beta", "alpha"))
        for key, v in want.items():
            assert f[key].dtype == np.float32
            np.testing.assert_array_equal(f[key], v)
    for c in CHECKPOINTS:
        shapes = ((10, 50), (10, 225)) if c.endswith("pl") else ((10, 2),
                                                                (10, 9))
        assert (want[f"{c}/beta"].shape, want[f"{c}/alpha"].shape) == shapes
    ck = str(tmp_path / "ck")
    assert pw.install_tables(ck) == list(CHECKPOINTS)
    for c in CHECKPOINTS:
        tree = load_checkpoint(os.path.join(ck, c))
        assert set(tree) == {"beta", "alpha"}
        for k, v in tree.items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), want[f"{c}/{k}"])
    assert pw.install_tables(ck) == []
    shutil.rmtree(os.path.join(ck, "orcq_ref3"))
    assert pw.install_tables(ck, ["orcq_ref3", "orcq_dde"]) == ["orcq_ref3"]


def test_constants_and_ladders_equal_the_jax_programs(monkeypatch):
    """Every constant, each ladder tag's (CN, V2C) pair (``dde`` is the
    10-pair ladder, ``ref4`` reaches 1408.4 in V2C), the arms' tables of
    ``train_matched`` and ``pbrl_honest_train``; an unknown tag raises in
    both."""
    monkeypatch.chdir(REPO)
    assert (pw.HAND_CN, pw.VQP8, pw.VQP6, pw.T) == (
        jax_pw.HAND_CN, jax_pw.VQP8, jax_pw.VQP6, jax_pw.T)
    for tag in TAGS:
        assert pw._ladder(tag) == jax_pw._ladder(tag), tag
    assert len(pw._ladder("dde")[0]) == 10
    assert {g for _, g in pw._ladder("dde")[0]} == {1.0, 1.3}
    assert pw._ladder("ref4")[1][-1] == (1408.3534, 1.0)
    for bad in ("handpl", "ref6"):
        with pytest.raises(ValueError):
            pw._ladder(bad)
        with pytest.raises(ValueError):
            jax_pw._ladder(bad)
    assert tm.ARMS == jax_tm.ARMS
    assert (ht.ARMS, ht.CN_REF3, ht.VQP8, ht.VQP6, ht.T) == (
        jax_ht.ARMS, jax_ht.CN_REF3, jax_ht.VQP8, jax_ht.VQP6, jax_ht.T)
    assert ht.CN_REF3 == pw._ladder("ref3")[0]
    assert (pw.WAVE, pw.MIN_FRAMES, pw.BUDGET, tm.BUDGET, ht.BUDGET) == (
        32768, 65536, 4096, 4096, 8192)


def test_pbrl_wrcq_arms_equal_the_jax_programs(tmp_path, monkeypatch):
    """Every arm of ``build_arms`` built by both packages (no decode): the
    precoded code (base column 0's 86 bits punctured), QC tables, spec
    (the per-iteration quantizer tables, bc=5's closed form), options
    (float32 on the CPU), weights: the pinned OMS constants and each
    trained table, the twin's installed from the npz into its own
    checkpoint directory."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(ldpc_tpu.utils.checkpoint, "load_checkpoint",
                        _carried)
    jarms, jpunct = jax_pw.build_arms(WRCQ_ARMS)
    monkeypatch.chdir(tmp_path)
    tarms, tpunct = pw.build_arms(WRCQ_ARMS, "cpu")
    assert tpunct == jpunct == tuple(range(86))
    assert list(tarms) == list(jarms) == list(WRCQ_ARMS)
    for name, jdec in jarms.items():
        tdec = tarms[name]
        assert_same_decoder(tdec, _strip(jdec))
        assert tdec.qc_options == dict(fused=True, dtype=torch.float32)
        assert tdec.code.n == 3182 and tdec.qc.lift == 86
    assert tarms["rcq5-ref3"].spec.closed_qdq
    assert tarms["wrcq-ref3pl"].recipe["per_layer"]
    assert sorted(os.listdir(pw.CK_DIR)) == ["orcq_dde", "orcq_hand",
                                             "orcq_ref3", "orcq_ref3pl"]


def test_train_matched_and_honest_arms_equal_the_jax_programs():
    """Every decoder ``train_matched._setup`` and ``pbrl_honest_train``'s
    ``_setup`` make (the ref2 ladder; CN_REF3 with bv=8 and the uniform
    V2C ladder, or bv=None and no V2C quantizer, for every arm's kind and
    ``per_layer``): code, spec, options; the weights where they are not
    drawn at random (plain RCQ, the pinned OMS)."""
    jmk, jpunct = jax_tm._setup()
    tmk, tpunct = tm._setup("cpu")
    assert tpunct == jpunct
    for kind in ("rcq", "orcq"):
        assert_same_decoder(tmk(kind), _strip(jmk(kind)),
                            weights=kind == "rcq")
    jmk, jpunct = jax_ht._setup()
    tmk, tpunct = ht._setup("cpu")
    assert tpunct == jpunct
    assert_same_decoder(tmk("oms6"), _strip(jmk("oms6")))
    assert_same_decoder(tmk("rcq"), _strip(jmk("rcq")))
    for spec in ht.ARMS.values():
        for bv in (8, None):
            tdec = tmk(spec["kind"], bv=bv, per_layer=spec["per_layer"])
            assert_same_decoder(tdec, _strip(jmk(
                spec["kind"], bv=bv, per_layer=spec["per_layer"])),
                weights=False)
            assert (tdec.spec.v2c_qparams is None) == (bv is None)


# -- K1's plain version against ldpc_tpu's kernel -----------------------------

ROWS, LIFT = (0, 1), 8


def _piece_protograph(real):
    """A ``create_pbrl_qc_protograph`` giving the precoded base's rows
    ROWS and the columns they touch at lift LIFT (shifts mod LIFT), and
    the original columns kept."""
    base = real(k=1032, rate=1 / 3, precode=True)[0]
    cols = np.flatnonzero((base[list(ROWS)] >= 0).any(axis=0))

    def narrowed(*args, **kw):
        b, _, punct = real(*args, **kw)
        sub = b[list(ROWS)][:, cols]
        return np.where(sub >= 0, sub % LIFT, -1), LIFT, punct
    return narrowed, cols


def _rewired(dec, full, cols):
    """``dec`` (on the piece) with each block's per-layer bucket the one
    its base row and column have in ``full`` (the whole code), and the
    whole code's table sizes."""
    where = {(int(r), int(c)): j for j, (r, c) in enumerate(
        zip(full.qc.block_row, full.qc.block_col))}
    pick = np.array([where[int(ROWS[r]), int(cols[c])] for r, c in zip(
        dec.qc.block_row, dec.qc.block_col)])
    spec = dataclasses.replace(
        dec.spec,
        beta_idx=np.asarray(full.spec.beta_idx, np.int32)[pick],
        alpha_idx=np.asarray(full.spec.alpha_idx, np.int32)[pick],
        n_beta=full.spec.n_beta, n_alpha=full.spec.n_alpha)
    return dataclasses.replace(dec, spec=spec)


@pytest.fixture(scope="module")
def k1_runs():
    """{arm: (port result, JAX result, LLRs)} of ``rcq-dde``, ``oms6`` and
    ``wrcq-ref3pl`` on the piece: each program's ``build_arms`` /
    ``mk`` with the protograph narrowed, the JAX decoders in interpret
    mode (three compiles)."""
    with np.load(pw.TABLES) as f:
        carried = {k: f[f"orcq_ref3pl/{k}"] for k in ("beta", "alpha")}
    full = pw._mk_setup("cpu")[0]("orcq", pw._ladder("ref3pl")[0],
                                  vqp=pw._ladder("ref3pl")[1],
                                  per_layer=True)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        jnarrow, cols = _piece_protograph(ldpc_tpu.create_pbrl_qc_protograph)
        tnarrow, _ = _piece_protograph(lt.create_pbrl_qc_protograph)
        mp.setattr(ldpc_tpu, "create_pbrl_qc_protograph", jnarrow)
        mp.setattr(lt, "create_pbrl_qc_protograph", tnarrow)
        jmk, jpunct, _ = jax_pw._mk_setup()
        tmk, tpunct, _ = pw._mk_setup("cpu")
        assert tpunct == jpunct == tuple(range(LIFT))
        qp, vqp = pw._ladder("ref3pl")
        decs = {"rcq-dde": (tmk("rcq", pw._ladder("dde")[0]),
                            jmk("rcq", jax_pw._ladder("dde")[0])),
                "oms6": (tmk("oms", None), jmk("oms", None))}
        tdec = _rewired(tmk("orcq", qp, vqp=vqp, per_layer=True), full, cols)
        jdec = _rewired(jmk("orcq", qp, vqp=vqp, per_layer=True), full, cols)
        decs["wrcq-ref3pl"] = (
            tdec.replace_weights(carried),
            dataclasses.replace(jdec, weights={
                k: jnp.asarray(v) for k, v in carried.items()}))
        mask = np.ones(decs["oms6"][0].code.n, np.float32)
        mask[list(tpunct)] = 0.0
        for i, (name, (tdec, jdec)) in enumerate(decs.items()):
            assert jdec.qc_options["interpret"]
            llr = channel_llr(64, tdec.code.n, (5.0, 4.0, 4.0)[i],
                              seed=31 + i) * mask
            before = fused.LAYERED_LAUNCHES
            got = tdec(torch.from_numpy(llr))
            assert fused.LAYERED_LAUNCHES == before
            out[name] = (got, jdec(jnp.asarray(llr)), llr, tdec)
    return out


@pytest.mark.parametrize("arm", ["rcq-dde", "oms6", "wrcq-ref3pl"])
def test_plain_k1_equals_ldpc_tpus_kernel_on_the_precoded_piece(k1_runs,
                                                                arm):
    got, want, llr, tdec = k1_runs[arm]
    assert not llr[:, :LIFT].any() and np.signbit(llr[:, :LIFT]).any()
    ok = np.asarray(want.success)
    assert 0 < ok.sum() < 64
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    np.testing.assert_array_equal(got.success.numpy(), ok)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_allclose(got.posterior.numpy(),
                               np.asarray(want.posterior), rtol=1e-6,
                               atol=1e-5)
    if arm == "wrcq-ref3pl":
        spec = tdec.spec
        assert (spec.n_beta, spec.n_alpha) == (50, 225)
        assert tuple(tdec.weights["alpha"].shape) == (10, 225)
        # the piece's blocks read entries of both base rows
        assert len({int(i) // 2 for i in spec.beta_idx}) == 2


# -- the identities the programs rest on -------------------------------------

def _piece_decoders(kind_kw, T=10):
    """(port decoder through the fused wrapper, JAX general layered
    decoder) on the piece for each ``make_decoder`` keyword set."""
    base = _piece_protograph(lt.create_pbrl_qc_protograph)[0](
        k=1032, rate=1 / 3, precode=True)[0]
    out = []
    for kw in kind_kw:
        t = lt.make_decoder(lt.create_qc_code(base, lift=LIFT,
                                              max_iterations=T),
                            max_iterations=T, qc=lt.build_qc_graph(base, LIFT),
                            layered=True, device="cpu",
                            qc_options=dict(fused=True, dtype=torch.float32),
                            **kw)
        j = ldpc_tpu.make_decoder(ldpc_tpu.create_qc_code(
            base, lift=LIFT, max_iterations=T), max_iterations=T,
            layered=True, **kw)
        if kw["kind"] == "orcq":   # the design point
            t = t.replace_weights({k: torch.zeros_like(v)
                                   for k, v in t.weights.items()})
            j = dataclasses.replace(j, weights={
                k: jnp.zeros_like(v) for k, v in j.weights.items()})
        out.append((t, j))
    return out


def _both(pair, llr):
    t, j = pair
    got = t(torch.from_numpy(llr))
    H = j.code.H
    layers = np.arange(H.shape[0]).reshape(-1, LIFT)
    post = np.asarray(jax_layered(
        jnp.asarray(llr), j.weights, layers, graph=j.graph, spec=j.spec,
        max_iterations=j.max_iterations,
        return_trajectory=True).posteriors_all[-1])
    return got, post


IDENTITIES = {
    # train_matched.py:1-10: zero W-OMS-RCQ tables are the designed decoder
    "zero_tables_are_plain_rcq": (
        dict(kind="orcq", bc=4, bv=8, sharing_type=2,
             quantizer_params=pw._ladder("ref2")[0],
             v2c_quantizer_params=pw._ladder("ref2")[1]),
        dict(kind="rcq", bc=4, bv=8, quantizer_params=pw._ladder("ref2")[0],
             v2c_quantizer_params=pw._ladder("ref2")[1])),
    # the bv ladder is decode-neutral in the layered schedule
    "v2c_ladder_is_decode_neutral": (
        dict(kind="rcq", bc=4, bv=8, quantizer_params=ht.CN_REF3,
             v2c_quantizer_params=ht.VQP8),
        dict(kind="rcq", bc=4, bv=8, quantizer_params=ht.CN_REF3,
             v2c_quantizer_params=pw._ladder("ref3")[1])),
}


@pytest.mark.parametrize("name", list(IDENTITIES))
def test_identities_hold_on_k1s_plain_version_and_on_ldpc_tpu(name):
    """Both decoders of the identity on the same punctured LLRs (64
    frames at 5 dB): K1's plain versions equal in bits, success and
    iterations; ``ldpc_tpu``'s general layered engine (the base rows as
    layers) equal in its final hard decisions. With zero tables the
    posteriors are equal bit for bit too, in both packages; under another
    V2C ladder they are not: the posterior K1 and the engine store is the
    V2C quantizer's output (levels 3.1034 apart under the 182.6 reach),
    so only the decisions are neutral."""
    a, b = _piece_decoders(IDENTITIES[name])
    mask = np.ones(a[0].code.n, np.float32)
    mask[:LIFT] = 0.0
    llr = channel_llr(64, a[0].code.n, 5.0, seed=41) * mask
    (ga, ja), (gb, jb) = _both(a, llr), _both(b, llr)
    assert 0 < ga.success.sum() < 64
    for k in ("bits", "success", "iterations"):
        assert torch.equal(getattr(ga, k), getattr(gb, k)), k
    np.testing.assert_array_equal(ja < 0, jb < 0)
    same = name == "zero_tables_are_plain_rcq"
    assert torch.equal(ga.posterior.view(torch.int32),
                       gb.posterior.view(torch.int32)) == same
    assert np.array_equal(ja.view(np.int32), jb.view(np.int32)) == same


# -- one training step against ldpc_tpu's -------------------------------------

T_TR, B_TR = 5, 16
BASE_TR = make_base(2, 4, 4, seed=0)
# the distinct trained configurations: (make_decoder arguments, TrainingConfig)
# (the weight decay rides on the W-OMS-RCQ type 2 step, as ``worcq-wd``'s
# and ``wd``'s: one JAX compile less)
TRAIN_CONFIGS = {
    "orcq_t2_bv_none_weight_decay": (dict(kind="orcq", sharing_type=2),
                                     dict(learning_rate=2e-3,
                                          weight_decay=1e-3)),
    "wrcq_t2_bv_none": (dict(kind="wrcq", sharing_type=2),
                        dict(learning_rate=2e-3)),
    "orcq_t2_per_layer": (dict(kind="orcq", sharing_type=2, per_layer=True),
                          dict(learning_rate=3e-4)),
}


@pytest.mark.parametrize("name", list(TRAIN_CONFIGS))
def test_training_step_equals_ldpc_tpus(name):
    """One ``train_step`` of the port's trainer against ``ldpc_tpu``'s
    jitted step on the same batch (W-OMS-RCQ / W-RCQ on CN_REF3, bc=4,
    bv=None, layered, the first column's LLRs zero as the punctured
    bits'): loss, accuracy and gradient norm, and the updated tables, to
    the trainer parity tests' tolerances."""
    kw, cfg = TRAIN_CONFIGS[name]
    jdec, tdec = decoder_pair(BASE_TR, 4, T_TR, layered=True, bc=4,
                              bv=None, quantizer_params=ht.CN_REF3, **kw)
    cfg = dict(batch_size=B_TR, snr_range=(1.5, 3.5),
               punctured_positions=tuple(range(4)), **cfg)
    jtr = ldpc_tpu.PosteriorJointTrainer(jdec, ldpc_tpu.TrainingConfig(**cfg))
    ttr = lt.PosteriorJointTrainer(tdec, lt.TrainingConfig(**cfg))
    llr = channel_llr(B_TR, tdec.code.n, 1.5, seed=51)
    llr[:, :4] = 0.0
    zeros = np.zeros_like(llr)
    tr, _, *jstats = jtr._train_step(jtr._trainable(jdec.weights),
                                     jtr.opt_state, jnp.asarray(llr),
                                     jnp.asarray(zeros))
    stats = ttr.train_step(torch.from_numpy(llr), torch.from_numpy(zeros))
    loss, acc, gnorm = (float(s) for s in stats)
    np.testing.assert_allclose(loss, float(jstats[0]), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(acc, float(jstats[1]), rtol=1e-6)
    np.testing.assert_allclose(gnorm, float(jstats[2]), rtol=1e-4)
    assert gnorm > 0
    for k, v in tr.items():
        np.testing.assert_allclose(tdec.weights[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    if kw.get("per_layer"):
        assert tdec.recipe["per_layer"]
        assert (tdec.spec.n_beta, tdec.spec.n_alpha) == (
            jdec.spec.n_beta, jdec.spec.n_alpha)


# -- the phases with recorders ------------------------------------------------

def _fake_point(dec, snr, cfg):
    """A recorded point at the error target."""
    nf = max(cfg.min_frames, cfg.wave_size)
    return cfg.max_errors / nf, 1e-5, 5.0, nf, cfg.max_errors


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: {"sim": [(decoder, SNR, config)], "sweep": [(decoder,
    name, config, checkpoint)], "train": [...], "saved": [...], "out":
    {...}}, plus each package's working directory}: the programs'
    phases with recorders."""
    rec = {}

    def single(decoder, snr_db, config, *args, **kw):
        rec["sim"].append((decoder, snr_db, config))
        return _fake_point(decoder, snr_db, config)

    class Trainer:
        def __init__(self, decoder, config=None):
            rec["train"].append(dict(decoder=decoder, config=config))

        def train(self, num_samples=3200, val_samples=640, verbose=True):
            rec["train"][-1]["num_samples"] = num_samples
            return {"training_losses": [0.25], "training_accuracies": [0.5]}

    def simulators(result_cls):
        class Simulator:
            def __init__(self, config=None):
                self.config = config

            def simulate_decoder(self, decoder, decoder_name=None,
                                 verbose=True, checkpoint=None):
                rec["sweep"].append((decoder, decoder_name, self.config,
                                     checkpoint))
                r = result_cls(decoder_name, [
                    float(s) for s in self.config.snr_points()])
                for i in range(len(r.snr_values)):
                    r.add_result(i, 0.5, 0.1, 1.0, 0.0, 2, 1)
                return r
        return Simulator

    root = tmp_path_factory.mktemp("runs")
    jdir = _jax_dir(str(root / "jax"), checkpoints=True)
    tdir = str(root / "torch")
    os.makedirs(tdir)
    out = {pkg: {"sim": [], "sweep": [], "train": [], "saved": [],
                 "out": {}} for pkg in ("jax", "torch")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ldpc_tpu.sim, "simulate_single_snr", single)
        mp.setattr(lt, "simulate_single_snr", single)
        mp.setattr(ldpc_tpu.sim, "LDPCSimulator",
                   simulators(JaxSimulationResult))
        mp.setattr(lt, "LDPCSimulator", simulators(SimulationResult))
        mp.setattr(ldpc_tpu.train, "PosteriorJointTrainer", Trainer)
        mp.setattr(lt, "PosteriorJointTrainer", Trainer)
        mp.setattr(ldpc_tpu.utils.checkpoint, "save_checkpoint",
                   lambda path, tree: rec["saved"].append((path, tree)))
        mp.setattr(ldpc_tpu.utils.checkpoint, "load_checkpoint", _carried)
        mp.setattr("logging.basicConfig", lambda **kw: None)
        rec.update(out["jax"])
        mp.chdir(jdir)
        o = out["jax"]["out"]
        o["dev"] = jax_pw.dev_fer(out_path="dev.json", verbose=False)
        o["deep"] = jax_pw.deep_fer(("wrcq-ref3", "rcq-ref3", "oms6"),
                                    out_path="deep.json", verbose=False)
        o["train_arms"] = jax_pw.train_arms(
            verbose=False, tags=("hand", "dde", "ref3", "ref3pl"))
        o["tm"] = [jax_tm.train_arm(n, s, verbose=False)
                   for n, s in jax_tm.ARMS.items()]
        o["ht"] = [jax_ht.train_arm(n, s, verbose=False)
                   for n, s in jax_ht.ARMS.items()]
        with open(jax_ht.OUT, "w") as f:
            json.dump({"oms6": {"2.0": {"fer": 0.5}}}, f)
        o["tm_dev"] = jax_tm.dev(tuple(jax_tm.ARMS), verbose=False)
        o["ht_dev"] = jax_ht.dev(tuple(jax_ht.ARMS), verbose=False)
        rec.update(out["torch"])
        mp.chdir(tdir)
        o = out["torch"]["out"]
        o["dev"] = pw.dev_fer(out_path="dev.json", verbose=False,
                              device="cpu")
        o["deep"] = pw.deep_fer(("wrcq-ref3", "rcq-ref3", "oms6"),
                                out_path="deep.json", verbose=False,
                                device="cpu")
        o["train_arms"] = pw.train_arms(
            verbose=False, tags=("hand", "dde", "ref3", "ref3pl"),
            device="cpu")
        o["tm"] = [tm.train_arm(n, s, verbose=False, device="cpu")
                   for n, s in tm.ARMS.items()]
        o["ht"] = [ht.train_arm(n, s, verbose=False, device="cpu")
                   for n, s in ht.ARMS.items()]
        # the carried tables (train_arms left its own in pw.CK_DIR)
        pw.install_tables("carried")
        for mod, names in ((tm, tm.ARMS), (ht, ht.ARMS)):
            for n in names:
                shutil.rmtree(os.path.join(mod.CK_DIR, n))
                save_checkpoint(os.path.join(mod.CK_DIR, n), load_checkpoint(
                    os.path.join("carried", "orcq_ref3pl" if
                                 n.endswith("pl") else "orcq_ref2")))
        with open(ht.OUT, "w") as f:
            json.dump({"oms6": {"2.0": {"fer": 0.5}}}, f)
        o["tm_dev"] = tm.dev(tuple(tm.ARMS), verbose=False, device="cpu")
        o["ht_dev"] = ht.dev(tuple(ht.ARMS), verbose=False, device="cpu")
    return out, jdir, tdir


def test_simulations_equal_the_jax_programs(runs):
    """Every ``simulate_single_snr`` call of ``dev_fer`` (the default
    arms: rcq-hand, oms6, rcq-dde, rcq-ref3 and the four trained ones),
    ``train_matched.dev`` and ``pbrl_honest_train.dev`` (resumed past the
    ``oms6`` its file holds; budget 8192) in the programs' order: the
    SNR, each ``SimulationConfig`` field and each decoder; every sweep of
    ``deep_fer`` with its resumable file."""
    out, _, _ = runs
    jsim, tsim = out["jax"]["sim"], out["torch"]["sim"]
    assert len(tsim) == len(jsim) == 8 * 2 + 5 + 6 * 2
    for (tdec, tsnr, tcfg), (jdec, jsnr, jcfg) in zip(tsim, jsim):
        assert tsnr == jsnr
        assert_same_config(tcfg, jcfg)
        assert tcfg.device == "cpu"
        assert tcfg.punctured_positions == tuple(range(86))
        assert_same_decoder(tdec, _strip(jdec))
    assert [c.survivor_budget for _, _, c in tsim] == [4096] * 21 + [8192] * 12
    assert list(out["torch"]["out"]["dev"]) == [
        "rcq-hand", "oms6", "rcq-dde", "rcq-ref3", "wrcq-hand", "wrcq-dde",
        "wrcq-ref3", "wrcq-ref3pl"]
    for key in ("dev", "tm_dev", "ht_dev"):
        assert out["torch"]["out"][key] == out["jax"]["out"][key]
    jsw, tsw = out["jax"]["sweep"], out["torch"]["sweep"]
    assert len(tsw) == len(jsw) == 3
    for (tdec, tname, tcfg, tck), (jdec, jname, jcfg, jck) in zip(tsw, jsw):
        assert tname == jname
        assert_same_config(tcfg, jcfg)
        assert_same_decoder(tdec, _strip(jdec))
        assert tck == jck.replace("experiments/pbrl_wrcq_ck",
                                  pw.CK_DIR)
    assert out["torch"]["out"]["deep"] == out["jax"]["out"]["deep"]


def test_trainings_equal_the_jax_programs(runs):
    """Every trainer the three programs make (``train_arms`` on hand, dde,
    ref3 and ref3pl, a missing ladder skipped; the four and five arms):
    the decoder (spec, sharing, ``per_layer``, bv=None for the honest
    arms, zero tables for ``zinit`` and ``worcq-low``), every
    ``TrainingConfig`` field (batch 128, cosine with 8 warm-up updates
    and 480 decay steps, 1.5-3.5 dB, the 86 punctured bits, the arm's
    learning rate and weight decay), 2048 frames an epoch; the checkpoint
    names under the twins' own directories."""
    out, jdir, tdir = runs
    jt, tt = out["jax"]["train"], out["torch"]["train"]
    assert len(tt) == len(jt) == 4 + 4 + 5
    for t, j in zip(tt, jt):
        assert dataclasses.asdict(t["config"]) == dataclasses.asdict(
            j["config"])
        assert t["num_samples"] == j["num_samples"] == 2048
        zero = all(not np.asarray(v).any() for v in j["decoder"].weights
                   .values() if v is not None)
        assert_same_decoder(t["decoder"], _strip(j["decoder"]),
                            weights=zero)
        assert t["config"].decay_steps == 480
    assert [t["config"].weight_decay for t in tt[4:]] == [
        0, 0, 0, 1e-3, 0, 0, 1e-3, 0, 0]
    assert tt[3]["decoder"].recipe["per_layer"]
    assert tt[-1]["decoder"].recipe["per_layer"]
    assert all(t["decoder"].spec.v2c_qparams is None for t in tt[8:])
    names = [os.path.relpath(p, "experiments") for p, _ in
             out["jax"]["saved"]]
    assert names == ([f"pbrl_wrcq_ck/orcq_{t}" for t in
                      ("hand", "dde", "ref3", "ref3pl")] +
                     [f"train_matched_ck/{n}" for n in tm.ARMS] +
                     [f"pbrl_honest_train_ck/{n}" for n in ht.ARMS])
    for (name, (_, tree)) in zip(
            [f"{pw.CK_DIR}/orcq_{t}" for t in ("hand", "dde", "ref3",
                                              "ref3pl")] +
            [f"{tm.CK_DIR}/{n}" for n in tm.ARMS] +
            [f"{ht.CK_DIR}/{n}" for n in ht.ARMS], out["jax"]["saved"]):
        got = load_checkpoint(os.path.join(tdir, name))
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: np.shape(v) for k, v in tree.items()}
    for key in ("train_arms", "tm", "ht"):
        assert out["torch"]["out"][key] == out["jax"]["out"][key]
    with open(os.path.join(tdir, pw.CK_DIR, "train_hist.json")) as f:
        twin = json.load(f)
    with open(os.path.join(jdir, jax_pw.CK_DIR, "train_hist.json")) as f:
        assert twin == json.load(f)


# -- the command lines --------------------------------------------------------

def _jax_main_calls(mod, argv, phases, cwd, monkeypatch):
    """The calls of ``mod``'s ``__main__`` block to ``phases`` (recorded,
    not run) under ``argv`` in the working directory ``cwd``."""
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    block = [n for n in tree.body if isinstance(n, ast.If) and
             "__main__" in ast.unparse(n.test)][0]
    calls = []
    g = dict(vars(mod))
    for name in phases:
        g[name] = (lambda n: lambda *a, **kw: calls.append((n, a, kw)))(name)
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    exec(compile(ast.Module(body=block.body, type_ignores=[]),
                 mod.__file__, "exec"), g)
    return calls


def _twin_main_calls(mod, argv, phases, cwd, monkeypatch):
    """The twin's ``main(argv)`` calls to ``phases``, recorded, with the
    arguments only twins take (``device``, ``design_dir``) left out."""
    calls = []

    def recorder(name):
        return lambda *a, **kw: calls.append((name, a, {
            k: v for k, v in kw.items()
            if k not in ("device", "design_dir")}))

    for name in phases:
        monkeypatch.setattr(mod, name, recorder(name))
    monkeypatch.chdir(cwd)
    mod.main(argv)
    return calls


MAIN_CASES = {
    "pbrl_wrcq_all": (jax_pw, pw, [], ("design_ladder", "train_arms",
                                       "dev_fer", "deep_fer")),
    "pbrl_wrcq_deep": (jax_pw, pw, ["--phase", "deep", "--frames", "1000",
                                    "--deep-arms", "oms6", "rcq-ref4"],
                       ("design_ladder", "train_arms", "dev_fer",
                        "deep_fer")),
    "pbrl_wrcq_train": (jax_pw, pw, ["--phase", "train", "--epochs", "3",
                                     "--train-tags", "ref2pl"],
                        ("design_ladder", "train_arms", "dev_fer",
                         "deep_fer")),
    "pbrl_wrcq_design": (jax_pw, pw, ["--phase", "design", "--design-snr",
                                      "2.2"],
                         ("design_ladder", "train_arms", "dev_fer",
                          "deep_fer")),
    "train_matched": (jax_tm, tm, ["--errors", "50", "--arms", "base", "wd"],
                      ("train_arm", "dev")),
    "train_matched_skip": (jax_tm, tm, ["--skip-train"],
                           ("train_arm", "dev")),
    "pbrl_honest_train": (jax_ht, ht, ["--epochs", "2"],
                          ("train_arm", "dev")),
}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_calls_the_programs_phases(case, tmp_path, monkeypatch):
    """Each twin's ``main`` calls its phases as the program's ``__main__``
    block does, with the same arguments; an arm's checkpoint found in the
    working directory skips its training in both (``base`` and
    ``worcq``). The JAX program in a directory without its design designs
    the ladder, as the twin does with ``--design-dir`` naming a directory
    without its own; the JAX program that sees the committed design skips
    it, as the twin does without ``--design-dir`` (it reads the committed
    design) and with a design in ``--design-dir``."""
    jmod, tmod, argv, phases = MAIN_CASES[case]
    monkeypatch.setattr(ldpc_tpu.utils.cache, "enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    os.makedirs(jdir / "experiments")
    os.makedirs(tdir)
    if jmod is jax_tm:
        os.makedirs(jdir / jax_tm.CK_DIR / "base")
        os.makedirs(tdir / tm.CK_DIR / "base")
    if jmod is jax_ht:
        os.makedirs(jdir / jax_ht.CK_DIR / "worcq")
        os.makedirs(tdir / ht.CK_DIR / "worcq")
    own = ["--design-dir", "."] if jmod is jax_pw else []
    want = _jax_main_calls(jmod, argv, phases, jdir, monkeypatch)
    got = _twin_main_calls(tmod, argv + own + ["--device", "cpu"], phases,
                           tdir, monkeypatch)
    assert got == want and want
    if jmod is jax_pw:
        # the JAX program sees the committed design: no design in either
        shutil.copy(os.path.join(EXP, "pbrl_wrcq_design.json"),
                    jdir / "experiments")
        want = _jax_main_calls(jmod, argv, phases, jdir, monkeypatch)
        assert "design_ladder" not in [c[0] for c in want]
        got = _twin_main_calls(tmod, argv, phases, tdir, monkeypatch)
        assert got == want
        shutil.copy(os.path.join(EXP, "pbrl_wrcq_design.json"),
                    tdir / pw.DESIGN_PATH)
        got = _twin_main_calls(tmod, argv + own, phases, tdir, monkeypatch)
        assert got == want


@pytest.mark.parametrize("call", [
    lambda: pw.main(["--phase", "dev"]),
    lambda: tm.main(["--skip-train"]),
    lambda: ht.main(["--skip-train"])],
    ids=["pbrl_wrcq", "train_matched", "pbrl_honest_train"])
def test_twin_needs_a_card_unless_told_cpu(call, tmp_path, monkeypatch):
    """Each twin runs on the card by default: without one it raises
    before it decodes."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    with pytest.raises(RuntimeError, match="CUDA card"):
        call()


def test_outputs_stay_out_of_experiments():
    for path in (pw.DESIGN_PATH, pw.CK_DIR, pw.DEV_OUT, pw.DEEP_OUT,
                 tm.CK_DIR, tm.OUT, ht.CK_DIR, ht.OUT):
        assert os.path.dirname(path) == "" and "torch" in path
    for path in (pw.DESIGN_RECORD, pw.DESIGN3_RECORD):
        assert os.path.dirname(path) == EXP and os.path.exists(path)
    assert os.path.dirname(pw.TABLES) == os.path.dirname(pw.__file__)
