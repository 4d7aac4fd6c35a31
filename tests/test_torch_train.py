"""The port's training slice against ``ldpc_tpu``'s: the straight-through
quantizers and the rest of ``quantizer.py``, the trainer's steps, the
gradient analyzer's per-sample norms, trainer checkpoints and the
training route of a fused or option-carrying decoder.

Tolerances:

- the quantizers, forward and backward: bit for bit (eager JAX rounds as
  IEEE; subnormal inputs are left out, XLA:CPU flushes them);
- a trainer step: the loss rtol 2e-5 / atol 1e-6 and the accuracy rtol
  1e-6 (as ``torch_port_helpers.assert_training_match``), the gradient
  norm rtol 1e-4 (the gradients' tolerance), the weights after the step
  rtol 1e-6 / atol 1e-6: an Adam update is the learning rate times a
  ratio of moments that the gradients' rounding moves by ~1e-4 of itself;
- per-sample gradient norms: rtol 1e-4 against JAX, rtol 1e-5 between
  ``torch.func.vmap`` and a loop over frames;
- a checkpoint resume, the fused decoders' training route: bit for bit.
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

import ldpc_tpu
import ldpc_tpu_torch as lt
from ldpc_tpu import quantizer as jq
from ldpc_tpu_torch import quantizer as tq
from ldpc_tpu_torch.utils import (load_trainer_checkpoint,
                                  save_trainer_checkpoint)
from torch_port_helpers import (one_torch_thread,  # noqa: F401 (autouse)
                                TRAIN_KINDS, channel_llr, decoder_pair,
                                general_route_pair, make_base)

B, SNR = 16, 1.5


def _bits_equal(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _inputs(thr, C, seed, n=100_000):
    """N(0, (1.5 C)^2) inputs plus knife edges: the thresholds and one ulp
    either side (both signs), +-0.0, +-C and beyond, the 1e-30 floor."""
    rng = np.random.default_rng(seed)
    pos = thr[1:]
    return np.concatenate([
        rng.normal(0, 1.5 * C, n), thr, -thr,
        np.nextafter(pos, np.inf), np.nextafter(pos, -np.inf),
        -np.nextafter(pos, np.inf), -np.nextafter(pos, -np.inf),
        [0.0, -0.0, C, -C, 1.5 * C, -1.5 * C, 1e-9, -1e-9, 1e-30, -1e-30],
    ]).astype(np.float32)


# (name, port STE, JAX STE, port qdq, thresholds): bc=3 staircase with
# the trap's ladder, the bv=8 uniform V2C ladder, a bv=8 power law
STES = {
    "staircase_bc3": (
        lambda x, p: tq.staircase_qdq_ste(x, torch.from_numpy(p[0])),
        lambda x, p: jq.staircase_qdq_ste(x, jnp.asarray(p[0])),
        lambda x, p: tq.staircase_qdq(x, torch.from_numpy(p[0])),
        (jq.power_thresholds(3, 2.0, 1.3),)),
    "uniform_bv8": (
        lambda x, p: tq.uniform_qdq_ste(x, torch.tensor(p[1]), 128),
        lambda x, p: jq.uniform_qdq_ste(x, np.float32(p[1]), 128),
        lambda x, p: tq.uniform_qdq(x, torch.tensor(p[1]), 128),
        (jq.power_thresholds(8, 4.0, 1.0), 4.0)),
    "power_bv8": (
        lambda x, p: tq.power_qdq_ste(x, torch.tensor(p[1]),
                                      torch.tensor(p[2]), 128),
        lambda x, p: jq.power_qdq_ste(x, np.float32(p[1]),
                                      np.float32(p[2]), 128),
        lambda x, p: tq.power_qdq(x, torch.tensor(p[1]),
                                  torch.tensor(p[2]), 128),
        (jq.power_thresholds(8, 6.0, 1.3), 6.0, 1.3)),
    "qdq_lut_bc3": (
        lambda x, p: tq.qdq_ste(x, torch.from_numpy(p[0])),
        lambda x, p: jq.qdq_ste(x, jnp.asarray(p[0])),
        lambda x, p: tq.quantize_dequantize(x, torch.from_numpy(p[0])),
        (jq.power_thresholds(3, 5.0, 1.3),)),
}


@pytest.mark.parametrize("name", list(STES))
def test_ste_forward_bit_exact_with_its_zeros(name):
    """The STE forward is JAX's ``clipped + (qdq(x) - clipped)``: where
    qdq gives the +-1e-30 floor it is an exact 0.0, as in JAX."""
    f, jf, qdq, p = STES[name]
    C = float(p[0][-1])
    x = _inputs(p[0], C, seed=len(name))
    got = f(torch.from_numpy(x), p)
    _bits_equal(got, jf(jnp.asarray(x), p))
    q = qdq(torch.from_numpy(x), p)
    zeros = (got == 0) & (q.abs() == tq.QDQ_SIGN_TINY)
    assert int(zeros.sum()) > 0 and not torch.equal(got, q)


@pytest.mark.parametrize("name", list(STES))
def test_ste_backward_equals_jax_grad(name):
    """The identity clipped to [-C, C]: 1 inside (and at +-0), 1/2 at
    +-C (``jnp.clip``'s tie rule), 0 beyond; bit for bit."""
    f, jf, _, p = STES[name]
    C = np.float32(p[0][-1])
    x = np.concatenate([[C, -C, 1.5 * C, -1.5 * C, 0.5 * C, -0.3 * C, 0.0,
                         -0.0], _inputs(p[0], C, seed=1, n=2000)]
                       ).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(f(xt, p).sum(), xt)
    jg = jax.grad(lambda v: jnp.sum(jf(v, p)))(jnp.asarray(x))
    _bits_equal(g, jg)
    np.testing.assert_array_equal(g[:8].numpy(), [0.5, 0.5, 0, 0, 1, 1, 1,
                                                  1])


@pytest.mark.parametrize("bc,C,gamma", [(3, 5.0, 1.3), (4, 7.0, 1.5),
                                        (8, 10.0, 1.0)])
def test_quantize_dequantize_and_class_bit_exact(bc, C, gamma):
    thr = jq.power_thresholds(bc, C, gamma)
    x = _inputs(thr, C, seed=bc, n=4000)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    code = tq.quantize(xt, thr)
    jcode = jq.quantize(xj, jnp.asarray(thr))
    assert code.dtype == torch.int32
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    _bits_equal(tq.dequantize(code, thr), jq.dequantize(jcode,
                                                        jnp.asarray(thr)))
    _bits_equal(tq.quantize_dequantize(xt, thr),
                jq.quantize_dequantize(xj, jnp.asarray(thr)))
    q, jqz = tq.NonUniformQuantizer(bc, C, gamma), jq.NonUniformQuantizer(
        bc, C, gamma)
    assert (q.bc, q.C, q.gamma) == (jqz.bc, jqz.C, jqz.gamma)
    np.testing.assert_array_equal(q.thresholds, jqz.thresholds)
    np.testing.assert_array_equal(q.quantize(xt).numpy(),
                                  np.asarray(jqz.quantize(xj)))
    _bits_equal(q.dequantize(code), jqz.dequantize(jcode))
    _bits_equal(q(xt), jqz(xj))
    # per-element LUT rows [N, L] (the compare-count path)
    rows = np.stack([thr, 2 * thr])[np.arange(x.size) % 2]
    _bits_equal(tq.quantize_dequantize(xt, rows),
                jq.quantize_dequantize(xj, jnp.asarray(rows)))
    np.testing.assert_array_equal(tq.quantize(xt, rows).numpy(),
                                  np.asarray(jq.quantize(xj,
                                                         jnp.asarray(rows))))


# -- the trainer against ldpc_tpu's jitted step -------------------------------

CONFIGS = {
    "plain": dict(),
    "clip": dict(use_gradient_clipping=True, clip_threshold=1e-3),
    "weight_decay": dict(weight_decay=0.05),
    "cosine_warmup": dict(lr_schedule="cosine", warmup_steps=1,
                          decay_steps=4),
}


@functools.lru_cache(maxsize=None)
def _trainer_runs(config):
    """Three steps of each package's trainer on the same three batches
    (W-RCQ, sharing type 2, on the PEG code, B=16): per step (loss,
    accuracy, gradient norm, weights) as numpy."""
    cfg = dict(batch_size=B, learning_rate=2e-3, snr_range=(1.0, 2.0),
               **CONFIGS[config])
    jdec, tdec = general_route_pair("flooding", "wrcq_t2")
    jtr = ldpc_tpu.PosteriorJointTrainer(jdec, ldpc_tpu.TrainingConfig(**cfg))
    ttr = lt.PosteriorJointTrainer(tdec, lt.TrainingConfig(**cfg))
    tr, state = jtr._trainable(jdec.weights), jtr.opt_state
    runs = {"jax": [], "torch": []}
    for i in range(3):
        llr = channel_llr(B, tdec.code.n, SNR, seed=20 + i)
        zeros = np.zeros_like(llr)
        tr, state, *stats = jtr._train_step(tr, state, jnp.asarray(llr),
                                            jnp.asarray(zeros))
        runs["jax"].append([float(s) for s in stats] + [
            {k: np.asarray(v) for k, v in tr.items()}])
        stats = ttr.train_step(torch.from_numpy(llr), torch.from_numpy(zeros))
        runs["torch"].append([float(s) for s in stats] + [
            {k: v.numpy() for k, v in tdec.weights.items() if v is not None}])
    return runs


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_trainer_steps_match_jax(config, steps):
    runs = _trainer_runs(config)
    for (loss, acc, gnorm, w), (jl, ja, jg, jw) in zip(
            runs["torch"][:steps], runs["jax"][:steps]):
        np.testing.assert_allclose(loss, jl, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(acc, ja, rtol=1e-6)
        np.testing.assert_allclose(gnorm, jg, rtol=1e-4)
        assert w.keys() == jw.keys()
        for k in w:
            np.testing.assert_allclose(w[k], jw[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    if config == "cosine_warmup":  # the first update has learning rate 0
        w0 = runs["torch"][0][3]
        _, tdec = general_route_pair("flooding", "wrcq_t2")
        for k in w0:
            assert np.array_equal(w0[k], tdec.weights[k].numpy())


def test_trainer_end_to_end_and_its_api(tmp_path):
    """train() on sampled batches: history, validation, early stop,
    detached float32 weights, the data generator and puncturing, and the
    plots (matplotlib is needed for those only)."""
    code = lt.create_test_ldpc_code()
    dec = lt.neural_min_sum(code, max_iterations=5, device="cpu")
    cfg = lt.TrainingConfig(batch_size=32, num_epochs=3, learning_rate=5e-3,
                            snr_range=(1.0, 5.0), early_stop_accuracy=2.0,
                            punctured_positions=(0, 3), seed=0)
    tr = lt.PosteriorJointTrainer(dec, cfg)
    w0 = dec.weights["beta"].clone()
    hist = tr.train(num_samples=64, val_samples=32, verbose=False)
    assert len(hist["training_losses"]) == 3 == len(hist["gradient_norms"])
    assert len(hist["validation_losses"]) == 3 and tr.step_count == 6
    beta = dec.weights["beta"]
    assert beta.dtype == torch.float32 and not beta.requires_grad
    assert not torch.equal(beta, w0)
    llr, tgt = tr.generate_training_data(10)
    assert llr.shape == (10, 7) and torch.all(llr[:, [0, 3]] == 0)
    assert torch.all(tgt == 0)
    x, _ = tr.sample()
    assert x.shape == (32, 7) and torch.all(x[:, [0, 3]] == 0)
    loss, acc = tr.validate()
    assert np.isfinite(loss) and 0 <= acc <= 1
    assert np.isfinite(tr.compute_loss(llr[0], tgt[0]))
    # the early stop halts after the first epoch
    stop = lt.PosteriorJointTrainer(dec, dataclasses.replace(
        cfg, early_stop_accuracy=0.0))
    assert len(stop.train(num_samples=32, verbose=False)
               ["training_losses"]) == 1
    assert os.path.exists(tr.plot_training_history(
        str(tmp_path / "h.png")))
    an = lt.GradientExplosionAnalyzer(dec)
    res = an.analyze(num_samples=4, snr_db=2.0)
    assert os.path.exists(an.plot_gradient_analysis(
        res, str(tmp_path / "g.png")))


def test_trainer_refusals():
    code = lt.create_test_ldpc_code()
    with pytest.raises(ValueError, match="no trainable weights"):
        lt.PosteriorJointTrainer(lt.basic_min_sum(code, device="cpu"))
    dec = lt.neural_min_sum(code, device="cpu")
    with pytest.raises(ValueError, match="decay_steps"):
        lt.PosteriorJointTrainer(dec, lt.TrainingConfig(lr_schedule="cosine"))
    with pytest.raises(ValueError, match="lr_schedule"):
        lt.PosteriorJointTrainer(dec, lt.TrainingConfig(lr_schedule="nope"))
    # a mesh (parallel/) must hold the decoder's kind of device and divide
    # the batch; a one-rank mesh trains
    from ldpc_tpu_torch.parallel import Mesh, make_mesh
    with pytest.raises(ValueError, match="batch_size"):
        lt.PosteriorJointTrainer(dec, mesh=Mesh(3, 0, torch.device("cpu")))
    assert lt.PosteriorJointTrainer(
        dec, mesh=make_mesh(devices="cpu")).mesh.size == 1
    with pytest.raises(ValueError, match="no trainable weights"):
        lt.GradientExplosionAnalyzer(lt.basic_min_sum(code, device="cpu"))


# -- the gradient analyzer ---------------------------------------------------


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "final"])
def test_per_sample_norms_match_jax(joint):
    jdec, tdec = general_route_pair("flooding", "orcq_t2_bv8")
    llr = channel_llr(8, tdec.code.n, SNR, seed=30)
    got = lt.GradientExplosionAnalyzer(tdec)._per_sample_norms(
        torch.from_numpy(llr), joint)
    want = ldpc_tpu.GradientExplosionAnalyzer(jdec)._per_sample_norms(
        jnp.asarray(llr), joint)
    assert got.shape == (8,) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _loop_norms(dec, llr, joint):
    """Per-frame gradient norms with one backward() per frame."""
    out = []
    for one in llr:
        w = {k: (None if v is None else v.clone().requires_grad_(True))
             for k, v in dec.weights.items()}
        loss, _ = lt.posterior_joint_loss(w, one[None],
                                          torch.zeros_like(one)[None],
                                          decoder=dec, joint=joint)
        gs = torch.autograd.grad(loss, [v for v in w.values()
                                        if v is not None])
        out.append(float(torch.sqrt(sum((g ** 2).sum() for g in gs))))
    return np.array(out)


@pytest.mark.parametrize("route", ["qc_flooding", "qc_layered", "flooding",
                                   "layered", "bucketed", "bucketed_ce2"])
def test_vmap_norms_equal_a_loop_on_every_route(route):
    """``torch.func.vmap`` of ``torch.func.grad`` runs through every
    engine (no in-place write of a batched value) and gives the loop's
    norms."""
    kind = TRAIN_KINDS["orcq_t2_bv8"]
    if route.startswith("qc_"):
        _, dec = decoder_pair(make_base(2, 4, 4, seed=0), 4, 5,
                              layered=route == "qc_layered", **kind)
    else:
        _, dec = general_route_pair(route, "orcq_t2_bv8",
                                    4 if route == "bucketed_ce2" else 5)
    llr = torch.from_numpy(channel_llr(6, dec.code.n, SNR, seed=31))
    an = lt.GradientExplosionAnalyzer(dec)
    for joint in (True, False):
        np.testing.assert_allclose(an._per_sample_norms(llr, joint),
                                   _loop_norms(dec, llr, joint), rtol=1e-5)
    res = an.analyze(num_samples=6, snr_db=SNR, seed=1)
    assert set(res) == {"posterior_joint", "final_only"}
    for st in res.values():
        assert set(st) == {"mean", "std", "max", "min", "p99", "norms"}
        assert len(st["norms"]) == 6 and np.all(np.isfinite(st["norms"]))


# -- checkpoints --------------------------------------------------------------


def _ckpt_trainer(T=5, **cfg):
    _, dec = general_route_pair("flooding", "orcq_t2_bv8", T)
    return lt.PosteriorJointTrainer(dec, lt.TrainingConfig(
        batch_size=B, learning_rate=2e-3, **cfg))


def _batch(i, n):
    llr = torch.from_numpy(channel_llr(B, n, SNR, seed=40 + i))
    return llr, torch.zeros_like(llr)


def test_checkpoint_resume_is_bit_exact(tmp_path):
    cfg = dict(lr_schedule="cosine", warmup_steps=1, decay_steps=5,
               weight_decay=0.01)
    ref = _ckpt_trainer(**cfg)
    n = ref.decoder.code.n
    ref_stats = [ref.train_step(*_batch(i, n)) for i in range(3)]
    first = _ckpt_trainer(**cfg)
    for i in range(2):
        first.train_step(*_batch(i, n))
    first.training_losses = [0.5, 0.25]
    path = save_trainer_checkpoint(str(tmp_path / "ck"), first, epoch=2)
    assert json.load(open(os.path.join(path, "history.json")))[
        "training_losses"] == [0.5, 0.25]
    resumed = _ckpt_trainer(**cfg)
    assert load_trainer_checkpoint(path, resumed) == 2
    assert resumed.training_losses == [0.5, 0.25]
    assert resumed.step_count == 2
    stats = resumed.train_step(*_batch(2, n))
    for a, b in zip(stats, ref_stats[2]):
        assert torch.equal(a, b)
    for k, w in ref.decoder.weights.items():
        assert torch.equal(resumed.decoder.weights[k], w)


def test_checkpoint_refuses_a_mismatch(tmp_path):
    tr = _ckpt_trainer()
    tr.train_step(*_batch(0, tr.decoder.code.n))
    path = save_trainer_checkpoint(str(tmp_path / "ck"), tr, epoch=1)
    for other in (_ckpt_trainer(T=4),                     # weight shapes
                  _ckpt_trainer(use_gradient_clipping=True),  # optimizer
                  _ckpt_trainer(weight_decay=0.1)):
        before = {k: v.clone() for k, v in other.decoder.weights.items()}
        with pytest.raises(ValueError, match="refusing"):
            load_trainer_checkpoint(path, other)
        for k, v in before.items():
            assert torch.equal(other.decoder.weights[k], v)
    _, nnms = general_route_pair("flooding", "nnms_t0")     # weight names
    with pytest.raises(ValueError, match="refusing"):
        load_trainer_checkpoint(path, lt.PosteriorJointTrainer(nnms))


# -- the training route of decoders with inference options -----------------


@pytest.mark.parametrize("layered", [False, True],
                         ids=["flooding", "layered"])
def test_fused_decoder_trains_on_its_engine(layered):
    """A fused decoder's training call returns the engine's result (the
    kernels are inference-only): f32, every iteration checked, the full
    result; its inference call still takes the fused route."""
    base = make_base(2, 4, 4, seed=0)
    _, eng = decoder_pair(base, 4, 5, layered=layered,
                          **TRAIN_KINDS["orcq_t2_bv8"])
    fused = dataclasses.replace(eng, qc_options=dict(
        fused=True, dtype=torch.bfloat16, lean=True))
    x = torch.from_numpy(channel_llr(B, eng.code.n, SNR, seed=50))
    for kw in (dict(ste=True), dict(return_trajectory=True),
               dict(ste=True, return_trajectory=True)):
        got, want = fused(x, **kw), eng(x, **kw)
        for f in ("bits", "posterior", "iterations", "success"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        if "return_trajectory" in kw:
            assert torch.equal(got.posteriors_all, want.posteriors_all)
    assert fused(x).bits.dtype == torch.int8  # lean: the fused path
    one = fused(x[3], ste=True, return_trajectory=True)
    assert one.posteriors_all.shape == (5, eng.code.n)
    assert torch.equal(one.posteriors_all, want.posteriors_all[:, 3])


def test_bucketed_training_keeps_check_every_and_drops_dtype():
    _, dec = general_route_pair("bucketed_ce2", "orcq_t2_bv8", 4)
    bf16 = dataclasses.replace(dec, qc_options=dict(dtype=torch.bfloat16,
                                                    check_every=2))
    x = torch.from_numpy(channel_llr(B, dec.code.n, SNR, seed=51))
    got, want = bf16(x, ste=True), dec(x, ste=True)
    assert torch.equal(got.posterior, want.posterior)
    assert torch.equal(got.iterations, want.iterations)
    assert set(got.iterations.tolist()) <= {2, 4}


def test_fused_weights_after_training_feed_the_kernel_path():
    """After a step the trainer leaves detached float32 weights that the
    fused decoder (its plain version on the CPU) decodes with."""
    base = make_base(2, 4, 4, seed=0)
    _, eng = decoder_pair(base, 4, 5, **TRAIN_KINDS["orcq_t2_bv8"])
    fused = dataclasses.replace(eng, qc_options=dict(fused=True,
                                                     dtype=torch.float32))
    tr = lt.PosteriorJointTrainer(fused, lt.TrainingConfig(batch_size=B))
    x = torch.from_numpy(channel_llr(B, eng.code.n, SNR, seed=52))
    tr.train_step(x, torch.zeros_like(x))
    assert not any(w.requires_grad for w in fused.weights.values())
    out = fused(x)
    ref = lt.qc_fused_decode_batch(x, fused.weights, qc=fused.qc,
                                   spec=fused.spec, max_iterations=5,
                                   dtype=torch.float32)
    assert torch.equal(out.bits, ref.bits)


# -- the optax chain's links ------------------------------------------------


@pytest.mark.parametrize("scale", [1e-6, 5e-4, 1e-3, 2e-3, 1.0])
def test_clip_by_global_norm_is_optax(scale):
    """Scaled by max / norm only where norm >= max (max = 1e-3, the
    default threshold); no ``+ 1e-6`` in the divisor. rtol 1e-6: the
    norm's sum runs in another order."""
    import optax
    from ldpc_tpu_torch.train.trainer import clip_by_global_norm, global_norm
    rng = np.random.default_rng(int(scale * 1e6))
    gs = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(5, 2)).astype(np.float32)]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs))
    gs = [(g * (scale / norm)).astype(np.float32) for g in gs]
    want, _ = optax.clip_by_global_norm(1e-3).update(
        [jnp.asarray(g) for g in gs], None)
    tg = [torch.from_numpy(g) for g in gs]
    got = clip_by_global_norm(tg, 1e-3)
    np.testing.assert_allclose(float(global_norm(tg)),
                               float(optax.global_norm(gs)), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("config", list(CONFIGS) + ["cosine_nowarmup"])
def test_learning_rate_schedule_is_optax(config):
    """The rate of the update after ``count`` updates, as the JAX
    trainer's optax schedule gives it (float32 there, float64 here: rtol
    1e-6); with a warmup the first update's rate is 0."""
    import optax
    from ldpc_tpu_torch.train.trainer import learning_rate_schedule
    kw = (dict(lr_schedule="cosine", decay_steps=6)
          if config == "cosine_nowarmup" else CONFIGS[config])
    cfg = lt.TrainingConfig(learning_rate=2e-3, **kw)
    lr = learning_rate_schedule(cfg)
    if cfg.lr_schedule == "constant":
        want = lambda count: 2e-3
    else:  # ldpc_tpu/train/trainer.py:_build_optimizer's schedule
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0 if cfg.warmup_steps else 2e-3, peak_value=2e-3,
            warmup_steps=cfg.warmup_steps, decay_steps=cfg.decay_steps,
            end_value=2e-3 * 0.01)
    for count in range(9):
        np.testing.assert_allclose(lr(count), float(want(count)), rtol=1e-6,
                                   atol=0)
    assert (lr(0) == 0.0) == (config == "cosine_warmup")
