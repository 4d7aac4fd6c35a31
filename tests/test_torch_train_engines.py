"""Training through the port's QC engines against ``ldpc_tpu``'s: the
posterior-joint loss (joint and final-only), its gradients with respect
to the weight tables and the trajectory ``posteriors_all``, on shared
numpy LLRs and the JAX decoder's weights, through ``Decoder.__call__``'s
training route (QC flooding and QC layered, float32, straight-through
quantizers). The tolerances are those of
``torch_port_helpers.assert_training_match``.

Code: a 2x4 protograph, lift 4 (n = 16), T = 5, B = 16 at 1.5 dB. Each
case compiles one JAX gradient (~4 s).

Also here, on every engine: the two derivative rules where JAX's and
torch's differ, ``|x|`` at 0 (punctured positions) and the offset kinds'
``relu`` at 0 (a c2v magnitude equal to beta). Each case also shows that
its input reaches the rule: under torch's rule the gradients differ."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (one_torch_thread,  # noqa: F401 (autouse)
                                TRAIN_KINDS, assert_training_match,
                                channel_llr, decoder_pair,
                                jax_loss_and_grads, make_base,
                                general_route_pair, torch_loss_and_grads)

T, B, SNR = 5, 16, 1.5
BASE = make_base(2, 4, 4, seed=0)


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "final"])
@pytest.mark.parametrize("layered", [False, True],
                         ids=["flooding", "layered"])
@pytest.mark.parametrize("name", list(TRAIN_KINDS))
def test_qc_loss_and_gradients_match_jax(name, layered, joint):
    jdec, tdec = decoder_pair(BASE, 4, T, layered=layered,
                              **TRAIN_KINDS[name])
    llr = channel_llr(B, tdec.code.n, SNR, seed=3)
    got = torch_loss_and_grads(tdec, llr, joint)
    want = jax_loss_and_grads(jdec, llr, joint)
    assert_training_match(got, want)
    if joint:
        assert got[3].shape == (T, B, tdec.code.n)
    # the gradient reaches every trainable table
    assert all(np.abs(g).sum() > 0 for g in got[4].values())


def test_qc_punctured_positions_take_jax_abs_rule(monkeypatch):
    """Punctured positions (channel LLR 0) on W-OMS-RCQ: the straight-
    through quantizer's forward sends an exact 0.0 for a dead-zone c2v, so
    a punctured variable's v2c is exactly 0 in later iterations, where
    ``|x|``'s derivative is JAX's +1. With torch's rule (0 at 0) the
    gradients differ, so this input reaches the rule."""
    from ldpc_tpu_torch.decode import engine

    jdec, tdec = decoder_pair(BASE, 4, T, **TRAIN_KINDS["orcq_t2_bv8"])
    llr = channel_llr(B, tdec.code.n, SNR, seed=4)
    llr[:, ::5] = 0.0
    got = torch_loss_and_grads(tdec, llr, True)
    assert_training_match(got, jax_loss_and_grads(jdec, llr, True))
    monkeypatch.setattr(engine, "jax_abs", torch.abs)
    torch_rule = torch_loss_and_grads(tdec, llr, True)[4]
    assert any(not np.allclose(torch_rule[k], g, rtol=1e-4, atol=1e-6)
               for k, g in got[4].items())


@pytest.mark.parametrize("route", ["flooding", "layered", "bucketed"])
def test_punctured_positions_take_jax_abs_rule(route, monkeypatch):
    """As the QC case, on the general routes: where the straight-through
    quantizer's forward rounds a dead-zone c2v to an exact 0.0, a
    punctured variable's v2c is exactly 0 and ``|x|``'s derivative is
    JAX's +1. With torch's rule (0 at 0) the gradients differ."""
    from ldpc_tpu_torch.decode import engine

    jdec, tdec = general_route_pair(route, "orcq_t2_bv8")
    llr = channel_llr(B, tdec.code.n, SNR, seed=4)
    llr[:, ::4] = 0.0
    got = torch_loss_and_grads(tdec, llr, True)
    assert_training_match(got, jax_loss_and_grads(jdec, llr, True))
    monkeypatch.setattr(engine, "jax_abs", torch.abs)
    torch_rule = torch_loss_and_grads(tdec, llr, True)[4]
    assert any(not np.allclose(torch_rule[k], g, rtol=1e-4, atol=1e-6)
               for k, g in got[4].items())


@pytest.mark.parametrize("route", ["flooding", "bucketed"])
def test_offset_at_beta_takes_relu_rule(route, monkeypatch):
    """N-2D-OMS with beta = 0.5, alpha = 0 and LLRs on a 0.5 grid: every
    message stays on the grid, so many c2v magnitudes equal beta exactly,
    where ``relu``'s derivative is 0 in JAX (``torch.clamp_min``'s is 1).
    The gradients equal JAX's, and differ under the clamp rule."""
    jdec, tdec = general_route_pair(route, "oms_t2")
    w = {k: np.full(np.shape(v), 0.5 if k == "beta" else 0.0, np.float32)
         for k, v in jdec.weights.items()}
    jdec = dataclasses.replace(jdec, weights={k: jnp.asarray(v)
                                              for k, v in w.items()})
    tdec = tdec.replace_weights(w)
    llr = np.round(channel_llr(B, tdec.code.n, SNR, seed=5) * 2) / 2
    got = torch_loss_and_grads(tdec, llr, True)
    assert_training_match(got, jax_loss_and_grads(jdec, llr, True))
    monkeypatch.setattr(torch, "relu", lambda x: torch.clamp_min(x, 0.0))
    clamp_rule = torch_loss_and_grads(tdec, llr, True)[4]
    assert any(not np.allclose(clamp_rule[k], g, rtol=1e-4, atol=1e-6)
               for k, g in got[4].items())
