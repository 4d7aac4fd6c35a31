"""Training through the port's general, layered and degree-bucketed
engines against ``ldpc_tpu``'s: the posterior-joint loss (joint and
final-only), its weight gradients and the trajectory ``posteriors_all``
on shared numpy LLRs and the JAX decoder's weights, through
``Decoder.__call__``'s training route. The tolerances are those of
``torch_port_helpers.assert_training_match``.

Code: a PEG code, n = 32, m = 16 (check degrees 5-7, variable degree 3),
T = 5, B = 16 at 1.5 dB. The kinds of the QC tests plus per-edge N-NMS
(sharing type 0, general routes only). ``test_torch_train_engines.py``
holds the derivative rules where JAX's and torch's differ on these
routes too."""

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from torch_port_helpers import (one_torch_thread,  # noqa: F401 (autouse)
                                GENERAL_ROUTES, TRAIN_KINDS_GENERAL,
                                assert_training_match, channel_llr,
                                general_route_pair, jax_loss_and_grads,
                                torch_loss_and_grads)

T, B, SNR = 5, 16, 1.5


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "final"])
@pytest.mark.parametrize("route", list(GENERAL_ROUTES))
@pytest.mark.parametrize("name", list(TRAIN_KINDS_GENERAL))
def test_general_loss_and_gradients_match_jax(name, route, joint):
    # check_every=2 must divide T: that route runs T=4
    jdec, tdec = general_route_pair(route, name,
                                    4 if route == "bucketed_ce2" else T)
    llr = channel_llr(B, tdec.code.n, SNR, seed=3)
    got = torch_loss_and_grads(tdec, llr, joint)
    assert_training_match(got, jax_loss_and_grads(jdec, llr, joint))
    if joint:
        assert got[3].shape == (tdec.max_iterations, B, tdec.code.n)
    assert all(np.abs(g).sum() > 0 for g in got[4].values())


def test_layered_trajectory_ends_at_the_final_posterior():
    """The trajectory's last iteration is the final posterior wherever a
    frame ran all T iterations (frozen frames keep an earlier one)."""
    _, tdec = general_route_pair("layered", "orcq_t2_bv8")
    x = torch.from_numpy(channel_llr(B, tdec.code.n, SNR, seed=6))
    out = tdec(x, ste=True, return_trajectory=True)
    ran = out.iterations == T
    assert ran.any()
    assert torch.equal(out.posteriors_all[-1][ran], out.posterior[ran])
    assert lt.DecodeResult is type(out)
