"""Training on the card against training on the CPU: the straight-through
quantizers, the posterior-joint loss with its weight gradients and
trajectory on every engine route and trainable kind, the trainer's steps
and the gradient analyzer. Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

These tests import no JAX. The training path runs no hand-written kernel:
it is autograd over the engines' PyTorch ops. Tolerances:

- the quantizers: bit for bit, forward and backward (elementwise ops),
  except the power law's forward where ``torch.pow`` rounds differently
  on the card (ROADMAP Queue 3);
- a decode's trajectory and final posterior: rtol 1e-6 / atol 1e-5 (the
  forward contract; the engines' forward is bit for bit on the card in
  ``test_general_engine_cuda.py``);
- the loss rtol 2e-5 / atol 1e-6 and the accuracy rtol 1e-6: a mean whose
  reduction order differs;
- the weight gradients rtol 1e-4 / atol 1e-6, the tolerance against the
  JAX package on the CPU: the backward of a gather (``index_select``,
  the weight tables' indexing) adds with atomics on the card, in an order
  the CPU does not;
- a trainer's weights after 3 Adam steps rtol 1e-6 / atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch import quantizer as tq
from ldpc_tpu_torch.decode import fused, qc_rowcol

pytestmark = pytest.mark.cuda

QP = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
KINDS = {
    "nms_t2": dict(kind="nms", sharing_type=2, init="nms", seed=1),
    "oms_t2": dict(kind="oms", sharing_type=2, seed=5),
    "wrcq_t2": dict(kind="wrcq", bc=3, sharing_type=2, init="nms", seed=6),
    "orcq_t2_bv8": dict(kind="orcq", bc=3, bv=8, sharing_type=2, seed=7,
                        quantizer_params=QP, v2c_quantizer_params=VQP),
    "nnms_t0": dict(kind="nms", sharing_type=0, seed=1),
}
# route: (make_decoder arguments, qc_options, QC code)
ROUTES = {
    "qc_flooding": (dict(), None, True),
    "qc_layered": (dict(layered=True), None, True),
    "flooding": (dict(), None, False),
    "layered": (dict(layered=True), None, False),
    "bucketed": (dict(bucketed=True), None, False),
    "bucketed_ce2": (dict(bucketed=True), {"check_every": 2}, False),
}
T, B, SNR = 4, 16, 1.5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _decoder(route, kind, device):
    args, opts, qc = ROUTES[route]
    if qc:
        base = np.random.default_rng(0).integers(0, 16, size=(3, 8))
        code = lt.create_qc_code(base, lift=16, max_iterations=T)
        args = dict(args, qc=lt.build_qc_graph(base, 16))
    else:
        code = lt.create_peg_code(n=64, m=32, dv=3, seed=1, max_iterations=T)
    return lt.make_decoder(code, max_iterations=T, qc_options=opts,
                           device=device, **args, **KINDS[kind])


def _cpu_twin(dec):
    return dataclasses.replace(dec, device=torch.device("cpu")
                               ).replace_weights(dec.weights)


def _llr(n, seed, device, batch=B):
    rng = np.random.default_rng(seed)
    sigma2 = 10.0 ** (-SNR / 10.0)
    r = 1.0 + np.sqrt(sigma2) * rng.standard_normal((batch, n))
    return torch.from_numpy((2.0 * r / sigma2).astype(np.float32)).to(device)


def _loss_and_grads(dec, llr, joint):
    w = {k: (None if v is None else v.clone().requires_grad_(True))
         for k, v in dec.weights.items()}
    loss, (post, acc) = lt.posterior_joint_loss(
        w, llr, torch.zeros_like(llr), decoder=dec, joint=joint)
    keys = [k for k, v in w.items() if v is not None]
    grads = torch.autograd.grad(loss, [w[k] for k in keys])
    traj = dec(llr, ste=True, return_trajectory=True).posteriors_all
    cpu = lambda t: t.detach().cpu().numpy()
    return (float(loss.detach()), float(acc), cpu(post), cpu(traj),
            {k: cpu(g) for k, g in zip(keys, grads)})


def _counts():
    return (fused.LAYERED_LAUNCHES, fused.FLOODING_LAUNCHES,
            qc_rowcol.CN_LAUNCHES, qc_rowcol.VN_LAUNCHES)


def _bits_equal(a, b):
    assert a.dtype == b.dtype == torch.float32
    assert torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


STES = {
    "staircase": lambda x, C: tq.staircase_qdq_ste(
        x, torch.as_tensor(tq.power_thresholds(3, C, 1.3), device=x.device)),
    "uniform": lambda x, C: tq.uniform_qdq_ste(
        x, torch.tensor(C, device=x.device), 128),
    "power": lambda x, C: tq.power_qdq_ste(
        x, torch.tensor(C, device=x.device),
        torch.tensor(1.3, device=x.device), 128),
    "lut": lambda x, C: tq.qdq_ste(
        x, torch.as_tensor(tq.power_thresholds(3, C, 1.3), device=x.device)),
}


@pytest.mark.parametrize("name", list(STES))
def test_ste_quantizers_card_equals_cpu(card, name):
    """Forward (with the exact zeros of ``clipped + (q - clipped)``) and
    backward (1, 1/2 at +-C, 0 beyond) bit for bit. The power law's
    forward is bit for bit wherever its ``power_qdq`` is: ``torch.pow``
    rounds differently on the card and the CPU (ROADMAP Queue 3)."""
    C = 4.0
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0, 1.5 * C, 200_000),
                        [C, -C, 2 * C, -2 * C, 0.0, -0.0, 1e-30, -1e-30]])
    x = torch.from_numpy(x.astype(np.float32))
    outs = []
    for dev in ("cpu", card):
        xd = x.to(dev).requires_grad_(True)
        y = STES[name](xd, C)
        (g,) = torch.autograd.grad(y.sum(), xd)
        q = tq.power_qdq(xd.detach(), torch.tensor(C, device=dev),
                         torch.tensor(1.3, device=dev), 128).cpu()
        outs.append((y.detach(), g, q.view(torch.int32)))
    same = slice(None)
    if name == "power":  # and on each device the STE of its own qdq
        same = outs[1][2] == outs[0][2]
        for y, _, q in outs:
            clipped = torch.clamp(x, -C, C)
            _bits_equal(y.cpu(), clipped + (q.view(torch.float32) - clipped))
    _bits_equal(outs[1][0].cpu()[same], outs[0][0][same])
    _bits_equal(outs[1][1], outs[0][1])
    assert int((outs[0][0] == 0).sum()) > 0
    assert outs[0][1][-8:-4].tolist() == [0.5, 0.5, 0.0, 0.0]


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "final"])
@pytest.mark.parametrize("route,kind", [
    (r, k) for r in ROUTES for k in KINDS
    if not (ROUTES[r][2] and k == "nnms_t0")])  # type 0: not on QC
def test_loss_and_gradients_card_equal_cpu(card, route, kind, joint):
    dec = _decoder(route, kind, card)
    llr = _llr(dec.code.n, 3, card)
    before = _counts()
    got = _loss_and_grads(dec, llr, joint)
    torch.cuda.synchronize()
    assert _counts() == before  # no hand-written kernel on this path
    want = _loss_and_grads(_cpu_twin(dec), llr.cpu(), joint)
    loss, acc, post, traj, grads = got
    np.testing.assert_allclose(loss, want[0], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(acc, want[1], rtol=1e-6)
    np.testing.assert_allclose(post, want[2], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(traj, want[3], rtol=1e-6, atol=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want[4][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        assert np.abs(g).sum() > 0


@pytest.mark.parametrize("route", ["qc_flooding", "flooding", "bucketed"])
def test_trainer_three_steps_card_equal_cpu(card, route):
    """The clipped, weight-decayed, warmed-up cosine chain: three steps on
    the same batches, on the card and on the CPU."""
    cfg = lt.TrainingConfig(batch_size=B, learning_rate=2e-3,
                            use_gradient_clipping=True, weight_decay=0.01,
                            lr_schedule="cosine", warmup_steps=1,
                            decay_steps=6)
    dec = _decoder(route, "orcq_t2_bv8", card)
    trainers = [lt.PosteriorJointTrainer(d, cfg)
                for d in (dec, _cpu_twin(dec))]
    for i in range(3):
        llr = _llr(dec.code.n, 10 + i, "cpu")
        stats = [tr.train_step(llr.to(tr.device),
                               torch.zeros_like(llr).to(tr.device))
                 for tr in trainers]
        (l1, a1, g1), (l0, a0, g0) = stats
        np.testing.assert_allclose(float(l1), float(l0), rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(a1), float(a0), rtol=1e-6)
        np.testing.assert_allclose(float(g1), float(g0), rtol=1e-4)
    for k, w in trainers[0].decoder.weights.items():
        np.testing.assert_allclose(w.cpu().numpy(),
                                   trainers[1].decoder.weights[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        assert w.device.type == "cuda" and not w.requires_grad


@pytest.mark.parametrize("route", ["qc_flooding", "qc_layered", "layered",
                                   "bucketed"])
def test_analyzer_vmap_on_the_card(card, route):
    """Per-sample norms through ``torch.func.vmap`` on the card equal a
    loop of single-frame gradients on the card (rtol 1e-5) and the CPU's
    vmap (rtol 1e-4)."""
    dec = _decoder(route, "orcq_t2_bv8", card)
    llr = _llr(dec.code.n, 20, card, batch=8)
    got = lt.GradientExplosionAnalyzer(dec)._per_sample_norms(llr, True)
    loop = []
    for one in llr:
        _, _, _, _, g = _loss_and_grads(dec, one[None], True)
        loop.append(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                for v in g.values())))
    np.testing.assert_allclose(got, loop, rtol=1e-5)
    cpu = lt.GradientExplosionAnalyzer(_cpu_twin(dec))._per_sample_norms(
        llr.cpu(), True)
    np.testing.assert_allclose(got, cpu, rtol=1e-4)
