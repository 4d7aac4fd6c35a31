"""Shared set-up for the parity tests of the PyTorch port (``ldpc_tpu_torch``)
against the JAX package: one protograph, one decoder per package built
with the same arguments, the JAX weights carried across, and channel LLRs
made once with numpy."""

import dataclasses

import numpy as np
import pytest

import ldpc_tpu
import ldpc_tpu_torch as lt
from ldpc_tpu.decode.qc_engine import build_qc_graph as jax_build_qc_graph

# one decoder of every variant kind (the make_decoder arguments)
SMALL_KINDS = {
    "ms": dict(kind="ms", factor=0.7),
    "rcq_bc3_bv8": dict(kind="rcq", bc=3, bv=8),
    "nms_t2": dict(kind="nms", sharing_type=2, init="nms", seed=1),
    "oms_t2": dict(kind="oms", sharing_type=2, seed=5),
    "wrcq_t2": dict(kind="wrcq", bc=3, sharing_type=2, init="nms", seed=6),
    "orcq_t2": dict(kind="orcq", bc=3, sharing_type=2, seed=7),
    "rcq_bc5_closed": dict(kind="rcq", bc=5, bv=8, closed_qdq=True),
}
# the zoo decoder's variant: W-OMS-RCQ, bc=3, bv=8 uniform V2C ladder
ZOO_LIKE = dict(kind="orcq", bc=3, bv=8, sharing_type=2, seed=3,
                quantizer_params=((2.0, 1.3), (4.0, 1.3), (6.0, 1.3)),
                v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)))


def make_base(mb, nb, lift, seed=0, density=1.0):
    """A random protograph; ``density < 1`` blanks entries but keeps every
    row and column non-empty (as ``tests/test_pallas_fused.py::_setup``)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, lift, size=(mb, nb))
    if density < 1.0:
        mask = rng.random((mb, nb)) < (1.0 - density)
        base = np.where(mask, -1, base)
        for i in range(mb):
            if (base[i] >= 0).sum() == 0:
                base[i, rng.integers(nb)] = rng.integers(lift)
        for j in range(nb):
            if (base[:, j] >= 0).sum() == 0:
                base[rng.integers(mb), j] = rng.integers(lift)
    return base


def decoder_pair(base, lift, T, jax_options=None, torch_options=None, **kw):
    """(JAX decoder, port decoder on the CPU) for the same code and
    arguments; the port decoder carries the JAX decoder's weights."""
    jdec = ldpc_tpu.make_decoder(
        ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T),
        max_iterations=T, qc=jax_build_qc_graph(base, lift),
        qc_options=jax_options, **kw)
    tdec = lt.make_decoder(
        lt.create_qc_code(base, lift=lift, max_iterations=T),
        max_iterations=T, qc=lt.build_qc_graph(base, lift),
        qc_options=torch_options, device="cpu", **kw)
    return jdec, carry_weights(jdec, tdec)


def carry_weights(jdec, tdec):
    """``tdec`` with ``jdec``'s (JAX) weights, on the CPU."""
    return tdec.replace_weights(lt.weights_from_numpy(
        {k: (None if v is None else np.array(v))
         for k, v in jdec.weights.items()}, device="cpu"))


def general_pair(factory, code_kw, T, jax_options=None, torch_options=None,
                 **kw):
    """(JAX decoder, port decoder on the CPU) on the code that both
    packages' ``factory`` (a code constructor's name) builds from
    ``code_kw``, without a QC structure; the port decoder carries the JAX
    decoder's weights."""
    jdec = ldpc_tpu.make_decoder(
        getattr(ldpc_tpu, factory)(max_iterations=T, **code_kw),
        max_iterations=T, qc_options=jax_options, **kw)
    tdec = lt.make_decoder(
        getattr(lt, factory)(max_iterations=T, **code_kw),
        max_iterations=T, qc_options=torch_options, device="cpu", **kw)
    np.testing.assert_array_equal(jdec.code.H, tdec.code.H)
    return jdec, carry_weights(jdec, tdec)


def channel_llr(B, n, snr_db, seed):
    """BPSK all-zero codewords over AWGN, as float32 numpy LLRs."""
    rng = np.random.default_rng(seed)
    sigma2 = 10.0 ** (-snr_db / 10.0)
    r = 1.0 + np.sqrt(sigma2) * rng.standard_normal((B, n))
    return (2.0 * r / sigma2).astype(np.float32)


def assert_same_fields(a, b):
    """Two dataclasses (a port one and its JAX twin) hold equal fields;
    numpy arrays equal in value and dtype, dataclass fields compared the
    same way."""
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if dataclasses.is_dataclass(x):
            assert_same_fields(x, y)
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, k
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), k)
            assert np.asarray(x).dtype == np.asarray(y).dtype, k
        else:
            assert x == y, k


def assert_same_decoder(tdec, jdec, weights=True):
    """The port decoder equals the JAX one: code, QC tables, spec, name,
    recipe, schedule, options and (``weights``) the weight tables."""
    np.testing.assert_array_equal(tdec.code.H, jdec.code.H)
    assert (tdec.code.n, tdec.code.k) == (jdec.code.n, jdec.code.k)
    assert (jdec.qc is None) == (tdec.qc is None)
    if jdec.qc is not None:
        assert_same_fields(tdec.qc, jdec.qc)
    else:
        assert_same_fields(tdec.graph, jdec.graph)
    assert_same_fields(tdec.spec, jdec.spec)
    assert (tdec.name, tdec.recipe) == (jdec.name, jdec.recipe)
    assert (tdec.layered, tdec.max_iterations) == (jdec.layered,
                                                   jdec.max_iterations)

    def opts(o, dtype_name):
        return None if o is None else {
            k: (dtype_name(v) if k == "dtype" else v) for k, v in o.items()}

    assert opts(tdec.qc_options, lambda d: str(d).split(".")[-1]) == \
        opts(jdec.qc_options, lambda d: np.dtype(d).name)
    assert tdec.weights.keys() == jdec.weights.keys()
    for k, w in jdec.weights.items():
        assert (w is None) == (tdec.weights[k] is None)
        if w is not None:
            assert tuple(tdec.weights[k].shape) == np.shape(w)
            if weights:
                np.testing.assert_array_equal(tdec.weights[k].numpy(),
                                              np.asarray(w))


def assert_same_config(tcfg, jcfg):
    """A port ``SimulationConfig`` equals the JAX one in every JAX field."""
    for f in dataclasses.fields(jcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    np.testing.assert_array_equal(tcfg.snr_points(), jcfg.snr_points())


# -- training: the loss, its weight gradients and the trajectory -------------

QP = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
# the trainable kinds of the training parity tests (make_decoder arguments)
TRAIN_KINDS = {
    "nms_t2": dict(kind="nms", sharing_type=2, init="nms", seed=1),
    "oms_t2": dict(kind="oms", sharing_type=2, seed=5),
    "wrcq_t2": dict(kind="wrcq", bc=3, sharing_type=2, init="nms", seed=6),
    "orcq_t2_bv8": dict(kind="orcq", bc=3, bv=8, sharing_type=2, seed=7,
                        quantizer_params=QP, v2c_quantizer_params=VQP),
}


def jax_loss_and_grads(jdec, llr, joint):
    """``jax.value_and_grad(ldpc_tpu.train.posterior_joint_loss)`` on the
    numpy LLRs (all-zero targets), plus the trajectory: (loss, accuracy,
    final posterior, posteriors_all or None, {key: gradient}) as numpy."""
    import jax
    import jax.numpy as jnp
    from ldpc_tpu.train import posterior_joint_loss

    x = jnp.asarray(llr)
    fn = jax.value_and_grad(
        lambda w: posterior_joint_loss(w, x, jnp.zeros_like(x),
                                       decoder=jdec, joint=joint),
        has_aux=True)
    (loss, (post, acc)), grads = fn(jdec.weights)
    traj = (np.asarray(jdec(x, ste=True, return_trajectory=True)
                       .posteriors_all) if joint else None)
    return (float(loss), float(acc), np.asarray(post), traj,
            {k: np.asarray(g) for k, g in grads.items() if g is not None})


def torch_loss_and_grads(tdec, llr, joint):
    """The port's counterpart of :func:`jax_loss_and_grads` (autograd
    through ``ldpc_tpu_torch.train.posterior_joint_loss``)."""
    import torch
    from ldpc_tpu_torch.train import posterior_joint_loss

    w = {k: (None if v is None else v.clone().requires_grad_(True))
         for k, v in tdec.weights.items()}
    x = torch.as_tensor(llr, device=tdec.device)
    loss, (post, acc) = posterior_joint_loss(w, x, torch.zeros_like(x),
                                             decoder=tdec, joint=joint)
    keys = [k for k, v in w.items() if v is not None]
    grads = torch.autograd.grad(loss, [w[k] for k in keys])
    traj = (tdec(x, ste=True, return_trajectory=True).posteriors_all
            if joint else None)
    cpu = lambda t: t.detach().cpu().numpy()
    return (float(loss.detach()), float(acc), cpu(post),
            None if traj is None else cpu(traj),
            {k: cpu(g) for k, g in zip(keys, grads)})


def assert_training_match(got, want):
    """A port result of :func:`torch_loss_and_grads` against ``ldpc_tpu``'s
    (or another device's). Tolerances: posteriors and the trajectory as
    the forward contract, rtol 1e-6 / atol 1e-5 (XLA:CPU contracts FMAs);
    the loss, a mean of BCE terms whose relative error is the posteriors'
    absolute error, rtol 2e-5 / atol 1e-6; the accuracy to one float32
    rounding of its mean (rtol 1e-6); each weight gradient, a sum over
    B * n * T terms of the same deviations, rtol 1e-4 / atol 1e-6."""
    loss, acc, post, traj, grads = got
    jloss, jacc, jpost, jtraj, jgrads = want
    np.testing.assert_allclose(loss, jloss, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(acc, jacc, rtol=1e-6)
    np.testing.assert_allclose(post, jpost, rtol=1e-6, atol=1e-5)
    if jtraj is not None:
        assert traj.shape == jtraj.shape
        np.testing.assert_allclose(traj, jtraj, rtol=1e-6, atol=1e-5)
    assert grads.keys() == jgrads.keys()
    for k in grads:
        np.testing.assert_allclose(grads[k], jgrads[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


# the general training tests' code: n = 32, check degrees 5-7, dv = 3
PEG = ("create_peg_code", dict(n=32, m=16, dv=3, seed=1))
# the kinds of the general routes: TRAIN_KINDS and per-edge N-NMS
TRAIN_KINDS_GENERAL = dict(TRAIN_KINDS, nnms_t0=dict(kind="nms",
                                                     sharing_type=0, seed=1))
# route: (make_decoder arguments, qc_options)
GENERAL_ROUTES = {
    "flooding": (dict(), None),
    "layered": (dict(layered=True), None),
    "bucketed": (dict(bucketed=True), None),
    "bucketed_ce2": (dict(bucketed=True), {"check_every": 2}),
}


def general_route_pair(route, name, T=5):
    """(JAX decoder, port decoder) of kind ``name`` on the PEG code and
    ``route``."""
    args, opts = GENERAL_ROUTES[route]
    return general_pair(*PEG, T, jax_options=opts, torch_options=opts,
                        **TRAIN_KINDS_GENERAL[name], **args)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run a test's torch ops on one thread. The training tests run
    thousands of tiny ops; with several test processes on the machine,
    torch's intra-op thread pool oversubscribes the cores and every
    process slows by several times."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
