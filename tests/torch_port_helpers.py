"""Shared set-up for the parity tests of the PyTorch port (``ldpc_tpu_torch``)
against the JAX package: one protograph, one decoder per package built
with the same arguments, the JAX weights carried across, and channel LLRs
made once with numpy."""

import dataclasses

import numpy as np

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
