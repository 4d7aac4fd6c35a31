"""The port's row/column QC decode (``ldpc_tpu_torch.decode.qc_rowcol``,
kernels K5 and K6) against ``ldpc_tpu/decode/pallas_qc.py`` run in
interpret mode, on the CPU, where the port runs the kernels' plain
PyTorch versions.

- per kind and storage type, one K5 launch (``_cn_row_plain`` vs
  ``_row_call``) and one K6 launch (``_vn_col_plain`` vs ``_col_call``);
- the whole ``qc_pallas_decode_batch`` (f32 with ``check_every`` 1 and 3,
  and bf16), its argument checks, and the device rule;
- the row/column path against the port's engine route: equal hard outputs
  in f32; in bf16 K6 keeps its sums in f32 where the engine rounds them,
  so the two agree statistically only, as ``ldpc_tpu``'s own two routes
  do on the zoo decoder.

Tolerances: f32 outputs to rtol 1e-6 / atol 1e-5 with equal signs and
exact hard outputs (XLA:CPU contracts ``llr + alpha*ext`` into an FMA and
its ``pow`` is not the port's); bf16 >= 99.99% equal (bit-exact on these
cases), with XLA's excess precision off for the JAX compile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu.decode.engine import _scan_xs
from ldpc_tpu.decode.pallas_qc import _col_call, _row_call
from ldpc_tpu.decode.pallas_qc import \
    qc_pallas_decode_batch as jax_rowcol
from ldpc_tpu.decode.qc_engine import _per_block_weights
from ldpc_tpu_torch.decode import engine, qc_rowcol
from torch_port_helpers import (SMALL_KINDS, ZOO_LIKE, channel_llr,
                                decoder_pair, make_base)

T = 6
NO_EXCESS = {"xla_allow_excess_precision": False}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(mb=3, nb=8, density=0.8, **kw):
    return decoder_pair(make_base(mb, nb, 16, seed=0, density=density), 16,
                        T, **kw)


def _close(got, want, f32):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    if f32:
        np.testing.assert_array_equal(got < 0, want < 0)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    else:
        assert (got == want).mean() >= 0.9999


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(SMALL_KINDS))
def test_single_launches_match_jax(name, dt):
    """K5 on base row 1 and K6 on base column 2 at iteration t=4 (the
    last quantizer of the schedule), on states drawn with numpy."""
    jdt, tdt = DTYPES[dt]
    jdec, tdec = _pair(**SMALL_KINDS[name])
    qc, spec, L, B, t = tdec.qc, tdec.spec, 16, 64, 4
    rng = np.random.default_rng(13)
    v2c = (4.0 * rng.standard_normal((qc.num_blocks, L, B))
           ).astype(np.float32)
    c2v = (2.0 * rng.standard_normal((qc.num_blocks, L, B))
           ).astype(np.float32)
    llr = channel_llr(B, tdec.code.n, 2.0, seed=14).T.reshape(qc.nb, L, B)
    tv2c, tc2v, tllr = (torch.from_numpy(a).to(tdt) for a in (v2c, c2v, llr))
    jv2c, jc2v, jllr = (jnp.asarray(a).astype(jdt) for a in (v2c, c2v, llr))

    x = {k: a[t] for k, a in _scan_xs(jdec.spec, jdec.weights, T).items()}
    beta, alpha = (jnp.broadcast_to(a, (qc.num_blocks,)).astype(jnp.float32)
                   for a in _per_block_weights(jdec.spec, jdec.qc, x["beta"],
                                               x["alpha"]))
    tabs = engine._tables(tdec.weights, spec, T, qc.num_blocks, "cpu")

    blocks = list(qc.row_blocks[1])
    ref = _row_call(jdec.qc, jdec.spec, 1, jv2c[np.array(blocks)],
                    beta[np.array(blocks)][None], alpha[np.array(blocks)][None],
                    x["thr"][None], x["qp"][None], L, 32, jdt, True)
    out = torch.zeros_like(tv2c)
    qc_rowcol._cn_row_plain(tv2c, out, tabs, qc, spec, 1, t)
    _close(out[blocks], ref, dt == "f32")

    blocks = list(qc.col_blocks[2])
    ref_v2c, ref_post = _col_call(
        jdec.qc, jdec.spec, 2, jc2v[np.array(blocks)], jllr[2],
        alpha[np.array(blocks)][None], x["vthr"][None], x["vqp"][None], L,
        32, jdt, qc_rowcol._with_vqdq(spec), True)
    v2c_out, post = torch.zeros_like(tv2c), torch.zeros_like(tllr)
    qc_rowcol._vn_col_plain(tc2v, tllr, v2c_out, post, tabs, qc, spec, 2, t)
    _close(v2c_out[blocks], ref_v2c, dt == "f32")
    _close(post[2], ref_post, dt == "f32")


@pytest.mark.parametrize("kind,dt,check_every", [
    ("rcq_bc3_bv8", "f32", 1), ("orcq_t2", "f32", 3), ("zoo_like", "bf16", 1),
])
def test_decode_matches_jax(kind, dt, check_every):
    jdt, tdt = DTYPES[dt]
    jdec, tdec = _pair(**(ZOO_LIKE if kind == "zoo_like"
                          else SMALL_KINDS[kind]))
    llr = channel_llr(128, tdec.code.n, 3.0, seed=15)
    x = jnp.asarray(llr)
    ref = jax_rowcol.lower(
        x, jdec.weights, qc=jdec.qc, spec=jdec.spec, max_iterations=T,
        check_every=check_every, dtype=jdt, batch_tile=64, interpret=True,
    ).compile(compiler_options=NO_EXCESS)(x, jdec.weights)
    out = lt.qc_pallas_decode_batch(
        torch.from_numpy(llr), tdec.weights, qc=tdec.qc, spec=tdec.spec,
        max_iterations=T, check_every=check_every, dtype=tdt, batch_tile=64)
    assert out.posterior.dtype == tdt and out.bits.dtype == torch.int32
    _close(out.posterior, ref.posterior, dt == "f32")
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    assert 0 < int(out.success.sum()) < 128


def test_argument_checks():
    """B must be a multiple of batch_tile and check_every must divide T,
    as in ldpc_tpu; interpret and unroll are accepted and ignored."""
    _, tdec = _pair(**SMALL_KINDS["ms"])
    llr = torch.from_numpy(channel_llr(100, tdec.code.n, 2.5, seed=16))
    args = dict(qc=tdec.qc, spec=tdec.spec, max_iterations=T)
    with pytest.raises(ValueError, match="tile"):
        lt.qc_pallas_decode_batch(llr, tdec.weights, batch_tile=64, **args)
    with pytest.raises(ValueError, match="check_every"):
        lt.qc_pallas_decode_batch(llr, tdec.weights, batch_tile=4,
                                  check_every=4, **args)
    with pytest.raises(ValueError, match="dtype"):
        lt.qc_pallas_decode_batch(llr, tdec.weights, batch_tile=4,
                                  dtype=torch.float16, **args)
    a = lt.qc_pallas_decode_batch(llr, tdec.weights, batch_tile=4, **args)
    b = lt.qc_pallas_decode_batch(llr, tdec.weights, batch_tile=20,
                                  interpret=True, unroll=True, **args)
    assert torch.equal(a.posterior, b.posterior)
    assert a.posterior.dtype == torch.bfloat16  # the JAX default storage


def test_rowcol_path_vs_engine_route():
    """In f32 the row/column path and the engine compute the same sums in
    the same order (only the V2C quantizer's closed form differs, by at
    most an ulp of the reconstruction): equal hard outputs. In bf16 they
    round at different points, so frames near the decision boundary may
    go either way; their frame error counts stay close."""
    _, tdec = _pair(5, 12, 1.0, **ZOO_LIKE)
    llr = torch.from_numpy(channel_llr(128, tdec.code.n, 4.0, seed=17))
    args = dict(qc=tdec.qc, spec=tdec.spec, max_iterations=T, check_every=2)
    for dtype in (torch.float32, torch.bfloat16):
        rc = lt.qc_pallas_decode_batch(llr, tdec.weights, dtype=dtype,
                                       **args)
        en = lt.qc_decode_batch(llr, tdec.weights, dtype=dtype, **args)
        if dtype == torch.float32:
            assert torch.equal(rc.bits, en.bits)
            assert torch.equal(rc.success, en.success)
            assert torch.equal(rc.iterations, en.iterations)
            torch.testing.assert_close(rc.posterior, en.posterior,
                                       rtol=1e-6, atol=1e-5)
        else:  # 42 frame errors on each route here, success flags 100% equal
            fe_rc = int(rc.bits.any(dim=1).sum())
            fe_en = int(en.bits.any(dim=1).sum())
            assert 20 < fe_rc < 100 and abs(fe_rc - fe_en) <= 6
            assert (rc.success == en.success).float().mean().item() >= 0.95


def test_zoo_decoder_routes_match_jax_routes():
    """On the zoo decoder in bf16 (256 frames at 6.25 dB) each port route
    equals its JAX counterpart bit for bit, and ``ldpc_tpu``'s own engine
    and K5/K6 routes disagree on marginal frames, as the port's do: the
    routes' disagreement is the reference's rounding, not the port's."""
    from ldpc_tpu.decode.qc_engine import qc_decode_batch as jax_engine
    from ldpc_tpu.zoo import load_pretrained as jax_load

    jdec = jax_load("worcq_bc3_qc9472")
    tdec = lt.load_pretrained("worcq_bc3_qc9472", device="cpu")
    llr = channel_llr(256, tdec.code.n, 6.25, seed=21)
    x = jnp.asarray(llr)
    args = dict(qc=jdec.qc, spec=jdec.spec, max_iterations=10,
                dtype=jnp.bfloat16)
    j_en = jax_engine.lower(x, jdec.weights, **args).compile(
        compiler_options=NO_EXCESS)(x, jdec.weights)
    j_rc = jax_rowcol.lower(x, jdec.weights, batch_tile=128, interpret=True,
                            **args).compile(
        compiler_options=NO_EXCESS)(x, jdec.weights)
    targs = dict(qc=tdec.qc, spec=tdec.spec, max_iterations=10,
                 dtype=torch.bfloat16)
    t_en = lt.qc_decode_batch(torch.from_numpy(llr), tdec.weights, **targs)
    t_rc = lt.qc_pallas_decode_batch(torch.from_numpy(llr), tdec.weights,
                                     **targs)
    for port, ref in ((t_en, j_en), (t_rc, j_rc)):
        np.testing.assert_array_equal(port.bits.numpy(), np.asarray(ref.bits))
        np.testing.assert_array_equal(port.success.numpy(),
                                      np.asarray(ref.success))
    # ldpc_tpu's two routes: 99.957% of bits, 253 of 256 success flags
    bits = (np.asarray(j_en.bits) == np.asarray(j_rc.bits)).mean()
    same = int((np.asarray(j_en.success) == np.asarray(j_rc.success)).sum())
    assert 0.999 < bits < 1.0 and same == 253, (bits, same)


def test_wrappers_refuse_other_devices(monkeypatch):
    """A tensor on neither the CPU nor a CUDA card raises, and never falls
    back to the plain versions."""
    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(qc_rowcol, "_cn_row_plain", no_plain)
    monkeypatch.setattr(qc_rowcol, "_vn_col_plain", no_plain)
    _, tdec = _pair(**SMALL_KINDS["ms"])
    meta = torch.zeros((128, tdec.code.n), device="meta")
    before = (qc_rowcol.CN_LAUNCHES, qc_rowcol.VN_LAUNCHES)
    with pytest.raises(ValueError, match="device"):
        lt.qc_pallas_decode_batch(meta, tdec.weights, qc=tdec.qc,
                                  spec=tdec.spec, max_iterations=T)
    state = torch.zeros((tdec.qc.num_blocks, 16, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        qc_rowcol.cn_row(state, state, {}, tdec.qc, tdec.spec, 0, 0)
    with pytest.raises(ValueError, match="device"):
        qc_rowcol.vn_col(state, state, state, state, {}, tdec.qc, tdec.spec,
                         0, 0)
    assert (qc_rowcol.CN_LAUNCHES, qc_rowcol.VN_LAUNCHES) == before
