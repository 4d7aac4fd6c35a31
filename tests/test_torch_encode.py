"""The port's systematic encoder (``ldpc_tpu_torch.encode``) and
``channel.simulate_awgn_channel`` against ``ldpc_tpu`` on the same numpy
inputs: GF(2) reduction, pivots and codewords bit for bit (the
rank-deficient reference "(7,4)" code included), then encoded frames
through both packages' decoders on the same LLRs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu.channel as jchannel
import ldpc_tpu_torch as lt
import ldpc_tpu_torch.channel as tchannel
from ldpc_tpu.encode import gf2_row_reduce as jax_rref
from ldpc_tpu_torch.encode import gf2_row_reduce
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _codes():
    """(name, JAX code, port code) with equal H."""
    base = np.random.default_rng(0).integers(0, 64, size=(5, 37))
    t74, j74 = lt.create_test_ldpc_code(), ldpc_tpu.create_test_ldpc_code()
    return [
        ("(7,4)", j74, t74),
        ("(7,4)+dup",
         dataclasses.replace(j74, H=np.vstack([j74.H, j74.H[:1]])),
         dataclasses.replace(t74, H=np.vstack([t74.H, t74.H[:1]]))),
        ("peg256", ldpc_tpu.create_peg_code(n=256, m=128, dv=3, seed=0),
         lt.create_peg_code(n=256, m=128, dv=3, seed=0)),
        ("qc5x37_l16", ldpc_tpu.create_qc_code(base % 16, lift=16),
         lt.create_qc_code(base % 16, lift=16)),
    ]


@pytest.mark.parametrize("case", range(4), ids=[c[0] for c in _codes()])
def test_encoder_equals_jax_bit_for_bit(case):
    name, jcode, tcode = _codes()[case]
    np.testing.assert_array_equal(tcode.H, jcode.H)
    R, piv = gf2_row_reduce(tcode.H)
    jR, jpiv = jax_rref(jcode.H)
    np.testing.assert_array_equal(R, jR)
    np.testing.assert_array_equal(piv, jpiv)
    enc, jenc = lt.make_encoder(tcode), ldpc_tpu.make_encoder(jcode)
    np.testing.assert_array_equal(enc.info_positions, jenc.info_positions)
    np.testing.assert_array_equal(enc.pivot_positions, jenc.pivot_positions)
    if name.startswith("(7,4)"):
        assert enc.k_eff == 3  # H has four independent rows: a (7,3) code
    u = np.random.default_rng(case).integers(0, 2, size=(33, enc.k_eff))
    c = enc(torch.from_numpy(u))
    assert c.dtype == torch.int32 and c.shape == (33, tcode.n)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jenc(jnp.asarray(u))))
    np.testing.assert_array_equal(c[:, enc.info_positions].numpy(), u)
    ok = enc.syndrome_ok(c)
    np.testing.assert_array_equal(ok.numpy(),
                                  np.asarray(jenc.syndrome_ok(np.asarray(c))))
    assert bool(ok.all())
    # a flipped bit breaks the syndrome of that frame only
    bad = c.clone()
    bad[0, 0] ^= 1
    assert enc.syndrome_ok(bad).tolist() == [False] + [True] * 32
    # one frame, squeezed as in the JAX package
    np.testing.assert_array_equal(enc(torch.from_numpy(u[0])).numpy(),
                                  c[0].numpy())


def test_encoder_uploads_constants_once_and_checks_width():
    enc = lt.make_encoder(lt.create_test_ldpc_code())
    enc(torch.zeros(3, dtype=torch.int32))
    first = dict(enc._dev)
    enc(torch.ones((2, 3), dtype=torch.int32))
    assert all(enc._dev[k] is v for k, v in first.items())
    with pytest.raises(ValueError, match="expected 3 info bits"):
        enc(torch.zeros((2, 4)))


def test_encoded_frames_decode_as_in_jax():
    """Random messages, encoded by the port, sent at 2.5 dB through LLRs
    made once with numpy, decoded by both packages' min-sum: equal bits
    and success; at 6 dB every message comes back from the info
    positions."""
    code = lt.create_peg_code(n=256, m=128, dv=3, seed=0, max_iterations=20)
    jcode = ldpc_tpu.create_peg_code(n=256, m=128, dv=3, seed=0,
                                     max_iterations=20)
    enc = lt.make_encoder(code)
    dec = lt.basic_min_sum(code, device="cpu")
    jdec = ldpc_tpu.basic_min_sum(jcode)
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.integers(0, 2, size=(64, enc.k_eff)))
    c = enc(u)
    for snr in (2.5, 6.0):
        sigma2 = 10.0 ** (-snr / 10.0)
        r = (1.0 - 2.0 * c.numpy()) + np.sqrt(sigma2) * \
            rng.standard_normal(c.shape)
        llr = (2.0 * r / sigma2).astype(np.float32)
        out, jout = dec(torch.from_numpy(llr)), jdec(jnp.asarray(llr))
        np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))
        np.testing.assert_array_equal(out.success.numpy(),
                                      np.asarray(jout.success))
    assert torch.equal(out.bits.to(torch.int32), c)
    assert torch.equal(out.bits[:, enc.info_positions].long(), u)


def test_simulate_awgn_channel_matches_jax(monkeypatch):
    """With the noise drawn as zeros both packages return the noise-free
    LLR 2 * symbol / sigma^2 (float32, rtol 1e-6: the two compute
    10^(-snr/10) with their own float32 pow); with noise, the wrapper is
    ``awgn_llr`` on the same generator."""
    bits = np.random.default_rng(2).integers(0, 2, size=(4, 24))
    snr = 3.0
    monkeypatch.setattr(tchannel.torch, "randn",
                        lambda shape, **kw: torch.zeros(
                            shape, dtype=kw.get("dtype"),
                            device=kw.get("device")))
    monkeypatch.setattr(jchannel.jax.random, "normal",
                        lambda key, shape, dtype: jnp.zeros(shape, dtype))
    got = lt.simulate_awgn_channel(torch.Generator().manual_seed(0),
                                   torch.from_numpy(bits), snr)
    want = jchannel.simulate_awgn_channel(jax.random.PRNGKey(0),
                                          jnp.asarray(bits), snr)
    exact = 2.0 * (1.0 - 2.0 * bits) / 10.0 ** (-snr / 10.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-6)
    monkeypatch.undo()
    x = torch.from_numpy(bits)
    assert torch.equal(
        lt.simulate_awgn_channel(torch.Generator().manual_seed(5), x, snr),
        lt.awgn_llr(torch.Generator().manual_seed(5), x, snr))
