"""The port's importance sampler (``ldpc_tpu_torch.sim.importance``)
against ``ldpc_tpu.sim.importance``.

Torch cannot draw JAX's threefry numbers, so estimates agree only
statistically; what is exact: on the same LLRs both packages' event
functions give the same indicators (and so the same estimates), ``log_w``
is the float32 evaluation of the likelihood ratio of the noise that made
the LLRs, zero shift gives unit weights, and punctured positions are
handled by the same rule."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu.sim.importance as jis
import ldpc_tpu_torch as lt
import ldpc_tpu_torch.sim.importance as tis
from ldpc_tpu.design import find_trapping_sets
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _Q(x):
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def _peg_pair():
    """Min-sum on the PEG (48, 24) code in both packages, and its dominant
    trapping set (the JAX tests' decoder-level configuration)."""
    jcode = ldpc_tpu.create_peg_code(n=48, m=24, dv=3, seed=2,
                                     max_iterations=12)
    tcode = lt.create_peg_code(n=48, m=24, dv=3, seed=2, max_iterations=12)
    rep = find_trapping_sets(jcode.H, a_max=4, b_max=3, restarts=2)
    return (ldpc_tpu.basic_min_sum(jcode),
            lt.basic_min_sum(tcode, device="cpu"), rep)


def _two_classes(rep, mult):
    """The first exemplar of each of the report's first two classes."""
    first = {}
    for ts in rep.sets:
        first.setdefault((ts.a, ts.b), ts)
    assert len(first) >= 2
    return [(ab, mult, ts.variables) for ab, ts in list(first.items())[:2]]


def _biased_numpy(B, n, snr, positions, shift, seed):
    """(llr, log_w) of the biased channel computed in float64 numpy."""
    rng = np.random.default_rng(seed)
    sigma2 = 10.0 ** (-snr / 10.0)
    noise = np.sqrt(sigma2) * rng.standard_normal((B, n))
    recv = 1.0 + noise
    recv[:, positions] -= shift
    log_w = (2.0 * shift * noise[:, positions].sum(1)
             - len(positions) * shift ** 2) / (2.0 * sigma2)
    return ((2.0 * recv / sigma2).astype(np.float32),
            log_w.astype(np.float32))


@pytest.mark.parametrize("localized", [True, False])
def test_event_indicators_equal_on_the_same_llrs(monkeypatch, localized):
    """Both packages' ``estimate_trapping_floor`` on the same biased LLRs
    (each package's channel replaced by one numpy draw): the indicators
    their event functions return are equal, and so are the estimates, to
    rtol 1e-6 (XLA's and torch's float32 ``exp`` differ by an ulp on some
    weights)."""
    jdec, tdec, rep = _peg_pair()
    classes = _two_classes(rep, 3)
    seen = {"jax": [], "torch": []}

    def patch(mod, name, to_array):
        real = mod.estimate_event_probability

        def wrapped(event_fn, *, positions, **kw):
            llr, log_w = _biased_numpy(1024, 48, 1.5, list(positions), 1.6,
                                       seed=len(seen[name]))
            seen[name].append(np.asarray(event_fn(to_array(llr))))
            mod_llr, mod_w = to_array(llr), to_array(log_w)
            monkeypatch.setattr(mod, "biased_awgn_llr",
                                lambda *a, **k: (mod_llr, mod_w))
            return real(event_fn, positions=positions, **kw)

        monkeypatch.setattr(mod, "estimate_event_probability", wrapped)

    patch(jis, "jax", jnp.asarray)
    patch(tis, "torch", torch.from_numpy)
    kw = dict(snr_db=1.5, shift=1.6, n_samples=2048, batch=1024,
              localized=localized)
    est = tis.estimate_trapping_floor(tdec, classes, **kw)
    jest = jis.estimate_trapping_floor(jdec, classes, **kw)
    for got, want in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(got)
    assert est.per_class.keys() == jest.per_class.keys()
    for ab, (m, p, rel) in est.per_class.items():
        jm, jp, jrel = jest.per_class[ab]
        assert m == jm and p > 0
        np.testing.assert_allclose((p, rel), (jp, jrel), rtol=1e-6)
    np.testing.assert_allclose(est.fer_floor, jest.fer_floor, rtol=1e-6)
    assert est.summary() == jest.summary()


def test_log_w_is_the_likelihood_ratio_of_the_noise():
    """``log_w`` equals a float64 numpy evaluation from the noise, both
    the noise handed to ``biased_llr_from_noise`` and the noise recovered
    from ``biased_awgn_llr``'s LLRs (rtol 1e-5; atol 1e-5 where log_w
    nears 0 and its float32 difference cancels)."""
    snr, shift, pos = 3.0, 1.3, [2, 7, 11]
    sigma2 = 10.0 ** (-snr / 10.0)
    ref = lambda nz: (2.0 * shift * nz[:, pos].sum(1)
                      - len(pos) * shift ** 2) / (2.0 * sigma2)
    noise = (np.sqrt(sigma2) * np.random.default_rng(3).standard_normal(
        (512, 16))).astype(np.float32)
    llr, log_w = tis.biased_llr_from_noise(torch.from_numpy(noise), snr,
                                           pos, shift)
    np.testing.assert_allclose(log_w.numpy(), ref(noise.astype(np.float64)),
                               rtol=1e-5, atol=1e-5)
    llr, log_w = tis.biased_awgn_llr(torch.Generator().manual_seed(0), 512,
                                     16, snr, pos, shift)
    assert llr.dtype == log_w.dtype == torch.float32
    recv = llr.double().numpy() * sigma2 / 2.0
    recv[:, pos] += shift
    np.testing.assert_allclose(log_w.numpy(), ref(recv - 1.0), rtol=1e-5,
                               atol=1e-5)


def test_zero_shift_gives_unit_weights():
    llr, log_w = tis.biased_awgn_llr(torch.Generator().manual_seed(0), 256,
                                     32, 2.0, positions=[1, 5], shift=0.0)
    assert torch.all(log_w == 0.0)
    assert (llr > 0).float().mean().item() > 0.85


def test_matches_closed_form_gaussian_probability():
    """P[r_i < 0 for i in S] = Q(1/sigma)^|S| (~1.6e-8 at 8 dB) to 20%
    with 2^15 samples, as the JAX package's test asks of its sampler."""
    snr, S = 8.0, [3, 11]
    exact = _Q(10.0 ** (snr / 20.0)) ** 2
    p, rel = tis.estimate_event_probability(
        lambda llr: torch.all(llr[:, S] < 0, dim=1), n=24, snr_db=snr,
        positions=S, shift=1.0, n_samples=2 ** 15, batch=2 ** 12, seed=3,
        device="cpu")
    assert rel < 0.2
    assert abs(p - exact) / exact < 0.2, (p, exact)


def test_punctured_rule():
    """Punctured LLRs are zero, the rest are not; the weight covers the
    transmitted coordinates only (punctured noise does not enter it); a
    shifted punctured position raises."""
    llr, log_w = tis.biased_awgn_llr(torch.Generator().manual_seed(7), 64,
                                     16, 3.0, positions=[4], shift=1.0,
                                     punctured=(0, 1))
    assert torch.all(llr[:, :2] == 0.0) and torch.all(llr[:, 2:] != 0.0)
    _, unpunct_w = tis.biased_awgn_llr(torch.Generator().manual_seed(7), 64,
                                       16, 3.0, positions=[4], shift=1.0)
    assert torch.equal(log_w, unpunct_w)
    for fn in (lambda: tis.biased_awgn_llr(torch.Generator(), 8, 16, 3.0,
                                           positions=[1], shift=1.0,
                                           punctured=(0, 1)),
               lambda: jis.biased_awgn_llr(jax.random.PRNGKey(7), 8, 16, 3.0,
                                           positions=[1], shift=1.0,
                                           punctured=(0, 1))):
        with pytest.raises(ValueError, match="punctured"):
            fn()


def test_decoder_level_estimate_agrees_with_jax():
    """``tests/test_importance.py``'s decoder-level estimate (PEG (48, 24)
    min-sum, dominant set, 1.5 dB, shift 1.2, 2^15 samples) from both
    packages: within four combined standard errors."""
    jdec, tdec, rep = _peg_pair()
    S = list(rep.dominant(1)[0].variables)
    kw = dict(n=48, snr_db=1.5, positions=S, shift=1.2, n_samples=2 ** 15,
              batch=2 ** 12)
    p, rel = tis.estimate_event_probability(
        tis.localized_failure(tdec, S), seed=5, device="cpu", **kw)
    inside = np.zeros(48, bool)
    inside[S] = True

    def jax_event(llr):
        wrong = jdec(llr).bits.astype(jnp.int32)
        stray = jnp.sum(jnp.where(jnp.asarray(~inside)[None], wrong, 0), 1)
        return (jnp.sum(wrong, axis=1) > 0) & (stray == 0)

    jp, jrel = jis.estimate_event_probability(
        jax_event, key=jax.random.PRNGKey(5), **kw)
    # the weights are heavy-tailed: with this seed the JAX estimate's
    # relative error is 0.71, the port's 0.12
    assert p > 0 and jp > 0 and rel < 0.25
    assert abs(p - jp) <= 4.0 * math.hypot(p * rel, jp * jrel), (p, jp)


def test_floor_estimate_is_seeded_and_summarized_as_in_jax():
    """A seed fixes the estimate; another seed draws other frames; the
    summary is the JAX package's text for the same numbers."""
    _, tdec, rep = _peg_pair()
    classes = _two_classes(rep, 2)
    kw = dict(snr_db=2.0, shift=1.5, n_samples=2 ** 11, batch=2 ** 10)
    a = tis.estimate_trapping_floor(tdec, classes, seed=4, **kw)
    b = tis.estimate_trapping_floor(tdec, classes, seed=4, **kw)
    c = tis.estimate_trapping_floor(tdec, classes, seed=9, **kw)
    assert a.per_class == b.per_class and a.per_class != c.per_class
    assert a.fer_floor == sum(m * p for m, p, _ in a.per_class.values())
    j = jis.FloorEstimate(fer_floor=a.fer_floor, per_class=a.per_class,
                          snr_db=a.snr_db)
    assert a.summary() == j.summary()
    assert a.summary().startswith("IS floor estimate @ 2.0 dB")
