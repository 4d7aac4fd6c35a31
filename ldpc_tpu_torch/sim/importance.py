"""Mean-shift importance sampling for error-floor estimation (counterpart
of ``ldpc_tpu/sim/importance.py``).

The floor is dominated by a few small trapping-set classes
(``design.trapping_sets``), and the failures that matter lie where the
channel pushes exactly those variables toward the wrong symbol. So the
all-zero codeword (BPSK +1) is sent with the noise mean shifted by
``-shift`` on the target set's variables, and each frame is weighted by
the Gaussian likelihood ratio ``w = exp((2 d.n - |d|^2) / (2 sigma^2))``
(``d`` the shift vector, ``n`` the drawn noise), which makes
``E_biased[1{event} w] = P_unbiased[event]``. A class contributes
``multiplicity x P[the decoder fails localized on the exemplar]``; the
sum over classes is the union-bound floor (Richardson, "Error floors of
LDPC codes", Allerton 2003).

The arithmetic is the JAX package's: float32 noise drawn with
``jax.random.normal``'s transform (``channel.standard_normal``), float32
``log_w`` and float32 ``exp``, then the sums in float64 (on the device,
one host read per batch). Randomness comes from ``torch.Generator``s
derived from a ``seed`` (one per batch, one seed per class) in place of
JAX's key splits, so estimates agree with the JAX package's
statistically; on equal LLRs the event indicators are equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ldpc_tpu_torch.channel import puncture_llr, standard_normal
from ldpc_tpu_torch.decode.variants import resolve_device

__all__ = ["biased_awgn_llr", "biased_llr_from_noise",
           "estimate_event_probability", "estimate_trapping_floor",
           "localized_failure", "FloorEstimate"]


def _derived(seed: int, index: int) -> int:
    """A 64-bit seed for draw ``index`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0])


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def biased_llr_from_noise(noise: torch.Tensor, snr_db: float, positions,
                          shift: float, punctured=None,
                          dtype=torch.float32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(llr [B, n], log_w [B])`` of :func:`biased_awgn_llr` from its
    scaled float32 noise ``noise`` (standard normal times sigma), on the
    noise's device. Every operation rounds the same on the card and on
    the CPU: the shifted noise is summed position by position in order
    and the divisions are IEEE divisions by a float32 tensor."""
    positions = np.asarray(positions, dtype=np.int64)
    if punctured is not None and np.intersect1d(
            positions, np.asarray(punctured)).size:
        raise ValueError("cannot shift punctured (untransmitted) positions")
    sigma2 = 10.0 ** (-float(snr_db) / 10.0)
    shift = float(shift)
    recv = 1.0 + noise
    pos = torch.as_tensor(positions, device=noise.device)
    recv[:, pos] += _f32(-shift, noise)
    # d.n over the shifted coordinates, |d|^2 = a * shift^2
    dn = torch.zeros(noise.shape[0], dtype=torch.float32, device=noise.device)
    for p in positions:
        dn = dn + noise[:, p]
    dn = shift * dn
    log_w = torch.div(2.0 * dn - _f32(len(positions) * shift ** 2, noise),
                      _f32(2.0 * sigma2, noise))
    llr = torch.div(2.0 * recv, _f32(sigma2, noise)).to(dtype)
    if punctured is not None:
        llr = puncture_llr(llr, punctured)
    return llr, log_w


def biased_awgn_llr(gen: torch.Generator, batch: int, n: int, snr_db: float,
                    positions, shift: float, punctured=None,
                    dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-zero-codeword AWGN LLRs with the noise mean shifted by
    ``-shift`` at ``positions``; returns ``(llr [B, n], log_w [B])`` on
    the generator's device.

    ``exp(log_w)`` is the per-frame likelihood ratio of the true channel
    to the biased one. Conventions as ``channel.awgn_llr`` (bit 0 -> +1,
    ``llr = 2 r / sigma^2``). ``punctured``: positions never transmitted;
    their LLRs are zeroed after the weight is computed (the weight covers
    only transmitted coordinates), and shifting one raises.
    """
    sigma2 = 10.0 ** (-float(snr_db) / 10.0)
    noise = standard_normal(gen, (batch, n), gen.device) * torch.sqrt(
        torch.full((), sigma2, dtype=torch.float32, device=gen.device))
    return biased_llr_from_noise(noise, snr_db, positions, shift,
                                 punctured=punctured, dtype=dtype)


def estimate_event_probability(
    event_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    n: int,
    snr_db: float,
    positions,
    shift: float,
    n_samples: int = 2 ** 16,
    batch: int = 2 ** 12,
    seed: int = 0,
    punctured=None,
    device="cuda",
) -> Tuple[float, float]:
    """IS estimate of ``P[event]`` under the true channel.

    ``event_fn(llr [B, n]) -> bool [B]`` defines the event. Batch ``i``
    draws from a generator on ``device`` seeded from ``(seed, i)``.
    Returns ``(p_hat, rel_std)``: the estimate and its relative standard
    error (std of the weighted indicator / (p_hat sqrt(N))); a rel_std
    near 1/sqrt(hits) means the shift missed the event region.
    """
    device = resolve_device(device)
    total = 0.0
    total_sq = 0.0
    count = 0
    i = 0
    while count < n_samples:
        b = min(batch, n_samples - count)
        gen = torch.Generator(device=device).manual_seed(_derived(seed, i))
        llr, log_w = biased_awgn_llr(gen, b, n, snr_db, positions, shift,
                                     punctured=punctured)
        ind = event_fn(llr)
        vals = torch.where(ind, torch.exp(log_w), 0.0).to(torch.float64)
        s, sq = torch.stack([vals.sum(), (vals * vals).sum()]).tolist()
        total += s
        total_sq += sq
        count += b
        i += 1
    p = total / count
    var = max(total_sq / count - p ** 2, 0.0)
    rel = float(np.sqrt(var / count) / p) if p > 0 else float("inf")
    return p, rel


@dataclasses.dataclass
class FloorEstimate:
    """Union-bound floor estimate: sum over classes of
    multiplicity x P[localized failure on the class exemplar]."""

    fer_floor: float
    per_class: dict          # {(a, b): (multiplicity, p_hat, rel_std)}
    snr_db: float

    def summary(self) -> str:
        lines = [f"IS floor estimate @ {self.snr_db} dB: "
                 f"FER ~ {self.fer_floor:.3e}"]
        for (a, b), (m, p, rel) in sorted(self.per_class.items(),
                                          key=lambda kv: -kv[1][0] * kv[1][1]):
            lines.append(f"  ({a},{b}) x{m}: p={p:.3e} (rel_std {rel:.2f})"
                         f" -> {m * p:.3e}")
        return "\n".join(lines)


def localized_failure(decoder, members, localized: bool = True
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The event of :func:`estimate_trapping_floor` for one exemplar: the
    decoder fails with every wrong bit inside ``members``
    (``localized=False``: any frame error). Returns ``event(llr) -> bool
    [B]`` on the LLRs' device."""
    inside = np.zeros(decoder.code.n, bool)
    inside[np.asarray(members, dtype=np.int64)] = True
    outside = torch.from_numpy(~inside).to(decoder.device)

    def event(llr):
        out = decoder(llr)
        wrong = out.bits.to(torch.int32)
        any_wrong = wrong.sum(dim=1) > 0
        if not localized:
            return any_wrong
        stray = torch.where(outside.to(llr.device)[None, :], wrong, 0)
        return any_wrong & (stray.sum(dim=1) == 0)

    return event


def estimate_trapping_floor(
    decoder,
    classes: Sequence[Tuple[Tuple[int, int], int, Sequence[int]]],
    *,
    snr_db: float,
    shift: float = 2.0,
    n_samples: int = 2 ** 15,
    batch: int = 2 ** 11,
    localized: bool = True,
    seed: int = 1,
    punctured=None,
) -> FloorEstimate:
    """Floor contribution of the given trapping-set classes, sampled on
    the decoder's device.

    ``classes``: [((a, b), multiplicity, exemplar_variables), ...], e.g.
    from a ``TrappingSetReport``'s ``class_counts()`` and one exemplar per
    class (QC orbits share one probability by symmetry). Class ``j``
    samples with the seed derived from ``(seed, j)``. ``localized=True``
    counts a frame only when the decoder fails with every residual bit
    error inside the exemplar set; ``localized=False`` counts any frame
    error (an upper-bound diagnostic that double-counts across classes).

    ``shift`` ~ 2/sigma-ish pushes the exemplar's bits to the wrong side
    of the decision boundary; tune until ``rel_std`` is small (<0.1 is
    excellent, >1 means the bias missed the failure region).
    """
    n = decoder.code.n
    per_class = {}
    fer = 0.0
    for j, (ab, mult, members) in enumerate(classes):
        members = np.asarray(sorted(int(v) for v in members), np.int64)
        p, rel = estimate_event_probability(
            localized_failure(decoder, members, localized), n=n,
            snr_db=snr_db, positions=members, shift=shift,
            n_samples=n_samples, batch=batch, seed=_derived(seed, j),
            punctured=punctured, device=decoder.device)
        per_class[tuple(ab)] = (int(mult), p, rel)
        fer += mult * p
    return FloorEstimate(fer_floor=fer, per_class=per_class, snr_db=snr_db)
