"""BPSK/AWGN channel (counterpart of ``ldpc_tpu/channel.py``).

Bit 0 maps to +1, so ``llr = 2r/sigma^2`` and ``bit = llr < 0`` agree:
all-zero codewords give positive LLRs. Randomness comes from an explicit
``torch.Generator``; its numbers differ from JAX's threefry for the same
seed, so parity with the JAX package is statistical only. The Gaussian
draws follow ``jax.random.normal``'s float32 transform
(:func:`normal_from_bits`), so both packages' channels have one
distribution: the frame error rate of a quantized decoder can depend on
it (``torch.randn``'s draws moved two precoded-PBRL RCQ arms' FER at 2.0
dB away from the JAX package's on an H100; PERF.md).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["bpsk_modulate", "standard_normal", "normal_from_bits",
           "awgn_llr", "simulate_awgn_channel", "puncture_llr"]

# jax.random.normal's uniform: u on [nextafter(-1, 0), 1), float32
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def bpsk_modulate(bits: torch.Tensor) -> torch.Tensor:
    """Map bit 0 -> +1, bit 1 -> -1 (float32)."""
    return 1.0 - 2.0 * bits.to(torch.float32)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Standard normal float32 draws from ``bits``, integers in [0, 2^23),
    as ``jax.random.normal`` makes them from the top 23 of its 32 random
    bits: the uniform ``u = max(lo, bits * 2^-23 * 2 + lo)`` with ``lo =
    nextafter(-1, 0)`` (a 2^-22 grid), then ``sqrt(2) erfinv(u)``."""
    u = torch.clamp_min(bits.to(torch.float32) * 2.0 ** -23 * 2.0 + _LO,
                        _LO)
    return math.sqrt(2.0) * torch.erfinv(u)


def standard_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` on ``device`` (the
    generator's), made by :func:`normal_from_bits`."""
    return normal_from_bits(torch.randint(0, 2 ** 23, tuple(shape),
                                          generator=gen, dtype=torch.int32,
                                          device=device))


def awgn_llr(gen: torch.Generator, codewords: torch.Tensor, snr_db,
             dtype=torch.float32) -> torch.Tensor:
    """Transmit ``codewords`` [..., n] over AWGN at ``snr_db`` and return
    channel LLRs on the codewords' device (which must be the generator's).

    ``snr_db`` is a scalar or broadcastable to the leading batch dims (e.g.
    shape [B] for a per-sample SNR). ``sigma^2 = 10^(-snr/10)``,
    ``llr = 2 r / sigma^2``."""
    device = codewords.device
    snr = torch.as_tensor(snr_db, dtype=torch.float32, device=device)
    noise_power = 10.0 ** (-snr / 10.0)
    if noise_power.ndim:  # per-sample SNR broadcasts over the bit axis
        noise_power = noise_power[..., None]
    symbols = bpsk_modulate(codewords)
    noise = standard_normal(gen, codewords.shape, device)
    received = symbols + torch.sqrt(noise_power) * noise
    return (2.0 * received / noise_power).to(dtype)


def simulate_awgn_channel(gen: torch.Generator, codeword: torch.Tensor,
                          snr_db) -> torch.Tensor:
    """Reference-named wrapper (``ldpc_decoder.py:286``) of
    :func:`awgn_llr`: one codeword (or a batch), an explicit generator."""
    return awgn_llr(gen, codeword, snr_db)


def puncture_llr(llr: torch.Tensor, positions) -> torch.Tensor:
    """Zero the channel LLRs at punctured bit positions."""
    positions = np.asarray(positions, dtype=np.int64)
    if positions.size == 0:
        return llr
    mask = torch.ones(llr.shape[-1], dtype=llr.dtype, device=llr.device)
    mask[torch.as_tensor(positions, device=llr.device)] = 0.0
    return llr * mask
