"""BPSK/AWGN channel (counterpart of ``ldpc_tpu/channel.py``).

Bit 0 maps to +1, so ``llr = 2r/sigma^2`` and ``bit = llr < 0`` agree:
all-zero codewords give positive LLRs. Randomness comes from an explicit
``torch.Generator``; its numbers differ from JAX's threefry for the same
seed, so parity with the JAX package is statistical only.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bpsk_modulate", "awgn_llr", "puncture_llr"]


def bpsk_modulate(bits: torch.Tensor) -> torch.Tensor:
    """Map bit 0 -> +1, bit 1 -> -1 (float32)."""
    return 1.0 - 2.0 * bits.to(torch.float32)


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
    noise = torch.randn(codewords.shape, generator=gen, dtype=torch.float32,
                        device=device)
    received = symbols + torch.sqrt(noise_power) * noise
    return (2.0 * received / noise_power).to(dtype)


def puncture_llr(llr: torch.Tensor, positions) -> torch.Tensor:
    """Zero the channel LLRs at punctured bit positions."""
    positions = np.asarray(positions, dtype=np.int64)
    if positions.size == 0:
        return llr
    mask = torch.ones(llr.shape[-1], dtype=llr.dtype, device=llr.device)
    mask[torch.as_tensor(positions, device=llr.device)] = 0.0
    return llr * mask
