"""Systematic GF(2) encoding for any LDPCCode (counterpart of
``ldpc_tpu/encode.py``).

Gaussian elimination over GF(2) on H (bit-packed numpy rows, a copy of the
JAX package's ``gf2_row_reduce``) finds ``r = rank(H)`` pivot columns; the
other ``k = n - r`` columns are the information set. Encoding solves
``H c^T = 0`` for the pivot bits: ``c[pivots] = (u @ P^T) mod 2`` with the
dense {0,1} matrix ``P = reduce(H)[:, info]``. On the tensor's device that
is one float32 ``[B, k] x [k, r]`` matmul, a remainder by 2 and two index
scatters. The operands are 0/1 and every sum stays below 2^24, so float32
is exact, and so is TF32; bf16 or fp16 would not be (sums of thousands of
terms lose their low bits there).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldpc_tpu_torch.codes import LDPCCode

__all__ = ["Encoder", "make_encoder", "gf2_row_reduce"]


def gf2_row_reduce(H: np.ndarray):
    """Reduced row-echelon form of a {0,1} matrix over GF(2).

    Returns ``(R, pivot_cols)`` with ``R`` dense uint8 in RREF (each
    pivot column has a single 1). Rows are bit-packed into uint64 words
    internally, so elimination on the (1280, 9472) bench matrix takes
    ~0.1 s instead of tens of seconds.
    """
    H = np.asarray(H, dtype=np.uint8)
    m, n = H.shape
    W = (n + 63) // 64
    packed = np.zeros((m, W), dtype=np.uint64)
    bits = np.packbits(H, axis=1, bitorder="little")
    packed.view(np.uint8)[:, :bits.shape[1]] = bits

    pivots = []
    row = 0
    for col in range(n):
        if row >= m:
            break
        w, b = col >> 6, np.uint64(1) << np.uint64(col & 63)
        hot = (packed[row:, w] & b) != 0
        if not hot.any():
            continue
        sel = row + int(np.argmax(hot))
        if sel != row:
            packed[[row, sel]] = packed[[sel, row]]
        # eliminate this column from every OTHER row (full RREF)
        others = (packed[:, w] & b) != 0
        others[row] = False
        packed[others] ^= packed[row]
        pivots.append(col)
        row += 1

    unpacked = np.unpackbits(packed.view(np.uint8), axis=1,
                             bitorder="little")[:, :n]
    return unpacked.astype(np.uint8), np.asarray(pivots, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class Encoder:
    """Systematic encoder for one code.

    ``k_eff = n - rank(H)`` is the true code dimension and can differ
    from the nominal ``code.k`` in either direction: redundant checks
    make it larger, extra independent checks smaller (the reference's
    "(7,4)" test code has four independent rows, so it is a (7,3) code).
    """

    code: LDPCCode
    info_positions: np.ndarray    # [k_eff] columns carrying payload bits
    pivot_positions: np.ndarray   # [r] columns carrying parity bits
    _P: np.ndarray                # [r, k_eff] {0,1} parity map

    @property
    def k_eff(self) -> int:
        return len(self.info_positions)

    def _on(self, device: torch.device, key: str, make):
        """The device copy ``key`` of a constant, uploaded once per device
        (P is ~40 MB on the bench code)."""
        cache = self.__dict__.get("_dev")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_dev", cache)
        k = (key, str(device))
        if k not in cache:
            cache[k] = make().to(device)
        return cache[k]

    def _constants(self, device):
        P_T = self._on(device, "P_T", lambda: torch.from_numpy(
            self._P.T.astype(np.float32)))
        info = self._on(device, "info",
                        lambda: torch.from_numpy(self.info_positions))
        piv = self._on(device, "piv",
                       lambda: torch.from_numpy(self.pivot_positions))
        return P_T, info, piv

    def __call__(self, info_bits: torch.Tensor) -> torch.Tensor:
        """Encode [B, k_eff] (or [k_eff]) info bits -> [B, n] int32
        codewords, on the bits' device."""
        u = torch.as_tensor(info_bits)
        squeeze = u.ndim == 1
        if squeeze:
            u = u[None]
        if u.shape[-1] != self.k_eff:
            raise ValueError(
                f"expected {self.k_eff} info bits, got {u.shape[-1]}")
        P_T, info, piv = self._constants(u.device)
        uf = u.to(torch.float32)
        parity = torch.remainder(uf @ P_T, 2.0).to(torch.int32)
        c = torch.zeros((u.shape[0], self.code.n), dtype=torch.int32,
                        device=u.device)
        c[:, info] = uf.to(torch.int32)
        c[:, piv] = parity
        return c[0] if squeeze else c

    def syndrome_ok(self, codewords: torch.Tensor) -> torch.Tensor:
        """Per-frame parity check with the dense H (bool [B])."""
        c = torch.as_tensor(codewords)
        H_T = self._on(c.device, "H_T", lambda: torch.from_numpy(
            np.asarray(self.code.H, np.float32).T.copy()))
        s = torch.remainder(c.to(torch.float32) @ H_T, 2.0)
        return torch.all(s == 0, dim=-1)


def make_encoder(code: LDPCCode) -> Encoder:
    """Build the systematic encoder (one GF(2) elimination of H)."""
    R, pivots = gf2_row_reduce(code.H)
    r = len(pivots)
    info = np.setdiff1d(np.arange(code.n), pivots)
    P = R[:r][:, info]  # row i of RREF: c[pivot_i] = sum(P[i] * u) mod 2
    return Encoder(code=code, info_positions=info, pivot_positions=pivots,
                   _P=P.astype(np.uint8))
