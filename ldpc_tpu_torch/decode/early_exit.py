"""Two-checkpoint early-exit decoding (counterpart of
``ldpc_tpu/decode/early_exit.py``).

The fused decodes (layered and flooding) check the syndrome once, after
the final iteration. The {t1, T} two-checkpoint decoder restores early
termination around it:

1. stage 1 decodes every frame for ``t1`` iterations; frames whose
   syndrome passes there are done;
2. up to ``survivor_budget`` unconverged frames, ranked by
   ``cumsum(~success) - 1``, are gathered into a fixed S-row batch (unused
   rows are zero LLRs) and decoded at full depth T;
3. their outputs are scattered back over the stage-1 outputs.

Gather and scatter are index operations on the device with fixed shapes:
no host synchronisation and no data-dependent shape. Frames past the
budget keep their stage-1 output with ``success=False``; the returned
``n_survivors`` (a 0-d device tensor) tells the caller the budget was
exceeded.
"""

from __future__ import annotations

import dataclasses

import torch

from ldpc_tpu_torch.decode.engine import DecodeResult

__all__ = ["make_two_checkpoint_decoder", "two_checkpoint_stages",
           "gather_survivors"]


def two_checkpoint_stages(decoder, t1: int):
    """The two decodes of the {t1, T} schedule of a fused-kernel QC decoder
    (``qc_options={'fused': True, ...}``): ``(stage1, stage2)``, each
    ``(llr, weights) -> DecodeResult`` taking the decoder's full [T, ...]
    weights; stage 1 decodes for ``t1`` iterations with its single check
    there, stage 2 for T."""
    T = decoder.max_iterations
    if not 0 < t1 < T:
        raise ValueError(f"need 0 < t1={t1} < max_iterations={T}")
    # Decoder.truncated refuses fused decoders (their check schedule is
    # {T}), so truncate without the options and re-attach them: stage 1
    # runs the fused decode with its single check at t1
    opts = dict(decoder.qc_options or {})
    opts.pop("check_every", None)
    opts.pop("unroll", None)
    short = dataclasses.replace(decoder, qc_options=None).truncated(t1)
    short = dataclasses.replace(short, qc_options=opts or None)
    full = dataclasses.replace(decoder, qc_options=opts or None)

    def stage1(llr, w):
        return short(llr, {k: (None if a is None else a[:t1])
                           for k, a in w.items()})

    return stage1, full


def gather_survivors(llr: torch.Tensor, success: torch.Tensor, S: int):
    """The first ``S`` frames of ``llr`` [B, n] whose ``success`` is False,
    in frame order, as a fixed [S, n] batch (zero rows after the last).
    Returns ``(rows, slot_frame, valid, in_budget, n_survivors)``: the
    frame of each slot (0 past the last survivor), which slots hold one,
    which frames got a slot, and the survivor count (0-d int32)."""
    B, dev = llr.shape[0], llr.device
    unconv = ~success
    n_surv = unconv.sum(dtype=torch.int32)
    rank = torch.cumsum(unconv.to(torch.int64), 0) - 1
    inbud = unconv & (rank < S)
    # frames outside the budget all land on the spare slot S
    slots = torch.zeros(S + 1, dtype=torch.int64, device=dev)
    slots.scatter_(0, torch.where(inbud, rank, S),
                   torch.arange(B, dtype=torch.int64, device=dev))
    slot_frame = slots[:S]
    valid = torch.arange(S, device=dev) < torch.clamp_max(n_surv, S)
    rows = torch.where(valid[:, None], llr[slot_frame],
                       torch.zeros((), dtype=llr.dtype, device=dev))
    return rows, slot_frame, valid, inbud, n_surv


def make_two_checkpoint_decoder(decoder, *, t1: int, survivor_budget: int):
    """Build ``fn(llr, weights=None) -> (DecodeResult, n_survivors)`` with
    the {t1, T} checkpoint schedule for a fused-kernel QC decoder
    (``qc_options={'fused': True, ...}``)."""
    T = decoder.max_iterations
    stage1, full = two_checkpoint_stages(decoder, t1)
    S = int(survivor_budget)
    if S <= 0:
        raise ValueError(f"survivor_budget must be positive, got {S}")

    def _merge(dst, src2, tgt, src_row, any_valid):
        # dst[tgt[s]] = src2[src_row[s]] for every slot. Slots past the
        # last survivor repeat slot 0's target with slot 0's row, so the
        # duplicate writes carry identical data; with no survivors at all
        # every slot rewrites frame 0 with its own stage-1 row. dst is a
        # fresh stage-1 output, updated in place.
        data = torch.where(any_valid.view(-1, *([1] * (dst.ndim - 1))),
                           src2[src_row], dst[tgt])
        dst.index_copy_(0, tgt, data)
        return dst

    def fn(llr: torch.Tensor, weights=None):
        w = decoder.weights if weights is None else weights
        out1 = stage1(llr, w)
        llr2, slot_frame, valid, inbud, n_surv = gather_survivors(
            llr, out1.success, S)
        out2 = full(llr2, w)
        ar = torch.arange(S, device=llr.device)

        any_valid = valid[0]
        tgt = torch.where(valid, slot_frame, slot_frame[0])
        src_row = torch.where(valid, ar, 0)
        success = _merge(out1.success, out2.success, tgt, src_row,
                         any_valid)
        if out1.posterior is None:
            bits = _merge(out1.bits, out2.bits, tgt, src_row, any_valid)
            post = None
        else:
            post = _merge(out1.posterior, out2.posterior, tgt, src_row,
                          any_valid)
            bits = (post < 0).to(torch.int32)
        iterations = torch.where(inbud, torch.full_like(out1.iterations, T),
                                 out1.iterations)
        return DecodeResult(bits=bits, posterior=post,
                            iterations=iterations, success=success), n_surv

    return fn
