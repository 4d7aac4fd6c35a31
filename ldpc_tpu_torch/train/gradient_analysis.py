"""Per-sample gradient-norm statistics (counterpart of
``ldpc_tpu/train/gradient_analysis.py``): the distribution of per-frame
gradient norms through the unrolled decoder, for the posterior-joint loss
and the final-posterior loss, to show the paper's gradient explosion and
its fix.

The per-sample gradients come from ``torch.func.vmap`` of
``torch.func.grad`` over the decoder's weight tables: one batched decode
and one batched backward for all frames, not a loop of ``backward()``
calls.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from ldpc_tpu_torch.channel import awgn_llr
from ldpc_tpu_torch.decode.variants import Decoder
from ldpc_tpu_torch.train.trainer import posterior_joint_loss

logger = logging.getLogger(__name__)

__all__ = ["GradientExplosionAnalyzer"]


class GradientExplosionAnalyzer:
    """Per-sample gradient-norm statistics for a neural decoder."""

    def __init__(self, decoder: Decoder):
        if all(w is None for w in decoder.weights.values()):
            raise ValueError("decoder has no trainable weights to analyze")
        self.decoder = decoder

    def _per_sample_norms(self, llr: torch.Tensor, joint: bool
                          ) -> np.ndarray:
        """The global gradient norm of each frame's loss, [N] float32."""
        dec = self.decoder
        trainable = {k: w.detach() for k, w in dec.weights.items()
                     if w is not None}
        frozen = {k: w for k, w in dec.weights.items() if w is None}

        def single_loss(tr, one_llr):
            w = dict(frozen)
            w.update(tr)
            loss, _ = posterior_joint_loss(
                w, one_llr[None], torch.zeros_like(one_llr)[None],
                decoder=dec, joint=joint)
            return loss

        grads = torch.func.vmap(torch.func.grad(single_loss),
                                in_dims=(None, 0))(trainable, llr)
        sq = sum(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1)
                 for g in grads.values())
        return torch.sqrt(sq).cpu().numpy()

    def analyze(self, num_samples: int = 64, snr_db: float = 2.0,
                seed: int = 0, compare_final_only: bool = True) -> Dict:
        """Per-sample gradient norms on all-zero-codeword AWGN LLRs (from a
        generator seeded with ``seed`` on the decoder's device), for the
        posterior-joint loss and, optionally, the final-only loss: each
        as ``mean``, ``std``, ``max``, ``min``, ``p99`` and ``norms``."""
        dev = self.decoder.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        llr = awgn_llr(gen, torch.zeros((num_samples, self.decoder.code.n),
                                        device=dev), snr_db)

        def stats(norms: np.ndarray) -> Dict:
            return {
                "mean": float(norms.mean()),
                "std": float(norms.std()),
                "max": float(norms.max()),
                "min": float(norms.min()),
                "p99": float(np.percentile(norms, 99)),
                "norms": norms.tolist(),
            }

        out = {"posterior_joint": stats(self._per_sample_norms(llr, True))}
        if compare_final_only:
            out["final_only"] = stats(self._per_sample_norms(llr, False))
        logger.info(
            "gradient norms @ %.1f dB: joint mean=%.3e max=%.3e%s",
            snr_db, out["posterior_joint"]["mean"],
            out["posterior_joint"]["max"],
            (f"; final-only mean={out['final_only']['mean']:.3e} "
             f"max={out['final_only']['max']:.3e}")
            if compare_final_only else "")
        return out

    def plot_gradient_analysis(self, results: Dict,
                               path: str = "gradient_analysis.png"):
        """Histogram of per-sample gradient norms (needs matplotlib)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4.5))
        for name, st in results.items():
            ax.hist(st["norms"], bins=30, alpha=0.6, label=name)
        ax.set_xlabel("per-sample gradient norm")
        ax.set_ylabel("count")
        ax.set_title(f"Gradient norms — {self.decoder.name}")
        ax.legend()
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
