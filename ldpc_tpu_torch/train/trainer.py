"""Posterior-joint training of neural decoder weights (counterpart of
``ldpc_tpu/train/trainer.py``).

All-zero-codeword AWGN batches over an SNR range, BCE-with-logits on the
negated posterior (the paper's posterior joint loss over every
iteration's posterior, or the final posterior only), gradients by autograd
through the decoder's engine with the quantizers' straight-through
estimators, and the JAX package's ``optax`` chain on ``torch.optim.Adam``:

- the global gradient norm is logged before clipping;
- ``clip_by_global_norm``: the gradients are scaled by ``max / norm``
  only where ``norm >= max`` (``torch.nn.utils.clip_grad_norm_`` divides
  by ``norm + 1e-6``, which matters at the default ``clip_threshold`` of
  1e-3);
- ``add_decayed_weights``: ``weight_decay * p`` is added to the (clipped)
  gradient before Adam, which is ``torch.optim.Adam(weight_decay=...)``
  (not AdamW);
- the learning rate of an update is the schedule at the number of updates
  made before it, so with ``warmup_steps > 0`` the first update has
  learning rate 0 (``warmup_cosine_decay_schedule`` to 1% of the peak).

Data comes from the trainer's ``torch.Generator`` on the decoder's device
(its numbers differ from ``jax.random``'s for the same seed); pass shared
LLRs to :meth:`PosteriorJointTrainer.train_step` to compare the two
packages step for step.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ldpc_tpu_torch.channel import awgn_llr
from ldpc_tpu_torch.decode.variants import Decoder, _not_ported

logger = logging.getLogger(__name__)

__all__ = ["TrainingConfig", "PosteriorJointTrainer", "posterior_joint_loss",
           "global_norm", "clip_by_global_norm", "learning_rate_schedule"]


@dataclasses.dataclass
class TrainingConfig:
    """The training options of ``ldpc_tpu.train.TrainingConfig``, each
    read: batch, epochs, peak learning rate, SNR range (dB), joint or
    final-only loss, global-norm clipping, the accuracy early stop, the
    seed, the schedule ('constant' or 'cosine': linear warmup over
    ``warmup_steps`` updates, then cosine decay to 1% of the peak at
    ``decay_steps`` updates, warmup included), punctured positions (their
    channel LLR is 0) and the L2 pull of the weights toward zero."""

    batch_size: int = 32
    num_epochs: int = 100
    learning_rate: float = 1e-3
    snr_range: Tuple[float, float] = (0.0, 6.0)
    use_posterior_training: bool = True
    use_gradient_clipping: bool = False
    clip_threshold: float = 1e-3
    early_stop_accuracy: float = 0.99
    seed: int = 0
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: Optional[int] = None
    punctured_positions: Tuple[int, ...] = ()
    weight_decay: float = 0.0


def posterior_joint_loss(weights, llr: torch.Tensor, targets: torch.Tensor,
                         *, decoder: Decoder, joint: bool):
    """BCE-with-logits on the negated posterior (positive posterior means
    bit 0, so the logit of bit 1 is ``-posterior``), averaged over every
    iteration's posterior when ``joint``, else over the final one.

    Decodes through ``decoder`` with the straight-through quantizers.
    Returns ``(loss, (final posterior, bit accuracy))``."""
    out = decoder(llr, weights, ste=True, return_trajectory=joint)
    targets = targets.to(torch.float32)
    if joint and out.posteriors_all is not None:
        logits = -out.posteriors_all            # [T, B, n]
        targets_t = targets[None].expand(logits.shape)
    else:
        logits, targets_t = -out.posterior, targets
    loss = F.binary_cross_entropy_with_logits(logits, targets_t)
    acc = (out.bits == targets.to(torch.int32)).to(torch.float32).mean()
    return loss, (out.posterior, acc)


def global_norm(grads) -> torch.Tensor:
    """``sqrt(sum of every gradient's squares)``, ``optax.global_norm``."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """``optax.clip_by_global_norm``: each gradient becomes
    ``(g / norm) * max_norm`` where ``norm >= max_norm``, else stays."""
    norm = global_norm(grads) if norm is None else norm
    return [torch.where(norm < max_norm, g, (g / norm) * max_norm)
            for g in grads]


def learning_rate_schedule(cfg: TrainingConfig):
    """The learning rate as a function of the number of updates made,
    ``optax.warmup_cosine_decay_schedule``'s (or a constant)."""
    peak = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        return lambda count: peak
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if not cfg.decay_steps:
        raise ValueError(
            "lr_schedule='cosine' needs decay_steps (total optimizer steps "
            "= num_epochs * batches_per_epoch)")
    warm, decay = cfg.warmup_steps, cfg.decay_steps - cfg.warmup_steps
    if not decay > 0:
        raise ValueError(f"decay_steps must exceed warmup_steps, got "
                         f"{cfg.decay_steps} and {warm}")
    alpha, init = 0.01, (0.0 if warm else peak)

    def lr(count: int) -> float:
        if count < warm:  # linear warmup from init to the peak
            return (init - peak) * (1 - count / warm) + peak
        c = min(count - warm, decay)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c /
                                                          decay)) + alpha)

    return lr


class PosteriorJointTrainer:
    """Train a neural decoder's weight tables (``decoder.weights``).

    The decoder's weights are the source of truth: each step starts from
    them, and each step leaves them as detached float32 tensors on the
    decoder's device, so the fused decoders and ``zoo.save_pretrained``
    take them as they are. ``mesh=`` (data-parallel training) is not
    ported."""

    def __init__(self, decoder: Decoder,
                 config: Optional[TrainingConfig] = None, mesh=None):
        if mesh is not None:
            raise _not_ported("data-parallel training (mesh=)", "parallel/")
        if all(w is None for w in decoder.weights.values()):
            raise ValueError(
                f"decoder {decoder.name!r} has no trainable weights")
        self.decoder = decoder
        self.config = config or TrainingConfig()
        self.device = decoder.device
        self._lr = learning_rate_schedule(self.config)
        self.params = {k: torch.as_tensor(w, dtype=torch.float32,
                                          device=self.device)
                       .detach().clone().requires_grad_(True)
                       for k, w in decoder.weights.items() if w is not None}
        self.optimizer = torch.optim.Adam(
            list(self.params.values()), lr=self._lr(0),
            weight_decay=self.config.weight_decay)
        self.step_count = 0   # updates made: the schedule's clock
        self._synced: Dict[str, torch.Tensor] = {}
        self.generator = torch.Generator(
            device=self.device).manual_seed(self.config.seed)
        self.training_losses: List[float] = []
        self.validation_losses: List[float] = []
        self.training_accuracies: List[float] = []
        self.gradient_norms: List[float] = []

    # -- one optimizer step ---------------------------------------------------

    def _merged(self, trainable) -> dict:
        w = dict(self.decoder.weights)
        w.update(trainable)
        return w

    def optimizer_structure(self) -> dict:
        """What shapes the optimizer's state: the optax chain's links."""
        cfg = self.config
        return dict(clip=bool(cfg.use_gradient_clipping),
                    weight_decay=bool(cfg.weight_decay),
                    lr_schedule=cfg.lr_schedule)

    def train_step(self, llr: torch.Tensor, targets: torch.Tensor):
        """One update on the batch ``llr`` [B, n] with ``targets`` [B, n]
        (the counterpart of the JAX trainer's ``_train_step``). Returns
        ``(loss, accuracy, gradient norm)`` as 0-d tensors, the norm taken
        before clipping."""
        cfg = self.config
        with torch.no_grad():  # start from the decoder's weights
            for k, p in self.params.items():
                if self.decoder.weights[k] is not self._synced.get(k):
                    p.copy_(self.decoder.weights[k])
        params = list(self.params.values())
        loss, (_, acc) = posterior_joint_loss(
            self._merged(self.params), llr, targets, decoder=self.decoder,
            joint=cfg.use_posterior_training)
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        gnorm = global_norm(grads)
        if cfg.use_gradient_clipping:
            grads = clip_by_global_norm(grads, cfg.clip_threshold, gnorm)
        for p, g in zip(params, grads):
            p.grad = g
        for group in self.optimizer.param_groups:
            group["lr"] = self._lr(self.step_count)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step_count += 1
        self._synced = {k: p.detach().clone() for k, p in self.params.items()}
        self.decoder.weights = self._merged(self._synced)
        return loss.detach(), acc, gnorm.detach()

    @torch.no_grad()
    def _eval_step(self, llr, targets):
        loss, (_, acc) = posterior_joint_loss(
            self.decoder.weights, llr, targets, decoder=self.decoder,
            joint=self.config.use_posterior_training)
        return loss, acc

    # -- data ----------------------------------------------------------------

    def _tx_mask(self) -> Optional[torch.Tensor]:
        """[n] mask: 0 at punctured positions, else 1 (None without
        puncturing)."""
        punct = self.config.punctured_positions
        if not punct:
            return None
        mask = np.ones(self.decoder.code.n, np.float32)
        mask[np.asarray(punct, np.int64)] = 0.0
        return torch.as_tensor(mask, device=self.device)

    def _channel(self, gen: torch.Generator, snrs: torch.Tensor):
        zeros = torch.zeros((snrs.shape[0], self.decoder.code.n),
                            dtype=torch.float32, device=self.device)
        llr = awgn_llr(gen, zeros, snrs)
        mask = self._tx_mask()
        return (llr if mask is None else llr * mask), zeros

    def sample(self, gen: Optional[torch.Generator] = None):
        """One training batch: all-zero codewords, each frame's SNR drawn
        uniformly in ``snr_range``. Returns (llr [B, n], targets [B, n])."""
        gen = self.generator if gen is None else gen
        lo, hi = self.config.snr_range
        u = torch.rand(self.config.batch_size, generator=gen,
                       device=self.device)
        return self._channel(gen, lo + (hi - lo) * u)

    def generate_training_data(self, num_samples: int,
                               gen: Optional[torch.Generator] = None):
        """A dataset like the reference's: all-zero codewords at SNRs
        spaced evenly over ``snr_range`` (a generator seeded with
        ``config.seed`` unless ``gen`` is given). Returns (llrs [N, n],
        targets [N, n])."""
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.config.seed)
        lo, hi = self.config.snr_range
        return self._channel(gen, torch.linspace(lo, hi, num_samples,
                                                 device=self.device))

    # -- the reference's API ------------------------------------------------

    def compute_loss(self, llr, targets) -> float:
        """The loss on (llr, targets) with the current weights."""
        loss, _ = self._eval_step(torch.atleast_2d(llr),
                                  torch.atleast_2d(targets))
        return float(loss)

    def train_epoch(self, gen: Optional[torch.Generator] = None,
                    batches_per_epoch: int = 1):
        """``batches_per_epoch`` steps on sampled batches (from ``gen``, or
        the trainer's generator); returns (mean loss, mean accuracy, mean
        gradient norm)."""
        stats = [self.train_step(*self.sample(gen))
                 for _ in range(batches_per_epoch)]
        loss, acc, gnorm = (float(torch.stack(s).mean())
                            for s in zip(*stats))
        return loss, acc, gnorm

    def train(self, num_samples: int = 3200, val_samples: int = 640,
              verbose: bool = True) -> Dict:
        """Epochs of ``num_samples // batch_size`` batches with a
        validation loss after each, stopping early once the training
        accuracy exceeds ``early_stop_accuracy``."""
        cfg = self.config
        batches_per_epoch = max(1, num_samples // cfg.batch_size)
        val_llr, val_tgt = self.generate_training_data(val_samples,
                                                       self.generator)
        t0 = time.time()
        for epoch in range(cfg.num_epochs):
            loss, acc, gnorm = self.train_epoch(None, batches_per_epoch)
            vloss, vacc = self._eval_step(val_llr, val_tgt)
            self.training_losses.append(loss)
            self.training_accuracies.append(acc)
            self.gradient_norms.append(gnorm)
            self.validation_losses.append(float(vloss))
            if verbose:
                logger.info(
                    "epoch %d/%d: loss=%.4f acc=%.4f val_loss=%.4f "
                    "val_acc=%.4f |grad|=%.3e", epoch + 1, cfg.num_epochs,
                    loss, acc, float(vloss), float(vacc), gnorm)
            if acc > cfg.early_stop_accuracy:
                if verbose:
                    logger.info("early stop: accuracy %.4f > %.2f", acc,
                                cfg.early_stop_accuracy)
                break
        return {
            "training_losses": self.training_losses,
            "validation_losses": self.validation_losses,
            "training_accuracies": self.training_accuracies,
            "gradient_norms": self.gradient_norms,
            "train_time": time.time() - t0,
            "final_weights": self.decoder.weights,
        }

    def validate(self, llr=None, targets=None) -> Tuple[float, float]:
        """(loss, bit accuracy) on held-out data: by default 640 frames
        from a generator seeded with ``seed + 1``."""
        if llr is None:
            llr, targets = self.generate_training_data(
                640, torch.Generator(device=self.device).manual_seed(
                    self.config.seed + 1))
        loss, acc = self._eval_step(llr, targets)
        return float(loss), float(acc)

    def plot_training_history(self, path: str = "training_history.png"):
        """Loss, accuracy and gradient-norm panels (needs matplotlib)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        axes[0].plot(self.training_losses, label="train")
        axes[0].plot(self.validation_losses, label="val")
        axes[0].set_xlabel("epoch"); axes[0].set_ylabel("BCE loss")
        axes[0].legend(); axes[0].set_title("Loss")
        axes[1].plot(self.training_accuracies)
        axes[1].set_xlabel("epoch"); axes[1].set_ylabel("bit accuracy")
        axes[1].set_title("Accuracy")
        axes[2].semilogy(self.gradient_norms)
        axes[2].set_xlabel("epoch"); axes[2].set_ylabel("global grad norm")
        axes[2].set_title("Gradient norms")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
