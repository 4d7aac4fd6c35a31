"""Save and resume a trainer (counterpart of the trainer half of
``ldpc_tpu/utils/checkpoint.py``).

A checkpoint is a directory holding ``trainer.pt`` (``torch.save`` of the
decoder's trainable weights, the optimizer's state, the schedule's update
count, the optimizer's structure and the epoch) and ``history.json`` (the
loss, accuracy and gradient-norm lists). It is read back with
``torch.load(weights_only=True)``. The JAX package's orbax checkpoints are
a different format and are not read.
"""

from __future__ import annotations

import json
import os

import torch

__all__ = ["save_trainer_checkpoint", "load_trainer_checkpoint"]

_STATE = "trainer.pt"
_HISTORY = ("training_losses", "validation_losses", "training_accuracies",
            "gradient_norms")


def save_trainer_checkpoint(path: str, trainer, epoch: int) -> str:
    """Persist a :class:`~ldpc_tpu_torch.train.PosteriorJointTrainer`'s
    resumable state into the directory ``path``; returns ``path``."""
    os.makedirs(path, exist_ok=True)
    torch.save({
        "weights": {k: v.detach() for k, v in trainer.decoder.weights.items()
                    if v is not None},
        "optimizer": trainer.optimizer.state_dict(),
        "structure": trainer.optimizer_structure(),
        "step_count": int(trainer.step_count),
        "epoch": int(epoch),
    }, os.path.join(path, _STATE))
    with open(os.path.join(path, "history.json"), "w") as f:
        json.dump({k: getattr(trainer, k) for k in _HISTORY}, f)
    return path


def load_trainer_checkpoint(path: str, trainer) -> int:
    """Restore a checkpoint of :func:`save_trainer_checkpoint` into
    ``trainer``; returns the saved epoch. A checkpoint whose weights
    differ in names or shapes from the trainer's decoder, or whose
    optimizer differs in structure (clipping, weight decay, schedule) or
    in its state's shapes, raises ``ValueError`` and changes nothing."""
    state = torch.load(os.path.join(path, _STATE), map_location=trainer.device,
                       weights_only=True)
    w = dict(trainer.decoder.weights)
    mine = {k for k, v in w.items() if v is not None}
    if set(state["weights"]) != mine:
        raise ValueError(
            f"checkpoint weights {sorted(state['weights'])} do not match "
            f"this trainer's decoder's {sorted(mine)}; refusing to resume "
            "into a mismatched decoder")
    for k, v in state["weights"].items():
        if tuple(v.shape) != tuple(w[k].shape):
            raise ValueError(
                f"checkpoint weight {k!r} has shape {tuple(v.shape)} but "
                f"this trainer's decoder expects {tuple(w[k].shape)}; "
                "refusing to resume into a mismatched decoder")
        w[k] = v.to(device=trainer.device, dtype=torch.float32)
    if state["structure"] != trainer.optimizer_structure():
        raise ValueError(
            f"optimizer in {path} is {state['structure']}, this trainer's "
            f"is {trainer.optimizer_structure()}; refusing to resume with a "
            "different optimizer")
    params = [p for g in trainer.optimizer.param_groups for p in g["params"]]
    saved = state["optimizer"]
    ids = [i for g in saved["param_groups"] for i in g["params"]]
    if len(ids) != len(params) or any(
            tuple(t.shape) != tuple(params[i].shape)
            for i, s in saved["state"].items() for key, t in s.items()
            if key != "step"):
        raise ValueError(
            f"optimizer state in {path} does not fit this trainer's "
            "weights; refusing to silently reinitialize")
    trainer.optimizer.load_state_dict(saved)
    trainer.step_count = state["step_count"]
    trainer.decoder.weights = w
    hist_path = os.path.join(path, "history.json")
    if os.path.exists(hist_path):
        with open(hist_path) as f:
            hist = json.load(f)
        for k in _HISTORY:
            setattr(trainer, k, hist[k])
    return state["epoch"]
