"""Carry weights across from the JAX package.

``make_decoder`` in the port draws its initial weights from a
``torch.Generator``, so its values differ from ``ldpc_tpu``'s
``jax.random`` ones for the same seed. To run both packages on the same
decoder, convert the JAX decoder's weights with :func:`weights_from_numpy`
and pass them to the port's decoder (``Decoder.replace_weights`` or the
``weights=`` argument of a call).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ldpc_tpu_torch.decode.variants import resolve_device

__all__ = ["weights_from_numpy"]


def weights_from_numpy(weights, device="cuda"
                       ) -> Dict[str, Optional[torch.Tensor]]:
    """``{"beta": array | None, "alpha": array | None}`` (as
    ``np.asarray(jax_decoder.weights[k])`` yields them) -> the port's dict
    of float32 tensors on ``device`` (None entries stay None). The default
    is the card, as for ``make_decoder``; without one this raises unless
    ``device="cpu"`` is passed."""
    device = resolve_device(device)
    return {k: (None if v is None else
                torch.as_tensor(np.asarray(v, dtype=np.float32),
                                device=device))
            for k, v in weights.items()}
