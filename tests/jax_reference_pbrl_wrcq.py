"""The trained W-OMS-RCQ tables of ``experiments/pbrl_wrcq.py`` as numpy:
reads the seven orbax checkpoints ``experiments/pbrl_wrcq_ck/orcq_*``
(``hand``, ``dde``, ``ref2``, ``ref3``, ``ref3it``: beta [10, 2], alpha
[10, 9]; the per-layer ``ref2pl``, ``ref3pl``: beta [10, 50], alpha
[10, 225]) with ``ldpc_tpu.utils.checkpoint.load_checkpoint`` and writes
them to ``ldpc_tpu_torch/cli/pbrl_wrcq_tables.npz``, float32 arrays keyed
``<checkpoint>/<beta|alpha>``, through the reading and writing code of
``jax_reference_pbrl_rates.py``. The port's
``cli/pbrl_wrcq.install_tables`` turns that file into ``save_checkpoint``
directories, so the twin decodes with the JAX program's tables on a
machine without jax or orbax. CPU only:

    JAX_PLATFORMS=cpu python tests/jax_reference_pbrl_wrcq.py [--check]

``--check`` writes nothing and says whether the committed file equals the
checkpoints element for element.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import jax_reference_pbrl_rates as ref  # noqa: E402

CK_DIR = os.path.join(ref.REPO, "experiments", "pbrl_wrcq_ck")
OUT = os.path.join(ref.REPO, "ldpc_tpu_torch", "cli", "pbrl_wrcq_tables.npz")


def tables():
    """{``<checkpoint>/<beta|alpha>``: float32 array} of the seven
    checkpoints, in name order."""
    return ref.tables(CK_DIR)


if __name__ == "__main__":
    ref.main(CK_DIR, OUT)
