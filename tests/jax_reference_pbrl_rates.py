"""The trained W-OMS-RCQ tables of ``experiments/pbrl_rates.py`` as numpy:
reads the eight orbax checkpoints ``experiments/pbrl_rates_ck/orcq_*``
with ``ldpc_tpu.utils.checkpoint.load_checkpoint`` and writes them to
``ldpc_tpu_torch/cli/pbrl_rates_tables.npz``, float32 arrays keyed
``<checkpoint>/<beta|alpha>`` (``orcq_89/beta``, ...). The port's
``cli/pbrl_rates.install_tables`` turns that file into ``save_checkpoint``
directories, so the twin decodes with the JAX program's tables on a
machine without jax or orbax. CPU only:

    JAX_PLATFORMS=cpu python tests/jax_reference_pbrl_rates.py [--check]

``--check`` writes nothing and says whether the committed file equals the
checkpoints element for element.
"""

import io
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CK_DIR = os.path.join(REPO, "experiments", "pbrl_rates_ck")
OUT = os.path.join(REPO, "ldpc_tpu_torch", "cli", "pbrl_rates_tables.npz")


def tables():
    """{``<checkpoint>/<beta|alpha>``: float32 array} of every ``orcq_*``
    checkpoint, in name order."""
    sys.path.insert(0, REPO)
    from ldpc_tpu.utils.checkpoint import load_checkpoint

    out = {}
    for name in sorted(os.listdir(CK_DIR)):
        if not name.startswith("orcq_"):
            continue
        tree = load_checkpoint(os.path.join(CK_DIR, name))
        for key in ("beta", "alpha"):
            out[f"{name}/{key}"] = np.asarray(tree[key], np.float32)
    return out


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")

    tabs = tables()
    if "--check" in sys.argv[1:]:
        with np.load(OUT) as f:
            same = sorted(f.files) == sorted(tabs) and all(
                np.array_equal(f[k], v) and f[k].dtype == v.dtype
                for k, v in tabs.items())
        print(f"{OUT}: {len(tabs)} arrays, equal to the checkpoints: {same}")
        raise SystemExit(0 if same else 1)
    buf = io.BytesIO()
    np.savez_compressed(buf, **tabs)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"{OUT}: {len(tabs)} arrays, {len(buf.getvalue())} bytes")


if __name__ == "__main__":
    main()
