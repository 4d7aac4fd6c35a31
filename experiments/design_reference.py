"""The JAX package's numbers that ``chip_smoke.py`` phase 12 holds the
port's design tools to: ``experiments/dde_ladders.py:52-66``'s designer
call on the bench profile (the 5x37 base of ``bench.py``, bc=3, bv=8,
T=10, 6.3 dB, three phases), then ``analyze_decoder`` of the layered T=6
decoder built on the designed ladder at 6.5 dB, and the trapping-set
class counts of the PBRL QC codes of ``experiments/floor_is.py``.

    JAX_PLATFORMS=cpu python experiments/design_reference.py

Prints one JSON line: the CN and V2C ladders, the DE threshold, the
trajectory, the class counts of both arms and the host seconds of each
step.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")

    import ldpc_tpu
    from ldpc_tpu.decode.qc_engine import build_qc_graph
    from ldpc_tpu.design import (analyze_decoder, degree_profile_from_base,
                                 design_rcq_ladders, find_trapping_sets)

    out, secs = {}, {}
    base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    t0 = time.perf_counter()
    qp, vqp, res = design_rcq_ladders(degree_profile_from_base(base), bc=3,
                                      bv=8, max_iterations=10, snr_db=6.3,
                                      phases=3)
    secs["design"] = time.perf_counter() - t0
    out.update(cn=qp, v2c=vqp, threshold_db=res.threshold_db)

    code = ldpc_tpu.create_qc_code(base, lift=256, max_iterations=6)
    dec = ldpc_tpu.make_decoder(
        code, kind="rcq", bc=3, bv=8, quantizer_params=qp,
        v2c_quantizer_params=vqp, max_iterations=6,
        qc=build_qc_graph(base, 256), layered=True)
    t0 = time.perf_counter()
    out["trajectory_6.5dB"] = [float(e) for e in analyze_decoder(
        dec, snr_db=6.5).error_prob]
    secs["analyze_decoder"] = time.perf_counter() - t0

    for arm, precode in (("random", False), ("precoded", True)):
        B, L = ldpc_tpu.create_pbrl_qc_protograph(
            k=1032, rate=1 / 3, precode=precode)[:2]
        H = ldpc_tpu.create_qc_code(B, lift=L, max_iterations=10).H
        t0 = time.perf_counter()
        rep = find_trapping_sets(H, a_max=8, b_max=3, restarts=3,
                                 max_sets=10000)
        secs[f"trapping_sets_{arm}"] = time.perf_counter() - t0
        out[f"class_counts_{arm}"] = {
            f"{a},{b}": c for (a, b), c in sorted(rep.class_counts().items())}
    out["seconds"] = secs
    print(json.dumps(out))


if __name__ == "__main__":
    main()
