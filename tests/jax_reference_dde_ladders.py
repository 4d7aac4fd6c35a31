"""The JAX package's numbers that ``chip_smoke.py`` phase 19 (d) puts in
place of ``ldpc_tpu_torch.cli.dde_ladders``' host designer calls, which
take minutes: ``experiments/dde_ladders.py:58-72``'s calls on the bench
protograph (the 5x37 base of ``bench.py``) at bc=4 (``design_rcq_ladders``
on the degree profile, bv=8, T=10, 6.3 dB, three phases, then
``refine_ladders_protograph`` of its ladders at T=6, layered) and the
refine at bc=3 of the bc=3 design (phase 12's ``DESIGN_QP`` /
``DESIGN_VQP``, the same call's result).

    JAX_PLATFORMS=cpu python tests/jax_reference_dde_ladders.py [--port]

Prints one JSON line: each call's ladders, its DE threshold and its host
seconds. ``--port`` makes the same calls through ``ldpc_tpu_torch.design``
as well and says whether every result is equal.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DESIGN_SNR, T_EFF = 6.3, 10


def calls(design, bc3_design):
    """{name: (ladders, threshold, seconds)} of the three calls through
    the package ``design``; ``bc3_design`` is (CN, V2C) of the bc=3
    design."""
    base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    out = {}
    t0 = time.perf_counter()
    qp, vqp, r = design.design_rcq_ladders(
        design.degree_profile_from_base(base), bc=4, bv=8,
        max_iterations=T_EFF, snr_db=DESIGN_SNR, phases=3)
    out["design_bc4"] = dict(cn=qp, v2c=vqp, threshold_db=r.threshold_db,
                             seconds=time.perf_counter() - t0)
    for bc, (cn, v2c) in ((3, bc3_design), (4, (qp, vqp))):
        t0 = time.perf_counter()
        rqp, rvqp, rthr = design.refine_ladders_protograph(
            base, cn, v2c, bc=bc, bv=8, max_iterations=6,
            snr_db=DESIGN_SNR, schedule="layered")
        out[f"refined_bc{bc}"] = dict(cn=rqp, v2c=rvqp, threshold_db=rthr,
                                      seconds=time.perf_counter() - t0)
    return out


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")

    import ldpc_tpu.design

    import chip_smoke
    sys.modules["jax"] = jax  # chip_smoke blocks it for the port

    bc3 = (chip_smoke.DESIGN_QP, chip_smoke.DESIGN_VQP)
    out = {"jax": json.loads(json.dumps(calls(ldpc_tpu.design, bc3)))}
    if "--port" in sys.argv[1:]:
        import ldpc_tpu_torch.design
        out["port"] = json.loads(json.dumps(calls(ldpc_tpu_torch.design,
                                                  bc3)))
        out["equal"] = {k: {f: out["port"][k][f] == v[f]
                            for f in ("cn", "v2c", "threshold_db")}
                        for k, v in out["jax"].items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
