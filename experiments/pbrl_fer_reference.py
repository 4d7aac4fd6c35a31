"""The JAX package's FER for the PBRL (3096, 1032) decoder that
``chip_smoke.py`` phase 10 runs through the port's simulator: RCQ bc=3,
bv=8 (the ladders of ``throughput_matrix.py``), T=10, on the
degree-bucketed engine with bf16 message state and the syndrome checked
every 5 iterations, at 1.2 dB, through ``ldpc_tpu.sim`` on the CPU.

    JAX_PLATFORMS=cpu python experiments/pbrl_fer_reference.py [--frames N]

Prints one JSON line: frames, frame errors, FER, and the share of frames
that have not converged after 5 iterations (the survivors of a compacting
wave with ``early_exit_iters=5``).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QP = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
SNR_DB, T, CHECK_EVERY = 1.2, 10, 5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16384)
    ap.add_argument("--wave", type=int, default=2048)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import ldpc_tpu
    from ldpc_tpu.sim import SimulationConfig, simulate_single_snr

    code = ldpc_tpu.create_pbrl_like_code(k=1032, rate=1 / 3,
                                          max_iterations=T)
    dec = ldpc_tpu.make_decoder(
        code, kind="rcq", bc=3, bv=8, quantizer_params=QP,
        v2c_quantizer_params=VQP, max_iterations=T, bucketed=True,
        qc_options={"dtype": jnp.bfloat16, "check_every": CHECK_EVERY})
    cfg = SimulationConfig(max_frames=args.frames, max_errors=10 ** 9,
                           min_frames=0, wave_size=args.wave, seed=0,
                           save_results=False)
    t0 = time.time()
    fer, ber, avg_iter, frames, errors = simulate_single_snr(
        dec, SNR_DB, cfg, key=jax.random.PRNGKey(0))
    # survivors after 5 iterations on one wave of the same channel
    llr = ldpc_tpu.channel.awgn_llr(jax.random.PRNGKey(1),
                                    jnp.zeros((args.wave, code.n)), SNR_DB)
    surv = float(jnp.mean(dec(llr).iterations > CHECK_EVERY))
    print(json.dumps(dict(snr_db=SNR_DB, frames=int(frames),
                          frame_errors=int(errors), fer=fer, ber=ber,
                          avg_iterations=avg_iter,
                          unconverged_after_5=surv,
                          seconds=round(time.time() - t0, 1))))


if __name__ == "__main__":
    main()
