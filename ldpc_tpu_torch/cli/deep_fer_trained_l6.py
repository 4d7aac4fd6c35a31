"""Deep FER of the trained layered T=6 W-OMS-RCQ(3,8) decoder (twin of
``experiments/deep_fer_trained_l6.py``).

The companion of :mod:`ldpc_tpu_torch.cli.deep_fer`, with the same
machinery: the bench code, the 2-4-6 @ gamma 1.3 ladder, the uniform
bv=8 V2C quantizer, the whole-decode layered kernel (K1,
``csrc/fused_layered.cu``) in bf16 with the full output, waves of 32768
frames, survivor budget 2048, here under the {2, 6} two-checkpoint
compaction. The weights come from the zoo entry ``worcq_bc3_layered_t6``,
whose tables equal the JAX program's ``experiments/orcq_layered_t6_ck``
element for element. SNR 6.4-6.7 dB, 100 frame errors a point
or ``frames`` frames. The curve is written after every point to
``deep_fer_torch_ck/W-OMS-RCQ-bc3-trained-L6.json`` in the working
directory (rerunning resumes), and the report to ``--out`` (default
``deep_fer_trained_l6_torch.json`` in the working directory).

    python -m ldpc_tpu_torch.cli.deep_fer_trained_l6 [--frames 50000000]
        [--errors 100] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging

from ldpc_tpu_torch.cli import deep_fer

__all__ = ["NAME", "T1", "SNRS", "WAVE", "WEIGHTS", "DEFAULT_OUT",
           "trained_layered_decoder", "trained_l6_config", "run", "main"]

NAME = "W-OMS-RCQ-bc3-trained-L6"
T1 = 2
SNRS = (6.4, 6.5, 6.6, 6.7)
WAVE = 32768
WEIGHTS = "worcq_bc3_layered_t6"
DEFAULT_OUT = "deep_fer_trained_l6_torch.json"


def trained_layered_decoder(lift: int = 256, device="cuda"):
    """The layered T=6 W-OMS-RCQ with the zoo entry's tables
    (``experiments/deep_fer_trained_l6.py:47-53``)."""
    dec = deep_fer.qc_decoder(lift, 6, device, kind="orcq", bc=3, bv=8,
                              sharing_type=2, quantizer_params=deep_fer.QP,
                              v2c_quantizer_params=deep_fer.VQP,
                              layered=True)
    return dec.replace_weights(deep_fer.load_weights(WEIGHTS))


def trained_l6_config(frames: int = 5 * 10 ** 7, errors: int = 100,
                      device="cuda"):
    """``experiments/deep_fer_trained_l6.py:55-61``: the campaign's
    configuration over SNRS in waves of WAVE frames under {2, 6}."""
    step = round(SNRS[1] - SNRS[0], 6) if len(SNRS) > 1 else 0.1
    return deep_fer.campaign_config(T1, frames, errors, WAVE, min(SNRS),
                                    max(SNRS), step, device)


def run(frames: int = 5 * 10 ** 7, errors: int = 100, lift: int = 256,
        out_path: str = DEFAULT_OUT, device="cuda", verbose: bool = True):
    """The campaign; writes the report to ``out_path`` and returns it."""
    dec = trained_layered_decoder(lift, device)
    res = deep_fer.sweep({NAME: dec}, trained_l6_config(
        frames, errors, device), verbose=verbose)[0][NAME]
    report = {"curve": res.to_dict(), "weights": WEIGHTS,
              "config": "layered T=6 fused, {2,6} compaction, bc=3 bv=8 "
                        "uniform, 2-4-6@1.3"}
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=5 * 10 ** 7)
    ap.add_argument("--errors", type=int, default=100)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the simulator's per-point and heartbeat lines
    logging.basicConfig(level=logging.INFO, force=True)
    run(frames=args.frames, errors=args.errors, out_path=args.out,
        device=args.device)


if __name__ == "__main__":
    main()
