"""DDE-designed quantizer ladders against the hand-swept ones on dev FER
(twin of ``experiments/dde_ladders.py``).

On the bench code (``default_rng(0)``'s 5x37 base, lift 256), for bc=3
and bc=4: ``design_rcq_ladders`` on the base's degree profile (bv=8,
``t_eff`` = 10 flooding iterations standing for layered T=6, three
phases, at ``design_snr`` dB), then ``refine_ladders_protograph`` of that
design under the layered schedule at T=6 (host numpy, minutes a call).
Each bc gets four arms, RCQ bv=8, layered T=6 through the whole-decode
layered kernel (K1, ``csrc/fused_layered.cu``) with the full output, bf16
on the card (on the CPU the kernel's plain version in float32):

- ``bc{bc}_hand``: the hand CN ladder 2-4-6 @ 1.3, V2C 4-8-12;
- ``bc{bc}_dde``: the design's CN and V2C ladders;
- ``bc{bc}_dde_cn_only``: the design's CN ladder, V2C 4-8-12;
- ``bc{bc}_dde_refined``: the refine's ladders;

and ``bc{bc}_dyn`` (the per-iteration ``designed_params`` of the
committed ``experiments/dynamic_ladders_results.json``, read-only, V2C
4-8-12) when that file exists. In the layered schedule the V2C ladder
quantizes only the final posterior and keeps its signs, so arms that
differ only in it decode the same bits. Every arm runs at each of
``dev_snrs`` on ``frames`` frames in waves of ``min(16384, frames)``,
seed 7, no early exit. The report goes to ``--out`` (default
``dde_ladders_torch.json`` in the working directory, never under
``experiments/``) with the program's keys.

    python -m ldpc_tpu_torch.cli.dde_ladders [--frames 262144]
        [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import ldpc_tpu_torch as lt
from ldpc_tpu_torch import design as dsg
from ldpc_tpu_torch.cli import deep_fer
from ldpc_tpu_torch.cli.generate_images import EXPERIMENTS
from ldpc_tpu_torch.cli.ladder_bc4 import fused_options
from ldpc_tpu_torch.decode.variants import resolve_device

__all__ = ["HAND_CN", "HAND_V2C", "T", "DYNAMIC", "DEFAULT_OUT",
           "designs_for", "arms", "dev_config", "run", "main"]

HAND_CN = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))
HAND_V2C = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
T = 6
DYNAMIC = str(EXPERIMENTS / "dynamic_ladders_results.json")
DEFAULT_OUT = "dde_ladders_torch.json"


def designs_for(base, design_snr: float = 6.3, t_eff: int = 10,
                verbose: bool = True):
    """({bc: (CN, V2C)} designed, {bc: (CN, V2C)} refined) for bc = 3, 4
    (``dde_ladders.py:58-79``)."""
    prof = dsg.degree_profile_from_base(base)
    designs, refined = {}, {}
    for bc in (3, 4):
        qp, vqp, r = dsg.design_rcq_ladders(prof, bc=bc, bv=8,
                                            max_iterations=t_eff,
                                            snr_db=design_snr, phases=3)
        designs[bc] = (qp, vqp)
        if verbose:
            print(f"bc={bc} DDE design: CN {qp} V2C {vqp} "
                  f"(DE threshold {r.threshold_db:.2f} dB)", flush=True)
        # schedule-exact polish: layered protograph DE at T=6
        rqp, rvqp, rthr = dsg.refine_ladders_protograph(
            base, qp, vqp, bc=bc, bv=8, max_iterations=T,
            snr_db=design_snr, schedule="layered")
        refined[bc] = (rqp, rvqp)
        if verbose:
            print(f"bc={bc} proto-refined: CN {rqp} V2C {rvqp} "
                  f"(layered thr {rthr:.2f} dB)", flush=True)
    return designs, refined


def arms(designs, refined, lift: int = 256, device="cuda"):
    """{name: decoder} in the program's order (``dde_ladders.py:81-102``)."""
    base = deep_fer.bench_base(lift)
    code = lt.create_qc_code(base, lift=lift, max_iterations=T)
    qc = lt.build_qc_graph(base, lift)

    def mk(bc, qp, vqp):
        return lt.make_decoder(
            code, kind="rcq", bc=bc, bv=8, quantizer_params=qp,
            v2c_quantizer_params=vqp, max_iterations=T, qc=qc,
            layered=True, qc_options=fused_options(device), device=device)

    out = {}
    for bc in (3, 4):
        out[f"bc{bc}_hand"] = mk(bc, HAND_CN, HAND_V2C)
        out[f"bc{bc}_dde"] = mk(bc, *designs[bc])
        # decomposition arm: DDE CN ladder with the hand V2C ladder
        out[f"bc{bc}_dde_cn_only"] = mk(bc, designs[bc][0], HAND_V2C)
        out[f"bc{bc}_dde_refined"] = mk(bc, *refined[bc])
    if os.path.exists(DYNAMIC):
        with open(DYNAMIC) as f:
            dyn = json.load(f)
        for bc in (3, 4):
            d = dyn.get(f"bc{bc}")
            if d:
                qp = tuple(tuple(p) for p in d["designed_params"])
                out[f"bc{bc}_dyn"] = mk(bc, qp, HAND_V2C)
    return out


def dev_config(frames: int = 262144, device="cuda") -> lt.SimulationConfig:
    """The dev points' Monte-Carlo (``dde_ladders.py:104-106``)."""
    return lt.SimulationConfig(snr_range=(0, 0), max_frames=frames,
                               max_errors=10 ** 9, min_frames=0,
                               wave_size=min(16384, frames), seed=7,
                               device=device)


def run(frames: int = 262144, lift: int = 256, dev_snrs=(6.4, 6.5),
        design_snr: float = 6.3, t_eff: int = 10,
        out_path: str = DEFAULT_OUT, verbose: bool = True, device="cuda"):
    """The designs and the dev points; writes the report to ``out_path``
    and returns it. A CUDA ``device`` must exist before the designs'
    minutes of host work begin."""
    resolve_device(device)
    designs, refined = designs_for(deep_fer.bench_base(lift), design_snr,
                                   t_eff, verbose)
    decs = arms(designs, refined, lift, device)
    cfg = dev_config(frames, device)
    fers = {}
    for snr in dev_snrs:
        for name, dec in decs.items():
            fer = lt.simulate_single_snr(dec, snr, cfg)[0]
            fers[f"{name}@{snr}"] = float(fer)
            if verbose:
                print(f"{name:18s} @ {snr} dB: FER {fer:.4e}", flush=True)

    code = decs["bc3_hand"].code
    report = {
        "code": f"QC({code.n},{code.k}) lift={lift}, layered T=6, bv=8",
        "design_snr": design_snr, "t_eff": t_eff,
        "designs": {str(bc): {"cn": designs[bc][0], "v2c": designs[bc][1]}
                    for bc in designs},
        "refined": {str(bc): {"cn": refined[bc][0], "v2c": refined[bc][1]}
                    for bc in refined},
        "fers": fers, "frames": frames,
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=262144)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(frames=args.frames, out_path=args.out, device=args.device)


if __name__ == "__main__":
    main()
