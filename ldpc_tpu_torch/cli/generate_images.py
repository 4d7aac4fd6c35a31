"""Report figures of the PyTorch port from measured data (twin of the root
``generate_images.py``).

``generate_all_images`` re-runs the Monte-Carlo comparison of every
decoder of ``create_test_decoders`` on ``--device`` and renders the
FER/BER/iteration/comparison, parameter and weight-pattern figures;
``generate_deep_fer_figure`` and ``generate_trapping_figure`` render the
committed campaign results under ``experiments/``;
``generate_de_figure`` the protograph density-evolution curves (host
numpy, ``ldpc_tpu_torch.design``). Drawing needs matplotlib; the data
behind the two computed figures comes from :func:`comparison_results`
and :func:`de_curves`, which do not.

    python -m ldpc_tpu_torch.cli.generate_images [--out images]
        [--frames 4096] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

import ldpc_tpu_torch as lt

EXPERIMENTS = Path(__file__).resolve().parents[2] / "experiments"


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def comparison_results(out_dir: str = "images", max_frames: int = 4096,
                       verbose: bool = True, device="cuda"):
    """The Monte-Carlo comparison behind :func:`generate_all_images`: every
    decoder of ``create_test_decoders`` on PEG(128, 64), T=12, at 0-5 dB,
    saved as ``mc_results.json`` in ``out_dir``. Returns (code, decoders,
    results)."""
    os.makedirs(out_dir, exist_ok=True)
    code = lt.create_peg_code(n=128, m=64, dv=3, seed=0, max_iterations=12)
    zoo = lt.create_test_decoders(code, max_iterations=12, device=device)
    cfg = lt.SimulationConfig(
        snr_range=(0.0, 5.0), snr_step=1.0, max_frames=max_frames,
        max_errors=max(200, max_frames // 8),
        min_frames=min(1024, max_frames), wave_size=1024,
        results_dir=out_dir, device=device)
    sim = lt.LDPCSimulator(cfg)
    results = sim.simulate_multiple_decoders(zoo, verbose=verbose)
    sim.save_results(filename="mc_results.json")
    return code, zoo, results


def generate_all_images(out_dir: str = "images", max_frames: int = 4096,
                        verbose: bool = True, device="cuda"):
    """The comparison figures of every decoder, from a fresh simulation;
    returns the PNG paths."""
    from ldpc_tpu_torch.report import (analyze_weight_patterns,
                                       parameter_reduction_report,
                                       plot_ber_curves, plot_comparison_grid,
                                       plot_fer_curves, plot_iteration_curves,
                                       plot_weight_patterns)

    code, zoo, results = comparison_results(out_dir, max_frames, verbose,
                                            device)
    paths = [
        plot_fer_curves(results, os.path.join(out_dir, "fer_comparison.png")),
        plot_ber_curves(results, os.path.join(out_dir, "ber_comparison.png")),
        plot_iteration_curves(
            results, os.path.join(out_dir, "iteration_comparison.png")),
        plot_comparison_grid(results, os.path.join(out_dir, "comparison.png")),
    ]

    # parameter-comparison bar chart (reference parameter_comparison.png)
    plt = _plt()
    rep = parameter_reduction_report(zoo, baseline="N-NMS")
    names = list(rep["decoders"])
    counts = [rep["decoders"][n]["params"] for n in names]
    fig, ax = plt.subplots(figsize=(9, 4.5))
    ax.bar(names, counts)
    ax.set_ylabel("trainable parameters")
    ax.set_title(f"Parameter counts ({code.n},{code.k}) @ 12 iterations")
    plt.setp(ax.get_xticklabels(), rotation=30, ha="right", fontsize=8)
    fig.tight_layout()
    p = os.path.join(out_dir, "parameter_comparison.png")
    fig.savefig(p, dpi=130)
    plt.close(fig)
    paths.append(p)

    # weight-pattern figure (reference weight_pattern_analysis.png)
    paths.append(plot_weight_patterns(
        analyze_weight_patterns(zoo["N-NMS"]),
        os.path.join(out_dir, "weight_pattern_analysis.png")))
    return paths


def generate_deep_fer_figure(out_dir: str = "images",
                             verbose: bool = True) -> str:
    """Render the deep-FER campaign (measured curves down to FER ~2e-8;
    ``experiments/deep_fer_results.json`` + ``deep_fer_trained_l6``) —
    the paper's §VII-B no-error-floor evidence regime."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    with open(EXPERIMENTS / "deep_fer_results.json") as f:
        curves = dict(json.load(f)["curves"])
    trained = EXPERIMENTS / "deep_fer_trained_l6_results.json"
    if trained.exists():
        with open(trained) as f:
            curves["W-OMS-RCQ-bc3-trained-L6"] = json.load(f)["curve"]

    style = {
        "float-MS-L6": ("float min-sum, layered T=6", "k", "o"),
        "RCQ-bc3-L6": ("RCQ bc=3/bv=8, layered T=6", "C0", "s"),
        "RCQ-bc4-L6": ("RCQ bc=4/bv=8, layered T=6", "C1", "^"),
        "W-OMS-RCQ-bc3-trained": ("trained W-OMS-RCQ bc=3, flooding T=10",
                                  "C2", "v"),
        "W-OMS-RCQ-bc3-trained-L6": ("trained W-OMS-RCQ bc=3, layered T=6",
                                     "C3", "D"),
    }
    fig, ax = plt.subplots(figsize=(7.2, 5.2))
    for name, c in curves.items():
        label, color, marker = style.get(name, (name, None, "o"))
        snr = c["snr_values"][: len(c["frame_error_rates"])]
        pts = [(s, f) for s, f in zip(snr, c["frame_error_rates"]) if f > 0]
        if pts:
            ax.semilogy(*zip(*pts), marker=marker, color=color, label=label)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("FER")
    ax.set_title("Deep-FER, (9472, 8192) QC code — 50M frames/point,\n"
                 "fused layered kernel + two-checkpoint compaction (1 chip)")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=8)
    path = os.path.join(out_dir, "deep_fer.png")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    if verbose:
        print(f"wrote {path}")
    return path


_VQ = dict(bv=8, v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)))
RCQ3 = dict(kind="rcq", bc=3,
            quantizer_params=((2.0, 1.3), (4.0, 1.3), (6.0, 1.3)), **_VQ)
DE_ARMS = [
    ("bc=3, 2-4-6@1.3 (bench ladder)", RCQ3),
    ("bc=4, 6-11-16@1.3 (on-code sweep)",
     dict(kind="rcq", bc=4,
          quantizer_params=((6.0, 1.3), (11.0, 1.3), (16.0, 1.3)), **_VQ)),
    ("bc=4, 3-6-12@1.3 (DE pick)",
     dict(kind="rcq", bc=4,
          quantizer_params=((3.0, 1.3), (6.0, 1.3), (12.0, 1.3)), **_VQ)),
]
DE_SNRS = np.arange(2.0, 4.01, 0.5)
_EPS = 1e-16


def de_curves() -> dict:
    """The curves of :func:`generate_de_figure`: the bench protograph's
    flooding and layered DE trajectories at 6.4 dB (T=8), and the PBRL
    (3096, 1032) ensemble's layered error probability after 12 iterations
    over ``DE_SNRS`` for each ladder of ``DE_ARMS``."""
    from ldpc_tpu_torch.design import protograph_density_evolution as pde

    base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    curves = {s: np.maximum(pde(base, schedule=s, snr_db=6.4,
                                max_iterations=8, **RCQ3).error_prob, _EPS)
              for s in ("flooding", "layered")}
    B, _ = lt.create_pbrl_qc_protograph(k=1032, rate=1 / 3, lift=86)
    curves["pbrl"] = {
        label: [max(float(pde(B, schedule="layered", snr_db=s,
                              max_iterations=12, **kw).error_prob[-1]), _EPS)
                for s in DE_SNRS]
        for label, kw in DE_ARMS}
    return curves


def generate_de_figure(out_dir: str = "images", verbose: bool = True,
                       curves=None):
    """Density-evolution analysis figure (pure CPU, ldpc_tpu_torch.design):

    left — layered vs flooding per-edge DE trajectories on the bench
    protograph (the measured ~2x schedule speedup, RESULTS §17);
    right — PBRL rate-1/3 deep behavior vs SNR for the bc=3 bench ladder
    (degree-1 clipping plateau) against two bc=4 ladders (floor removed).
    Okabe-Ito colorblind-safe hues in fixed order; one axis per panel.
    ``curves`` is :func:`de_curves`' result, computed here when None.
    """
    curves = de_curves() if curves is None else curves
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    C = ["#0072B2", "#E69F00", "#009E73", "#CC79A7"]  # Okabe-Ito subset
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10.5, 4.2))
    it = np.arange(1, 9)
    ax1.semilogy(it, curves["flooding"], "o-", color=C[0], label="flooding")
    ax1.semilogy(it, curves["layered"], "s-", color=C[1], label="layered")
    ax1.set_xlabel("iteration")
    ax1.set_ylabel("DE bit-error probability")
    ax1.set_title("Protograph DE, bench (9472, 8192) base @ 6.4 dB\n"
                  "layered reaches 1e-5 in half the iterations")
    ax1.grid(True, which="both", alpha=0.3)
    ax1.legend(fontsize=9)
    for (label, errs), color, marker in zip(curves["pbrl"].items(), C,
                                            ("o", "s", "^")):
        ax2.semilogy(DE_SNRS, errs, marker=marker, color=color, label=label)
    ax2.set_xlabel("SNR (dB)")
    ax2.set_ylabel("DE bit-error probability (12 iters)")
    ax2.set_title("PBRL (3096, 1032) ensemble: degree-1 clipping\n"
                  "plateaus bc=3; bc=4 range removes it (RESULTS §17)")
    ax2.grid(True, which="both", alpha=0.3)
    ax2.legend(fontsize=8)
    path = os.path.join(out_dir, "de_analysis.png")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    if verbose:
        print(f"wrote {path}")
    return path


def generate_trapping_figure(out_dir: str = "images", verbose: bool = True):
    """Trapping-set min-b fingerprints of all measured codes (RESULTS
    §19), from ``experiments/trapping_spectrum_results.json`` (the
    ``design.trapping_set_profile`` output — measured structure, not
    simulation)."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    with open(EXPERIMENTS / "trapping_spectrum_results.json") as f:
        data = json.load(f)
    fig, ax = plt.subplots(figsize=(7.2, 4.6))
    for (name, d), m in zip(sorted(data.items()), ["o", "s", "^", "v", "D"]):
        fp = {int(a): b for a, b in d["min_b_fingerprint"].items()
              if b is not None}
        if fp:
            xs = sorted(fp)
            ax.plot(xs, [fp[a] for a in xs], marker=m, label=name)
    ax.set_xlabel("trapping-set size a (variable nodes)")
    ax.set_ylabel("min b found (unsatisfied checks)")
    ax.set_title("Trapping-set min-b fingerprints "
                 "(design.trapping_set_profile, greedy+exact verify)")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    path = os.path.join(out_dir, "trapping_fingerprints.png")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    if verbose:
        print(f"wrote {path}")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="images")
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in generate_all_images(args.out, args.frames, device=args.device):
        print(p)


if __name__ == "__main__":
    main()
