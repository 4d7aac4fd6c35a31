"""FER/BER/iteration/time comparison plots (counterpart of
``ldpc_tpu/report/plots.py``).

Capability parity with the reference's plotting surface
(``simulation_framework.py:218-336``: ``plot_fer_curves``,
``plot_ber_curves``, ``plot_iteration_curves``, ``plot_timing_curves``) and
the report-figure generator (``generate_images.py:158-415``) — driven by
real Monte-Carlo results, never synthetic curves (the reference's committed
PNGs are fabricated ``exp(-k*snr)`` templates, SURVEY §8.6).

matplotlib is imported only when a plot is drawn: nothing on the device
path needs it, and a GPU host may not have it.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

__all__ = [
    "plot_fer_curves",
    "plot_ber_curves",
    "plot_iteration_curves",
    "plot_timing_curves",
    "plot_comparison_grid",
]


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _curve_plot(results: Dict, field: str, ylabel: str, title: str,
                path: str, logy: bool = True):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5.5))
    for name, res in results.items():
        y = np.asarray(getattr(res, field), dtype=float)
        x = np.asarray(res.snr_values, dtype=float)[: len(y)]
        if logy:
            mask = y > 0
            ax.semilogy(x[mask], y[mask], marker="o", label=name)
        else:
            ax.plot(x, y, marker="o", label=name)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_fer_curves(results: Dict, path: str = "fer_comparison.png"):
    """(``simulation_framework.py:218-246``)."""
    return _curve_plot(results, "frame_error_rates", "Frame Error Rate",
                       "FER vs SNR", path)


def plot_ber_curves(results: Dict, path: str = "ber_comparison.png"):
    """(``simulation_framework.py:248-276``)."""
    return _curve_plot(results, "bit_error_rates", "Bit Error Rate",
                       "BER vs SNR", path)


def plot_iteration_curves(results: Dict, path: str = "iterations.png"):
    """(``simulation_framework.py:278-306``)."""
    return _curve_plot(results, "average_iterations", "Average iterations",
                       "Decoding iterations vs SNR", path, logy=False)


def plot_timing_curves(results: Dict, path: str = "timing.png"):
    """(``simulation_framework.py:308-336``)."""
    return _curve_plot(results, "simulation_times", "Simulation time (s)",
                       "Per-SNR simulation time", path, logy=False)


def plot_comparison_grid(results: Dict, path: str = "comparison.png"):
    """All four panels in one figure (the reference's combined layout)."""
    plt = _plt()
    fig, axes = plt.subplots(2, 2, figsize=(13, 9))
    panels = [
        ("frame_error_rates", "FER", True),
        ("bit_error_rates", "BER", True),
        ("average_iterations", "Avg iterations", False),
        ("simulation_times", "Time (s)", False),
    ]
    for ax, (field, ylabel, logy) in zip(axes.flat, panels):
        for name, res in results.items():
            y = np.asarray(getattr(res, field), dtype=float)
            x = np.asarray(res.snr_values, dtype=float)[: len(y)]
            if logy:
                mask = y > 0
                ax.semilogy(x[mask], y[mask], marker="o", ms=3, label=name)
            else:
                ax.plot(x, y, marker="o", ms=3, label=name)
        ax.set_xlabel("SNR (dB)")
        ax.set_ylabel(ylabel)
        ax.grid(True, which="both", alpha=0.3)
    axes.flat[0].legend(fontsize=7)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
