"""Weight-pattern analysis and parameter accounting (counterpart of
``ldpc_tpu/report/analysis.py``).

Capability parity with the reference's ``analyze_weight_patterns``
(``neural_minsum_decoder.py:288-349``) — per-iteration weight statistics and
mean weight grouped by check-node degree — and the parameter-reduction
analysis of ``comprehensive_test.py:187-229`` (the paper's Table I story:
degree-shared types keep N-NMS performance at orders of magnitude fewer
parameters).

The reference walks string-keyed ``ParameterDict``s; here weights are dense
``[T, buckets]`` tensors with per-edge bucket indices, so the analysis
reads them on the host (wherever the decoder lives) and is vectorized
numpy over the same quantities.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ldpc_tpu_torch.decode.variants import Decoder

__all__ = ["analyze_weight_patterns", "parameter_reduction_report",
           "plot_weight_patterns"]


def analyze_weight_patterns(decoder: Decoder) -> Dict:
    """Per-iteration stats of the CN (beta) weights plus mean weight per
    check-node degree — the reference's weight-sharing evidence
    (``neural_minsum_decoder.py:288-349``): edge weights of a trained N-NMS
    cluster by node degree, motivating types 1-4."""
    w = decoder.weights.get("beta")
    if w is None:
        raise ValueError(
            f"decoder {decoder.name!r} has no beta weights to analyze")
    w = w.detach().cpu().numpy()  # [T, n_beta]
    T = w.shape[0]
    graph = decoder.graph
    spec = decoder.spec

    per_iteration = []
    for t in range(T):
        wt = w[t]
        per_iteration.append({
            "iteration": t,
            "mean": float(wt.mean()),
            "std": float(wt.std()),
            "min": float(wt.min()),
            "max": float(wt.max()),
        })

    # mean weight grouped by check-node degree: expand to per-edge values
    # via the spec's bucket wiring, then group by each edge's check degree.
    # A QC decoder's buckets are per block: a block's L edges share its
    # weight, its base row's degree and its base column's, so grouping the
    # blocks gives the per-edge means (the JAX package indexes per-edge
    # degrees with the per-block buckets there, and raises IndexError)
    by_degree: Dict[int, float] = {}
    by_var_degree: Dict[int, float] = {}
    if spec.beta_idx is not None:
        edge_w = w[:, np.asarray(spec.beta_idx)]  # [T, E] (QC: [T, NB])
        qc = decoder.qc
        if qc is not None:
            edge_dc = np.array([len(qc.row_blocks[r]) for r in qc.block_row])
            edge_dv = np.array([len(qc.col_blocks[c]) for c in qc.block_col])
        else:
            edge_dc = graph.check_degree[graph.edge_check]
            edge_dv = graph.var_degree[graph.edge_var]
        for dc in sorted(set(int(d) for d in edge_dc)):
            by_degree[dc] = float(edge_w[:, edge_dc == dc].mean())
        # by variable-node degree (the 2D half of the story)
        for dv in sorted(set(int(d) for d in edge_dv)):
            by_var_degree[dv] = float(edge_w[:, edge_dv == dv].mean())

    return {
        "decoder_name": decoder.name,
        "num_iterations": T,
        "total_parameters": decoder.param_count(),
        "per_iteration": per_iteration,
        "mean_weight_by_check_degree": by_degree,
        "mean_weight_by_variable_degree": by_var_degree,
    }


def parameter_reduction_report(decoders: Dict[str, Decoder],
                               baseline: Optional[str] = None) -> Dict:
    """Parameter counts and reduction ratios vs the N-NMS baseline
    (``comprehensive_test.py:187-229``; paper Table I)."""
    counts = {name: dec.param_count() for name, dec in decoders.items()}
    if baseline is None:
        baseline = max(counts, key=counts.get)
    base = counts[baseline]
    report = {"baseline": baseline, "baseline_params": base, "decoders": {}}
    for name, c in counts.items():
        report["decoders"][name] = {
            "params": c,
            "reduction_pct": (100.0 * (1 - c / base)) if base else 0.0,
            "params_per_iteration": (
                c / decoders[name].max_iterations
                if decoders[name].max_iterations else 0),
        }
    return report


def plot_weight_patterns(analysis: Dict,
                         path: str = "weight_pattern_analysis.png"):
    """Per-iteration mean±std and per-degree mean bars
    (reference ``generate_images.py`` weight-pattern figure)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    it = [p["iteration"] for p in analysis["per_iteration"]]
    mean = np.array([p["mean"] for p in analysis["per_iteration"]])
    std = np.array([p["std"] for p in analysis["per_iteration"]])
    axes[0].errorbar(it, mean, yerr=std, marker="o", capsize=3)
    axes[0].set_xlabel("iteration")
    axes[0].set_ylabel("beta weight")
    axes[0].set_title(f"Per-iteration weights — {analysis['decoder_name']}")
    axes[0].grid(alpha=0.3)

    bd = analysis["mean_weight_by_check_degree"]
    if bd:
        axes[1].bar([str(k) for k in bd], list(bd.values()))
    axes[1].set_xlabel("check-node degree")
    axes[1].set_ylabel("mean beta")
    axes[1].set_title("Mean weight by check degree")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
