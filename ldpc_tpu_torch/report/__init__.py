"""Weight-pattern analysis, parameter accounting and result plots
(counterpart of ``ldpc_tpu/report/``)."""

from ldpc_tpu_torch.report.analysis import (
    analyze_weight_patterns,
    parameter_reduction_report,
    plot_weight_patterns,
)
from ldpc_tpu_torch.report.plots import (
    plot_ber_curves,
    plot_comparison_grid,
    plot_fer_curves,
    plot_iteration_curves,
    plot_timing_curves,
)
