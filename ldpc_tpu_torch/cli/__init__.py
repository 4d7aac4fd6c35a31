"""Command-line twins of the root scripts (``examples.py``,
``comprehensive_test.py``, ``generate_images.py``, ``__graft_entry__.py``,
``bench.py``) and of the throughput, FER campaign, bench-knob,
short-schedule, W-RCQ training, rate-specific and PBRL error-floor
programs of ``experiments/`` (``throughput_matrix``, ``ee_batch``,
``fer_parity``, ``accuracy_bc3``, ``deep_fer``, ``deep_fer_trained_l6``,
``bench_ab_s``, ``ee_trained``, ``bench_dde``, ``train_layered_short``,
``train_wrcq``, ``train_wrcq_qc9472``, ``rate_specific``,
``rate_specific_deep``, ``pbrl_bc5``, ``pbrl_lift_floor``,
``pbrl_precode``, ``floor_is``, ``trapping_spectrum``) and of the
bench-code design studies (``ladder_bc4``, ``bc4_refine``,
``quantizer_count``, ``dde_ladders``), run as
``python -m ldpc_tpu_torch.cli.<name>``; each that decodes takes
``--device`` (the card by default), and each writes its results outside
``experiments/``."""
