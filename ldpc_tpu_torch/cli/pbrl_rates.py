"""The paper's section VII-C across rates: one precoded PBRL mother code,
designed 4-bit RCQ against a "6-bit" OMS at every rate (twin of
``experiments/pbrl_rates.py``).

The mother structure is ``create_pbrl_qc_protograph(k=1032, lift=43,
precode=True, core_rate=8/9)``: at rates 1/3, 1/2, 2/3 and 8/9 a 49x73,
25x49, 13x37 and 4x28 base (n = 3139, 2107, 1591 and 1204), each the
leading submatrix of the mother, base column 0 (43 bits) punctured. Every
decoder is layered T=10 through the whole-decode layered kernel (K1,
``csrc/fused_layered.cu``) with the full output, in bf16 on the card (on
the CPU the kernel's plain version in float32, as the JAX program switches
to f32 off the TPU). The arms of :func:`_mk_setup`:

- ``oms6``: OMS with sharing type 2 and its tables pinned to beta = 0.5,
  alpha = 0; the program's ``bv=6`` and 6-bit V2C ladder are ignored for
  ``oms`` (``make_decoder`` quantizes only ``rcq``, ``wrcq`` and
  ``orcq``), so it is a float OMS, as in the JAX record;
- RCQ bc=4, bv=8 with the uniform V2C ladder 4-8-12 on a CN ladder:
  ``rcq-seed`` (the round-3 fixed point scaled by :data:`SEED_SCALE`),
  ``rcq-best`` (the design's best refine pass), ``rcq-p<i>`` (pass i),
  ``rcq-pol`` (the floor-polished ladder), ``rcq-pol3`` (the two-point
  guarded polish), ``rcq-q4`` / ``rcq-q5`` (4- and 5-pair ladders, which
  ``phase_schedule`` spreads evenly over the 10 iterations);
- ``wrcq-<tag>[-q4|-pol3][pl]``: trained W-OMS-RCQ (``orcq``, sharing
  type 2, per-layer tables with ``pl``) on the best, 4-pair or polish3
  ladder, its tables read with ``load_checkpoint`` from
  ``pbrl_rates_torch_ck/orcq_<tag>[_q4|_pol3][pl]`` in the working
  directory. Where that checkpoint is missing, :func:`install_tables`
  first writes it from ``pbrl_rates_tables.npz`` beside this module: the
  JAX program's eight trained tables, equal element for element to its
  orbax checkpoints ``experiments/pbrl_rates_ck/orcq_*``
  (``tests/jax_reference_pbrl_rates.py`` makes the file).

Phases:

- ``--phase design`` (:func:`design`, host numpy): the per-rate CN-ladder
  design by ``iterate_refine`` on the decision-bias-fixed DE, seeded from
  :func:`seed_ladders`, written to ``pbrl_rates_design_<tag>_torch.json``;
- ``--phase polish`` (:func:`polish`, host numpy): the floor-objective
  polish of the best pass at its DE floor's peak, written to
  ``pbrl_rates_design_<tag>_polish_torch.json``;
- ``--phase train`` (:func:`train`): W-OMS-RCQ on the rate's best
  (``--ladder best``), 4-pair or polish3 ladder by
  ``PosteriorJointTrainer`` (batch 128, 30 epochs of 2048 frames, cosine
  schedule from 2e-3 with 8 warm-up updates, SNR threshold + 1 to + 3 dB,
  the punctured bits' LLRs 0), saved to ``pbrl_rates_torch_ck/``;
- ``--phase deep`` (:func:`deep`): the adaptive scan of each arm
  (:func:`_scan_arm`): down in 0.4 dB steps while FER < 3e-4, up in 0.4
  dB steps while FER > 3e-3 with at most 2e6 frames, then 0.2 dB steps
  to FER <= 1e-6 or a point without errors; each point under the {5, 10}
  two-checkpoint compaction with survivor budget 4096 and waves of
  ``min(262144, 32768 * max(1, round(9472 / n)))`` frames, until
  ``--errors`` frame errors once 65,536 frames ran, or ``--frames``
  frames; one resumable file an arm, ``pbrl_rates_torch_ck/<tag>_<arm>.json``;
- ``--phase report`` (:func:`report`): each arm's SNR at FER 1e-6
  (log-linear between the bracketing points) and its gap to ``oms6``,
  written to ``pbrl_rates_torch.json``.

``deep`` and ``train`` read the committed designs
``experiments/pbrl_rates_design_<tag>[_polish].json`` (read only), or,
with ``--design-dir DIR``, the twin's own designs in DIR. The 4- and
5-pair and polish3 ladders are always the committed ones. Everything is
written in the working directory, never under ``experiments/``.

    python -m ldpc_tpu_torch.cli.pbrl_rates --phase
        design|polish|train|deep|report [--rates 89 23 12 13]
        [--arms oms6 rcq-best] [--frames 50000000] [--errors 100]
        [--max-passes 6] [--snr-start DB] [--ladder best|q4|pol3]
        [--per-layer] [--design-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os

import numpy as np
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch import design as dsg
from ldpc_tpu_torch.cli.generate_images import EXPERIMENTS
from ldpc_tpu_torch.cli.ladder_bc4 import fused_options
from ldpc_tpu_torch.interop import weights_from_numpy
from ldpc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["K", "LIFT", "CORE_RATE", "T", "BC", "BV", "RATES", "CN_SEED",
           "SEED_SCALE", "VQP8", "VQP6", "DESIGN_PATH", "DESIGN_RECORD",
           "POLISH_PATH", "POLISH_RECORD", "CK_DIR", "OUT_PATH",
           "FER_TARGET", "TABLES", "BATCH", "NUM_SAMPLES", "LEARNING_RATE",
           "WARMUP_STEPS", "MIN_FRAMES", "EARLY_EXIT", "BUDGET", "family",
           "seed_ladders", "design", "_load_design", "_best_ladder",
           "_q4_ladder", "polish", "install_tables", "_mk_setup", "train",
           "wave_size", "_scan_arm", "deep", "_snr_at", "report", "main"]

K, LIFT, CORE_RATE = 1032, 43, 8 / 9
T, BC, BV = 10, 4, 8
RATES = {"13": 1 / 3, "12": 1 / 2, "23": 2 / 3, "89": 8 / 9}
# the round-3 converged refine's CN ladder; the V2C ladder is
# decode-neutral in the layered schedule, so every arm keeps 4-8-12
CN_SEED = ((6.797, 1.3), (7.2043, 1.3), (6.5867, 1.3))
# the seed's reach scaled with the operating SNR of each rate
SEED_SCALE = {"13": 1.0, "12": 1.4, "23": 2.0, "89": 4.0}
VQP8 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
VQP6 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
# the twin's own designs (working directory) and the committed ones
DESIGN_PATH = "pbrl_rates_design_{tag}_torch.json"
POLISH_PATH = "pbrl_rates_design_{tag}_polish_torch.json"
DESIGN_RECORD = str(EXPERIMENTS / "pbrl_rates_design_{tag}.json")
POLISH_RECORD = str(EXPERIMENTS / "pbrl_rates_design_{tag}_polish.json")
CK_DIR = "pbrl_rates_torch_ck"
OUT_PATH = "pbrl_rates_torch.json"
FER_TARGET = 1e-6
# the JAX program's trained tables, keyed <checkpoint>/<beta|alpha>
TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "pbrl_rates_tables.npz")
# train's batch, frames an epoch, peak learning rate and warm-up updates
# (the cosine schedule decays over the program's 16 updates an epoch
# whatever NUM_SAMPLES is)
BATCH, NUM_SAMPLES, LEARNING_RATE, WARMUP_STEPS = 128, 2048, 2e-3, 8
# the deep scan's compaction: frames before the error target counts,
# stage-1 depth and survivor budget
MIN_FRAMES, EARLY_EXIT, BUDGET = 65536, 5, 4096


def family(tag):
    """(base, lift, punctured base columns) of the rate ``tag``."""
    return lt.create_pbrl_qc_protograph(
        k=K, rate=RATES[tag], lift=LIFT, precode=True, core_rate=CORE_RATE)


def seed_ladders(tag: str):
    s = SEED_SCALE[tag]
    return tuple((round(c * s, 4), g) for c, g in CN_SEED), VQP8


def _ladder(p):
    """(CN, V2C) ladders of a design entry, as tuples of pairs."""
    return (tuple(tuple(x) for x in p["cn"]),
            tuple(tuple(x) for x in p["v2c"]))


def _read(path):
    with open(path) as f:
        return json.load(f)


def design(tag: str, max_passes: int = 6, grid_step: float = 1 / 16,
           verbose: bool = True):
    """Host: iterated refine for one rate (``pbrl_rates.py:70-92``);
    writes DESIGN_PATH and returns its dict."""
    base, lift, punct = family(tag)
    cn0, v2c0 = seed_ladders(tag)
    # the rate-1/3 grid is dominated by the degree-49 punctured column
    if tag == "13":
        grid_step = max(grid_step, 1 / 8)
    hist = dsg.iterate_refine(
        base, cn0, v2c0, bc=BC, bv=BV, max_iterations=T, snr_db=None,
        schedule="layered", punctured_cols=punct, max_passes=max_passes,
        min_gain_db=0.01, grid_step=grid_step,
        sweep=(0.5, 0.7, 0.9, 1.1, 1.4, 2.0), verbose=verbose)
    out = {"rate": RATES[tag], "mb": int(base.shape[0]),
           "grid_step": grid_step, **hist.to_dict()}
    with open(DESIGN_PATH.format(tag=tag), "w") as f:
        json.dump(out, f, indent=2)
    print(f"rate {tag}: best pass {hist.best.index} "
          f"thr {hist.best.threshold_db:.3f} dB ({hist.stopped_by})",
          flush=True)
    return out


def _load_design(tag, design_dir=None):
    """The rate's threshold design: the committed one, or the twin's in
    ``design_dir``."""
    return _read(DESIGN_RECORD.format(tag=tag) if design_dir is None else
                 os.path.join(design_dir, DESIGN_PATH.format(tag=tag)))


def _polish_path(tag, design_dir=None):
    return (POLISH_RECORD.format(tag=tag) if design_dir is None else
            os.path.join(design_dir, POLISH_PATH.format(tag=tag)))


def _best_ladder(tag, design_dir=None):
    """The rate's operational ladder: the floor-polished one when the
    polish phase has run, else the best threshold-refine pass."""
    path = _polish_path(tag, design_dir)
    if os.path.exists(path):
        return _read(path)
    d = _load_design(tag, design_dir)
    return d["passes"][d["best_index"]]


def _committed(tag, suffix):
    """A committed ladder ``pbrl_rates_design_<tag>_<suffix>.json``."""
    return _read(str(EXPERIMENTS / f"pbrl_rates_design_{tag}_{suffix}.json"))


def _q4_ladder(tag):
    """The rate's committed 4-pair ladder (``pbrl_rates_q4.py``)."""
    return _committed(tag, "q4")


def polish(tag: str, verbose: bool = True, design_dir=None):
    """Host: floor-objective polish of the threshold-designed ladder,
    anchored where its high-SNR DE floor peaks (``pbrl_rates.py:115-189``);
    writes POLISH_PATH and returns its dict."""
    from ldpc_tpu_torch.design import proto_dde

    base, lift, punct = family(tag)
    d = _load_design(tag, design_dir)
    bp = d["passes"][d["best_index"]]
    cn, vqp = _ladder(bp)
    thr = bp["threshold_db"]
    if thr >= 12.9:
        # a window bottom of 0.0 dB is a real one
        w = bp.get("window_db")
        thr = w if w is not None else 2.0
    gs = d.get("grid_step", 1 / 16)
    kw = dict(max_iterations=T, bc=BC, bv=BV, schedule="layered",
              punctured_cols=punct, grid_step=gs)
    # probe the post-waterfall region for the residual floor's peak
    probe = []
    for off in (0.5, 1.0, 1.5, 2.0, 3.0):
        r = proto_dde.protograph_density_evolution(
            base, snr_db=thr + off, kind="rcq", quantizer_params=cn,
            v2c_quantizer_params=vqp, **kw)
        probe.append((thr + off, float(r.error_prob[-1])))
        if verbose:
            print(f"  floor probe {thr + off:.2f} dB: "
                  f"{r.error_prob[-1]:.3e}", flush=True)
    peak_snr, peak_err = max(probe, key=lambda p: p[1])
    cur, cur_v, e = cn, vqp, peak_err
    if peak_err < 1e-12:
        # numerically clean already: a polish would chase noise
        print(f"rate {tag} polish: floor already clean "
              f"({peak_err:.1e}), skipping", flush=True)
        out = {"rate": RATES[tag], "anchor_db": peak_snr,
               "pre_err": peak_err, "post_err": peak_err,
               "cn": [list(p) for p in cur],
               "v2c": [list(p) for p in cur_v]}
        with open(POLISH_PATH.format(tag=tag), "w") as f:
            json.dump(out, f, indent=2)
        return out
    for i in range(2):
        cur, cur_v, e = proto_dde.refine_ladders_protograph(
            base, cur, cur_v, snr_db=peak_snr, objective="floor",
            guard_snr=thr, sweep=(0.6, 0.8, 0.9, 1.1, 1.25, 1.6),
            gammas=(1.0, 1.15, 1.3, 1.5, 1.8, 2.2), **kw)
        if verbose:
            print(f"  polish pass {i + 1}: err {e:.3e} cn {cur}",
                  flush=True)
    out = {"rate": RATES[tag], "anchor_db": peak_snr,
           "pre_err": peak_err, "post_err": float(e),
           "cn": [list(p) for p in cur], "v2c": [list(p) for p in cur_v]}
    with open(POLISH_PATH.format(tag=tag), "w") as f:
        json.dump(out, f, indent=2)
    print(f"rate {tag} polish: floor {peak_err:.3e} -> {e:.3e} "
          f"@ {peak_snr:.2f} dB", flush=True)
    return out


def install_tables(ck_dir: str = CK_DIR, names=None,
                   tables: str = TABLES) -> list:
    """Write a JAX program's trained tables (``tables``, by default this
    program's :data:`TABLES`) as ``save_checkpoint`` directories
    ``ck_dir/<checkpoint>``, each through ``weights_from_numpy``: the
    checkpoints ``names`` (default all in the file) that are not there yet
    (a table ``train`` wrote stays). Returns the names written."""
    done = []
    with np.load(tables) as f:
        have = sorted({k.split("/")[0] for k in f.files})
        for name in have if names is None else names:
            path = os.path.join(ck_dir, name)
            if os.path.exists(path):
                continue
            save_checkpoint(path, weights_from_numpy(
                {k: f[f"{name}/{k}"] for k in ("beta", "alpha")},
                device="cpu"))
            done.append(name)
    return done


def _mk_setup(tag, device="cuda", design_dir=None):
    """(``mk(arm)`` -> decoder, punctured bit positions, code) at the rate
    ``tag`` (``pbrl_rates.py:192-302``)."""
    base, lift, punct_cols = family(tag)
    qc = lt.build_qc_graph(base, lift)
    code = lt.create_qc_code(base, lift=lift, max_iterations=T)
    punct_bits = tuple(range(lift * punct_cols[0],
                             lift * (punct_cols[0] + 1)))
    fused = fused_options(device)
    common = dict(max_iterations=T, qc=qc, layered=True, device=device)

    def mk(arm):
        if arm == "oms6":   # the anchor
            dec = lt.make_decoder(
                code, kind="oms", sharing_type=2, bv=6,
                v2c_quantizer_params=VQP6, qc_options=dict(fused), **common)
            return dec.replace_weights({
                "beta": torch.full_like(dec.weights["beta"], 0.5),
                "alpha": torch.zeros_like(dec.weights["alpha"])})
        if arm == "rcq-seed":
            qp, vqp = seed_ladders(tag)
        elif arm == "rcq-best":
            d = _load_design(tag, design_dir)
            qp, vqp = _ladder(d["passes"][d["best_index"]])
        elif arm == "rcq-pol":             # floor-polished ladder
            qp, vqp = _ladder(_read(_polish_path(tag, design_dir)))
        elif arm == "rcq-pol3":            # two-point-guarded polish
            qp, vqp = _ladder(_committed(tag, "polish3"))
        elif arm in ("rcq-q4", "rcq-q5"):  # 4/5-pair ladder
            qp, vqp = _ladder(_committed(tag, arm[4:]))
        elif arm.startswith("rcq-p"):      # a refine pass
            d = _load_design(tag, design_dir)
            qp, vqp = _ladder(d["passes"][int(arm[5:])])
        elif arm.startswith("wrcq-"):
            per_layer = arm.endswith("pl")
            if per_layer:
                arm = arm[:-2]
            if arm.endswith("-q4"):
                p, ck = _q4_ladder(tag), f"orcq_{tag}_q4"
            elif arm.endswith("-pol3"):
                p, ck = _committed(tag, "polish3"), f"orcq_{tag}_pol3"
            else:
                p, ck = _best_ladder(tag, design_dir), f"orcq_{tag}"
            if per_layer:
                ck += "pl"
            install_tables(CK_DIR, [ck])
            qp, vqp = _ladder(p)
            dec = lt.make_decoder(
                code, kind="orcq", bc=BC, bv=BV, quantizer_params=qp,
                v2c_quantizer_params=vqp, sharing_type=2,
                per_layer=per_layer, qc_options=dict(fused), **common)
            return dec.replace_weights(load_checkpoint(
                os.path.join(CK_DIR, ck)))
        else:
            raise ValueError(arm)
        return lt.make_decoder(
            code, kind="rcq", bc=BC, bv=BV, quantizer_params=qp,
            v2c_quantizer_params=vqp, qc_options=dict(fused), **common)

    return mk, punct_bits, code


def train(tag: str, epochs: int = 30, ladder: str = "best",
          per_layer: bool = False, verbose: bool = True, device="cuda",
          design_dir=None):
    """Rate-specific W-OMS-RCQ on the rate's ladder (``ladder``: "best",
    the polished ladder where there is one; "q4"; "pol3"), saved to
    ``CK_DIR/orcq_<tag>[_q4|_pol3][pl]``; returns the trainer's history
    (``pbrl_rates.py:305-372``)."""
    _, punct_bits, _ = _mk_setup(tag, device, design_dir)
    if ladder == "q4":
        p = _q4_ladder(tag)
        thr = p["threshold_db"]
        ck_name = f"orcq_{tag}_q4"
    elif ladder == "pol3":
        p = _committed(tag, "polish3")
        thr = p["threshold_db"]
        ck_name = f"orcq_{tag}_pol3"
    else:
        d = _load_design(tag, design_dir)
        bp = d["passes"][d["best_index"]]
        if bp["threshold_db"] >= 12.9:
            w = bp.get("window_db")
            thr = w if w is not None else bp["threshold_db"]
        else:
            thr = bp["threshold_db"]
        p = _best_ladder(tag, design_dir)
        ck_name = f"orcq_{tag}"
    base, lift, _ = family(tag)
    if per_layer:
        ck_name += "pl"
    qp, vqp = _ladder(p)
    dec = lt.make_decoder(
        lt.create_qc_code(base, lift=lift, max_iterations=T), kind="orcq",
        bc=BC, bv=BV, quantizer_params=qp, v2c_quantizer_params=vqp,
        max_iterations=T, qc=lt.build_qc_graph(base, lift), layered=True,
        sharing_type=2, per_layer=per_layer,
        qc_options=fused_options(device), device=device)
    # the schedule's updates: epochs of 2048 frames in batches of 128
    steps = epochs * (2048 // 128)
    tr = lt.PosteriorJointTrainer(dec, lt.TrainingConfig(
        batch_size=BATCH, num_epochs=epochs, learning_rate=LEARNING_RATE,
        snr_range=(thr + 1.0, thr + 3.0), lr_schedule="cosine",
        warmup_steps=WARMUP_STEPS, decay_steps=steps,
        early_stop_accuracy=2.0, seed=0, punctured_positions=punct_bits))
    h = tr.train(num_samples=NUM_SAMPLES, verbose=verbose)
    os.makedirs(CK_DIR, exist_ok=True)
    save_checkpoint(os.path.join(CK_DIR, ck_name),
                    {k: v for k, v in dec.weights.items() if v is not None})
    print(f"trained orcq rate {tag} ({ck_name}): "
          f"loss {h['training_losses'][-1]:.5f}", flush=True)
    return h


def wave_size(n_bits: int) -> int:
    """Frames a wave: bench-sized work a launch on these shorter codes."""
    return min(262144, 32768 * max(1, round(9472 / n_bits)))


def _scan_arm(tag, arm, dec, punct_bits, snr_start, *, frames, errors,
              verbose=True, device="cuda"):
    """Adaptive deep scan of one arm (``pbrl_rates.py:375-438``): the
    points, resumed from and written to ``CK_DIR/<tag>_<arm>.json``
    after each."""
    os.makedirs(CK_DIR, exist_ok=True)
    ck_path = os.path.join(CK_DIR, f"{tag}_{arm}.json")
    points = {}
    if os.path.exists(ck_path):
        points = _read(ck_path)["points"]
    wave = wave_size(dec.code.n if hasattr(dec, "code") else 3096)

    def measure(snr, fr, er):
        key = f"{snr:.1f}"
        if key in points:
            return points[key]
        cfg = lt.SimulationConfig(
            snr_range=(snr, snr), max_frames=fr, max_errors=er,
            min_frames=MIN_FRAMES, wave_size=wave,
            early_exit_iters=EARLY_EXIT, survivor_budget=BUDGET,
            punctured_positions=punct_bits, save_results=False,
            device=device)
        fer, ber, avg_it, nf, ne = lt.simulate_single_snr(dec, snr, cfg)
        points[key] = {"fer": fer, "frames": nf, "errors": ne}
        with open(ck_path, "w") as f:
            json.dump({"arm": arm, "rate_tag": tag, "points": points}, f,
                      indent=2)
        if verbose:
            print(f"{tag}/{arm} @ {snr:.1f} dB: FER {fer:.3e} "
                  f"({ne}/{nf})", flush=True)
        return points[key]

    snr = snr_start
    # a start above the waterfall walks down until the FER is coarse
    for _ in range(12):
        p = measure(round(snr, 1), min(frames, 2 * 10 ** 6), errors)
        if p["fer"] >= 3e-4 or snr <= snr_start - 4.8:
            break
        snr -= 0.4
    # coarse walk with cheap caps to the waterfall
    for _ in range(16):
        p = measure(round(snr, 1), min(frames, 2 * 10 ** 6), errors)
        if p["fer"] <= 3e-3:
            break
        snr += 0.4
    # fine walk to the target
    for _ in range(14):
        p = measure(round(snr, 1), frames, errors)
        if p["fer"] <= FER_TARGET or p["errors"] == 0:
            break
        snr += 0.2
    return points


def deep(tag: str, arms, snr_start=None, frames=5 * 10 ** 7,
         errors: int = 100, verbose: bool = True, device="cuda",
         design_dir=None):
    """The adaptive deep scan of each arm at one rate; by default from the
    best pass's threshold + 0.2 dB (its convergence-window bottom where
    the threshold is capped)."""
    mk, punct_bits, _ = _mk_setup(tag, device, design_dir)
    if snr_start is None:
        d = _load_design(tag, design_dir)
        p = d["passes"][d["best_index"]]
        cap = p["threshold_db"] >= 12.9
        w = p.get("window_db")
        snr_start = round((w if w is not None else p["threshold_db"])
                          if cap else p["threshold_db"] + 0.2, 1)
    for arm in arms:
        _scan_arm(tag, arm, mk(arm), punct_bits, snr_start,
                  frames=frames, errors=errors, verbose=verbose,
                  device=device)


def _snr_at(points, target=FER_TARGET):
    """Log-linear interpolated SNR at ``target`` FER from scan points."""
    pts = sorted((float(s), v["fer"]) for s, v in points.items()
                 if v["fer"] > 0)
    for (s0, f0), (s1, f1) in zip(pts, pts[1:]):
        if f0 >= target >= f1:
            return s0 + (s1 - s0) * (math.log(f0 / target)
                                     / math.log(f0 / f1))
    return None


def report(out_path=OUT_PATH):
    """The per-rate scans in ``CK_DIR`` as the section VII-C table, with
    each arm's gap to ``oms6`` at FER 1e-6; written to ``out_path``."""
    table = {}
    for tag in RATES:
        row = {}
        for fn in os.listdir(CK_DIR) if os.path.isdir(CK_DIR) else []:
            if fn.startswith(f"{tag}_") and fn.endswith(".json"):
                arm = fn[len(tag) + 1:-5]
                pts = _read(os.path.join(CK_DIR, fn))["points"]
                row[arm] = {"points": pts, "snr_at_1e-6": _snr_at(pts)}
        if row:
            anchor = row.get("oms6", {}).get("snr_at_1e-6")
            for arm, r in row.items():
                if anchor and r["snr_at_1e-6"]:
                    r["gap_vs_oms6_db"] = round(r["snr_at_1e-6"] - anchor,
                                                3)
            table[tag] = {"rate": RATES[tag], "arms": row}
    with open(out_path, "w") as f:
        json.dump(table, f, indent=2)
    for tag, t in table.items():
        for arm, r in t["arms"].items():
            print(f"rate {tag} {arm:10s}: SNR@1e-6 = {r['snr_at_1e-6']} "
                  f"gap {r.get('gap_vs_oms6_db')}", flush=True)
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["design", "polish", "train",
                                        "deep", "report"], required=True)
    ap.add_argument("--rates", nargs="+", default=["89", "23", "12", "13"])
    ap.add_argument("--arms", nargs="+", default=["oms6", "rcq-best"])
    ap.add_argument("--frames", type=int, default=5 * 10 ** 7)
    ap.add_argument("--errors", type=int, default=100)
    ap.add_argument("--max-passes", type=int, default=6)
    ap.add_argument("--snr-start", type=float, default=None)
    ap.add_argument("--ladder", choices=["best", "q4", "pol3"],
                    default="best")
    ap.add_argument("--per-layer", action="store_true",
                    help="per-layer weight buckets (checkpoint *pl; "
                         "deep arm suffix ...pl)")
    ap.add_argument("--design-dir", default=None,
                    help="read the twin's own designs from this directory "
                         "(default: the committed ones)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.phase != "design":
        # the trainer's epoch lines and the simulator's heartbeat lines
        logging.basicConfig(level=logging.INFO, force=True)
    if args.phase == "design":
        for tag in args.rates:
            design(tag, max_passes=args.max_passes)
    elif args.phase == "polish":
        for tag in args.rates:
            polish(tag, design_dir=args.design_dir)
    elif args.phase == "train":
        for tag in args.rates:
            train(tag, ladder=args.ladder, per_layer=args.per_layer,
                  device=args.device, design_dir=args.design_dir)
    elif args.phase == "deep":
        for tag in args.rates:
            deep(tag, tuple(args.arms), snr_start=args.snr_start,
                 frames=args.frames, errors=args.errors, device=args.device,
                 design_dir=args.design_dir)
    else:
        report()


if __name__ == "__main__":
    main()
