"""Close the 4-bit gap on the precoded PBRL graph: DE-designed ladders and
trained degree-shared weights against the 6-bit OMS anchor (paper section
VII-C; twin of ``experiments/pbrl_wrcq.py``).

The code is ``create_pbrl_qc_protograph(k=1032, rate=1/3, precode=True)``:
a 25x37 base at lift 86, n = 3182, base column 0 (86 bits) punctured.
Every decoder is layered T=10 through the whole-decode layered kernel
(K1, ``csrc/fused_layered.cu``), in bf16 on the card (on the CPU the
kernel's plain version in float32, as the JAX program switches to f32
off the TPU). The arms of :func:`build_arms`:

- ``oms6``: OMS with sharing type 2, its tables pinned to beta = 0.5,
  alpha = 0; the program's ``bv=6`` and 6-bit V2C ladder are ignored for
  ``oms`` (``make_decoder`` quantizes only ``rcq``, ``wrcq`` and
  ``orcq``), so it is a float OMS, as in the JAX record;
- ``rcq-<tag>``: RCQ bc=4, bv=8 on the ladder :func:`_ladder` gives the
  tag (``hand``: 6-11-16 @ 1.3; ``dde``: the 10-pair per-iteration
  design; ``ref2`` ... ``ref5``: the refine passes of
  ``pbrl_wrcq_design3.json`` with their refined V2C ladders);
  ``rcq5-<tag>``: the same with a 5-bit C2V quantizer in its closed
  form;
- ``wrcq-<tag>``: W-OMS-RCQ (``orcq``, sharing type 2, per-layer tables
  when the tag ends in ``pl``) with trained tables read with
  ``load_checkpoint`` from ``pbrl_wrcq_torch_ck/orcq_<tag>`` in the
  working directory. Where that checkpoint is missing,
  :func:`install_tables` first writes it from ``pbrl_wrcq_tables.npz``
  beside this module: the JAX program's seven trained tables, equal
  element for element to its orbax checkpoints
  ``experiments/pbrl_wrcq_ck/orcq_*`` (``tests/jax_reference_pbrl_wrcq.py``
  makes the file).

Phases (``--phase``, default ``all``):

- ``design`` (:func:`design_ladder`, host numpy): the per-iteration CN
  ladder of ``design_dynamic_quantizers`` on the precoded protograph,
  written to ``pbrl_wrcq_design_torch.json`` in ``--design-dir``. It
  runs only where the design that ``dde`` reads is missing: never without
  ``--design-dir`` (the committed design is there, as the JAX program
  skips its design at the repo root);
- ``train`` (:func:`train_arms`): W-OMS-RCQ type 2 on each ``--train-tags``
  ladder by ``PosteriorJointTrainer`` (batch 128, ``--epochs`` epochs of
  2048 frames, cosine from 2e-3 with 8 warm-up updates, 1.5-3.5 dB, the
  punctured bits' LLRs 0), saved to ``pbrl_wrcq_torch_ck/orcq_<tag>``;
- ``dev`` (:func:`dev_fer`): each arm at 2.0 and 2.4 dB to 100 errors or
  ``--frames`` frames under the {5, 10} two-checkpoint compaction (waves
  of 32768, survivor budget 4096, 65,536 frames at least), written to
  ``pbrl_wrcq_torch_dev.json``;
- ``deep`` (:func:`deep_fer`): ``--deep-arms`` from 2.0 to 3.2 dB in 0.2
  dB steps, each curve resumable in ``pbrl_wrcq_torch_ck/deep/``,
  written to ``pbrl_wrcq_torch_deep.json``.

The ``dde`` ladder is the committed ``experiments/pbrl_wrcq_design.json``
(read only), or with ``--design-dir DIR`` the twin's own design in DIR;
the refined ladders are the committed ``pbrl_wrcq_design3.json``.
Everything is written in the working directory, never under
``experiments/``.

    python -m ldpc_tpu_torch.cli.pbrl_wrcq [--phase
        design|train|dev|deep|all] [--frames 20000000] [--epochs 30]
        [--design-snr 2.6] [--deep-arms wrcq-ref3 rcq-ref3 oms6]
        [--train-tags hand dde ref3] [--design-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch import design as dsg
from ldpc_tpu_torch.cli import pbrl_rates
from ldpc_tpu_torch.cli.generate_images import EXPERIMENTS
from ldpc_tpu_torch.cli.pbrl_precode import K, RATE, T1, fused_options
from ldpc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["HAND_CN", "VQP8", "VQP6", "T", "DESIGN_PATH", "DESIGN_RECORD",
           "DESIGN3_RECORD", "CK_DIR", "DEV_OUT", "DEEP_OUT", "TABLES",
           "BATCH", "NUM_SAMPLES", "WAVE", "MIN_FRAMES", "BUDGET",
           "design_path", "design_ladder", "punctured_bits", "_mk_setup",
           "install_tables", "train_arms", "_load_trained", "_ladder",
           "build_arms", "dev_config", "dev_fer", "deep_fer", "main"]

HAND_CN = ((6.0, 1.3), (11.0, 1.3), (16.0, 1.3))   # the on-code ladder
VQP8 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
VQP6 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
T = 10
# the twin's own design (working directory) and the committed ones
DESIGN_PATH = "pbrl_wrcq_design_torch.json"
DESIGN_RECORD = str(EXPERIMENTS / "pbrl_wrcq_design.json")
DESIGN3_RECORD = str(EXPERIMENTS / "pbrl_wrcq_design3.json")
CK_DIR = "pbrl_wrcq_torch_ck"
DEV_OUT = "pbrl_wrcq_torch_dev.json"
DEEP_OUT = "pbrl_wrcq_torch_deep.json"
# the JAX program's trained tables, keyed <checkpoint>/<beta|alpha>
TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "pbrl_wrcq_tables.npz")
# a training epoch: batches of BATCH out of NUM_SAMPLES frames (the cosine
# schedule decays over the program's 16 updates an epoch whatever
# NUM_SAMPLES is); the simulations' wave, frames before the error target
# counts and survivor budget (read at call time)
BATCH, NUM_SAMPLES = 128, 2048
WAVE, MIN_FRAMES, BUDGET = 32768, 65536, 4096
# design3's key of each refine tag
_REFINED = {"ref3": "refined", "ref2": "refined2", "ref3it": "refined3",
            "ref4": "refined4", "ref5": "refined5"}


def _read(path):
    with open(path) as f:
        return json.load(f)


def design_path(design_dir=None):
    """The design the ``dde`` ladder reads: the committed one, or the
    twin's own in ``design_dir``."""
    return (DESIGN_RECORD if design_dir is None
            else os.path.join(design_dir, DESIGN_PATH))


def design_ladder(design_snr: float = 2.6, verbose: bool = True,
                  design_dir="."):
    """Host: the per-iteration CN ladder for the precoded protograph
    (``pbrl_wrcq.py:49-69``); writes DESIGN_PATH in ``design_dir`` and
    returns its dict."""
    base, lift, punct_cols = lt.create_pbrl_qc_protograph(
        k=K, rate=RATE, precode=True)
    params, de = dsg.design_dynamic_quantizers(
        base, snr_db=design_snr, max_iterations=T, bc=4, bv=8,
        v2c_quantizer_params=VQP8, schedule="layered",
        punctured_cols=tuple(punct_cols), init_params=HAND_CN)
    out = {"design_snr": design_snr, "bc": 4, "T": T,
           "params": [list(p) for p in params],
           "final_error": float(de.error_prob[-1]),
           "error_trajectory": [float(e) for e in de.error_prob]}
    with open(os.path.join(design_dir, DESIGN_PATH), "w") as f:
        json.dump(out, f, indent=2)
    if verbose:
        print(f"designed ladder: {params}", flush=True)
        print(f"DE error trajectory: {out['error_trajectory']}", flush=True)
    return out


def punctured_bits(lift, punct_cols):
    """The lifted bits of the first punctured base column."""
    return tuple(range(lift * punct_cols[0], lift * (punct_cols[0] + 1)))


def _mk_setup(device="cuda"):
    """(``mk(kind, qp, ...)`` -> decoder, punctured bit positions, code)
    on the precoded code (``pbrl_wrcq.py:72-109``); ``mk``'s ``bv`` (8 in
    this program) is the V2C quantizer's width of the probe programs
    (``pbrl_bv10``)."""
    base, lift, punct_cols = lt.create_pbrl_qc_protograph(
        k=K, rate=RATE, precode=True)
    qc = lt.build_qc_graph(base, lift)
    code = lt.create_qc_code(base, lift=lift, max_iterations=T)
    fused = fused_options(device)
    common = dict(max_iterations=T, qc=qc, layered=True, device=device)

    def mk(kind, qp, trained=None, vqp=VQP8, per_layer=False, bc=4, bv=8):
        kw = ({} if kind == "rcq"
              else dict(sharing_type=2, per_layer=per_layer))
        common["qc_options"] = dict(fused)
        if kind == "oms":
            dec = lt.make_decoder(code, kind="oms", sharing_type=2, bv=6,
                                  v2c_quantizer_params=VQP6, **common)
            return dec.replace_weights({
                "beta": torch.full_like(dec.weights["beta"], 0.5),
                "alpha": torch.zeros_like(dec.weights["alpha"])})
        dec = lt.make_decoder(code, kind=kind, bc=bc, bv=bv,
                              quantizer_params=qp, v2c_quantizer_params=vqp,
                              closed_qdq=(bc >= 5), **common, **kw)
        if trained is not None:
            dec = dec.replace_weights(trained)
        return dec

    return mk, punctured_bits(lift, punct_cols), code


def install_tables(ck_dir: str = CK_DIR, names=None) -> list:
    """The JAX program's trained tables (:data:`TABLES`) as
    ``save_checkpoint`` directories ``ck_dir/<checkpoint>`` where they
    are missing (``pbrl_rates.install_tables``); returns the names
    written."""
    return pbrl_rates.install_tables(ck_dir, names, TABLES)


def train_arms(epochs: int = 30, verbose: bool = True,
               tags=("hand", "dde", "ref3"), device="cuda",
               design_dir=None):
    """W-OMS-RCQ type 2 on each available ladder, saved to
    ``CK_DIR/orcq_<tag>`` (``pbrl_wrcq.py:112-145``); returns
    {tag: final loss and accuracy}, also written to
    ``CK_DIR/train_hist.json``."""
    mk, punct_bits, _ = _mk_setup(device)
    os.makedirs(CK_DIR, exist_ok=True)
    hist = {}
    for tag in tags:
        try:
            qp, vqp = _ladder(tag, design_dir)
        except (FileNotFoundError, KeyError) as e:
            print(f"skip {tag}: design missing ({e!r})", flush=True)
            continue
        dec = mk("orcq", qp, vqp=vqp, per_layer=tag.endswith("pl"))
        # the schedule's updates: epochs of 2048 frames in batches of 128
        steps = epochs * (2048 // 128)
        tr = lt.PosteriorJointTrainer(dec, lt.TrainingConfig(
            batch_size=BATCH, num_epochs=epochs, learning_rate=2e-3,
            snr_range=(1.5, 3.5), lr_schedule="cosine", warmup_steps=8,
            decay_steps=steps, early_stop_accuracy=2.0, seed=0,
            punctured_positions=punct_bits))
        h = tr.train(num_samples=NUM_SAMPLES, verbose=verbose)
        save_checkpoint(os.path.join(CK_DIR, f"orcq_{tag}"),
                        {k: v for k, v in dec.weights.items()
                         if v is not None})
        hist[tag] = {"final_loss": h["training_losses"][-1],
                     "final_acc": h["training_accuracies"][-1]}
        if verbose:
            print(f"trained orcq-{tag}: loss "
                  f"{h['training_losses'][-1]:.5f}", flush=True)
    with open(os.path.join(CK_DIR, "train_hist.json"), "w") as f:
        json.dump(hist, f, indent=2)
    return hist


def _load_trained(tag):
    """The trained tables of ``tag``: ``CK_DIR/orcq_<tag>``, installed
    from :data:`TABLES` first where missing."""
    install_tables(CK_DIR, [f"orcq_{tag}"])
    return load_checkpoint(os.path.join(CK_DIR, f"orcq_{tag}"))


def _ladder(tag, design_dir=None):
    """A ladder tag -> (CN params, V2C params) (``pbrl_wrcq.py:156-184``);
    ``dde`` from the committed design or the twin's in ``design_dir``."""
    if tag == "hand":
        return HAND_CN, VQP8
    if tag == "dde":   # per-iteration dynamic, designed against VQP8
        return (tuple(tuple(p) for p in
                      _read(design_path(design_dir))["params"]), VQP8)
    key = _REFINED.get(tag[:-2] if tag.endswith("pl") else tag)
    if key is None:
        raise ValueError(tag)
    d = _read(DESIGN3_RECORD)[key]
    return (tuple(tuple(p) for p in d["cn"]),
            tuple(tuple(p) for p in d["v2c"]))


def _trained_tags():
    """The tags with trained tables: a checkpoint in CK_DIR or a table
    in :data:`TABLES`."""
    have = set()
    if os.path.isdir(CK_DIR):
        have |= {n for n in os.listdir(CK_DIR) if n.startswith("orcq_")}
    with np.load(TABLES) as f:
        have |= {k.split("/")[0] for k in f.files}
    return {n[5:] for n in have}


def build_arms(which=("rcq-hand", "rcq-dde", "wrcq-hand", "wrcq-dde",
                      "oms6"), device="cuda", design_dir=None):
    """({name: decoder}, punctured bit positions) of the arms ``which``
    (``pbrl_wrcq.py:187-204``)."""
    mk, punct_bits, _ = _mk_setup(device)
    arms = {}
    for name in which:
        if name == "oms6":
            arms[name] = mk("oms", None)
            continue
        kind, tag = name.split("-")
        qp, vqp = _ladder(tag, design_dir)
        if kind == "rcq5":   # plain RCQ with a 5th C2V bit (closed qdq)
            arms[name] = mk("rcq", qp, vqp=vqp, bc=5)
        elif kind == "rcq":
            arms[name] = mk("rcq", qp, vqp=vqp)
        else:
            arms[name] = mk("orcq", qp, trained=_load_trained(tag),
                            vqp=vqp, per_layer=tag.endswith("pl"))
    return arms, punct_bits


def dev_config(snr, frames, errors, punct_bits, device="cuda",
               snr_step=None, snr_hi=None):
    """The program's simulation: {5, 10}, waves of 32768, survivor budget
    4096, 65,536 frames at least, the punctured bits' LLRs 0; one point
    at ``snr`` (a sweep to ``snr_hi`` in ``snr_step`` steps)."""
    extra = {} if snr_step is None else dict(snr_step=snr_step)
    return lt.SimulationConfig(
        snr_range=(snr, snr if snr_hi is None else snr_hi),
        max_frames=frames, max_errors=errors, min_frames=MIN_FRAMES,
        wave_size=WAVE, early_exit_iters=T1, survivor_budget=BUDGET,
        punctured_positions=punct_bits, save_results=False, device=device,
        **extra)


def dev_fer(frames: int = 2 * 10 ** 7, errors: int = 100,
            snrs=(2.0, 2.4), out_path=DEV_OUT, verbose: bool = True,
            which=None, device="cuda", design_dir=None):
    """Dev FER of each arm at ``snrs`` (``pbrl_wrcq.py:207-240``), written
    to ``out_path``; by default the hand, dde and ref3 RCQ arms, the
    anchor and each trained arm (hand, dde, ref3, ref3pl) that has
    tables."""
    if which is None:
        which = ["rcq-hand", "oms6"]
        if os.path.exists(design_path(design_dir)):
            which += ["rcq-dde"]
        if os.path.exists(DESIGN3_RECORD):
            which += ["rcq-ref3"]
        have = _trained_tags()
        for tag in ("hand", "dde", "ref3", "ref3pl"):
            if tag in have:
                which.append(f"wrcq-{tag}")
    arms, punct_bits = build_arms(tuple(which), device, design_dir)
    results = {}
    for name, dec in arms.items():
        results[name] = {}
        for snr in snrs:
            cfg = dev_config(snr, frames, errors, punct_bits, device)
            fer, ber, avg_it, nf, ne = lt.simulate_single_snr(dec, snr, cfg)
            results[name][str(snr)] = {"fer": fer, "ber": ber,
                                       "frames": nf, "errors": ne}
            if verbose:
                print(f"{name:10s} @ {snr} dB: FER {fer:.3e} "
                      f"({ne} errs / {nf} frames)", flush=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return results


def deep_fer(arm_names, frames: int = 2 * 10 ** 7, errors: int = 100,
             snr_lo: float = 2.0, snr_hi: float = 3.2,
             snr_step: float = 0.2, out_path=DEEP_OUT,
             verbose: bool = True, device="cuda", design_dir=None):
    """The deep curve of each arm (``pbrl_wrcq.py:243-271``), resumable
    per arm in ``CK_DIR/deep/<arm>.json``; the report goes to
    ``out_path``."""
    arms, punct_bits = build_arms(arm_names, device, design_dir)
    os.makedirs(os.path.join(CK_DIR, "deep"), exist_ok=True)
    curves = {}
    for name, dec in arms.items():
        cfg = dev_config(snr_lo, frames, errors, punct_bits, device,
                         snr_step=snr_step, snr_hi=snr_hi)
        sim = lt.LDPCSimulator(cfg)
        curves[name] = sim.simulate_decoder(
            dec, name, verbose=verbose,
            checkpoint=os.path.join(CK_DIR, "deep", f"{name}.json"))
    report = {"curves": {k: r.to_dict() for k, r in curves.items()}}
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["design", "train", "dev", "deep",
                                        "all"], default="all")
    ap.add_argument("--frames", type=int, default=2 * 10 ** 7)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--design-snr", type=float, default=2.6)
    ap.add_argument("--deep-arms", nargs="+",
                    default=["wrcq-ref3", "rcq-ref3", "oms6"])
    ap.add_argument("--train-tags", nargs="+",
                    default=["hand", "dde", "ref3"])
    ap.add_argument("--design-dir", default=None,
                    help="the twin's own dde design: read from this "
                         "directory, designed into it where missing "
                         "(default: the committed design)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the trainer's epoch lines and the simulator's heartbeat lines
    logging.basicConfig(level=logging.INFO, force=True)

    if args.phase in ("design", "all") and not os.path.exists(
            design_path(args.design_dir)):
        design_ladder(args.design_snr, design_dir=args.design_dir)
    if args.phase in ("train", "all"):
        train_arms(args.epochs, tags=tuple(args.train_tags),
                   device=args.device, design_dir=args.design_dir)
    if args.phase in ("dev", "all"):
        dev_fer(frames=args.frames, device=args.device,
                design_dir=args.design_dir)
    if args.phase == "deep":
        deep_fer(tuple(args.deep_arms), frames=args.frames,
                 device=args.device, design_dir=args.design_dir)


if __name__ == "__main__":
    main()
