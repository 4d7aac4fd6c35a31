"""Batched Monte-Carlo FER/BER simulation (counterpart of
``ldpc_tpu/sim/montecarlo.py``).

Frames are decoded in *waves* of ``wave_size`` all-zero codewords (BPSK(0)
= +1, so any decoded 1-bit is an error): channel, decode and the four
error counts (frame errors, bit errors, iteration sum, successes) run on
the device, and one host transfer per wave brings the counts back. The
stopping rule is the reference's (``max_frames`` or ``max_errors``) with
``min_frames`` enforced. Results are JSON key-compatible with the JAX
package's (and so with the reference's ``save_results``).

With ``early_exit_iters`` (T1) the wave is a compacting wave:

- of a fused decoder, the {T1, T} two-checkpoint decode of
  ``decode/early_exit.make_two_checkpoint_decoder`` (frames converged at
  T1 keep that output, up to ``survivor_budget`` others are re-decoded at
  T). When more frames survive than the budget holds, the whole wave falls
  back to the same schedule without compaction: the SAME LLRs are decoded
  at T1 and at T and each frame takes its T1 output if it converged there.
- of a non-fused (engine) decoder, QC or general or bucketed, the decoder
  truncated to T1 iterations on its own ``check_every`` schedule (T1
  rounded up to a check boundary),
  or with ``stage1_fused`` the fused flooding kernel with its single check
  at T1 (``check_every`` must equal T1); up to ``survivor_budget``
  unconverged frames are re-decoded from scratch by the decoder itself.
  Converged frames are frozen at their first check, so the pooled counts
  equal the plain wave's; on overflow the wave is the plain wave.

Frames past the budget never reach the statistics, and no noise is drawn
again.

Randomness: one ``torch.Generator`` on the simulation's device per (seed,
SNR index), so a resumed sweep gives the same statistics as an
uninterrupted one. Its numbers differ from the JAX package's threefry
keys for the same seed: agreement with it is statistical.

Not ported yet: ``mesh`` (parallel/), which raises
``NotImplementedError`` naming its ROADMAP.md Queue 1 item. The
``plot_*`` methods draw through ``report.plots`` (matplotlib, imported
only when a plot is drawn).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ldpc_tpu_torch.channel import awgn_llr, puncture_llr
from ldpc_tpu_torch.decode.early_exit import (gather_survivors,
                                              make_two_checkpoint_decoder,
                                              two_checkpoint_stages)
from ldpc_tpu_torch.decode.variants import (Decoder, _not_ported,
                                            resolve_device)

logger = logging.getLogger(__name__)

__all__ = [
    "SimulationConfig",
    "SimulationResult",
    "LDPCSimulator",
    "simulate_single_snr",
    "create_test_decoders",
    "point_generator",
]


@dataclasses.dataclass
class SimulationConfig:
    """The JAX package's ``SimulationConfig`` plus ``device``, where the
    waves run (the card unless ``"cpu"``). ``stage1_batch_tile`` is a TPU
    tiling knob, kept for parity and ignored."""

    snr_range: Tuple[float, float] = (0.0, 6.0)
    snr_step: float = 0.5
    max_frames: int = 10000
    max_errors: int = 100
    min_frames: int = 1000
    wave_size: int = 1024          # codewords per device wave
    seed: int = 0
    save_results: bool = True
    results_dir: str = "simulation_results"
    # two-checkpoint compaction of a fused decoder: decode every frame for
    # early_exit_iters first, re-decode only the survivors at full depth
    early_exit_iters: Optional[int] = None
    survivor_budget: Optional[int] = None  # default: wave_size // 4
    stage1_fused: bool = False
    stage1_batch_tile: int = 64
    # bit positions transmitted with no channel observation (LLR 0)
    punctured_positions: Optional[Tuple[int, ...]] = None
    device: str = "cuda"

    def snr_points(self) -> np.ndarray:
        lo, hi = self.snr_range
        return np.arange(lo, hi + 1e-9, self.snr_step)


class SimulationResult:
    """Per-decoder result container; field names match the reference's so
    saved JSON is interchangeable with the JAX package's."""

    def __init__(self, decoder_name: str, snr_values: Sequence[float]):
        self.decoder_name = decoder_name
        self.snr_values = list(snr_values)
        self.frame_error_rates: List[float] = []
        self.bit_error_rates: List[float] = []
        self.average_iterations: List[float] = []
        self.simulation_times: List[float] = []
        self.total_frames: List[int] = []
        self.total_errors: List[int] = []

    def add_result(self, snr_idx: int, fer: float, ber: float, avg_iter: float,
                   sim_time: float, total_frames: int, total_errors: int):
        while len(self.frame_error_rates) <= snr_idx:
            for lst, fill in (
                (self.frame_error_rates, 0.0), (self.bit_error_rates, 0.0),
                (self.average_iterations, 0.0), (self.simulation_times, 0.0),
                (self.total_frames, 0), (self.total_errors, 0),
            ):
                lst.append(fill)
        self.frame_error_rates[snr_idx] = float(fer)
        self.bit_error_rates[snr_idx] = float(ber)
        self.average_iterations[snr_idx] = float(avg_iter)
        self.simulation_times[snr_idx] = float(sim_time)
        self.total_frames[snr_idx] = int(total_frames)
        self.total_errors[snr_idx] = int(total_errors)

    def to_dict(self) -> dict:
        return {
            "decoder_name": self.decoder_name,
            "snr_values": self.snr_values,
            "frame_error_rates": self.frame_error_rates,
            "bit_error_rates": self.bit_error_rates,
            "average_iterations": self.average_iterations,
            "simulation_times": self.simulation_times,
            "total_frames": self.total_frames,
            "total_errors": self.total_errors,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SimulationResult":
        r = cls(d["decoder_name"], d["snr_values"])
        r.frame_error_rates = list(d["frame_error_rates"])
        r.bit_error_rates = list(d["bit_error_rates"])
        r.average_iterations = list(d["average_iterations"])
        r.simulation_times = list(d["simulation_times"])
        r.total_frames = list(d["total_frames"])
        r.total_errors = list(d["total_errors"])
        return r


def point_generator(seed: int, snr_idx: int, device) -> torch.Generator:
    """The generator of SNR point ``snr_idx`` of a sweep seeded ``seed``."""
    state = np.random.SeedSequence([seed, snr_idx]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _counts(bits, iterations, success, keep=None) -> torch.Tensor:
    """(frame errors, bit errors, iteration sum, successes) as an int64
    device tensor, over the frames ``keep`` selects (default all); bit
    sums accumulate in int64 whatever the bits' type."""
    wrong = bits.sum(dim=-1, dtype=torch.int64)
    iterations = iterations.to(torch.int64)
    if keep is not None:
        wrong, iterations = wrong * keep, iterations * keep
        success = success & keep
    return torch.stack([(wrong > 0).sum(), wrong.sum(), iterations.sum(),
                        success.sum(dtype=torch.int64)])


class _Wave:
    """One wave of the plain decoder: draw the LLRs, decode, count.
    ``kinds`` counts the waves run, by kind."""

    def __init__(self, decoder: Decoder, wave_size: int, device,
                 punctured=None):
        self.decoder = decoder
        n = decoder.code.n
        self.zeros = torch.zeros((wave_size, n), device=device)
        self.mask = (None if punctured is None else
                     puncture_llr(torch.ones(n, device=device), punctured))
        self.kinds = collections.Counter()

    def llr(self, gen: torch.Generator, snr) -> torch.Tensor:
        llr = awgn_llr(gen, self.zeros, snr)
        return llr if self.mask is None else llr * self.mask

    def counts(self, llr, weights=None) -> List[int]:
        out = self.decoder(llr, weights)
        self.kinds["plain"] += 1
        return _counts(out.bits, out.iterations, out.success).tolist()

    def __call__(self, gen: torch.Generator, snr, weights=None) -> List[int]:
        return self.counts(self.llr(gen, snr), weights)


class _CompactingWave(_Wave):
    """The {T1, T} two-checkpoint wave of a fused decoder, compacted when
    the survivors fit the budget, else decoded whole at both depths."""

    def __init__(self, decoder: Decoder, wave_size: int, device, t1: int,
                 survivor_budget: int, punctured=None):
        super().__init__(decoder, wave_size, device, punctured)
        self.budget = survivor_budget
        self.compacted = make_two_checkpoint_decoder(
            decoder, t1=t1, survivor_budget=survivor_budget)
        self.stage1, self.stage2 = two_checkpoint_stages(decoder, t1)

    def counts(self, llr, weights=None) -> List[int]:
        w = self.decoder.weights if weights is None else weights
        out, n_surv = self.compacted(llr, w)
        c = _counts(out.bits, out.iterations, out.success)
        vals = torch.cat([c, n_surv.view(1).to(torch.int64)]).tolist()
        if vals[4] <= self.budget:
            self.kinds["compacted"] += 1
            return vals[:4]
        # survivor overflow: the same schedule on every frame of the wave
        self.kinds["fallback"] += 1
        o1 = self.stage1(llr, w)
        o2 = self.stage2(llr, w)
        conv = o1.success
        bits = torch.where(conv[:, None], o1.bits, o2.bits)
        iters = torch.where(conv, o1.iterations, o2.iterations)
        return _counts(bits, iters, conv | o2.success).tolist()


class _EngineCompactingWave(_Wave):
    """The compacting wave of a non-fused decoder: a truncated (or, with
    ``stage1_fused``, fused) stage 1, the decoder itself on the survivors,
    and the plain wave when more survive than the budget holds."""

    def __init__(self, decoder: Decoder, wave_size: int, device, t1: int,
                 survivor_budget: int, stage1_fused: bool, punctured=None):
        super().__init__(decoder, wave_size, device, punctured)
        self.budget, self.t1 = survivor_budget, t1
        short = decoder.truncated(t1)
        if stage1_fused:
            if decoder.qc is None:
                raise ValueError("stage1_fused needs a QC decoder")
            ce = (decoder.qc_options or {}).get("check_every")
            if ce != t1:
                raise ValueError(
                    f"stage1_fused requires check_every == early_exit_iters "
                    f"(got {ce} vs {t1}): the fused kernel checks once at "
                    "T1, which must be the truncated decoder's schedule")
            opts = dict(short.qc_options, fused=True)
            opts.pop("check_every")
            opts.pop("unroll", None)
            short = dataclasses.replace(short, qc_options=opts)
        self.short = short

    def counts(self, llr, weights=None) -> List[int]:
        w = self.decoder.weights if weights is None else weights
        out1 = self.short(llr, {k: (None if a is None else a[:self.t1])
                                for k, a in w.items()})
        conv = out1.success
        llr2, _, valid, _, n_surv = gather_survivors(llr, conv, self.budget)
        out2 = self.decoder(llr2, w)
        # stage 1 counts the frames it settled, stage 2 its valid rows
        c = (_counts(out1.bits, out1.iterations, out1.success, conv) +
             _counts(out2.bits, out2.iterations, out2.success, valid))
        vals = torch.cat([c, n_surv.view(1).to(torch.int64)]).tolist()
        if vals[4] <= self.budget:
            self.kinds["compacted"] += 1
            return vals[:4]
        self.kinds["fallback"] += 1  # survivor overflow: the plain wave
        out = self.decoder(llr, weights)
        return _counts(out.bits, out.iterations, out.success).tolist()


def _build_wave(decoder: Decoder, config: SimulationConfig, mesh=None):
    if mesh is not None:
        raise _not_ported("mesh-sharded simulation", "parallel/")
    device = resolve_device(config.device)
    punct = config.punctured_positions
    if config.early_exit_iters is None:
        return _Wave(decoder, config.wave_size, device, punct)
    opts = decoder.qc_options or {}
    budget = (config.survivor_budget if config.survivor_budget is not None
              else max(1, config.wave_size // 4))
    t1 = config.early_exit_iters
    ce = opts.get("check_every")
    if ce and t1 % ce:
        # stage 1 is judged on the decoder's own check schedule: round up
        t1 = ((t1 + ce - 1) // ce) * ce
    if not opts.get("fused"):
        return _EngineCompactingWave(decoder, config.wave_size, device, t1,
                                     budget, config.stage1_fused, punct)
    return _CompactingWave(decoder, config.wave_size, device, t1, budget,
                           punct)


def simulate_single_snr(
    decoder: Decoder,
    snr_db: float,
    config: SimulationConfig,
    gen: Optional[torch.Generator] = None,
    wave_fn=None,
) -> Tuple[float, float, float, int, int]:
    """Monte-Carlo at one SNR point: returns (fer, ber, avg_iter, frames,
    frame_errors). Waves run until ``frames >= max_frames`` or
    ``frame_errors >= max_errors`` once ``frames >= min_frames``. ``gen``
    defaults to a generator seeded with ``config.seed`` on
    ``config.device``."""
    device = resolve_device(config.device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(config.seed)
    if wave_fn is None:
        wave_fn = _build_wave(decoder, config)
    snr = torch.tensor(snr_db, dtype=torch.float32, device=device)

    frames = 0
    frame_errors = 0
    bit_errors = 0
    iter_sum = 0
    last_beat = time.time()
    while frames < config.max_frames:
        if frame_errors >= config.max_errors and frames >= config.min_frames:
            break
        fe, be, it, _ = wave_fn(gen, snr)
        frames += config.wave_size
        frame_errors += fe
        bit_errors += be
        iter_sum += it
        now = time.time()
        if now - last_beat >= 60:
            last_beat = now
            logger.info("  ... %.2f dB: %d/%d frames, %d errors",
                        snr_db, frames, config.max_frames, frame_errors)

    fer = frame_errors / frames
    ber = bit_errors / (frames * decoder.code.n)
    avg_iter = iter_sum / frames
    return fer, ber, avg_iter, frames, frame_errors


class LDPCSimulator:
    """Multi-decoder Monte-Carlo harness. Decoders run one after another,
    each sweep saturating the device with its waves. ``wave_kinds[name]``
    lists, per SNR point, how many waves of each kind ran ("plain",
    "compacted", "fallback")."""

    def __init__(self, config: Optional[SimulationConfig] = None, mesh=None):
        if mesh is not None:
            raise _not_ported("mesh-sharded simulation", "parallel/")
        self.config = config or SimulationConfig()
        self.results: Dict[str, SimulationResult] = {}
        self.wave_kinds: Dict[str, List[Dict[str, int]]] = {}

    def simulate_decoder(self, decoder: Decoder,
                         decoder_name: Optional[str] = None,
                         verbose: bool = True,
                         checkpoint: Optional[str] = None) -> SimulationResult:
        """SNR sweep for one decoder.

        ``checkpoint``: path of a JSON file updated after every SNR point;
        if it already exists, completed points are skipped on restart.
        Each point draws from its own generator (:func:`point_generator`),
        so resumed and uninterrupted runs produce identical statistics.
        """
        name = decoder_name or decoder.name
        snrs = self.config.snr_points()
        result = SimulationResult(name, [float(s) for s in snrs])
        done_points = 0
        if checkpoint and os.path.exists(checkpoint):
            with open(checkpoint) as f:
                saved = SimulationResult.from_dict(json.load(f))
            if saved.snr_values == result.snr_values:
                result = saved
                done_points = len(saved.frame_error_rates)
                if verbose and done_points:
                    logger.info("%s: resuming after %d completed SNR points",
                                name, done_points)
        wave_fn = _build_wave(decoder, self.config)
        device = resolve_device(self.config.device)
        kinds = self.wave_kinds.setdefault(name, [])
        for idx, snr in enumerate(snrs):
            if idx < done_points:
                continue
            wave_fn.kinds.clear()
            t0 = time.time()
            fer, ber, avg_iter, frames, errors = simulate_single_snr(
                decoder, float(snr), self.config,
                gen=point_generator(self.config.seed, idx, device),
                wave_fn=wave_fn)
            dt = time.time() - t0
            kinds.append(dict(wave_fn.kinds))
            result.add_result(idx, fer, ber, avg_iter, dt, frames, errors)
            if checkpoint:
                with open(checkpoint, "w") as f:
                    json.dump(result.to_dict(), f)
            if verbose:
                logger.info(
                    "%s @ %.2f dB: FER=%.3e BER=%.3e iters=%.2f "
                    "(%d frames, %.2fs, %.0f fps)",
                    name, snr, fer, ber, avg_iter, frames, dt, frames / dt)
        self.results[name] = result
        return result

    def simulate_multiple_decoders(
        self, decoders: Dict[str, Decoder], verbose: bool = True
    ) -> Dict[str, SimulationResult]:
        """Compare several decoders. A decoder that fails is logged and
        dropped from the results, as in the JAX package; a route that is
        not ported yet raises instead of dropping out silently."""
        for name, dec in decoders.items():
            try:
                self.simulate_decoder(dec, name, verbose=verbose)
            except NotImplementedError:
                raise
            except Exception:
                logger.exception("decoder %s failed; dropped from results",
                                 name)
        return self.results

    # -- plotting (report/plots.py)

    def plot_fer_curves(self, path: str = "fer_comparison.png",
                        results=None):
        from ldpc_tpu_torch.report import plot_fer_curves
        return plot_fer_curves(results or self.results, path)

    def plot_ber_curves(self, path: str = "ber_comparison.png",
                        results=None):
        from ldpc_tpu_torch.report import plot_ber_curves
        return plot_ber_curves(results or self.results, path)

    def plot_iteration_curves(self, path: str = "iterations.png",
                              results=None):
        from ldpc_tpu_torch.report import plot_iteration_curves
        return plot_iteration_curves(results or self.results, path)

    def plot_timing_curves(self, path: str = "timing.png", results=None):
        from ldpc_tpu_torch.report import plot_timing_curves
        return plot_timing_curves(results or self.results, path)

    # -- persistence (format-compatible with the JAX package's)

    def save_results(self,
                     results: Optional[Dict[str, SimulationResult]] = None,
                     filename: str = "simulation_results.json"):
        """Write ``results`` (default: ``self.results``) as JSON under
        ``config.results_dir``; returns the path."""
        results = results if results is not None else self.results
        os.makedirs(self.config.results_dir, exist_ok=True)
        path = os.path.join(self.config.results_dir, filename)
        with open(path, "w") as f:
            json.dump({k: r.to_dict() for k, r in results.items()}, f,
                      indent=2)
        logger.info("Results saved to %s", path)
        return path

    def load_results(self, filename: str) -> Dict[str, SimulationResult]:
        path = os.path.join(self.config.results_dir, filename)
        with open(path) as f:
            data = json.load(f)
        results = {k: SimulationResult.from_dict(v) for k, v in data.items()}
        self.results.update(results)
        return results


def create_test_decoders(code, max_iterations: int = 10,
                         device="cuda") -> Dict[str, Decoder]:
    """The reference's 9-decoder comparison set plus W-OMS-RCQ, built on
    ``device``. On a code without a QC structure (every code of
    ``examples.py``) each decodes on the general flooding engine."""
    from ldpc_tpu_torch.decode.variants import (
        basic_min_sum, neural_2d_min_sum, neural_min_sum,
        neural_offset_min_sum, rcq_min_sum, weighted_oms_rcq, weighted_rcq)

    kw = dict(max_iterations=max_iterations, device=device)
    qp = ((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))
    zoo: Dict[str, Decoder] = {
        "Basic-MinSum": basic_min_sum(code, factor=0.7, **kw),
        "N-NMS": neural_min_sum(code, **kw),
        "N-OMS": neural_offset_min_sum(code, **kw),
    }
    for t in (1, 2, 3, 4):
        zoo[f"N-2D-NMS-T{t}"] = neural_2d_min_sum(code, weight_sharing_type=t,
                                                  **kw)
    zoo["RCQ"] = rcq_min_sum(code, bc=3, bv=8, quantizer_params=qp, **kw)
    zoo["W-RCQ-T2"] = weighted_rcq(code, bc=3, bv=8, weight_sharing_type=2,
                                   quantizer_params=qp, **kw)
    zoo["W-OMS-RCQ-T2"] = weighted_oms_rcq(code, bc=3, bv=8,
                                           weight_sharing_type=2,
                                           quantizer_params=qp, **kw)
    return zoo
