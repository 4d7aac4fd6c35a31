"""The port's Monte-Carlo simulator (``ldpc_tpu_torch.sim``) on the CPU.

- The compacting wave of a fused parent (flooding and layered) equals the
  explicit program "decode every frame at T1 and at T, select by the T1
  syndrome", on the compacted and on the overflow path (as
  ``tests/test_sim.py`` holds the JAX wave), and on shared numpy LLRs its
  counts equal that program run by ``ldpc_tpu`` (f32, exact counts).
- The compacting wave of a non-fused (engine) parent gives the plain
  wave's counts exactly, compacted or on overflow, with stage 1 truncated
  or on the fused kernel (``tests/test_sim.py``'s three compaction tests,
  on a QC decoder).
- The stopping rule, JSON interchange with ``ldpc_tpu``'s results, resume
  from a checkpoint, puncturing and the failing-decoder rule.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu_torch as lt
from ldpc_tpu.decode.early_exit import \
    make_two_checkpoint_decoder as jax_two_checkpoint
from ldpc_tpu.sim import LDPCSimulator as JaxSimulator
from ldpc_tpu.sim import SimulationConfig as JaxConfig
from ldpc_tpu.sim import SimulationResult as JaxResult
from ldpc_tpu_torch.sim.montecarlo import _build_wave
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import channel_llr, decoder_pair

BASE = np.array([[0, 3, 5, 7, 2], [4, 1, 6, 0, 3]])
T, T1, WAVE = 8, 2, 256


def _decoder(layered, **opts):
    code = lt.create_qc_code(BASE, lift=16, max_iterations=T)
    return lt.rcq_min_sum(code, bc=4, max_iterations=T, layered=layered,
                          qc=lt.build_qc_graph(BASE, 16), device="cpu",
                          qc_options=dict(fused=True, dtype=torch.float32,
                                          **opts))


def _config(**kw):
    return lt.SimulationConfig(**{**dict(wave_size=WAVE, device="cpu"), **kw})


def _program(stage1, stage2, llr):
    """(frame errors, bit errors, iteration sum, successes) of the {T1, T}
    schedule decoded without compaction."""
    o1, o2 = stage1(llr), stage2(llr)
    conv = np.asarray(o1.success)
    bits = np.where(conv[:, None], np.asarray(o1.bits), np.asarray(o2.bits))
    iters = np.where(conv, np.asarray(o1.iterations),
                     np.asarray(o2.iterations))
    wrong = bits.astype(np.int64).sum(-1)
    return [int((wrong > 0).sum()), int(wrong.sum()), int(iters.sum()),
            int((conv | np.asarray(o2.success)).sum())]


@pytest.mark.parametrize("layered", [False, True],
                         ids=["flooding", "layered"])
def test_compacting_wave_equals_two_checkpoint_program(layered):
    dec = _decoder(layered, lean=True)
    stage1, stage2 = lt.decode.two_checkpoint_stages(dec, T1)
    for snr, path in ((2.5, "compacted"), (1.0, "fallback")):
        llr = _build_wave(dec, _config()).llr(
            torch.Generator().manual_seed(33), snr)
        # each path at its edge: a budget that holds exactly the draw's
        # survivors, or one fewer
        n_surv = int((~stage1(llr, dec.weights).success).sum())
        assert n_surv > 1
        wave = _build_wave(dec, _config(
            early_exit_iters=T1,
            survivor_budget=n_surv - (path == "fallback")))
        got = wave.counts(llr)
        assert dict(wave.kinds) == {path: 1}
        assert got == _program(lambda x: stage1(x, dec.weights),
                               lambda x: stage2(x, dec.weights), llr)
        # a drawn wave is the same computation on the generator's LLRs
        assert wave(torch.Generator().manual_seed(33), snr) == got


@pytest.mark.parametrize("layered", [False, True],
                         ids=["flooding", "layered"])
def test_wave_counts_match_jax_program(layered):
    """The port's wave on shared numpy LLRs counts what ``ldpc_tpu``'s
    two-checkpoint program counts on them, on both paths."""
    jdec, tdec = decoder_pair(
        BASE, 16, T,
        jax_options=dict(fused=True, batch_tile=16, interpret=True,
                         dtype=jnp.float32, lean=True),
        torch_options=dict(fused=True, dtype=torch.float32, lean=True),
        kind="rcq", bc=4, layered=layered)
    llr = channel_llr(96, tdec.code.n, 2.0, seed=4)
    x = jnp.asarray(llr)
    # stage 1 and stage 2 of ldpc_tpu's schedule, read off its own
    # two-checkpoint decoder with a budget that holds every frame
    ref, _ = jax_two_checkpoint(jdec, t1=T1, survivor_budget=96)(x)
    wrong = np.asarray(ref.bits).astype(np.int64).sum(-1)
    want = [int((wrong > 0).sum()), int(wrong.sum()),
            int(np.asarray(ref.iterations).sum()),
            int(np.asarray(ref.success).sum())]
    kinds = set()
    for budget in (96, 4):
        wave = _build_wave(tdec, _config(wave_size=96, early_exit_iters=T1,
                                         survivor_budget=budget))
        assert wave.counts(torch.from_numpy(llr)) == want
        kinds |= set(wave.kinds)
    assert kinds == {"compacted", "fallback"}
    assert 0 < want[0] < 96 and want[3] < 96


def test_stopping_rule():
    dec = _decoder(False)
    # max_errors stops the point early, once min_frames are in
    fer, ber, avg_iter, frames, errors = lt.simulate_single_snr(
        dec, 0.5, _config(max_frames=100 * WAVE, max_errors=50,
                          min_frames=0))
    assert errors >= 50 and frames == WAVE and fer == errors / frames
    assert 0.0 <= ber <= fer <= 1.0 and avg_iter == T
    _, _, _, frames, _ = lt.simulate_single_snr(
        dec, 0.5, _config(max_frames=100 * WAVE, max_errors=1,
                          min_frames=3 * WAVE))
    assert frames == 3 * WAVE
    # max_frames stops a clean point
    _, _, _, frames, errors = lt.simulate_single_snr(
        dec, 9.0, _config(max_frames=2 * WAVE, max_errors=10))
    assert frames == 2 * WAVE and errors == 0


def test_results_json_interchange(tmp_path):
    """A JSON written by ldpc_tpu loads into the port and is written back
    unchanged (and the port's own sweep writes the same keys)."""
    jr = JaxResult("W-OMS-RCQ", [6.0, 6.25])
    jr.add_result(0, 0.8, 0.01, 10.0, 1.5, 32768, 26000)
    jr.add_result(1, 0.1, 4.7e-4, 9.1, 0.5, 32768, 3300)
    JaxSimulator(JaxConfig(results_dir=str(tmp_path))).save_results(
        {"a": jr}, "jax.json")
    sim = lt.LDPCSimulator(_config(results_dir=str(tmp_path)))
    loaded = sim.load_results("jax.json")
    assert loaded["a"].to_dict() == jr.to_dict() and "a" in sim.results
    sim.save_results(filename="port.json")
    assert (json.loads((tmp_path / "port.json").read_text()) ==
            json.loads((tmp_path / "jax.json").read_text()))
    back = JaxSimulator(JaxConfig(results_dir=str(tmp_path))).load_results(
        "port.json")
    assert back["a"].to_dict() == jr.to_dict()


def test_resumed_sweep_equals_uninterrupted(tmp_path):
    dec = _decoder(False, lean=True)
    cfg = _config(snr_range=(1.0, 2.0), snr_step=0.5, max_frames=2 * WAVE,
                  max_errors=10 ** 6, min_frames=0, early_exit_iters=T1,
                  survivor_budget=64)
    whole = lt.LDPCSimulator(cfg).simulate_decoder(dec, "d", verbose=False)
    # a checkpoint holding the first point only, as an interrupted run
    # leaves it
    part = lt.SimulationResult("d", whole.snr_values)
    part.add_result(0, whole.frame_error_rates[0], whole.bit_error_rates[0],
                    whole.average_iterations[0], 0.0, whole.total_frames[0],
                    whole.total_errors[0])
    ck = tmp_path / "ck.json"
    ck.write_text(json.dumps(part.to_dict()))
    sim = lt.LDPCSimulator(cfg)
    resumed = sim.simulate_decoder(dec, "d", verbose=False,
                                   checkpoint=str(ck))
    assert len(sim.wave_kinds["d"]) == 2  # only points 1 and 2 ran
    for key in ("frame_error_rates", "bit_error_rates", "average_iterations",
                "total_frames", "total_errors"):
        assert getattr(resumed, key) == getattr(whole, key), key
    assert json.loads(ck.read_text())["total_errors"] == whole.total_errors
    assert whole.frame_error_rates[0] > whole.frame_error_rates[2]


@pytest.mark.parametrize("early", [None, T1], ids=["plain", "compacting"])
def test_punctured_positions(early):
    dec = _decoder(False, lean=True)
    punct = tuple(range(0, dec.code.n, 3))
    kw = dict(early_exit_iters=early, survivor_budget=WAVE)
    wave = _build_wave(dec, _config(punctured_positions=punct, **kw))
    clean = _build_wave(dec, _config(**kw))
    gen = lambda: torch.Generator().manual_seed(8)
    llr, ref = wave.llr(gen(), 3.0), clean.llr(gen(), 3.0)
    keep = np.setdiff1d(np.arange(dec.code.n), punct)
    assert (llr[:, list(punct)] == 0).all()
    assert torch.equal(llr[:, keep], ref[:, keep])
    fe_p = wave(gen(), 3.0)[0]
    fe_c = clean(gen(), 3.0)[0]
    assert fe_p > fe_c


def test_failing_decoder_dropped_and_test_decoders_built():
    good = _decoder(False)
    bad = lt.rcq_min_sum(good.code, bc=4, max_iterations=T,
                         qc=good.qc, device="cpu",
                         qc_options=dict(fused=True, check_every=1))
    sim = lt.LDPCSimulator(_config(snr_range=(3.0, 3.0), max_frames=WAVE))
    res = sim.simulate_multiple_decoders({"bad": bad, "good": good},
                                         verbose=False)
    assert list(res) == ["good"] and sim.wave_kinds["good"] == [{"plain": 1}]
    zoo = lt.create_test_decoders(good.code, max_iterations=5, device="cpu")
    jzoo = ldpc_tpu.create_test_decoders(
        ldpc_tpu.create_qc_code(BASE, lift=16, max_iterations=5),
        max_iterations=5)
    assert list(zoo) == list(jzoo)
    for name, d in zoo.items():
        assert d.name == jzoo[name].name and d.device.type == "cpu"
        assert d.param_count() == jzoo[name].param_count()


def _engine_decoder(**opts):
    """A non-fused QC decoder (the torch flooding engine), f32."""
    code = lt.create_qc_code(BASE, lift=16, max_iterations=T)
    return lt.rcq_min_sum(code, bc=4, max_iterations=T,
                          qc=lt.build_qc_graph(BASE, 16), device="cpu",
                          qc_options=opts or None)


def _plain_and_compacting(dec, **kw):
    plain = _build_wave(dec, _config())
    comp = _build_wave(dec, _config(**kw))
    return plain, comp


def test_compacting_wave_matches_full():
    """Early-exit compaction of a non-fused decoder gives the plain
    full-depth wave's pooled counts (same LLRs)."""
    plain, comp = _plain_and_compacting(_engine_decoder(), early_exit_iters=3,
                                        survivor_budget=192)
    for snr in (2.0, 3.0):
        llr = plain.llr(torch.Generator().manual_seed(42), snr)
        assert comp.counts(llr) == plain.counts(llr), snr
    assert dict(comp.kinds) == {"compacted": 2}


def test_compacting_wave_overflow_fallback():
    """More survivors than the budget: the plain wave, still exact."""
    plain, comp = _plain_and_compacting(_engine_decoder(), early_exit_iters=2,
                                        survivor_budget=8)
    llr = plain.llr(torch.Generator().manual_seed(1), 0.0)
    assert comp.counts(llr) == plain.counts(llr)
    assert dict(comp.kinds) == {"fallback": 1}
    # passed weights reach every stage
    dec = plain.decoder
    alt = {k: (None if w is None else w * 0.5)
           for k, w in dec.weights.items()}
    assert comp.counts(llr, alt) == plain.counts(llr, alt)


def test_compacting_wave_fused_stage1_exact():
    """stage1_fused routes the truncated decode through the fused flooding
    kernel (its plain version here); the counts equal both the plain wave
    and the engine-stage-1 compaction. Stage 1 keeps the parent's options,
    so the parent names f32 storage: the fused kernel's default is bf16,
    the engine's f32 (as in ldpc_tpu). T1 rounds up to the check schedule;
    a schedule other than check_every == T1 is refused."""
    dec = _engine_decoder(check_every=2, dtype=torch.float32)
    plain = _build_wave(dec, _config())
    comp = _build_wave(dec, _config(early_exit_iters=2, survivor_budget=192))
    compf = _build_wave(dec, _config(early_exit_iters=2, survivor_budget=192,
                                     stage1_fused=True))
    assert compf.short.qc_options == dict(fused=True, dtype=torch.float32)
    llr = plain.llr(torch.Generator().manual_seed(17), 2.5)
    want = plain.counts(llr)
    assert comp.counts(llr) == want and compf.counts(llr) == want
    assert dict(compf.kinds) == {"compacted": 1}
    # early_exit_iters=3 judges stage 1 at the decoder's check at 4
    assert _build_wave(dec, _config(early_exit_iters=3)).t1 == 4
    with pytest.raises(ValueError, match="check_every"):
        _build_wave(_engine_decoder(), _config(early_exit_iters=2,
                                               stage1_fused=True))
