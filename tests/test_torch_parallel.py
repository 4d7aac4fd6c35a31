"""The port's ``parallel/`` against ``ldpc_tpu.parallel`` and against its
own single-device paths, at ``tests/test_parallel.py``'s sizes (the (7,4)
code, PEG(128, 64), 3x8 bases at lift 16).

- a world of one (no process group) gives the single-device waves, the
  simulator and the trainer bit for bit;
- two gloo ranks on the CPU, started once for the module
  (``parallel.spawn``): the pooled counts of the plain, compacting
  (including the 0 dB per-rank fallback) and punctured waves equal the sum
  of the per-rank counts computed here with each rank's generator, bit for
  bit; the bench program's pooled stats equal the single-device
  two-checkpoint decode and ``ldpc_tpu``'s 8-device stats exactly (f32
  hard outputs are exact by the parity contract); the mesh simulator's
  FER agrees with ``ldpc_tpu``'s 8-device mesh FER within 6 standard
  errors + 0.02 (the JAX test's band; the two draw other noise); two
  data-parallel steps leave the weights within rtol 1e-5 of one process's
  steps on the same global batches (the ranks' half-batch sums round in
  another order), and within the trainer tolerance of
  ``tests/test_torch_train.py`` (loss rtol 2e-5, accuracy rtol 1e-6, norm
  rtol 1e-4, weights rtol 1e-6 / atol 1e-6) of ``ldpc_tpu``'s trainer on
  an 8-device mesh.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu_torch as lt
from ldpc_tpu.parallel import make_mesh as jax_make_mesh
from ldpc_tpu_torch.decode.early_exit import make_two_checkpoint_decoder
from ldpc_tpu_torch.parallel import (Mesh, batch_sharding, distributed_init,
                                     make_mesh, make_spmd_compacting_wave_fn,
                                     make_spmd_two_checkpoint_stats_fn,
                                     make_spmd_wave_fn, replicated, spawn)
from ldpc_tpu_torch.parallel import launch
from ldpc_tpu_torch.sim.montecarlo import (_counts, _EngineCompactingWave,
                                           _Wave, point_generator)
from torch_port_helpers import (channel_llr, decoder_pair, general_route_pair,
                                make_base,
                                one_torch_thread)  # noqa: F401 (autouse)

CPU = torch.device("cpu")
WAVE, SEED, PUNCT = 512, 21, tuple(range(6))
# the compacting waves: (snr, early_iters, global budget); 0 dB overflows
# every rank's 128 slots
COMPACT = [(2.0, 3, 256), (0.0, 3, 256)]
SIM = dict(snr_range=(2.0, 2.0), snr_step=1.0, max_frames=4096,
           max_errors=10 ** 9, min_frames=0, wave_size=2048,
           save_results=False)
# the bench program: ldpc_tpu's test_spmd_two_checkpoint_matches_single_
# device decoder (3x8, lift 16, layered fused lean f32, T=6, t1=3)
TWO_CK_KW = dict(kind="rcq", bc=3, bv=8,
                 quantizer_params=((2.6, 1.3), (3.1, 1.3), (5.4, 1.3)),
                 v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
                 layered=True)
TWO_CK_B, TWO_CK_SNR, TWO_CK_SEED = 128, 1.5, 3
TRAIN_CFG = dict(batch_size=16, learning_rate=2e-3, snr_range=(1.0, 2.0))
TRAIN_SNR = 1.5


def mid_decoder():
    code = lt.create_peg_code(n=128, m=64, dv=3, seed=1, max_iterations=20)
    return lt.basic_min_sum(code, max_iterations=15, device="cpu")


def two_ck_pair():
    return decoder_pair(
        make_base(3, 8, 16, seed=7), 16, 6,
        jax_options=dict(fused=True, interpret=True, batch_tile=16,
                         dtype=jnp.float32, lean=True),
        torch_options=dict(fused=True, dtype=torch.float32, lean=True),
        **TWO_CK_KW)


def train_batches(n):
    return [(x, np.zeros_like(x)) for x in
            (channel_llr(TRAIN_CFG["batch_size"], n, TRAIN_SNR, seed=40 + i)
             for i in range(2))]


def local_counts(dec, per, rank, size, snr, compact=None, punct=None):
    """One rank's counts, computed in this process with its generator."""
    if compact is None:
        wave = _Wave(dec, per, CPU, punct)
    else:
        t1, budget = compact
        wave = _EngineCompactingWave(dec, per, CPU, t1, budget, False, punct)
    return np.array(wave(point_generator(SEED, 0, CPU, rank, size), snr))


@pytest.fixture(scope="module")
def two_ranks():
    """Every two-rank case, run by one spawn of two gloo ranks on the CPU;
    each rank's results by case name."""
    dec = mid_decoder()
    _, tdec = two_ck_pair()
    _, wdec = general_route_pair("flooding", "wrcq_t2")
    cases = {
        "plain": (launch.wave, (dec, WAVE, 2.0, SEED)),
        "plain0": (launch.wave, (dec, WAVE, 0.0, SEED)),
        "plain2.5": (launch.wave, (dec, WAVE, 2.5, SEED)),
        "punct": (launch.wave, (dec, WAVE, 2.5, SEED, 0, None, None, False,
                                PUNCT)),
        "punct_compact": (launch.wave, (dec, WAVE, 2.5, SEED, 0, 3, 256,
                                        False, PUNCT)),
        **{f"compact{snr}": (launch.wave, (dec, WAVE, snr, SEED, 0, t1, S))
           for snr, t1, S in COMPACT},
        "sim": (launch.simulate, (dec, lt.SimulationConfig(**SIM,
                                                           device="cpu"))),
        "two_ck": (launch.two_checkpoint_stats,
                   (tdec, TWO_CK_B, TWO_CK_SNR, TWO_CK_SEED, 3,
                    TWO_CK_B // 2)),
        "train": (launch.train_steps,
                  (wdec, lt.TrainingConfig(**TRAIN_CFG),
                   train_batches(wdec.code.n))),
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the children's torch threads
        ranks = spawn(launch.run_all, 2, "gloo", "cpu", list(cases.values()))
    return [dict(zip(cases, r)) for r in ranks]


# -- the mesh ------------------------------------------------------------------

def test_make_mesh():
    mesh = make_mesh(devices="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.axis_names == ("batch",) and mesh.device == CPU
    with pytest.raises(ValueError):
        make_mesh(10 ** 6, devices="cpu")
    x = torch.arange(12.0).view(6, 2)
    assert torch.equal(batch_sharding(mesh)(x), x)
    assert replicated(mesh)(x) is x
    # rank 1 of 3 takes the middle third; an indivisible batch raises
    third = batch_sharding(Mesh(3, 1, CPU))
    assert torch.equal(third(x), x[2:4])
    with pytest.raises(ValueError, match="divisible"):
        third(x[:5])
    # a single process needs no group; NCCL is never swapped for gloo
    distributed_init()
    with pytest.raises(RuntimeError, match="gloo"):
        distributed_init("tcp://localhost:1", 2, 0, backend="nccl")


def test_spmd_wave_rejects_indivisible():
    dec = lt.basic_min_sum(lt.create_test_ldpc_code(), device="cpu")
    mesh = Mesh(8, 0, CPU)
    with pytest.raises(ValueError):
        make_spmd_wave_fn(dec, 1023, mesh)
    with pytest.raises(ValueError):
        make_spmd_compacting_wave_fn(dec, 1024, 2, 100, mesh)
    # a fused parent cannot be truncated, so it has no mesh compaction
    base = make_base(2, 6, 16, seed=2)
    fused = lt.make_decoder(lt.create_qc_code(base, lift=16,
                                              max_iterations=4),
                            kind="ms", qc=lt.build_qc_graph(base, 16),
                            qc_options=dict(fused=True), device="cpu")
    with pytest.raises(ValueError, match="truncate"):
        make_spmd_compacting_wave_fn(fused, 1024, 2, 256, mesh)


# -- a world of one: the single-device paths, bit for bit ----------------------

@pytest.mark.parametrize("snr", [2.0, 0.0])
def test_world_of_one_waves_are_single_device(snr):
    dec, mesh = mid_decoder(), make_mesh(devices="cpu")
    gen = lambda: point_generator(SEED, 0, CPU)
    assert point_generator(SEED, 0, CPU, 0, 1).initial_seed() == \
        gen().initial_seed()
    assert make_spmd_wave_fn(dec, WAVE, mesh)(gen(), snr) == \
        _Wave(dec, WAVE, CPU)(gen(), snr)
    assert make_spmd_compacting_wave_fn(dec, WAVE, 3, 256, mesh)(
        gen(), snr) == _EngineCompactingWave(dec, WAVE, CPU, 3, 256,
                                             False)(gen(), snr)


def test_world_of_one_simulator_is_single_device():
    dec = mid_decoder()
    cfg = lt.SimulationConfig(**dict(SIM, max_frames=2048, wave_size=1024,
                                     snr_range=(2.0, 3.0)), device="cpu",
                              early_exit_iters=3, survivor_budget=256)
    res = [lt.LDPCSimulator(cfg, mesh=m).simulate_decoder(dec, verbose=False)
           for m in (None, make_mesh(devices="cpu"))]
    a, b = (dict(r.to_dict(), simulation_times=None) for r in res)
    assert a == b and a["total_frames"] == [2048, 2048]


def test_world_of_one_trainer_is_single_process():
    _, tdec = general_route_pair("flooding", "wrcq_t2")
    runs = []
    for mesh in (None, make_mesh(devices="cpu")):
        tr = lt.PosteriorJointTrainer(dataclasses.replace(tdec),
                                      lt.TrainingConfig(**TRAIN_CFG),
                                      mesh=mesh)
        stats = [tuple(float(v) for v in tr.train_step(
            torch.from_numpy(x), torch.from_numpy(y)))
            for x, y in train_batches(tdec.code.n)]
        runs.append((stats, tr.decoder.weights))
    assert runs[0][0] == runs[1][0]
    for k, w in runs[0][1].items():
        assert torch.equal(w, runs[1][1][k]), k


# -- two gloo ranks ----------------------------------------------------------

def test_two_ranks_agree(two_ranks):
    r0, r1 = two_ranks
    assert r0.keys() == r1.keys()
    for k in r0:
        if k == "sim":  # the wall-clock times are each rank's own
            assert dict(r0[k][0], simulation_times=None) == \
                dict(r1[k][0], simulation_times=None)
        elif k == "train":
            assert r0[k]["stats"] == r1[k]["stats"]
            for w in r0[k]["weights"]:
                assert np.array_equal(r0[k]["weights"][w],
                                      r1[k]["weights"][w])
        else:
            assert r0[k] == r1[k], k


SNRS = {"plain": 2.0, "plain0": 0.0, "plain2.5": 2.5, "punct": 2.5,
        "compact2.0": 2.0, "compact0.0": 0.0, "punct_compact": 2.5}


@pytest.mark.parametrize("case", list(SNRS))
def test_two_rank_counts_are_the_per_rank_sums(two_ranks, case):
    dec, per, snr = mid_decoder(), WAVE // 2, SNRS[case]
    compact = (3, 128) if "compact" in case else None
    punct = PUNCT if "punct" in case else None
    want = sum(local_counts(dec, per, r, 2, snr, compact, punct)
               for r in range(2))
    assert two_ranks[0][case] == want.tolist()
    if case == "compact0.0":  # every rank fell back to its full decode
        wave = _EngineCompactingWave(dec, per, CPU, 3, 128, False)
        for r in range(2):
            wave(point_generator(SEED, 0, CPU, r, 2), snr)
        assert wave.kinds == {"fallback": 2}


def test_two_rank_compaction_equals_the_plain_wave(two_ranks):
    """As ``ldpc_tpu``'s tests: per-rank compaction, fallback included,
    pools to the plain wave's counts on the same generators, punctured or
    not, and puncturing raises the frame errors on the same noise."""
    r = two_ranks[0]
    assert r["compact2.0"] == r["plain"] and r["compact0.0"] == r["plain0"]
    assert r["punct_compact"] == r["punct"]
    assert r["punct"][0] > r["plain2.5"][0]


def test_two_rank_simulator_fer_matches_jax_mesh(two_ranks):
    res, kinds = two_ranks[0]["sim"]
    assert res["total_frames"] == [4096] and kinds == [{"plain": 2}]
    fer = res["frame_error_rates"][0]
    jdec = ldpc_tpu.basic_min_sum(
        ldpc_tpu.create_peg_code(n=128, m=64, dv=3, seed=1,
                                 max_iterations=20), max_iterations=15)
    fer_8 = ldpc_tpu.LDPCSimulator(
        ldpc_tpu.SimulationConfig(**SIM), mesh=jax_make_mesh(8)
    ).simulate_decoder(jdec, verbose=False).frame_error_rates[0]
    assert fer > 0 and fer_8 > 0
    se = (fer_8 * (1 - fer_8) / 4096) ** 0.5
    assert abs(fer - fer_8) < 6 * se + 0.02


def test_two_rank_bench_program_equals_single_and_jax(two_ranks):
    from ldpc_tpu.parallel import \
        make_spmd_two_checkpoint_stats_fn as jax_stats_fn

    jdec, tdec = two_ck_pair()
    llr = launch.global_llr(TWO_CK_B, tdec.code.n, TWO_CK_SNR, TWO_CK_SEED,
                            CPU)
    out, n_surv = make_two_checkpoint_decoder(
        tdec, t1=3, survivor_budget=TWO_CK_B)(llr)
    single = _counts(out.bits, out.iterations, out.success).tolist() + [
        int(n_surv)]
    # a world of one through the same function
    one = make_spmd_two_checkpoint_stats_fn(
        tdec, t1=3, survivor_budget=TWO_CK_B, mesh=make_mesh(devices="cpu"))
    jax_8 = [int(v) for v in jax_stats_fn(
        jdec, t1=3, survivor_budget=TWO_CK_B // 8, mesh=jax_make_mesh(8))(
        jnp.asarray(llr.numpy()), jdec.weights)]
    assert two_ranks[0]["two_ck"] == single == one(llr).tolist() == jax_8
    assert 0 < single[3] < TWO_CK_B   # both outcomes occur


def test_two_rank_training_matches_one_process_and_jax(two_ranks):
    jdec, tdec = general_route_pair("flooding", "wrcq_t2")
    got = two_ranks[0]["train"]
    tr = lt.PosteriorJointTrainer(tdec, lt.TrainingConfig(**TRAIN_CFG))
    jtr = ldpc_tpu.PosteriorJointTrainer(
        jdec, ldpc_tpu.TrainingConfig(**TRAIN_CFG), mesh=jax_make_mesh(8))
    jw, state = jtr._trainable(jdec.weights), jtr.opt_state
    for (x, y), (loss, acc, gnorm) in zip(train_batches(tdec.code.n),
                                          got["stats"]):
        one = [float(v) for v in tr.train_step(torch.from_numpy(x),
                                               torch.from_numpy(y))]
        np.testing.assert_allclose([loss, acc, gnorm], one, rtol=1e-5)
        jw, state, jl, ja, jg = jtr._train_step(jw, state, jnp.asarray(x),
                                                jnp.asarray(y))
        np.testing.assert_allclose(loss, float(jl), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(acc, float(ja), rtol=1e-6)
        np.testing.assert_allclose(gnorm, float(jg), rtol=1e-4)
    assert got["weights"].keys() == {k for k, v in tdec.weights.items()
                                     if v is not None}
    for k, w in got["weights"].items():
        np.testing.assert_allclose(w, tdec.weights[k].numpy(), rtol=1e-5)
        np.testing.assert_allclose(w, np.asarray(jw[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_mesh_compaction_rounds_t1_up_as_single_device():
    """Both packages' single-device simulators round ``early_exit_iters``
    up to the decoder's check schedule; ``ldpc_tpu``'s mesh path raises
    for it instead, the port's mesh path rounds as its single device does
    (ROADMAP Queue 3)."""
    from ldpc_tpu.sim.montecarlo import _build_wave as jax_build_wave

    jdec, tdec = decoder_pair(make_base(2, 6, 16, seed=2), 16, 4,
                              jax_options=dict(check_every=2),
                              torch_options=dict(check_every=2), kind="ms")
    kw = dict(snr_range=(2.0, 2.0), snr_step=1.0, max_frames=128,
              max_errors=10 ** 9, min_frames=0, wave_size=64,
              early_exit_iters=3, survivor_budget=32, save_results=False)
    with pytest.raises(ValueError, match="multiple"):
        jax_build_wave(jdec, ldpc_tpu.SimulationConfig(**kw),
                       mesh=jax_make_mesh(8))
    cfg = lt.SimulationConfig(**kw, device="cpu")
    res = [lt.LDPCSimulator(cfg, mesh=m).simulate_decoder(tdec, verbose=False)
           for m in (None, make_mesh(devices="cpu"))]
    a, b = (dict(r.to_dict(), simulation_times=None) for r in res)
    assert a == b
