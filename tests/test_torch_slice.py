"""The port's main path end to end through its public entry points
(``make_decoder``, the ``Decoder`` call, ``make_two_checkpoint_decoder``)
with the bench's decoder arguments, against ``ldpc_tpu`` with the same
arguments; plus the channel, the jax-free import, the device default, and
the routes ported after the main path (training, the engines, ``mesh=``).

The code is a 2x6 full base with lift 32 (the bench's 5x37, lift 256
shape class, cut to CPU size). Messages are f32 so that hard outputs can be
compared exactly (in bf16 XLA:CPU keeps excess precision; see
``test_torch_fused_layered.py``)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu_torch as lt
from ldpc_tpu.decode.qc_engine import build_qc_graph as jax_build_qc_graph
from ldpc_tpu_torch.parallel import make_mesh
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import channel_llr, make_base

T, T1 = 6, 3
BENCH_KW = dict(
    kind="rcq", bc=3, bv=8,
    quantizer_params=((2.6474, 1.3), (3.0869, 1.3), (5.3767, 1.3)),
    v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
    max_iterations=T, layered=True)


def test_slice_matches_jax_end_to_end():
    base = make_base(2, 6, 32, seed=1)
    jdec = ldpc_tpu.make_decoder(
        ldpc_tpu.create_qc_code(base, lift=32, max_iterations=T),
        qc=jax_build_qc_graph(base, 32),
        qc_options=dict(fused=True, batch_tile=16, dtype=jnp.float32,
                        lean=True, interpret=True), **BENCH_KW)
    tdec = lt.make_decoder(
        lt.create_qc_code(base, lift=32, max_iterations=T),
        qc=lt.build_qc_graph(base, 32),
        qc_options=dict(fused=True, batch_tile=16, dtype=torch.float32,
                        lean=True, natural=True), device="cpu", **BENCH_KW)
    llr = channel_llr(40, tdec.code.n, 5.0, seed=3)

    ref = jdec(jnp.asarray(llr))
    out = tdec(torch.from_numpy(llr))
    assert out.posterior is None and out.bits.dtype == torch.int8
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))

    ref2, ref_n = ldpc_tpu.make_two_checkpoint_decoder(
        jdec, t1=T1, survivor_budget=16)(jnp.asarray(llr))
    out2, n = lt.make_two_checkpoint_decoder(
        tdec, t1=T1, survivor_budget=16)(torch.from_numpy(llr))
    assert 0 < int(n) == int(ref_n) <= 16
    np.testing.assert_array_equal(out2.bits.numpy(), np.asarray(ref2.bits))
    np.testing.assert_array_equal(out2.success.numpy(),
                                  np.asarray(ref2.success))
    np.testing.assert_array_equal(out2.iterations.numpy(),
                                  np.asarray(ref2.iterations))
    # a single frame decodes as in the batch
    one = tdec(torch.from_numpy(llr[7]))
    np.testing.assert_array_equal(one.bits.numpy(), out.bits.numpy()[7])


def test_awgn_llr_reproducible_and_distributed():
    gen = lambda: torch.Generator().manual_seed(5)
    cw = torch.zeros((64, 512))
    a = lt.awgn_llr(gen(), cw, 2.0)
    b = lt.awgn_llr(gen(), cw, 2.0)
    assert a.dtype == torch.float32 and a.shape == (64, 512)
    assert torch.equal(a, b)
    assert not torch.equal(a, lt.awgn_llr(torch.Generator().manual_seed(6),
                                          cw, 2.0))
    # all-zero codeword: llr ~ N(2/s2, 4/s2) with s2 = 10^(-snr/10)
    s2 = 10.0 ** (-2.0 / 10.0)
    N = a.numel()
    mean, var = a.mean().item(), a.var().item()
    assert abs(mean - 2 / s2) < 5 * np.sqrt(4 / s2 / N)
    assert abs(var - 4 / s2) < 5 * (4 / s2) * np.sqrt(2 / N)
    # bit 1 -> -1; a per-sample SNR broadcasts over the bit axis
    ones = lt.awgn_llr(gen(), torch.ones((64, 512)), 2.0)
    assert ones.mean().item() < 0
    snr = torch.tensor([0.0, 10.0])
    per = lt.awgn_llr(gen(), torch.zeros((2, 4096)), snr, dtype=torch.bfloat16)
    assert per.dtype == torch.bfloat16
    assert per[1].float().mean().item() > 5 * per[0].float().mean().item()
    np.testing.assert_array_equal(
        lt.puncture_llr(torch.ones((2, 6)), [1, 4]).numpy(),
        np.array([[1, 0, 1, 1, 0, 1]] * 2, np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_normal_draws_are_jax_random_normals_transform(seed):
    """The channel's Gaussian draws from given random bits equal
    ``jax.random.normal``'s from the same bits (its top 23 of 32): the
    same 2^-22 uniform grid on [nextafter(-1, 0), 1) through sqrt(2)
    erfinv, within the two erfinv approximations' rounding (up to ≈ 5e-6
    relative, in the tails)."""
    import jax

    from ldpc_tpu_torch.channel import normal_from_bits, standard_normal

    key = jax.random.PRNGKey(seed)
    shape = (64, 1024)
    bits = np.asarray(jax.random.bits(key, shape, np.uint32)) >> 9
    want = np.asarray(jax.random.normal(key, shape, np.float32))
    got = normal_from_bits(torch.from_numpy(bits.astype(np.int32)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-7)
    extremes = normal_from_bits(torch.tensor([0, 2 ** 23 - 1]))
    assert -5.5 < extremes[0] < -5.3 and 5.0 < extremes[1] < 5.3
    draws = standard_normal(torch.Generator().manual_seed(seed),
                               (256, 1024), "cpu")
    assert abs(draws.mean().item()) < 0.01
    assert abs(draws.std().item() - 1.0) < 0.01


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import ldpc_tpu_torch, ldpc_tpu_torch.decode._build, "
            "ldpc_tpu_torch.zoo, ldpc_tpu_torch.sim, ldpc_tpu_torch.design, "
            "ldpc_tpu_torch.report, ldpc_tpu_torch.encode, "
            "ldpc_tpu_torch.sim.importance, ldpc_tpu_torch.utils, "
            "ldpc_tpu_torch.parallel, ldpc_tpu_torch.parallel.launch, "
            "ldpc_tpu_torch.cli.examples, ldpc_tpu_torch.cli.comprehensive, "
            "ldpc_tpu_torch.cli.generate_images, "
            "ldpc_tpu_torch.cli.graft_entry; "
            "assert 'ldpc_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_unported_routes_refuse(tmp_path):
    base = make_base(2, 6, 16, seed=2)
    code = lt.create_qc_code(base, lift=16, max_iterations=4)
    qc = lt.build_qc_graph(base, 16)
    llr = torch.zeros((2, code.n))
    fused = dict(fused=True, dtype=torch.float32)
    mk = lambda **kw: lt.make_decoder(code, kind="ms", device="cpu", **kw)
    # the training calls (train/) run on every route, a fused decoder's on
    # its engine
    for dec, kw in [
        (mk(layered=True), dict(ste=True)),
        (mk(bucketed=True), dict(return_trajectory=True)),
        (mk(qc=qc, layered=True), dict(ste=True)),
        (mk(qc=qc), dict(return_trajectory=True)),
        (mk(qc=qc, layered=True, qc_options=fused), dict(ste=True)),
        (mk(qc=qc, layered=True, qc_options=fused),
         dict(return_trajectory=True)),
        (mk(qc=qc, qc_options=fused), dict(ste=True)),
    ]:
        assert dec(llr, **kw).bits.shape == (2, code.n)
    # data-parallel training (parallel/) runs on a one-rank mesh
    mesh = make_mesh(devices="cpu")
    tr = lt.PosteriorJointTrainer(lt.neural_min_sum(code, device="cpu"),
                                  mesh=mesh)
    x = torch.full((2, code.n), 4.0)
    assert all(torch.isfinite(v) for v in tr.train_step(x, x * 0))
    # the QC engines and the general, layered and bucketed engines run
    # (every inference route and the simulator's compaction over the
    # engines are ported)
    for dec in (mk(qc=qc), mk(qc=qc, layered=True), mk(), mk(layered=True),
                mk(bucketed=True)):
        assert dec(llr).bits.shape == (2, code.n)
    cfg = dict(max_frames=4, wave_size=2, device="cpu")
    for sim_kw in (dict(early_exit_iters=2), dict(early_exit_iters=2,
                                                  stage1_fused=True)):
        dec = mk(qc=qc, qc_options=dict(check_every=2))
        assert lt.simulate_single_snr(
            dec, 3.0, lt.SimulationConfig(**cfg, **sim_kw))[3] == 4
    # the simulator shards its waves over a mesh (parallel/); its plots
    # draw through report/
    res = lt.LDPCSimulator(lt.SimulationConfig(**cfg), mesh=mesh
                           ).simulate_decoder(mk(qc=qc), verbose=False)
    assert res.total_frames == [4] * len(res.snr_values)
    sim = lt.LDPCSimulator(lt.SimulationConfig(**cfg))
    res = lt.SimulationResult("MS", [1.0, 2.0])
    res.add_result(0, 0.5, 0.1, 5.0, 1.0, 1000, 500)
    res.add_result(1, 0.1, 0.01, 4.0, 1.0, 1000, 100)
    sim.results = {"MS": res}
    for plot in ("plot_fer_curves", "plot_ber_curves",
                 "plot_iteration_curves", "plot_timing_curves"):
        path = str(tmp_path / f"{plot}.png")
        assert getattr(sim, plot)(path) == path
        assert os.path.getsize(path) > 1000
    # a dropped decoder never hides an unported route

    class Unported:
        name, qc_options, weights = "unported", None, {}

        def __init__(self):
            self.code = code

        def __call__(self, llr, weights=None):
            raise NotImplementedError("ROADMAP.md Queue 1: train/")

    with pytest.raises(NotImplementedError):
        sim.simulate_multiple_decoders({"unported": Unported()},
                                       verbose=False)


def test_device_defaults_to_the_card(monkeypatch):
    """Without a card the entry points raise instead of running on the
    CPU; with device="cpu" the decoder, its weights and the zoo load live
    there, and replace_weights keeps weights on the decoder's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = make_base(2, 6, 16, seed=2)
    code = lt.create_qc_code(base, lift=16, max_iterations=4)
    qc = lt.build_qc_graph(base, 16)
    for call in (lambda: lt.make_decoder(code, kind="orcq", sharing_type=2,
                                         qc=qc),
                 lambda: lt.load_pretrained("worcq_bc3_layered_t4"),
                 lambda: lt.simulate_single_snr(
                     lt.make_decoder(code, kind="ms", qc=qc, device="cpu"),
                     3.0, lt.SimulationConfig())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    dec = lt.make_decoder(code, kind="orcq", sharing_type=2, qc=qc,
                          device="cpu")
    assert dec.device == torch.device("cpu")
    assert all(w.device.type == "cpu" for w in dec.weights.values())
    moved = dec.replace_weights({k: np.ones((4, w.shape[1]))
                                 for k, w in dec.weights.items()})
    assert all(w.device.type == "cpu" and w.dtype == torch.float32
               for w in moved.weights.values())
    # the same seed draws the same weights as before the device argument
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(dec.weights["beta"],
                       0.1 * torch.randn((4, dec.weights["beta"].shape[1]),
                                         generator=gen))


def test_fused_wrapper_refuses_other_devices(monkeypatch):
    """A tensor on neither the CPU nor a CUDA card raises, and never falls
    back to the plain version."""
    from ldpc_tpu_torch.decode import fused

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(fused, "_fused_layered_plain", no_plain)
    base = make_base(2, 6, 16, seed=2)
    code = lt.create_qc_code(base, lift=16, max_iterations=4)
    monkeypatch.setattr(fused, "_fused_flooding_plain", no_plain)
    for layered in (True, False):
        dec = lt.make_decoder(code, kind="ms", qc=lt.build_qc_graph(base, 16),
                              layered=layered, qc_options=dict(fused=True),
                              device="cpu")
        before = (fused.LAYERED_LAUNCHES, fused.FLOODING_LAUNCHES)
        with pytest.raises(ValueError, match="device"):
            dec(torch.zeros((2, code.n), device="meta"))
        assert (fused.LAYERED_LAUNCHES, fused.FLOODING_LAUNCHES) == before
