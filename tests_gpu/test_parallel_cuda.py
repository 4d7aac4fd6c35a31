"""``ldpc_tpu_torch.parallel`` on the card: the mesh paths through K1 and
K4 against the single-device paths. Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

These tests import no JAX. Each spawns its ranks once for the module
(``parallel.spawn``): a world of one over NCCL, and two ranks sharing the
card over gloo (NCCL refuses two ranks on one card). Tolerances:

- a world of one: bit for bit with the single-device wave (K4), the
  stage-1-fused compacting wave (K4, then the engine), the two-checkpoint
  bench program (K1) and a trainer step;
- two ranks: the pooled counts equal the sum of the two ranks' counts
  computed here with each rank's generator, and the bench program the
  single-device decode of the same batch, bit for bit; two data-parallel
  steps leave the weights within rtol 1e-5 of one process's steps (the
  ranks' half-batch means round in another order).
"""

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.decode.early_exit import make_two_checkpoint_decoder
from ldpc_tpu_torch.parallel import launch, spawn
from ldpc_tpu_torch.sim.montecarlo import (_counts, _EngineCompactingWave,
                                           _Wave, point_generator)

pytestmark = pytest.mark.cuda

WAVE, SNR, SEED, T1, BUDGET = 4096, 2.5, 5, 5, 2048
TWO_CK = dict(batch=4096, snr_db=3.0, seed=7, t1=3, survivor_budget=4096)
TRAIN_CFG = dict(batch_size=16, learning_rate=2e-3, snr_range=(1.0, 2.0))


def _base():
    return np.random.default_rng(0).integers(0, 16, size=(3, 8))


def k4_decoder(**opts):
    """W-OMS-RCQ, T=10, on a 3x8 base at lift 16, on the CPU."""
    base = _base()
    return lt.make_decoder(
        lt.create_qc_code(base, lift=16, max_iterations=10), kind="orcq",
        bc=3, bv=8, sharing_type=2, seed=3, max_iterations=10,
        qc=lt.build_qc_graph(base, 16), qc_options=opts, device="cpu")


def k1_decoder():
    """The bench decoder's kinds (RCQ bc=3, bv=8, layered T=6, bf16,
    lean) on the small base, on the CPU."""
    base = _base()
    return lt.make_decoder(
        lt.create_qc_code(base, lift=16, max_iterations=6), kind="rcq", bc=3,
        bv=8, quantizer_params=((2.6474, 1.3), (3.0869, 1.3), (5.3767, 1.3)),
        v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
        max_iterations=6, layered=True, qc=lt.build_qc_graph(base, 16),
        qc_options=dict(fused=True, dtype=torch.bfloat16, lean=True),
        device="cpu")


def train_decoder():
    code = lt.create_peg_code(n=64, m=32, dv=3, seed=1, max_iterations=5)
    return lt.make_decoder(code, kind="wrcq", bc=3, sharing_type=2,
                           init="nms", seed=6, max_iterations=5,
                           device="cpu")


def batches(n):
    rng = np.random.default_rng(11)
    s2 = 10.0 ** (-1.5 / 10.0)
    out = []
    for _ in range(2):
        r = 1.0 + np.sqrt(s2) * rng.standard_normal((16, n))
        x = (2.0 * r / s2).astype(np.float32)
        out.append((x, np.zeros_like(x)))
    return out


def cases():
    fused = k4_decoder(fused=True, dtype=torch.bfloat16, lean=True)
    engine = k4_decoder(check_every=T1, dtype=torch.bfloat16)
    wdec = train_decoder()
    return {
        "k4": (launch.wave, (fused, WAVE, SNR, SEED)),
        "compact": (launch.wave, (engine, WAVE, SNR, SEED, 0, T1, BUDGET,
                                  True)),
        "two_ck": (launch.two_checkpoint_stats,
                   (k1_decoder(), *TWO_CK.values())),
        "train": (launch.train_steps, (wdec, lt.TrainingConfig(**TRAIN_CFG),
                                       batches(wdec.code.n))),
    }


@pytest.fixture(scope="module")
def runs():
    """Rank 0's results of the world of one over NCCL and of two gloo
    ranks on the card, by case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ldpc_tpu_torch.decode import _build
    _build.load_library()  # the children load it, they do not build it
    c = cases()
    one = spawn(launch.run_all, 1, "nccl", None, list(c.values()))
    two = spawn(launch.run_all, 2, "gloo", "cuda:0", list(c.values()))
    return {"one": dict(zip(c, one[0])), "two": dict(zip(c, two[0])),
            "two_rank1": dict(zip(c, two[1]))}


def _wave(dec, per, rank, size, compact=False):
    dev = torch.device("cuda")
    dec = dec.to(dev)
    w = (_EngineCompactingWave(dec, per, dev, T1, BUDGET // size, True)
         if compact else _Wave(dec, per, dev))
    return np.array(w(point_generator(SEED, 0, dev, rank, size), SNR))


def _single_two_ck():
    dev = torch.device("cuda")
    dec = k1_decoder().to(dev)
    llr = launch.global_llr(TWO_CK["batch"], dec.code.n, TWO_CK["snr_db"],
                            TWO_CK["seed"], dev)
    out, n = make_two_checkpoint_decoder(
        dec, t1=TWO_CK["t1"], survivor_budget=TWO_CK["batch"])(llr)
    return _counts(out.bits, out.iterations, out.success).tolist() + [int(n)]


def _single_train():
    wdec = train_decoder().to("cuda")
    tr = lt.PosteriorJointTrainer(wdec, lt.TrainingConfig(**TRAIN_CFG))
    for x, y in batches(wdec.code.n):
        tr.train_step(torch.as_tensor(x, device="cuda"),
                      torch.as_tensor(y, device="cuda"))
    return {k: v.cpu().numpy() for k, v in wdec.weights.items()
            if v is not None}


@pytest.mark.parametrize("compact", [False, True])
def test_world_of_one_over_nccl_is_single_device(runs, compact):
    got = runs["one"]["compact" if compact else "k4"]
    assert got == _wave(k4_decoder(fused=True, dtype=torch.bfloat16,
                                   lean=True) if not compact else
                        k4_decoder(check_every=T1, dtype=torch.bfloat16),
                        WAVE, 0, 1, compact).tolist()


def test_world_of_one_bench_program_and_step(runs):
    assert runs["one"]["two_ck"] == _single_two_ck()
    want = _single_train()
    for k, w in runs["one"]["train"]["weights"].items():
        assert np.array_equal(w, want[k]), k


def test_two_gloo_ranks_on_the_card(runs):
    two, two1 = runs["two"], runs["two_rank1"]
    assert two["k4"] == two1["k4"]
    fused = k4_decoder(fused=True, dtype=torch.bfloat16, lean=True)
    assert two["k4"] == sum(_wave(fused, WAVE // 2, r, 2)
                            for r in range(2)).tolist()
    engine = k4_decoder(check_every=T1, dtype=torch.bfloat16)
    assert two["compact"] == sum(_wave(engine, WAVE // 2, r, 2, True)
                                 for r in range(2)).tolist()
    single = _single_two_ck()
    assert two["two_ck"] == single and 0 < single[3] < TWO_CK["batch"]
    want = _single_train()
    for k, w in two["train"]["weights"].items():
        np.testing.assert_allclose(w, want[k], rtol=1e-5, err_msg=k)
