"""The section VII-C rate-family twins (``ldpc_tpu_torch.cli.pbrl_rates``,
``.tighten89``) on the card. Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

K1 against its plain version at 256 frames, in f32 and bf16, at both
depths of the programs' {5, 10} schedule, on LLRs whose 43 punctured
positions (base column 0) were multiplied by zero as the simulator's mask
does: bits, success, iterations and the posteriors' bit patterns equal.
The codes are the precoded PBRL family at lift 43 (rates 8/9, 2/3, 1/2
and 1/3: 4x28, 13x37, 25x49 and 49x73 bases), the table kinds ``oms6``
(every row sharing one (beta, alpha)), the 3-pair ``rcq-pol``, the 4-pair
``rcq-q4`` and 5-pair ``rcq-q5`` (``phase_schedule``'s even spread), the
trained type-2 ``wrcq-89`` and ``wrcq-89-q4`` and the per-layer
``wrcq-13pl``, whose tables are the JAX program's
(``pbrl_rates_tables.npz``)."""

import dataclasses

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import pbrl_rates as pr
from ldpc_tpu_torch.decode import fused

pytestmark = pytest.mark.cuda

# (rate, arm) -> SNR of the check LLRs
ARMS = {("89", "oms6"): 7.2, ("89", "rcq-pol"): 7.2, ("89", "wrcq-89"): 7.2,
        ("89", "wrcq-89-q4"): 7.2, ("23", "oms6"): 5.6,
        ("23", "rcq-q5"): 5.6, ("12", "rcq-q4"): 3.9,
        ("13", "wrcq-13pl"): 1.4}


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    """{(rate, arm): (decoder, punctured positions)}; the arms install the
    JAX program's tables in a temporary checkpoint directory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("ck"))
        setups = {tag: pr._mk_setup(tag, "cuda") for tag, _ in ARMS}
        return {(tag, arm): (setups[tag][0](arm), setups[tag][1])
                for tag, arm in ARMS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [5, 10], ids=["stage 1", "whole"])
@pytest.mark.parametrize("key", list(ARMS), ids=lambda k: "/".join(k))
def test_k1_equals_plain(decoders, key, T, dtype):
    dec, punct = decoders[key]
    d = dec if T == dec.max_iterations else dataclasses.replace(
        dataclasses.replace(dec, qc_options=None).truncated(T),
        qc_options=dec.qc_options)
    gen = torch.Generator(device="cuda").manual_seed(20)
    llr = lt.puncture_llr(lt.awgn_llr(gen, torch.zeros(
        (256, dec.code.n), device="cuda"), ARMS[key]), punct).to(dtype)
    assert dec.qc.lift == 43 and punct == tuple(range(43))
    assert torch.signbit(llr[:, :43]).any() and not llr[:, :43].any()
    args = dict(qc=d.qc, spec=d.spec, max_iterations=T, dtype=dtype)
    before = fused.LAYERED_LAUNCHES
    out = fused.qc_fused_decode_batch_layered(llr, d.weights, **args)
    ref = fused._fused_layered_plain(llr, d.weights, **args)
    torch.cuda.synchronize()
    assert fused.LAYERED_LAUNCHES == before + 1
    assert torch.equal(out.bits, ref.bits)
    assert torch.equal(out.success, ref.success)
    assert torch.equal(out.iterations, ref.iterations)
    nan = torch.isnan(ref.posterior)
    assert torch.equal(torch.isnan(out.posterior), nan)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dtype]
    assert torch.equal(out.posterior[~nan].view(ints),
                       ref.posterior[~nan].view(ints))


@pytest.mark.parametrize("key", [k for k in ARMS if k[1].startswith("wrcq")],
                         ids=lambda k: "/".join(k))
def test_trained_arms_decode_with_the_jax_programs_tables(decoders, key):
    """The trained arms' tables on the card equal the JAX program's
    element for element; type 2 at lift 43: [10, 3] / [10, 4] at rate
    8/9, per layer [10, 147] / [10, 588] at rate 1/3."""
    dec = decoders[key][0]
    ck = "orcq_" + key[1][5:].replace("-", "_")
    with np.load(pr.TABLES) as f:
        for k in ("beta", "alpha"):
            w = dec.weights[k]
            assert w.device.type == "cuda" and w.dtype == torch.float32
            np.testing.assert_array_equal(w.cpu().numpy(), f[f"{ck}/{k}"])
    shapes = {k: tuple(v.shape) for k, v in dec.weights.items()}
    assert shapes == ({"beta": (10, 147), "alpha": (10, 588)}
                      if key[1].endswith("pl") else
                      {"beta": (10, 3), "alpha": (10, 4)})
