"""The precoded-PBRL training twins (``ldpc_tpu_torch.cli.pbrl_wrcq``,
``.train_matched``, ``.pbrl_honest_train``) on the card. Run on a machine
with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

K1 against its plain version at 256 frames, in f32 and bf16, at both
depths of the programs' {5, 10} schedule, on the precoded PBRL code
(k=1032, rate 1/3, 25x37 base at lift 86, n = 3182) with the 86 LLRs of
base column 0 multiplied by zero as the simulator's mask does: bits,
success, iterations and the posteriors' bit patterns equal. The decoders
are the ones these programs put on K1 first: ``rcq-dde`` (10 CN pairs,
one an iteration, gamma 1.3 and 1.0 mixed), ``rcq-ref2`` (the designed
arm of ``train_matched``), ``rcq-ref4`` (V2C reach 1408.4), ``wrcq-ref3`` and ``wrcq-ref3pl`` (the JAX program's trained
type-2 and per-layer tables, ``pbrl_wrcq_tables.npz``), and
``pbrl_honest_train``'s ``rcq-ref3`` and its ``worcq``, ``wrcq``
(multiplicative beta) and ``worcq-pl`` arms on their initial tables
decoded with bv=8. Then the two identities the programs rest on, through
K1 on the same LLRs: W-OMS-RCQ with all-zero tables decodes as the plain
designed RCQ decoder (in f32 the posteriors too, in bf16 the hard outputs),
and ``rcq-ref3`` decodes the same hard outputs in bf16 under the uniform
V2C ladder as under design3's refined one."""

import dataclasses

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import pbrl_honest_train as ht
from ldpc_tpu_torch.cli import pbrl_wrcq as pw
from ldpc_tpu_torch.cli import train_matched as tm
from ldpc_tpu_torch.decode import fused

pytestmark = pytest.mark.cuda

SNR = 2.0
ARMS = ("rcq-dde", "rcq-ref2", "rcq-ref4", "wrcq-ref3", "wrcq-ref3pl",
        "ht/rcq-ref3", "ht/worcq", "ht/wrcq", "ht/worcq-pl")


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    """{arm: decoder} on the card; the trained arms install the JAX
    program's tables in a temporary checkpoint directory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("ck"))
        out, punct = pw.build_arms(ARMS[:5], "cuda")
        mk, _ = ht._setup("cuda")
        out["ht/rcq-ref3"] = mk("rcq")
        for name in ("worcq", "wrcq", "worcq-pl"):
            spec = ht.ARMS[name]
            out[f"ht/{name}"] = mk(spec["kind"], per_layer=spec["per_layer"])
    assert punct == tuple(range(86))
    return out


def _llr(dec, dtype, seed=21):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    llr = lt.puncture_llr(lt.awgn_llr(gen, torch.zeros(
        (256, dec.code.n), device="cuda"), SNR), tuple(range(86)))
    return llr.to(dtype)


def _equal(out, ref, dtype, posterior=True):
    assert torch.equal(out.bits, ref.bits)
    assert torch.equal(out.success, ref.success)
    assert torch.equal(out.iterations, ref.iterations)
    if posterior:
        nan = torch.isnan(ref.posterior)
        assert torch.equal(torch.isnan(out.posterior), nan)
        ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[
            dtype]
        assert torch.equal(out.posterior[~nan].view(ints),
                           ref.posterior[~nan].view(ints))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [5, 10], ids=["stage 1", "whole"])
@pytest.mark.parametrize("arm", ARMS)
def test_k1_equals_plain(decoders, arm, T, dtype):
    dec = decoders[arm]
    d = dec if T == dec.max_iterations else dataclasses.replace(
        dataclasses.replace(dec, qc_options=None).truncated(T),
        qc_options=dec.qc_options)
    llr = _llr(dec, dtype)
    assert dec.qc.lift == 86 and dec.code.n == 3182
    assert torch.signbit(llr[:, :86]).any() and not llr[:, :86].any()
    args = dict(qc=d.qc, spec=d.spec, max_iterations=T, dtype=dtype)
    before = fused.LAYERED_LAUNCHES
    out = fused.qc_fused_decode_batch_layered(llr, d.weights, **args)
    ref = fused._fused_layered_plain(llr, d.weights, **args)
    torch.cuda.synchronize()
    assert fused.LAYERED_LAUNCHES == before + 1
    _equal(out, ref, dtype)


def test_carried_tables_on_the_card(decoders):
    """``wrcq-ref3`` and ``wrcq-ref3pl`` decode with the JAX program's
    tables element for element: [10, 2] / [10, 9] and, per layer,
    [10, 50] / [10, 225]."""
    with np.load(pw.TABLES) as f:
        for arm, shapes in (("wrcq-ref3", ((10, 2), (10, 9))),
                            ("wrcq-ref3pl", ((10, 50), (10, 225)))):
            dec = decoders[arm]
            for k, shape in zip(("beta", "alpha"), shapes):
                w = dec.weights[k]
                assert w.device.type == "cuda" and tuple(w.shape) == shape
                np.testing.assert_array_equal(
                    w.cpu().numpy(), f[f"orcq_{arm[5:]}/{k}"])


def _through_k1(dec, llr):
    """``dec``'s whole decode through K1 in ``llr``'s type."""
    before = fused.LAYERED_LAUNCHES
    out = fused.qc_fused_decode_batch_layered(
        llr, dec.weights, qc=dec.qc, spec=dec.spec,
        max_iterations=dec.max_iterations, dtype=llr.dtype)
    torch.cuda.synchronize()
    assert fused.LAYERED_LAUNCHES == before + 1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_zero_tables_are_the_plain_designed_decoder(dtype):
    """``train_matched``'s premise on K1: W-OMS-RCQ with every table zero
    decodes as the plain ref2 RCQ decoder, in bits, success and
    iterations, and in f32 in the posteriors' bit patterns too. In bf16
    the posteriors part: the offset kinds round each v2c to bf16 before
    the check update where RCQ keeps it in f32, as ``ldpc_tpu``'s kernel
    does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    mk, _ = tm._setup("cuda")
    rcq = mk("rcq")
    zero = mk("orcq")
    zero = zero.replace_weights({k: torch.zeros_like(v)
                                 for k, v in zero.weights.items()})
    llr = _llr(rcq, dtype, seed=22)
    _equal(_through_k1(zero, llr), _through_k1(rcq, llr), dtype,
           posterior=dtype == torch.float32)


def test_v2c_ladder_is_decode_neutral_in_the_layered_schedule():
    """RESULTS section 33's premise on K1 in bf16: ``rcq-ref3`` under the
    uniform V2C ladder and under design3's refined one (reach 394.1) give
    the same bits, success and iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    arms, _ = pw.build_arms(("rcq-ref3",), "cuda")
    mk, _ = ht._setup("cuda")
    llr = _llr(arms["rcq-ref3"], torch.bfloat16, seed=23)
    _equal(_through_k1(arms["rcq-ref3"], llr), _through_k1(mk("rcq"), llr),
           torch.bfloat16, posterior=False)
