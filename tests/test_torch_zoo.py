"""The port's zoo (``ldpc_tpu_torch.zoo``) against ``ldpc_tpu.zoo``: every
committed entry loads with the same recipe, spec arrays and weights; an
entry saved by the port loads in both packages; ``max_iterations`` cuts
the schedule and never extends it; and a loaded entry decodes the same
bits as the JAX package on shared LLRs.

The decode comparison runs the zoo's flooding entry at its full width
(5x37 base, lift 256) with T cut to 2 and 4 frames: the port through its
fused flooding decode (the plain version on the CPU), the JAX package
through its XLA QC engine with ``check_every=T``, whose contract (one
syndrome check, at T) is the fused kernel's; its interpret-mode Pallas
kernel takes over a minute to compile at this width. f32: hard outputs
exact, posteriors to rtol 1e-6 / atol 1e-5 (XLA:CPU's FMA contraction).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu_torch as lt
from ldpc_tpu import zoo as jzoo
from torch_port_helpers import assert_same_fields, make_base

ENTRIES = sorted(os.path.basename(p) for p, _ in jzoo.list_pretrained())


def _assert_same_decoder(t, j):
    assert t.name == j.name and t.recipe == j.recipe
    assert t.max_iterations == j.max_iterations
    assert t.layered == j.layered
    assert_same_fields(t.spec, j.spec)
    assert (t.qc is None) == (j.qc is None)
    if j.qc is not None:
        assert_same_fields(t.qc, j.qc)
    np.testing.assert_array_equal(t.code.H, j.code.H)
    assert t.weights.keys() == j.weights.keys()
    for k, w in j.weights.items():
        assert (t.weights[k] is None) == (w is None)
        if w is not None:
            assert t.weights[k].dtype == torch.float32
            assert t.weights[k].device.type == "cpu"
            np.testing.assert_array_equal(t.weights[k].numpy(),
                                          np.asarray(w))


@pytest.mark.parametrize("entry", ENTRIES)
def test_committed_entries_load_equal(entry):
    assert len(ENTRIES) == 5
    t = lt.load_pretrained(entry, device="cpu")
    j = jzoo.load_pretrained(entry)
    _assert_same_decoder(t, j)
    assert [os.path.basename(p) for p, _ in lt.list_pretrained()] == ENTRIES
    # a reduced schedule slices the weights exactly as the JAX package does
    T = j.max_iterations - 1
    _assert_same_decoder(lt.load_pretrained(entry, max_iterations=T,
                                            device="cpu"),
                         jzoo.load_pretrained(entry, max_iterations=T))
    with pytest.raises(ValueError, match="cannot extend"):
        lt.load_pretrained(entry, max_iterations=j.max_iterations + 1,
                           device="cpu")


def test_save_load_round_trip(tmp_path):
    """A port-saved entry (QC and general codes) reloads equal in the port
    and in the JAX package; qc_options are deployment-time, not saved."""
    base = make_base(3, 8, 16, seed=2)
    code = lt.create_qc_code(base, lift=16, max_iterations=4)
    dec = lt.make_decoder(code, kind="orcq", bc=3, bv=8, sharing_type=2,
                          qc=lt.build_qc_graph(base, 16), seed=4,
                          device="cpu",
                          qc_options=dict(fused=True, dtype=torch.float32))
    lt.save_pretrained(str(tmp_path / "qc"), dec, meta={"note": "test"})
    opts = dict(fused=True, dtype=torch.bfloat16, lean=True)
    back = lt.load_pretrained(str(tmp_path / "qc"), qc_options=opts,
                              device="cpu")
    assert back.qc_options == opts
    _assert_same_decoder(back, jzoo.load_pretrained(str(tmp_path / "qc")))
    for k, w in dec.weights.items():
        assert torch.equal(back.weights[k], w)
    (path, spec), = lt.list_pretrained(str(tmp_path))
    assert spec["meta"] == {"note": "test"} and path.endswith("qc")

    gen = lt.neural_2d_min_sum(lt.create_test_ldpc_code(), 3,
                               max_iterations=5, device="cpu")
    lt.save_pretrained(str(tmp_path / "gen"), gen)
    _assert_same_decoder(
        lt.load_pretrained(str(tmp_path / "gen"), device="cpu"),
        jzoo.load_pretrained(str(tmp_path / "gen")))
    with pytest.raises(ValueError, match="recipe"):
        lt.save_pretrained(str(tmp_path / "x"), lt.Decoder(
            name="hand", code=gen.code, graph=gen.graph, spec=gen.spec,
            max_iterations=5, weights=gen.weights))


def test_loaded_entry_decodes_as_jax():
    T = 2
    tdec = lt.load_pretrained(
        "worcq_bc3_qc9472", max_iterations=T, device="cpu",
        qc_options=dict(fused=True, dtype=torch.float32, batch_tile=64))
    jdec = jzoo.load_pretrained("worcq_bc3_qc9472", max_iterations=T,
                                qc_options=dict(check_every=T))
    rng = np.random.default_rng(5)
    # 4 frames at 8, 7, 6 and 4.5 dB: the first converges in 2 iterations
    sigma2 = 10.0 ** (-np.array([[8.0], [7.0], [6.0], [4.5]]) / 10.0)
    llr = (2.0 * (1.0 + np.sqrt(sigma2) * rng.standard_normal(
        (4, tdec.code.n))) / sigma2).astype(np.float32)
    out = tdec(torch.from_numpy(llr))
    ref = jdec(jnp.asarray(llr))
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(out.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(out.posterior.numpy(),
                               np.asarray(ref.posterior), rtol=1e-6,
                               atol=1e-5)
    assert out.success.numpy()[0] and out.bits.numpy().any()
    assert ldpc_tpu.zoo.DEFAULT_ZOO_DIR == lt.zoo.DEFAULT_ZOO_DIR
