"""The port's reports, plots, profiling and generic checkpoints
(``ldpc_tpu_torch.report``, ``.utils``) against ``ldpc_tpu`` on the same
weights: weight-pattern analyses and parameter reports equal, plots
written, matplotlib never imported on the way to a decode, the profiler
trace written, and checkpoint trees restored as saved."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu.report as jreport
import ldpc_tpu_torch as lt
import ldpc_tpu_torch.report as treport
from ldpc_tpu_torch.utils import (ThroughputCounter, load_checkpoint,
                                  measure_throughput, save_checkpoint, trace)
from torch_port_helpers import (one_torch_thread,  # noqa: F401 (autouse)
                                carry_weights, decoder_pair, make_base)


def _fake_results():
    r = lt.SimulationResult("MS", [1.0, 2.0, 3.0])
    for i, (fer, ber) in enumerate([(0.5, 0.1), (0.1, 0.01), (0.01, 1e-3)]):
        r.add_result(i, fer, ber, 5.0 - i, 1.0, 1000, int(fer * 1000))
    return {"MS": r}


def test_weight_patterns_equal_jax():
    code = ldpc_tpu.create_test_ldpc_code()
    for make in ("neural_min_sum", "neural_2d_offset_min_sum"):
        jdec = getattr(ldpc_tpu, make)(code, max_iterations=6, seed=0)
        tdec = carry_weights(jdec, getattr(lt, make)(
            lt.create_test_ldpc_code(), max_iterations=6, device="cpu"))
        assert treport.analyze_weight_patterns(tdec) == \
            jreport.analyze_weight_patterns(jdec)
    with pytest.raises(ValueError, match="no beta weights"):
        treport.analyze_weight_patterns(
            lt.basic_min_sum(lt.create_test_ldpc_code(), device="cpu"))


def test_weight_patterns_of_a_qc_decoder():
    """A QC decoder's buckets are per block. The JAX package indexes its
    per-edge degrees with them and raises IndexError; the port groups the
    blocks, which gives the per-edge means of the same weights on the
    non-QC decoder of the same code (type 2: the same bucket universes),
    to float32 rounding of the means (rtol 1e-6)."""
    base = make_base(3, 8, 16, seed=4, density=0.8)
    kw = dict(kind="nms", sharing_type=2, init="nms", seed=1)
    jqc, tqc = decoder_pair(base, 16, 5, **kw)
    with pytest.raises(IndexError):
        jreport.analyze_weight_patterns(jqc)
    jflat = ldpc_tpu.make_decoder(jqc.code, max_iterations=5,
                                  **kw).replace_weights(jqc.weights)
    got = treport.analyze_weight_patterns(tqc)
    want = jreport.analyze_weight_patterns(jflat)
    assert got["per_iteration"] == want["per_iteration"]
    for key in ("mean_weight_by_check_degree",
                "mean_weight_by_variable_degree"):
        assert got[key].keys() == want[key].keys() and len(got[key]) > 1
        np.testing.assert_allclose(list(got[key].values()),
                                   list(want[key].values()), rtol=1e-6)


def test_parameter_reduction_report_equal_jax():
    jz = ldpc_tpu.create_test_decoders(ldpc_tpu.create_test_ldpc_code(),
                                       max_iterations=10)
    tz = lt.create_test_decoders(lt.create_test_ldpc_code(),
                                 max_iterations=10, device="cpu")
    for baseline in ("N-NMS", None):
        assert treport.parameter_reduction_report(tz, baseline) == \
            jreport.parameter_reduction_report(jz, baseline)
    assert treport.parameter_reduction_report(tz, "N-NMS")["decoders"][
        "N-2D-NMS-T1"]["params"] == 40


def test_plots_write_files(tmp_path):
    res = _fake_results()
    paths = [getattr(treport, name)(res, str(tmp_path / f"{name}.png"))
             for name in ("plot_fer_curves", "plot_ber_curves",
                          "plot_iteration_curves", "plot_timing_curves",
                          "plot_comparison_grid")]
    dec = lt.neural_min_sum(lt.create_test_ldpc_code(), max_iterations=5,
                            device="cpu")
    paths.append(treport.plot_weight_patterns(
        treport.analyze_weight_patterns(dec), str(tmp_path / "wp.png")))
    for p in paths:
        assert os.path.getsize(p) > 1000


def test_matplotlib_is_imported_only_to_draw():
    code = ("import sys; sys.modules['jax'] = None; "
            "import ldpc_tpu_torch, ldpc_tpu_torch.report, "
            "ldpc_tpu_torch.utils, ldpc_tpu_torch.design; "
            "assert 'matplotlib' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_profiling_on_the_cpu(tmp_path):
    """The trace is written as a Chrome trace with the decode's operators
    in it; the counters count calls and codewords."""
    dec = lt.basic_min_sum(lt.create_test_ldpc_code(), device="cpu")
    llr = torch.ones((8, 7))
    with trace(str(tmp_path / "t")) as prof:
        dec(llr)
    path = tmp_path / "t" / "trace.json"
    assert path.exists() and path.stat().st_size > 100
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
    assert measure_throughput(dec, llr, reps=2) > 0
    tc = ThroughputCounter()
    assert tc.codewords_per_sec == 0.0
    for _ in range(2):
        tc.start()
        dec(llr)
        tc.stop(8)
    assert tc.codewords == 16 and tc.codewords_per_sec > 0
    with pytest.raises(RuntimeError, match="start"):
        tc.stop(1)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"beta": np.arange(6, dtype=np.float32).reshape(2, 3),
            "alpha": None,
            "weights": torch.linspace(0, 1, 5).requires_grad_(True),
            "counters": {"frames": np.int64(123), "snr": 3.5},
            "ladder": ((2.4067, 1.3), (3.0869, 1.3)),
            "classes": [np.array([1, 2]), torch.tensor([3])]}
    path = save_checkpoint(str(tmp_path / "ck"), tree)
    assert os.path.isabs(path) and os.listdir(path) == ["tree.pt"]
    raw = load_checkpoint(path)
    assert "alpha" not in raw
    assert torch.equal(raw["beta"], torch.arange(6.0).reshape(2, 3))
    assert raw["counters"] == {"frames": torch.tensor(123), "snr": 3.5}
    assert raw["ladder"] == ((2.4067, 1.3), (3.0869, 1.3))
    back = load_checkpoint(path, item=tree)
    np.testing.assert_array_equal(back["beta"], tree["beta"])
    assert isinstance(back["beta"], np.ndarray)
    assert back["counters"]["frames"] == 123
    assert isinstance(back["counters"]["frames"], np.ndarray)
    assert torch.equal(back["weights"], tree["weights"].detach())
    assert not back["weights"].requires_grad
    assert isinstance(back["classes"], list)
    np.testing.assert_array_equal(back["classes"][0], [1, 2])
    with pytest.raises(KeyError):
        load_checkpoint(path, item={"missing": np.zeros(1)})
    with pytest.raises(ValueError, match="entries"):
        load_checkpoint(path, item={"ladder": ((1.0, 1.0),)})
