"""The port's command-line twins (``ldpc_tpu_torch.cli``) on the CPU, as
``tests/test_examples.py`` runs the root scripts: each in a subprocess
that cannot import jax, with ``--device cpu``, in a temporary directory
(the simulation scenario and the figures write there)."""

import os
import subprocess
import sys

import pytest

import ldpc_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, module, *args, timeout=300):
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.argv = ['cli'] + sys.argv[1:]; "
            f"runpy.run_module('ldpc_tpu_torch.cli.{module}', "
            "run_name='__main__'); "
            "assert 'ldpc_tpu' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code, *args, "--device",
                           "cpu"], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=tmp_path)


def test_examples_quick(tmp_path):
    r = _run(tmp_path, "examples", "quick")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "quick test OK" in r.stdout


@pytest.mark.parametrize("scenario,says", [("2d", "type 4"),
                                           ("rcq", "round-trip")])
def test_examples_single_scenario(tmp_path, scenario, says):
    r = _run(tmp_path, "examples", scenario)
    assert r.returncode == 0, r.stderr[-2000:]
    assert says in r.stdout


def test_examples_rejects_unknown(tmp_path):
    r = _run(tmp_path, "examples", "nonsense")
    assert r.returncode == 1
    assert "unknown scenario" in r.stdout


def test_examples_zoo_scenario(tmp_path):
    """The zoo's first entry is trained at T=4; the scenario's T=5 cut would
    extend it, which both packages refuse, so the twin decodes at T=4."""
    path, spec = ldpc_tpu.list_pretrained()[0]
    assert spec["recipe"]["max_iterations"] == 4
    with pytest.raises(ValueError, match="cannot extend"):
        ldpc_tpu.load_pretrained(path, max_iterations=5)
    r = _run(tmp_path, "examples", "zoo")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "/16 converged at T=4" in r.stdout


def test_comprehensive_every_decoder_reports(tmp_path):
    r = _run(tmp_path, "comprehensive", "--code", "test", "--batch", "64")
    assert r.returncode == 0, r.stderr[-2000:]
    for name in ("Basic-MinSum", "N-NMS", "N-OMS", "N-2D-NMS-T1",
                 "N-2D-NMS-T2", "N-2D-NMS-T3", "N-2D-NMS-T4", "RCQ",
                 "W-RCQ-T2", "W-OMS-RCQ-T2"):
        assert f"  {name} " in r.stdout, name
    assert "golden parameter counts OK" in r.stdout
    assert "ALL COMPREHENSIVE TESTS PASSED" in r.stdout


def test_generate_images(tmp_path):
    r = _run(tmp_path, "generate_images", "--out", str(tmp_path / "img"),
             "--frames", "256")
    assert r.returncode == 0, r.stderr[-2000:]
    paths = r.stdout.split()
    assert len(paths) == 6 and all(p.endswith(".png") for p in paths)
    assert all(os.path.getsize(p) > 1000 for p in paths)
    assert (tmp_path / "img" / "mc_results.json").exists()


def test_graft_entry_and_two_rank_dryrun(tmp_path):
    r = _run(tmp_path, "graft_entry", "--ranks", "2")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "entry ok: [(256, 1536), (256, 1536), (256,)]" in r.stdout
    assert "dryrun_multichip ok" in r.stdout
