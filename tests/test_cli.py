"""CLI / experiment-harness tests, including the reference's stdout
contract: the summary block must match automated.py's scrape regex
(automated.py:33-38)."""

import re
import subprocess
import sys

import numpy as np
import pytest

# the reference's exact scrape regex (automated.py:33-38)
SUMMARY_REGEX = r"""
Found solution with rel prec res norm = (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*) when k = (\d+) and i = (\d+)
  total iterations = (\d+)
  ilu took (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*)s; gmres took (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*)s
  resNorm = (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*); errNorm = (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*)
"""


def run_cli(module, *args):
    out = subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True, text=True, timeout=600,
    )
    return out


def test_solve_cli_reference_output_contract(tmp_path):
    out = run_cli(
        "gmres_tpu.cli.solve",
        "--device", "cpu", "--synth", "poisson2d:12",
        "--mode", "baseline", "--orth", "mgs", "--prec", "identity",
        "--rlen", "15", "--tol", "1e-6",
    )
    assert out.returncode == 0, out.stderr
    m = re.search(re.compile(SUMMARY_REGEX), out.stdout)
    assert m, f"summary block not scrapeable:\n{out.stdout}"
    assert int(m.group(2)) == 0  # k = 0 (convergence at check_initial)
    assert int(m.group(4)) > 0
    assert "||x|| = " in out.stdout and "||A|| = " in out.stdout
    assert "Doing Baseline test" in out.stdout


def test_solve_cli_mixed_banner():
    out = run_cli(
        "gmres_tpu.cli.solve",
        "--device", "cpu", "--synth", "poisson2d:8",
        "--mode", "mixed", "--rlen", "10", "--prec", "jacobi",
    )
    assert "Doing Mixed Precision test" in out.stdout


def test_solve_cli_missing_A():
    out = run_cli("gmres_tpu.cli.solve", "--device", "cpu")
    assert out.returncode == 1
    assert "No value suplied for A" in out.stdout  # reference message verbatim


def test_solve_cli_conflicting_policies():
    out = run_cli(
        "gmres_tpu.cli.solve", "--device", "cpu", "--synth", "poisson2d:8",
        "--repeat-iter", "--orthloss",
    )
    assert out.returncode == 1
    assert "cannot be used with" in out.stdout


def test_solve_cli_abort_path():
    out = run_cli(
        "gmres_tpu.cli.solve",
        "--device", "cpu", "--synth", "poisson2d:12",
        "--mode", "baseline", "--prec", "identity",
        "--rlen", "5", "--tol", "1e-15", "--max-restarts", "2",
    )
    assert "Aborting after 10 iterations" in out.stdout


def test_mtx_file_solve(tmp_path):
    from gmres_tpu.io import mmio
    from gmres_tpu.io.synth import poisson_2d

    A = poisson_2d(8)
    rp = np.asarray(A.row_ptr)
    nnz = int(rp[-1])
    rows = np.repeat(np.arange(A.n_rows), np.diff(rp))
    path = tmp_path / "m.mtx"
    mmio.write_coordinate(path, A.n_rows, A.n_cols, rows,
                          np.asarray(A.col_idx)[:nnz], np.asarray(A.vals)[:nnz])
    out = run_cli(
        "gmres_tpu.cli.solve",
        "--device", "cpu", "--Apath", str(path),
        "--mode", "baseline", "--prec", "identity", "--rlen", "10",
    )
    assert out.returncode == 0, out.stderr
    assert re.search(re.compile(SUMMARY_REGEX), out.stdout)


def test_sweep_and_findmin(tmp_path):
    out = run_cli(
        "gmres_tpu.experiments.sweep",
        "--device", "cpu", "--prec", "identity", "--orth", "mgs",
        "--no-singleprec", "--no-single",
        "--out-dir", str(tmp_path),
        "poisson2d:10", "10", "0", "1e-6", "42",
    )
    assert out.returncode == 0, out.stderr
    hist = tmp_path / "history-poisson2d10.csv"
    assert hist.exists()
    lines = hist.read_text().strip().splitlines()
    assert len(lines) == 2  # baseline + mixed
    assert lines[0].startswith("poisson2d10,b,MGS,10,")

    out2 = run_cli(
        "gmres_tpu.experiments.findmin",
        "--plotting-format", "--in-dir", str(tmp_path),
        "1e-06", "MGS", "cpu", "identity", "poisson2d10",
    )
    assert out2.returncode == 0, out2.stderr
    assert out2.stdout.startswith("'poisson2d10': [(")

    # normalized filter spellings select the same rows: 1e-6 vs the CSV's
    # 1e-06, lowercase orth name (regression: exact-string filters silently
    # produced empty findmin output for the campaign's arg spellings)
    out3 = run_cli(
        "gmres_tpu.experiments.findmin",
        "--plotting-format", "--in-dir", str(tmp_path),
        "1e-6", "mgs", "cpu", "identity", "poisson2d10",
    )
    assert out3.returncode == 0, out3.stderr
    assert out3.stdout == out2.stdout


def test_sweep_comma_lists(tmp_path):
    """List-valued sweep args accept comma separators (regression: the
    campaign script passes seeds as ``42,42`` which whitespace-split
    parsed as one invalid int)."""
    out = run_cli(
        "gmres_tpu.experiments.sweep",
        "--device", "cpu", "--prec", "identity", "--orth", "mgs",
        "--no-singleprec", "--no-single", "--no-baseline", "--warmup", "0",
        "--out-dir", str(tmp_path),
        "poisson2d:10", "10", "0", "1e-6", "42,7",
    )
    assert out.returncode == 0, out.stderr
    lines = (tmp_path / "history-poisson2d10.csv").read_text().strip().splitlines()
    assert len(lines) == 2  # mixed x 2 seeds


def test_condest_accuracy():
    import jax

    from gmres_tpu.io.synth import poisson_2d
    from gmres_tpu.solver.condest import condest

    A = poisson_2d(12)
    cond, smax, smin, iters = condest(A, max_iters=2000, verbose=lambda *a: None)
    s = np.linalg.svd(A.to_dense(), compute_uv=False)
    true_cond = s[0] / s[-1]
    assert abs(smax - s[0]) / s[0] < 0.02
    assert abs(cond - true_cond) / true_cond < 0.25  # estimator, not exact


def test_transpose_csr():
    from gmres_tpu.io.synth import convection_diffusion_2d
    from gmres_tpu.solver.condest import transpose_csr

    A = convection_diffusion_2d(7)
    At = transpose_csr(A)
    np.testing.assert_allclose(At.to_dense(), A.to_dense().T, rtol=1e-14)
