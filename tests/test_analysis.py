"""Analysis-layer tests (component 28 capability): best-config timings,
speedup geo-means, LaTeX/plot generation from a synthetic history."""

import numpy as np

from gmres_tpu.experiments.analysis import (
    best_timings,
    latex_timing_table,
    plot_speedups,
    speedups,
)
from gmres_tpu.experiments.history import append_rows


def make_history(tmp_path):
    rows = []
    for mat, base_t, mixed_t in (("matA", 2.0, 1.0), ("matB", 3.0, 2.0)):
        for seed, jitter in ((42, 0.0), (7, 0.1)):
            for code, t in (("b", base_t), ("mp", mixed_t)):
                rows.append({
                    "mat": mat, "type": code, "orth": "MGS", "rlen": "30",
                    "rtol": "0", "rorth": "0", "tol": "1e-06",
                    "device": "gpu", "prec": "identity",
                    "i": "3", "total_iters": "90", "res": "1e-7",
                    "err": "1e-6", "ilu": "0.0", "gmres": f"{t + jitter}",
                })
        append_rows(mat, [r for r in rows if r["mat"] == mat], str(tmp_path))
    return ["matA", "matB"]


def test_speedups_and_geo_mean(tmp_path):
    mats = make_history(tmp_path)
    t = best_timings(mats, "1e-06", "MGS", "gpu", "identity", str(tmp_path))
    assert set(t) == {"matA", "matB"}
    per_mat, geo = speedups(t, "mp")
    # medians: matA 2.05/1.05, matB 3.05/2.05
    np.testing.assert_allclose(per_mat["matA"][0], 2.05 / 1.05, rtol=1e-12)
    np.testing.assert_allclose(per_mat["matB"][0], 3.05 / 2.05, rtol=1e-12)
    want_geo = np.exp(np.mean(np.log([2.05 / 1.05, 3.05 / 2.05])))
    np.testing.assert_allclose(geo, want_geo, rtol=1e-12)


def test_latex_and_plot(tmp_path):
    mats = make_history(tmp_path)
    t = best_timings(mats, "1e-06", "MGS", "gpu", "identity", str(tmp_path))
    tex = latex_timing_table(t)
    assert "matA" in tex and r"\begin{tabular}" in tex
    out = tmp_path / "s.png"
    geo = plot_speedups(t, "mp", str(out))
    assert out.exists() and out.stat().st_size > 1000
    assert geo > 1.0


def test_filter_match_normalization():
    from gmres_tpu.experiments.history import _filter_match

    assert _filter_match(None, "anything")
    assert _filter_match("1e-08", "1e-08")
    assert _filter_match("1e-8", "1e-08")      # numeric equality
    assert _filter_match("cgsr", "CGSR")       # case-insensitive fallback
    assert not _filter_match("1e-6", "1e-08")
    assert not _filter_match("MGS", "CGSR")


def test_suites():
    from gmres_tpu.experiments.suites import suite

    assert "rajat31" in suite("paper")
    assert "cage15" in suite("large")
    assert all(":" in s for s in suite("synth-large"))
