"""chip_smoke.py: its CPU rehearsal end to end, its refusal to run without
a GPU or without the package, and (``gpu`` marker) the XLA forms on a card,
where float32 products must not fall to TF32."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "chip_smoke.py"


def _run(*args, cwd=ROOT, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py"), *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cpu_rehearsal_runs_every_phase():
    out = _run("--cpu-rehearsal")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    phases = [json.loads(l)["phase"] for l in lines if l.startswith('{"phase"')]
    assert phases == ["device", "layers", "solve", "distributed"]
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {"platform": "cpu", "kind": "cpu",
                                           "count": 4}}
    by_phase = {json.loads(l)["phase"]: json.loads(l)
                for l in lines if l.startswith('{"phase"')}
    layers = {r["layer"] for r in by_phase["layers"]["results"]}
    assert layers == {"copy", "dia_spmv", "csr_spmv", "orth_cgs", "orth_cgsr",
                      "ilu_apply", "fp64_residual"}
    for r in by_phase["solve"]["results"] + by_phase["distributed"]["results"]:
        assert r["converged"] and r["backward_error"] <= 1e-8
    for r in by_phase["distributed"]["results"]:
        assert r["devices"] == 4 and r["restarts"] == r["single"]["restarts"]


def test_without_gpu_exits_1_and_prints_no_result():
    out = _run()
    assert out.returncode == 1
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout and '"phase"' not in out.stdout


def test_alone_without_the_package_fails(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run("--cpu-rehearsal", cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_xla_forms_on_card_keep_float32_accuracy(gpu_device):
    """On the card, the solver's float32 orthogonalization and SpMV agree
    with float64 to fp32 accuracy; TF32 products (about 1e-3) would not."""
    from gmres_tpu.io.synth import convection_diffusion_2d
    from gmres_tpu.ops.dia import from_csr
    from gmres_tpu.ops.orth import mgs_lowsync_step, orthonormalize_step
    from gmres_tpu.ops.spmv import spmv

    rng = np.random.default_rng(0)
    n, m1, k = 1 << 16, 31, 29
    Q, _ = np.linalg.qr(rng.standard_normal((n, k + 1)))
    V = np.zeros((m1, n))
    V[: k + 1] = Q.T
    w = rng.standard_normal(n)
    u = V @ w
    w_ref = w - V.T @ u
    with jax.default_device(gpu_device):
        h, w2, _ = orthonormalize_step("cgs", jnp.asarray(V, jnp.float32), k,
                                       jnp.asarray(w, jnp.float32),
                                       assume_zero_tail=True)
        L = jnp.zeros((m1, m1), jnp.float32)
        h_ls, _, _, _ = mgs_lowsync_step(jnp.asarray(V, jnp.float32), k,
                                         jnp.asarray(w, jnp.float32), L, None)
        A = convection_diffusion_2d(256, beta=2.0)
        x = rng.standard_normal(A.n_rows)
        y = spmv(jax.device_put(from_csr(A).astype(jnp.float32)),
                 jnp.asarray(x, jnp.float32))
    assert list(h.devices())[0].platform == "gpu"
    rel = lambda a, b: np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b)
    assert rel(h[: k + 1], u[: k + 1]) < 1e-5
    assert rel(w2, w_ref) < 1e-5
    assert rel(h_ls[: k + 1], u[: k + 1]) < 1e-5
    assert rel(y, A.to_scipy() @ x) < 1e-5
