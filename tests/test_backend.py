"""The backend module: its answers per platform, its refusal of unknown
platforms, compile-cache placement, and source scans that keep platform
questions inside it."""

import ast
import pathlib
import subprocess

import jax
import pytest

from gmres_tpu import backend

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "gmres_tpu"
PROGRAM_FILES = sorted(PACKAGE.rglob("*.py")) + [
    ROOT / "bench.py", ROOT / "chip_smoke.py", ROOT / "__graft_entry__.py"]


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_answers_per_platform(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    b = backend.current()
    assert b.platform == platform
    # today's schedule on both platforms: rolled inner loop, and the
    # one-reduce MGS only where it saves allreduces (distributed)
    assert backend.unroll_inner() is False
    assert backend.lowsync_mgs_auto(distributed=False) is False
    assert backend.lowsync_mgs_auto(distributed=True) is True


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
def test_unknown_platform_is_an_error(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match=repr(platform)):
        backend.current()
    with pytest.raises(RuntimeError):
        backend.unroll_inner()


def test_describe_devices_reports_jax_view():
    dev = backend.describe_devices()
    assert set(dev) == {"platform", "kind", "count"}
    assert dev["platform"] == jax.devices()[0].platform
    assert dev["count"] == len(jax.devices())


def test_require_gpu_exits_without_a_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        backend.require_gpu()
    assert e.value.code == 1
    assert "no GPU" in capsys.readouterr().out


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; without
    it the cache sits at <checkout>/.jax_cache, a fixed path."""
    old = jax.config.jax_compilation_cache_dir
    set_calls = []
    real_update = jax.config.update

    def spy(name, value):
        set_calls.append((name, value))

    monkeypatch.setattr(jax.config, "update", spy)
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert backend.use_compile_cache() == str(tmp_path)
        assert set_calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(ROOT / ".jax_cache")
        assert backend.use_compile_cache() == want
        assert set_calls == [("jax_compilation_cache_dir", want)]
    monkeypatch.setattr(jax.config, "update", real_update)
    assert jax.config.jax_compilation_cache_dir == old


@pytest.mark.parametrize("failure", [FileNotFoundError, subprocess.TimeoutExpired])
def test_card_line_without_nvidia_smi(monkeypatch, failure):
    def fake_run(*a, **k):
        if failure is subprocess.TimeoutExpired:
            raise failure(cmd="nvidia-smi", timeout=30)
        raise failure("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert backend.card_line().startswith("nvidia-smi unavailable")


def test_card_line_passes_nvidia_smi_output(monkeypatch):
    out = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    def fake_run(cmd, **k):
        assert "--query-gpu=name,power.limit" in cmd
        return subprocess.CompletedProcess(cmd, 0, stdout=out)

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert backend.card_line() == out.strip()


# ------------------------------------------------------------ source scans
def _sources():
    return [(p, p.read_text()) for p in PROGRAM_FILES]


@pytest.mark.parametrize("needle", [
    "default_backend", "device_kind", "pallas.tpu", "pltpu", "pallas_call",
])
def test_platform_questions_live_in_backend(needle):
    """Only gmres_tpu/backend.py reads the platform; no program file
    imports a TPU Pallas module or builds a Pallas kernel."""
    hits = [str(p.relative_to(ROOT)) for p, src in _sources()
            if needle in src and p.name != "backend.py"]
    assert hits == [], hits


def test_no_interpret_mode_kernel_in_program_files():
    hits = [str(p.relative_to(ROOT)) for p, src in _sources()
            if "interpret=True" in src or "interpret=" in src]
    assert hits == [], hits


def _product_calls(tree):
    """Calls of jnp/jax.numpy matmul, einsum, dot, tensordot and vdot."""
    names = {"matmul", "einsum", "dot", "tensordot", "vdot", "inner"}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in names
                and isinstance(f.value, ast.Name)
                and f.value.id in ("jnp", "jax")):
            yield node


@pytest.mark.parametrize("subdir", ["ops", "solver", "precond", "parallel",
                                    "cli"])
def test_device_products_state_precision(subdir):
    """Every jnp matmul/einsum/dot in the package states ``precision``:
    without it the GPU may compute float32 products in TF32."""
    missing = []
    for p in sorted((PACKAGE / subdir).rglob("*.py")):
        for call in _product_calls(ast.parse(p.read_text())):
            if not any(k.arg == "precision" for k in call.keywords):
                missing.append(f"{p.relative_to(ROOT)}:{call.lineno}")
    assert missing == [], missing


def test_product_scan_sees_products():
    """The scan above finds what it looks for (guards a vacuous pass)."""
    src = ("import jax.numpy as jnp\n"
           "a = jnp.dot(x, y)\n"
           "b = jnp.einsum('i,i->', x, y, precision=P)\n")
    calls = list(_product_calls(ast.parse(src)))
    assert len(calls) == 2
    assert [any(k.arg == "precision" for k in c.keywords)
            for c in calls] == [False, True]
