"""The one backend resolver, the compile-cache location and the chip smoke
script's refusal to run without a GPU."""

import os
import pathlib
import subprocess
import sys

import pytest

from project3_cuda_path_tracer_2025_tpu import config
from project3_cuda_path_tracer_2025_tpu.config import RenderConfig

REPO = pathlib.Path(__file__).resolve().parent.parent

# auto knob -> expected resolution on each of config.PLATFORMS
AUTO_KNOBS = {
    "fused_bounce": (False, True, False),
    "bounce_prefix_tiers": ((), (4, 2), (4, 2)),
    "mesh_intersector": ("threaded", "threaded", "threaded"),
}


def _resolve(cfg: RenderConfig, knob: str):
    return {
        "fused_bounce": cfg.resolved_fused_bounce,
        "bounce_prefix_tiers": cfg.resolved_prefix_tiers,
        "mesh_intersector": cfg.resolved_mesh_intersector,
    }[knob]()


@pytest.mark.parametrize("platform", config.PLATFORMS)
@pytest.mark.parametrize("knob", sorted(AUTO_KNOBS))
def test_auto_knob_resolves_per_platform(monkeypatch, platform, knob):
    """Every "auto" resolves through ``config.backend()`` on each platform."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert config.backend() == platform
    want = AUTO_KNOBS[knob][config.PLATFORMS.index(platform)]
    assert _resolve(RenderConfig(), knob) == want


@pytest.mark.parametrize("knob, value, want", [
    ("fused_bounce", "on", True),
    ("fused_bounce", "off", False),
    ("bounce_prefix_tiers", (8,), (8,)),
    ("mesh_intersector", "brute", "brute"),
])
def test_explicit_knob_ignores_platform(monkeypatch, knob, value, want):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _resolve(RenderConfig(**{knob: value}), knob) == want


def test_unknown_platform_is_an_error(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        config.backend()
    with pytest.raises(RuntimeError):
        RenderConfig().resolved_fused_bounce()


def test_no_bvh_selects_brute_force():
    assert RenderConfig(bvh_acceleration=False).resolved_mesh_intersector() == "brute"


def test_removed_knob_values_are_rejected():
    with pytest.raises(ValueError):
        RenderConfig(mesh_intersector="mxu")
    with pytest.raises(ValueError):
        RenderConfig(fused_bounce="maybe")


def _cache_dir_in_fresh_process(env_value):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = (
        "import jax\n"
        "from project3_cuda_path_tracer_2025_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, check=True,
        capture_output=True, text=True, timeout=120,
    ).stdout.split()
    return out[-2:]


@pytest.mark.parametrize("env_value", [None, "set"])
def test_compile_cache_location(tmp_path, env_value):
    """With JAX_COMPILATION_CACHE_DIR set, JAX keeps its cache there and
    nothing else is set; without it, the cache sits at <repo>/.jax_cache."""
    value = None if env_value is None else str(tmp_path / "cache")
    returned, configured = _cache_dir_in_fresh_process(value)
    want = value if value is not None else str(REPO / ".jax_cache")
    assert returned == want
    assert configured == want


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    """chip_smoke.py is a GPU-only proof: on the CPU, and in a directory
    holding nothing else of the repo, it exits non-zero and prints no
    result line."""
    import shutil

    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
