"""Test configuration: CPU with 8 virtual devices so the sharding tests run
without accelerators, float32 JAX.

The driver's test command sets ``JAX_PLATFORMS=cpu``; the defaults below
make a bare ``pytest`` do the same.  Tests that need a GPU carry the
``gpu`` marker and ask the ``gpu_device`` fixture, which skips here."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib
import sys

import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
SCENES_DIR = REPO_ROOT / "scenes"
sys.path.insert(0, str(REPO_ROOT))


@pytest.fixture(scope="session")
def repo_root():
    return REPO_ROOT


@pytest.fixture(scope="session")
def scene_file():
    """``scene_file(name)`` -> path of an in-repo scene (or asset) under
    ``scenes/``; skips the test when that file is not in the tree (the
    reference's other scenes and textures are not vendored)."""

    def get(name: str) -> pathlib.Path:
        path = SCENES_DIR / name
        if not path.exists():
            pytest.skip(f"scene not in the tree: scenes/{name}")
        return path

    return get


@pytest.fixture
def gpu_device():
    """The first GPU device; skips where JAX has none (as in the CPU suite)."""
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU")
    return gpus[0]
