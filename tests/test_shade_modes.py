"""Shader-mode and debug-config tests."""

import numpy as np
import pytest

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution


@pytest.fixture(scope="module")
def cornell_tiny(scene_file):
    return set_resolution(load_scene(str(scene_file("cornell.json"))), 24, 24)


def test_fake_shader_runs(cornell_tiny):
    """shadeFakeMaterial parity: noisy pseudo-lit image, no scattering."""
    r = Renderer(cornell_tiny, RenderConfig(shader="fake"))
    r.step()
    img = r.image_normalized()
    assert np.isfinite(img).all()
    assert img.mean() > 0.001
    # no scattering -> bounces never decrease except... they never change;
    # telemetry shows all paths still "alive" through the loop
    assert r._alive_counts[0] == r.static.pixel_count


def test_fake_differs_from_full(cornell_tiny):
    a = Renderer(cornell_tiny, RenderConfig(shader="fake"))
    b = Renderer(cornell_tiny, RenderConfig(shader="full"))
    a.step()
    b.step()
    assert not np.allclose(a.image(), b.image())


def test_debug_nan_checks_pass_on_clean_scene(cornell_tiny):
    r = Renderer(cornell_tiny, RenderConfig(debug_nan_checks=True))
    r.step()  # should not raise


def test_debug_nan_checks_detect_poison(cornell_tiny):
    import jax.numpy as jnp

    r = Renderer(cornell_tiny, RenderConfig(debug_nan_checks=True))
    r.step()
    r.film = r.film._replace(x=r.film.x.at[0].set(jnp.nan))
    with pytest.raises(FloatingPointError, match="non-finite"):
        r._check_finite()
