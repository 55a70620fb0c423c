"""Interactive terminal shell: frame rasterizer + key dispatch (no TTY)."""

import numpy as np

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu.interactive import (
    InteractiveShell,
    frame_to_ansi,
)
from project3_cuda_path_tracer_2025_tpu.models import Renderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution


def test_frame_to_ansi_shape_and_colors():
    img = np.zeros((8, 8, 3), np.float32)
    img[:, :4] = (1.0, 0.0, 0.0)  # left half red
    out = frame_to_ansi(img, cols=4, rows=2, mirror=False)
    lines = out.split("\n")
    assert len(lines) == 2
    # 4 cells per line, each with fg+bg truecolor escapes
    assert lines[0].count("▀") == 4
    assert "38;2;255;0;0" in lines[0]  # red present
    assert "38;2;0;0;0" in lines[0]  # black present
    # mirror flips red to the right half
    m = frame_to_ansi(img, cols=4, rows=2, mirror=True)
    first_cell = m.split("▀")[0]
    assert "38;2;0;0;0" in first_cell


def test_frame_to_ansi_clamps():
    img = np.full((4, 4, 3), 7.5, np.float32)  # HDR accumulation overshoot
    out = frame_to_ansi(img, cols=2, rows=1)
    assert "38;2;255;255;255" in out and "256" not in out


def test_shell_key_dispatch(scene_file, tmp_path):
    scene = set_resolution(load_scene(str(scene_file("cornell.json"))), 12, 12)
    scene.state.trace_depth = 2
    r = Renderer(scene, RenderConfig())
    r.step()
    shell = InteractiveShell(r, out_dir=str(tmp_path))
    it0 = r.iteration
    assert shell.handle_key("l")  # orbit resets accumulation
    assert r.iteration == 0 and it0 > 0
    assert shell.handle_key(" ") and shell.paused
    assert shell.handle_key(" ") and not shell.paused
    assert not shell.handle_key("z")  # unbound key
    r.step()
    assert shell.handle_key("s")
    assert "saved" in shell.message and not shell.quit
    assert shell.handle_key("q") and shell.quit
    import glob

    assert len(glob.glob(str(tmp_path / "*.png"))) >= 1
    assert "iter" in shell.status_line()


def test_preview_image_matches_full_fetch(scene_file):
    """Device-side preview downsample == host downsample of the full image
    on the same nearest-neighbor grid (divisible sizes -> exact)."""
    scene = set_resolution(load_scene(str(scene_file("cornell.json"))), 16, 16)
    scene.state.trace_depth = 2
    r = Renderer(scene, RenderConfig())
    r.step()
    small = r.preview_image(8, 4)
    assert small.shape == (8, 4, 3)
    full = r.image_normalized()
    ys = ((np.arange(8) + 0.5) * 16 / 8).astype(int)
    xs = ((np.arange(4) + 0.5) * 16 / 4).astype(int)
    np.testing.assert_allclose(small, full[ys][:, xs], rtol=1e-6)


def test_step_nosync_pipelines(scene_file):
    """step(sync=False) enqueues without a host sync and the film still
    accumulates correctly once fetched."""
    scene = set_resolution(load_scene(str(scene_file("cornell.json"))), 12, 12)
    scene.state.trace_depth = 2
    a = Renderer(scene, RenderConfig())
    b = Renderer(scene, RenderConfig())
    for _ in range(3):
        a.step()
        b.step(sync=False)
    np.testing.assert_allclose(a.image(), b.image(), atol=0.0)
    assert b.iteration == 3
