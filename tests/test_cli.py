"""CLI shell tests (the reference app's argv contract: one scene file,
``src/main.cpp:341-351``, plus our extended flags)."""

import numpy as np
import pytest

from project3_cuda_path_tracer_2025_tpu import cli


def test_missing_scene_exits_nonzero(capsys):
    rc = cli.main(["/does/not/exist.json", "--cpu"])
    assert rc == 1
    assert "Couldn't read from" in capsys.readouterr().err


def test_parser_flags():
    p = cli.build_parser()
    a = p.parse_args(
        ["s.json", "--spp", "7", "--res", "32", "48", "--no-bvh",
         "--material-sort", "--integrator", "wavefront", "--raw-camera"]
    )
    assert a.spp == 7 and a.res == [32, 48]
    assert a.no_bvh and a.material_sort and a.raw_camera
    assert a.integrator == "wavefront"


def test_end_to_end_render_devices_tiers(tmp_path, scene_file):
    """--devices N (shard_map) with the wavefront's prefix tiers, through
    the real argv surface, equals the single-device render."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    common = [
        str(scene_file("cornell.json")),
        "--cpu", "--res", "16", "16", "--spp", "1", "--quiet",
        "--integrator", "wavefront", "--bounce-prefix-tiers", "4,2",
    ]
    a, b = tmp_path / "single", tmp_path / "sharded"
    a.mkdir(), b.mkdir()
    assert cli.main(common + ["--out", str(a)]) == 0
    assert cli.main(common + ["--out", str(b), "--devices", "8"]) == 0
    from project3_cuda_path_tracer_2025_tpu.utils import image_io

    ia = image_io.read_png(str(next(a.glob("*.png"))))
    ib = image_io.read_png(str(next(b.glob("*.png"))))
    np.testing.assert_array_equal(ia, ib)


def test_end_to_end_render(tmp_path, scene_file, capsys):
    rc = cli.main(
        [
            str(scene_file("cornell.json")),
            "--cpu",
            "--res", "16", "16",
            "--spp", "2",
            "--out", str(tmp_path),
            "--quiet",
        ]
    )
    assert rc == 0
    pngs = list(tmp_path.glob("cornell.*samp.png"))
    assert len(pngs) == 1
    from project3_cuda_path_tracer_2025_tpu.utils import image_io

    img = image_io.read_png(str(pngs[0]))
    assert img.shape == (16, 16, 3)
    assert img.max() > 0


def test_render_config_stream_compaction_normalization():
    """String toggles: sibling fields use 'on'/'off', so RenderConfig must
    normalize them for stream_compaction rather than let a truthy 'off'
    silently ENABLE compaction (inverting any A/B built on it)."""
    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig

    assert RenderConfig(stream_compaction="off").stream_compaction is False
    assert RenderConfig(stream_compaction="on").stream_compaction is True
    assert (
        RenderConfig(stream_compaction="adaptive").stream_compaction
        == "adaptive"
    )
    with pytest.raises(ValueError):
        RenderConfig(stream_compaction="maybe")
