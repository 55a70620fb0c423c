"""Texture subsystem: bilinear-wrap sampler vs a NumPy oracle, the
reference's (u, 1-v) flip / magenta fallback / height-from-red conventions,
and an end-to-end textured + bump-mapped render."""

import json

import numpy as np
import pytest

import jax.numpy as jnp

from project3_cuda_path_tracer_2025_tpu.ops import texture as tex_ops
from project3_cuda_path_tracer_2025_tpu.scene.device import TextureTable
from project3_cuda_path_tracer_2025_tpu.scene.textures import (
    TextureData,
    build_texture_stack,
    load_texture,
)


def _oracle_bilinear(img, u, v):
    """CUDA tex2D semantics: sample at (u*W-0.5, v*H-0.5), wrap addressing."""
    h, w = img.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    g = lambda yy, xx: img[yy % h, xx % w]
    fx = fx[..., None]
    fy = fy[..., None]
    return (
        g(y0, x0) * (1 - fx) * (1 - fy)
        + g(y0, x0 + 1) * fx * (1 - fy)
        + g(y0 + 1, x0) * (1 - fx) * fy
        + g(y0 + 1, x0 + 1) * fx * fy
    )


def _table(datas):
    stack, wh = build_texture_stack(datas)
    nt, hmax, wmax, _ = stack.shape
    return (
        TextureTable(
            rgba=jnp.asarray(stack.reshape(-1, 4)),
            grad=jnp.zeros((stack.shape[0] * hmax * wmax, 2), jnp.float32),
            width=jnp.asarray(wh[:, 0], jnp.int32),
            height=jnp.asarray(wh[:, 1], jnp.int32),
        ),
        nt,
        wmax,
        hmax,
    )


def test_bilinear_sampler_matches_oracle():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (13, 9, 4)).astype(np.uint8)  # non-pow2 dims
    tex = TextureData(width=9, height=13, channels=4, data=img)
    table, nt, wmax, hmax = _table([tex])

    n = 300
    u = rng.uniform(-1.5, 2.5, n).astype(np.float32)  # exercises wrap
    v = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    tid = jnp.zeros((n,), jnp.int32)
    out = tex_ops.sample_texture(
        table, nt, wmax, hmax, tid, jnp.asarray(u), jnp.asarray(v)
    )
    imgf = img.astype(np.float64) / 255.0
    # sampler flips v: tex2D(u, 1 - v)
    expect = _oracle_bilinear(imgf, u, 1.0 - v)
    np.testing.assert_allclose(np.asarray(out.x), expect[:, 0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.y), expect[:, 1], atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.z), expect[:, 2], atol=1e-5)


def test_invalid_texture_id_magenta():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (4, 4, 4)).astype(np.uint8)
    table, nt, wmax, hmax = _table([TextureData(4, 4, 4, img)])
    u = jnp.asarray([0.5, 0.5])
    out = tex_ops.sample_texture(
        table, nt, wmax, hmax, jnp.asarray([-1, 7], jnp.int32), u, u
    )
    np.testing.assert_allclose(np.asarray(out.to_array()), [[1, 0, 1], [1, 0, 1]])
    h = tex_ops.sample_height(
        table, nt, wmax, hmax, jnp.asarray([-1, 7], jnp.int32), u, u
    )
    np.testing.assert_allclose(np.asarray(h), [0.0, 0.0])


def test_height_is_red_channel():
    img = np.zeros((2, 2, 4), np.uint8)
    img[..., 0] = 200  # red
    img[..., 1] = 17
    table, nt, wmax, hmax = _table([TextureData(2, 2, 4, img)])
    h = tex_ops.sample_height(
        table, nt, wmax, hmax, jnp.zeros((1,), jnp.int32),
        jnp.asarray([0.5]), jnp.asarray([0.5]),
    )
    assert float(h[0]) == pytest.approx(200 / 255, abs=1e-5)


def test_multiple_textures_padded_stack():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (4, 8, 4)).astype(np.uint8)
    b = rng.integers(0, 256, (16, 2, 4)).astype(np.uint8)
    table, nt, wmax, hmax = _table(
        [TextureData(8, 4, 4, a), TextureData(2, 16, 4, b)]
    )
    assert (wmax, hmax) == (8, 16)
    n = 64
    u = rng.uniform(0, 1, n).astype(np.float32)
    v = rng.uniform(0, 1, n).astype(np.float32)
    for tid, img in ((0, a), (1, b)):
        out = tex_ops.sample_texture(
            table, nt, wmax, hmax,
            jnp.full((n,), tid, jnp.int32), jnp.asarray(u), jnp.asarray(v),
        )
        expect = _oracle_bilinear(img.astype(np.float64) / 255.0, u, 1.0 - v)
        np.testing.assert_allclose(np.asarray(out.x), expect[:, 0], atol=1e-5)


def test_wahoo_bmp_loads(scene_file):
    path = scene_file("textures/wahoo.bmp")
    tex = load_texture(str(path))
    assert tex.channels == 4
    assert tex.width > 0 and tex.height > 0
    assert tex.data.shape == (tex.height, tex.width, 4)


def test_textured_bump_render_end_to_end(tmp_path):
    """Textured + bump-mapped quad lights up with texture colors."""
    from PIL import Image

    # checkerboard texture: red / blue
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:4, :4] = (255, 0, 0)
    tex[4:, 4:] = (255, 0, 0)
    tex[:4, 4:] = (0, 0, 255)
    tex[4:, :4] = (0, 0, 255)
    Image.fromarray(tex).save(tmp_path / "check.png")
    bump = (np.arange(64, dtype=np.uint8).reshape(8, 8) * 3)[..., None].repeat(3, -1)
    Image.fromarray(bump).save(tmp_path / "bump.png")

    (tmp_path / "quad.obj").write_text(
        "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 1 0\nvn 0 1 0\nvn 0 1 0\nvn 0 1 0\n"
        "f 1/1/1 2/2/2 3/3/3 4/4/4\n"
    )
    scene = {
        "Materials": {
            "light": {"TYPE": "Emitting", "RGB": [1, 1, 1], "EMITTANCE": 10.0},
            "tex": {
                "TYPE": "Diffuse",
                "RGB": [0.5, 0.5, 0.5],
                "TEXTURE": "check.png",
                "BUMP_MAP": "bump.png",
                "BUMP_SCALE": 0.3,
            },
        },
        "Camera": {
            "RES": [24, 24], "FOVY": 30.0, "ITERATIONS": 8, "DEPTH": 3,
            "FILE": "q", "EYE": [0, 2.2, 2.2], "LOOKAT": [0, 0, 0],
            "UP": [0, 1, 0], "APERTURE": 0.0,
        },
        "Objects": [
            {"TYPE": "obj", "PATH": "quad.obj", "MATERIAL": "tex",
             "TRANS": [0, 0, 0], "ROTAT": [0, 0, 0], "SCALE": [1, 1, 1]},
            {"TYPE": "cube", "MATERIAL": "light",
             "TRANS": [0, 5, 0], "ROTAT": [0, 0, 0], "SCALE": [4, 0.2, 4]},
        ],
    }
    json.dump(scene, (tmp_path / "scene.json").open("w"))

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene

    s = load_scene(str(tmp_path / "scene.json"))
    assert len(s.textures) == 2
    mat = s.materials[s.material_name_to_id["tex"]]
    assert mat.has_texture and mat.has_bump_map and mat.bump_scale == 0.3

    # Raw camera: the reference's spherical reconstruction flips
    # elevated cameras below the target (acos drops the elevation sign,
    # src/main.cpp:377-378,427-429) which would put this top-down camera
    # underneath the quad.
    r = Renderer(s, RenderConfig(spherical_camera_reconstruction=False))
    for _ in range(8):
        r.step()
    img = r.image_normalized()
    assert np.isfinite(img).all()
    # the quad fills the view; red and blue checker cells must both appear
    red = (img[..., 0] > img[..., 2] * 2) & (img[..., 0] > 0.02)
    blue = (img[..., 2] > img[..., 0] * 2) & (img[..., 2] > 0.02)
    assert red.sum() > 20 and blue.sum() > 20


def test_grad_table_matches_height_differences():
    """Bilinear samples of the precomputed difference table must equal the
    reference's finite differences of bilinear height samples (weight
    distributivity; up to f32 rounding and the reference's own ulp-level
    weight drift at texel boundaries)."""
    rng = np.random.default_rng(3)
    h, w = 8, 16
    data = (rng.random((h, w, 3)) * 255).astype(np.uint8)

    class T:
        pass

    t = T()
    t.height, t.width, t.data = h, w, np.dstack([data, np.full((h, w), 255, np.uint8)])
    tab, nt, wmax, hmax = _table([t])
    hch = np.asarray(tab.rgba).reshape(h, w, 4)[:, :, 0]
    grad = np.zeros((h, w, 2), np.float32)
    grad[:, :, 0] = np.roll(hch, -1, axis=1) - hch
    grad[:, :, 1] = np.roll(hch, 1, axis=0) - hch
    tab = tab._replace(grad=jnp.asarray(grad.reshape(-1, 2)))

    n = 257
    u = rng.random(n).astype(np.float32)
    v = rng.random(n).astype(np.float32)
    tid = jnp.zeros((n,), jnp.int32)
    tw = jnp.full((n,), w, jnp.int32)
    th = jnp.full((n,), h, jnp.int32)
    _, gdu, gdv = tex_ops.sample_surface(
        tab, nt, wmax, hmax, tid, tid, jnp.asarray(u), jnp.asarray(v),
        tw, th, tw, th,
    )
    du, dv = 1.0 / w, 1.0 / h
    args = (tab, nt, wmax, hmax)
    h0 = tex_ops.sample_height(*args, tid, jnp.asarray(u), jnp.asarray(v))
    h_u = tex_ops.sample_height(*args, tid, jnp.asarray(u + du), jnp.asarray(v))
    h_v = tex_ops.sample_height(*args, tid, jnp.asarray(u), jnp.asarray(v + dv))
    np.testing.assert_allclose(np.asarray(gdu), np.asarray(h_u - h0), atol=2e-6)
    np.testing.assert_allclose(np.asarray(gdv), np.asarray(h_v - h0), atol=2e-6)
