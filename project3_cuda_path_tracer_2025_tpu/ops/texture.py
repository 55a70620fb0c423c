"""Texture sampling: bilinear, wrap addressing, normalized coords.

Parity with the reference's CUDA texture objects (``src/pathtrace.cu:110-131``:
``cudaFilterModeLinear`` + ``cudaAddressModeWrap`` + normalized float reads)
and its samplers (``sampleTexture``/``sampleHeight``, ``:505-519``):

* albedo/height lookups flip v: ``tex2D(u, 1 - v)``;
* out-of-range texture ids return magenta (1, 0, 1) / height 0;
* bump height is the ``.x`` (red) channel.

CUDA's linear filter samples at (u*W - 0.5, v*H - 0.5) texel space; the same
convention is used here with full float weights (CUDA quantizes the fraction
to 9 bits -- a <0.2% difference well under the RMSE gate).

Implemented as ROW gathers from the RGBA row table (one row per texel): a
bilinear sample is 4 row gathers fetching all channels at once.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..scene.device import TextureTable
from ..utils.vec import Vec3


def _bilinear_prep(
    tex_id: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
    tw: jnp.ndarray,  # per-lane true width
    th: jnp.ndarray,
    wmax: int,
    hmax: int,
):
    """Corner row indices + fractional weights for one bilinear-wrap sample.

    Returns ``((i00, i01, i10, i11), fx, fy)`` where iYX indexes the flat
    RGBA row table (Y = 0/1 texel row, X = 0/1 texel column)."""
    x = u * tw.astype(jnp.float32) - 0.5
    y = v * th.astype(jnp.float32) - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    x0w = jnp.mod(x0i, tw)
    x1w = jnp.mod(x0i + 1, tw)
    y0w = jnp.mod(y0i, th)
    y1w = jnp.mod(y0i + 1, th)

    base = tex_id * (wmax * hmax)
    idx = lambda yy, xx: base + yy * wmax + xx
    return (
        (idx(y0w, x0w), idx(y0w, x1w), idx(y1w, x0w), idx(y1w, x1w)),
        fx,
        fy,
    )


def _bilinear_combine(r00, r01, r10, r11, fx, fy):
    top = r00 * (1.0 - fx) + r01 * fx
    bot = r10 * (1.0 - fx) + r11 * fx
    return top * (1.0 - fy) + bot * fy


def _bilinear_rows(
    rgba: jnp.ndarray,  # [NT * Hmax * Wmax, 4]
    tex_id: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
    tw: jnp.ndarray,  # per-lane true width
    th: jnp.ndarray,
    wmax: int,
    hmax: int,
) -> jnp.ndarray:
    """Bilinear-wrap sample -> [N, 4] RGBA rows."""
    (i00, i01, i10, i11), fx, fy = _bilinear_prep(
        tex_id, u, v, tw, th, wmax, hmax
    )
    return _bilinear_combine(
        rgba[i00], rgba[i01], rgba[i10], rgba[i11], fx, fy
    )


def sample_surface(
    tex: TextureTable,
    num_textures: int,
    wmax: int,
    hmax: int,
    tex_id: jnp.ndarray,  # i32 per lane (may be out of range)
    bump_id: jnp.ndarray,
    uv_u: jnp.ndarray,
    uv_v: jnp.ndarray,
    tw_t: jnp.ndarray,  # texture dims per lane (albedo)
    th_t: jnp.ndarray,
    tw_b: jnp.ndarray,  # bump dims per lane
    th_b: jnp.ndarray,
    live: jnp.ndarray = None,  # lanes whose result is consumed
    single_quad: bool = False,  # no material has distinct texture/bump ids
):
    """The shading path's full texture traffic in two texel-quad gathers:
    one bilinear RGBA sample (albedo) and one bilinear sample of the
    precomputed height-difference table (bump gradients; see
    ``TextureTable.grad`` -- equal to the reference's finite differences of
    bilinear height samples by weight distributivity, to f32 rounding).

    Texel fetches over a multi-MB texture stack are HBM-random-access bound
    (~0.6 Gelem/s measured at 640k lanes); two quads instead of four plus
    ``live``-masking dead/miss lanes to texel row 0 (cache-resident) cuts
    that traffic ~6x in typical bounces.

    Returns ``(tex_rgb: Vec3, dh_du_raw, dh_dv_raw)`` where the raw
    gradients are per-TEXEL differences (divide by du/dv for per-uv)."""
    valid_t = (tex_id >= 0) & (tex_id < num_textures)
    valid_b = (bump_id >= 0) & (bump_id < num_textures)
    tid = jnp.clip(tex_id, 0, max(num_textures - 1, 0))
    bid = jnp.clip(bump_id, 0, max(num_textures - 1, 0))

    (qa, fxa, fya) = _bilinear_prep(tid, uv_u, 1.0 - uv_v, tw_t, th_t, wmax, hmax)
    (qb, fxb, fyb) = _bilinear_prep(bid, uv_u, 1.0 - uv_v, tw_b, th_b, wmax, hmax)
    n = uv_u.shape[0]
    if single_quad and tex.packed is not None:
        # One texel-quad gather serves BOTH albedo and bump gradients: for
        # a lane with both valid the ids (hence indices) coincide by the
        # single_quad precondition; otherwise the unused output is masked.
        q = tuple(jnp.where(valid_b, ib, ia) for ia, ib in zip(qa, qb))
        if live is not None:
            q = tuple(
                jnp.where(live & (valid_t | valid_b), i, 0) for i in q
            )
        rows = tex.packed[jnp.concatenate(q)]  # [4N, 2] i32
        w0 = rows[:, 0]
        w1 = rows[:, 1]
        inv255 = jnp.float32(255.0)
        alb4 = jnp.stack(
            [
                (w0 & 0xFF).astype(jnp.float32),
                ((w0 >> 8) & 0xFF).astype(jnp.float32),
                ((w0 >> 16) & 0xFF).astype(jnp.float32),
            ],
            axis=1,
        ) / inv255  # u8/255 division reproduces the f32 stack exactly
        grd4 = (
            jnp.stack(
                [
                    ((w1 & 0x3FF) - 256).astype(jnp.float32),
                    (((w1 >> 10) & 0x3FF) - 256).astype(jnp.float32),
                ],
                axis=1,
            )
            / inv255
        )
        ra = [alb4[c * n : (c + 1) * n] for c in range(4)]
        rg = [grd4[c * n : (c + 1) * n] for c in range(4)]
    else:
        if live is not None:
            qa = tuple(jnp.where(live & valid_t, i, 0) for i in qa)
            qb = tuple(jnp.where(live & valid_b, i, 0) for i in qb)
        rows_a = tex.rgba[jnp.concatenate(qa)]  # [4N, 4]
        rows_g = tex.grad[jnp.concatenate(qb)]  # [4N, 2]
        ra = [rows_a[c * n : (c + 1) * n] for c in range(4)]
        rg = [rows_g[c * n : (c + 1) * n] for c in range(4)]
    alb = _bilinear_combine(ra[0], ra[1], ra[2], ra[3], fxa, fya)
    grd = _bilinear_combine(rg[0], rg[1], rg[2], rg[3], fxb, fyb)

    tex_rgb = Vec3(
        jnp.where(valid_t, alb[:, 0], 1.0),
        jnp.where(valid_t, alb[:, 1], 0.0),
        jnp.where(valid_t, alb[:, 2], 1.0),
    )
    dh_du_raw = jnp.where(valid_b, grd[:, 0], 0.0)
    dh_dv_raw = jnp.where(valid_b, grd[:, 1], 0.0)
    return tex_rgb, dh_du_raw, dh_dv_raw


def sample_texture(
    tex: TextureTable,
    num_textures: int,
    wmax: int,
    hmax: int,
    tex_id: jnp.ndarray,  # i32 per lane (may be out of range)
    uv_u: jnp.ndarray,
    uv_v: jnp.ndarray,
) -> Vec3:
    """RGB sample at (u, 1-v); magenta fallback for invalid ids
    (``sampleTexture``, ``src/pathtrace.cu:505-512``)."""
    valid = (tex_id >= 0) & (tex_id < num_textures)
    tid = jnp.clip(tex_id, 0, max(num_textures - 1, 0))
    tw = tex.width[tid]
    th = tex.height[tid]
    rows = _bilinear_rows(tex.rgba, tid, uv_u, 1.0 - uv_v, tw, th, wmax, hmax)
    return Vec3(
        jnp.where(valid, rows[:, 0], 1.0),
        jnp.where(valid, rows[:, 1], 0.0),
        jnp.where(valid, rows[:, 2], 1.0),
    )


def sample_height(
    tex: TextureTable,
    num_textures: int,
    wmax: int,
    hmax: int,
    tex_id: jnp.ndarray,
    uv_u: jnp.ndarray,
    uv_v: jnp.ndarray,
) -> jnp.ndarray:
    """Height = red channel at (u, 1-v); 0 for invalid ids
    (``sampleHeight``, ``src/pathtrace.cu:515-519``)."""
    valid = (tex_id >= 0) & (tex_id < num_textures)
    tid = jnp.clip(tex_id, 0, max(num_textures - 1, 0))
    tw = tex.width[tid]
    th = tex.height[tid]
    rows = _bilinear_rows(tex.rgba, tid, uv_u, 1.0 - uv_v, tw, th, wmax, hmax)
    return jnp.where(valid, rows[:, 0], 0.0)
