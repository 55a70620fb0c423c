"""Generate local fixture assets: procedural meshes + scene files.

The reference mirror is missing all scenes/obj/*.obj (large-blob strip), so
mesh benchmarks use procedural stand-ins of comparable triangle counts:

* icosphere(4) ~ 5.1k tris  (phatphuck-class)
* icosphere(5) ~ 20.5k tris
* torus-knot   ~ 80k tris   (cyrene/heavy-class)

Writes OBJ files into scenes/obj/ and Cornell-style scene JSONs into
scenes/ (same schema as the reference loader).
"""

import json
import math
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(os.path.dirname(HERE), "scenes")


def icosphere(subdiv: int):
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    verts = [np.asarray(v, float) / np.linalg.norm(v) for v in verts]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    cache = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = verts[i] + verts[j]
            m /= np.linalg.norm(m)
            verts.append(m)
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    return np.asarray(verts), faces


def torus_knot(p=2, q=3, seg_u=400, seg_v=100, r_tube=0.35):
    us = np.linspace(0, 2 * np.pi, seg_u, endpoint=False)
    # center curve of a (p,q) torus knot
    cx = np.cos(p * us) * (2 + np.cos(q * us))
    cy = np.sin(p * us) * (2 + np.cos(q * us))
    cz = np.sin(q * us)
    c = np.stack([cx, cy, cz], 1)
    tangent = np.roll(c, -1, 0) - np.roll(c, 1, 0)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    up = np.asarray([0.0, 0.0, 1.0])
    n1 = np.cross(tangent, up)
    n1 /= np.maximum(np.linalg.norm(n1, axis=1, keepdims=True), 1e-9)
    n2 = np.cross(tangent, n1)

    vs = np.linspace(0, 2 * np.pi, seg_v, endpoint=False)
    verts = (
        c[:, None, :]
        + r_tube * (np.cos(vs)[None, :, None] * n1[:, None, :]
                    + np.sin(vs)[None, :, None] * n2[:, None, :])
    ).reshape(-1, 3)
    faces = []
    for i in range(seg_u):
        for j in range(seg_v):
            a = i * seg_v + j
            b = ((i + 1) % seg_u) * seg_v + j
            c2 = ((i + 1) % seg_u) * seg_v + (j + 1) % seg_v
            d = i * seg_v + (j + 1) % seg_v
            faces.append((a, b, c2))
            faces.append((a, c2, d))
    return verts / 3.0, faces


def uvsphere(seg_u=72, seg_v=36):
    """Lat-long sphere with spherical UVs (the textured-mesh fixture; the
    reference's textured scenes need UV-mapped OBJs which were stripped)."""
    verts, uvs, faces = [], [], []
    for j in range(seg_v + 1):
        phi = math.pi * j / seg_v
        for i in range(seg_u + 1):
            theta = 2 * math.pi * i / seg_u
            verts.append((
                math.sin(phi) * math.cos(theta),
                math.cos(phi),
                math.sin(phi) * math.sin(theta),
            ))
            uvs.append((i / seg_u, 1.0 - j / seg_v))
    row = seg_u + 1
    for j in range(seg_v):
        for i in range(seg_u):
            a = j * row + i
            b = a + 1
            c = a + row
            d = c + 1
            if j > 0:
                faces.append((a, b, c))
            if j < seg_v - 1:
                faces.append((b, d, c))
    return np.asarray(verts, float), np.asarray(uvs, float), faces


def write_obj_uv(path, verts, uvs, faces):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for uv in uvs:
            f.write(f"vt {uv[0]:.6f} {uv[1]:.6f}\n")
        for v in verts:  # sphere: normal == position direction
            n = v / max(np.linalg.norm(v), 1e-9)
            f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for a, b, c in faces:
            f.write(
                f"f {a+1}/{a+1}/{a+1} {b+1}/{b+1}/{b+1} {c+1}/{c+1}/{c+1}\n"
            )


def write_obj(path, verts, faces, with_normals=False):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if with_normals:
            for v in verts:  # sphere-like: normal == position direction
                n = v / max(np.linalg.norm(v), 1e-9)
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
            for a, b, c in faces:
                f.write(f"f {a+1}//{a+1} {b+1}//{b+1} {c+1}//{c+1}\n")
        else:
            for a, b, c in faces:
                f.write(f"f {a+1} {b+1} {c+1}\n")


def cornell_mesh_scene(obj_name, scale, out_name, res=800, depth=8, iters=5000,
                       closed=False):
    """Cornell-box scene (reference schema) around a mesh.

    ``closed=True`` adds the front wall exactly as the reference's
    ``cornell_obj_phatphuck_closed.json`` does (a white cube at
    TRANS [0,5,5] ROTAT [0,90,0] SCALE [.01,10,10]) -- the scene pair behind
    its closed-vs-open stream-compaction study (README.md:138-151)."""
    scene = {
        "Materials": {
            "light": {"TYPE": "Emitting", "RGB": [1.0, 1.0, 1.0], "EMITTANCE": 5.0},
            "diffuse_white": {"TYPE": "Diffuse", "RGB": [0.98, 0.98, 0.98]},
            "diffuse_red": {"TYPE": "Diffuse", "RGB": [0.85, 0.35, 0.35]},
            "diffuse_green": {"TYPE": "Diffuse", "RGB": [0.35, 0.85, 0.35]},
            "mesh_mat": {"TYPE": "Diffuse", "RGB": [0.85, 0.7, 0.45]},
        },
        "Camera": {
            "RES": [res, res],
            "FOVY": 45.0,
            "ITERATIONS": iters,
            "DEPTH": depth,
            "FILE": out_name,
            "EYE": [0.0, 5.0, 10.5],
            "LOOKAT": [0.0, 5.0, 0.0],
            "UP": [0.0, 1.0, 0.0],
            "APERTURE": 0.0,
        },
        "Objects": [
            {"TYPE": "cube", "MATERIAL": "light",
             "TRANS": [0, 10, 0], "ROTAT": [0, 0, 0], "SCALE": [3, 0.3, 3]},
            {"TYPE": "cube", "MATERIAL": "diffuse_white",
             "TRANS": [0, 0, 0], "ROTAT": [0, 0, 0], "SCALE": [10, 0.01, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_white",
             "TRANS": [0, 10, 0], "ROTAT": [0, 0, 90], "SCALE": [0.01, 10, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_white",
             "TRANS": [0, 5, -5], "ROTAT": [0, 90, 0], "SCALE": [0.01, 10, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_red",
             "TRANS": [-5, 5, 0], "ROTAT": [0, 0, 0], "SCALE": [0.01, 10, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_green",
             "TRANS": [5, 5, 0], "ROTAT": [0, 0, 0], "SCALE": [0.01, 10, 10]},
            {"TYPE": "obj", "PATH": f"obj/{obj_name}", "MATERIAL": "mesh_mat",
             "TRANS": [0, 4, 0], "ROTAT": [0, 30, 0],
             "SCALE": [scale, scale, scale]},
        ],
    }
    if closed:
        scene["Objects"].insert(
            6,
            {"TYPE": "cube", "MATERIAL": "diffuse_white",
             "TRANS": [0, 5, 5], "ROTAT": [0, 90, 0],
             "SCALE": [0.01, 10, 10]},
        )
    with open(os.path.join(SCENES, out_name + ".json"), "w") as f:
        json.dump(scene, f, indent=2)


WAHOO = "../../reference/scenes/textures/wahoo.bmp"  # relative to scenes/


def cornell_textured_scene(obj_name, scale, out_name, res=800, depth=8,
                           iters=5000):
    """Textured + bump-mapped mesh in the cornell box (the reference's
    cornell_obj_phatphuck_texture_test-class workload; its OBJ/textures were
    stripped, so this uses the surviving wahoo.bmp on a UV sphere)."""
    scene = {
        "Materials": {
            "light": {"TYPE": "Emitting", "RGB": [1.0, 1.0, 1.0], "EMITTANCE": 5.0},
            "diffuse_white": {"TYPE": "Diffuse", "RGB": [0.98, 0.98, 0.98]},
            "diffuse_red": {"TYPE": "Diffuse", "RGB": [0.85, 0.35, 0.35]},
            "diffuse_green": {"TYPE": "Diffuse", "RGB": [0.35, 0.85, 0.35]},
            "mesh_tex": {
                "TYPE": "Diffuse", "RGB": [1.0, 1.0, 1.0],
                "TEXTURE": WAHOO,
                "BUMP_MAP": WAHOO, "BUMP_SCALE": 0.4,
            },
        },
        "Camera": {
            "RES": [res, res], "FOVY": 45.0, "ITERATIONS": iters,
            "DEPTH": depth, "FILE": out_name,
            "EYE": [0.0, 5.0, 10.5], "LOOKAT": [0.0, 5.0, 0.0],
            "UP": [0.0, 1.0, 0.0], "APERTURE": 0.0,
        },
        "Objects": [
            {"TYPE": "cube", "MATERIAL": "light",
             "TRANS": [0, 10, 0], "ROTAT": [0, 0, 0], "SCALE": [3, 0.3, 3]},
            {"TYPE": "cube", "MATERIAL": "diffuse_white",
             "TRANS": [0, 0, 0], "ROTAT": [0, 0, 0], "SCALE": [10, 0.01, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_white",
             "TRANS": [0, 10, 0], "ROTAT": [0, 0, 90], "SCALE": [0.01, 10, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_white",
             "TRANS": [0, 5, -5], "ROTAT": [0, 90, 0], "SCALE": [0.01, 10, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_red",
             "TRANS": [-5, 5, 0], "ROTAT": [0, 0, 0], "SCALE": [0.01, 10, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_green",
             "TRANS": [5, 5, 0], "ROTAT": [0, 0, 0], "SCALE": [0.01, 10, 10]},
            {"TYPE": "obj", "PATH": f"obj/{obj_name}", "MATERIAL": "mesh_tex",
             "TRANS": [0, 4, 0], "ROTAT": [0, 30, 0],
             "SCALE": [scale, scale, scale]},
        ],
    }
    with open(os.path.join(SCENES, out_name + ".json"), "w") as f:
        json.dump(scene, f, indent=2)


def cornell_prim_textured_scene(out_name, with_mesh, res=800, depth=8,
                                iters=5000):
    """Textured analytic SPHERE in the cornell box.  The reference shades
    prim and mesh textures uniformly (src/pathtrace.cu:549-553) but gives
    prims uv = (0,0) (:115), so a textured prim renders the texel at (0,1)
    flat -- this scene reproduces exactly that quirk (no BUMP_MAP: with the
    prims' zero tangent frames the reference's perturbation would
    glm::normalize(vec3(0)) -> NaN).  ``with_mesh`` adds an untextured mesh
    so the scene exercises textured prims with a mesh
    merge."""
    scene = {
        "Materials": {
            "light": {"TYPE": "Emitting", "RGB": [1.0, 1.0, 1.0], "EMITTANCE": 5.0},
            "diffuse_white": {"TYPE": "Diffuse", "RGB": [0.98, 0.98, 0.98]},
            "diffuse_red": {"TYPE": "Diffuse", "RGB": [0.85, 0.35, 0.35]},
            "diffuse_green": {"TYPE": "Diffuse", "RGB": [0.35, 0.85, 0.35]},
            "sphere_tex": {
                "TYPE": "Diffuse", "RGB": [1.0, 1.0, 1.0],
                "TEXTURE": WAHOO,
            },
            "mesh_mat": {"TYPE": "Diffuse", "RGB": [0.85, 0.7, 0.45]},
        },
        "Camera": {
            "RES": [res, res], "FOVY": 45.0, "ITERATIONS": iters,
            "DEPTH": depth, "FILE": out_name,
            "EYE": [0.0, 5.0, 10.5], "LOOKAT": [0.0, 5.0, 0.0],
            "UP": [0.0, 1.0, 0.0], "APERTURE": 0.0,
        },
        "Objects": [
            {"TYPE": "cube", "MATERIAL": "light",
             "TRANS": [0, 10, 0], "ROTAT": [0, 0, 0], "SCALE": [3, 0.3, 3]},
            {"TYPE": "cube", "MATERIAL": "diffuse_white",
             "TRANS": [0, 0, 0], "ROTAT": [0, 0, 0], "SCALE": [10, 0.01, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_white",
             "TRANS": [0, 10, 0], "ROTAT": [0, 0, 90], "SCALE": [0.01, 10, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_white",
             "TRANS": [0, 5, -5], "ROTAT": [0, 90, 0], "SCALE": [0.01, 10, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_red",
             "TRANS": [-5, 5, 0], "ROTAT": [0, 0, 0], "SCALE": [0.01, 10, 10]},
            {"TYPE": "cube", "MATERIAL": "diffuse_green",
             "TRANS": [5, 5, 0], "ROTAT": [0, 0, 0], "SCALE": [0.01, 10, 10]},
            {"TYPE": "sphere", "MATERIAL": "sphere_tex",
             "TRANS": [-2, 4, 0], "ROTAT": [0, 0, 0], "SCALE": [4, 4, 4]},
        ],
    }
    if with_mesh:
        scene["Objects"].append(
            {"TYPE": "obj", "PATH": "obj/ico4.obj", "MATERIAL": "mesh_mat",
             "TRANS": [2.5, 4, 0], "ROTAT": [0, 30, 0], "SCALE": [1.8, 1.8, 1.8]}
        )
    with open(os.path.join(SCENES, out_name + ".json"), "w") as f:
        json.dump(scene, f, indent=2)


def main():
    os.makedirs(os.path.join(SCENES, "obj"), exist_ok=True)

    v, uv, f = uvsphere()
    write_obj_uv(os.path.join(SCENES, "obj", "uvsphere5k.obj"), v, uv, f)
    print(f"uvsphere: {len(f)} tris")
    cornell_textured_scene("uvsphere5k.obj", 2.5, "cornell_mesh_textured")
    cornell_prim_textured_scene("cornell_prim_textured", with_mesh=True)

    v, f = icosphere(4)
    write_obj(os.path.join(SCENES, "obj", "ico4.obj"), v, f, with_normals=True)
    print(f"ico4: {len(f)} tris")
    cornell_mesh_scene("ico4.obj", 2.5, "cornell_mesh_5k")
    cornell_mesh_scene("ico4.obj", 2.5, "cornell_mesh_5k_closed", closed=True)

    v, f = icosphere(5)
    write_obj(os.path.join(SCENES, "obj", "ico5.obj"), v, f, with_normals=True)
    print(f"ico5: {len(f)} tris")
    cornell_mesh_scene("ico5.obj", 2.5, "cornell_mesh_20k")

    v, f = torus_knot()
    write_obj(os.path.join(SCENES, "obj", "knot80k.obj"), v, f)
    print(f"knot: {len(f)} tris")
    cornell_mesh_scene("knot80k.obj", 2.0, "cornell_mesh_80k")

    # cyrene-class heavy mesh (the reference's 200k-tri benchmark scene,
    # README.md:204-206) as a denser torus knot.
    v, f = torus_knot(p=3, q=4, seg_u=625, seg_v=160)
    write_obj(os.path.join(SCENES, "obj", "knot200k.obj"), v, f)
    print(f"knot200k: {len(f)} tris")
    cornell_mesh_scene("knot200k.obj", 2.0, "cornell_mesh_200k")

    # 500k-tri stress mesh: 2.5x past the reference's largest published
    # scene, for the scaling curve beyond parity.
    v, f = torus_knot(p=3, q=5, seg_u=1000, seg_v=250)
    write_obj(os.path.join(SCENES, "obj", "knot500k.obj"), v, f)
    print(f"knot500k: {len(f)} tris")
    cornell_mesh_scene("knot500k.obj", 2.0, "cornell_mesh_500k")


if __name__ == "__main__":
    sys.exit(main())
