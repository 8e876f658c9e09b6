"""Built-in test scenes (no external files needed): the Cornell box (12
triangles and two spheres, the dense route), its BVH variant with the two
spheres replaced by subdivided triangle meshes, and the terrain height field
under a sky and a sun, written as a PLY file (counterpart of
pbrt_tpu/scene/testscenes.py; the classic Cornell box dimensions are
public-domain measurement data)."""
import os
from pathlib import Path

import numpy as np

from pbrt_tpu_torch.scene import builder as bd
from pbrt_tpu_torch.scene import lexer as lx
from pbrt_tpu_torch.scene.compile import compile_scene

# build/pbrt_tpu_torch/scenes/ beside the package (git-ignored)
SCENE_CACHE = Path(__file__).resolve().parents[2] / "build" / "pbrt_tpu_torch" / "scenes"

CORNELL_PBRT = """
Integrator "path" "integer maxdepth" [5]
Sampler "independent" "integer pixelsamples" [4]
Film "rgb" "integer xresolution" [128] "integer yresolution" [128]
    "string filename" ["cornell.png"]
LookAt 278 273 -800   278 273 0   0 1 0
Camera "perspective" "float fov" [38]

WorldBegin

AttributeBegin
  AreaLightSource "diffuse" "rgb L" [18.4 15.6 8.0]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [213 548.7 227   343 548.7 227   343 548.7 332   213 548.7 332]
AttributeEnd

Material "diffuse" "rgb reflectance" [0.73 0.73 0.73]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [552.8 0 0   0 0 0   0 0 559.2   549.6 0 559.2]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [556 548.8 0   556 548.8 559.2   0 548.8 559.2   0 548.8 0]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [549.6 0 559.2   0 0 559.2   0 548.8 559.2   556 548.8 559.2]

Material "diffuse" "rgb reflectance" [0.12 0.45 0.15]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [0 0 559.2   0 0 0   0 548.8 0   0 548.8 559.2]

Material "diffuse" "rgb reflectance" [0.63 0.065 0.05]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [552.8 0 0   549.6 0 559.2   556 548.8 559.2   556 548.8 0]

AttributeBegin
  Material "conductor" "float roughness" [0.005]
  Translate 400 90 350
  Shape "sphere" "float radius" [90]
AttributeEnd

AttributeBegin
  Material "dielectric" "float eta" [1.5]
  Translate 160 90 200
  Shape "sphere" "float radius" [90]
AttributeEnd
"""


def _octahedron_pbrt(cx, cy, cz, r, levels):
    """Shape "loopsubdiv" text for an octahedron control cage -> ~8*4^levels
    triangles after subdivision (approximates a sphere)."""
    P = [
        (cx + r, cy, cz), (cx - r, cy, cz),
        (cx, cy + r, cz), (cx, cy - r, cz),
        (cx, cy, cz + r), (cx, cy, cz - r),
    ]
    F = [
        (0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
        (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5),
    ]
    pts = " ".join(f"{x} {y} {z}" for x, y, z in P)
    idx = " ".join(f"{a} {b} {c}" for a, b, c in F)
    return (
        f'Shape "loopsubdiv" "integer levels" [{levels}] '
        f'"integer indices" [{idx}] "point3 P" [{pts}]'
    )


def cornell_mesh_pbrt(levels=5):
    """Cornell box with the two analytic spheres replaced by subdivided
    triangle meshes — the BVH-path testbed (8 * 4^levels tris per ball;
    levels=7 -> 262k total, staircase-class geometry per BASELINE.md #2)."""
    ball1 = _octahedron_pbrt(400, 90, 350, 90, levels)
    ball2 = _octahedron_pbrt(160, 90, 200, 90, levels)
    txt = CORNELL_PBRT
    txt = txt.replace(
        'AttributeBegin\n  Material "conductor" "float roughness" [0.005]\n'
        "  Translate 400 90 350\n"
        '  Shape "sphere" "float radius" [90]\nAttributeEnd',
        'AttributeBegin\n  Material "conductor" "float roughness" [0.005]\n'
        f"  {ball1}\nAttributeEnd",
    )
    txt = txt.replace(
        'AttributeBegin\n  Material "dielectric" "float eta" [1.5]\n'
        "  Translate 160 90 200\n"
        '  Shape "sphere" "float radius" [90]\nAttributeEnd',
        'AttributeBegin\n  Material "dielectric" "float eta" [1.5]\n'
        f"  {ball2}\nAttributeEnd",
    )
    return txt


def cornell_builder(res=128, filter_kind=None):
    """SceneBuilder of CORNELL_PBRT at res x res, optionally with another
    pixel filter."""
    b = bd.SceneBuilder()
    b.parse_tokens(lx.tokenize(CORNELL_PBRT))
    b.film["xresolution"] = b.film["yresolution"] = res
    if filter_kind is not None:
        b.filter = {"type": filter_kind}
    return b


def cornell(res=128, spp=4, device=None, filter_kind=None, integrator=None):
    """-> (Scene, SceneMeta) for the built-in Cornell box (dense route),
    rendered by the file's path integrator unless `integrator` names
    another ("bdpt")."""
    return compile_scene(cornell_builder(res, filter_kind), spp_override=spp, device=device,
                         integrator_override=integrator)


def cornell_mesh_builder(levels=5, res=None, filter_kind=None):
    """SceneBuilder of cornell_mesh_pbrt(levels), optionally at res x res
    and with another pixel filter."""
    b = bd.SceneBuilder()
    b.parse_tokens(lx.tokenize(cornell_mesh_pbrt(levels)))
    if res is not None:
        b.film["xresolution"] = b.film["yresolution"] = res
    if filter_kind is not None:
        b.filter = {"type": filter_kind}
    return b


def cornell_mesh(res=128, spp=4, levels=5, device=None, filter_kind=None, integrator=None):
    """-> (Scene, SceneMeta): the BVH-exercising Cornell variant;
    `integrator` overrides the file's "path"."""
    return compile_scene(cornell_mesh_builder(levels, res, filter_kind),
                         spp_override=spp, device=device, integrator_override=integrator)


def terrain_ply_path(n=256, cache_dir=None):
    """Write (once) and return a binary-little-endian PLY of an (n x n)
    sine-displaced height-field grid: 2 (n-1)^2 triangles (n=256 -> 130,050),
    byte-identical to the JAX package's. The file goes to cache_dir, by
    default SCENE_CACHE."""
    cache_dir = str(cache_dir or SCENE_CACHE)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"terrain_{n}.ply")
    if os.path.exists(path):
        return path
    xs = np.linspace(0.0, 100.0, n, dtype=np.float32)
    zs = np.linspace(0.0, 100.0, n, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = (6.0 * np.sin(X * 0.11) * np.cos(Z * 0.13)
         + 2.5 * np.sin(X * 0.31 + 1.0) * np.sin(Z * 0.27)
         + 1.2 * np.cos(X * 0.83) * np.cos(Z * 0.71 + 0.5)).astype(np.float32)
    V = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    i = np.arange(n * n).reshape(n, n)
    a, b, c, d = i[:-1, :-1], i[1:, :-1], i[1:, 1:], i[:-1, 1:]
    F = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                        np.stack([a, c, d], -1).reshape(-1, 3)]).astype(np.int32)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(b"ply\nformat binary_little_endian 1.0\n"
                 + f"element vertex {V.shape[0]}\n".encode()
                 + b"property float x\nproperty float y\nproperty float z\n"
                 + f"element face {F.shape[0]}\n".encode()
                 + b"property list uchar int vertex_indices\nend_header\n")
        fh.write(V.astype("<f4").tobytes())
        rows = np.zeros(F.shape[0], dtype=[("n", "u1"), ("v", "<i4", 3)])
        rows["n"] = 3
        rows["v"] = F
        fh.write(rows.tobytes())
    os.replace(tmp, path)
    return path


def terrain_pbrt(ply_path, spp=4, res=256):
    """Sun (distant light) and sky (uniform infinite light) over the PLY
    height field: an open scene, so the render takes the wavefront loop."""
    return f"""
Integrator "path" "integer maxdepth" [5]
Sampler "independent" "integer pixelsamples" [{spp}]
Film "rgb" "integer xresolution" [{res}] "integer yresolution" [{res}]
    "string filename" ["terrain.png"]
LookAt 50 40 -55   50 2 55   0 1 0
Camera "perspective" "float fov" [48]
WorldBegin
LightSource "infinite" "rgb L" [0.25 0.32 0.45]
LightSource "distant" "point3 from" [30 80 -20] "point3 to" [50 0 50]
    "rgb L" [2.5 2.3 2.0]
Material "diffuse" "rgb reflectance" [0.42 0.36 0.28]
Shape "plymesh" "string filename" ["{ply_path}"]
"""


def terrain(res=256, spp=4, n=256, device=None, cache_dir=None):
    """-> (Scene, SceneMeta): sun and sky over a 130k-triangle PLY height
    field (n=256), the large open-scene benchmark of the JAX package."""
    b = bd.SceneBuilder()
    b.parse_tokens(lx.tokenize(terrain_pbrt(terrain_ply_path(n, cache_dir), res=res)))
    return compile_scene(b, spp_override=spp, device=device)
