"""Built-in test scenes (no external files needed): the Cornell box (12
triangles and two spheres, the dense route), its BVH variant with the two
spheres replaced by subdivided triangle meshes, an instanced variant of it
(ObjectBegin/ObjectInstance), a textured variant of it (images written
from a seed), and the terrain height field
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


def _walls_and_light():
    """CORNELL_PBRT up to its two spheres: the header, the light and five
    walls (12 triangles)."""
    return CORNELL_PBRT[: CORNELL_PBRT.index('AttributeBegin\n  Material "conductor"')]


def instanced_cornell_pbrt(levels_a, levels_b, res=256, spp=16):
    """The cornell box's walls and light with 36 instances of a subdivided
    octahedron ball (conductor, levels_a) on a 6x6 floor grid, every fourth
    mirrored, and 16 of a gem (dielectric, levels_b) on a raised 4x4 grid
    placed through a named coordinate system; res^2, spp samples of the
    independent sampler, max depth 5, mitchell filter, as cornell-mesh. At
    levels (6, 5): 1,310,732 world triangles, of which instancing "auto"
    flattens the first 7 balls and 3 gems (253,964) and shares the rest as 2
    prototypes (40,960)."""
    head = _walls_and_light()
    head = head.replace('"integer pixelsamples" [4]', f'"integer pixelsamples" [{spp}]')
    head = head.replace('"integer xresolution" [128] "integer yresolution" [128]',
                        f'"integer xresolution" [{res}] "integer yresolution" [{res}]')
    # the subdivided cage of radius 2.2 has a limit surface of radius ~0.6-1
    out = [head, 'ObjectBegin "ball"\n  Material "conductor" "float roughness" [0.05]\n  ',
           _octahedron_pbrt(0, 0, 0, 2.2, levels_a), '\nObjectEnd\n',
           'ObjectBegin "gem"\n  Material "dielectric" "float eta" [1.5]\n  ',
           _octahedron_pbrt(0, 0, 0, 2.2, levels_b), '\nObjectEnd\n']
    axes = ("0 1 0", "1 0 0", "0 0 1", "1 1 0", "0 1 1", "1 0 1")
    # back rows first: "auto" flattens the first instances, so the shared
    # ones stand in front, where the camera sees them
    for k in range(36):
        i, j = divmod(k, 6)
        out.append(f"AttributeBegin\n  Translate {78 + 80 * j} 37 {480 - 80 * i}\n"
                   f"  Rotate {(37 * k) % 360} {axes[k % 6]}\n"
                   + ("  Scale -1 1 1\n" if k % 4 == 3 else "")
                   + '  Scale 36 36 36\n  ObjectInstance "ball"\nAttributeEnd\n')
    out.append('AttributeBegin\n  Translate 278 300 280\n  CoordinateSystem "gems"\n')
    for k in range(16):
        i, j = divmod(k, 4)
        out.append(f'  CoordSysTransform "gems"\n  Translate {-150 + 100 * j} {10 * (k % 3)} '
                   f'{150 - 100 * i}\n  Rotate {(53 * k) % 360} {axes[(k + 2) % 6]}\n'
                   '  Scale 30 30 30\n  ObjectInstance "gem"\n')
    out.append("AttributeEnd\n")
    return "".join(out)


def textured_images(image_dir, seed=0, size=256):
    """Write the textured cornell box's two images into image_dir, made from
    `seed` with numpy and written as 8-bit PNG by film/png.py: the back
    wall's size x size mosaic of 8 x 8 random colours under a diagonal
    ramp, and a (size / 4)^2 grey roughness image. -> (wall path, roughness
    path), absolute."""
    from pbrt_tpu_torch.film import png

    rng = np.random.default_rng(seed)
    cell = size // 8
    mosaic = np.kron(rng.uniform(0.15, 0.95, (8, 8, 3)), np.ones((cell, cell, 1)))
    ramp = np.linspace(0.6, 1.0, size)[:, None, None] * np.linspace(1.0, 0.7, size)[None, :, None]
    rough = np.repeat(rng.uniform(0.0, 1.0, (size // 4, size // 4, 1)), 3, axis=2)
    image_dir = Path(image_dir).resolve()
    image_dir.mkdir(parents=True, exist_ok=True)
    paths = image_dir / "wall.png", image_dir / "rough.png"
    for path, img in zip(paths, (mosaic * ramp, rough)):
        png.write_png(str(path), np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8))
    return tuple(str(p) for p in paths)


def textured_cornell_mesh_pbrt(levels=5, image_dir=None, res=256, spp=16, coated=False):
    """cornell_mesh_pbrt(levels) dressed in textures (the BVH route, 16,396
    triangles at levels 5): a uv checkerboard floor, a 256^2 imagemap back
    wall, walls through MakeNamedMaterial / NamedMaterial, one ball a mix
    (amount 0.5) of a diffuse and a conductor whose roughness is a float
    scale of an imagemap, the other a diffuse transmitter whose reflectance
    is a planar-mapped checkerboard and whose transmittance a directionmix.
    The images are written into image_dir (default: under SCENE_CACHE) by
    textured_images. `coated`: the floor a coateddiffuse over the
    checkerboard (the layered BxDF, K7, with a textured reflectance)."""
    wall, rough = textured_images(SCENE_CACHE / "textured" if image_dir is None else image_dir)
    ball1 = _octahedron_pbrt(400, 90, 350, 90, levels)
    ball2 = _octahedron_pbrt(160, 90, 200, 90, levels)
    return f"""
Integrator "path" "integer maxdepth" [5]
Sampler "independent" "integer pixelsamples" [{spp}]
Film "rgb" "integer xresolution" [{res}] "integer yresolution" [{res}]
    "string filename" ["textured-cornell.png"]
LookAt 278 273 -800   278 273 0   0 1 0
Camera "perspective" "float fov" [38]

WorldBegin

Texture "floor-checks" "spectrum" "checkerboard" "float uscale" [8] "float vscale" [8]
  "rgb tex1" [0.8 0.8 0.75] "rgb tex2" [0.1 0.1 0.12]
Texture "wall-image" "spectrum" "imagemap" "string filename" ["{wall}"]
Texture "rough-image" "float" "imagemap" "string filename" ["{rough}"] "string wrap" ["clamp"]
Texture "rough" "float" "scale" "texture tex" ["rough-image"] "float scale" [0.4]
Texture "ball-checks" "spectrum" "checkerboard" "string mapping" ["planar"]
  "vector3 v1" [0.04 0 0] "vector3 v2" [0 0.04 0] "rgb tex1" [0.85 0.85 0.85]
  "rgb tex2" [0.2 0.3 0.7]
Texture "ball-dirmix" "spectrum" "directionmix" "rgb tex1" [0.9 0.5 0.1]
  "rgb tex2" [0.1 0.4 0.8] "vector3 dir" [0 1 0]

MakeNamedMaterial "white" "string type" ["diffuse"] "rgb reflectance" [0.73 0.73 0.73]
MakeNamedMaterial "red" "string type" ["diffuse"] "rgb reflectance" [0.63 0.065 0.05]
MakeNamedMaterial "green" "string type" ["diffuse"] "rgb reflectance" [0.12 0.45 0.15]
MakeNamedMaterial "floor" "string type" ["{'coateddiffuse' if coated else 'diffuse'}"]
  "texture reflectance" ["floor-checks"]
MakeNamedMaterial "back" "string type" ["diffuse"] "texture reflectance" ["wall-image"]
MakeNamedMaterial "matte" "string type" ["diffuse"] "rgb reflectance" [0.7 0.6 0.4]
MakeNamedMaterial "brushed" "string type" ["conductor"] "texture roughness" ["rough"]
MakeNamedMaterial "ball-mix" "string type" ["mix"] "string materials" ["matte" "brushed"]
  "float amount" [0.5]

AttributeBegin
  AreaLightSource "diffuse" "rgb L" [18.4 15.6 8.0]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [213 548.7 227   343 548.7 227   343 548.7 332   213 548.7 332]
AttributeEnd

NamedMaterial "floor"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [552.8 0 0   0 0 0   0 0 559.2   549.6 0 559.2]
  "point2 uv" [1 0   0 0   0 1   1 1]
NamedMaterial "white"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [556 548.8 0   556 548.8 559.2   0 548.8 559.2   0 548.8 0]
NamedMaterial "back"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [549.6 0 559.2   0 0 559.2   0 548.8 559.2   556 548.8 559.2]
  "point2 uv" [1 0   0 0   0 1   1 1]
NamedMaterial "green"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [0 0 559.2   0 0 0   0 548.8 0   0 548.8 559.2]
NamedMaterial "red"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [552.8 0 0   549.6 0 559.2   556 548.8 559.2   556 548.8 0]

AttributeBegin
  NamedMaterial "ball-mix"
  {ball1}
AttributeEnd
AttributeBegin
  Material "diffusetransmission" "texture reflectance" ["ball-checks"]
    "texture transmittance" ["ball-dirmix"]
  {ball2}
AttributeEnd
"""


def textured_cornell_mesh_builder(levels=5, image_dir=None, res=256, spp=16, coated=False):
    """SceneBuilder of textured_cornell_mesh_pbrt."""
    b = bd.SceneBuilder()
    b.parse_tokens(lx.tokenize(textured_cornell_mesh_pbrt(levels, image_dir, res, spp, coated)))
    return b


def instanced_cornell_builder(levels=(6, 5), res=256, spp=16, instancing="auto",
                              filter_kind=None):
    """SceneBuilder of instanced_cornell_pbrt under `instancing` ("auto",
    "flatten" or "bvh"), optionally with another pixel filter."""
    b = bd.SceneBuilder()
    b.instancing = instancing
    b.parse_tokens(lx.tokenize(instanced_cornell_pbrt(*levels, res=res, spp=spp)))
    if filter_kind is not None:
        b.filter = {"type": filter_kind}
    return b


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
