"""Built-in test scenes (no external files needed): the Cornell box text
and its BVH variant with the two spheres replaced by subdivided triangle
meshes (counterpart of pbrt_tpu/scene/testscenes.py; the classic Cornell
box dimensions are public-domain measurement data)."""
from pbrt_tpu_torch.scene import builder as bd
from pbrt_tpu_torch.scene import lexer as lx
from pbrt_tpu_torch.scene.compile import compile_scene

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


def cornell_mesh(res=128, spp=4, levels=5, device=None, filter_kind=None):
    """-> (Scene, SceneMeta): the BVH-exercising Cornell variant."""
    return compile_scene(cornell_mesh_builder(levels, res, filter_kind),
                         spp_override=spp, device=device)
