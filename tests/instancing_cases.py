"""Instanced scenes as .pbrt text, shared by tests/test_torch_instancing.py,
tests/test_torch_gpu.py and chip_smoke.py. Imports neither jax nor pbrt_tpu.

- HEAD, QUAD and the small scenes of tests/test_instancing.py: INSTANCED
  (one definition placed three times, one of them scaled), FLATTENED (the
  same geometry written out), MIRROR (a mirrored instance), DEF_MATERIAL (an
  instance keeps the material of its definition) and COORD_SYS
  (CoordinateSystem / CoordSysTransform);
- AREA_LIGHT_IN_DEFINITION: a definition holding an area light (the
  builder refuses it);
- OPEN: an open scene (uniform infinite and distant light, no walls) of
  rotated and mirrored instances, which the render takes through the
  wavefront loop;
- instanced_cornell_pbrt(levels_a, levels_b) (from the port's
  scene/testscenes.py, where `python -m pbrt_tpu_torch.profile_render
  --scene cornell-instanced` finds it too): the cornell box's walls and
  light with 36 instances of a subdivided-octahedron ball (conductor) on a
  6x6 floor grid, every fourth mirrored, and 16 of a smaller gem
  (dielectric) on a raised 4x4 grid placed through a named coordinate
  system. At levels (6, 5) the balls have 32,768 triangles and the gems
  8,192: 1,310,732 world triangles, of which instancing "auto" flattens
  the first 7 balls and 3 gems (253,964 triangles) and shares the rest as 2
  prototypes (40,960 triangles).
"""
from pbrt_tpu_torch.scene.testscenes import _octahedron_pbrt, instanced_cornell_pbrt

HEAD = """
Integrator "path" "integer maxdepth" [3]
Sampler "independent" "integer pixelsamples" [1]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
LookAt 0 0 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [10 10 10]
  Shape "trianglemesh" "integer indices" [0 1 2]
    "point3 P" [-1 2.9 0   1 2.9 0   0 2.9 1]
AttributeEnd
Material "diffuse" "rgb reflectance" [0.6 0.5 0.4]
"""

QUAD = ('Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
        '"point3 P" [-0.5 -0.5 0   0.5 -0.5 0   0.5 0.5 0   -0.5 0.5 0]')

INSTANCED = HEAD + f"""
ObjectBegin "card"
  Translate 0 0 0.25
  {QUAD}
ObjectEnd
ObjectInstance "card"
Translate 1.2 0 0
ObjectInstance "card"
Translate -2.4 0 0
Scale 2 2 2
ObjectInstance "card"
"""

FLATTENED = HEAD + f"""
Translate 0 0 0.25
{QUAD}
Identity
Translate 1.2 0 0
Translate 0 0 0.25
{QUAD}
Identity
Translate 1.2 0 0
Translate -2.4 0 0
Scale 2 2 2
Translate 0 0 0.25
{QUAD}
"""

MIRROR = HEAD + f"""
ObjectBegin "card"
  Translate 0.1 0 0.25
  {QUAD}
ObjectEnd
Scale -1 1 1
ObjectInstance "card"
"""

DEF_MATERIAL = HEAD + f"""
ObjectBegin "card"
  {QUAD}
ObjectEnd
Material "conductor" "float roughness" [0.2]
Translate 1 0 0
ObjectInstance "card"
"""

COORD_SYS = HEAD + f"""
CoordinateSystem "saved"
Translate 5 0 0
CoordSysTransform "saved"
{QUAD}
"""

AREA_LIGHT_IN_DEFINITION = HEAD + f"""
ObjectBegin "lamp"
  AreaLightSource "diffuse" "rgb L" [1 1 1]
  {QUAD}
ObjectEnd
"""

# the same definition also as quadrics (flattened at every instance)
QUADRICS = HEAD + """
ObjectBegin "pair"
  Translate 0.3 0 0.5
  Shape "sphere" "float radius" [0.4]
  Translate -0.8 0 0
  Shape "disk" "float radius" [0.3]
ObjectEnd
Translate -0.6 0 0
ObjectInstance "pair"
Translate 1.4 0.2 0
Scale -1.5 1.5 1.5
ObjectInstance "pair"
"""

OPEN = """
Integrator "path" "integer maxdepth" [4]
Sampler "independent" "integer pixelsamples" [2]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
LookAt 0 2 -7  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "infinite" "rgb L" [0.4 0.45 0.5]
LightSource "distant" "point3 from" [1 4 -2] "point3 to" [0 0 0] "rgb L" [3 3 3]
ObjectBegin "ball"
  Material "diffuse" "rgb reflectance" [0.7 0.4 0.2]
  """ + _octahedron_pbrt(0, 0, 0, 1, 2) + """
ObjectEnd
""" + "".join(
    f"AttributeBegin\n  Translate {-2.4 + 1.6 * k} 0 {0.5 * (k % 2)}\n  Rotate {40 * k} 0 1 1\n"
    + ("  Scale -1 1 1\n" if k % 2 else "") + '  ObjectInstance "ball"\nAttributeEnd\n'
    for k in range(4))
