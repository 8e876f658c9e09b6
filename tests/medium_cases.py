"""Shared inputs of the media tests (tests/test_torch_medium*.py,
tests/test_torch_gpu.py) and of chip_smoke.py: FOG_SPHERE, a fog sphere
behind a material-less interface under an area light (the text of
tests/test_medium.py), the repo's volumetric-caustic scene, and synthetic
path-state lanes in and out of a medium. Imports nothing of JAX; the JAX
twins are tests/medium_jax.py's."""
import pathlib

import torch

ROOT = pathlib.Path(__file__).parent.parent
CAUSTIC = ROOT / "scenes" / "volumetric-caustic.pbrt"

FOG_SPHERE = """
Film "rgb" "integer xresolution" [32] "integer yresolution" [32]
Sampler "independent" "integer pixelsamples" [8]
Integrator "path" "integer maxdepth" [8]
LookAt 0 0 -6   0 0 0   0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [%(sa)s %(sa)s %(sa)s] "rgb sigma_s" [%(ss)s %(ss)s %(ss)s]
    "float g" [0.0]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [12 12 12]
  Translate 0 4 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-1.5 0 -1.5  1.5 0 -1.5  1.5 0 1.5  -1.5 0 1.5]
AttributeEnd
AttributeBegin
  Material "interface"
  MediumInterface "fog" ""
  Shape "sphere" "float radius" [1.5]
AttributeEnd
Material "diffuse" "rgb reflectance" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-8 -2 -8  8 -2 -8  8 -2 8  -8 -2 8]
"""


def fog_text(sa=0.3, ss=0.6, g=0.0, lights=True):
    """FOG_SPHERE with its fog's coefficients and g; lights=False takes its
    one light out (a volumetric scene without lights)."""
    text = (FOG_SPHERE % {"sa": sa, "ss": ss}).replace('"float g" [0.0]', f'"float g" [{g}]')
    if not lights:
        head, rest = text.split("AttributeBegin\n  AreaLightSource", 1)
        text = head + rest.split("AttributeEnd\n", 1)[1]
    return text


def synthetic_fog_lanes(scene, meta, n, seed):
    """n path-state lanes of a volumetric scene in the middle of a path
    (path_cases.synthetic_state), each in a medium at random: lanes inside
    the fog (medium 0) and outside (-1), transmittance pdfs below 1."""
    import path_cases as pc

    st = pc.synthetic_state(scene, meta, n, seed)
    g = torch.Generator().manual_seed(seed + 1)
    n_med = scene.med_g.shape[0]
    medium = torch.randint(-1, max(n_med, 1), (n,), generator=g)
    trans_pdf = 0.2 + 0.8 * torch.rand((n, 4), generator=g)
    return st._replace(medium=medium.to(st.o.device), trans_pdf=trans_pdf.to(st.o.device))
