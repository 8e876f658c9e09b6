"""The coated-diffuse slice end to end on the CPU: staircase (63,212
triangles, 63,196 of them from staircase-geo.ply, coateddiffuse woodwork,
two area lights) through the port's normal entry points at 16^2 x 4 spp,
max depth 3, box filter, against a live pbrt_tpu render of the same scene,
under tests/test_parity.py's image criterion on 8x8-pixel block means and
with honest ray counts within 1 % (tests/scene_render_check.py says why not
per pixel and not equal). The CPU runs the layered BxDF's plain version
(materials/layered.py)."""
import pathlib

import torch

from scene_render_check import check_against_live_jax

torch.set_num_threads(2)
SCENE = pathlib.Path(__file__).parent.parent / "scenes" / "staircase.pbrt"


def test_staircase_matches_live_jax_render():
    meta = check_against_live_jax(SCENE, res=16, spp=4, max_depth=3)
    assert meta.layered and meta.n_tris == 63212 and meta.bvh_nint > 0
