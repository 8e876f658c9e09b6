"""pbrt_tpu_torch scene compile vs pbrt_tpu: the port's own numpy compile
must equal pbrt_tpu.scene.compile field by field (BVH rows, hit records,
integer columns and the light alias table exactly; float columns to 1e-6
relative) on cornell_mesh_pbrt(levels=3) (BVH, two filters), the plain
cornell box (dense, spheres), caustic-glass (a disk light, named glass
spectrum), a scene of partial spheres and disks with a spot light, terrain
n=16 (PLY, distant and infinite lights), material-testball (coated
conductor, loopsubdiv, partial sphere) and staircase (63k-triangle PLY,
coated diffuse); scene_from_arrays must round-trip, and what the port does
not render yet must raise."""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from pbrt_tpu.scene import builder as jbd, lexer as jlx, testscenes as jts
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch.scene import builder as tbd, lexer as tlx, testscenes as tts
from pbrt_tpu_torch.scene.compile import (Scene, SceneMeta, compile_arrays, compile_scene,
                                          scene_from_arrays)

torch.set_num_threads(2)

EXACT = ["bvh_rows", "tri_rec", "mat_type", "mat_remap",
         "mat_eta_spec", "mat_k_spec", "mat_refl_mode", "lt_type", "lt_twosided",
         "lt_tri", "lt_alias_rows", "tri_p0", "tri_p1", "tri_p2",
         "tri_n0", "tri_n1", "tri_n2", "tri_has_n", "tri_uv0", "tri_uv1", "tri_uv2",
         "tri_mat", "tri_light", "tri_rev", "sph_mat", "sph_light", "dsk_mat", "dsk_light",
         "lt_sph", "lt_dsk"]
CLOSE = ["mat_refl_c", "mat_trans_c", "mat_urough", "mat_vrough", "mat_eta",
         "spec_table", "lt_emission", "lt_scale", "lt_pmf", "camera_from_raster",
         "render_from_camera", "camera_lens_radius", "camera_focal_distance",
         "scene_radius", "ray_offset_scale",
         "sph_center", "sph_radius", "sph_rot", "sph_zmin", "sph_zmax", "sph_phimax",
         "dsk_center", "dsk_normal", "dsk_radius", "dsk_inner", "dsk_xaxis", "dsk_yaxis",
         "dsk_phimax", "lt_direction", "lt_position", "lt_cos_start", "lt_cos_end",
         "mat_albedo_c", "mat_thickness", "mat_ieta", "mat_lay_g", "mat_crough_u", "mat_crough_v",
         "camera_A", "camera_cos_total", "camera_res", "scene_center"]
SCENES = ["cornell-mesh mitchell", "cornell-mesh box", "cornell", "caustic-glass",
          "partial quadrics", "terrain", "testball", "staircase"]
SCENE_FILES = {"testball": "material-testball.pbrt", "staircase": "staircase.pbrt"}
SCENES_DIR = pathlib.Path(__file__).parent.parent / "scenes"
PARTIAL_PBRT = """
LookAt 0 0 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "spot" "point3 from" [0 3 0] "point3 to" [0 0 0] "rgb I" [3 3 3]
    "float power" [20]
AttributeBegin
  Rotate 30 0 1 0
  Shape "sphere" "float radius" [1] "float zmin" [-0.5] "float zmax" [0.8]
      "float phimax" [270]
AttributeEnd
AttributeBegin
  Translate 2 0 0
  Scale 2 2 2
  Shape "disk" "float radius" [0.5] "float innerradius" [0.2] "float phimax" [200]
      "float height" [0.1]
AttributeEnd
AttributeBegin
  ReverseOrientation
  Translate -2 0 0
  Shape "disk" "float radius" [0.4]
AttributeEnd
"""


def _jax_builder(text, res):
    b = jbd.SceneBuilder()
    b.parse_tokens(jlx.tokenize(text))
    b.film["xresolution"] = b.film["yresolution"] = res
    return b


def _scene_text(name, tmp_dir):
    if name.startswith("cornell-mesh"):
        return jts.cornell_mesh_pbrt(levels=3)
    if name == "cornell":
        return jts.CORNELL_PBRT
    if name == "caustic-glass":
        path = pathlib.Path(__file__).parent.parent / "scenes" / "caustic-glass.pbrt"
        return path.read_text().replace('Integrator "bdpt"', 'Integrator "path"')
    if name == "partial quadrics":
        return PARTIAL_PBRT
    return tts.terrain_pbrt(tts.terrain_ply_path(16, tmp_dir))


@pytest.fixture(scope="module", params=SCENES)
def both(request, tmp_path_factory):
    if request.param in SCENE_FILES:   # read from the file: its PLY is beside it
        path = str(SCENES_DIR / SCENE_FILES[request.param])
        jb, tb = jbd.SceneBuilder().parse_file(path), tbd.SceneBuilder().parse_file(path)
        for b in (jb, tb):
            b.film["xresolution"] = b.film["yresolution"] = 40
    else:
        text = _scene_text(request.param, tmp_path_factory.mktemp("ply"))
        jb = _jax_builder(text, 40)
        tb = tbd.SceneBuilder()
        tb.parse_tokens(tlx.tokenize(text))
        tb.film["xresolution"] = tb.film["yresolution"] = 40
    if request.param.endswith("box"):
        jb.filter = {"type": "box"}
        tb.filter = {"type": "box"}
    ja, jm = j_compile(jb, spp_override=4)
    ta, tm = compile_arrays(tb, spp_override=4)
    return ja, jm, ta, tm


@pytest.mark.parametrize("field", EXACT)
def test_field_exact(both, field):
    ja, _, ta, _ = both
    want = np.asarray(getattr(ja, field))
    got = ta[field]
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field", CLOSE)
def test_field_close(both, field):
    ja, _, ta, _ = both
    np.testing.assert_allclose(ta[field], np.asarray(getattr(ja, field)), rtol=1e-6)


def test_filter_tables_and_meta(both):
    ja, jm, ta, tm = both
    for k in ta["filt"]._fields:
        np.testing.assert_allclose(getattr(ta["filt"], k), np.asarray(getattr(ja.filt, k)),
                                   rtol=1e-6)
    assert tm.bvh_nint == ja.bvh_nint.shape[0]
    assert tm.bvh_depth == ja.bvh_depth.shape[0]
    assert tm.sph_partial == (ja.sph_partial_marker.shape[0] > 0)
    assert tm.dsk_partial == (ja.dsk_partial_marker.shape[0] > 0)
    assert tm.layered == (ja.lay_marker.shape[0] > 0)
    for k in ("resolution", "spp", "sampler", "integrator", "max_depth", "n_tris",
              "n_spheres", "n_disks", "n_lights", "filter_kind", "film_imaging_ratio",
              "open_scene", "mutations_per_pixel"):
        assert getattr(tm, k) == getattr(jm, k), k
    np.testing.assert_allclose(tm.film_out_matrix, jm.film_out_matrix, rtol=1e-6)


def test_scene_from_arrays_round_trip(both):
    ja, jm, ta, tm = both
    scene, meta = scene_from_arrays(ta, tm, "cpu")
    for f in dataclasses.fields(Scene):
        if f.name != "filt":
            np.testing.assert_array_equal(getattr(scene, f.name).numpy(), ta[f.name])
    for k, v in ta["filt"]._asdict().items():
        np.testing.assert_array_equal(getattr(scene.filt, k).numpy(), v)
    assert meta == tm
    # the JAX package's SceneArrays, field by field through np.asarray
    j_dict = {k: np.asarray(v) if k != "filt" else v for k, v in ja._asdict().items()
              if v is not None and k != "tex"}
    js, jmeta = scene_from_arrays(j_dict, jm, "cpu")
    assert (jmeta.bvh_nint, jmeta.bvh_depth) == (tm.bvh_nint, tm.bvh_depth)
    assert (jmeta.sph_partial, jmeta.dsk_partial, jmeta.layered) == (
        tm.sph_partial, tm.dsk_partial, tm.layered)
    assert torch.equal(js.bvh_rows, scene.bvh_rows) and torch.equal(js.tri_rec, scene.tri_rec)


def test_entry_points_need_a_device_choice():
    b = tts.cornell_mesh_builder(levels=1, res=8)
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means cuda here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_scene(b)
    scene, meta = compile_scene(b, device="cpu")
    assert isinstance(meta, SceneMeta) and scene.device == torch.device("cpu")


UNPORTED = {
    "image infinite light": 'WorldBegin\nLightSource "infinite" "string filename" "sky.exr"',
    "texture": 'WorldBegin\nTexture "t" "spectrum" "checkerboard"',
    "medium": 'MakeNamedMedium "m" "string type" "homogeneous"',
    "mix material": 'WorldBegin\nMaterial "mix"',
    "interface": 'WorldBegin\nMaterial "interface"',
    "mlt": 'Integrator "mlt"\nMakeNamedMedium "m" "string type" "homogeneous"',
    "aov integrator": 'Integrator "ambientocclusion"',
    "gaussian filter": 'PixelFilter "gaussian"',
    "instancing": 'WorldBegin\nObjectBegin "a"',
    "named material": 'WorldBegin\nNamedMaterial "a"',
}


@pytest.mark.parametrize("what", sorted(UNPORTED))
def test_unported_features_raise(what):
    """Parsing raises, or for an integrator (recorded as written, so that a
    file can be rendered with another) compiling does."""
    b = tbd.SceneBuilder()
    with pytest.raises(NotImplementedError, match="planned slice"):
        b.parse_tokens(tlx.tokenize(UNPORTED[what]))
        compile_arrays(b)
