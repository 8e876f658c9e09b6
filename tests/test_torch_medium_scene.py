"""Participating media in the port's scene description on the CPU, against
the JAX package: the builder and compiled tables of FOG_SPHERE,
volumetric-caustic and a fog scene of enough triangles for the BVH route
(its media in BVH leaf order, in tri_med and in tri_rec's medium columns)
equal JAX's; dispatch.intersect's medium ids equal JAX's on both routes;
MLT over BDPT takes 16 + 40 (max_depth + 2) primary samples on a volumetric
scene, and a tiny volumetric MLT frame is finite; the combinations the
medium branches do not cover raise a ValueError that names them."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pbrt_tpu.accel import dispatch as jdispatch
from pbrt_tpu_torch.accel import dispatch as tdispatch
from pbrt_tpu_torch.integrators import mlt, path as tpath, render as trender
from pbrt_tpu_torch.scene import builder as tbd, lexer as tlx
from pbrt_tpu_torch.scene.compile import compile_arrays, compile_scene
import medium_cases as mc
import medium_jax as mj

torch.set_num_threads(2)

# a fog box of 12 interface triangles over a floor of 2 x 40^2 triangles:
# past MIN_TRIS_FOR_BVH, so the BVH route
GRID = 40
_FLOOR = " ".join(f"{-8 + 16 * i / GRID} -2 {-8 + 16 * j / GRID}"
                  for j in range(GRID + 1) for i in range(GRID + 1))
_IDX = " ".join(f"{j * (GRID + 1) + i} {j * (GRID + 1) + i + 1} {(j + 1) * (GRID + 1) + i + 1} "
                f"{j * (GRID + 1) + i} {(j + 1) * (GRID + 1) + i + 1} {(j + 1) * (GRID + 1) + i}"
                for j in range(GRID) for i in range(GRID))
FOG_BOX = f"""
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
Sampler "independent" "integer pixelsamples" [2]
Integrator "bdpt" "integer maxdepth" [4]
LookAt 0 1 -6   0 0 0   0 1 0
Camera "perspective" "float fov" [45]
MakeNamedMedium "haze" "string type" "homogeneous" "rgb sigma_a" [0.05 0.05 0.05]
    "rgb sigma_s" [0.1 0.1 0.1] "float g" [-0.3]
MediumInterface "" "haze"
WorldBegin
MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0.2 0.3 0.4]
    "rgb sigma_s" [0.5 0.5 0.5] "float g" [0.5]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Translate 0 3 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]
AttributeEnd
AttributeBegin
  Material "interface"
  MediumInterface "fog" "haze"
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3  4 6 5 4 7 6  0 4 5 0 5 1
      1 5 6 1 6 2  2 6 7 2 7 3  3 7 4 3 4 0]
    "point3 P" [-1 -1 -1  1 -1 -1  1 -1 1  -1 -1 1  -1 1 -1  1 1 -1  1 1 1  -1 1 1]
AttributeEnd
Material "diffuse" "rgb reflectance" [0.6 0.6 0.6]
Shape "trianglemesh" "integer indices" [{_IDX}] "point3 P" [{_FLOOR}]
"""
EXACT = ("tri_med", "sph_med", "dsk_med", "camera_medium", "lt_medium", "med_g", "tri_rec",
         "tri_mat")
CLOSE = ("med_sigma_a", "med_sigma_s")


def _builders(name):
    if name == "fog sphere":
        return mj.builders(mc.fog_text(0.3, 0.6, 0.3))
    if name == "fog box":
        return mj.builders(FOG_BOX)
    return mj.builders(path=mc.CAUSTIC)


@pytest.fixture(scope="module", params=["fog sphere", "volumetric-caustic", "fog box"])
def both(request):
    jb, tb = _builders(request.param)
    js, jm, _, _ = mj.twins(jb, 2)
    ta, tm = compile_arrays(tb, spp_override=2)
    return request.param, js, jm, ta, tm, jb, tb


def test_builder_media_match_jax(both):
    name, _, _, _, _, jb, tb = both
    assert len(tb.media) == len(jb.media) > 0
    for a, b in zip(tb.media, jb.media):
        np.testing.assert_allclose(a["sigma_a"], b["sigma_a"], rtol=1e-12)
        np.testing.assert_allclose(a["sigma_s"], b["sigma_s"], rtol=1e-12)
        assert a["g"] == b["g"]
    assert tb.camera_medium == jb.camera_medium
    assert tb.tri_med == [tuple(m) for m in jb.tri_med]
    assert [sp["med"] for sp in tb.spheres] == [tuple(sp["med"]) for sp in jb.spheres]
    assert [(l.type, l.medium) for l in tb.lights] == [(l.type, l.medium) for l in jb.lights]
    # material-less interfaces: FOG_SPHERE's sphere, the fog box's faces
    assert (min(tb.tri_mat + [s["mat"] for s in tb.spheres]) < 0) == (
        name != "volumetric-caustic")


@pytest.mark.parametrize("field", EXACT + CLOSE)
def test_compiled_media_tables_match_jax(both, field):
    """The medium tables, each shape's media (in BVH leaf order on the BVH
    route, also tri_rec's columns 19:21), the camera's and the lights'
    media: equal to JAX's (the sigma rows to 1e-6); volumetric too."""
    name, js, jm, ta, tm, _, _ = both
    assert tm.volumetric and jm.volumetric
    want, got = np.asarray(getattr(js, field)), ta[field]
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    if field in CLOSE:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    if name == "fog box" and field == "tri_med":
        # the faces: inside the fog (1), outside the haze (0); the rest in the haze
        assert tm.bvh_nint > 0 and {(int(a), int(b)) for a, b in got} == {(1, 0), (-1, 0), (-1, -1)}


@pytest.mark.parametrize("name", ["fog sphere", "fog box"])
def test_hit_media_match_jax(name):
    """dispatch.intersect's med_in / med_out (the dense route's sphere and
    the BVH route's tri_rec columns) on random rays equal JAX's wherever the
    two hit the same shape (material and validity equal)."""
    jb, _ = _builders(name)
    js, jm, ts, tm = mj.twins(jb, 2)
    rng = np.random.default_rng(3)
    n = 4096
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32) + np.asarray(ts.sph_center[0]
                                                                        if name == "fog sphere"
                                                                        else [0, 0, 6.0],
                                                                        np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    jh = jdispatch.intersect(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    th = tdispatch.intersect(ts, tm, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(t_max))
    same = (th.valid.numpy() == np.asarray(jh.valid)) & (th.mat.numpy() == np.asarray(jh.mat))
    assert same.mean() > 0.99
    for k in ("med_in", "med_out"):
        np.testing.assert_array_equal(getattr(th, k).numpy()[same],
                                      np.asarray(getattr(jh, k))[same], k)
    iface = same & th.valid.numpy() & (th.mat.numpy() < 0)
    assert iface.sum() > 100 and (th.med_in.numpy()[iface] != th.med_out.numpy()[iface]).all()


def test_mlt_dims_and_tiny_volumetric_frame():
    """MLT over BDPT on volumetric-caustic takes 376 primary samples a chain
    (16 + 40 (7 + 2), JAX mlt.py:201; 16 + 16 (7 + 2) without media); a
    tiny frame (8^2, max depth 2, 256 chains, 8 mutations a pixel) is
    finite and carries light."""
    scene, meta = compile_scene(mj.builders(path=mc.CAUSTIC)[1], device="cpu")
    assert meta.integrator == "mlt" and mlt.bdpt_dims(meta) == 376
    assert mlt.bdpt_dims(dataclasses.replace(meta, volumetric=False)) == 160
    b = mj.builders(path=mc.CAUSTIC, res=8, max_depth=2)[1]
    scene, meta = compile_scene(b, device="cpu")
    img, stats = mlt.render_mlt(scene, dataclasses.replace(meta, mutations_per_pixel=8),
                                n_chains=256, n_bootstrap=1024, device="cpu")
    img = img.numpy()
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0
    assert stats["mutations"] == 256 * (8 * 64 // 256) and stats["shadow"] > 0


COATED_FOG = mc.fog_text().replace(
    'Material "diffuse" "rgb reflectance" [0.7 0.7 0.7]',
    'Material "coateddiffuse" "rgb reflectance" [0.7 0.7 0.7]')
INSTANCED_FOG = mc.fog_text().replace("WorldBegin", "WorldBegin\n").replace(
    'Material "diffuse" "rgb reflectance" [0.7 0.7 0.7]\nShape',
    'ObjectBegin "floor"\nMaterial "diffuse" "rgb reflectance" [0.7 0.7 0.7]\nShape') + \
    'ObjectEnd\nObjectInstance "floor"\n'


def test_cli_renders_volumetric_caustic(tmp_path):
    """The CLI renders the repo's volumetric scene (8^2, 1 spp, the path
    integrator, on the CPU)."""
    from pbrt_tpu_torch import cli
    from pbrt_tpu_torch.film import png

    out = tmp_path / "fog.png"
    assert cli.main([str(mc.CAUSTIC), "--resolution", "8x8", "--spp", "1", "--integrator", "path",
                     "--device", "cpu", "--outfile", str(out), "--quiet"]) == 0
    assert png.read_png(str(out)).shape == (8, 8, 3)


@pytest.mark.parametrize("what", ["coated", "instanced"])
@pytest.mark.parametrize("integrator", ["path", "bdpt"])
def test_uncovered_combinations_raise(what, integrator):
    """A volumetric scene with coated materials, or with a two-level
    (instanced) BVH, raises a ValueError naming the combination."""
    b = tbd.SceneBuilder()
    if what == "instanced":
        b.instancing = "bvh"
    b.parse_tokens(tlx.tokenize(COATED_FOG if what == "coated" else INSTANCED_FOG))
    b.film["xresolution"] = b.film["yresolution"] = 4
    scene, meta = compile_scene(b, 1, device="cpu", integrator_override=integrator)
    assert meta.volumetric
    with pytest.raises(ValueError, match="coated" if what == "coated" else "instanced"):
        trender.render(scene, meta, device="cpu")


def test_instanced_media_refused_by_the_builder():
    """A shared (two-level) instance whose shapes carry media or a
    material-less interface is refused when the instance is made."""
    text = mc.fog_text().replace(
        'AttributeBegin\n  Material "interface"', 'ObjectBegin "ball"\nAttributeBegin\n'
        '  Material "interface"').replace(
        'Shape "sphere" "float radius" [1.5]\nAttributeEnd',
        'Shape "trianglemesh" "integer indices" [0 1 2] "point3 P" [0 0 0 1 0 0 0 1 0]\n'
        'AttributeEnd\nObjectEnd\nObjectInstance "ball"')
    b = tbd.SceneBuilder()
    b.instancing = "bvh"
    with pytest.raises(ValueError, match="media or material-less interfaces"):
        b.parse_tokens(tlx.tokenize(text))
    assert tpath.MAX_HOPS == 8
