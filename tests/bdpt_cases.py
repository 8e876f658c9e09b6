"""K12 (csrc/bdpt.cu) against its plain version, shared by
tests/test_torch_gpu.py and chip_smoke.py, and a scene with every light
type the builder emits (FOUR_LIGHTS_PBRT, also read by
tests/test_torch_bdpt.py). Imports neither jax nor pbrt_tpu.

Criterion: a (strategy, lane) contribution agrees when each of its four
wavelengths is within ATOL + RTOL |plain|. The kernel and the plain version
do the same float32 operations in the same order (3-term dots as
(x + y) + z, built with --fmad=false), except where the plain version
reduces with torch.sum (pdf_we's cosine, pdf_le's, offset_ray_origin's side
test) and raises to powers with torch.pow; so all but a handful of lanes
may round apart. For every strategy, CLOSE_FRAC of the lanes where either
side is nonzero must agree (below 10^4 live lanes: all of them), so a
strategy that is wrong on its few live lanes fails however rare it is.
Shadow-ray counts must be equal, and so must the splat pixel ids of
agreeing t = 1 contributions."""
import torch

RTOL, ATOL = 1e-4, 1e-6
CLOSE_FRAC = 0.9999
# every light type the builder emits (triangle, sphere and disk area lights,
# distant, spot and uniform infinite), a lens, and diffuse, rough conductor,
# dielectric and diffuse-transmission surfaces between them
FOUR_LIGHTS_PBRT = """
Integrator "bdpt" "integer maxdepth" [5]
Sampler "independent"
LookAt 0 1.5 -6  0 0.8 0  0 1 0
Camera "perspective" "float fov" [45] "float lensradius" [0.05] "float focaldistance" [6]
WorldBegin
LightSource "distant" "point3 from" [1 3 -2] "point3 to" [0 0 0] "rgb L" [2 1.5 1]
LightSource "infinite" "rgb L" [0.3 0.4 0.5]
LightSource "spot" "point3 from" [0 4 -1] "point3 to" [0.5 0 0]
    "float coneangle" [40] "float conedeltaangle" [10] "rgb I" [25 20 15]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 3 2]
  Translate 1.5 2.2 0.5
  Shape "sphere" "float radius" [0.4]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 6 6] "bool twosided" [true]
  Translate -1.5 2.5 0
  Rotate 90 1 0 0
  Shape "disk" "float radius" [0.5] "float innerradius" [0.1]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [3 3 5]
  Shape "trianglemesh" "integer indices" [0 1 2]
    "point3 P" [-0.5 3 1.5  0.5 3 1.5  0 3 0.8]
AttributeEnd
Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
AttributeBegin
  Material "conductor" "float roughness" [0.2]
  Translate -0.9 0.5 0.3
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "dielectric" "float eta" [1.5]
  Translate 0.6 0.5 -0.2
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "diffusetransmission" "rgb reflectance" [0.3 0.4 0.3]
      "rgb transmittance" [0.4 0.3 0.3]
  Translate 0 1.2 1.5
  Shape "sphere" "float radius" [0.35]
AttributeEnd
"""


def four_lights_builder(res):
    """SceneBuilder of FOUR_LIGHTS_PBRT at res x res."""
    from pbrt_tpu_torch.scene import builder as bd, lexer as lx

    b = bd.SceneBuilder()
    b.parse_tokens(lx.tokenize(FOUR_LIGHTS_PBRT))
    b.film["xresolution"] = b.film["yresolution"] = res
    return b


def wave_inputs(scene, meta, pixel_ids, sample_ids):
    """What K12 is given for the lanes (pixel_ids, sample_ids): (light
    vertices, camera vertices, wavelengths (R,4), strategy list, sampled
    endpoints), drawn as li_bdpt draws them."""
    from pbrt_tpu_torch.integrators import bdpt, render as rd

    p_film, wl, r, _ = rd.film_samples(scene, meta, pixel_ids, sample_ids)
    cam_vs, r, _ = bdpt.camera_path(scene, meta, p_film, r, wl, meta.sampler, meta.spp)
    light_vs, r, _ = bdpt.light_path(scene, meta, r, wl, meta.sampler, meta.spp)
    table = bdpt.strategies(len(cam_vs), len(light_vs), meta.max_depth)
    samples, _ = bdpt.sample_endpoints(scene, light_vs, cam_vs, table, r, wl, meta.sampler,
                                       meta.spp)
    return light_vs, cam_vs, wl.lam.contiguous(), table, samples


def compare(scene, meta, light_vs, cam_vs, lam, table, samples):
    """K12 and its plain version on the same inputs, each with its own
    visibility dispatch -> {lanes, strategies, frac: the least share of
    agreeing contributions among a strategy's live lanes (where either side
    is nonzero), worst: that strategy (s, t), live: live (strategy, lane)
    contributions, strategies_live: strategies live on some lane, L_frac:
    share of lanes whose t > 1 sum agrees, rays_kernel, rays_plain,
    splat_pix_differ: agreeing live splats whose pixel ids differ,
    max_abs_err: the largest difference over every contribution}."""
    from pbrt_tpu_torch.integrators import bdpt

    R = lam.shape[0]
    per_k = torch.empty((len(table), R, 4), device=lam.device)
    L_k, splat_k, pix_k, n_k = bdpt.connect_all_cuda(scene, meta, light_vs, cam_vs, lam, table,
                                                     samples, per_k)
    per_p = []
    L_p, splat_p, pix_p, n_p = bdpt.connect_all_plain(scene, meta, light_vs, cam_vs, lam, table,
                                                      samples, per_p)
    per_p = torch.stack(per_p)

    def close(a, b):
        return ((a - b).abs() <= ATOL + RTOL * b.abs()).all(-1)

    ok = close(per_k, per_p)
    live = (per_k != 0).any(-1) | (per_p != 0).any(-1)
    n_live = live.sum(-1)
    frac = torch.where(n_live > 0, (ok & live).sum(-1).double() / n_live.clamp(min=1), 1.0)
    w = int(frac.argmin())
    live_splat = (splat_p != 0).any(-1) & close(splat_k, splat_p)
    return dict(lanes=R, strategies=len(table), frac=float(frac[w]), worst=tuple(table[w]),
                live=int(n_live.sum()), strategies_live=int((n_live > 0).sum()),
                L_frac=float(close(L_k, L_p).double().mean()), rays_kernel=int(n_k),
                rays_plain=int(n_p),
                splat_pix_differ=int((pix_k[live_splat] != pix_p[live_splat]).sum()),
                max_abs_err=float((per_k - per_p).abs().max()))


def require_agreement(res):
    """Raise unless compare()'s result meets the criterion."""
    if not (res["frac"] >= CLOSE_FRAC and res["rays_kernel"] == res["rays_plain"]
            and res["splat_pix_differ"] == 0):
        raise AssertionError(f"K12 disagrees with its plain version: {res}")
