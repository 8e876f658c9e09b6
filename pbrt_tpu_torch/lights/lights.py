"""Light sampling, vectorized over lanes (counterpart of
pbrt_tpu/lights/lights.py; reference lights/ + light_samplers/). Every lane
carries a sampled light index; sampling gathers the light's table row and
selects by its type with torch.where:
  - area lights on triangles (shapes/triangle.cu:25-211: spherical-triangle
    sampling with a bilinear cosine warp inside the [MIN, MAX] solid-angle
    window, uniform-area sampling outside it), spheres (cone sampling from
    outside, area sampling from inside, sphere.cu) and disks (uniform area,
    disk.cu);
  - distant lights (a direction, seen from a pseudo-position 2 scene radii
    away), uniform infinite lights (uniform sphere directions) and spot
    lights (a delta position with smoothstep falloff).
BDPT's light subpaths start from `sample_le` (every light type above) and
its MIS weights read `pdf_le` (lights.py:534-736 of the JAX package).
Image infinite lights come with the textures slice; the builder refuses them.
"""
from typing import NamedTuple

import torch

from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.sampling import warps
from pbrt_tpu_torch.scene import builder as bd
from pbrt_tpu_torch.spectral import spectra
from pbrt_tpu_torch.utils.math import PI, smoothstep

MIN_SPHERICAL_SAMPLE_AREA = 3e-4
MAX_SPHERICAL_SAMPLE_AREA = 6.22


class LightLiSample(NamedTuple):
    L: torch.Tensor        # (R,4)
    wi: torch.Tensor       # (R,3)
    pdf: torch.Tensor      # (R,) solid-angle pdf
    p_light: torch.Tensor  # (R,3)
    n_light: torch.Tensor  # (R,3)
    valid: torch.Tensor    # (R,)
    is_delta: torch.Tensor  # (R,) delta direction or position light
    is_distant: torch.Tensor  # (R,) light at infinity (shadow ray to p_light)


def emission(scene, light_idx, lam):
    """scale * Lemit(lam) of light light_idx: (R,4)."""
    li = torch.clamp(light_idx, min=0).long()
    return spectra.sample_table(scene.lt_emission, li, lam) * scene.lt_scale[li][..., None]


def area_light_le(scene, light_idx, n, w, lam):
    """Radiance leaving an emissive surface hit: zero from the back side
    unless two-sided."""
    li = torch.clamp(light_idx, min=0).long()
    ok = (vm.dot(n, w) > 0.0) | scene.lt_twosided[li]
    return torch.where((ok & (light_idx >= 0))[..., None], emission(scene, light_idx, lam), 0.0)


def _tri_verts(scene, light_idx):
    t = torch.clamp(scene.lt_tri[torch.clamp(light_idx, min=0).long()], min=0).long()
    return scene.tri_p0[t], scene.tri_p1[t], scene.tri_p2[t]


def _tri_solid_angle(p0, p1, p2, p):
    return vm.spherical_triangle_area(
        vm.normalize(p0 - p), vm.normalize(p1 - p), vm.normalize(p2 - p))


def _tri_area_normal(p0, p1, p2):
    cr = vm.cross(p1 - p0, p2 - p0)
    area = 0.5 * vm.length(cr)
    return area, cr / torch.clamp(2.0 * area, min=1e-12)[..., None]


def _corner_weights(ns_ref, p0, p1, p2, p_ref):
    wi0 = vm.normalize(p0 - p_ref)
    wi1 = vm.normalize(p1 - p_ref)
    wi2 = vm.normalize(p2 - p_ref)
    return torch.stack([
        torch.clamp(vm.absdot(ns_ref, wi1), min=0.01),
        torch.clamp(vm.absdot(ns_ref, wi1), min=0.01),
        torch.clamp(vm.absdot(ns_ref, wi0), min=0.01),
        torch.clamp(vm.absdot(ns_ref, wi2), min=0.01),
    ], dim=-1)


def sample_area_light_li(scene, light_idx, p_ref, ns_ref, u2):
    """-> (p_light (R,3), n_light (R,3), pdf_sa (R,), valid)."""
    p0, p1, p2 = _tri_verts(scene, light_idx)
    area, n_geo = _tri_area_normal(p0, p1, p2)
    sa = _tri_solid_angle(p0, p1, p2, p_ref)
    use_area = (sa < MIN_SPHERICAL_SAMPLE_AREA) | (sa > MAX_SPHERICAL_SAMPLE_AREA)

    # uniform-area sampling, pdf converted to solid angle
    b_area = warps.sample_uniform_triangle(u2)
    pA = b_area[..., 0:1] * p0 + b_area[..., 1:2] * p1 + b_area[..., 2:3] * p2
    wiA = pA - p_ref
    dist2A = vm.length_squared(wiA)
    wiA_n = wiA / torch.sqrt(torch.clamp(dist2A, min=1e-24))[..., None]
    cosA = vm.absdot(n_geo, -wiA_n)
    pdfA = (1.0 / torch.clamp(area, min=1e-12)) * dist2A / torch.clamp(cosA, min=1e-9)
    validA = (dist2A > 0.0) & (cosA > 1e-7) & torch.isfinite(pdfA)

    # spherical triangle with the bilinear cosine warp at the receiver
    has_ns = vm.length_squared(ns_ref) > 0.0
    w_corner = _corner_weights(ns_ref, p0, p1, p2, p_ref)
    u_warp = torch.where(has_ns[..., None], warps.sample_bilinear(u2, w_corner), u2)
    pdf_warp = torch.where(has_ns, warps.bilinear_pdf(u_warp, w_corner), 1.0)
    b_sph, pdf_tri = warps.sample_spherical_triangle(p0, p1, p2, p_ref, u_warp)
    pB = b_sph[..., 0:1] * p0 + b_sph[..., 1:2] * p1 + b_sph[..., 2:3] * p2

    p_light = torch.where(use_area[..., None], pA, pB)
    pdf = torch.where(use_area, pdfA, pdf_tri * pdf_warp)
    valid = torch.where(use_area, validA, pdf_tri > 0.0)
    return p_light, n_geo, pdf, valid


def area_light_pdf_li(scene, light_idx, p_ref, ns_ref, wi, hit_p, hit_n):
    """Solid-angle pdf that sample_li generates wi towards the known hit
    point (hit_p, geometric normal hit_n) on area light light_idx."""
    li = torch.clamp(light_idx, min=0).long()
    out = torch.zeros(p_ref.shape[:-1], device=p_ref.device)
    if scene.sph_center.shape[0] > 0:
        out = torch.where(scene.lt_sph[li] >= 0,
                          sphere_light_pdf_li(scene, light_idx, p_ref, hit_p, hit_n, wi), out)
    if scene.dsk_center.shape[0] > 0:
        out = torch.where(scene.lt_dsk[li] >= 0,
                          disk_light_pdf_li(scene, light_idx, p_ref, hit_p, hit_n, wi), out)
    if scene.tri_p0.shape[0] == 0:
        return out
    p0, p1, p2 = _tri_verts(scene, light_idx)
    area, _ = _tri_area_normal(p0, p1, p2)
    sa = _tri_solid_angle(p0, p1, p2, p_ref)
    use_area = (sa < MIN_SPHERICAL_SAMPLE_AREA) | (sa > MAX_SPHERICAL_SAMPLE_AREA)

    dist2 = vm.length_squared(hit_p - p_ref)
    cos_l = vm.absdot(hit_n, -wi)
    pdfA = dist2 / torch.clamp(area * torch.clamp(cos_l, min=1e-9), min=1e-12)
    pdfA = torch.where(torch.isfinite(pdfA), pdfA, 0.0)

    has_ns = vm.length_squared(ns_ref) > 0.0
    u_inv = warps.invert_spherical_triangle_sample(p0, p1, p2, p_ref, wi)
    w_corner = _corner_weights(ns_ref, p0, p1, p2, p_ref)
    pdfB = 1.0 / torch.clamp(sa, min=1e-12) * torch.where(
        has_ns, warps.bilinear_pdf(u_inv, w_corner), 1.0)
    tri_pdf = torch.where(use_area, pdfA, pdfB)
    return torch.where(scene.lt_tri[li] >= 0, tri_pdf, out)


def sample_li(scene, light_idx, p_ref, ns_ref, u2, lam):
    """Li sample of light light_idx (R,) seen from p_ref, dispatched over the
    light types (lights.py:179-285 of the JAX package, image-infinite lights
    excepted)."""
    li = torch.clamp(light_idx, min=0).long()
    ltype = scene.lt_type[li]
    em = emission(scene, light_idx, lam)
    two_r = 2.0 * scene.scene_radius

    # area emitters: lt_tri / lt_sph / lt_dsk pick the shape; shape kinds
    # absent from the scene are skipped
    if scene.tri_p0.shape[0] > 0:
        p_a, n_a, pdf_a, valid_a = sample_area_light_li(scene, light_idx, p_ref, ns_ref, u2)
    else:
        p_a = p_ref
        n_a = torch.zeros_like(p_ref)
        n_a[..., 2] = 1.0
        pdf_a = torch.zeros(p_ref.shape[:-1], device=p_ref.device)
        valid_a = torch.zeros(p_ref.shape[:-1], dtype=torch.bool, device=p_ref.device)
    for shapes, table, sample in ((scene.sph_center, scene.lt_sph, sample_sphere_light_li),
                                  (scene.dsk_center, scene.lt_dsk, sample_disk_light_li)):
        if shapes.shape[0] > 0:
            is_k = table[li] >= 0
            p_k, n_k, pdf_k, valid_k = sample(scene, light_idx, p_ref, u2)
            p_a = torch.where(is_k[..., None], p_k, p_a)
            n_a = torch.where(is_k[..., None], n_k, n_a)
            pdf_a = torch.where(is_k, pdf_k, pdf_a)
            valid_a = torch.where(is_k, valid_k, valid_a)
    wi_a = vm.normalize(p_a - p_ref)
    L_a = torch.where((vm.dot(n_a, -wi_a) > 0.0) | scene.lt_twosided[li], 1.0, 0.0)[..., None] * em

    # distant: wi = light direction, pseudo-position 2 scene radii away
    wi_d = scene.lt_direction[li]
    p_d = p_ref + wi_d * two_r
    # uniform infinite: uniform sphere direction
    wi_u = warps.sample_uniform_sphere(u2)
    pdf_u = torch.full_like(pdf_a, warps.UNIFORM_SPHERE_PDF)
    p_u = p_ref + wi_u * two_r
    # spot: delta position, wi towards it, smoothstep cone falloff
    pos = scene.lt_position[li]
    to_spot = pos - p_ref
    d2_spot = vm.length_squared(to_spot)
    wi_s = to_spot / torch.sqrt(torch.clamp(d2_spot, min=1e-24))[..., None]
    falloff = smoothstep(vm.dot(-wi_s, scene.lt_direction[li]), scene.lt_cos_end[li],
                         scene.lt_cos_start[li])
    L_s = em * (falloff / torch.clamp(d2_spot, min=1e-12))[..., None]

    is_area = (ltype == bd.LIGHT_AREA)[..., None]
    is_distant = (ltype == bd.LIGHT_DISTANT)[..., None]
    is_uniform = ltype == bd.LIGHT_UNIFORM_INFINITE
    is_spot = (ltype == bd.LIGHT_SPOT)[..., None]
    wi = torch.where(is_area, wi_a, torch.where(is_distant, wi_d, torch.where(is_spot, wi_s, wi_u)))
    L = torch.where(is_area, L_a, torch.where(is_spot, L_s, em))
    pdf = torch.where(is_area[:, 0], pdf_a, torch.where(is_uniform, pdf_u, 1.0))
    p_light = torch.where(is_area, p_a, torch.where(is_spot, pos,
                                                    torch.where(is_distant, p_d, p_u)))
    valid = torch.where(is_area[:, 0], valid_a, True) & (light_idx >= 0) & (pdf > 0.0)
    return LightLiSample(
        L=L, wi=wi, pdf=pdf, p_light=p_light,
        n_light=torch.where(is_area, n_a, -wi),
        valid=valid,
        is_delta=(is_distant | is_spot)[:, 0],
        is_distant=is_distant[:, 0] | is_uniform,
    )


def uniform_infinite_pdf_li():
    return warps.UNIFORM_SPHERE_PDF


def infinite_light_density(scene, w_toward):
    """Sum over the uniform infinite lights of pmf * pdf_li(w_toward)
    (reference bdpt.cu:67-76; image infinite lights come with textures).
    -> (R,)"""
    pmf = torch.where(scene.lt_type == bd.LIGHT_UNIFORM_INFINITE, scene.lt_pmf, 0.0).sum()
    return torch.zeros(w_toward.shape[:-1], device=w_toward.device) + pmf * uniform_infinite_pdf_li()


def uniform_infinite_emission(scene):
    """The summed dense emission (471,) of the uniform infinite lights."""
    is_uinf = scene.lt_type == bd.LIGHT_UNIFORM_INFINITE
    em_all = scene.lt_emission * scene.lt_scale[:, None]
    return torch.where(is_uinf[:, None], em_all, 0.0).sum(dim=0)


def infinite_le(scene, d, lam):
    """Radiance of all uniform infinite lights along escaped directions d
    (reference Vertex::Le infinite branch, bdpt.cu:192-203). -> (R,4)"""
    return spectra.sample_dense(uniform_infinite_emission(scene), lam)


# ------------------------------------------------- sphere / disk emitters
# (reference shapes/sphere.cu sample(ctx): cone sampling outside, area
# sampling inside; shapes/disk.cu sample(ctx): uniform area -> solid angle)

_SMALL_CONE = 0.00068523  # sin^2 theta_max below which 1 - cos is taken as sin^2 / 2


def _sphere_of(scene, light_idx):
    sph = torch.clamp(scene.lt_sph[torch.clamp(light_idx, min=0).long()], min=0).long()
    return scene.sph_center[sph], scene.sph_radius[sph]


def _cone_pdf(sin2_max):
    cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))
    one_minus = torch.where(sin2_max < _SMALL_CONE, sin2_max / 2.0, 1.0 - cos_max)
    return cos_max, 1.0 / torch.clamp(2.0 * PI * one_minus, min=1e-12)


def sample_sphere_light_li(scene, light_idx, p_ref, u2):
    """-> (p_light, n_light, pdf (solid angle), valid)."""
    c, rad = _sphere_of(scene, light_idx)
    dist2 = vm.length_squared(c - p_ref)
    inside = dist2 <= rad * rad

    # outside: uniform cone (sphere.cu:188-240 / pbrt-v4)
    sin2_max = (rad * rad) / torch.clamp(dist2, min=1e-24)
    cos_max, pdf_out = _cone_pdf(sin2_max)
    cos_t = (cos_max - 1.0) * u2[..., 0] + 1.0
    sin2_t = 1.0 - cos_t * cos_t
    small = sin2_max < _SMALL_CONE
    sin2_t = torch.where(small, sin2_max * u2[..., 0], sin2_t)
    cos_t = torch.where(small, torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0)), cos_t)
    sin_max = torch.sqrt(torch.clamp(sin2_max, min=1e-24))
    cos_alpha = sin2_t / sin_max + cos_t * torch.sqrt(
        torch.clamp(1.0 - sin2_t / torch.clamp(sin2_max, min=1e-24), min=0.0))
    sin_alpha = torch.sqrt(torch.clamp(1.0 - cos_alpha * cos_alpha, min=0.0))
    phi = 2.0 * PI * u2[..., 1]
    fx, fy, fz = vm.frame_from_z(vm.normalize(p_ref - c))
    n_out = vm.from_local(fx, fy, fz, vm.spherical_direction(sin_alpha, cos_alpha, phi))
    p_out = c + rad[..., None] * n_out

    # inside: uniform area sample -> solid angle
    n_in = warps.sample_uniform_sphere(u2)
    p_in = c + rad[..., None] * n_in
    wi_in = vm.normalize(p_in - p_ref)
    d2_in = vm.length_squared(p_in - p_ref)
    cos_l = vm.absdot(n_in, -wi_in)
    pdf_in = d2_in / torch.clamp(4.0 * PI * rad * rad * torch.clamp(cos_l, min=1e-9), min=1e-12)

    pdf = torch.where(inside, pdf_in, pdf_out)
    return (torch.where(inside[..., None], p_in, p_out),
            torch.where(inside[..., None], n_in, n_out),
            pdf, torch.isfinite(pdf) & (pdf > 0.0))


def sphere_light_pdf_li(scene, light_idx, p_ref, hit_p, hit_n, wi):
    c, rad = _sphere_of(scene, light_idx)
    dist2 = vm.length_squared(c - p_ref)
    _, pdf_out = _cone_pdf((rad * rad) / torch.clamp(dist2, min=1e-24))
    d2 = vm.length_squared(hit_p - p_ref)
    cos_l = vm.absdot(hit_n, -wi)
    pdf_in = d2 / torch.clamp(4.0 * PI * rad * rad * torch.clamp(cos_l, min=1e-9), min=1e-12)
    return torch.where(dist2 <= rad * rad, pdf_in, pdf_out)


def _disk_of(scene, light_idx):
    dk = torch.clamp(scene.lt_dsk[torch.clamp(light_idx, min=0).long()], min=0).long()
    rad = scene.dsk_radius[dk]
    area = PI * (rad * rad - scene.dsk_inner[dk] ** 2)
    return scene.dsk_center[dk], scene.dsk_normal[dk], rad, area


def sample_disk_light_li(scene, light_idx, p_ref, u2):
    """Uniform-area disk sample converted to solid angle (disk.cu:42-85)."""
    c, n, rad, area = _disk_of(scene, light_idx)
    pd = warps.sample_uniform_disk_concentric(u2)
    fx, fy, _ = vm.frame_from_z(n)
    p_l = c + fx * (pd[..., 0] * rad)[..., None] + fy * (pd[..., 1] * rad)[..., None]
    wi = vm.normalize(p_l - p_ref)
    d2 = vm.length_squared(p_l - p_ref)
    cos_l = vm.absdot(n, -wi)
    pdf = d2 / torch.clamp(area * torch.clamp(cos_l, min=1e-9), min=1e-12)
    return p_l, n, pdf, torch.isfinite(pdf) & (pdf > 0.0) & (d2 > 0.0)


def disk_light_pdf_li(scene, light_idx, p_ref, hit_p, hit_n, wi):
    _, _, _, area = _disk_of(scene, light_idx)
    d2 = vm.length_squared(hit_p - p_ref)
    cos_l = vm.absdot(hit_n, -wi)
    pdf = d2 / torch.clamp(area * torch.clamp(cos_l, min=1e-9), min=1e-12)
    return torch.where(torch.isfinite(pdf), pdf, 0.0)


# ------------------------------------------------------ light-path emission
# (reference diffuse_area_light.cu:76-128, distant_light.cu,
# uniform_infinite_light.cu, spot_light.cu sample_le / pdf_le: BDPT's
# light-subpath starts)


def _area_shape_sample(scene, light_idx, u2):
    """Uniform-by-area point on the emitter shape of light_idx (R,) -> (p
    (R,3), ng (R,3), area (R,), valid (R,)); shape kinds absent from the
    scene are skipped."""
    li = torch.clamp(light_idx, min=0).long()
    R, dev = u2.shape[0], u2.device
    p = torch.zeros((R, 3), device=dev)
    n = torch.zeros((R, 3), device=dev)
    n[:, 2] = 1.0
    area = torch.ones((R,), device=dev)
    valid = torch.zeros((R,), dtype=torch.bool, device=dev)
    if scene.tri_p0.shape[0] > 0:
        is_t = scene.lt_tri[li] >= 0
        p0, p1, p2 = _tri_verts(scene, light_idx)
        a_t, n_t = _tri_area_normal(p0, p1, p2)
        b = warps.sample_uniform_triangle(u2)
        p_t = b[..., 0:1] * p0 + b[..., 1:2] * p1 + b[..., 2:3] * p2
        p = torch.where(is_t[..., None], p_t, p)
        n = torch.where(is_t[..., None], n_t, n)
        area = torch.where(is_t, a_t, area)
        valid = valid | is_t
    if scene.sph_center.shape[0] > 0:
        is_s = scene.lt_sph[li] >= 0
        c, rad = _sphere_of(scene, light_idx)
        n_s = warps.sample_uniform_sphere(u2)
        p = torch.where(is_s[..., None], c + rad[..., None] * n_s, p)
        n = torch.where(is_s[..., None], n_s, n)
        area = torch.where(is_s, 4.0 * PI * rad * rad, area)
        valid = valid | is_s
    if scene.dsk_center.shape[0] > 0:
        is_d = scene.lt_dsk[li] >= 0
        c, nd, rad, a_d = _disk_of(scene, light_idx)
        pd = warps.sample_uniform_disk_concentric(u2)
        fx, fy, _ = vm.frame_from_z(nd)
        p_d = c + fx * (pd[..., 0] * rad)[..., None] + fy * (pd[..., 1] * rad)[..., None]
        p = torch.where(is_d[..., None], p_d, p)
        n = torch.where(is_d[..., None], nd, n)
        area = torch.where(is_d, a_d, area)
        valid = valid | is_d
    return p, n, area, valid


def _disk_pdf(scene):
    return 1.0 / (PI * torch.clamp(scene.scene_radius * scene.scene_radius, min=1e-12))


def sample_le(scene, light_idx, u_pos, u_dir, lam):
    """Emit a ray from light light_idx (R,) -> (Le (R,4), p (R,3), ng (R,3),
    w (R,3), pdf_pos (R,), pdf_dir (R,), valid (R,)). Area lights emit
    cosine-weighted from a uniform point of their shape; distant and uniform
    infinite lights start on the scene's bounding disk facing the emission
    direction (pdf_pos = 1 / (pi r^2)); a spot light from its position
    (pdf_pos 1) into a uniform cone. Delta quantities report pdf 1 (BDPT's
    MIS handles the delta)."""
    li = torch.clamp(light_idx, min=0).long()
    ltype = scene.lt_type[li]
    is_area = ltype == bd.LIGHT_AREA
    is_distant = ltype == bd.LIGHT_DISTANT
    is_uniform = ltype == bd.LIGHT_UNIFORM_INFINITE
    is_spot = ltype == bd.LIGHT_SPOT
    em = emission(scene, light_idx, lam)
    radius = scene.scene_radius

    # area emitters: cosine hemisphere about the shape normal (both sides
    # for two-sided lights)
    p_a, ng_a, area, shape_ok = _area_shape_sample(scene, light_idx, u_pos)
    two = scene.lt_twosided[li]
    u0 = u_dir[..., 0]
    flipside = two & (u0 >= 0.5)
    u0r = torch.where(two, torch.where(u0 < 0.5, u0 * 2.0, (u0 - 0.5) * 2.0), u0)
    u0r = torch.clamp(u0r, max=1.0 - 1e-7)
    w_local = warps.sample_cosine_hemisphere(torch.stack([u0r, u_dir[..., 1]], dim=-1))
    w_local = torch.where(flipside[..., None],
                          w_local * torch.tensor([1.0, 1.0, -1.0], device=w_local.device),
                          w_local)
    pdf_dir_a = warps.cosine_hemisphere_pdf(torch.abs(w_local[..., 2]))
    pdf_dir_a = torch.where(two, pdf_dir_a / 2.0, pdf_dir_a)
    fx, fy, fz = vm.frame_from_z(ng_a)
    w_a = vm.from_local(fx, fy, fz, w_local)
    Le_a = torch.where(((w_local[..., 2] > 0.0) | two)[..., None], em, 0.0)

    # the other types' directions: distant -lt_direction, uniform infinite a
    # uniform sphere direction, spot a uniform cone about its axis
    w_dist = -scene.lt_direction[li]
    w_unif = warps.sample_uniform_sphere(u_dir)
    cos_end = scene.lt_cos_end[li]
    cos_t = (1.0 - u_dir[..., 0]) + u_dir[..., 0] * cos_end
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * PI * u_dir[..., 1]
    ax_x, ax_y, ax_z = vm.frame_from_z(scene.lt_direction[li])
    w_spot = (ax_x * (sin_t * torch.cos(phi))[..., None]
              + ax_y * (sin_t * torch.sin(phi))[..., None]
              + ax_z * cos_t[..., None])
    pdf_cone = 1.0 / (2.0 * PI * torch.clamp(1.0 - cos_end, min=1e-9))
    Le_spot = em * smoothstep(cos_t, cos_end, scene.lt_cos_start[li])[..., None]
    w = torch.where(is_area[..., None], w_a, torch.where(
        is_distant[..., None], w_dist, torch.where(is_spot[..., None], w_spot, w_unif)))

    # origins: the shape point, the spot position, or the bounding disk
    dx, dy, _ = vm.frame_from_z(w)
    cd = warps.sample_uniform_disk_concentric(u_pos)
    p_disk = (scene.scene_center[None, :] + radius * (-w)
              + radius * (dx * cd[..., 0:1] + dy * cd[..., 1:2]))
    p = torch.where(is_area[..., None], p_a,
                    torch.where(is_spot[..., None], scene.lt_position[li], p_disk))
    ng = torch.where(is_area[..., None], ng_a, w)
    Le = torch.where(is_area[..., None], Le_a, torch.where(is_spot[..., None], Le_spot, em))
    pdf_pos = torch.where(is_area, 1.0 / torch.clamp(area, min=1e-12),
                          torch.where(is_spot, 1.0, _disk_pdf(scene)))
    pdf_dir = torch.where(is_area, pdf_dir_a, torch.where(
        is_distant, 1.0, torch.where(is_uniform, warps.UNIFORM_SPHERE_PDF, pdf_cone)))
    valid = (light_idx >= 0) & (pdf_dir > 0.0) & torch.where(
        is_area, shape_ok & (pdf_dir_a > 0.0), True)
    return Le, p, ng, w, pdf_pos, pdf_dir, valid


def pdf_le(scene, light_idx, ng, w):
    """(pdf_pos (R,), pdf_dir (R,)) of light light_idx emitting w from a
    point with normal ng (reference pdf_le: cosine hemisphere for area
    lights; the bounding-disk density for distant and infinite lights; delta
    quantities 0)."""
    li = torch.clamp(light_idx, min=0).long()
    ltype = scene.lt_type[li]
    is_area = ltype == bd.LIGHT_AREA
    is_distant = ltype == bd.LIGHT_DISTANT
    is_uniform = ltype == bd.LIGHT_UNIFORM_INFINITE
    is_spot = ltype == bd.LIGHT_SPOT
    _, _, area, _ = _area_shape_sample(scene, light_idx,
                                       torch.full(ng.shape[:-1] + (2,), 0.5, device=ng.device))
    cosw = vm.dot(ng, w)
    pdf_dir_a = torch.where(scene.lt_twosided[li],
                            warps.cosine_hemisphere_pdf(torch.abs(cosw)) / 2.0,
                            warps.cosine_hemisphere_pdf(torch.clamp(cosw, min=0.0)))
    cos_end = scene.lt_cos_end[li]
    pdf_cone = torch.where(vm.dot(scene.lt_direction[li], w) >= cos_end,
                           1.0 / (2.0 * PI * torch.clamp(1.0 - cos_end, min=1e-9)), 0.0)
    pdf_pos = torch.where(is_area, 1.0 / torch.clamp(area, min=1e-12),
                          torch.where(is_spot, 0.0, _disk_pdf(scene)))
    pdf_dir = torch.where(is_area, pdf_dir_a, torch.where(
        is_distant, 0.0, torch.where(is_uniform, warps.UNIFORM_SPHERE_PDF, pdf_cone)))
    return pdf_pos, pdf_dir
