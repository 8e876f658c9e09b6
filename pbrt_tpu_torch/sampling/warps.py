"""Sampling warps (counterpart of the parts of pbrt_tpu/sampling/warps.py
that the path integrator uses; reference util/sampling.h/.cu)."""
import torch

from pbrt_tpu_torch.utils.math import INV_PI, PI, PI_OVER_2, PI_OVER_4, safe_sqrt
from pbrt_tpu_torch.geometry import vecmath as vm


def sample_uniform_disk_concentric(u):
    """Shirley–Chiu concentric disk warp."""
    u_offset = 2.0 * u - 1.0
    ux, uy = u_offset[..., 0], u_offset[..., 1]
    zero = (ux == 0.0) & (uy == 0.0)
    cond = torch.abs(ux) > torch.abs(uy)
    r = torch.where(cond, ux, uy)
    theta = torch.where(
        cond,
        PI_OVER_4 * torch.where(ux != 0, uy / torch.where(ux == 0, 1.0, ux), 0.0),
        PI_OVER_2 - PI_OVER_4 * torch.where(uy != 0, ux / torch.where(uy == 0, 1.0, uy), 0.0),
    )
    p = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], 0.0, p)


def sample_uniform_disk_polar(u):
    r = torch.sqrt(torch.clamp(u[..., 0], min=1e-12))
    theta = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_cosine_hemisphere(u):
    """Cosine-weighted hemisphere about +z; pdf = cos(theta)/pi."""
    d = sample_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return torch.cat([d, z[..., None]], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def sample_uniform_sphere(u):
    """Uniform direction on the unit sphere; pdf UNIFORM_SPHERE_PDF."""
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


UNIFORM_SPHERE_PDF = 1.0 / (4.0 * PI)


def sample_exponential(u, a):
    """t with density a exp(-a t) (reference sampling.h)."""
    return -torch.log(torch.clamp(1.0 - u, min=1e-38)) / a


def henyey_greenstein(cos_theta, g):
    """Henyey-Greenstein phase function value (reference sampling.h)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return UNIFORM_SPHERE_PDF * (1.0 - g * g) / (denom * safe_sqrt(denom))


def sample_henyey_greenstein(wo, g, u):
    """Sample the HG phase function about wo (reference sampling.cu:7-40)
    -> (wi, pdf)."""
    g = torch.where(torch.abs(g) < 1e-3, torch.where(g < 0, -1e-3, 1e-3), g)
    sqr_term = (1.0 - g * g) / (1.0 + g - 2.0 * g * u[..., 0])
    cos_theta = -(1.0 + g * g - sqr_term * sqr_term) / (2.0 * g)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * PI * u[..., 1]
    x, y, z = vm.frame_from_z(wo)
    wi = vm.from_local(x, y, z, vm.spherical_direction(sin_theta, cos_theta, phi))
    return wi, henyey_greenstein(cos_theta, g)


def sample_uniform_triangle(u):
    """Barycentric (b0, b1, b2) uniform on a triangle (sqrt-free form)."""
    u0, u1 = u[..., 0], u[..., 1]
    flip = u0 < u1
    b0 = torch.where(flip, u0 / 2.0, u0 - u1 / 2.0)
    b1 = torch.where(flip, u1 - b0, u1 / 2.0)
    return torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1)


def sample_spherical_triangle(v0, v1, v2, p, u):
    """Direction towards the spherical projection of (v0,v1,v2) seen from
    p, uniform in solid angle (Arvo; reference util/sampling.h:167).
    Returns (barycentrics (..., 3), pdf = 1/solid_angle)."""
    a = vm.normalize(v0 - p)
    b = vm.normalize(v1 - p)
    c = vm.normalize(v2 - p)
    n_ab = vm.cross(a, b)
    n_bc = vm.cross(b, c)
    n_ca = vm.cross(c, a)
    degenerate = (
        (vm.length_squared(n_ab) < 1e-18)
        | (vm.length_squared(n_bc) < 1e-18)
        | (vm.length_squared(n_ca) < 1e-18)
    )
    n_ab_n = vm.normalize(n_ab)
    n_bc_n = vm.normalize(n_bc)
    n_ca_n = vm.normalize(n_ca)
    alpha = vm.angle_between(n_ab_n, -n_ca_n)
    beta = vm.angle_between(n_bc_n, -n_ab_n)
    gamma = vm.angle_between(n_ca_n, -n_bc_n)

    A_pi = alpha + beta + gamma
    Ap_pi = (1.0 - u[..., 0]) * PI + u[..., 0] * A_pi
    A = A_pi - PI
    pdf = torch.where(A <= 0.0, 0.0, 1.0 / torch.clamp(A, min=1e-12))

    cos_alpha = torch.cos(alpha)
    sin_alpha = torch.sin(alpha)
    sin_phi = torch.sin(Ap_pi) * cos_alpha - torch.cos(Ap_pi) * sin_alpha
    cos_phi = torch.cos(Ap_pi) * cos_alpha + torch.sin(Ap_pi) * sin_alpha
    k1 = cos_phi + cos_alpha
    k2 = sin_phi - sin_alpha * vm.dot(a, b)
    denom = (k2 * sin_phi + k1 * cos_phi) * sin_alpha
    cos_bp = (k2 + (k2 * cos_phi - k1 * sin_phi) * cos_alpha) / torch.where(
        torch.abs(denom) < 1e-20, 1.0, denom
    )
    cos_bp = torch.clamp(cos_bp, -1.0, 1.0)
    sin_bp = safe_sqrt(1.0 - cos_bp * cos_bp)
    cp = cos_bp[..., None] * a + sin_bp[..., None] * vm.normalize(vm.gram_schmidt(c, a))
    cos_theta = 1.0 - u[..., 1] * (1.0 - vm.dot(cp, b))
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    w = cos_theta[..., None] * b + sin_theta[..., None] * vm.normalize(vm.gram_schmidt(cp, b))
    e1 = v1 - v0
    e2 = v2 - v0
    s1 = vm.cross(w, e2)
    div = vm.dot(s1, e1)
    div_safe = torch.where(torch.abs(div) < 1e-12, 1.0, div)
    s = p - v0
    b1 = torch.clamp(vm.dot(s, s1) / div_safe, 0.0, 1.0)
    b2 = torch.clamp(vm.dot(w, vm.cross(s, e1)) / div_safe, 0.0, 1.0)
    over = (b1 + b2) > 1.0
    norm = torch.where(over, b1 + b2, 1.0)
    b1 = torch.where(over, b1 / norm, b1)
    b2 = torch.where(over, b2 / norm, b2)
    bary = torch.stack([1.0 - b1 - b2, b1, b2], dim=-1)
    bad = degenerate | (torch.abs(div) < 1e-12)
    bary = torch.where(bad[..., None], 1.0 / 3.0, bary)
    pdf = torch.where(bad, 0.0, pdf)
    return bary, pdf


def sample_linear(u, a, b):
    """x in [0,1] with density proportional to lerp(x, a, b)."""
    denom = a + torch.sqrt(torch.clamp((1.0 - u) * a * a + u * b * b, min=1e-24))
    x = torch.where(denom > 0.0, u * (a + b) / torch.clamp(denom, min=1e-12), u)
    return torch.clamp(x, max=0.99999994)


def sample_bilinear(u, w):
    """(x, y) in [0,1]^2 with bilinear corner weights w (..., 4) ordered
    (w00, w10, w01, w11) (pbrt SampleBilinear)."""
    y = sample_linear(u[..., 1], w[..., 0] + w[..., 1], w[..., 2] + w[..., 3])
    x = sample_linear(
        u[..., 0],
        (1.0 - y) * w[..., 0] + y * w[..., 2],
        (1.0 - y) * w[..., 1] + y * w[..., 3],
    )
    return torch.stack([x, y], dim=-1)


def bilinear_pdf(p, w):
    x, y = p[..., 0], p[..., 1]
    s = torch.sum(w, dim=-1)
    interp = (
        (1 - x) * (1 - y) * w[..., 0]
        + x * (1 - y) * w[..., 1]
        + (1 - x) * y * w[..., 2]
        + x * y * w[..., 3]
    )
    inside = (x >= 0) & (x <= 1) & (y >= 0) & (y <= 1)
    return torch.where(inside, torch.where(s == 0.0, 1.0, 4.0 * interp / torch.clamp(s, min=1e-12)), 0.0)


def invert_spherical_triangle_sample(v0, v1, v2, p, w):
    """Direction w -> the (u0, u1) that Arvo sampling maps to it (reference
    util/sampling.cu:42-103)."""
    a = vm.normalize(v0 - p)
    b = vm.normalize(v1 - p)
    c = vm.normalize(v2 - p)
    n_ab = vm.cross(a, b)
    n_bc = vm.cross(b, c)
    n_ca = vm.cross(c, a)
    bad = (
        (vm.length_squared(n_ab) < 1e-18)
        | (vm.length_squared(n_bc) < 1e-18)
        | (vm.length_squared(n_ca) < 1e-18)
    )
    n_ab_n = vm.normalize(n_ab)
    n_bc_n = vm.normalize(n_bc)
    n_ca_n = vm.normalize(n_ca)
    alpha = vm.angle_between(n_ab_n, -n_ca_n)
    beta = vm.angle_between(n_bc_n, -n_ab_n)
    gamma = vm.angle_between(n_ca_n, -n_bc_n)

    cp = vm.cross(vm.cross(b, w), vm.cross(c, a))
    cp = vm.normalize(torch.where((vm.length_squared(cp) < 1e-18)[..., None], a, cp))
    cp = torch.where((vm.dot(cp, a + c) < 0.0)[..., None], -cp, cp)

    n_cpb = vm.cross(cp, b)
    n_acp = vm.cross(a, cp)
    degen2 = (vm.length_squared(n_cpb) < 1e-18) | (vm.length_squared(n_acp) < 1e-18)
    n_cpb_n = vm.normalize(torch.where(degen2[..., None], a, n_cpb))
    n_acp_n = vm.normalize(torch.where(degen2[..., None], b, n_acp))
    Ap = alpha + vm.angle_between(n_ab_n, n_cpb_n) + vm.angle_between(n_acp_n, -n_cpb_n) - PI
    A = alpha + beta + gamma - PI
    u0 = torch.where(
        vm.dot(a, cp) > 0.99999847691,
        0.0,
        torch.clamp(Ap / torch.clamp(A, min=1e-12), 0.0, 1.0),
    )
    u1 = torch.clamp(
        (1.0 - vm.dot(w, b)) / torch.clamp(1.0 - vm.dot(cp, b), min=1e-12), 0.0, 1.0
    )
    u = torch.stack([u0, u1], dim=-1)
    return torch.where((bad | degen2)[..., None], 0.5, u)
