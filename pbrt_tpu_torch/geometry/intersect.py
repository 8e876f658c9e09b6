"""Ray-primitive intersection (counterpart of pbrt_tpu/geometry/
intersect.py; reference shapes/triangle.cu:213-323, sphere.cu, disk.cu).

The watertight triangle test (`ray_shear`, `watertight_core`,
`intersect_tri_lanes`, `intersect_tri_block`) is the plain version of the
arithmetic that the BVH kernel (csrc/bvh_traverse.cu) inlines per leaf
triangle, and the refit against the winning triangle after traversal.

The dense sweeps over every primitive of a small scene, K3
(`intersect_tris_dense`, `occluded_tris_dense`) and K4
(`intersect_spheres_dense`, `occluded_spheres_dense`,
`intersect_disks_dense`), launch csrc/dense_intersect.cu on CUDA tensors
and run their plain versions (`*_plain`) on CPU tensors. Contract, as in
the JAX package: closest hit (t, index, ...), index -1 and t = INFINITY on
a miss, the lowest index winning ties as argmin does; p and n are 0 on a
miss. The any-hit sphere sweep answers the closest hit's `index >= 0`, which
is what the JAX package's `occluded` computes from it. The plain quadric
versions spell sums of three products as (x + y) + z, the order the kernel
uses, so on the card the two agree but for atan2 in the phi clip.
"""
import ctypes
from typing import NamedTuple, Optional

import torch

from pbrt_tpu_torch.utils.math import INFINITY, PI, clamp_mag, gamma, safe_sqrt


class TriHit(NamedTuple):
    t: torch.Tensor      # (R,) hit distance (INFINITY on a miss)
    prim: torch.Tensor   # (R,) int64 leaf-order triangle index (-1 on a miss)
    b: torch.Tensor      # (R, 3) barycentrics
    inst: torch.Tensor = None  # (R,) int64 instance of a two-level hit (-1 static)


def permute_by_kz(v, kz):
    """Cyclic permutation (v[kz+1], v[kz+2], v[kz]) of (..., 3) -> 3 tensors."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    is0 = kz == 0
    is1 = kz == 1
    px = torch.where(is0, y, torch.where(is1, z, x))
    py = torch.where(is0, z, torch.where(is1, x, y))
    pz = torch.where(is0, x, torch.where(is1, y, z))
    return px, py, pz


def ray_shear(d):
    """Per-ray permutation axis kz and shear constants (sx, sy, sz) so that
    |d_z| is the largest component after permuting (triangle.cu:220-247)."""
    kz = torch.argmax(torch.abs(d), dim=-1)
    dx, dy, dz = permute_by_kz(d, kz)
    dz_safe = clamp_mag(dz, 1e-12)
    return kz, -dx / dz_safe, -dy / dz_safe, 1.0 / dz_safe


def watertight_core(a, b, c, sx, sy, sz, t_max):
    """Watertight test on translated+permuted vertices, each a tuple of 3
    tensors; shear constants broadcast against them. -> (t, (b0, b1, b2), hit)."""
    ax = a[0] + sx * a[2]
    ay = a[1] + sy * a[2]
    bx = b[0] + sx * b[2]
    by = b[1] + sy * b[2]
    cx = c[0] + sx * c[2]
    cy = c[1] + sy * c[2]

    e0 = cx * by - cy * bx
    e1 = ax * cy - ay * cx
    e2 = bx * ay - by * ax

    hit = ~(((e0 < 0) | (e1 < 0) | (e2 < 0)) & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    hit &= det != 0.0

    az = sz * a[2]
    bz = sz * b[2]
    cz = sz * c[2]
    t_scaled = e0 * az + e1 * bz + e2 * cz
    hit &= torch.where(
        det < 0,
        (t_scaled < 0) & (t_scaled > t_max * det),
        (t_scaled > 0) & (t_scaled < t_max * det),
    )

    max_e = torch.maximum(torch.maximum(torch.abs(e0), torch.abs(e1)), torch.abs(e2))
    inv_det = 1.0 / clamp_mag(det, 1e-8 * max_e + 1e-30)
    t = t_scaled * inv_det

    # conservative t error bound (reference triangle.cu:299-320)
    max_z = torch.maximum(torch.maximum(torch.abs(az), torch.abs(bz)), torch.abs(cz))
    max_x = torch.maximum(torch.maximum(torch.abs(ax), torch.abs(bx)), torch.abs(cx))
    max_y = torch.maximum(torch.maximum(torch.abs(ay), torch.abs(by)), torch.abs(cy))
    delta_z = gamma(3) * max_z
    delta_x = gamma(5) * (max_x + max_z)
    delta_y = gamma(5) * (max_y + max_z)
    delta_e = 2 * (gamma(2) * max_x * max_y + delta_y * max_x + delta_x * max_y)
    delta_t = 3 * (
        gamma(3) * max_e * max_z + delta_e * max_z + delta_z * max_e
    ) * torch.abs(inv_det)
    hit &= t > delta_t
    return t, (e0 * inv_det, e1 * inv_det, e2 * inv_det), hit


def intersect_tri_lanes(o, d, t_max, p0, p1, p2):
    """Ray i against triangle i: o, d, p0, p1, p2 (R, 3); t_max (R,).
    -> (t (R,), bary (R, 3), hit (R,))."""
    kz, sx, sy, sz = ray_shear(d)

    def prep(pv):
        return permute_by_kz(pv - o, kz)

    t, bary, hit = watertight_core(prep(p0), prep(p1), prep(p2), sx, sy, sz, t_max)
    return t, torch.stack(bary, dim=-1), hit


def intersect_tri_block(o, shear, t_max, p0, p1, p2):
    """Every ray against every triangle of a block: o (R, 3), shear from
    `ray_shear`, t_max (R,), p0/p1/p2 (T, 3). -> (t (R, T), hit (R, T))."""
    kz, sx, sy, sz = shear

    def prep(pv):
        return permute_by_kz(pv[None, :, :] - o[:, None, :], kz[:, None])

    t, _, hit = watertight_core(
        prep(p0), prep(p1), prep(p2),
        sx[:, None], sy[:, None], sz[:, None], t_max[:, None],
    )
    return t, hit


# ---------------------------------------------------------- dense sweeps (K3/K4)

class SphereSoA(NamedTuple):
    """Spheres: center (S, 3), radius (S,). The clip fields (object-frame
    rotation (S, 3, 3), z window, phimax) make PARTIAL spheres (reference
    shapes/sphere.cu:15-26); None means full spheres and no clip code.
    `table` is the kernel's packed row table (`sphere_table`), which the
    CUDA wrapper needs and the plain version ignores."""

    center: torch.Tensor
    radius: torch.Tensor
    rot: Optional[torch.Tensor] = None
    zmin: Optional[torch.Tensor] = None
    zmax: Optional[torch.Tensor] = None
    phimax: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None


class DiskSoA(NamedTuple):
    """Disks: center (D, 3), unit normal (D, 3), radius and inner radius
    (D,) in render space (reference shapes/disk.{h,cu}). The in-plane frame
    and phimax make partial disks; None means full disks. `table` as for
    SphereSoA (`disk_table`)."""

    center: torch.Tensor
    normal: torch.Tensor
    radius: torch.Tensor
    inner: torch.Tensor
    xaxis: Optional[torch.Tensor] = None
    yaxis: Optional[torch.Tensor] = None
    phimax: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None


# row widths of the kernel tables (csrc/dense_intersect.cu SPH_W, DSK_W)
SPH_W, DSK_W = 16, 15


def _pack(cols, n):
    return torch.cat([c.reshape(n, -1).to(torch.float32) for c in cols], dim=1).contiguous()


def sphere_table(center, radius, rot, zmin, zmax, phimax):
    """(S, 16) float32 rows [center radius rot zmin zmax phimax] of the
    dense sphere kernel, packed once per scene (`Scene.sph_table`)."""
    return _pack((center, radius, rot, zmin, zmax, phimax), center.shape[0])


def disk_table(center, normal, radius, inner, xaxis, yaxis, phimax):
    """(D, 15) float32 rows [center normal radius inner xaxis yaxis phimax]
    of the dense disk kernel, packed once per scene (`Scene.dsk_table`)."""
    return _pack((center, normal, radius, inner, xaxis, yaxis, phimax), center.shape[0])


def with_table(q):
    """A SphereSoA or DiskSoA with its kernel table packed. Full quadrics
    fill the clip columns with placeholders: the kernel reads them only in
    its partial variant."""
    if isinstance(q, SphereSoA):
        if q.rot is None:
            S = q.center.shape[0]
            eye = torch.eye(3, device=q.center.device).expand(S, 3, 3)
            return q._replace(table=sphere_table(q.center, q.radius, eye, q.radius,
                                                 q.radius, q.radius))
        return q._replace(table=sphere_table(q.center, q.radius, q.rot, q.zmin, q.zmax,
                                             q.phimax))
    if q.xaxis is None:
        return q._replace(table=disk_table(q.center, q.normal, q.radius, q.inner, q.normal,
                                           q.normal, q.radius))
    return q._replace(table=disk_table(q.center, q.normal, q.radius, q.inner, q.xaxis,
                                       q.yaxis, q.phimax))


# launches of the dense kernels (plain ints, added to where they launch)
launches = {"dense_tri_closest": 0, "dense_tri_any": 0, "dense_spheres": 0,
            "dense_spheres_any": 0, "dense_disks": 0}


def _dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2 over (..., 3) tensors (the kernel's order)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _phi(y, x):
    phi = torch.atan2(y, x)
    return torch.where(phi < 0.0, phi + 2.0 * PI, phi)


def _closest(t, ok):
    """Row argmin of the candidate t (R, N) -> (t_best, index or -1)."""
    t = torch.where(ok, t, INFINITY)
    best = torch.argmin(t, dim=-1)
    t_best = torch.gather(t, 1, best[:, None])[:, 0]
    found = t_best < INFINITY
    return torch.where(found, t_best, INFINITY), torch.where(found, best, -1)


def intersect_tris_dense_plain(o, d, t_max, p0, p1, p2) -> TriHit:
    """K3 plain version: every ray against every triangle (p0/p1/p2 (T, 3))
    in one block, row argmin; barycentrics refit against the winner (the
    same operations, so the same values as the block's)."""
    t, hit = intersect_tri_block(o, ray_shear(d), t_max, p0, p1, p2)
    t_best, prim = _closest(t, hit)
    pc = prim.clamp(min=0)
    _, bary, _ = intersect_tri_lanes(o, d, t_max, p0[pc], p1[pc], p2[pc])
    return TriHit(t=t_best, prim=prim, b=torch.where((prim >= 0)[:, None], bary, 0.0))


def occluded_tris_dense_plain(o, d, t_max, p0, p1, p2):
    """K3 any-hit plain version: True where some triangle blocks (R,)."""
    _, hit = intersect_tri_block(o, ray_shear(d), t_max, p0, p1, p2)
    return hit.any(dim=1)


def _sphere_candidates(o, d, t_max, sph: SphereSoA):
    """(R, S) candidate t and ok of the stable quadratic, with the z/phi
    window on the nearest passing root for partial spheres."""
    oc = o[:, None, :] - sph.center[None, :, :]
    dd = d[:, None, :]
    a = _dot3(dd, dd)
    b = 2.0 * _dot3(oc, dd)
    c = _dot3(oc, oc) - sph.radius * sph.radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = safe_sqrt(disc)
    q = -0.5 * (b + torch.where(b < 0, -sq, sq))
    t0 = q / clamp_mag(a, 1e-12)
    t1 = c / clamp_mag(q, 1e-12)
    tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
    eps = 1e-3  # min-t epsilon in scene units; callers offset origins
    if sph.rot is None:
        t = torch.where(tn > eps, tn, tf)
    else:
        def passes(t):
            rel = (o[:, None, :] + t[..., None] * dd) - sph.center[None, :, :]
            rot = sph.rot[None]                     # local_i = sum_j rot[j, i] rel_j
            lx, ly, lz = (rel[..., 0] * rot[..., 0, i] + rel[..., 1] * rot[..., 1, i]
                          + rel[..., 2] * rot[..., 2, i] for i in range(3))
            zeps = 1e-4 * sph.radius
            return (lz >= sph.zmin - zeps) & (lz <= sph.zmax + zeps) & (_phi(ly, lx) <= sph.phimax)

        ok_n = (tn > eps) & passes(tn)
        ok_f = (tf > eps) & passes(tf)
        t = torch.where(ok_n, tn, tf)
        ok = ok & (ok_n | ok_f)
    return t, ok & (t > eps) & (t < t_max[:, None])


def intersect_spheres_dense_plain(o, d, t_max, sph: SphereSoA):
    """K4 plain version, spheres -> (t, idx, p, n); the hit point is
    reprojected onto the sphere (reference sphere.cu refinement)."""
    t_best, idx = _closest(*_sphere_candidates(o, d, t_max, sph))
    found = idx >= 0
    best = idx.clamp(min=0)
    center, radius = sph.center[best], sph.radius[best]
    rel = (o + torch.where(found, t_best, 1.0)[:, None] * d) - center
    p = center + rel * (radius / torch.clamp(safe_sqrt(_dot3(rel, rel)), min=1e-12))[:, None]
    u = p - center
    n = u / torch.clamp(safe_sqrt(_dot3(u, u)), min=1e-12)[:, None]
    f3 = found[:, None]
    return t_best, idx, torch.where(f3, p, 0.0), torch.where(f3, n, 0.0)


def occluded_spheres_dense_plain(o, d, t_max, sph: SphereSoA):
    """K4 any-hit plain version: True where some sphere has a passing root
    in (EPS, t_max) (R,), the closest hit's `idx >= 0` (JAX's `occluded`,
    pbrt_tpu/accel/dispatch.py:321-322)."""
    return intersect_spheres_dense_plain(o, d, t_max, sph)[1] >= 0


def fma_f32(a, b, c):
    """a * b + c of float32 tensors rounded once to float32, as CUDA's
    __fmaf_rn: the float64 product is exact, and where the float64 sum lies
    exactly halfway between two floats its own rounding error (TwoSum)
    decides the side."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    f = s.float()
    r = s - f.double()
    nb = torch.nextafter(f, torch.where(r > 0, torch.inf, -torch.inf).float())
    half = (r != 0) & ((nb.double() - f.double()).abs() == 2.0 * r.abs())
    return torch.where(half & (e * r > 0), nb, f)


def intersect_disks_dense_plain(o, d, t_max, dsk: DiskSoA):
    """K4 plain version, disks: plane hit and annulus test (disk.cu
    intersect), phi window for partial disks -> (t, idx, p, n)."""
    nrm = dsk.normal[None]
    denom = _dot3(d[:, None, :], nrm)
    dist = _dot3(o[:, None, :] - dsk.center[None], nrm)
    t = -dist / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    rel = (o[:, None, :] + t[..., None] * d[:, None, :]) - dsk.center[None]
    r2 = _dot3(rel, rel)
    ok = ((torch.abs(denom) > 1e-9) & (t > 1e-3) & (t < t_max[:, None])
          & (r2 <= dsk.radius * dsk.radius) & (r2 >= dsk.inner * dsk.inner))
    if dsk.xaxis is not None:
        ok = ok & (_phi(_dot3(rel, dsk.yaxis[None]), _dot3(rel, dsk.xaxis[None])) <= dsk.phimax)
    t_best, idx = _closest(t, ok)
    found = (idx >= 0)[:, None]
    # the hit point rounds once, as a fused multiply-add: XLA:CPU contracts
    # the JAX package's `o + t * d` here (intersect.py:389), and the kernel
    # computes it with __fmaf_rn
    p = fma_f32(torch.where(found[:, 0], t_best, 0.0)[:, None], d, o)
    return (t_best, idx, torch.where(found, p, 0.0),
            torch.where(found, dsk.normal[idx.clamp(min=0)], 0.0))


def _dense_lib():
    """The built dense-sweep library, its C functions declared once."""
    from pbrt_tpu_torch import kernels

    lib = kernels.load("dense_intersect")
    if not hasattr(lib, "declared"):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pbrt_dense_tris.argtypes = [P, P, P, I, P, P, P, I, P, P, P, I, I, I, I, P]
        lib.pbrt_dense_spheres.argtypes = [P, I, P, P, P, I, P, P, P, P, I, I, I, P]
        lib.pbrt_dense_disks.argtypes = [P, I, P, P, P, I, P, P, P, P, I, I, P]
        for fn in (lib.pbrt_dense_tris, lib.pbrt_dense_spheres, lib.pbrt_dense_disks):
            fn.restype = I
        lib.declared = True
    return lib


# bytes of K3's three staged copies (csrc/dense_intersect.cu SMEM_MAX)
DENSE_SMEM_MAX = 46 * 1024


def dense_tri_group(n_rays, n_tris):
    """G, the lanes of K3's group that share one ray (lane j tests
    triangles j, j + G, ...): on a small wave (not `dense_wide`) the largest
    power of two up to 8 and up to the triangle count that keeps the
    launch under 2^17 lanes (n_rays G), so that the wave reaches every SM;
    on a wide wave 1. At cornell's 2^20 rays G = 1; at caustic-glass-mlt's
    8,192 rays and 4 triangles G = 4."""
    g = 1
    while g < 8 and 2 * g <= n_tris and n_rays * 2 * g < 1 << 17:
        g *= 2
    return g


def dense_tri_stride(n_tris):
    """Floats between K3's three staged copies of the table (one a kz):
    12 a row (three 16-byte loads), padded to 4 (mod 32) so that a warp's
    lanes reading one row of the three copies meet three disjoint 4-bank
    windows."""
    s = 12 * n_tris
    return s + (4 - s) % 32


# the most triangles K3's wide mode stages (three copies in DENSE_SMEM_MAX;
# the small mode reads the rows through the read-only path and takes any
# count); the BVH route takes scenes of 64 and more (accel/bvh.py
# MIN_TRIS_FOR_BVH)
DENSE_MAX_TRIS = max(n for n in range(1024) if 12 * dense_tri_stride(n) <= DENSE_SMEM_MAX)


def dense_wide(n_rays):
    """The mode of K3, K4 and K4a (csrc/dense_intersect.cu WIDE) for a
    wave of n_rays: from 2^19 rays the table is staged in shared memory
    (K3: three pre-permuted copies behind one block barrier, each block
    sweeping many rays, a warp's live rays queued and swept 32 at a time;
    K4: blocks striding over the rays) and a lane reads its ray only when
    its t_max is > 0 (a BDPT wave's shadow rays and its later walk steps
    are mostly masked lanes); on a smaller wave the rows are read through
    the read-only path with no barrier and the ray's loads issued with
    t_max's. (On an NVIDIA H100 80GB HBM3 at 700 W, K3's wide mode was 14 %
    faster at caustic-glass BDPT's masked 2^20-ray walk launches and 3x at
    its shadow wave, and 3-8 % slower at caustic-glass-mlt's 286,720 shadow
    rays; K4's wide mode 4 % slower than its small one at an all-live 2^20
    launch, 4 % faster over a BDPT wave's 15 walk launches and 16 % at its
    shadow wave.)"""
    return n_rays >= 1 << 19


def _check_rays(what, o, d, t_max):
    R, dev = o.shape[0], o.device
    for name, x, shape in (("o", o, (R, 3)), ("d", d, (R, 3)), ("t_max", t_max, (R,))):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 {shape} tensor "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not o.is_cuda:
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {dev}")
    return R, dev


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def dense_tris_cuda(o, d, t_max, p0, p1, p2, any_hit=False):
    """Launch K3 on the current stream and count the launch. Closest hit ->
    TriHit (prim int64, -1 on a miss); any hit -> (R,) bool. Its group size
    G is `dense_tri_group`'s; the any-hit sweep runs G = 1 with its early
    exit."""
    from pbrt_tpu_torch import kernels

    R, dev = _check_rays("dense triangles", o, d, t_max)
    T = p0.shape[0]
    for name, x in (("p0", p0), ("p1", p1), ("p2", p2)):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != (T, 3) \
                or not x.is_contiguous():
            raise ValueError(f"dense triangles: {name} must be a contiguous float32 "
                             f"({T}, 3) tensor on {dev}")
    wide = dense_wide(R)
    if wide and T > DENSE_MAX_TRIS:
        raise ValueError(f"dense triangles: {T} triangles; the wide mode stages at most "
                         f"{DENSE_MAX_TRIS} (the BVH route takes more)")
    prim = torch.empty(R, dtype=torch.bool if any_hit else torch.int64, device=dev)
    t = torch.empty(0 if any_hit else R, dtype=torch.float32, device=dev)
    b = torch.empty((0 if any_hit else R, 3), dtype=torch.float32, device=dev)
    if R:
        group = 1 if any_hit else dense_tri_group(R, T)
        err = _dense_lib().pbrt_dense_tris(
            p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), T, o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), R, t.data_ptr(), prim.data_ptr(), b.data_ptr(), int(any_hit),
            group, dense_tri_stride(T), int(wide), _stream(dev))
        kernels.check(err, "dense_intersect (triangles)")
        launches["dense_tri_any" if any_hit else "dense_tri_closest"] += 1
    if any_hit:
        return prim
    return TriHit(t=t, prim=prim, b=b)


def _dense_quadrics_cuda(kind, q, width, partial, o, d, t_max, any_hit=False):
    from pbrt_tpu_torch import kernels

    n, table = q.center.shape[0], q.table
    if table is None:
        raise ValueError(f"dense {kind}: no packed table; pass the scene's or with_table(...)")
    if table.dtype != torch.float32 or tuple(table.shape) != (n, width) \
            or not table.is_contiguous():
        raise ValueError(f"dense {kind}: table must be a contiguous float32 ({n}, {width}) "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
    if n >= 1 << 30:
        raise ValueError(f"dense {kind}: {n} primitives")
    R, dev = _check_rays(f"dense {kind}", o, d, t_max)
    if table.device != dev:
        raise ValueError(f"dense {kind}: table on {table.device}, rays on {dev}")
    if kind == "spheres" and table.data_ptr() % 16:
        raise ValueError("dense spheres: the table's rows must be 16-byte aligned (read as "
                         "float4)")
    # the any-hit sweep writes only its bools
    idx = torch.empty(R, dtype=torch.bool if any_hit else torch.int64, device=dev)
    R_f = 0 if any_hit else R
    t = torch.empty(R_f, dtype=torch.float32, device=dev)
    p = torch.empty((R_f, 3), dtype=torch.float32, device=dev)
    nrm = torch.empty((R_f, 3), dtype=torch.float32, device=dev)
    if R:
        lib = _dense_lib()
        ptrs = (table.data_ptr(), n, o.data_ptr(), d.data_ptr(), t_max.data_ptr(), R,
                t.data_ptr(), idx.data_ptr(), p.data_ptr(), nrm.data_ptr(), int(partial),
                int(dense_wide(R)))
        if kind == "spheres":
            err = lib.pbrt_dense_spheres(*ptrs, int(any_hit), _stream(dev))
        else:
            err = lib.pbrt_dense_disks(*ptrs, _stream(dev))
        kernels.check(err, f"dense_intersect ({kind})")
        launches[f"dense_{kind}" + ("_any" if any_hit else "")] += 1
    return idx if any_hit else (t, idx, p, nrm)


def dense_spheres_cuda(o, d, t_max, sph: SphereSoA, any_hit=False):
    """Launch K4 (spheres) on the current stream over `sph.table` and count
    the launch; the clip code runs when the SoA has its clip fields. Closest
    hit -> (t, idx int64, p, n); any hit -> (R,) bool, counted as
    `dense_spheres_any`."""
    return _dense_quadrics_cuda("spheres", sph, SPH_W, sph.rot is not None, o, d, t_max,
                                any_hit)


def dense_disks_cuda(o, d, t_max, dsk: DiskSoA):
    """Launch K4 (disks) on the current stream over `dsk.table` and count
    the launch; the phi clip runs when the SoA has its in-plane frame."""
    return _dense_quadrics_cuda("disks", dsk, DSK_W, dsk.xaxis is not None, o, d, t_max)


def intersect_tris_dense(o, d, t_max, p0, p1, p2) -> TriHit:
    """Closest hit against all triangles (K3): the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if o.is_cuda:
        return dense_tris_cuda(o, d, t_max, p0, p1, p2)
    return intersect_tris_dense_plain(o, d, t_max, p0, p1, p2)


def occluded_tris_dense(o, d, t_max, p0, p1, p2):
    """Any-hit shadow query against all triangles (K3): True where blocked."""
    if o.is_cuda:
        return dense_tris_cuda(o, d, t_max, p0, p1, p2, any_hit=True)
    return occluded_tris_dense_plain(o, d, t_max, p0, p1, p2)


def intersect_spheres_dense(o, d, t_max, sph: SphereSoA):
    """Closest hit against all spheres (K4) -> (t, idx, p, n)."""
    if o.is_cuda:
        return dense_spheres_cuda(o, d, t_max, sph)
    return intersect_spheres_dense_plain(o, d, t_max, sph)


def occluded_spheres_dense(o, d, t_max, sph: SphereSoA):
    """Any-hit shadow query against all spheres (K4): True where blocked."""
    if o.is_cuda:
        return dense_spheres_cuda(o, d, t_max, sph, any_hit=True)
    return occluded_spheres_dense_plain(o, d, t_max, sph)


def intersect_disks_dense(o, d, t_max, dsk: DiskSoA):
    """Closest hit against all disks (K4) -> (t, idx, p, n)."""
    if o.is_cuda:
        return dense_disks_cuda(o, d, t_max, dsk)
    return intersect_disks_dense_plain(o, d, t_max, dsk)
