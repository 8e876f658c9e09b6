"""Metropolis light transport in primary sample space (counterpart of
pbrt_tpu/integrators/mlt.py; reference integrators/mlt_path.cu,
integrators/mlt_bdpt.cu, samplers/mlt.h).

N_CHAINS Markov chains run side by side, one lane each. A chain's state is
a primary-sample vector x of D uniforms; the estimator re-runs from it
through the sampler kind "mlt" (sampling/samplers.py): dims 0-1 the film
position, 2 the wavelength, the rest the integrator's draws in order.
  - "mltpath": `eval_x`, the path integrator's `li`; one contribution a
    chain (C = 1).
  - "mlt" / "mltbdpt": `eval_x_bdpt`, the whole BDPT estimator `li_bdpt`;
    its camera sum and each t = 1 splat strategy are separate contributions
    (C = 1 + n_t1), and their summed luminance is the chain's target.
A frame: a bootstrap of n_bootstrap fresh vectors gives the mean luminance
b and, through an alias table over their luminances, the chains' initial
states; then n_passes = mutations_per_pixel * n_pix // n_chains passes of
mutate (K12m-a) -> evaluate -> accept and splat (K12m-b), splatting both
states with their expected weights; the splat film is scaled by
b * n_pix / (n_passes * n_chains).

Kernels (csrc/mlt.cu), each beside its plain version here; the wrappers
launch the kernel on CUDA tensors and run the plain version only on CPU
tensors:
  - K12m-a `mlt_mutate` (JAX `mutate`, mlt.py:53): Kelemen mutation, a large
    step (fresh uniforms) with probability P_LARGE, else a Gaussian
    perturbation of width SIGMA wrapped into [0, 1).
  - K12m-b `mlt_accept_splat` (JAX `_accept_and_splat`, mlt.py:106, C = 1,
    and `_accept_and_splat_multi`, :168, C > 1): the acceptance a, the
    expected-value splats of every contribution of both states and the
    sampling-density heatmap (contribution 0), then the accept draw and the
    state update in place.

Random numbers. jax.random is not ported: every uniform a chain draws comes
from PCG32 (sampling/rng.py; the same bits in torch and in the kernels),
one stream per (seed, purpose, index, chain), seeded as
from_seed(MurmurHash64A of the four u32 words):
  - purpose BOOTSTRAP, index = bootstrap round: the D uniforms of the
    chain's fresh vector, in dimension order;
  - purpose PICK, index 0: the one uniform of the chain's alias pick;
  - purpose MUTATE, index = pass: the large-step uniform, then for each
    dimension d in order its fresh uniform and its Gaussian uniform
    (1 + 2 D draws; `chain_uniforms`);
  - purpose ACCEPT, index = pass: the accept uniform.
So a render on the card and one on the CPU draw the same numbers; they part
only where float rounding in the evaluation flips an accept decision.
"""
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pbrt_tpu_torch.cameras import perspective
from pbrt_tpu_torch.distribution import distributions as dist
from pbrt_tpu_torch.film import film_kernel
from pbrt_tpu_torch.integrators import bdpt, path as path_integrator
from pbrt_tpu_torch.sampling import rng as prng, samplers
from pbrt_tpu_torch.spectral import colorspace, sampled
from pbrt_tpu_torch.utils.device import resolve_device

P_LARGE = 0.3     # large-step probability (mlt_path.cu:163)
SIGMA = 0.01      # small-step mutation size (mlt_path.cu:164)
N_CHAINS = 8192   # parallel Markov chains (mlt_path.cu:16)
# float32(SIGMA) * float32(sqrt 2), rounded to float32 as the JAX package's
# `sigma * jnp.sqrt(2.0)` is; csrc/mlt.cu spells the same bits
SIGMA_SQRT2 = float(np.float32(SIGMA) * np.sqrt(np.float32(2.0)))
ONE_MINUS = 1.0 - 1e-7   # the clip's upper end, 0.99999988 in float32
# erfinv's constants with a = 0.147, as float32 values
TWO_OVER_PI_A = float(np.float32(2.0 / (np.pi * 0.147)))
INV_A = float(np.float32(1.0) / np.float32(0.147))

BOOTSTRAP, PICK, MUTATE, ACCEPT = 1, 2, 3, 4   # stream purposes

# launches of the two kernels (plain ints, added to where they launch)
launches = {"mlt_mutate": 0, "mlt_accept_splat": 0}


class Chains(NamedTuple):
    """The chains' states (or a pass's proposals), C contributions each."""

    x: torch.Tensor     # (R, D) float32 primary samples
    pix: torch.Tensor   # (C, R) int32 pixel of each contribution
    rgb: torch.Tensor   # (C, R, 3) float32 sensor RGB of each contribution
    y: torch.Tensor     # (R,) float32 target: summed luminance, >= 0


# ------------------------------------------------------------ PCG32 streams


def chain_streams(seed, purpose, index, R, device):
    """The PCG32 streams of chains 0..R-1 for (seed, purpose, index) ->
    (state, inc), (R,) int64 each."""
    lanes = torch.arange(R, device=device)
    words = [torch.full_like(lanes, int(v) & prng.M32) for v in (seed, purpose, index)]
    r = prng.from_seed(prng.murmur64a_u32_words(words + [lanes]))
    return r.state, r.inc


def stream_uniforms(seed, purpose, index, R, n, device):
    """The first n uniforms of each chain's stream -> (R, n) float32."""
    state, inc = chain_streams(seed, purpose, index, R, device)
    out = torch.empty((R, n), device=device)
    for k in range(n):
        state, out[:, k] = prng.uniform_float(state, inc)
    return out


def chain_uniforms(seed, pass_idx, R, D, device="cpu"):
    """The draws of K12m-a in its order -> (u_large (R,), fresh (R, D),
    u (R, D)): the large-step uniform, then per dimension the fresh and the
    Gaussian uniform."""
    u = stream_uniforms(seed, MUTATE, pass_idx, R, 1 + 2 * D, device)
    return u[:, 0].contiguous(), u[:, 1::2].contiguous(), u[:, 2::2].contiguous()


def accept_uniforms(seed, pass_idx, R, device="cpu"):
    """The accept uniforms of K12m-b -> (R,) float32."""
    return stream_uniforms(seed, ACCEPT, pass_idx, R, 1, device)[:, 0]


# ------------------------------------------------------------- K12m-a


def _erfinv(x):
    """Winitzki's approximation (reference util/math.h erfinv), clipped as
    in the JAX package. Its ln(1 - x^2) / 0.147 is a product with the
    float32 reciprocal, as torch computes a division by a scalar on the
    card, so that the CPU, torch on the card and csrc/mlt.cu round alike
    (near x = 0 the outer square root cancels and amplifies an ulp)."""
    x = torch.clamp(x, -0.99999, 0.99999)
    ln1mx2 = torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=1e-30))
    term = TWO_OVER_PI_A + ln1mx2 / 2.0
    return torch.sign(x) * torch.sqrt(
        torch.sqrt(torch.clamp(term * term - ln1mx2 * INV_A, min=0.0)) - term)


def mutate_from_uniforms(x, u_large, fresh, u):
    """Plain version of K12m-a's arithmetic (JAX `mutate` given its
    uniforms): x (R, D); u_large (R,); fresh, u (R, D) -> x_prop (R, D)."""
    perturbed = x + SIGMA_SQRT2 * _erfinv(2.0 * u - 1.0)
    perturbed = perturbed - torch.floor(perturbed)
    out = torch.where((u_large < P_LARGE)[:, None], fresh, perturbed)
    return torch.clamp(out, 0.0, ONE_MINUS)


def _lib():
    from pbrt_tpu_torch import kernels

    lib = kernels.load("mlt")
    if not hasattr(lib, "declared"):
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.pbrt_mlt_mutate.argtypes = [P, P, P, I, I, U, U, P]
        lib.pbrt_mlt_mutate.restype = I
        lib.pbrt_mlt_accept_splat.argtypes = [P] * 11 + [I] * 4 + [U, U, P]
        lib.pbrt_mlt_accept_splat.restype = I
        lib.declared = True
    return lib


def _check(what, x, dtype, shape, dev):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != dev \
            or not x.is_contiguous():
        raise ValueError(f"mlt kernel: {what} must be a contiguous {dtype} {tuple(shape)} "
                         f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def mutate_cuda(x, seed, pass_idx, draws=None):
    """K12m-a on the card: x (R, D) float32 -> x_prop (R, D). draws, an
    (R, 1 + 2 D) float32 tensor, receives the chains' uniforms in
    chain_uniforms's order."""
    from pbrt_tpu_torch import kernels

    R, D = x.shape
    dev = x.device
    if not x.is_cuda or not 0 < R < 1 << 30:
        raise ValueError(f"mlt_mutate: needs 0 < R < 2^30 chains on a CUDA device, got {R} "
                         f"on {dev}")
    _check("x", x, torch.float32, (R, D), dev)
    if draws is not None:
        _check("draws", draws, torch.float32, (R, 1 + 2 * D), dev)
    out = torch.empty_like(x)
    err = _lib().pbrt_mlt_mutate(
        x.data_ptr(), out.data_ptr(), 0 if draws is None else draws.data_ptr(), R, D,
        int(seed) & prng.M32, int(pass_idx) & prng.M32,
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "mlt_mutate")
    launches["mlt_mutate"] += 1
    return out


def mutate(x, seed, pass_idx):
    """K12m-a: one Kelemen mutation of every chain with the draws of stream
    (seed, MUTATE, pass_idx) -> x_prop (R, D); the kernel on CUDA tensors,
    its plain version on CPU tensors."""
    if x.is_cuda:
        return mutate_cuda(x, seed, pass_idx)
    return mutate_from_uniforms(x, *chain_uniforms(seed, pass_idx, *x.shape, x.device))


# ------------------------------------------------------------- K12m-b


def accept_and_splat_from_uniforms(splat, heat, cur: Chains, prop: Chains, u_acc):
    """Plain version of K12m-b given the accept uniforms u_acc (R,): the
    expected-value splats of every contribution of both states into splat
    (n_pix, 3) and of contribution 0 into heat (n_pix,), then the accepted
    chains take the proposal; splat, heat and cur are updated in place.
    -> the acceptance a (R,)."""
    y_cur, y_prop = cur.y, prop.y
    a = torch.where(y_cur > 0, torch.clamp(y_prop / torch.clamp(y_cur, min=1e-12), max=1.0),
                    1.0)
    w_prop = torch.where(y_prop > 0, a / torch.clamp(y_prop, min=1e-12), 0.0)
    w_cur = torch.where(y_cur > 0, (1.0 - a) / torch.clamp(y_cur, min=1e-12), 0.0)
    splat.index_add_(0, prop.pix.reshape(-1).long(),
                     (prop.rgb * w_prop[None, :, None]).reshape(-1, 3))
    splat.index_add_(0, cur.pix.reshape(-1).long(), (cur.rgb * w_cur[None, :, None]).reshape(-1, 3))
    heat.index_add_(0, prop.pix[0].long(), torch.where(y_prop > 0, a, 0.0))
    heat.index_add_(0, cur.pix[0].long(), torch.where(y_cur > 0, 1.0 - a, 0.0))
    acc = u_acc < a
    cur.x.copy_(torch.where(acc[:, None], prop.x, cur.x))
    cur.pix.copy_(torch.where(acc[None, :], prop.pix, cur.pix))
    cur.rgb.copy_(torch.where(acc[None, :, None], prop.rgb, cur.rgb))
    cur.y.copy_(torch.where(acc, prop.y, cur.y))
    return a


def accept_and_splat_cuda(splat, heat, cur: Chains, prop: Chains, seed, pass_idx):
    """K12m-b on the card, one thread a chain; the accept uniform comes from
    stream (seed, ACCEPT, pass_idx). Same contract as
    accept_and_splat_from_uniforms; splat and heat sums are atomic, so their
    order (not their terms) differs from run to run."""
    from pbrt_tpu_torch import kernels

    R, D = cur.x.shape
    C = cur.pix.shape[0]
    dev = cur.x.device
    n_pix = heat.shape[0]
    if not cur.x.is_cuda or not 0 < R < 1 << 30 or not 0 < n_pix < 1 << 31:
        raise ValueError(f"mlt_accept_splat: needs 0 < R < 2^30 chains on a CUDA device, got "
                         f"{R} on {dev}")
    _check("splat", splat, torch.float32, (n_pix, 3), dev)
    _check("heat", heat, torch.float32, (n_pix,), dev)
    for tag, ch in (("state", cur), ("proposal", prop)):
        _check(f"{tag} x", ch.x, torch.float32, (R, D), dev)
        _check(f"{tag} pix", ch.pix, torch.int32, (C, R), dev)
        _check(f"{tag} rgb", ch.rgb, torch.float32, (C, R, 3), dev)
        _check(f"{tag} y", ch.y, torch.float32, (R,), dev)
    a = torch.empty((R,), device=dev)
    err = _lib().pbrt_mlt_accept_splat(
        splat.data_ptr(), heat.data_ptr(), cur.x.data_ptr(), cur.pix.data_ptr(),
        cur.rgb.data_ptr(), cur.y.data_ptr(), prop.x.data_ptr(), prop.pix.data_ptr(),
        prop.rgb.data_ptr(), prop.y.data_ptr(), a.data_ptr(), R, D, C, n_pix,
        int(seed) & prng.M32, int(pass_idx) & prng.M32,
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "mlt_accept_splat")
    launches["mlt_accept_splat"] += 1
    return a


def accept_and_splat(splat, heat, cur: Chains, prop: Chains, seed, pass_idx):
    """K12m-b: the kernel on CUDA tensors, its plain version with the
    stream's accept uniforms on CPU tensors -> a (R,)."""
    if cur.x.is_cuda:
        return accept_and_splat_cuda(splat, heat, cur, prop, seed, pass_idx)
    return accept_and_splat_from_uniforms(
        splat, heat, cur, prop, accept_uniforms(seed, pass_idx, cur.x.shape[0], cur.x.device))


# ------------------------------------------------------------- evaluation


def _film_and_sampler(meta, x):
    """Film positions (R, 2), wavelengths and the MLT sampler at dim 3 of
    primary samples x (R, D), and the pixel ids (R,) int32."""
    res_x, res_y = meta.resolution
    px, py = x[:, 0] * res_x, x[:, 1] * res_y
    pix = (torch.clamp(py.to(torch.int32), 0, res_y - 1) * res_x
           + torch.clamp(px.to(torch.int32), 0, res_x - 1))
    smp = samplers.from_primary_samples(x)
    smp = smp._replace(dim=torch.full_like(smp.dim, 3))
    return torch.stack([px, py], dim=-1), sampled.sample_visible(x[:, 2]), smp, pix


def _sensor_rgb(L, lam, pdf):
    rgb = colorspace.to_sensor_rgb(L, lam, pdf, film_kernel.cie_table(L.device))
    return torch.where(torch.isfinite(rgb), rgb, 0.0)


def _luminance(rgb):
    return torch.clamp(0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2],
                       min=0.0)


def eval_x(scene, meta, x):
    """The path integrator's Li from primary samples x (R, D) (JAX
    mlt.py:77-102) -> (rgb (R, 3), luminance y (R,), pixel ids (R,) int32,
    {"closest", "shadow"} rays traced as 0-dim tensors)."""
    R = x.shape[0]
    p_film, wl, smp, pix = _film_and_sampler(meta, x)
    rays = perspective.generate_rays(scene, p_film, torch.zeros((R, 2), device=x.device))
    L, wl_out, stats = path_integrator.li(scene, meta, rays, wl, smp, "mlt", 0)
    rgb = _sensor_rgb(L, wl_out.lam, wl_out.pdf)
    return rgb, _luminance(rgb), pix, stats


def eval_x_bdpt(scene, meta, x):
    """The whole BDPT estimator from primary samples x (R, D) (JAX
    mlt.py:130-164) -> (pix (C, R) int32, rgb (C, R, 3), y (R,) the
    contributions' summed luminance, {"closest", "shadow"} rays traced).
    Contribution 0 is the camera sum at the film position, 1..n_t1 the t = 1
    splats in li_bdpt's strategy order."""
    R = x.shape[0]
    p_film, wl, smp, pix = _film_and_sampler(meta, x)
    L, (splat_pix, splat_L), stats = bdpt.li_bdpt(scene, meta, p_film, smp, wl, "mlt", 0)
    n_t1 = splat_pix.shape[0] // R
    pix = torch.cat([pix[None], splat_pix.reshape(n_t1, R).to(torch.int32)])
    Ls = torch.cat([L[None], splat_L.reshape(n_t1, R, 4)])
    rgb = _sensor_rgb(Ls, wl.lam[None], wl.pdf[None])
    return pix, rgb, _luminance(rgb).sum(0), stats


def _evaluate(scene, meta, x):
    """-> (Chains of x, ray counts) with the meta's estimator."""
    if meta.integrator in ("mlt", "mltbdpt"):
        pix, rgb, y, stats = eval_x_bdpt(scene, meta, x)
    else:
        rgb, y, pix, stats = eval_x(scene, meta, x)
        pix, rgb = pix[None], rgb[None]
    return Chains(x, pix.contiguous(), rgb.contiguous(), y.contiguous()), stats


# ------------------------------------------------------------------ frames


def _develop_mlt(img, meta):
    """Sensor-RGB splat sums (n_pix, 3) -> (H, W, 3) output RGB with the
    film's imaging ratio and output matrix, as film.develop treats splats."""
    res_x, res_y = meta.resolution
    m = meta.film_out_matrix if meta.film_out_matrix is not None \
        else colorspace.srgb().rgb_from_xyz
    return colorspace.apply_matrix(m, img * meta.film_imaging_ratio).reshape(res_y, res_x, 3)


def _render_chains(scene, meta, D, n_chains, n_bootstrap, seed, verbose, return_heatmap,
                   device, on_pass):
    device = resolve_device(device)
    if scene.device != device:
        scene = scene.to(device)
    res_x, res_y = meta.resolution
    n_pix = res_x * res_y
    n_bootstrap = n_bootstrap or max(n_chains * 4, 1 << 16)
    counts = {"closest": 0, "shadow": 0}

    def evaluate(x):
        ch, st = _evaluate(scene, meta, x)
        for k in counts:
            counts[k] = counts[k] + st[k]
        return ch

    # bootstrap: the mean luminance b and the chains' initial states
    xs, ys = [], []
    for i in range(max(1, n_bootstrap // n_chains)):
        x = stream_uniforms(seed, BOOTSTRAP, i, n_chains, D, device)
        xs.append(x)
        ys.append(evaluate(x).y)
    x_boot, y_boot = torch.cat(xs), torch.cat(ys)
    b = float(y_boot.mean())
    if b <= 0:
        raise ValueError("MLT bootstrap found no light-carrying paths")
    q, alias, _ = dist.alias_table_build(y_boot.cpu().numpy())
    pick, _ = dist.alias_sample(torch.as_tensor(q, device=device),
                                torch.as_tensor(alias, device=device),
                                stream_uniforms(seed, PICK, 0, n_chains, 1, device)[:, 0])
    cur = evaluate(x_boot[pick].contiguous())

    n_passes = max(1, meta.mutations_per_pixel * n_pix // n_chains)
    splat = torch.zeros((n_pix, 3), device=device)
    heat = torch.zeros((n_pix,), device=device)
    for i in range(n_passes):
        prop = evaluate(mutate(cur.x, seed, i))
        a = accept_and_splat(splat, heat, cur, prop, seed, i)
        if verbose and i % 16 == 0:
            print(f"pass {i + 1}/{n_passes} accept={float(a.mean()):.2f}")
        if on_pass is not None:
            on_pass(i, a)
    img = _develop_mlt(splat * (b * n_pix / (n_passes * n_chains)), meta)
    stats = {k: int(v) for k, v in counts.items()} | {"mutations": n_passes * n_chains}
    if return_heatmap:
        return img, heat.reshape(res_y, res_x), stats
    return img, stats


def render_mlt_bdpt(scene, meta, n_chains=N_CHAINS, n_bootstrap=None, seed=0, verbose=False,
                    return_heatmap=False, device=None, on_pass=None):
    """MLT over the BDPT estimator ("mlt", "mltbdpt"; JAX mlt.py:267-337)
    -> ((H, W, 3) linear RGB, [heatmap (H, W),] {"closest", "shadow",
    "mutations"}). D = 16 + 16 (max_depth + 2) primary samples a chain.
    on_pass(i, a), if given, is called after each pass with its acceptances."""
    return _render_chains(scene, meta, 16 + 16 * (meta.max_depth + 2), n_chains, n_bootstrap,
                          seed, verbose, return_heatmap, device, on_pass)


def render_mlt(scene, meta, n_chains=N_CHAINS, n_bootstrap=None, seed=0, verbose=False,
               return_heatmap=False, device=None, on_pass=None):
    """Full PSS-MLT render (JAX mlt.py:191-252; "mlt" and "mltbdpt" go to
    render_mlt_bdpt) -> ((H, W, 3) linear RGB, [heatmap (H, W),] {"closest",
    "shadow": rays traced by every evaluation (bootstrap, initial states,
    passes), "mutations"}). "mltpath": D = 16 + 10 max_depth."""
    if meta.integrator in ("mlt", "mltbdpt"):
        return render_mlt_bdpt(scene, meta, n_chains, n_bootstrap, seed, verbose,
                               return_heatmap, device, on_pass)
    return _render_chains(scene, meta, 16 + 10 * meta.max_depth, n_chains, n_bootstrap, seed,
                          verbose, return_heatmap, device, on_pass)
