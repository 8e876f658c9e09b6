"""K12m (csrc/mlt.cu) cases and criteria, shared by tests/test_torch_mlt.py,
tests/test_torch_gpu.py and chip_smoke.py. Imports neither jax nor
pbrt_tpu.

Criteria, with their reasons:
- mutate: the kernel and the plain version draw the same PCG32 bits and do
  the same float32 operations in the same order (built with --fmad=false;
  on the card torch's log and sqrt are the kernel's logf and sqrtf). So the
  draws and the large-step flags are bit-exact, and a value may differ by
  MUTATE_ULPS units in the last place of the largest values of [0, 1)
  (2^-24), measured around the circle (a value at the wrap point may land
  on either side). The error is absolute, not relative to the value:
  Winitzki's erfinv cancels near 0 (sqrt(term^2 - l) - term with term ~4.3),
  so an ulp of its logarithm moves the perturbation by up to ~5e-7 wherever
  x lies (glibc's logf against torch's log on the CPU: up to 9 units).
- accept and splat: the acceptance and the chain state are the same
  float32 operations on the same inputs, so they are equal; the splat and
  heat sums are atomic adds in an order that changes from run to run, so
  they agree to SPLAT_RTOL relative (of the largest sum) only.
"""
import numpy as np
import torch

MUTATE_ULPS = 2
SPLAT_RTOL = 1e-5


def _require(ok, *what):
    """A criterion's check; raises AssertionError (also under python -O)."""
    if not ok:
        raise AssertionError(" ".join(map(str, what)))


def primary_samples(R, D, seed):
    """(R, D) float32 primary samples from numpy: uniforms, with the
    edges 0, 0.5 and the clip end 1 - 1e-7 on a few rows."""
    rng = np.random.default_rng(seed)
    x = rng.random((R, D)).astype(np.float32)
    x[0] = 0.0
    x[1] = 0.5
    x[2] = np.float32(1.0 - 1e-7)
    return x


def accept_inputs(R, C, D, n_pix, seed):
    """Chain state and proposal for K12m-b as numpy arrays: {x_cur,
    x_prop (R, D); pix_cur, pix_prop (C, R) int32; rgb_cur, rgb_prop
    (C, R, 3); y_cur, y_prop (R,); u_acc (R,)}. Some lanes have y = 0 on
    either side, some contributions are 0, and pixels repeat."""
    rng = np.random.default_rng(seed)
    out = {}
    for tag in ("cur", "prop"):
        rgb = rng.gamma(0.5, 1.0, (C, R, 3)).astype(np.float32)
        rgb[:, rng.random(R) < 0.2] = 0.0                  # dead contributions
        y = (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]).sum(0)
        y[rng.random(R) < 0.1] = 0.0
        out[f"x_{tag}"] = rng.random((R, D)).astype(np.float32)
        out[f"pix_{tag}"] = rng.integers(0, n_pix, (C, R)).astype(np.int32)
        out[f"rgb_{tag}"] = rgb
        out[f"y_{tag}"] = y.astype(np.float32)
    out["u_acc"] = rng.random(R).astype(np.float32)
    return out


def circular_ulps(a, b):
    """Distance of a and b around [0, 1) in units of 2^-24, the spacing of
    float32 in [0.5, 1) (numpy float32 arrays)."""
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return np.minimum(d, 1.0 - d) * 2.0 ** 24


def compare_mutate(x, out_k, draws_k, mutate_from_uniforms, chain_uniforms, seed, pass_idx):
    """K12m-a's output and draws (torch, any device) against the plain
    version on the same x -> {chains, large (number of large steps),
    max_ulps}; raises AssertionError where the criterion fails."""
    R, D = x.shape
    u_large, fresh, u = chain_uniforms(seed, pass_idx, R, D, x.device)
    want = torch.cat([u_large[:, None], torch.stack([fresh, u], -1).reshape(R, 2 * D)], 1)
    _require(torch.equal(draws_k, want), "mutate draws differ from chain_uniforms")
    out_p = mutate_from_uniforms(x, u_large, fresh, u)
    large = (u_large < 0.3).cpu().numpy()
    a, b = out_k.cpu().numpy(), out_p.cpu().numpy()
    _require(np.array_equal(a[large], b[large]), "large steps differ")
    ulps = circular_ulps(a, b)
    _require(float(ulps.max()) <= MUTATE_ULPS, float(ulps.max()))
    _require(((a >= 0) & (a < 1)).all())
    return {"chains": R, "large": int(large.sum()), "max_ulps": float(ulps.max())}


def compare_accept(kernel, plain, splat, heat, cur, prop):
    """K12m-b, kernel(splat, heat, cur, prop) -> a, against its plain
    version plain(...) on copies of the same inputs (cur and prop are
    mlt.Chains; splat, heat and cur are updated in place) -> {chains,
    accepted, max_abs_err of splat and heat}; raises AssertionError where
    the criterion fails."""
    def copy(ch):
        return type(ch)(*(t.clone() for t in ch))
    ck, cp = copy(cur), copy(cur)
    sk, hk, sp, hp = splat.clone(), heat.clone(), splat.clone(), heat.clone()
    a_k = kernel(sk, hk, ck, prop)
    a_p = plain(sp, hp, cp, prop)
    _require(torch.equal(a_k, a_p), "acceptance differs")
    for f, k, p in zip(cur._fields, ck, cp):
        _require(torch.equal(k, p), f"chain state {f} differs")
    err = 0.0
    for k, p in ((sk, sp), (hk, hp)):
        scale = max(float(p.abs().max()), 1e-30)
        e = float((k - p).abs().max())
        _require(e <= SPLAT_RTOL * scale, (e, scale))
        err = max(err, e)
    return {"chains": cur.x.shape[0], "accepted": int((ck.x != cur.x).any(1).sum()),
            "max_abs_err": err}


# ---- renders (chip_smoke.py)
# cornell 24^2 on the card and on the CPU with one seed: 1024 chains, 8192
# bootstrap samples and 32 mutations per pixel (18 passes). The two draw the
# same random numbers, so they part only where rounding in an evaluation
# (torch's eager ops round apart between card and CPU) flips an acceptance,
# and a chain that flipped stays apart. DECISION_FRAC of the (chain, pass)
# decisions must agree. A (chain, pass) carries 1 / (chains x passes) of the
# frame's luminance, so the 1 % that may differ moves each 8x8 block of the
# 3 x 3 by about 1 % of its sum if spread with the energy; BLOCK_RTOL allows
# five times that, against the block's mean over its three channels (floored
# at 5 % of the image mean); the image means (b is the same bootstrap)
# within MEAN_RTOL.
SMALL_CHAINS, SMALL_BOOTSTRAP, SMALL_MUTATIONS = 1024, 8192, 32
DECISION_FRAC = 0.99
BLOCK_RTOL = 0.05
MEAN_RTOL = 0.01


def _blocks(img, n=8):
    h, w = img.shape[0] // n, img.shape[1] // n
    return img[:h * n, :w * n].reshape(h, n, w, n, -1).mean((1, 3))


def compare_renders(img_a, img_b, acc_a, acc_b):
    """Two MLT renders of one seed (numpy (H, W, 3) images, (passes,
    chains) bool acceptances) -> {decisions, block_rel}; raises
    AssertionError where the criteria above fail."""
    decisions = float((acc_a == acc_b).float().mean())
    _require(decisions >= DECISION_FRAC, decisions)
    ba, bb = _blocks(img_a), _blocks(img_b)
    scale = np.maximum(np.abs(bb).mean(-1, keepdims=True), 0.05 * img_b.mean())
    block_rel = float((np.abs(ba - bb) / scale).max())
    _require(block_rel <= BLOCK_RTOL, block_rel)
    _require(abs(img_a.mean() - img_b.mean()) <= MEAN_RTOL * img_b.mean())
    return {"decisions": decisions, "block_rel": block_rel}


# The full-width MLT frames' image means against the port's own BDPT
# (caustic-glass, 256^2 x 64) and path (cornell-mesh, 256^2 x 16) frames.
# An MLT frame's mean is the plain estimate of its bootstrap (65,536 samples
# of the unfiltered image), so its error is the bootstrap's. cornell-mesh
# (mltpath, max depth 5): a sample's luminance has a relative standard
# deviation of 6.2 (CPU, 65,536 samples), so 2.4 %; the bound is about four
# of those. caustic-glass (mlt, max depth 7) is heavy-tailed: a few samples
# are hundreds of times the mean (up to 999x in seed 3's 65,536), so the
# bootstrap mean mostly falls short. Measured on the CPU: seed 0's
# unfiltered bootstrap image mean lies 1.8 % below the same scene's BDPT
# frame at 256^2 x 64 (4.2M samples; box and mitchell filter 0.07 % apart)
# and equals seed 0's MLT frame mean to 0.01 %; the luminance means of
# seeds 0-3 spread over 2.3 %. The bound is the 1.8 % plus that spread
# (4.1 %), rounded up.
FRAME_MEAN_RTOL = {"caustic_mlt": 0.05, "cornell_mesh_mlt": 0.10}
