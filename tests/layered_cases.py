"""Synthetic lanes of the layered BxDF (K7), as numpy arrays from a seed, for
tests/test_torch_layered.py, tests/test_torch_gpu.py and chip_smoke.py, with
the criteria the walk is held to there and the block means the coated
renders are compared on. Lane i takes case
i % len(CASES); each case fixes the bottom kind, the coat's and the
bottom's roughness and the medium, and the lanes vary the rest: the coat's
eta, the thickness, the bottom's reflectance or complex IOR, and the
directions (a quarter of wo below the horizon, the two-sided flip; one lane
in eight grazing)."""
import numpy as np

K_DIFFUSE, K_CONDUCTOR, K_DIELECTRIC = 0, 1, 2

# name: (bottom kind, coat alpha, bottom alpha, medium albedo, g)
CASES = {
    "coated diffuse, smooth coat": (K_DIFFUSE, 1e-4, 1e-4, 0.0, 0.0),
    "coated diffuse, rough coat": (K_DIFFUSE, 0.28, 1e-4, 0.0, 0.0),
    "medium, g -0.5": (K_DIFFUSE, 0.2, 1e-4, 0.6, -0.5),
    "medium, g 0": (K_DIFFUSE, 1e-4, 1e-4, 0.8, 0.0),
    "medium, g 0.7": (K_DIFFUSE, 0.1, 1e-4, 0.5, 0.7),
    "coated conductor, smooth": (K_CONDUCTOR, 1e-4, 1e-4, 0.0, 0.0),
    "coated conductor, rough": (K_CONDUCTOR, 0.14, 0.35, 0.0, 0.0),
}


def _unit(g, n):
    v = g.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def lanes(n, seed):
    """{name: float32/int32 array} for n lanes: top_* and bottom_* BxDF
    fields (kind, refl, trans, eta_re, eta_im, eta, ax, ay), thickness, g,
    albedo, wo, wi, uc, u2, and case (n,) the case index of each lane."""
    g = np.random.default_rng(seed)
    case = np.arange(n) % len(CASES)
    table = np.array([v for v in CASES.values()], np.float64)
    bkind, calpha, balpha, alb, hg = (table[case, j] for j in range(5))
    out = {"case": case.astype(np.int32)}
    out["top_kind"] = np.full(n, K_DIELECTRIC, np.int32)
    out["top_refl"] = np.zeros((n, 4))
    out["top_trans"] = np.zeros((n, 4))
    out["top_eta_re"] = np.ones((n, 4))
    out["top_eta_im"] = np.zeros((n, 4))
    out["top_eta"] = g.uniform(1.3, 1.7, n)
    out["top_ax"] = calpha * g.uniform(0.8, 1.2, n)
    out["top_ay"] = calpha * g.uniform(0.8, 1.2, n)
    out["bottom_kind"] = bkind.astype(np.int32)
    out["bottom_refl"] = g.uniform(0.05, 0.95, (n, 4))
    out["bottom_trans"] = np.zeros((n, 4))
    out["bottom_eta_re"] = g.uniform(0.1, 2.0, (n, 4))
    out["bottom_eta_im"] = g.uniform(1.0, 5.0, (n, 4))
    out["bottom_eta"] = np.full(n, 1.5)
    out["bottom_ax"] = balpha * g.uniform(0.8, 1.2, n)
    out["bottom_ay"] = balpha * g.uniform(0.8, 1.2, n)
    out["thickness"] = g.uniform(0.005, 0.05, n)
    out["g"] = hg
    out["albedo"] = alb[:, None] * g.uniform(0.5, 1.0, (n, 4))
    wo = _unit(g, n)
    wo[:, 2] = np.abs(wo[:, 2])
    wo[::4] *= -1.0                                   # below the horizon
    graze = np.arange(n) % 8 == 3
    wo[graze, 2] = np.sign(wo[graze, 2]) * g.uniform(1e-4, 2e-2, graze.sum())
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    out["wo"] = wo
    wi = _unit(g, n)
    wi[:, 2] = np.where(g.random(n) < 0.8, np.abs(wi[:, 2]), -np.abs(wi[:, 2]))
    out["wi"] = np.where(wo[:, 2:3] < 0, -wi, wi)    # mostly wo's side
    out["uc"] = g.random(n)
    out["u2"] = g.random((n, 2))
    return {k: (v if v.dtype == np.int32 else v.astype(np.float32)) for k, v in out.items()}


def deep_medium_lanes(n, seed):
    """lanes(n, seed) with a thick, nearly white medium between the
    interfaces: 1 to 4 mean free paths, albedo 0.93 to 0.97, g from -0.3 to
    0.6. Russian roulette spares such walks, so many run to max_depth: the
    lanes that keep a slot of the card's layered_f longest."""
    out = lanes(n, seed)
    g = np.random.default_rng(seed + 1)
    out["thickness"] = g.uniform(1.0, 4.0, n).astype(np.float32)
    out["albedo"] = g.uniform(0.93, 0.97, (n, 4)).astype(np.float32)
    out["g"] = g.uniform(-0.3, 0.6, n).astype(np.float32)
    return out


BXDF_FIELDS = ("kind", "refl", "trans", "eta_re", "eta_im", "eta", "ax", "ay")

# The walk's agreement criteria, against JAX on the CPU and against the plain
# version on the card. The walk is not bit-exact across implementations:
# exp, log1p, sin and cos round apart by an ulp, and the walk compares its
# draws with values computed from them (the Fresnel choice, russian
# roulette, the boundary tests), so a rare lane takes another branch.
EQUAL_FRAC = 0.999              # valid and flags equal on this share of lanes
CLOSE_FRAC = 0.995              # f, wi, pdf within RTOL, ATOL on this share
RTOL, ATOL = 1e-4, 1e-6
MEAN_RTOL = 1e-3                # lane means of f, pdf and f |cos| / pdf


def _f64(x):
    """float64 numpy copy of a numpy array or a torch tensor (on any device)."""
    if hasattr(x, "detach"):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def frac_close(got, want, rtol=RTOL, atol=ATOL):
    """Fraction of lanes (first axis) whose every component is within
    atol + rtol |want|."""
    got, want = _f64(got), _f64(want)
    got, want = got.reshape(len(got), -1), want.reshape(len(want), -1)
    return float(np.all(np.abs(got - want) <= atol + rtol * np.abs(want), axis=1).mean())


def blocks(img, k):
    """Mean over k x k pixel blocks of an (H, W, 3) image."""
    h, w, c = img.shape
    return img.reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))
