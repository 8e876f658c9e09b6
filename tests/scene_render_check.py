"""A scene with coated materials rendered through the port on the CPU and
through pbrt_tpu live at a small size (for tests/test_torch_render_*.py).

The layered BxDF seeds its walk's PCG32 with a hash of the float bits of
its directions, so an ulp of difference in a direction gives an independent
walk. The two packages' local directions differ in their bits on most lanes
(XLA contracts `from_local`'s and `to_local`'s sums of products into fused
multiply-adds; torch rounds each product:
tests/test_torch_layered.py::test_world_directions_round_apart_under_xla
counts 65 % and 72 % of lanes), so the two renders of a coated scene are
independent estimates of one image, not the same samples. The images are
therefore held to tests/test_parity.py's criterion after averaging
8x8-pixel blocks (256 samples a block at 16^2 x 4 spp), and the image means
to 1 %, as in the criterion. The honest ray counts, which the walks'
`valid` flags decide where a path ends, are held to 1 %, not equal: at
16^2 x 4 spp, max depth 3 they were 3,953 against JAX's 3,964 on
material-testball (0.28 %) and 5,866 against 5,888 on staircase (0.37 %),
JAX 0.9 on the CPU."""
import numpy as np
import jax.numpy as jnp

from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import render as jrender
from pbrt_tpu.scene import builder as jbd
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch.integrators.render import render
from pbrt_tpu_torch.scene import builder as tbd
from pbrt_tpu_torch.scene.compile import compile_scene
from layered_cases import blocks
from test_torch_render import _check


def check_against_live_jax(path, res, spp, max_depth, block=8):
    """Render `path` at res^2 x spp, max_depth, box filter through both
    packages; assert the images and ray counts agree as the module says.
    -> the port's SceneMeta."""
    builders = []
    for bd_ in (jbd, tbd):
        b = bd_.SceneBuilder().parse_file(str(path))
        b.film["xresolution"] = b.film["yresolution"] = res
        b.filter = {"type": "box"}
        b.integrator["maxdepth"] = max_depth
        builders.append(b)
    js, jm = j_compile(builders[0], spp_override=spp)
    film, n_rays = jrender.render_spp_fused(
        js, jfilm.new_film(jm.resolution), jnp.arange(res * res, dtype=jnp.int32), 0,
        n_spp=spp, lanes_spp=spp, max_depth=jm.max_depth, use_lens=False, res_x=res,
        sampler_kind=jm.sampler, spp=spp, filter_kind=jm.filter_kind, env_ids=(),
        volumetric=False, footprints=False)
    want = np.asarray(jfilm.develop(film, jm.resolution, out_matrix=jm.film_out_matrix,
                                    imaging_ratio=jm.film_imaging_ratio))
    scene, meta = compile_scene(builders[1], spp_override=spp, device="cpu")
    assert (meta.max_depth, meta.spp, meta.sampler) == (max_depth, spp, "stratified")
    img, stats = render(scene, meta, device="cpu", return_stats=True)
    img = img.numpy()
    assert img.shape == want.shape and np.isfinite(img).all()
    _check(blocks(img, block), blocks(want, block), str(path))
    assert abs(img.mean() - want.mean()) < 0.01 * want.mean()
    n_port = stats["closest"] + stats["shadow"]
    assert abs(n_port - float(n_rays)) <= 0.01 * float(n_rays), (n_port, float(n_rays))
    return meta
