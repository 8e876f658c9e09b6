"""Multi-process renders of the port for tests/test_torch_parallel.py: each
rank is a process spawned with `run_ranks`, joins a gloo process group
through a file (so concurrent test workers never share a port), renders the
cases and saves what it got. Imports torch and pbrt_tpu_torch only: the
spawned processes never load JAX."""
import dataclasses
import multiprocessing as mp
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

RES, SPP, DEPTH = 16, 2, 3
TERRAIN_RES, TERRAIN_SPP, TERRAIN_POOL = 32, 4, 2048


def cornell_mesh():
    """cornell-mesh levels 3 at RES^2 x SPP, max depth DEPTH, on the CPU."""
    from pbrt_tpu_torch.scene import testscenes as ts

    scene, meta = ts.cornell_mesh(res=RES, spp=SPP, levels=3, device="cpu")
    return scene, dataclasses.replace(meta, max_depth=DEPTH)


def terrain(cache_dir):
    """terrain n = 16 (450 triangles, open: the wavefront loop) at
    TERRAIN_RES^2 x TERRAIN_SPP."""
    from pbrt_tpu_torch.scene import testscenes as ts

    return ts.terrain(res=TERRAIN_RES, spp=TERRAIN_SPP, n=16, device="cpu",
                      cache_dir=cache_dir)


def render_case(case, cache_dir):
    """One case in this process (under a process group or alone) -> {name:
    array}: the film sums (pixel-parallel cases), the image and the ray
    counts of render()."""
    from pbrt_tpu_torch.film import film as filmlib
    from pbrt_tpu_torch.integrators import render as rd

    out = {}
    if case == "terrain":
        scene, meta = terrain(cache_dir)
    else:
        scene, meta = cornell_mesh()
    if case in ("cornell-mesh", "terrain"):
        film = filmlib.new_film(meta.resolution, "cpu")
        stats, dropped = rd.render_pixel_parallel(scene, meta, film)
        out.update(rgb_sum=film.rgb_sum.numpy(), weight_sum=film.weight_sum.numpy(),
                   film_rays=np.int64(int(stats["closest"]) + int(stats["shadow"])),
                   dropped=np.int64(dropped))
    img, stats = rd.render(scene, meta, device="cpu", return_stats=True,
                           shard_parts=2 if case == "sharded" else 0)
    out.update(img=img.numpy(), closest=np.int64(stats["closest"]),
               shadow=np.int64(stats["shadow"]))
    return out


CASES = ("cornell-mesh", "terrain", "sharded")


def rank_main(rank, world, init_file, out_dir):
    """A rank: join the gloo group, render every case, save
    out_dir/rank{rank}.npz with keys "{case}/{name}"."""
    from pbrt_tpu_torch.integrators import render as rd

    torch.set_num_threads(2)
    rd.POOL_LANES = TERRAIN_POOL
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        res = {f"{case}/{k}": v for case in CASES
               for k, v in render_case(case, out_dir).items()}
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def run_ranks(world, out_dir, timeout=600):
    """Spawn `world` ranks of rank_main and wait for them -> [{key: array}]
    of each rank."""
    ctx = mp.get_context("spawn")
    init_file = Path(out_dir) / "pg_init"
    procs = [ctx.Process(target=rank_main, args=(r, world, str(init_file), str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"ranks exited with {codes}")
    return [dict(np.load(Path(out_dir) / f"rank{r}.npz")) for r in range(world)]
