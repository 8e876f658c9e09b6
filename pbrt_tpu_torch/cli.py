"""Command-line entry point of the port:

    python -m pbrt_tpu_torch.cli scene.pbrt --spp N --outfile out.png
        [--integrator path|bdpt|mltpath|mlt|mltbdpt] [--heatmap heat.png]
        [--shard-scene N] [--device cpu]
    torchrun --nproc-per-node G -m pbrt_tpu_torch.cli scene.pbrt ... [--shard-scene N]

Renders on the GPU by default and raises without one; `--device cpu` runs
the plain PyTorch versions of the kernels on the CPU (counterpart of
pbrt_tpu/cli.py for the path-family, BDPT and MLT integrators; the file's
integrator unless --integrator overrides it; --heatmap writes an MLT
render's sampling-density PNG). Under torchrun each rank renders on its own
card (gloo ranks with --device cpu) and the path family splits the frame's
pixels over them; --shard-scene N splits the scene's triangles into N parts
over the ranks instead (N >= the number of ranks). Rank 0 alone writes."""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pbrt-tpu-torch",
                                 description="spectral path tracer on PyTorch/CUDA")
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("--spp", type=int, default=None, help="samples per pixel (overrides scene)")
    ap.add_argument("--integrator", default=None,
                    help="path|volpath|bdpt|mltpath|mlt|mltbdpt (overrides the scene's)")
    ap.add_argument("--outfile", default=None, help="output PNG path")
    ap.add_argument("--resolution", default=None, help="WxH override, e.g. 256x256")
    ap.add_argument("--heatmap", default=None, metavar="FILE.png",
                    help="MLT integrators: write the sampling-density heatmap PNG")
    ap.add_argument("--shard-scene", type=int, default=0, metavar="N",
                    help="path family: split the triangles into N parts over the ranks "
                         "(for scenes larger than one card's memory)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from pbrt_tpu_torch.integrators.render import render_to_png
    from pbrt_tpu_torch.parallel import dist as pdist
    from pbrt_tpu_torch.scene import builder as bd
    from pbrt_tpu_torch.scene.compile import compile_scene
    from pbrt_tpu_torch.utils.device import resolve_device

    device = pdist.init_from_env(resolve_device(args.device))
    quiet = args.quiet or pdist.rank() != 0
    t0 = time.time()
    b = bd.SceneBuilder().parse_file(args.scene)
    if args.resolution:
        w, h = (int(x) for x in args.resolution.lower().split("x"))
        b.film["xresolution"], b.film["yresolution"] = w, h
    scene, meta = compile_scene(b, spp_override=args.spp, device=device,
                                integrator_override=args.integrator)
    if not quiet:
        print(f"scene: {meta.n_tris} tris, {meta.n_lights} lights; "
              f"{meta.resolution[0]}x{meta.resolution[1]} @ {meta.spp} spp, "
              f"integrator={meta.integrator} on {device} x{pdist.world()} ranks"
              + (f", geometry in {args.shard_scene} parts" if args.shard_scene else "")
              + f"; parse+compile {time.time() - t0:.2f} s")
    try:
        render_to_png(scene, meta, out_path=args.outfile, device=device, verbose=not quiet,
                      heatmap_path=args.heatmap, shard_parts=args.shard_scene)
        pdist.barrier()    # every rank leaves once rank 0 has written
    finally:
        pdist.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
