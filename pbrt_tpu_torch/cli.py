"""Command-line entry point of the port:

    python -m pbrt_tpu_torch.cli scene.pbrt --spp N --outfile out.png [--device cpu]

Renders on the GPU by default and raises without one; `--device cpu` runs
the plain PyTorch versions of the kernels on the CPU (counterpart of
pbrt_tpu/cli.py, for the path-family integrators and BDPT; the file's
integrator is used, and MLT raises until its slice)."""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pbrt-tpu-torch",
                                 description="spectral path tracer on PyTorch/CUDA")
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("--spp", type=int, default=None, help="samples per pixel (overrides scene)")
    ap.add_argument("--outfile", default=None, help="output PNG path")
    ap.add_argument("--resolution", default=None, help="WxH override, e.g. 256x256")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from pbrt_tpu_torch.integrators.render import render_to_png
    from pbrt_tpu_torch.scene import builder as bd
    from pbrt_tpu_torch.scene.compile import compile_scene
    from pbrt_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.time()
    b = bd.SceneBuilder().parse_file(args.scene)
    if args.resolution:
        w, h = (int(x) for x in args.resolution.lower().split("x"))
        b.film["xresolution"], b.film["yresolution"] = w, h
    scene, meta = compile_scene(b, spp_override=args.spp, device=device)
    if not args.quiet:
        print(f"scene: {meta.n_tris} tris, {meta.n_lights} lights; "
              f"{meta.resolution[0]}x{meta.resolution[1]} @ {meta.spp} spp on {device}; "
              f"parse+compile {time.time() - t0:.2f} s")
    render_to_png(scene, meta, out_path=args.outfile, device=device, verbose=not args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
