"""Where a path-integrator frame's paths part between the card and the CPU.

Renders the frame on the card and on the CPU (the same random numbers) and
compares them: the share of pixel values outside tests/test_parity.py's
per-pixel tolerance, the same over 4x4 block means, and the means. Then it
follows the frame's first wave bounce by bounce on both devices, each from
its own states (path.bounce_step from the card's camera rays and from the
CPU's), and prints, a bounce at a time, how many lanes part there (their
direction or activity, or their radiance beyond 1e-3 relative), the
materials they hit there and a few of them with their hits; a lane counts
once, at the bounce where it first parts. Scenes: the textured
cornell-mesh as it is ("textured"), with its mix ball made its diffuse
("textured-nomix"), and the untextured cornell-mesh ("cornell-mesh"), each
at --levels, --res and --spp under a box filter. Needs a card; from the
repo root:
    python tools/card_cpu_parting.py --scene textured --out build/parting.json
"""
import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pbrt_tpu_torch import kernels  # noqa: E402
from pbrt_tpu_torch.accel import dispatch  # noqa: E402
from pbrt_tpu_torch.integrators import path as pth, render as rd  # noqa: E402
from pbrt_tpu_torch.scene import builder as bd, lexer as lx, testscenes as ts  # noqa: E402
from pbrt_tpu_torch.scene.compile import compile_scene  # noqa: E402
from pbrt_tpu_torch.utils.math import INFINITY  # noqa: E402

MIX_BALL = '\n  NamedMaterial "ball-mix"'


def builder(scene, levels, res, spp):
    if scene == "cornell-mesh":
        b = ts.cornell_mesh_builder(levels=levels, res=res)
        b.sampler["pixelsamples"] = spp
    else:
        text = ts.textured_cornell_mesh_pbrt(levels, kernels.BUILD_DIR / "textures", res, spp)
        if scene == "textured-nomix":
            if text.count(MIX_BALL) != 1:
                raise RuntimeError("the textured scene's mix ball is not where it was")
            text = text.replace(MIX_BALL, '\n  NamedMaterial "matte"')
        b = bd.SceneBuilder()
        b.parse_tokens(lx.tokenize(text))
    b.filter = {"type": "box"}
    return b


def outside(a, ref):
    """Share of values of a outside tests/test_parity.py's tolerance of ref."""
    return float((np.abs(a - ref) > 5e-3 + 0.05 * np.abs(ref)).mean())


def blocks4(img):
    h, w, c = img.shape
    return img.reshape(h // 4, 4, w // 4, 4, c).mean(axis=(1, 3))


def cpu_of(x):
    """Tensors (and NamedTuples of them) on the CPU."""
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(cpu_of(v) for v in x))
    return x


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="textured",
                    choices=("textured", "textured-nomix", "cornell-mesh"))
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("card_cpu_parting: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    b = builder(args.scene, args.levels, args.res, args.spp)
    (sg, mg), (sc, mc) = compile_scene(b, device=dev), compile_scene(b, device=cpu)
    img_g = rd.render(sg, mg, device=dev).cpu().numpy()
    img_c = rd.render(sc, mc, device=cpu).numpy()
    out = dict(card=card, scene=args.scene, levels=args.levels, res=args.res, spp=args.spp,
               pixels_outside=outside(img_g, img_c),
               blocks4_outside=outside(blocks4(img_g), blocks4(img_c)),
               means=[float(img_g.mean()), float(img_c.mean())], bounces=[])
    print(f"{card}; {args.scene} levels {args.levels} {args.res}^2 x {args.spp}: card vs cpu "
          f"{out['pixels_outside']:.4%} of values outside tests/test_parity.py's tolerance, "
          f"{out['blocks4_outside']:.4%} of 4x4 block means; means {out['means'][0]:.5f} / "
          f"{out['means'][1]:.5f}")
    ids, sids, _ = next(iter(rd.wave_lanes(args.res * args.res, mc.spp, "cpu")))
    states = []
    for sc_, mc_, d_ in ((sg, mg, dev), (sc, mc, cpu)):
        rays, wl, r, _ = rd.camera_lanes(sc_, mc_, ids.to(d_), sids.to(d_), False)
        states.append(pth.initial_state(rays, wl, r, pth.camera_medium(sc_, mc_)))
    parted = torch.zeros(ids.shape[0], dtype=torch.bool)
    for step in range(pth.iterations(mc)):
        st_g, st_c = states
        hits = [cpu_of(dispatch.intersect(s_, m_, st.o, st.d,
                                          torch.where(st.active, INFINITY, 0.0)))
                for s_, m_, st in ((sg, mg, st_g), (sc, mc, st_c))]
        states = [pth.bounce_step(sg, mg, st_g), pth.bounce_step(sc, mc, st_c)]
        ng, nc = cpu_of(states[0]), states[1]
        dd = (ng.d - nc.d).abs().max(-1).values
        new = ((dd > 1e-3) | (ng.active != nc.active)
               | ((ng.L - nc.L).abs() > 1e-3 * (nc.L.abs() + 1e-2)).any(-1)) & ~parted
        parted |= new
        mats, counts = torch.unique(hits[1].mat[new], return_counts=True)
        kinds = {int(m): int(sc.mat_type[m]) if m >= 0 else -1 for m in mats.tolist()}
        rec = dict(bounce=step, parted=int(new.sum()), live=int(st_c.active.sum()),
                   materials={str(m): int(n) for m, n in zip(mats.tolist(), counts.tolist())},
                   kinds={str(m): k for m, k in kinds.items()})
        out["bounces"].append(rec)
        print(f"bounce {step}: {rec['parted']} of {rec['live']} live lanes part; materials hit "
              f"there (index: lanes) {rec['materials']}, their kinds {rec['kinds']}")
        for lane in torch.nonzero(new)[:3, 0].tolist():
            hg, hc = hits[0], hits[1]
            print(f"  lane {lane}: mat {int(hc.mat[lane])} / {int(hg.mat[lane])}, p "
                  f"{hc.p[lane].tolist()} / {hg.p[lane].tolist()}, direction apart by "
                  f"{float(dd[lane]):.3e}")
    out["parted"] = int(parted.sum())
    out["lanes"] = int(ids.shape[0])
    print(f"{out['parted']} of {out['lanes']} lanes part")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
