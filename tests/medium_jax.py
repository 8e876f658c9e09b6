"""The JAX package's and the port's twins of the media tests' scenes
(tests/medium_cases.py), for the CPU tests that hold the port to JAX."""
import numpy as np


def builders(text=None, path=None, res=16, integrator=None, max_depth=None, box=True):
    """The JAX package's and the port's SceneBuilder of a scene text or
    file at res x res -> (JAX builder, port builder)."""
    from pbrt_tpu.scene import builder as jbd, lexer as jlx
    from pbrt_tpu_torch.scene import builder as tbd, lexer as tlx

    out = []
    for bd, lx in ((jbd, jlx), (tbd, tlx)):
        if path is not None:
            b = bd.SceneBuilder().parse_file(str(path))
        else:
            b = bd.SceneBuilder()
            b.parse_tokens(lx.tokenize(text))
        b.film["xresolution"] = b.film["yresolution"] = res
        if box:
            b.filter = {"type": "box"}
        if integrator is not None:
            b.integrator["type"] = integrator
        if max_depth is not None:
            b.integrator["maxdepth"] = max_depth
        out.append(b)
    return out


def twins(jb, spp):
    """The JAX package's compiled scene of builder jb and the port's CPU twin
    carried across by scene_from_arrays -> (JAX scene, JAX meta, port scene,
    port meta)."""
    from pbrt_tpu.scene.compile import compile_scene as j_compile
    from pbrt_tpu_torch.scene.compile import scene_from_arrays

    js, jm = j_compile(jb, spp_override=spp)
    arrays = {k: (np.asarray(v) if k != "filt" else v) for k, v in js._asdict().items()
              if v is not None and k != "tex"}
    ts, tm = scene_from_arrays(arrays, jm, "cpu")
    return js, jm, ts, tm
