"""The process group of a multi-GPU render (counterpart of the JAX package's
`jax.distributed.initialize`, tools/multiproc_worker.py:36-40).

One process per card, started by torchrun:

    torchrun --nproc-per-node G -m pbrt_tpu_torch.cli scene.pbrt ...

`init_from_env` reads torchrun's RANK, WORLD_SIZE and LOCAL_RANK (and its
MASTER_ADDR and MASTER_PORT) and joins the group: NCCL on the card, after
`torch.cuda.set_device(LOCAL_RANK)`, gloo on the CPU. A render under a
process group splits its pixels over the ranks (or, scene-sharded, its
geometry) and all-reduces films and ray counts; without one it runs alone.
"""
import os

import torch
import torch.distributed as dist


def init_from_env(device):
    """Join the process group torchrun describes, for `device` ("cuda" or
    "cpu"). -> the device this rank renders on: cuda:LOCAL_RANK or the CPU.
    Outside torchrun (no WORLD_SIZE in the environment) nothing is joined
    and `device` comes back unchanged."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    if device.type == "cuda":
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return device


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def world():
    return dist.get_world_size() if dist.is_initialized() else 1


def all_reduce_film(film):
    """Sum the ranks' films in place (rgb_sum, weight_sum, splat)."""
    for x in (film.rgb_sum, film.weight_sum, film.splat):
        dist.all_reduce(x)


def barrier():
    if dist.is_initialized():
        dist.barrier()


def close():
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
