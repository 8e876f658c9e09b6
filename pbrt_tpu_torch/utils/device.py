"""Device selection for the port's entry points.

The entry points run on the card unless the caller asks for the CPU: with
`device=None` they use "cuda", and without a card they raise instead of
falling back to the CPU. The CPU runs the plain PyTorch version of every
kernel and is what the tests use."""
import torch


def resolve_device(device=None):
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pbrt_tpu_torch: no CUDA device is available; pass device='cpu' "
            "(CLI: --device cpu) to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
