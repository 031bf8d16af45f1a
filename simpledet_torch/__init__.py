"""SimpleDet on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `simpledet_tpu`, module for module. It imports
`torch` and numpy only; the JAX package stays the reference that the tests
hold this one against. Entry points run on the card (`device="cuda"`) unless
the caller asks for the CPU.
"""


def resolve_device(device):
    """torch.device for an entry point; raises if CUDA is asked for and absent
    (there is no silent CPU path)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU explicitly")
    return device
