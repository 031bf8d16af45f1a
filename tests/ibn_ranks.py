"""The SEPC PConv module with iBN on 2 images, split over 2 gloo ranks or in
one process (tests/test_torch_necks.py). It imports no JAX: the ranks are
subprocesses that import this module."""
import os

import numpy as np
import torch

from simpledet_torch.parallel import dist

FILTERS, B = 16, 2
SHAPES = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]


def module():
    """A seeded deformable PConv module with iBN; its offset convs drawn so
    that the offsets reach a few cells."""
    from simpledet_torch.models.sepc import PConvModule, SEPCConvShared

    mod = PConvModule(FILTERS, part_deform=True, ibn=True)
    gen = torch.Generator().manual_seed(0)
    for m in mod.modules():
        if isinstance(m, SEPCConvShared):
            m.init_weights(gen)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            if "offset_conv.weight" in name:
                p.normal_(0.0, 2.0 / np.sqrt(9 * FILTERS), generator=gen)
            if name.endswith("ibn.beta"):
                p.fill_(0.5)
    return mod


def inputs():
    """The 2 images' levels [B, C, h, w] and the output gradients."""
    rng = np.random.RandomState(3)
    levels = [rng.randn(B, FILTERS, h, w).astype(np.float32)
              for h, w in SHAPES]
    gouts = [rng.randn(B, FILTERS, h, w).astype(np.float32)
             for h, w in SHAPES]
    return levels, gouts


def run(rows):
    """Outputs, input gradients and parameter gradients of the module on
    the images `rows`, for the loss sum(out * gout)."""
    mod = module()
    levels, gouts = inputs()
    xs = [torch.from_numpy(x[rows]).requires_grad_() for x in levels]
    outs = mod(xs)
    sum((o * torch.from_numpy(g[rows])).sum()
        for o, g in zip(outs, gouts)).backward()
    return dict(outs=[o.detach() for o in outs],
                x_grads=[x.grad for x in xs],
                grads={n: p.grad for n, p in mod.named_parameters()})


def rank_main(out_dir):
    dist.init_from_env("cpu")
    r = dist.rank()
    result = run([r])
    result["world"] = dist.world_size()
    torch.save(result, os.path.join(out_dir, f"rank{r}.pt"))
    dist.destroy()
