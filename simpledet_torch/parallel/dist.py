"""Data-parallel process groups (counterpart of simpledet_tpu/parallel/mesh.py).

The JAX package runs one process per host over a mesh of that host's devices;
pjit shards the batch over the mesh and XLA inserts the collectives. Here one
process drives one device, as `torchrun` launches them, and the collectives
are explicit: DDP averages the gradients (`core/train.py`), SyncBN sums its
statistics, and in its backward their gradients' sums, over the group
(`models/norm.py`), and the RPN's loss normaliser is summed over the group
(`models/rpn.py`).

    torchrun --nproc_per_node N -m simpledet_torch.detection_train \
        --config config/<name>.py [--device cpu]

`init_from_env` reads torchrun's `RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`LOCAL_WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT`, and takes NCCL on the
card and gloo on the CPU. Without a process group every helper here acts as
on a group of one. `dryrun_multichip(n)` spawns n gloo ranks on the CPU, and
each takes one DDP step at tiny shapes.
"""
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

from simpledet_torch import resolve_device


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if is_initialized() else 0


def world_size():
    return dist.get_world_size() if is_initialized() else 1


def host_count():
    """Hosts in the job: WORLD_SIZE // LOCAL_WORLD_SIZE (1 without torchrun).
    The JAX package scales the lr by jax.process_count(), one process per
    host, so the port scales by hosts, not by ranks."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return max(world // max(local, 1), 1)


def init_from_env(device="cuda"):
    """Join the process group that torchrun's environment describes and
    return this rank's device: `cuda:<LOCAL_RANK>` with NCCL, or the CPU with
    gloo when device is "cpu". Without WORLD_SIZE in the environment no group
    is made and `resolve_device(device)` is returned."""
    if "WORLD_SIZE" not in os.environ:
        return resolve_device(device)
    device = resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return device


def destroy():
    if is_initialized():
        dist.destroy_process_group()


@torch.no_grad()
def sum_over_group(x):
    """A detached copy of x summed over the process group."""
    x = x.detach().clone()
    if is_initialized():
        dist.all_reduce(x)
    return x


def mean_over_group(values):
    """{name: scalar tensor} averaged over the group in one all_reduce."""
    if not is_initialized():
        return values
    names = list(values)
    stacked = sum_over_group(torch.stack([values[k].float() for k in names]))
    return dict(zip(names, stacked / world_size()))


def data_parallel(model, device):
    """model in DistributedDataParallel on `device`. The buffers are synced
    from rank 0 once, when DDP wraps the model, and never in a forward:
    FrozenBN's are constants and SyncBN's running statistics come from
    statistics summed over the group, the same on every rank."""
    import inspect

    from torch.nn.parallel import DistributedDataParallel as DDP

    kw = dict(device_ids=[device.index] if device.type == "cuda" else None)
    if "forward_sync_buffers" in inspect.signature(DDP).parameters:
        kw["forward_sync_buffers"] = False
    else:
        kw["broadcast_buffers"] = False
    return DDP(model, **kw)


# ------------------------------------------------------------------ dry run


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(code, n, *, env=None, threads=2, timeout=900):
    """Run `python -c code` as n ranks of one host, with torchrun's
    environment (gloo rendezvous on a free localhost port) and `threads`
    CPU threads each; returns their outputs and raises if one fails."""
    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for r in range(n):
        e = dict(os.environ, **(env or {}))
        e.update(OMP_NUM_THREADS=str(threads), RANK=str(r),
                 LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                 LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port),
                 PYTHONPATH=os.pathsep.join(
                     [repo] + [p for p in [e.get("PYTHONPATH")] if p]))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited with {p.returncode}:\n"
                               f"{out[-4000:]}")
    return outs


FLAGSHIP = "config/faster_r50v1_fpn_1x.py"


def dryrun_rank(config=FLAGSHIP, h=128, w=160):
    """One rank of `dryrun_multichip`: the config's train detector with a
    SyncBN backbone (full proposal and roi counts, images of h x w, batch 1
    a rank) in DDP on the CPU takes one step. Prints the losses."""
    import numpy as np

    from simpledet_torch.core.config import Normalizer, read_config
    from simpledet_torch.core.train import Trainer
    from simpledet_torch.dsl import build_detector
    from simpledet_torch.models.norm import SyncBN

    device = init_from_env("cpu")
    spec = read_config(config, is_train=True)
    spec.components["backbone"].param.normalizer = Normalizer("syncbn")
    model = build_detector(spec)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last).train()
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if n.endswith((".mean", ".var"))}
    trainer = Trainer.from_spec(model, spec, 1, seed=rank())
    gen = np.random.RandomState(rank())
    images = torch.from_numpy(gen.randint(0, 256, (1, h, w, 3), np.uint8))
    im_info = torch.tensor([[h, w, 1.0]])
    gt = torch.full((1, 100, 5), -1.0)
    gt[0, 0] = torch.tensor([20.0, 20, 100, 90, 1])
    gt[0, 1] = torch.tensor([50.0, 40, 120, 110, 7])
    losses = trainer.step(images, im_info, gt)
    assert all(torch.isfinite(v) for v in losses.values()), losses
    moved = any(not torch.equal(b, stats0[n]) for n, b in
                model.named_buffers() if n in stats0)
    assert moved and any(isinstance(m, SyncBN) for m in model.modules()), \
        "SyncBN's running statistics did not move"
    print({k: float(v) for k, v in losses.items()}, device, flush=True)
    destroy()


def dryrun_multichip(n_devices, *, config=FLAGSHIP, h=128, w=160):
    """Counterpart of `__graft_entry__.dryrun_multichip`: n_devices gloo
    ranks on the CPU, each one DDP step of the config's detector with a
    SyncBN backbone at tiny shapes (`dryrun_rank`). Returns the ranks'
    outputs; raises if a rank fails."""
    code = ("from simpledet_torch.parallel.dist import dryrun_rank; "
            f"dryrun_rank({config!r}, {h}, {w})")
    return launch_local(code, n_devices)
