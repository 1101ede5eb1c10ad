"""Multi-device parallelism over torch.distributed
(vcr_gaus_tpu/parallel/dp.py).

Two modes, as in the JAX package:

  * **scene-DP**: one scene per device, share-nothing: ``scene_dispatch``
    hands each scene's closure its own ``torch.device``;
  * **camera-DP**: a camera batch split over the ranks of a process group,
    each rank rendering its contiguous share; the gradients, the densify
    dummy's gradient and the losses are all-reduced as a mean (one
    flattened ``all_reduce``), radii, visibility and the entry count as a
    maximum, before the Adam update that every rank runs on identical
    inputs. ``make_camera_dp_step`` is the standalone l1 + SSIM step;
    the trainer's own step (``train.trainer.make_train_step``) reduces
    through ``reduce_mean`` and ``reduce_max``.

A process group is joined with ``init_process_group``: NCCL for CUDA
devices, gloo for the CPU, and no fall back from one to the other.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..data.cameras import CameraArrays
from ..models import gaussians as GM
from ..render.renderer import RenderConfig, render
from ..train import losses as L


def backend_for(device: str | torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device type {kind!r}")


def init_process_group(rank: int, world_size: int, init_method: str,
                       device: str | torch.device) -> str:
    """Join the default process group as ``rank`` of ``world_size`` at
    ``init_method`` (``tcp://host:port``, ``file://path`` or ``env://``)
    with the device's backend. A failed init raises; there is no other
    backend to fall back to. Returns the backend."""
    backend = backend_for(device)
    dev = torch.device(device)
    if backend == "nccl":
        if dev.index is None:
            raise ValueError("a CUDA device of a process group needs its "
                             "index (cuda:<local rank>)")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend


def initialized() -> bool:
    """Whether the default process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) when none
    is initialised."""
    if not initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if initialized():
        dist.barrier()


def stack_cameras(cams: list[CameraArrays]) -> CameraArrays:
    """Cameras of one size as one CameraArrays with a leading batch axis."""
    return CameraArrays(*(torch.stack(xs) for xs in zip(*cams)))


def shard_camera_batch(cams: CameraArrays, rank: int | None = None,
                       world_size: int | None = None) -> CameraArrays:
    """This rank's contiguous slice of a stacked camera batch, as the JAX
    package's ``P(axis)`` sharding gives chip r its slice. The batch must
    be a multiple of the world size."""
    r, w = world()
    rank = r if rank is None else rank
    world_size = w if world_size is None else world_size
    batch = cams.viewmatrix.shape[0]
    if batch % world_size:
        raise ValueError(f"camera batch {batch} not divisible by the world "
                         f"size {world_size}")
    k = batch // world_size
    return CameraArrays(*(x[rank * k:(rank + 1) * k] for x in cams))


def leaves(obj) -> list[torch.Tensor]:
    """The tensors of a state, dataclass, list, tuple or dict, in a fixed
    order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in leaves(getattr(obj, f.name))]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in leaves(x)]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in leaves(obj[k])]
    return []


def replicate(tree, src: int = 0):
    """Broadcast every tensor of ``tree`` (a GaussianState, a dataclass, a
    list or dict of tensors) from rank ``src`` in place; returns ``tree``.
    Nothing moves without a process group."""
    if not initialized():
        return tree
    with torch.no_grad():
        for t in leaves(tree):
            # a collective takes a contiguous buffer, and bool as bytes
            buf = (t.to(torch.uint8) if t.dtype == torch.bool
                   else t.contiguous())
            dist.broadcast(buf, src)
            if buf is not t:
                t.copy_(buf)
    return tree


def reduce_mean(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over the ranks of each float32 tensor: one flattened
    ``all_reduce(SUM)`` times 1/W (the JAX package's ``pmean``)."""
    _, w = world()
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat = flat * (1.0 / w)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def reduce_max(radii: torch.Tensor, visibility: torch.Tensor,
               num_entries: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The maximum over the ranks of the radii, the visibility (an OR) and
    the entry count (the JAX package's ``pmax``), in one float64
    ``all_reduce(MAX)``: exact for integers below 2^53."""
    n = radii.numel()
    flat = torch.cat([radii.reshape(-1).to(torch.float64),
                      visibility.reshape(-1).to(torch.float64),
                      radii.new_tensor([num_entries], dtype=torch.float64)])
    dist.all_reduce(flat, op=dist.ReduceOp.MAX)
    return (flat[:n].view(radii.shape).to(radii.dtype),
            flat[n:2 * n].view(visibility.shape) > 0, int(flat[-1].item()))


def make_camera_dp_step(rcfg: RenderConfig, weights: dict | None = None,
                        scene_extent: float = 1e9):
    """The standalone data-parallel step of the JAX package:
    step(state, cam_shard, bg, lr_xyz) -> (state, loss). ``cam_shard`` is
    this rank's share of a stacked batch (``shard_camera_batch``), one
    camera per rank; the l1 + SSIM loss at SH degree 0, its gradient
    all-reduced as a mean, then Adam with fixed learning rates, so that
    the state stays identical on every rank."""
    weights = weights or {"l1": 0.8, "ssim": 0.2}

    def step(state: GM.GaussianState, cam_shard: CameraArrays,
             bg: torch.Tensor, lr_xyz: float):
        cam = CameraArrays(*(x[0] for x in cam_shard))
        params = state.params.map(lambda p: p.detach().requires_grad_(True))
        st = state.replace(params=params)
        out = render(st, cam, rcfg, bg, sh_degree=0,
                     scene_extent=scene_extent)
        total = weights.get("l1", 0) * L.l1_loss(out["render"], cam.image)
        if weights.get("ssim", 0):
            total = total + weights["ssim"] * (
                1 - L.ssim(out["render"], cam.image))
        tensors = list(params.as_dict().values())
        grads = torch.autograd.grad(total, tensors, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(tensors, grads)]
        *grads, loss = reduce_mean(grads + [total.detach()])
        with torch.no_grad():
            g_params = GM.mask_grads(GM.GaussianParams(*grads), state.active)
            lrs = GM.LearningRates(xyz=lr_xyz, f_dc=0.0025,
                                   f_rest=0.0025 / 20, opacity=0.05,
                                   scaling=0.005, rotation=0.001,
                                   obj_dc=0.0025)
            return GM.adam_step(state, g_params, lrs), loss

    return step


def scene_dispatch(scene_fns: list[Callable[[torch.device], object]],
                   devices: list[str | torch.device],
                   parallel: bool = False) -> list:
    """Share-nothing scene parallelism: ``scene_fns[i](device)`` runs with
    its own explicit device. Sequential mode: scene i on device i % n.
    Parallel mode: a thread pool whose threads draw a device from a queue
    for each scene and return it after, so no two scenes share a device at
    once; a CUDA device is also made the thread's current one. Returns the
    results in the order of ``scene_fns``."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("scene_dispatch needs at least one device")

    def call(fn, dev):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return fn(dev)
        return fn(dev)

    if not parallel:
        return [call(fn, devs[i % len(devs)])
                for i, fn in enumerate(scene_fns)]

    import queue
    from concurrent.futures import ThreadPoolExecutor
    pool: queue.Queue = queue.Queue()
    for d in devs:
        pool.put(d)

    def run(fn):
        d = pool.get()
        try:
            return call(fn, d)
        finally:
            pool.put(d)

    with ThreadPoolExecutor(max_workers=len(devs)) as ex:
        futs = [ex.submit(run, fn) for fn in scene_fns]
        return [f.result() for f in futs]
