"""Process groups for data-parallel training, device lists for data-parallel serving.

The port's counterpart of academicodec_tpu/parallel/mesh.py (``make_mesh``,
``shard_batch``, ``replicate``, :1-59). JAX gets global-batch semantics from
GSPMD: one program over a ``data`` mesh axis, whose gradient and codebook
sums come out as collectives the compiler inserts. The port spells those
collectives out over a ``torch.distributed`` process group, one process per
card as ``torchrun`` starts them:

* :func:`init_from_env` joins the group from the ``torchrun`` environment
  (NCCL for CUDA devices, gloo for the CPU);
* :func:`shard_batch` is the rank-major block of a global batch that rank
  ``r`` holds, the inverse of JAX's ``make_array_from_process_local_data``
  assembly (:34-51);
* :func:`replicate` broadcasts rank 0's tensors (JAX ``replicate``, :54-57);
* :func:`all_reduce_mean_grads` averages a module's gradients in one flat
  all-reduce; :func:`all_reduce_sum_` sums tensors in place;
  :func:`all_gather_rows` concatenates every rank's rows, rank-major.

Every helper takes the group as ``group``; ``None`` means no group, and then
the helper is the identity and issues no collective. With a group of any
size, world 1 included, it issues its collective. Gloo has no
``all_gather`` for CUDA tensors (torch.distributed's backend table), so
under gloo :func:`all_gather_rows` goes through host copies.

Serving (JAX ``SoundStreamCompressor(mesh=)``, codec/compress.py:116-149) is
one process over the local cards: :func:`serving_devices` reads the device
list, :func:`module_replicas` puts one copy of the model on each, and
:func:`split_rows` cuts a batch into one equal contiguous block per device.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

Group = Optional[dist.ProcessGroup]


def missing_torchrun_env() -> List[str]:
    """The variables of :data:`TORCHRUN_ENV` that this process lacks."""
    return [k for k in TORCHRUN_ENV if k not in os.environ]


def init_from_env(device: Union[str, torch.device] = "cuda",
                  backend: Optional[str] = None) -> Tuple[dist.ProcessGroup, torch.device]:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) -> ``(group,
    this rank's device)``. ``device`` names the device type; a CUDA device
    without an index becomes ``cuda:LOCAL_RANK``. ``backend`` defaults to NCCL
    for CUDA and gloo for the CPU; gloo on CUDA tensors is allowed (several
    ranks on one card)."""
    missing = missing_torchrun_env()
    if missing:
        raise RuntimeError(f"no torchrun environment ({', '.join(missing)} unset): launch with "
                           "torchrun --nproc_per_node N -m <module> ...")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.group.WORLD, device


def rank(group: Group = None) -> int:
    """This process's rank in ``group``; 0 without one."""
    return 0 if group is None else dist.get_rank(group)


def world_size(group: Group = None) -> int:
    """The size of ``group``; 1 without one."""
    return 1 if group is None else dist.get_world_size(group)


def shard_batch(global_rows, rank: int, world: int):
    """Rank ``rank``'s rows of a global batch: the ``rank``-th of ``world`` equal
    contiguous blocks, so that the rank-major concatenation of every rank's
    block is the global batch."""
    n = len(global_rows)
    if n % world:
        raise ValueError(f"a global batch of {n} rows does not split over {world} ranks")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} not in [0, {world})")
    per = n // world
    return global_rows[rank * per:(rank + 1) * per]


def _flat_apply(tensors: Sequence[torch.Tensor], fn: Callable[[torch.Tensor], None]) -> None:
    """Run ``fn`` on one flat buffer per dtype of ``tensors`` (bool as uint8) and
    copy the result back into each tensor."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        wire = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([t.detach().reshape(-1).to(wire) for t in ts])
        fn(flat)
        offset = 0
        for t in ts:
            n = t.numel()
            t.detach().copy_(flat[offset:offset + n].view_as(t).to(dtype))
            offset += n


def _tensors(module_or_tensors) -> List[torch.Tensor]:
    if isinstance(module_or_tensors, nn.Module):
        return list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
    return list(module_or_tensors)


def replicate(module_or_tensors, group: Group = None, src: int = 0) -> None:
    """Overwrite every parameter and buffer of a module (or each tensor of a
    sequence) with rank ``src``'s, in one broadcast per dtype."""
    if group is None:
        return
    with torch.no_grad():
        _flat_apply(_tensors(module_or_tensors), lambda flat: dist.broadcast(flat, src, group=group))


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group: Group = None) -> None:
    """Replace each tensor by its sum over the ranks, in one all-reduce per dtype."""
    if group is None:
        return
    with torch.no_grad():
        _flat_apply(tensors, lambda flat: dist.all_reduce(flat, group=group))


def all_reduce_mean_grads(module: nn.Module, group: Group = None) -> None:
    """Average the module's gradients over the ranks: one flat all-reduce (sum),
    then a division by the world size. Every rank must hold gradients for the
    same parameters."""
    if group is None:
        return
    world = dist.get_world_size(group)
    grads = [p.grad for p in module.parameters() if p.grad is not None]

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(world)

    with torch.no_grad():
        _flat_apply(grads, mean)


def all_gather_rows(t: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all) concatenated on dim 0, rank-major."""
    if group is None:
        return t
    parts_of = t
    if t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        parts_of = t.cpu()
    parts = [torch.empty_like(parts_of) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, parts_of.contiguous(), group=group)
    return torch.cat(parts).to(t.device)


def serving_devices(spec: str) -> List[torch.device]:
    """The devices of data-parallel serving: a comma-separated list (``cuda:0,cuda:1``,
    ``cpu,cpu``), or one device type, which means every visible card for ``cuda``
    and one replica for ``cpu``."""
    names = [s.strip() for s in spec.split(",") if s.strip()]
    if len(names) == 1 and names[0] == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(n) for n in names]


def module_replicas(module: nn.Module, devices: Sequence[torch.device]) -> List[nn.Module]:
    """One copy of ``module`` on each device; the module itself stands for a
    device it already lies on, the first time that device is listed."""
    own = next(module.parameters()).device
    out, used = [], False
    for dev in devices:
        if torch.device(dev) == own and not used:
            out.append(module)
            used = True
        else:
            out.append(copy.deepcopy(module).to(dev))
    return out


def split_rows(batch: int, parts: int) -> List[slice]:
    """``parts`` equal contiguous blocks of a batch of ``batch`` rows (JAX
    codec/compress.py:262-267 refuses a batch that does not divide)."""
    if batch % parts:
        raise ValueError(f"data-parallel serving needs the batch ({batch}) divisible by the device count "
                         f"({parts}); use pad_to_batch / --batch_files at a multiple")
    n = batch // parts
    return [slice(i * n, (i + 1) * n) for i in range(parts)]


def microbatches(x: torch.Tensor, k: int, group: Group = None) -> torch.Tensor:
    """This rank's rows of each of the ``k`` microbatches of a step -> ``[k, B /
    (k W), ...]``, from its local rows ``x`` (the rank-major block of the global
    batch of ``B`` rows). JAX reshapes the global batch, so its microbatch ``i``
    is global rows ``[i B/k, (i+1) B/k)`` (academicodec_tpu/train/encodec.py:335);
    rank ``r`` takes the ``r``-th of ``W`` equal blocks of each. For ``k > 1`` the
    step's global batch is gathered first."""
    world = world_size(group)
    B = x.shape[0] * world
    if B % k:
        raise ValueError(f"batch {B} not divisible by accum_steps {k}")
    if (B // k) % world:
        raise ValueError(f"microbatches of {B // k} rows (batch {B}, accum_steps {k}) do not split over "
                         f"{world} ranks")
    if k == 1 or group is None:
        return x.reshape(k, -1, *x.shape[1:])
    return all_gather_rows(x, group).reshape(k, world, B // (k * world), *x.shape[1:])[:, rank(group)]


def all_reduce_mean_metrics(metrics: Dict[str, torch.Tensor], group: Group = None) -> Dict[str, torch.Tensor]:
    """0-dim metrics averaged over the ranks, in one all-reduce: each rank's
    metric is a mean over its equal share of the global batch, so their mean
    is the global batch's."""
    if group is None:
        return metrics
    names = list(metrics)
    values = torch.stack([metrics[n].detach().float() for n in names])
    dist.all_reduce(values, group=group)
    values.div_(dist.get_world_size(group))
    return dict(zip(names, values.unbind()))
