"""The (data, model) device mesh and the data-parallel helpers.

Counterpart of ``debias_vision_lang_tpu/parallel/mesh.py``.  JAX runs one
controller over a ``jax.sharding.Mesh`` and lets ``shard_map`` hand each
chip its block; here a ``Mesh`` is an explicit grid of slots, each a
``torch.device``, and ``dp_shard_map`` runs a function once per data shard
on its slot's device and gathers the outputs:

  * slots may repeat a device: ``create_mesh(devices=[torch.device("cpu")] * 8)``
    is the counterpart of JAX's 8 virtual CPU devices, and
    ``create_mesh(devices=[torch.device("cuda:0")] * 4)`` runs four data
    shards on one card;
  * across processes (``init_distributed``, over ``torch.distributed``),
    the mesh spans world x local slots on the data axis, as JAX's global
    ``jax.devices()`` does: each rank computes the shards of its own slots
    and the outputs are all-gathered, so every rank ends with the same
    replicated result (JAX's ``out_specs=P()``);
  * the model axis exists (``model > 1`` is accepted, and a data shard is
    computed once, by the slot at model index 0 of its row); the
    tensor-parallel placements raise (ROADMAP.md queue 1 item 5b).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import os
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

ROADMAP_TP = "ROADMAP.md queue 1 item 5b (tensor parallel)"

# collectives run, by path ("gloo (host-staged)", "gloo", "nccl"): a reader
# of a run learns which path its gathers took
COLLECTIVES: collections.Counter = collections.Counter()


def _world() -> Tuple[int, int]:
    """(world size, rank) of the torch.distributed group, (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A ``(data, model)`` grid of slots.  ``devices[i, j]`` is the slot's
    ``torch.device`` and ``ranks[i, j]`` the process that owns it."""

    def __init__(self, devices: np.ndarray, ranks: np.ndarray,
                 axis_names: Tuple[str, str], rank: int = 0):
        self.devices = devices
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.world = int(ranks.max()) + 1

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    def data_shards(self, axis: str = DATA_AXIS) -> List[Tuple[int, torch.device]]:
        """(shard index, device) of each shard along ``axis`` that this process
        computes: the slot at index 0 of the other axis owns the shard."""
        grid_d, grid_r = self.devices, self.ranks
        if self.axis_names.index(axis) == 1:
            grid_d, grid_r = grid_d.T, grid_r.T
        return [(i, grid_d[i, 0]) for i in range(grid_d.shape[0])
                if grid_r[i, 0] == self.rank]

    @property
    def first_device(self) -> torch.device:
        """Where gathered outputs land: this process's first slot."""
        return self.data_shards()[0][1]

    def local_devices(self) -> List[torch.device]:
        """The distinct devices of this process's slots, in slot order."""
        seen: List[torch.device] = []
        for dev, r in zip(self.devices.flat, self.ranks.flat):
            if r == self.rank and dev not in seen:
                seen.append(dev)
        return seen

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, devices={sorted({str(d) for d in self.devices.flat})}"
                f", world={self.world})")


def _canonical(device) -> torch.device:
    """``cuda`` names the current card: give it its index, so slots and a
    model's parameters compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _local_cards() -> List[torch.device]:
    """This process's cards: every visible card in one process; in a world,
    the card of the rank's local index (ranks past the card count share)."""
    n = torch.cuda.device_count()
    world, rank = _world()
    if world == 1:
        return [torch.device("cuda", i) for i in range(n)]
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return [torch.device("cuda", local_rank % n)]


def create_mesh(shape: Optional[Tuple[int, int]] = None,
                axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
                devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (this process's slots), by
    default every visible card on the data axis; in a torch.distributed
    world the mesh spans world x local slots, rank-major.  Without a card
    the default raises: pass CPU devices explicitly."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("create_mesh: no CUDA device is visible; pass "
                               "devices=[torch.device('cpu')] * n for a CPU mesh")
        local = _local_cards()
    else:
        local = [_canonical(d) for d in devices]
    if not local:
        raise ValueError("create_mesh: no devices")
    world, rank = _world()
    n = world * len(local)
    if shape is None:
        shape = (n, 1)
    d, m = shape
    if d * m != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    if world > 1 and len(local) % m:
        raise ValueError(f"the model axis ({m}) must divide each process's "
                         f"{len(local)} slots, so no data row spans two ranks")
    devs = np.empty(n, dtype=object)
    for g in range(n):
        devs[g] = local[g % len(local)]
    ranks = np.repeat(np.arange(world), len(local))
    return Mesh(devs.reshape(d, m), ranks.reshape(d, m), axis_names, rank)


def default_mesh(device="cuda") -> Mesh:
    """The mesh ``mesh="auto"`` resolves to, over the devices of the type a
    model lives on: every visible card for CUDA, one slot for the CPU (one
    per process in a world)."""
    if torch.device(device).type == "cuda":
        return create_mesh()
    return create_mesh(devices=[torch.device("cpu")])


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join a torch.distributed world, the counterpart of JAX's
    ``jax.distributed.initialize`` handshake; ``create_mesh()`` and
    ``default_mesh()`` then span every rank's slots.

    Initializes only when a coordinator is named: ``coordinator_address``
    (``host:port``, or an init method such as ``tcp://...`` or
    ``file://...``), else ``$MASTER_ADDR`` / ``$MASTER_PORT`` (torchrun),
    with ``num_processes`` / ``process_id`` defaulting to ``$WORLD_SIZE`` /
    ``$RANK``.  Without a coordinator it is a no-op.  The backend is nccl
    when each rank has a card of its own, gloo on the CPU and when ranks
    share a card (NCCL refuses two ranks on one device).  Idempotent.
    Returns True when a multi-process world is up after the call."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    coord = coordinator_address
    if coord is None and os.environ.get("MASTER_ADDR"):
        coord = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coord is None:
        return False
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator is named but the world "
                         "size or rank is not (pass num_processes / process_id, "
                         "or set $WORLD_SIZE / $RANK)")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    own_cards = (torch.cuda.is_available()
                 and torch.cuda.device_count() >= local_world)
    backend = "nccl" if own_cards else "gloo"
    if own_cards:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend,
        init_method=coord if "://" in coord else f"tcp://{coord}",
        world_size=num_processes, rank=process_id)
    return dist.is_initialized() and dist.get_world_size() > 1


# ---------------------------------------------------------------------------
# Replication and batch sharding
# ---------------------------------------------------------------------------


def _device_of(obj) -> Optional[torch.device]:
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(obj, torch.nn.Module):
        for t in obj.parameters():
            return t.device
        for t in obj.buffers():
            return t.device
        return None
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for x in obj:
            dev = _device_of(x)
            if dev is not None:
                return dev
    return None


def _copy_to(obj, device: torch.device):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device)
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).to(device)
    if isinstance(obj, dict):
        return type(obj)((k, _copy_to(v, device)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_copy_to(v, device) for v in obj)
    return obj


def _version(obj) -> tuple:
    """Changes whenever a tensor of ``obj`` is written or replaced."""
    if isinstance(obj, torch.Tensor):
        return ((obj.data_ptr(), obj._version),)
    if isinstance(obj, torch.nn.Module):
        return tuple((t.data_ptr(), t._version)
                     for t in list(obj.parameters()) + list(obj.buffers()))
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return tuple(v for x in obj for v in _version(x))
    return ()


class Replicated:
    """One copy of a module or tensor tree per distinct device of a mesh;
    slots that share a device share the copy, and the copy on the source's
    own device is the source itself."""

    def __init__(self, copies: Dict[torch.device, Any]):
        self.copies = copies

    def on(self, device: torch.device):
        return self.copies[device]


def replicate_params(params, mesh: Mesh) -> Replicated:
    """Place a module or tensor tree on every device of this process's
    slots: one copy per distinct device (copies are detached)."""
    if isinstance(params, Replicated):
        return params
    home = _device_of(params)
    return Replicated({dev: params if home in (None, dev) else _copy_to(params, dev)
                       for dev in mesh.local_devices()})


# replicas made by dp_shard_map for a plain (unreplicated) first argument on
# another device, refreshed whenever a source tensor changes
_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _replica(obj, device: torch.device):
    if isinstance(obj, Replicated):
        return obj.on(device)
    if _device_of(obj) in (None, device):
        return obj
    if torch.is_grad_enabled() and isinstance(obj, torch.nn.Module):
        # a differentiable broadcast: gradients reach the source parameters
        from torch.nn.parallel import replicate

        return replicate(obj, [device], detach=False)[0]
    key = _version(obj)
    try:
        hit = _REPLICAS.get(obj, {}).get(device)
    except TypeError:  # not weak-referenceable: copy every call
        return _copy_to(obj, device)
    if hit is not None and hit[0] == key:
        return hit[1]
    rep = _copy_to(obj, device)
    _REPLICAS.setdefault(obj, {})[device] = (key, rep)
    return rep


class ShardedArray:
    """A batch split along dim 0 over one mesh axis: (shard index, rows on
    the slot's device) for each shard this process computes, and the global
    shape."""

    def __init__(self, shards: List[Tuple[int, torch.Tensor]], shape: Tuple[int, ...]):
        self.shards = shards
        self.shape = tuple(shape)


def pad_batch(a: np.ndarray, multiple: int) -> np.ndarray:
    """``a`` with zero rows appended up to a multiple of ``multiple``: a
    ragged batch made divisible for ``shard_batch_arrays`` (the caller
    slices the pad rows' outputs off)."""
    pad = -a.shape[0] % multiple
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def shard_batch_arrays(mesh: Mesh, *arrays, axis: str = DATA_AXIS):
    """Split each array (numpy or tensor) along dim 0 into ``mesh.shape[axis]``
    shards, each placed on its slot's device (this process's shards only).

    The batch MUST already be a multiple of the axis size: this does not pad
    (JAX's device_put raises on an indivisible sharding too).  Callers that
    can mask a ragged tail pad it and slice the pad rows off."""
    n_shards = mesh.shape[axis]
    out = []
    for a in arrays:
        t = _as_tensor(a)
        n = t.shape[0]
        if n % n_shards:
            raise ValueError(f"a batch of {n} rows does not divide over the "
                             f"{n_shards}-way {axis!r} axis; pad it to a multiple")
        rows = n // n_shards
        shards = [(i, t[i * rows:(i + 1) * rows].to(dev, non_blocking=True))
                  for i, dev in mesh.data_shards(axis)]
        out.append(ShardedArray(shards, tuple(t.shape)))
    return tuple(out) if len(out) > 1 else out[0]


def _device_context(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Collectives over the world's group
# ---------------------------------------------------------------------------


def collective_path(t: torch.Tensor) -> str:
    """The path a gather of ``t`` takes: NCCL on the card, gloo on the CPU,
    and gloo through host memory for a CUDA tensor under gloo (ranks that
    share a card)."""
    import torch.distributed as dist

    backend = dist.get_backend()
    if backend == "gloo" and t.is_cuda:
        return "gloo (host-staged)"
    return backend


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on each), in rank order, on
    ``t``'s device."""
    import torch.distributed as dist

    path = collective_path(t)
    COLLECTIVES[path] += 1
    src = t.detach().cpu() if path == "gloo (host-staged)" else t.detach().contiguous()
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, src)
    return [o.to(t.device) for o in outs]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t``, on ``t``'s device."""
    import torch.distributed as dist

    path = collective_path(t)
    COLLECTIVES[path] += 1
    src = t.detach().cpu().clone() if path == "gloo (host-staged)" else t.detach().clone()
    dist.all_reduce(src)
    return src.to(t.device)


class _GatherRanks(torch.autograd.Function):
    """Every rank's rows concatenated in rank order; the backward hands
    back this rank's rows of the upstream gradient.  Every rank computes
    the same loss on the gathered rows, so that slice is this rank's whole
    share: the gradients of the parameters behind the rows are summed
    across ranks afterwards (``all_reduce_sum``), once."""

    @staticmethod
    def forward(ctx, local: torch.Tensor) -> torch.Tensor:
        ctx.rows = (_world()[1] * local.shape[0], local.shape[0])
        return torch.cat(all_gather(local))

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        start, n = ctx.rows
        return grad[start:start + n]


def gather_shards(mesh: Mesh, outs: List[torch.Tensor]) -> torch.Tensor:
    """Concatenate this process's per-shard outputs in shard order on its
    first slot's device and, in a world, all-gather them across ranks
    (each rank holds the same number of equal shards; autograd flows back
    to this rank's rows)."""
    home = mesh.first_device
    local = torch.cat([o.to(home) for o in outs])
    if mesh.world == 1:
        return local
    return _GatherRanks.apply(local)


def dp_shard_map(mesh: Mesh, fn: Callable) -> Callable:
    """Data-parallel wrapper: ``run(replicated, batch)`` calls
    ``fn(replica, shard)`` once per data shard of this process, on the
    shard's slot (under ``torch.cuda.device(slot)``, so each launch goes to
    that card's stream), and returns the outputs concatenated in global
    order on this process's first slot, all-gathered across ranks in a
    world.

    ``replicated``: a ``replicate_params`` result, or a module / tensor tree
    (used as is on its own device, copied to the others); ``batch``: a
    ``ShardedArray`` or anything ``shard_batch_arrays`` splits.  The output
    is a tensor or a tuple of tensors.  Autograd flows through it; across
    processes each rank's parameters receive the gradient of its own rows
    only (sum them across ranks with ``all_reduce_sum``)."""

    def run(replicated, batch):
        shards = batch if isinstance(batch, ShardedArray) else shard_batch_arrays(mesh, batch)
        outs = []
        for _, x in shards.shards:
            with _device_context(x.device):
                outs.append(fn(_replica(replicated, x.device), x))
        if isinstance(outs[0], (tuple, list)):
            return tuple(gather_shards(mesh, list(parts)) for parts in zip(*outs))
        return gather_shards(mesh, outs)

    return run


# ---------------------------------------------------------------------------
# Tensor-parallel placements (ROADMAP.md queue 1 item 5b)
# ---------------------------------------------------------------------------


def _tp_not_ported(name: str):
    raise NotImplementedError(f"{name}: tensor-parallel placement is not ported "
                              f"yet: {ROADMAP_TP}")


def clip_param_pspecs(params, model_axis: str = MODEL_AXIS):
    """Megatron-style specs for a CLIP tree (JAX); not ported."""
    _tp_not_ported("clip_param_pspecs")


def shard_clip_params(params, mesh: Mesh):
    """CLIP weights placed by ``clip_param_pspecs`` (JAX); not ported."""
    _tp_not_ported("shard_clip_params")


def quantized_resblock_pspecs(model_axis: str = MODEL_AXIS):
    """Megatron specs for the int8 resblocks (JAX); not ported."""
    _tp_not_ported("quantized_resblock_pspecs")


def quantized_tower_pspecs(tower_q, model_axis: str = MODEL_AXIS):
    """Specs for a quantized tower tree (JAX); not ported."""
    _tp_not_ported("quantized_tower_pspecs")


def shard_quantized_clip(qmodel, mesh: Mesh):
    """A QuantizedCLIP placed tensor-parallel (JAX); not ported."""
    _tp_not_ported("shard_quantized_clip")
