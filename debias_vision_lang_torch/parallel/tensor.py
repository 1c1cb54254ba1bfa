"""Tensor parallel: the Megatron head and hidden splits of every resblock
over a mesh's model axis.

The JAX package keeps all of this in ``debias_vision_lang_tpu/parallel/
mesh.py`` (``clip_param_pspecs`` .. ``shard_quantized_clip``): it places
the stacked resblock weights by PartitionSpecs and GSPMD inserts the
collectives.  Here the placement is explicit: ``parallel/mesh.py`` holds
the five functions, this module the split and the blocks that run it.

  * The split (``head_columns``, ``check_split``): slot j of a model row of
    m slots takes the q, k and v columns of heads [j g, (j + 1) g), g = H /
    m, and those heads' rows of wo; the hidden columns [j F/m, (j + 1) F/m)
    of w1 and b1, and those rows of w2.  JAX splits the packed [D, 3D] wqkv
    contiguously (at m = 2 a boundary falls inside k, and GSPMD reshards);
    the head split permutes wqkv's columns into head groups and computes
    the same function.  H % m or F % m != 0 is refused with a ValueError
    naming the shape (JAX reshards there).  The int8 weights split alike: a
    column-parallel q with its per-output-channel scale, a row-parallel q
    with the whole scale (JAX's ``quantized_resblock_pspecs``).
  * ``TensorParallelBlocks`` / ``TensorParallelQBlocks``: a tower's blocks so
    split, one shard per (model index, device) of the mesh, as an
    ``nn.ModuleList`` of per-layer blocks (the layer index leads every
    parameter name, which the freezing policy reads).  They carry the
    protocol the towers call, so that neither ``models/`` nor
    ``ops/quant.py`` knows these classes: blocks with a ``run`` method run
    themselves (``run`` the tower, ``block`` one block, and for the float
    blocks ``attention`` / ``mlp`` one half).  On activations they split the
    batch over this process's model rows (the data axis) and run each block
    over a row's m slots:
      - "plain" (float32 on the plain layers, JAX's ``use_pallas=False``
        route; autograd flows): per slot LN(x) -> its heads' QKV -> the
        attention -> attn_g @ wo_g, then x + (sum + bo); the MLP alike;
      - "fused" (bfloat16 on the CUDA kernels, their twins on the CPU):
        ``attention_block_heads`` / ``mlp_block_cols`` per slot and one
        ``tp_reduce`` per half; where a gradient is wanted, the kernels
        forward and the twins' recompute backward (``_FusedTPBlockFn``, the
        pattern of ``fused_transformer_diff``);
      - int8: each slot's row amax of the row-parallel input (attention
        output, MLP hidden) is maxed across the row before that input is
        quantized, and the int32 partials are summed exactly before one
        dequantize: the codes and the integer sums are the unsharded
        block's, so an int8 tensor-parallel tower is bit-equal to the
        unsharded one (JAX dequantizes each partial, then psums).
A model row never spans processes (``create_mesh``), so the partials meet
on the row's slot 0 by a device copy (none when the slots share a card) and
the block's output goes back to every slot as the next block's input; no
collective runs.  In a torch.distributed world each rank runs its own rows.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.layers import (attention_heads, causal_mask, gelu, linear, ln_f32,
                             quick_gelu)
from ..ops import fused_block as fb
from ..ops import fused_block_q as fbq
from .mesh import MODEL_AXIS, Mesh

ACTS = {"quick_gelu": quick_gelu, "gelu": gelu}
ROUTES = ("plain", "fused")


def check_split(d: int, heads: int, f: int, m: int) -> None:
    """Raise unless ``heads`` and the MLP's ``f`` hidden columns divide over
    ``m`` model slots."""
    if m < 1 or m > fb.MAX_TP_SLOTS:
        raise ValueError(f"the model axis takes 1 to {fb.MAX_TP_SLOTS} slots, got {m}")
    if heads % m:
        raise ValueError(f"tensor parallel over {m} model slots splits the attention "
                         f"heads into equal groups: H={heads} (D={d}) % {m} != 0")
    if f % m:
        raise ValueError(f"tensor parallel over {m} model slots splits the MLP hidden "
                         f"columns into equal groups: F={f} (D={d}) % {m} != 0")


def head_columns(d: int, m: int, j: int) -> torch.Tensor:
    """The columns of a packed [D, 3D] wqkv (q | k | v) that slot j of m
    takes: q, then k, then v of its heads [j g, (j + 1) g) (heads are
    contiguous 64-column groups of each third, so the group's columns are
    [j D/m, (j + 1) D/m) of each)."""
    lo, hi = j * d // m, (j + 1) * d // m
    return torch.cat([torch.arange(lo, hi) + i * d for i in range(3)])


def _slices(d: int, f: int, m: int, j: int):
    """(wo rows, hidden columns) of slot j."""
    return slice(j * d // m, (j + 1) * d // m), slice(j * f // m, (j + 1) * f // m)


def _copy(t: torch.Tensor, device) -> torch.Tensor:
    return t.detach().to(device, copy=True).contiguous()


def _param(t: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(_copy(t, device), requires_grad=t.requires_grad)


def _layer_norm(src, device) -> nn.Module:
    ln = nn.Module()
    ln.scale = _param(src.scale, device)
    ln.bias = _param(src.bias, device)
    return ln


def _on(t: torch.Tensor, device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


class _Row:
    """One model row of this process: the shard index and device of each of
    its m slots."""

    def __init__(self, shards: List[int], devices: List[torch.device]):
        self.shards, self.devices = shards, devices


def _placement(mesh: Mesh):
    """(the distinct (model index, device) pairs of this process's slots,
    its rows, m)."""
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(f"the mesh has no {MODEL_AXIS!r} axis: {mesh.axis_names}")
    grid, ranks = mesh.devices, mesh.ranks
    if mesh.axis_names.index(MODEL_AXIS) == 0:
        grid, ranks = grid.T, ranks.T
    keys: list = []
    rows: List[_Row] = []
    for i in range(grid.shape[0]):
        if ranks[i, 0] != mesh.rank:
            continue
        shards = []
        for j in range(grid.shape[1]):
            key = (j, grid[i, j])
            if key not in keys:
                keys.append(key)
            shards.append(keys.index(key))
        rows.append(_Row(shards, list(grid[i])))
    if not rows:
        raise ValueError(f"process {mesh.rank} owns no model row of {mesh}")
    return keys, rows, grid.shape[1]


class _SplitBlocks(nn.ModuleList):
    """The per-layer blocks of a tower under a mesh, and the data split."""

    def _setup(self, mesh: Mesh, heads: int, rows: List[_Row]) -> None:
        self.mesh, self.heads, self.rows = mesh, heads, rows
        self.m = len(rows[0].shards)
        self.g = heads // self.m

    def _over_rows(self, x: torch.Tensor, fn) -> torch.Tensor:
        """``fn(row, chunk)`` on the chunk of x's batch each of this process's
        rows takes (on its slot 0), gathered in order on x's device."""
        outs = []
        for row, chunk in zip(self.rows, x.tensor_split(len(self.rows))):
            if chunk.shape[0]:
                outs.append(_on(fn(row, _on(chunk, row.devices[0])), x.device))
        if not outs:
            return x
        return outs[0] if len(outs) == 1 else torch.cat(outs)


# ---------------------------------------------------------------------------
# float32 / bfloat16 blocks
# ---------------------------------------------------------------------------


class SlotShard(nn.Module):
    """Slot j's share of one block's matrices: ``wqkv`` [D, 3D/m] (its heads'
    q | k | v columns), ``bqkv``, ``wo`` [D/m, D] (those heads' rows),
    ``w1`` [D, F/m], ``b1`` [F/m], ``w2`` [F/m, D]; copies on the slot's
    device."""

    def __init__(self, blk, m: int, j: int, device):
        super().__init__()
        a, p = blk.attn, blk.mlp
        d, f = a.wo.shape[0], p.w1.shape[1]
        cols = head_columns(d, m, j).to(a.wqkv.device)
        rows, hidden = _slices(d, f, m, j)
        self.wqkv = _param(a.wqkv[:, cols], device)
        self.bqkv = _param(a.bqkv[cols], device)
        self.wo = _param(a.wo[rows], device)
        self.w1 = _param(p.w1[:, hidden], device)
        self.b1 = _param(p.b1[hidden], device)
        self.w2 = _param(p.w2[hidden], device)

    def tensors(self):
        return (self.wqkv, self.bqkv, self.wo, self.w1, self.b1, self.w2)


class TPBlock(nn.Module):
    """One resblock split over the model axis: the replicated LayerNorms and
    row-parallel biases (``bo``, ``b2``) on the mesh's first device, and one
    ``SlotShard`` per (model index, device)."""

    def __init__(self, blk, m: int, keys, home):
        super().__init__()
        self.ln_1 = _layer_norm(blk.ln_1, home)
        self.ln_2 = _layer_norm(blk.ln_2, home)
        self.bo = _param(blk.attn.bo, home)
        self.b2 = _param(blk.mlp.b2, home)
        self.slots = nn.ModuleList(SlotShard(blk, m, j, dev) for j, dev in keys)

    def replicated(self):
        return (self.ln_1.scale, self.ln_1.bias, self.bo,
                self.ln_2.scale, self.ln_2.bias, self.b2)


def _fused_block_row(y, rep, slot_ts, devices, g, act_kind, causal, twin):
    """One block over a row's slots through the split entries (``twin``: their
    plain twins, the backward's recompute)."""
    attn = fb.attention_block_heads_plain if twin else fb.attention_block_heads
    mlp = fb.mlp_block_cols_plain if twin else fb.mlp_block_cols
    reduce = fb.tp_reduce_plain if twin else fb.tp_reduce
    ln1s, ln1b, bo, ln2s, ln2b, b2 = rep
    home = y.device
    parts = [_on(attn(_on(y, dev), _on(ln1s, dev), _on(ln1b, dev), *ts[:3], heads=g,
                      causal=causal), home) for ts, dev in zip(slot_ts, devices)]
    y = reduce(parts, _on(bo, home), y, bias_first=False)
    parts = [_on(mlp(_on(y, dev), _on(ln2s, dev), _on(ln2b, dev), *ts[3:],
                     act_kind=act_kind), home) for ts, dev in zip(slot_ts, devices)]
    return reduce(parts, _on(b2, home), y, bias_first=True)


class _FusedTPBlockFn(torch.autograd.Function):
    """Forward through the split kernels (``_fused_block_row``), backward by
    autograd through their twins recomputed from the saved inputs: the
    gradients of the function the forward evaluated, for the activations and
    every tensor of the block (``fused_block._FusedResblockFn``'s pattern)."""

    @staticmethod
    def forward(ctx, cfg, y, *tensors):
        ctx.cfg = cfg
        ctx.save_for_backward(y, *tensors)
        devices, g, act_kind, causal = cfg
        return _fused_block_row(y, tensors[:6], _per_slot(tensors[6:]), devices, g,
                                act_kind, causal, twin=False)

    @staticmethod
    def backward(ctx, grad):
        devices, g, act_kind, causal = ctx.cfg
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = _fused_block_row(inputs[0], inputs[1:7], _per_slot(inputs[7:]), devices, g,
                                   act_kind, causal, twin=True)
            wanted = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return (None,) + tuple(next(grads) if n else None for n in need)


def _per_slot(flat):
    return [tuple(flat[i:i + 6]) for i in range(0, len(flat), 6)]


class TensorParallelBlocks(_SplitBlocks):
    """A float tower's resblocks split over ``mesh``'s model axis (see the
    module docstring); ``heads`` is the tower's head count."""

    def __init__(self, blocks, mesh: Mesh, heads: int):
        blk0 = blocks[0]
        d, f = blk0.attn.wo.shape[0], blk0.mlp.w1.shape[1]
        keys, rows, m = _placement(mesh)
        check_split(d, heads, f, m)
        super().__init__(TPBlock(blk, m, keys, mesh.first_device) for blk in blocks)
        self._setup(mesh, heads, rows)

    def run(self, x: torch.Tensor, *, route: str = "plain",
            act_kind: str = "quick_gelu", causal: bool = False,
            use_pallas: Optional[bool] = None, remat: bool = False) -> torch.Tensor:
        """The whole tower on [B, S, D] activations."""
        def tower(row, y):
            for blk in self:
                y = self._block(blk, row, y, route, act_kind, causal, use_pallas, remat)
            return y

        return self._over_rows(x, tower)

    def block(self, i: int, x: torch.Tensor, *, route: str = "plain",
              act_kind: str = "quick_gelu", causal: bool = False,
              use_pallas: Optional[bool] = None, remat: bool = False) -> torch.Tensor:
        """Block ``i`` alone."""
        return self._over_rows(x, lambda row, y: self._block(
            self[i], row, y, route, act_kind, causal, use_pallas, remat))

    def attention(self, i: int, x: torch.Tensor, *, causal: bool = False,
                  use_pallas: Optional[bool] = None) -> torch.Tensor:
        """x + the attention half of block ``i`` on the plain route (x may
        carry extra leading dims)."""
        return self._over_rows(x, lambda row, y: self._attn_plain(self[i], row, y, causal,
                                                                  use_pallas))

    def mlp(self, i: int, x: torch.Tensor, *, act_kind: str = "quick_gelu") -> torch.Tensor:
        """x + the MLP half of block ``i`` on the plain route."""
        return self._over_rows(x, lambda row, y: self._mlp_plain(self[i], row, y, act_kind))

    def _block(self, blk, row, y, route, act_kind, causal, use_pallas, remat):
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        if route == "plain":
            def plain(y):
                y = self._attn_plain(blk, row, y, causal, use_pallas)
                return self._mlp_plain(blk, row, y, act_kind)

            return checkpoint(plain, y, use_reentrant=False) if remat else plain(y)
        slots = [blk.slots[k] for k in row.shards]
        slot_ts = [s.tensors() for s in slots]
        rep = blk.replicated()
        if torch.is_grad_enabled() and (y.requires_grad or any(
                t.requires_grad for t in rep + tuple(t for ts in slot_ts for t in ts))):
            flat = [t for ts in slot_ts for t in ts]
            return _FusedTPBlockFn.apply((row.devices, self.g, act_kind, causal), y, *rep,
                                         *flat)
        return _fused_block_row(y, rep, slot_ts, row.devices, self.g, act_kind, causal,
                                twin=False)

    def _attn_plain(self, blk, row, y, causal, use_pallas):
        home, dt = y.device, y.dtype
        parts = []
        for k, dev in zip(row.shards, row.devices):
            sh = blk.slots[k]
            xj = _on(y, dev)
            xn = ln_f32(xj, _on(blk.ln_1.scale, dev), _on(blk.ln_1.bias, dev))
            mask = causal_mask(xj.shape[-2], dev) if causal else None
            o = attention_heads(linear(xn, sh.wqkv, sh.bqkv), self.g, mask, use_pallas)
            parts.append(_on(o @ sh.wo.to(dt), home))
        return y + (sum(parts[1:], parts[0]) + blk.bo.to(home, dt))

    def _mlp_plain(self, blk, row, y, act_kind):
        home, dt = y.device, y.dtype
        parts = []
        for k, dev in zip(row.shards, row.devices):
            sh = blk.slots[k]
            xj = _on(y, dev)
            xn = ln_f32(xj, _on(blk.ln_2.scale, dev), _on(blk.ln_2.bias, dev))
            h = ACTS[act_kind](linear(xn, sh.w1, sh.b1))
            parts.append(_on(h @ sh.w2.to(dt), home))
        return y + (sum(parts[1:], parts[0]) + blk.b2.to(home, dt))


# ---------------------------------------------------------------------------
# int8 blocks
# ---------------------------------------------------------------------------


class QSlice(nn.Module):
    """A slice of an ``ops/quant.QWeight``: ``q`` [in, out] int8, ``scale``
    [1, out] f32 and ``qt`` [out, in], the names the int8 layers read."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, device):
        super().__init__()
        self.register_buffer("q", _copy(q, device))
        self.register_buffer("scale", _copy(scale, device))
        self.register_buffer("qt", self.q.t().contiguous())


class QSlotShard(nn.Module):
    """Slot j's share of an int8 block (``ops/quant.QuantBlock``): the column-
    parallel ``wqkv`` / ``w1`` with their scale slices, the row-parallel
    ``wo`` / ``w2`` rows with the whole scale, ``bqkv`` and ``b1`` slices."""

    def __init__(self, qblk, m: int, j: int, device):
        super().__init__()
        d, f = qblk.wo.q.shape[0], qblk.w1.q.shape[1]
        cols = head_columns(d, m, j).to(qblk.wqkv.q.device)
        rows, hidden = _slices(d, f, m, j)
        self.wqkv = QSlice(qblk.wqkv.q[:, cols], qblk.wqkv.scale[:, cols], device)
        self.wo = QSlice(qblk.wo.q[rows], qblk.wo.scale, device)
        self.w1 = QSlice(qblk.w1.q[:, hidden], qblk.w1.scale[:, hidden], device)
        self.w2 = QSlice(qblk.w2.q[hidden], qblk.w2.scale, device)
        self.register_buffer("bqkv", _copy(qblk.bqkv[cols], device))
        self.register_buffer("b1", _copy(qblk.b1[hidden], device))


class TPQBlock(nn.Module):
    """One int8 resblock split over the model axis (``TPBlock``'s layout)."""

    def __init__(self, qblk, m: int, keys, home):
        super().__init__()
        self.ln_1 = _layer_norm(qblk.ln_1, home)
        self.ln_2 = _layer_norm(qblk.ln_2, home)
        self.register_buffer("bo", _copy(qblk.bo, home))
        self.register_buffer("b2", _copy(qblk.b2, home))
        self.slots = nn.ModuleList(QSlotShard(qblk, m, j, dev) for j, dev in keys)


def _int8_linear(x: torch.Tensor, w, bias) -> torch.Tensor:
    """``ops/quant.int8_matmul``: per-row int8 x, exact product, dequantize,
    + bias, in x's dtype."""
    xq, xs = fbq.quant_rows(x.float())
    return (fbq.dot_q(xq, xs, w.q, w.scale, w.qt) + bias.float()).to(x.dtype)


class TensorParallelQBlocks(_SplitBlocks):
    """An int8 tower's resblocks (``ops/quant.quantize_resblocks``) split over
    ``mesh``'s model axis.  Route "fused": the int8 split kernels on a card
    (bfloat16 activations), their twins on the CPU; "plain": the plain int8
    layers (float32 activations, JAX's XLA int8 path)."""

    def __init__(self, qblocks, mesh: Mesh, heads: int):
        q0 = qblocks[0]
        d, f = q0.wo.q.shape[0], q0.w1.q.shape[1]
        keys, rows, m = _placement(mesh)
        check_split(d, heads, f, m)
        super().__init__(TPQBlock(qb, m, keys, mesh.first_device) for qb in qblocks)
        self._setup(mesh, heads, rows)

    def run(self, x: torch.Tensor, *, route: str = "fused",
            act_kind: str = "quick_gelu", causal: bool = False) -> torch.Tensor:
        """The whole tower on [B, S, D] activations."""
        def tower(row, y):
            for blk in self:
                y = self._block(blk, row, y, route, act_kind, causal)
            return y

        return self._over_rows(x, tower)

    def block(self, i: int, x: torch.Tensor, *, route: str = "fused",
              act_kind: str = "quick_gelu", causal: bool = False) -> torch.Tensor:
        return self._over_rows(x, lambda row, y: self._block(self[i], row, y, route,
                                                             act_kind, causal))

    def _block(self, blk, row, y, route, act_kind, causal):
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        slots = [blk.slots[k] for k in row.shards]
        if route == "fused":
            return self._fused(blk, slots, row.devices, y, act_kind, causal)
        return self._plain(blk, slots, row.devices, y, act_kind, causal)

    @staticmethod
    def _row_parallel(inputs, amaxes, weights, home, kernel: bool):
        """Each slot's input quantized at the row's global scale times its
        rows of the weight: the int32 partials on ``home`` and slot 0's row
        scales."""
        fn = fbq.rows_q_partial if kernel else (
            lambda a, am, q, w_qt=None: fbq.rows_q_partial_plain(a, am, q))
        parts, scale0 = [], None
        for a, w in zip(inputs, weights):
            acc, _, scale = fn(a, [_on(t, a.device) for t in amaxes], w.q, w_qt=w.qt)
            parts.append(_on(acc, home))
            scale0 = _on(scale, home) if scale0 is None else scale0
        return parts, scale0

    def _fused(self, blk, slots, devices, y, act_kind, causal):
        home = y.device
        out = [fbq.attention_block_q_heads(
            _on(y, dev), _on(blk.ln_1.scale, dev), _on(blk.ln_1.bias, dev), sh.wqkv.q,
            sh.wqkv.scale, sh.bqkv, heads=self.g, causal=causal, wqkv_qt=sh.wqkv.qt)
            for sh, dev in zip(slots, devices)]
        parts, scale = self._row_parallel([a for a, _ in out], [m for _, m in out],
                                          [sh.wo for sh in slots], home, True)
        y = fbq.tp_reduce_q(parts, scale, _on(slots[0].wo.scale, home), _on(blk.bo, home), y,
                            bias_first=False)
        out = [fbq.mlp_block_q_cols(
            _on(y, dev), _on(blk.ln_2.scale, dev), _on(blk.ln_2.bias, dev), sh.w1.q,
            sh.w1.scale, sh.b1, act_kind=act_kind, w1_qt=sh.w1.qt)
            for sh, dev in zip(slots, devices)]
        parts, scale = self._row_parallel([h for h, _ in out], [m for _, m in out],
                                          [sh.w2 for sh in slots], home, True)
        return fbq.tp_reduce_q(parts, scale, _on(slots[0].w2.scale, home), _on(blk.b2, home),
                               y, bias_first=True)

    def _plain(self, blk, slots, devices, y, act_kind, causal):
        """``ops/quant.resblock_q`` split: x + int8_matmul(o, wo, bo) with o's
        rows quantized at their global scale, the int32 partials summed."""
        home, dt = y.device, y.dtype
        outs = []
        for sh, dev in zip(slots, devices):
            xj = _on(y, dev)
            qkv = _int8_linear(ln_f32(xj, _on(blk.ln_1.scale, dev), _on(blk.ln_1.bias, dev)),
                               sh.wqkv, sh.bqkv)
            mask = causal_mask(xj.shape[-2], dev) if causal else None
            outs.append(attention_heads(qkv, self.g, mask))
        y = self._plain_reduce(outs, slots, "wo", blk.bo, y, home, dt)
        outs = []
        for sh, dev in zip(slots, devices):
            xj = _on(y, dev)
            xn = ln_f32(xj, _on(blk.ln_2.scale, dev), _on(blk.ln_2.bias, dev))
            outs.append(ACTS[act_kind](_int8_linear(xn, sh.w1, sh.b1)))
        return self._plain_reduce(outs, slots, "w2", blk.b2, y, home, dt)

    def _plain_reduce(self, outs, slots, name, bias, y, home, dt):
        amaxes = [fbq.row_amax(o) for o in outs]
        parts, scale = self._row_parallel(outs, amaxes, [getattr(sh, name) for sh in slots],
                                          home, False)
        acc = sum(parts[1:], parts[0])
        w_scale = _on(getattr(slots[0], name).scale, home).reshape(-1).float()
        return y + (acc.float() * scale * w_scale + _on(bias, home).float()).to(dt)
