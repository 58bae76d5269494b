"""Sharding policy (port of `repro/sharding/policy.py`).

Expert-parallel serving: `serve_ctx`, and `store_ctx`, the port's rule that
a sharded store always serves through it.

The training mesh's half, which the dry run reads (`launch/dryrun.py`):
best-effort partition specs for the parameters, the AdamW state, the inputs
and the decode caches, per (arch x input shape x mesh). Every rule checks
divisibility and falls back to replication, as the reference's do:

* weights (2D+): the last dim ("output features", incl. the MoE expert dim
  for routers / vocab for embeddings) -> `model`; the second-to-last ->
  `data` (FSDP-style), with the Megatron pairing of up / down projections;
* MoE expert stacks [G, E, d, f]: E -> `model`, f -> `data`;
* batch dims of inputs -> ("pod", "data") when divisible;
* decode K/V caches: seq -> `model` (and the data axes when the batch cannot
  use them); recurrent states: the widest trailing dim -> `model`.

The port places nothing on a mesh: one process holds every tensor whole.
The specs say what each device of the mesh would hold, and `shard_bytes`
sums it. A spec is the port's own `P`, a tuple with one entry a dim (None,
an axis name, or a tuple of axis names), equal entry for entry to the
reference's `PartitionSpec`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import make_ep_mesh
from repro_torch.models.attention import ShardingCtx


class P(tuple):
    """A partition spec: P(None, "model") shards dim 1 over `model`. An entry
    of one axis in a tuple is that axis, as JAX's `PartitionSpec` keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))


def serve_ctx(mesh: Optional[object], axis: str = "model") -> ShardingCtx:
    """The expert-parallel serving context: only the MoE slot pools and
    the expert FFN shard over `axis`; attention, the residual stream and
    every other weight stay replicated, which keeps the sharded forward
    equal to the one-device forward (the only reduction, the expert
    combine's sum, adds exact partials). No mesh: one device."""
    if mesh is None:
        return ShardingCtx()
    return ShardingCtx(mesh=mesh, expert_axis=axis if axis in mesh.axis_names else None)


def store_ctx(store, ctx: Optional[ShardingCtx] = None) -> ShardingCtx:
    """The context a store's forwards run under. A sharded store serves
    through the expert-parallel dispatch, never the one-device one: without
    a `ctx` it gets `serve_ctx` over its mesh (or a fresh one on its
    device), and a given `ctx` must shard its expert axis as many ways as
    the store's pools."""
    if ctx is None:
        if store.shards <= 1:
            return ShardingCtx()
        return serve_ctx(store.mesh if store.mesh is not None
                         else make_ep_mesh(store.shards, store.device))
    if ctx.ep_shards != store.shards:
        raise ValueError(f"the context shards the experts {ctx.ep_shards} ways, the store's "
                         f"slot pools {store.shards} ways")
    if ctx.mesh is not None and ctx.mesh.device != store.device:
        raise ValueError(f"the context's shards live on {ctx.mesh.device}, the store on "
                         f"{store.device}")
    return ctx


def slot_pool_spec(axis: str = "model") -> P:
    """Spec of one serving slot pool [G, S, ...]: the slot dim shards over the
    expert-parallel axis, shard m owning global slots [m·S_loc, (m+1)·S_loc);
    the scale planes [G, S, 1, f] share it."""
    return P(None, axis, None, None)


# ---------------------------------------------------------------------------
# the training mesh
# ---------------------------------------------------------------------------


def _tup(axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def _extent(mesh, axis) -> int:
    n = 1
    for a in _tup(axis):
        n *= mesh.shape[a]
    return n


def _div(n: int, mesh, axis) -> bool:
    return axis is not None and n % _extent(mesh, axis) == 0


def make_ctx(mesh) -> ShardingCtx:
    """The training / dry-run context: batch over ("pod", "data"), the model
    axis over "model"; the decode sequence axes are set per decode shape."""
    if mesh is None:
        return ShardingCtx()
    names = mesh.axis_names
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    return ShardingCtx(mesh=mesh, batch_axes=batch_axes or None,
                       model_axis="model" if "model" in names else None)


_EXPERT_KEYS = ("w_in", "w_gate", "w_out")


def _param_spec(path: str, shape: Tuple[int, ...], mesh) -> P:
    """Greedy best-effort spec for one parameter (the reference's rules)."""
    model = "model" if "model" in mesh.axis_names else None
    data = "data" if "data" in mesh.axis_names else None
    ndim = len(shape)
    if ndim <= 1:
        return P()
    is_block = path.startswith("blocks") or path.startswith("enc_blocks")
    is_expert = is_block and any(f"moe/{k}" in path for k in _EXPERT_KEYS)
    entries: list = [None] * ndim
    if path == "embed":
        # [V, d]: vocab -> model, so the (un)embedding logits land V-sharded
        if _div(shape[0], mesh, model):
            entries[0] = model
        if _div(shape[1], mesh, data):
            entries[1] = data
        return P(*entries)
    if path == "head":
        # [d, V]: vocab -> model, d -> data
        if _div(shape[1], mesh, model):
            entries[1] = model
        if _div(shape[0], mesh, data):
            entries[0] = data
        return P(*entries)
    if is_expert:
        # [G, E, d_in, d_out]: experts -> model, d_out -> data
        if _div(shape[1], mesh, model):
            entries[1] = model
        if _div(shape[3], mesh, data):
            entries[3] = data
        return P(*entries)
    if path.endswith("moe/router"):
        # the router stays E-replicated (a V-sharded top_k would gather the
        # logits); only its d dim shards over data
        if _div(shape[ndim - 2], mesh, data):
            entries[ndim - 2] = data
        return P(*entries)
    # Megatron-style pairing: up / column weights out -> model, in -> data;
    # down / row weights in -> model, out -> data
    leaf = path.rsplit("/", 1)[-1]
    is_down = leaf in ("wo", "w_out", "down", "ffn_out", "out_proj", "dt_proj")
    out_dim, in_dim = ndim - 1, ndim - 2
    lead_ok = in_dim >= (1 if is_block and ndim >= 3 else 0)
    if is_down:
        if lead_ok and _div(shape[in_dim], mesh, model):
            entries[in_dim] = model
        if _div(shape[out_dim], mesh, data):
            entries[out_dim] = data
        return P(*entries)
    if _div(shape[out_dim], mesh, model):
        entries[out_dim] = model
    if lead_ok and _div(shape[in_dim], mesh, data):
        entries[in_dim] = data
    return P(*entries)


def _paths_and_specs(tree: Dict[str, Any], spec_for, prefix: str = "") -> Dict[str, Any]:
    """A spec tree of `tree`'s structure: spec_for(path, leaf) at each leaf,
    its path the keys joined by "/" (as the reference's tree paths)."""
    return {k: (_paths_and_specs(v, spec_for, f"{prefix}{k}/") if isinstance(v, dict)
                else spec_for(f"{prefix}{k}", v))
            for k, v in tree.items()}


def fake_mode(mode=None):
    """A fake-tensor mode (`mode` itself when given): tensors made under it
    on the CPU carry shapes and dtypes and hold no memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode() if mode is None else mode


def param_shapes(cfg: ModelConfig, mode=None) -> dict:
    """`init_params(cfg)` as fake CPU tensors (under `mode`, or a fresh fake
    mode): the reference's `jax.eval_shape` of it."""
    from repro_torch.models.transformer import init_params

    with fake_mode(mode):
        return init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


def cache_shapes(cfg: ModelConfig, batch: int, seq_budget: int, enc_len: int = 0,
                 mode=None) -> dict:
    """`init_cache(cfg, batch, seq_budget, enc_len=)` as fake CPU tensors."""
    from repro_torch.models.transformer import init_cache

    with fake_mode(mode):
        return init_cache(cfg, batch, seq_budget, device="cpu", enc_len=enc_len)


def param_specs(cfg: ModelConfig, mesh, shapes: Optional[dict] = None) -> dict:
    """Spec tree of `init_params(cfg)` (from `shapes`, its fake tensors, when
    the caller has them)."""
    shapes = param_shapes(cfg) if shapes is None else shapes
    return _paths_and_specs(shapes, lambda path, t: _param_spec(path, tuple(t.shape), mesh))


def opt_specs(cfg: ModelConfig, mesh, pspecs) -> dict:
    """AdamW state: m / v shadow the parameter specs; t replicated."""
    return {"m": pspecs, "v": pspecs, "t": P()}


def batch_axes_for(mesh, batch: int) -> Optional[Tuple[str, ...]]:
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if not axes:
        return None
    if batch % _extent(mesh, axes) == 0:
        return axes
    for sub in (("data",), ("pod",)):
        if all(a in mesh.axis_names for a in sub) and batch % _extent(mesh, sub) == 0:
            return sub
    return None


def token_specs(mesh, batch: int) -> P:
    return P(batch_axes_for(mesh, batch), None)


def decode_plan(mesh, batch: int) -> Tuple[Optional[Tuple[str, ...]], Optional[Tuple[str, ...]]]:
    """(batch axes, K/V sequence axes) for decode: the cache's sequence dim
    always shards over `model`, and over the data axes too when the batch
    cannot use them (long_500k's batch of 1)."""
    b_ax = batch_axes_for(mesh, batch)
    seq_axes = tuple(a for a in ("model",) + (("pod", "data") if b_ax is None else ())
                     if a in mesh.axis_names)
    return b_ax, (seq_axes or None)


def cache_specs(cfg: ModelConfig, mesh, batch: int, seq_budget: int, enc_len: int = 0,
                shapes: Optional[dict] = None) -> dict:
    """Spec tree of `init_cache(cfg, batch, seq_budget, enc_len=)` (from
    `shapes`, its fake tensors, when the caller has them)."""
    b_ax, seq_axes = decode_plan(mesh, batch)
    model = "model" if "model" in mesh.axis_names else None
    shapes = cache_shapes(cfg, batch, seq_budget, enc_len) if shapes is None else shapes

    def spec_for(path: str, t) -> P:
        shape = tuple(t.shape)
        nd = len(shape)
        if path in ("pos", "cross_len"):
            return P(b_ax)
        if any(s in path for s in ("/k", "/v", "cross_k", "cross_v")) and nd == 5:
            # [G, B, Sc, K, D]: seq -> the flash-decode shard axes
            seq_ax = seq_axes if seq_axes and _div(shape[2], mesh, seq_axes) else None
            return P(None, b_ax, seq_ax, None, None)
        # recurrent states [G, B, ...]: the widest trailing dim on model
        entries = [None, b_ax] + [None] * (nd - 2)
        for i in range(nd - 1, 1, -1):
            if _div(shape[i], mesh, model):
                entries[i] = model
                break
        return P(*entries)

    return _paths_and_specs(shapes, spec_for)


def shard_bytes(tree, specs, mesh, used=None) -> int:
    """Bytes one device of `mesh` holds of `tree` under `specs`: each leaf's
    bytes over the extent of the axes its spec shards it on (every rule
    shards only dims that divide). With `used`, a set of tensor ids, a
    tensor leaf outside it counts 0, as `jax.jit` prunes an argument the
    step never reads. A Python int leaf (AdamW's step count) counts as the
    reference's int32 scalar."""
    if isinstance(tree, dict):
        return sum(shard_bytes(v, specs[k], mesh, used) for k, v in tree.items())
    if isinstance(tree, int):
        return 4
    if used is not None and id(tree) not in used:
        return 0
    n = tree.numel() * tree.element_size()
    for entry in specs:
        if entry is not None:
            n //= _extent(mesh, entry)
    return n
