"""Sharding policy of expert-parallel serving (port of
`repro/sharding/policy.py::serve_ctx`).

Only the serving context is ported, with `store_ctx`, the port's rule that
a sharded store always serves through it. The reference's training-mesh specs
(`param_specs`, `opt_specs`, `cache_specs`, `decode_plan`) belong to the
XLA tools (ROADMAP A15(b)).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.launch.mesh import make_ep_mesh
from repro_torch.models.attention import ShardingCtx


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
