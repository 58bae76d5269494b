"""Production-mesh dry run as a fake-tensor trace (port of
`repro/launch/dryrun.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch switch-base-8 --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]

The reference lowers and compiles each (arch x input shape x mesh) against
the production mesh and reads the partitioned HLO. PyTorch has no HLO, so
the port builds the parameters, the AdamW state (bf16 moments), the inputs
and the caches as fake CPU tensors, which carry shapes and dtypes and no
memory, and runs the train, prefill or serve step over them on this host
under `torch.utils.flop_counter.FlopCounterMode`. CPU fakes take each
kernel's plain version, which computes the same products as the reference's
`jnp` path does under its dry run. Per combination it writes
experiments/dryrun_torch/<arch>__<shape>__<mesh>.json with:

* `flops_global`, the step's matmul FLOPs (FlopCounterMode: mm, bmm, addmm,
  einsum's products, the recomputed forward under remat included), and
  `flops`, that over the mesh's devices: the ideal split, not a partition;
* `bytes_accessed_global`, the result bytes of every op traced (the
  reference's writes proxy), and `bytes_accessed`, that over the devices;
* `argument_size_in_bytes`, `output_size_in_bytes`, `alias_size_in_bytes`:
  what one device holds of the arguments the step reads (`jax.jit` prunes
  the others), the outputs and the donated arguments, from the ported
  partition specs (`sharding/policy.py`);
* `temp_size_in_bytes` and `collectives`: null, since nothing is
  partitioned, so there is no SPMD module to read them from
  (`null_because`).

The step runs once, on fakes, so the record has a trace time (`trace_s`)
where the reference has lower and compile times; with `--mesh both` a train
or prefill step is traced once and read on both meshes (`trace_from_mesh`).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import replace
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, get_config, list_configs, shape_supported
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import AUDIO_ENC_FRAMES, input_specs
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.optim.adamw import adamw_init
from repro_torch.sharding import policy

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")
NULL_BECAUSE = ("the port places nothing on the mesh, so there is no partitioned module to "
                "read temporaries or collectives from")


def build_lowering(cfg: ModelConfig, shape_name, mesh, mode=None) -> Tuple[Any, list, Dict]:
    """(step, fake arguments, meta) for `shape_name`'s step on `mesh`: the
    counterpart of the reference's lowering, which the caller runs under a
    counting mode instead of compiling. `shape_name` is a key of
    INPUT_SHAPES or an InputShape. meta holds the ctx, each argument's spec
    tree (`arg_specs`), the outputs' (`out_specs`, matched to the step's
    outputs in order) and which arguments the step donates (`donated`)."""
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mode = policy.fake_mode(mode)
    ctx = policy.make_ctx(mesh)
    params = policy.param_shapes(cfg, mode=mode)
    pspecs = policy.param_specs(cfg, mesh, shapes=params)
    ins = input_specs(cfg, shape, mode=mode)
    B = shape.global_batch
    b_ax = policy.batch_axes_for(mesh, B)
    tok_spec = policy.token_specs(mesh, B)
    enc_spec = policy.P(b_ax, None, None)
    logits_spec = policy.P(b_ax, None)
    scalar = policy.P()

    if shape.kind == "train":
        with mode:
            # bf16 optimizer moments at production scale, as the reference's
            opt = adamw_init(params, moment_dtype=torch.bfloat16)
        ospecs = policy.opt_specs(cfg, mesh, pspecs)
        args = [params, opt, ins["tokens"], ins["labels"]]
        specs = [pspecs, ospecs, tok_spec, tok_spec]
        if cfg.enc_dec:
            args.append(ins["enc_input"])
            specs.append(enc_spec)
        metrics = {k: scalar for k in ("lm_loss", "aux_loss", "z_loss", "total_loss")}
        return make_train_step(cfg), args, {
            "ctx": ctx, "arg_specs": specs, "out_specs": [pspecs, ospecs, metrics],
            "donated": (0, 1)}
    if shape.kind == "prefill":
        args = [params, ins["tokens"]]
        specs = [pspecs, tok_spec]
        if cfg.enc_dec:
            args.append(ins["enc_input"])
            specs.append(enc_spec)
        return make_prefill_step(cfg), args, {
            "ctx": ctx, "arg_specs": specs, "out_specs": [logits_spec], "donated": ()}
    # decode: one token against a seq_len cache
    b_ax, seq_axes = policy.decode_plan(mesh, B)
    ctx = replace(ctx, decode_seq_axis=seq_axes)
    cspecs = policy.cache_specs(cfg, mesh, B, shape.seq_len,
                                AUDIO_ENC_FRAMES if cfg.enc_dec else 0, shapes=ins["cache"])
    return make_serve_step(cfg, ctx=ctx), [params, ins["cache"], ins["tokens"]], {
        "ctx": ctx, "arg_specs": [pspecs, cspecs, policy.P(b_ax)],
        "out_specs": [policy.P(b_ax, None), cspecs], "donated": (1,)}


class ResultBytes(TorchDispatchMode):
    """Sums the bytes of every tensor an op returns, views and aliases left
    out (the reference's `bytes` skips parameters, bitcasts and copies), and
    keeps the ids of the tensors whose values an op reads (`read`): a view
    (a group's slice of a stacked weight) reads nothing itself, so its reads
    are its base's. An argument no op reads is one `jax.jit` would prune."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.read = set()
        self._base = {}          # id of a view -> id of the tensor it views

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:             # a query of metadata (a device, a size) reads no values
            return out
        if getattr(func, "is_view", False):
            base = next(t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor))
            root = self._base.get(id(base), id(base))
            self._base.update((id(t), root) for t in outs)
            return out
        self.read.update(self._base.get(id(t), id(t)) for t in tree_leaves((args, kwargs))
                         if isinstance(t, torch.Tensor))
        for t in outs:           # fresh tensors: an id a freed view held is not theirs
            self._base.pop(id(t), None)
            self.bytes += t.numel() * t.element_size()
        return out


def trace_step(step, args, mode) -> Tuple[Any, float, float, set]:
    """Runs `step(*args)` under the fake mode `mode`, counting. -> (outputs,
    matmul FLOPs, result bytes of every op, ids of the tensors read)."""
    counter, nbytes = FlopCounterMode(display=False), ResultBytes()
    with mode, counter, nbytes:
        out = step(*args)
    return out, float(counter.get_total_flops()), float(nbytes.bytes), nbytes.read


def argument_bytes(args, meta, mesh, read) -> list:
    """What one device of `mesh` holds of each argument the step reads, by
    its spec (`jax.jit` prunes the leaves it never reads, such as a
    non-gated config's `w_gate` in decode)."""
    return [policy.shard_bytes(a, s, mesh, used=read) for a, s in zip(args, meta["arg_specs"])]


def analyse(cfg: ModelConfig, shape_name: str, mesh_kind: str, verbose: bool = True,
            traces: Optional[dict] = None) -> dict:
    """One (arch x shape x mesh) record. With `traces`, a dict the caller
    keeps across meshes, a train or prefill step traced on one mesh is read
    again on the next: its computation does not depend on the mesh (only the
    specs do), and one trace of a recurrent arch at 32k tokens takes minutes.
    A decode step is traced on each mesh: its sequence split follows it."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    shape = INPUT_SHAPES[shape_name]
    n_dev = mesh.size
    rec: Dict[str, Any] = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_kind,
                           "n_devices": n_dev, "status": "ok"}
    t0 = time.perf_counter()
    try:
        mode = policy.fake_mode()
        step, args, meta = build_lowering(cfg, shape_name, mesh, mode=mode)
        key = (cfg.name, shape_name)
        if traces is not None and key in traces:
            # the same step over arguments of the same structure: the specs
            # of this mesh apply to the traced arguments leaf for leaf
            args, out, flops, nbytes, read, rec["trace_s"], rec["trace_from_mesh"] = traces[key]
        else:
            out, flops, nbytes, read = trace_step(step, args, mode)
            rec["trace_s"] = time.perf_counter() - t0
            if traces is not None and shape.kind != "decode":
                traces[key] = (args, out, flops, nbytes, read, rec["trace_s"], mesh_kind)
        rec["flops_global"] = flops
        rec["flops"] = flops / n_dev
        rec["flops_note"] = "ideal: the step's matmul FLOPs over the devices"
        rec["bytes_accessed_global"] = nbytes
        rec["bytes_accessed"] = nbytes / n_dev
        arg_b = argument_bytes(args, meta, mesh, read)
        rec["argument_size_in_bytes"] = sum(arg_b)
        rec["output_size_in_bytes"] = sum(
            policy.shard_bytes(o, s, mesh)
            for o, s in zip([out] if shape.kind == "prefill" else out, meta["out_specs"]))
        rec["alias_size_in_bytes"] = sum(arg_b[i] for i in meta["donated"])
        rec["temp_size_in_bytes"] = None
        rec["collectives"] = None
        rec["null_because"] = NULL_BECAUSE
        if verbose:
            dev_gb = (rec["argument_size_in_bytes"] + rec["output_size_in_bytes"]
                      - rec["alias_size_in_bytes"]) / 1e9
            again = f" (traced on {rec['trace_from_mesh']})" if "trace_from_mesh" in rec else ""
            print(f"  OK   trace {rec['trace_s']:.1f}s{again} flops/dev {rec['flops']:.3e} "
                  f"bytes/dev {rec['bytes_accessed']:.3e} args+outputs/dev ~{dev_gb:.2f} GB")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"  FAIL {type(e).__name__}: {str(e)[:200]}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = list_configs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures, traces = 0, {}
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            ok, why = shape_supported(cfg, INPUT_SHAPES[shape_name])
            if not ok:
                print(f"{arch} × {shape_name}: SKIP ({why})")
                continue
            for mesh_kind in meshes:
                print(f"{arch} × {shape_name} × {mesh_kind}:", flush=True)
                rec = analyse(cfg, shape_name, mesh_kind, traces=traces)
                failures += rec["status"] != "ok"
                with open(os.path.join(args.out, f"{arch}__{shape_name}__{mesh_kind}.json"),
                          "w") as f:
                    json.dump(rec, f, indent=2)
            traces.clear()
    print(f"\ndry-run complete; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
