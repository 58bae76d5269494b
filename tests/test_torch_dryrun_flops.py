"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's
on the CPU: the matmul FLOPs that `FlopCounterMode` counts over the port's
fake-tensor train, prefill and serve steps against the dot FLOPs that
`analyse_hlo` reads from XLA's compiled module of the same step, on a
(1, 1) mesh, at reduced configs, within 2 %.

Where a step of the port computes a product that XLA's module does not hold,
the product is named and its FLOPs, counted by a `FlopCounterMode` around
the call that computes it, are subtracted before the comparison
(`port_flops`):

* `expert_ffn_backward` (`kernels/autograd.py`) recomputes the expert
  FFN's pre-activations (`_pre_activations`: x·W_in, and x·W_gate when
  gated), because the kernel forward keeps only its inputs; XLA's backward
  of the `jnp` FFN reads the pre-activations its remat already recomputed.
* Under remat, torch's checkpoint recomputes a layer's forward until the
  last tensor its backward reads; with shared experts after the MoE
  combine, that runs the combine product (`moe._combine`), whose output no
  gradient reads, and XLA removes it as dead code.
* In prefill the mLSTM's state update after its last chunk
  (`ssm._mlstm_carry`: C and n) feeds nothing, and XLA removes it as dead
  code.

The JAX side runs in this process on its one CPU device (a (1, 1) mesh
needs no more). The families are in `test_torch_dryrun_flops_families.py`.
"""
import contextlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import InputShape as JInputShape
from repro.configs.base import get_config as jget_config
from repro.launch.dryrun import build_lowering as j_build_lowering
from repro.launch.hlo_analysis import analyse_hlo
from repro.launch.mesh import make_mesh as j_make_mesh
from repro_torch.configs.base import InputShape, get_config
from repro_torch.kernels import autograd
from repro_torch.launch.dryrun import build_lowering, trace_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe, ssm
from repro_torch.sharding import policy

torch.set_num_threads(2)
FLOPS_TOL = 0.02
KINDS = ("train", "prefill", "decode")


def xla_flops(name: str, kind: str) -> float:
    cfg = jget_config(name).reduced()
    mesh = j_make_mesh((1, 1), ("data", "model"))
    lowered, _ = j_build_lowering(cfg, JInputShape("t", 64, 8, kind), mesh)
    return analyse_hlo(lowered.compile().as_text())["flops"]


def _measure(folds: dict, key: str, fn, when=lambda: True):
    """`fn` that, when `when()` holds, adds the FLOPs a `FlopCounterMode`
    counts inside the call to `folds[key]`."""
    def wrapped(*args, **kwargs):
        if not when():
            return fn(*args, **kwargs)
        with FlopCounterMode(display=False) as counter:
            out = fn(*args, **kwargs)
        folds[key] += counter.get_total_flops()
        return out
    return wrapped


@contextlib.contextmanager
def _recording_folds(folds: dict, kind: str):
    """Patches the three products the module doc names to count, where each
    runs, its FLOPs into `folds`: every pre-activation recompute of the
    expert backward, every combine run inside the backward (the checkpoint's
    recompute), and in prefill the last chunk's mLSTM state update of each
    recurrence."""
    mp = pytest.MonkeyPatch()
    carries = []                                     # FLOPs of each mLSTM state update

    def in_backward():
        return torch._C._current_graph_task_id() != -1

    def _chunked(*args, **kwargs):
        n = len(carries)
        out = chunked(*args, **kwargs)
        if kind == "prefill" and len(carries) > n:
            folds["mlstm_last_chunk_state"] += carries[-1]
        return out

    def _mlstm_carry(*args):
        with FlopCounterMode(display=False) as counter:
            out = mlstm_carry(*args)
        carries.append(counter.get_total_flops())
        return out

    chunked, mlstm_carry = ssm._chunked, ssm._mlstm_carry
    mp.setattr(autograd, "_pre_activations", _measure(
        folds, "expert_ffn_backward_recompute", autograd._pre_activations))
    mp.setattr(moe, "_combine", _measure(folds, "moe_combine_recompute", moe._combine,
                                         when=in_backward))
    mp.setattr(ssm, "_chunked", _chunked)
    mp.setattr(ssm, "_mlstm_carry", _mlstm_carry)
    try:
        yield
    finally:
        mp.undo()


def port_flops(name: str, kind: str):
    """(the port's step FLOPs, {named product: FLOPs XLA's module lacks})."""
    cfg = get_config(name).reduced()
    mode = policy.fake_mode()
    step, args, _ = build_lowering(cfg, InputShape("t", 64, 8, kind),
                                   make_mesh((1, 1), ("data", "model")), mode=mode)
    folds = {"expert_ffn_backward_recompute": 0, "moe_combine_recompute": 0,
             "mlstm_last_chunk_state": 0}
    with _recording_folds(folds, kind):
        _, flops, _, _ = trace_step(step, args, mode)
    return flops, folds


def check_flops(name: str, kind: str):
    want = xla_flops(name, kind)
    got, folds = port_flops(name, kind)
    assert got > 0 and want > 0
    net = got - sum(folds.values())
    assert abs(net - want) <= FLOPS_TOL * want, (name, kind, got, folds, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["switch-base-8", "deepseek-moe-16b", "gemma2-9b"])
def test_dryrun_flops_match_xla(name, kind):
    check_flops(name, kind)
