"""Seeded weights, drawn on the benchmark's device and handed to both sides.

The model's weights come in the tree the program's engines take
(`{"embed", "blocks": {"sub<s>": ...}, "final_norm", "head"}`, each block
leaf stacked over the layer groups) and in the type they are served in; the
predictor's in float32. Every leaf, and every layer group of a stacked
leaf, draws from a generator of its own seeded from (seed, leaf, group), in
one `randn` call each, so the reference can draw any one again alone. The
program's own initialisers are not used: a change to them cannot move the
benchmark's inputs.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench.reference.moe_transformer import is_moe, period

NORM_STD = 0.1     # norm gains 1 + N(0, 0.1): a norm that ignores its gain shows
EMBED_STD = 0.02


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float, bool]   # path, shape, std, stacked


def model_leaves(m: Dict) -> List[Leaf]:
    """(path, shape without the group axis, std, stacked over groups)."""
    d, H, K = m["d_model"], m["n_heads"], m["n_kv_heads"]
    D = m["head_dim"] or d // H
    Vp = padded_vocab(m["vocab_size"])
    moe = m["moe"]
    out: List[Leaf] = [(("embed",), (Vp, d), EMBED_STD, False)]
    for s in range(period(m)):
        b = ("blocks", f"sub{s}")
        out += [
            (b + ("ln1", "scale"), (d,), NORM_STD, True),
            (b + ("attn", "wq"), (d, H * D), d ** -0.5, True),
            (b + ("attn", "wk"), (d, K * D), d ** -0.5, True),
            (b + ("attn", "wv"), (d, K * D), d ** -0.5, True),
            (b + ("attn", "wo"), (H * D, d), (H * D) ** -0.5, True),
            (b + ("ln2", "scale"), (d,), NORM_STD, True),
        ]
        if is_moe(m, s):
            E, F = moe["num_experts"], moe["d_expert"]
            # w_gate is drawn for non-gated experts too: the program's store
            # keeps and uploads all three stacks
            out += [(b + ("moe", "w_in"), (E, d, F), d ** -0.5, True),
                    (b + ("moe", "w_gate"), (E, d, F), d ** -0.5, True),
                    (b + ("moe", "w_out"), (E, F, d), F ** -0.5, True)]
            if moe["num_shared_experts"]:
                ds = moe["num_shared_experts"] * moe["d_shared"]
                out += [(b + ("moe", "shared_w_in"), (d, ds), d ** -0.5, True),
                        (b + ("moe", "shared_w_gate"), (d, ds), d ** -0.5, True),
                        (b + ("moe", "shared_w_out"), (ds, d), ds ** -0.5, True)]
        elif m["d_ff"]:
            out += [(b + ("mlp", "w_in"), (d, m["d_ff"]), d ** -0.5, True),
                    (b + ("mlp", "w_out"), (m["d_ff"], d), m["d_ff"] ** -0.5, True)]
            if m["glu"]:
                out.append((b + ("mlp", "w_gate"), (d, m["d_ff"]), d ** -0.5, True))
    out.append((("final_norm", "scale"), (d,), NORM_STD, False))
    if not m["tie_embeddings"]:
        out.append((("head",), (d, Vp), EMBED_STD, False))
    return out


def predictor_leaves(m: Dict, d_h: int) -> List[Leaf]:
    n_moe = m["n_layers"] // m["moe"]["moe_every"]
    d = m["d_model"]
    out: List[Leaf] = [(("compress",), (d, d_h), d ** -0.5, False)]
    for name, d_in in (("lstm1", d_h), ("lstm2", d_h)):
        out += [((name, "wx"), (d_in, 4 * d_h), d_in ** -0.5, False),
                ((name, "wh"), (d_h, 4 * d_h), d_h ** -0.5, False),
                ((name, "b"), (4 * d_h,), 0.0, False)]
    out += [(("attn_q",), (d_h, d_h), d_h ** -0.5, False),
            (("heads",), (d_h, n_moe * m["moe"]["num_experts"]), d_h ** -0.5, False)]
    return out


def _seed(seed: int, leaf: int, group: int) -> int:
    return (seed * 1_000_003 + leaf * 10_007 + group) % (1 << 62)


def draw(leaf: Leaf, index: int, seed: int, groups: int, dtype, device) -> torch.Tensor:
    """One leaf: [groups, *shape] when stacked, else shape."""
    path, shape, std, stacked = leaf

    def one(g: int) -> torch.Tensor:
        if std == 0.0:   # an LSTM bias: zeros, the forget gate's at 1
            t = torch.zeros(shape, dtype=torch.float32, device=device)
            t[shape[0] // 4: shape[0] // 2] = 1.0
            return t.to(dtype)
        gen = torch.Generator(device=device).manual_seed(_seed(seed, index, g))
        t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return t.mul_(std).to(dtype)

    if not stacked:
        return one(0)
    out = torch.empty((groups, *shape), dtype=dtype, device=device)
    for g in range(groups):
        out[g] = one(g)
    return out


def _tree(leaves: List[Leaf], seed: int, groups: int, dtype, device) -> Dict:
    tree: Dict = {}
    for i, leaf in enumerate(leaves):
        node = tree
        for key in leaf[0][:-1]:
            node = node.setdefault(key, {})
        node[leaf[0][-1]] = draw(leaf, i, seed, groups, dtype, device)
    return tree


def model_params(spec: Dict, device) -> Dict:
    m = spec["model"]
    return _tree(model_leaves(m), spec["weights"]["model_seed"], m["n_layers"] // period(m),
                 getattr(torch, m["dtype"]), device)


def predictor_params(spec: Dict, device) -> Dict:
    w = spec["weights"]
    return _tree(predictor_leaves(spec["model"], w["predictor_d_h"]), w["predictor_seed"], 1,
                 torch.float32, device)

