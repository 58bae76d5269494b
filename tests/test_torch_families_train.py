"""The hybrid, recurrent and encoder-decoder families' training path
through the port against the JAX package on the CPU: `loss_and_grads`
against `jax.grad` of the reference's objective, and two steps of each
package's `train()` launcher (seamless with its stub frames). The configs,
weights and inputs are test_torch_families.py's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.models import transformer as jtr
from repro_torch.checkpoint import params_from_numpy
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.tree import flatten
from test_torch_families import ARCHS, CTX, _enc, _j, _t, _toks, system

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_gradients_match_jax(name):
    """loss_and_grads (remat, "assoc") against jax.grad of the reference's
    train objective: every leaf within 1e-4·max|g| of the leaf. A leaf whose
    JAX gradient is at most 1e-6 of the largest leaf's is zero to rounding
    and must be so in the port too: the xLSTM cells' input-gate biases b_i,
    whose gradient is zero in exact arithmetic (the stabiliser m follows
    b_i's shift, so the gates i', f' and the states C, n, h are unchanged).
    Every other leaf, the smallest near 5e-5 of the largest, is held at
    1e-4 of its own scale."""
    cj, ct, pj, _, pt = system(name)
    toks, enc = _toks(ct, 2, 16, seed=9), _enc(ct, 2, seed=10)
    labels = np.roll(toks, -1, axis=1)

    def loss_fn(p):
        out = jtr.forward(p, cj, CTX, jnp.asarray(toks), enc_input=_j(enc), scan_mode="assoc",
                          remat=True)
        return jtr.lm_loss(out["logits"], jnp.asarray(labels))

    jloss, jgrads = jax.value_and_grad(loss_fn)(pj)
    total, m, grads = steps.loss_and_grads(ct, pt, torch.from_numpy(toks).long(),
                                           torch.from_numpy(labels).long(), enc_input=_t(enc))
    assert abs(float(total) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    fj, ft = flatten(jax.tree.map(np.asarray, jgrads)), flatten(grads)
    assert sorted(fj) == sorted(ft)
    top = max(float(np.abs(w).max()) for w in fj.values())
    roundoff = []
    for key in fj:
        g, w = ft[key].numpy(), fj[key]
        scale = float(np.abs(w).max())
        if scale <= 1e-6 * top:
            roundoff.append(key)
            assert float(np.abs(g).max()) <= 1e-6 * top, (key, float(np.abs(g).max()), top)
        else:
            err = float(np.abs(g - w).max())
            assert err <= 1e-4 * scale, (key, err, scale)
    assert all(key.endswith("mixer/b_i") for key in roundoff), roundoff


@pytest.mark.parametrize("name", ARCHS)
def test_train_launcher_matches_jax(name, monkeypatch):
    """Two steps of each package's `train()` from JAX's weights on the same
    synthetic batches (and, for seamless, the same stub frames): each
    step's lm_loss within 1e-4 relative."""
    _, _, _, pn, _ = system(name)
    jparams, jhist = jtrain.train(name, steps=2, batch=2, seq=16, lr=1e-3, reduced=True,
                                  log_every=1)
    monkeypatch.setattr(ttrain, "init_params", lambda gen, cfg, device: params_from_numpy(pn))
    _, thist = ttrain.train(name, steps=2, batch=2, seq=16, lr=1e-3, reduced=True,
                            log_every=1, device="cpu")
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [0, 1]
    for th, jh in zip(thist, jhist):
        assert abs(th["loss"] - jh["loss"]) <= 1e-4 * abs(jh["loss"]), (th, jh)
