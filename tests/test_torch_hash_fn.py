"""Port hash predictor against `repro.core.hash_fn` (fp32, CPU): identical
`predict_topk` ids, close logits and α, the causal form, and the segmented
long-prompt path (LSTM carries across segments, per-segment SparseMax),
including S > HASH_SEG_LEN."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hash_fn as jh
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import hash_fn as th

torch.set_num_threads(2)
TOL = 1e-4


def _params(d_model, L, E, d_h, seed=0):
    pj = jax.tree.map(np.asarray, jh.init_hash_fn(jax.random.PRNGKey(seed), d_model, L, E, d_h=d_h))
    return pj, params_from_numpy(pj)


def _emb(B, S, d, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


@pytest.mark.parametrize("B,S,L,E,k,causal", [
    (2, 24, 2, 8, 1, False), (3, 17, 3, 4, 2, False), (2, 20, 2, 8, 1, True),
])
def test_predict_topk_ids_match_jax(B, S, L, E, k, causal):
    pj, pt = _params(32, L, E, 16)
    emb = _emb(B, S, 32)
    lj = jh.hash_fn_apply(pj, jnp.asarray(emb), E, causal=causal)
    lt = th.hash_fn_apply(pt, torch.from_numpy(emb), E, causal=causal)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    ij, aj = jh.predict_topk(lj, k)
    it, at = th.predict_topk(lt, k)
    assert it.dtype == torch.int32 and tuple(it.shape) == (L, B, S, k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-5)


@pytest.mark.parametrize("S,seg_len", [(40, 16), (th.HASH_SEG_LEN + 76, th.HASH_SEG_LEN)])
def test_segmented_matches_jax(S, seg_len):
    assert th.HASH_SEG_LEN == jh.HASH_SEG_LEN
    pj, pt = _params(16, 2, 4, 8, seed=2)
    emb = _emb(1, S, 16, seed=3)
    lj = jh.hash_fn_apply_segmented(pj, jnp.asarray(emb), 4, seg_len=seg_len)
    lt = th.hash_fn_apply_segmented(pt, torch.from_numpy(emb), 4, seg_len=seg_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(th.predict_topk(lt, 1)[0].numpy(),
                                  np.asarray(jh.predict_topk(lj, 1)[0]))
    # one segment == the one-shot build
    short = torch.from_numpy(emb[:, :seg_len])
    np.testing.assert_allclose(th.hash_fn_apply_segmented(pt, short, 4, seg_len=seg_len).numpy(),
                               th.hash_fn_apply(pt, short, 4).numpy(), atol=1e-6)


def test_lstm_gate_order_and_forget_bias():
    pt = th.init_hash_fn(torch.Generator().manual_seed(0), 16, 2, 4, d_h=8, device="cpu")
    b = pt["lstm1"]["b"]
    assert torch.equal(b[8:16], torch.ones(8)) and b[:8].abs().sum() == 0 and b[16:].abs().sum() == 0
    pj, pt = _params(16, 2, 4, 8, seed=4)
    x = _emb(2, 5, 8, seed=5)
    hj, (cj_h, cj_c) = jh._lstm_layer(pj["lstm1"], jnp.asarray(x))
    ht, (ct_h, ct_c) = th._lstm_layer(pt["lstm1"], torch.from_numpy(x))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5)
    np.testing.assert_allclose(ct_c.numpy(), np.asarray(cj_c), atol=1e-5)
