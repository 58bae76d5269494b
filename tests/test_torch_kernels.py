"""Port kernels: the plain torch versions against the JAX oracles
(`repro.kernels.ref`) and the Pallas kernels run in interpret mode on the
CPU, and — on a machine with a GPU — each hand-written CUDA kernel against
its plain version. The GPU cases import no JAX, so they also run where JAX
is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.expert_gemm import expert_ffn_cuda, expert_ffn_q4_cuda, expert_ffn_q_cuda
from repro_torch.kernels.flash_decode import flash_decode_cuda, flash_decode_paged_cuda
from repro_torch.kernels.flash_prefill import flash_prefill_cuda
from repro_torch.kernels.sparsemax import sparsemax_cuda

torch.set_num_threads(2)

F32_TOL, BF16_TOL, SPARSEMAX_TOL = 1e-4, 5e-2, 1e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.fixture(scope="module")
def jx():
    """(jnp, repro.kernels.ops, repro.kernels.ref) — the JAX side."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jops, jref


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# expert_ffn
# ---------------------------------------------------------------------------


def _ffn_inputs(E, C, d, F, glu, seed=0):
    return (
        _np((E, C, d), seed), _np((E, d, F), seed + 1, 0.05),
        _np((E, d, F), seed + 2, 0.05) if glu else None, _np((E, F, d), seed + 3, 0.05),
    )


@pytest.mark.parametrize("E,C,d,F,glu,act,dtype,pallas", [
    (2, 128, 128, 128, True, "silu", "float32", True),
    (3, 64, 128, 256, False, "gelu", "float32", True),
    (2, 128, 128, 128, False, "relu", "bfloat16", True),
    (4, 200, 128, 192, False, "gelu", "float32", False),   # ragged C (Pallas needs C % bc)
    (3, 77, 64, 128, True, "gelu", "bfloat16", False),
])
def test_expert_ffn_plain_matches_jax(jx, E, C, d, F, glu, act, dtype, pallas):
    jnp, jops, jref = jx
    arrs = _ffn_inputs(E, C, d, F, glu)
    j = [None if a is None else jnp.asarray(a).astype(dtype) for a in arrs]
    t = [None if a is None else _t(a, dtype) for a in arrs]
    got = ref.expert_ffn_ref(*t, act=act)
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(got.float(), jref.expert_ffn_ref(*j, act=act), tol)
    if pallas:
        _close(got.float(), jops.expert_ffn(*j, act=act), tol)
    _close(ops.expert_ffn(*t, act=act).float(), got.float(), 0.0)   # CPU dispatch = plain


# ---------------------------------------------------------------------------
# sparsemax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 4), (37, 33), (256, 128), (300, 7), (2, 5, 17)])
def test_sparsemax_plain_matches_jax(jx, shape):
    jnp, jops, jref = jx
    z = _np(shape, 3, 3.0)
    got = ref.sparsemax_ref(torch.from_numpy(z))
    _close(got, jref.sparsemax_ref(jnp.asarray(z)), SPARSEMAX_TOL)
    _close(got, jops.sparsemax(jnp.asarray(z)), SPARSEMAX_TOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    assert (got >= 0).all()


# ---------------------------------------------------------------------------
# flash_prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,K,D,window,cap,causal,pallas", [
    (2, 256, 4, 2, 64, 0, 0.0, True, True),
    (1, 128, 6, 3, 64, 32, 30.0, True, True),
    (1, 128, 4, 4, 32, 0, 0.0, False, True),
    (2, 77, 4, 2, 32, 16, 0.0, True, False),    # ragged S (Pallas needs S % bq)
    (1, 100, 4, 1, 64, 0, 50.0, False, False),
])
def test_flash_prefill_plain_matches_jax(jx, B, S, H, K, D, window, cap, causal, pallas):
    jnp, jops, jref = jx
    q, k, v = _np((B, S, H, D), 4), _np((B, S, K, D), 5), _np((B, S, K, D), 6)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = ref.flash_prefill_ref(*map(torch.from_numpy, (q, k, v)), window, cap, causal)
    _close(got, jref.flash_prefill_ref(jq, jk, jv, window, cap, causal), F32_TOL)
    if pallas:
        want = jops.flash_prefill(jq, jk, jv, window=window, cap=cap, causal=causal,
                                  bq=64, bs=64)
        _close(got, want, F32_TOL)


def test_flash_prefill_plain_bf16_matches_jax(jx):
    jnp, _, jref = jx
    arrs = _np((1, 96, 4, 32), 7), _np((1, 96, 2, 32), 8), _np((1, 96, 2, 32), 9)
    got = ops.flash_prefill(*[_t(a, "bfloat16") for a in arrs], window=24)
    assert got.dtype == torch.bfloat16
    want = jref.flash_prefill_ref(*[jnp.asarray(a).astype("bfloat16") for a in arrs], window=24)
    _close(got.float(), want, BF16_TOL)


# ---------------------------------------------------------------------------
# dispatch: a CUDA-less tensor never reaches a kernel; the kernels refuse CPU
# ---------------------------------------------------------------------------


def test_kernels_refuse_cpu_and_other_devices():
    x = torch.zeros(2, 8, 64)
    w = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_cuda(x, w, None, w)
    with pytest.raises(ValueError, match="CUDA"):
        sparsemax_cuda(torch.zeros(4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill_cuda(torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_cuda(torch.zeros(1, 2, 32), torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32),
                          torch.zeros(1, 8, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    wq = torch.zeros(2, 64, 64, dtype=torch.int8)
    sq = torch.ones(2, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_q_cuda(x, wq, sq, None, None, wq, sq)
    with pytest.raises(ValueError, match="device meta"):
        ops.sparsemax(torch.zeros(4, 8, device="meta"))
    before = ops.launches()
    ops.sparsemax(torch.zeros(4, 8))
    assert ops.launches() == before     # the plain version counts no launch


def test_int4_and_paged_kernels_refuse_cpu_tensors():
    x = torch.zeros(2, 8, 64)
    q4, s4 = torch.zeros(2, 32, 64, dtype=torch.uint8), torch.ones(2, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_q4_cuda(x, q4, s4, None, None, q4, s4)
    kp = torch.zeros(3, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_paged_cuda(torch.zeros(1, 2, 32), kp, kp, torch.zeros(1, 2, dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int32))
    before = ops.launches()
    ops.expert_ffn_q4(x, q4, s4, None, None, q4, s4, act="gelu")
    ops.flash_decode_paged(torch.zeros(1, 2, 32), kp, kp, torch.zeros(1, 2, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32))
    assert ops.launches() == before     # the plain versions count no launch


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (skip without a GPU)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,F,glu,act", [
    (4, 640, 768, 3072, False, "gelu"), (3, 77, 128, 512, True, "silu"), (2, 1, 64, 128, False, "relu"),
])
def test_expert_ffn_kernel_matches_plain(cuda, E, C, d, F, glu, act, dtype):
    t = [None if a is None else _t(a, dtype).to(cuda) for a in _ffn_inputs(E, C, d, F, glu)]
    got = ops.expert_ffn(*t, act=act)
    torch.cuda.synchronize()
    want = ref.expert_ffn_ref(*t, act=act)
    _close(got.float().cpu(), want.float().cpu(), F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 256, 256), (37, 33), (5, 1), (300, 1024)])
def test_sparsemax_kernel_matches_plain(cuda, shape):
    z = torch.from_numpy(_np(shape, 10, 3.0)).to(cuda)
    _close(ops.sparsemax(z).cpu(), ref.sparsemax_ref(z).cpu(), SPARSEMAX_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D,window,cap,causal", [
    (8, 256, 12, 12, 64, 0, 0.0, True), (2, 77, 4, 2, 32, 0, 0.0, True),
    (1, 300, 6, 3, 128, 64, 30.0, True), (1, 129, 4, 2, 64, 17, 0.0, False),
])
def test_flash_prefill_kernel_matches_plain(cuda, B, S, H, K, D, window, cap, causal, dtype):
    q, k, v = (_t(_np(s, i), dtype).to(cuda)
               for i, s in enumerate([(B, S, H, D), (B, S, K, D), (B, S, K, D)]))
    got = ops.flash_prefill(q, k, v, window=window, cap=cap, causal=causal)
    assert got.dtype == q.dtype
    want = ref.flash_prefill_ref(q, k, v, window, cap, causal)
    # bf16: the kernel keeps fp32 probabilities and rounds the output once
    _close(got.float().cpu(), want.cpu(), F32_TOL if dtype == "float32" else 2e-2)


def _quantized(arr: np.ndarray):
    """Per-output-channel symmetric int8 of a [E, d_in, d_out] stack."""
    scale = np.maximum(np.abs(arr).max(axis=-2, keepdims=True), 1e-8) / 127.0
    q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
    return torch.from_numpy(q), torch.from_numpy(scale.astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,F,glu,act", [
    (4, 8, 768, 3072, False, "gelu"), (8, 8, 768, 3072, False, "gelu"),
    (4, 640, 768, 3072, False, "gelu"), (3, 77, 128, 512, True, "silu"), (2, 1, 64, 128, False, "relu"),
])
def test_expert_ffn_q_kernel_matches_plain(cuda, E, C, d, F, glu, act, dtype):
    xe, wi, wg, wo = _ffn_inputs(E, C, d, F, glu)
    qs = [_quantized(a) if a is not None else (None, None) for a in (wi, wg, wo)]
    args = [_t(xe, dtype).to(cuda)]
    for q, s in qs:
        args += [None, None] if q is None else [q.to(cuda), s.to(cuda)]
    got = ops.expert_ffn_q(*args, act=act)
    torch.cuda.synchronize()
    assert got.dtype == getattr(torch, dtype)
    want = ref.expert_ffn_q_ref(*args, act=act)
    # bf16: the plain version rounds q·s to bf16 before the product, the
    # kernel scales the fp32 product (tolerances of tests/test_quantized.py)
    _close(got.float().cpu(), want.float().cpu(), F32_TOL if dtype == "float32" else BF16_TOL)


def _decode_inputs(B, S, H, K, D, pos, wrap, dtype, cuda, seed=20):
    q, k, v = (_t(_np(s, seed + i), dtype).to(cuda)
               for i, s in enumerate([(B, H, D), (B, S, K, D), (B, S, K, D)]))
    p = torch.tensor(pos, dtype=torch.int32)
    s_idx = torch.arange(S, dtype=torch.int32)[None, :]
    if wrap:   # ring slots: the largest position <= pos that maps to each slot
        sp = p[:, None] - ((p[:, None] - s_idx) % S)
    else:      # linear slots, filled up to pos
        sp = s_idx.expand(B, S).clone()
    sp = torch.where(sp >= 0, sp, torch.full_like(sp, -1)).contiguous()
    return q, k, v, sp.to(cuda), p.to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D,pos,wrap,window,cap", [
    (8, 512, 12, 12, 64, [63] * 8, True, 0, 0.0),                 # the decode path's shape
    (8, 512, 12, 12, 64, [700, 5, 511, 512, 1023, 0, 64, 300], True, 0, 0.0),   # ring wrap
    (2, 100, 8, 2, 64, [150, 37], True, 24, 30.0),                # G = 4, window + cap, ragged S
    (3, 77, 6, 2, 128, [76, 10, 200], False, 0, 0.0),             # G = 3, D = 128
    (2, 33, 8, 1, 32, [5, 32], True, 0, 0.0),                     # G = 8, D = 32
    (2, 40, 4, 4, 64, [-1, 3], False, 0, 0.0),                    # lane 0: every slot invalid
])
def test_flash_decode_kernel_matches_plain(cuda, B, S, H, K, D, pos, wrap, window, cap, dtype):
    q, k, v, sp, p = _decode_inputs(B, S, H, K, D, pos, wrap, dtype, cuda)
    got = ops.flash_decode(q, k, v, sp, p, window=window, cap=cap)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and tuple(got.shape) == (B, H, D)
    want = ref.flash_decode_ref(q, k, v, sp, p, window, cap)
    _close(got.float().cpu(), want.cpu(), F32_TOL if dtype == "float32" else 2e-2)


def _quantized4(arr: np.ndarray, group: int):
    """Per-group symmetric int4 of a [E, d_in, d_out] stack, nibble-packed
    along d_in (core/offload.py quantize_expert_q4)."""
    from repro_torch.core.offload import quantize_expert_q4

    q, s = quantize_expert_q4(arr, group)
    return torch.from_numpy(q), torch.from_numpy(s)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,F,glu,act,group", [
    (3, 8, 768, 3072, False, "gelu", 64),       # the warm block at decode
    (4, 640, 768, 3072, False, "gelu", 64),     # a batch shape
    (3, 77, 128, 512, True, "silu", 32), (2, 1, 64, 128, False, "relu", 100),   # one group
    (2, 9, 192, 192, True, "gelu", 48),         # groups that straddle the 32-row tiles
])
def test_expert_ffn_q4_kernel_matches_plain(cuda, E, C, d, F, glu, act, group, dtype):
    xe, wi, wg, wo = _ffn_inputs(E, C, d, F, glu)
    args = [_t(xe, dtype).to(cuda)]
    for a in (wi, wg, wo):
        args += [None, None] if a is None else [t.to(cuda) for t in _quantized4(a, group)]
    got = ops.expert_ffn_q4(*args, act=act)
    torch.cuda.synchronize()
    assert got.dtype == getattr(torch, dtype)
    want = ref.expert_ffn_q4_ref(*args, act=act)
    _close(got.float().cpu(), want.float().cpu(), F32_TOL if dtype == "float32" else BF16_TOL)


def _paged_inputs(B, H, K, D, page, n_pages, table, dtype, cuda, seed=40):
    q = _t(_np((B, H, D), seed), dtype).to(cuda)
    kp, vp = (_t(_np((n_pages + 1, page, K, D), seed + i), dtype).to(cuda) for i in (1, 2))
    return q, kp, vp, torch.tensor(table, dtype=torch.int32, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,K,D,page,window,cap", [
    (12, 12, 64, 16, 0, 0.0), (8, 2, 64, 4, 6, 30.0), (6, 2, 128, 8, 0, 0.0),
    (8, 1, 32, 8, 9, 0.0),
])
def test_flash_decode_paged_kernel_matches_plain(cuda, H, K, D, page, window, cap, dtype):
    n_pages, Mp = 12, 5
    # lane 0 full, lane 1 with spilled entries, lane 2 past its table, lane 3
    # with no valid key (it averages V over every entry, -1 through the trash page)
    table = [[0, 1, 2, 3, 4], [-1, 5, -1, 6, 7], [8, 9, 10, -1, -1], [-1, -1, -1, -1, 11]]
    q, kp, vp, pt = _paged_inputs(4, H, K, D, page, n_pages, table, dtype, cuda)
    pos = torch.tensor([5 * page - 1, 4 * page - 2, 7 * page, 2], dtype=torch.int32, device=cuda)
    got = ops.flash_decode_paged(q, kp, vp, pt, pos, window=window, cap=cap)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and tuple(got.shape) == tuple(q.shape)
    want = ref.flash_decode_paged_ref(q, kp, vp, pt, pos, window, cap)
    _close(got.float().cpu(), want.cpu(), F32_TOL if dtype == "float32" else 2e-2)


@pytest.mark.gpu
def test_flash_decode_paged_kernel_equals_ring_kernel_on_the_same_keys(cuda):
    """A full table over 8 lanes of 32 pages of 16 reads the keys of the
    [8, 512] ring case: the two kernels agree."""
    B, H, D, page, Mp = 8, 12, 64, 16, 32
    q, kp, vp, pt = _paged_inputs(B, H, H, D, page, B * Mp, np.arange(B * Mp).reshape(B, Mp),
                                  "bfloat16", cuda)
    pos = torch.full((B,), Mp * page - 1, dtype=torch.int32, device=cuda)
    k, v = (x[:-1].reshape(B, Mp * page, H, D).contiguous() for x in (kp, vp))
    sp = torch.arange(Mp * page, dtype=torch.int32, device=cuda).expand(B, -1).contiguous()
    got = ops.flash_decode_paged(q, kp, vp, pt, pos)
    want = ops.flash_decode(q, k, v, sp, pos)
    torch.cuda.synchronize()
    _close(got.float().cpu(), want.float().cpu(), 1e-2)
