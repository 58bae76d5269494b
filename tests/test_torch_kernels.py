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
from repro_torch.kernels.expert_gemm import (
    SMS, TILE, expert_ffn_cuda, expert_ffn_q4_cuda, expert_ffn_q_cuda, gemm_plan,
)
from repro_torch.kernels.flash_decode import (
    SMEM_LIMIT, _smem_bytes, decode_plan, flash_decode_cuda, flash_decode_paged_cuda,
)
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


def _close_attention(got, want, mag, dtype):
    """An attention kernel against its fp32 plain version `want`: fp32
    within F32_TOL; bf16 within 2^-7·(P|V| + |want|) of each element, twice
    the rounding of P and of the output to bf16 (`mag` is the plain version
    over |v|), and never above _close's 2e-2·(1 + |want|). Over hundreds of
    keys that bound is ~6e-3, where 2e-2 is as large as a typical output."""
    got, want = got.float().cpu(), want.float().cpu()
    if dtype == "float32":
        _close(got, want, F32_TOL)
        return
    bound = torch.minimum(2.0 ** -7 * (mag.float().cpu() + want.abs()), 2e-2 * (1 + want.abs()))
    over = ((got - want).abs() / bound).max().item()
    assert over <= 1, over


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


MASKED = np.float32(-1e30)   # what both callers write into the scores they mask


def _ring_rows(live, seed, scale=3.0):
    """The decode predictor's [lanes, 128] ring scores: lane i has live[i]
    valid entries, -1e30 past them (`core/decode_engine.py::hash_fn_step`)."""
    z = _np((len(live), 128), seed, scale)
    return np.where(np.arange(128)[None, :] < np.asarray(live)[:, None], z, MASKED)


def _causal_rows(B, S, seed, scale=3.0):
    """The batch predictor's causal [B, S, S] scores (`core/hash_fn.py::_sparse_attention`)."""
    return np.where(np.tril(np.ones((S, S), bool)), _np((B, S, S), seed, scale), MASKED)


def _tie_rows(L):
    """Rows whose support ends in ties: values equal to tau itself (which
    change nothing whichever side of the support they fall), equal maxima,
    and one value above a flat rest. All exact in fp32."""
    rows = np.full((6, L), -0.5, np.float32)
    rows[0, :4] = [0.75, 0.5, 0.5, 0.25]      # tau = 0.25: the fourth value sits on it
    rows[0, 4:] = 0.25                        # and so does every other one
    rows[1, :] = 2.0                          # all equal: 1 / L each
    rows[2, 0], rows[2, 1:] = 1.0, 0.0        # tau = 0 = every value but the max
    rows[3, :2], rows[3, 2:] = 0.5, 0.0       # two maxima, tau = 0 on the rest
    rows[4, ::2] = 1.0                        # half the row tied at the max
    rows[5, :3] = [3.0, 3.0, 2.0]             # two maxima, the third value exactly 1 below
    return rows


SPARSEMAX_PATH_CASES = {
    "ring": lambda: _ring_rows([1, 2, 5, 17, 64, 100, 127, 128], 11),
    "causal": lambda: _causal_rows(2, 48, 12),
    "causal-slow": lambda: _causal_rows(2, 48, 13, 0.05),
    "ties": lambda: _tie_rows(96),
}


@pytest.mark.parametrize("case", sorted(SPARSEMAX_PATH_CASES))
def test_sparsemax_plain_matches_path_jax(jx, case):
    """The inputs the path gives sparsemax (masked ring rows, causal batch
    rows, ties at the support's edge) through the plain version, the path's
    own JAX function (`repro.core.hash_fn.sparsemax`, sort-based) and the
    Pallas kernel (interpret mode): all within 1e-5."""
    jnp, jops, _ = jx
    from repro.core.hash_fn import sparsemax as j_sparsemax

    z = SPARSEMAX_PATH_CASES[case]()
    got = ref.sparsemax_ref(torch.from_numpy(z))
    _close(got, j_sparsemax(jnp.asarray(z)), SPARSEMAX_TOL)
    _close(got, jops.sparsemax(jnp.asarray(z)), SPARSEMAX_TOL)
    _close(ops.sparsemax(torch.from_numpy(z)), got, 0.0)          # CPU dispatch = plain
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
# the bf16 Hopper GEMM's plan, and the wrappers' refusals (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,M,N,K,gated,plan", [
    (4, 640, 3072, 768, False, (128, 128, 1, 3)),   # batch up-projection: 480 tiles, 2 an SM
    (4, 640, 768, 3072, False, (128, 128, 1, 6)),   # batch down-projection: 120 tiles, one wave
    (4, 8, 3072, 768, False, (64, 128, 1, 8)),      # decode up-projection: 96 tiles
    (4, 8, 768, 3072, False, (64, 128, 4, 8)),      # decode down-projection: 24 tiles x 4 splits
    (3, 77, 512, 128, True, (128, 64, 1, 6)),       # gated: two accumulators, bn 64, no split
])
def test_gemm_plan_at_the_served_shapes(E, M, N, K, gated, plan):
    assert gemm_plan(E, M, N, K, gated=gated) == plan


@pytest.mark.parametrize("fmt,group,E,M,N,K,plan", [
    # int8, the 5b decode step (8 slots), 5c's hot block (2) and the int8
    # batch serve; at C = 8 the decode tile (bm 8: the tokens are wgmma's N;
    # split so that the busiest SM widens the fewest stages)
    ("int8", 0, 8, 8, 3072, 768, (8, 128, 1, 6)),      # 192 tiles, two an SM at most
    ("int8", 0, 8, 8, 768, 3072, (8, 128, 4, 6)),      # 48 tiles x 4 splits
    ("int8", 0, 2, 8, 3072, 768, (8, 128, 4, 6)),
    ("int8", 0, 2, 8, 768, 3072, (8, 128, 8, 16)),     # 12 tiles x 8 splits, one an SM
    ("int8", 0, 4, 640, 3072, 768, (128, 128, 1, 5)),  # a whole SM: the stage holds the bf16 tile
    ("int8", 0, 4, 640, 768, 3072, (128, 128, 1, 5)),
    # int4 group 64, 5c's warm block (3 slots) and a batch shape
    ("int4", 64, 3, 8, 3072, 768, (8, 128, 2, 10)),
    ("int4", 64, 3, 8, 768, 3072, (8, 128, 8, 10)),    # 18 tiles x 8 splits
    ("int4", 64, 4, 640, 3072, 768, (128, 128, 1, 5)),
    ("int4", 64, 4, 640, 768, 3072, (128, 128, 1, 5)),
])
def test_gemm_plan_at_the_served_quantised_shapes(fmt, group, E, M, N, K, plan):
    assert gemm_plan(E, M, N, K, fmt=fmt, group=group) == plan


def _smem(bm, bn, gated, fmt, K, group, stages):
    """A plan's shared memory, written out from the kernels' layouts. Per
    weight tile (two when gated) a stage holds the raw bytes that land (int8
    64 x bn; int4 32 x bn and its group-scale rows) and, for bm 64 or 128,
    the bf16 tile wgmma reads (for bf16 weights, only that); beside them the
    bm x 64 bf16 activation tile. The decode tile (bm 8 or 16) widens into
    three 32-row boxes per 64 columns per row half per weight tile instead,
    and stages its column scales."""
    up = lambda b: -(-b // 1024) * 1024
    nb = 2 if gated else 1
    srows = 1
    if fmt == "int4":
        srows = max(len({k // group for k in range(k0, k0 + TILE)}) for k0 in range(0, K, TILE))
    raw = {"fp": 0, "int8": TILE * bn, "int4": TILE // 2 * bn + 4 * srows * bn}[fmt]
    if bm < 64:    # + int8's column scales, staged
        stage = up(bm * TILE * 2) + up(nb * raw)
        boxes = 3 * nb * (bn // 64) * TILE * TILE * 2 + nb * bn * 4
    else:
        stage, boxes = up(bm * TILE * 2 + nb * (TILE * bn * 2 + raw)), 0
    return stages * stage + boxes + 1024 + 16 * stages


@pytest.mark.parametrize("fmt,group", [
    ("fp", 0), ("int8", 0), ("int4", 1), ("int4", 32), ("int4", 48), ("int4", 64),
    ("int4", 0),   # one group: the whole contraction axis
])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("M", [1, 8, 64, 65, 77, 129, 640, 5000])
def test_gemm_plan_is_a_valid_launch(M, gated, fmt, group):
    for E in (1, 4, 8):
        for N, K in ((3072, 768), (768, 3072), (128, 64), (64, 4096), (512, 128)):
            gs = group if group and K % group == 0 else K    # the store's _group_of
            bm, bn, split, stages = gemm_plan(E, M, N, K, gated=gated, fmt=fmt, group=gs)
            if bm < 64:    # the quantised decode tile, its splits one cluster
                assert fmt != "fp" and M <= bm == (8 if M <= 8 else 16)
                assert bn == 128 and 2 <= stages <= 16 and split <= 8
            else:
                assert bm == (64 if M <= 64 else 128) and 2 <= stages <= 8
                assert not gated or bn == 64
            # the ring (raw weight bytes, bf16 tiles and int4 scale rows),
            # the decode tile's boxes and the barriers fit a block's 227 KB
            assert _smem(bm, bn, gated, fmt, K, gs, stages) <= 232448
            assert bn in (64, 128) and N % bn == 0
            assert not gated or split == 1
            kb = K // TILE
            tiles = E * -(-M // bm) * (N // bn)
            if bm < 64:    # a split of 8 or fewer blocks, each of 2 stages or more
                assert kb % split == 0 and (split == 1 or kb // split >= 2)
                continue
            assert kb % split == 0 and (split == 1 or kb // split >= 4)
            # a split only while the tiles leave SMs idle, and its fp32
            # partials stay small beside the weights
            assert split == 1 or (tiles * split // 2 < 0.7 * SMS and 32 * split * M <= K)


# ---------------------------------------------------------------------------
# the decode kernels' split plan (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,KH,S,G,D,dtype,plan", [
    # the 5a / 5b ring, 8 lanes x 12 kv heads over 512 slots, and 5c's table
    # of 32 pages of 16 (the same 512 keys a lane): 96 x 4 blocks of two
    # tiles each
    (8, 12, 512, 1, 64, "bfloat16", 4),
    (8, 12, 32 * 16, 1, 64, "bfloat16", 4),
    (8, 12, 512, 1, 64, "float32", 4),         # 32-key fp32 tiles, four a rank
    (8, 3, 512, 4, 64, "bfloat16", 8),         # G 4: 24 (lane, kv head) pairs
    (8, 2, 512, 8, 64, "bfloat16", 8),         # G 8
    (8, 12, 512, 1, 32, "bfloat16", 4),        # D 32: 128-key tiles, one a rank
    (8, 12, 512, 1, 128, "bfloat16", 4),       # D 128: 32-key tiles
    (8, 12, 1, 1, 64, "bfloat16", 1),          # one key: unsplit
    (8, 12, 33, 1, 64, "bfloat16", 1),         # one 64-key tile
    (8, 12, 33, 1, 64, "float32", 2),          # two 32-key tiles, one a rank
    # the attention-family decode shapes over a 512-slot ring
    (8, 4, 512, 16, 128, "bfloat16", 8),       # qwen3-moe: G 16 in 2 head blocks, 64 x 8
    (8, 16, 512, 1, 128, "bfloat16", 4),       # deepseek-moe: 128 x 4
    (8, 8, 512, 4, 160, "bfloat16", 8),        # stablelm: 16-key tiles (a warp a row)
    (8, 8, 512, 2, 256, "bfloat16", 8),        # gemma2
    (8, 8, 512, 2, 256, "float32", 8),
])
def test_decode_plan_at_the_served_shapes(B, KH, S, G, D, dtype, plan):
    assert decode_plan(B, KH, S, G, D, getattr(torch, dtype)) == plan


def _decode_smem(G, D, esize, splits, Mp=None):
    """The decode kernel's shared memory written out from its layout
    (csrc/flash_decode.cu `Layout`): a key row spans D·esize/16 lanes of 16
    bytes when that divides 32, else a whole warp, each of the two ring
    stages holds four keys for each of the 4 x 32/that rows of the block,
    as K and V tiles and one int position a key; the warps' fp32 partials
    [4][GM][D + 2] reuse the ring; beside it the cluster's block partials
    [splits][GM][D + 2], an 8-byte mbarrier and the paged kernel's page
    list, 2 x Mp ints. GM is the heads a block holds: 1, 4 or 8."""
    gm = 1 if G == 1 else 4 if G <= 4 else 8
    lanes = D * esize // 16
    lanes = lanes if 32 % lanes == 0 else 32
    keys = 4 * (32 // lanes) * 4
    stage = 2 * keys * D * esize + 4 * keys
    partial = 4 * gm * (D + 2)
    return (max(2 * stage, 4 * partial) + splits * partial + 8
            + (8 * Mp if Mp is not None else 0))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [32, 64, 128, 160, 256])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 12, 16])
def test_decode_plan_is_a_valid_launch(G, D, dtype):
    esize = 2 if dtype == "bfloat16" else 4
    lanes = D * esize // 16                      # 16-byte pieces of a key row
    keys = 4 * (32 // (lanes if 32 % lanes == 0 else 32)) * 4     # a ring stage's keys
    head_blocks = -(-G // 8)                     # query heads in blocks of 8
    for B in (1, 3, 8, 64):
        for KH in (1, 2, 12):
            for S in (1, 7, 33, 64, 300, 512, 4096, 32768):
                splits = decode_plan(B, KH, S, G, D, getattr(torch, dtype))
                assert splits in (1, 2, 4, 8)    # a cluster of 8 at most
                # the kernel's balanced runs of tiles: on a ring no rank is empty
                tiles = -(-S // keys)
                assert all((r + 1) * tiles // splits > r * tiles // splits for r in range(splits))
                # a split only while the grid has fewer than two blocks an SM
                assert splits == 1 or B * KH * head_blocks * splits // 2 < 2 * 132
                smem = _smem_bytes(G, D, esize, splits)
                assert smem == _decode_smem(G, D, esize, splits) <= SMEM_LIMIT
                # the paged kernel over a table of 16-slot pages holding S keys
                Mp = -(-S // 16)
                paged = _smem_bytes(G, D, esize, splits, Mp)
                assert paged == _decode_smem(G, D, esize, splits, Mp) <= SMEM_LIMIT


def _ffn_args(E=2, C=8, d=64, F=128, dtype=torch.bfloat16):
    return [torch.zeros(E, C, d, dtype=dtype), torch.zeros(E, d, F, dtype=dtype), None,
            torch.zeros(E, F, d, dtype=dtype)]


def _misaligned(*shape):
    return torch.zeros(int(np.prod(shape)) + 1, dtype=torch.bfloat16)[1:].view(*shape)


@pytest.mark.parametrize("case,match", [
    ("fp16", "not supported"), ("d=96", "multiples of 64"), ("act", "unknown activation"),
    ("w_out shape", "w_out has shape"), ("misaligned", "16-byte aligned"),
    ("gate dtype", "w_gate is torch.float32"), ("cpu", "needs CUDA"),
])
def test_expert_ffn_cuda_refusals(case, match):
    args, kw = _ffn_args(), {}
    if case == "fp16":
        args = _ffn_args(dtype=torch.float16)
    elif case == "d=96":
        args = _ffn_args(d=96)
    elif case == "act":
        kw["act"] = "tanh"
    elif case == "w_out shape":
        args[3] = torch.zeros(2, 64, 128, dtype=torch.bfloat16)
    elif case == "misaligned":
        args[0] = _misaligned(2, 8, 64)
    elif case == "gate dtype":
        args[2] = torch.zeros(2, 64, 128)
    with pytest.raises(ValueError, match=match):
        expert_ffn_cuda(*args, **kw)


@pytest.mark.parametrize("case,match", [
    ("head_dim 48", "head_dim 48"), ("groups", "do not group"), ("k dtype", "k is"),
    ("misaligned", "16-byte aligned"), ("window", "must be >= 0"), ("cpu", "needs CUDA"),
    ("cross causal", "causal=False"), ("cross window", "window=0"),
])
def test_flash_prefill_cuda_refusals(case, match):
    B, S, H, K, D = 1, 8, 4, 2, 32
    q, k, v = (torch.zeros(B, S, h, D, dtype=torch.bfloat16) for h in (H, K, K))
    kw = {}
    if case == "head_dim 48":
        q, k, v = (torch.zeros(B, S, h, 48, dtype=torch.bfloat16) for h in (H, K, K))
    elif case == "groups":
        q = torch.zeros(B, S, 6, D, dtype=torch.bfloat16)
        k = v = torch.zeros(B, S, 4, D, dtype=torch.bfloat16)
    elif case == "k dtype":
        k = k.float()
    elif case == "misaligned":
        v = _misaligned(B, S, K, D)
    elif case == "window":
        kw["window"] = -1
    elif case.startswith("cross"):
        # 12 keys for 8 queries: only cross-attention's unmasked form
        k, v = (torch.zeros(B, 12, K, D, dtype=torch.bfloat16) for _ in range(2))
        kw = {"causal": True} if case == "cross causal" else {"causal": False, "window": 4}
    with pytest.raises(ValueError, match=match):
        flash_prefill_cuda(q, k, v, **kw)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 4), (True, 4)])
def test_flash_prefill_refuses_a_masked_key_length_of_its_own(causal, window):
    """ops.flash_prefill refuses S_kv != S with a mask on either device,
    before the plain version or the kernel sees it."""
    q = torch.zeros(1, 8, 2, 32)
    kv = torch.zeros(1, 12, 2, 32)
    with pytest.raises(ValueError, match="cross-attention"):
        ops.flash_prefill(q, kv, kv, window=window, causal=causal)


@pytest.mark.parametrize("S,S_kv,H,K,cap", [(17, 64, 4, 4, 0.0), (64, 9, 10, 2, 0.0),
                                            (5, 130, 25, 5, 30.0)])
def test_flash_prefill_plain_cross_attention_matches_jax(jx, S, S_kv, H, K, cap):
    """The plain version at a key length of its own against the reference's
    cross-attention (`repro.models.attention._attend_chunk`, unmasked), and
    its backward (`kernels.autograd`) against autograd over it."""
    jnp, _, _ = jx
    from repro.models.attention import _attend_chunk

    q, k, v = _np((2, S, H, 32), 11), _np((2, S_kv, K, 32), 12), _np((2, S_kv, K, 32), 13)
    got = ops.flash_prefill(*map(torch.from_numpy, (q, k, v)), cap=cap, causal=False)
    want = _attend_chunk(*map(jnp.asarray, (q, k, v)), jnp.arange(S), jnp.arange(S_kv), 0, cap,
                         False)
    _close(got, want, F32_TOL)
    _card_vs_plain_grads(
        lambda q, k, v: ops.flash_prefill(q, k, v, cap=cap, causal=False),
        lambda q, k, v: ref.flash_prefill_ref(q, k, v, cap=cap, causal=False),
        [torch.from_numpy(a) for a in (q, k, v)], "float32")


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
@pytest.mark.parametrize("glu,act", [(False, "gelu"), (True, "silu")])
@pytest.mark.parametrize("E", [1, 4])
@pytest.mark.parametrize("C", [1, 8, 77, 129, 640])
def test_expert_ffn_bf16_hopper_gemm_matches_plain(cuda, C, E, glu, act):
    """The TMA + wgmma GEMM at full width on every tile plan the served shapes
    reach: ragged capacity (zero fill past C in each slot), one and two
    consumer warpgroups, bn 64 / 128, the split decode down-projection at
    [4, 8, 768, 3072], and the gated two-accumulator epilogue. Weights at the
    served init scale (d^-1/2, F^-1/2, as chip_smoke.py phase 2 draws them),
    so outputs are O(1): at _ffn_inputs' fixed 0.05 the gated outputs reach
    |y| ~ 10, where one bf16 ulp (0.0625) is above the tolerance."""
    d, F = 768, 3072
    arrs = [_np((E, C, d), C + E), _np((E, d, F), C + E + 1, d ** -0.5),
            _np((E, d, F), C + E + 2, d ** -0.5) if glu else None,
            _np((E, F, d), C + E + 3, F ** -0.5)]
    t = [None if a is None else _t(a, "bfloat16").to(cuda) for a in arrs]
    got = ops.expert_ffn(*t, act=act)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (E, C, 768)
    want = ref.expert_ffn_ref(*t, act=act)
    _close(got.float().cpu(), want.float().cpu(), BF16_TOL)


@pytest.mark.gpu
def test_expert_ffn_bf16_split_is_deterministic(cuda):
    """The split down-projection sums its fp32 partials in a fixed order:
    two runs on the same inputs are bit-identical."""
    assert gemm_plan(4, 8, 768, 3072)[2] > 1   # split
    t = [None if a is None else _t(a, "bfloat16").to(cuda)
         for a in _ffn_inputs(4, 8, 768, 3072, False)]
    a, b = ops.expert_ffn(*t, act="gelu"), ops.expert_ffn(*t, act="gelu")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


SPARSEMAX_KERNEL_CASES = {
    **{f"shape-{'x'.join(map(str, s))}": (lambda s=s: _np(s, 10, 3.0))
       for s in [(8, 256, 256), (37, 33), (5, 1), (300, 1024)]},
    # every row length class of the kernel, L % 4 != 0 (scalar loads) included
    **{f"L{L}": (lambda L=L: _np((37, L), L, 3.0))
       for L in [1, 2, 31, 32, 33, 127, 128, 129, 255, 256, 257, 1023, 1024]},
    # the decode ring with n live entries a lane, -1e30 elsewhere
    **{f"ring-live{n}": (lambda n=n: _ring_rows([n] * 8, 20 + n))
       for n in [1, 2, 5, 17, 64, 100, 127, 128]},
    "ring-served": lambda: _ring_rows([1, 2, 5, 17, 64, 100, 127, 128], 11),
    "one-live-L256": lambda: np.where(np.eye(16, 256, 3, dtype=bool), _np((16, 256), 14),
                                      MASKED),
    "ties-L96": lambda: _tie_rows(96),
    "ties-L256": lambda: _tie_rows(256),
    "ties-L33": lambda: _tie_rows(33),
    # slowly converging: many values near the max, tau far from max - 1
    "slow-0.01-L256": lambda: _np((512, 256), 15, 0.01),
    "slow-0.05-L256": lambda: _np((512, 256), 16, 0.05),
    "slow-0.01-L1024": lambda: _np((64, 1024), 17, 0.01),
    "slow-0.05-L1024": lambda: _np((64, 1024), 18, 0.05),
    "causal-8x256x256": lambda: _causal_rows(8, 256, 19),
    "causal-slow-8x256x256": lambda: _causal_rows(8, 256, 21, 0.05),
}


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", list(SPARSEMAX_KERNEL_CASES))
def test_sparsemax_kernel_matches_plain(cuda, case, offset):
    """Within 1e-5 of the plain version, non-negative, summing to 1 within
    1e-5, and a rerun bit-identical. offset 1 puts the rows one float past a
    16-byte boundary (a contiguous view at a storage offset), so every row
    length also runs with 4-byte loads."""
    a = SPARSEMAX_KERNEL_CASES[case]()
    buf = torch.empty(a.size + offset, dtype=torch.float32, device=cuda)
    z = buf[offset:].view(a.shape)
    z.copy_(torch.from_numpy(a))
    assert z.is_contiguous() and (z.data_ptr() % 16 == 0) == (offset == 0)
    got = ops.sparsemax(z)
    again = ops.sparsemax(z)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    got = got.cpu()
    _close(got, ref.sparsemax_ref(torch.from_numpy(a)), SPARSEMAX_TOL)
    assert (got >= 0).all()
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


# rows past 1024 take the block kernel: the row in shared memory up to
# 57,856 values, re-read from global memory past that (65536)
SPARSEMAX_LONG_CASES = {
    **{f"L{L}": (lambda L=L: _np((8, L), L, 3.0)) for L in [1025, 2048, 4096, 65536]},
    "L1027-odd": lambda: _np((5, 1027), 30, 3.0),
    "slow-0.01-L2048": lambda: _np((16, 2048), 31, 0.01),
    "slow-0.01-L65536": lambda: _np((2, 65536), 32, 0.01),
    "ties-L2048": lambda: _tie_rows(2048),
    # TKD's draft head at S = 1280: row i holds S - i - 1 masked values
    "causal-2x1280x1280": lambda: _causal_rows(2, 1280, 33),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SPARSEMAX_LONG_CASES))
def test_sparsemax_long_rows_match_plain(cuda, case):
    """Past 1024 (C18): within the reference's 1e-5 of the plain version,
    non-negative, summing to 1 within 1e-5, a rerun bit-identical."""
    a = SPARSEMAX_LONG_CASES[case]()
    z = torch.from_numpy(a).to(cuda)
    got, again = ops.sparsemax(z), ops.sparsemax(z)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    got = got.cpu()
    _close(got, ref.sparsemax_ref(torch.from_numpy(a)), SPARSEMAX_TOL)
    assert (got >= 0).all()
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def _ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """One unit in the last place of each |x| in `dtype` (fp32 values; the
    smallest normal's spacing below it)."""
    fi = torch.finfo(dtype)
    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=fi.tiny)))
    return torch.exp2(e) * fi.eps


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("L", [33, 256, 1024, 2048, 65536])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_sparsemax_half_dtypes_match_plain(cuda, dtype, L, offset):
    """bf16 / fp16 in, read as fp32, written in z's dtype (the Pallas body's
    contract): bit-equal to the fp32 kernel on the same values cast to z's
    dtype (the same lane layout: offset 1 puts both off their vector
    alignment), and within one ulp of the plain version over z.float() cast
    to z's dtype."""
    dt = getattr(torch, dtype)
    a = torch.from_numpy(_np((8, L), 40 + L, 3.0)).to(dt)
    buf = torch.empty(a.numel() + offset, dtype=dt, device=cuda)
    z = buf[offset:].view(a.shape)
    z.copy_(a)
    buf32 = torch.empty(a.numel() + offset, dtype=torch.float32, device=cuda)
    z32 = buf32[offset:].view(a.shape)
    z32.copy_(a.float())
    got = ops.sparsemax(z)
    want32 = ops.sparsemax(z32)
    torch.cuda.synchronize()
    assert got.dtype == dt
    assert torch.equal(got, want32.to(dt))
    want = ref.sparsemax_ref(a.float()).to(dt).float()
    err = (got.cpu().float() - want).abs()
    assert (err <= _ulp(want, dt)).all(), err.max().item()


@pytest.mark.gpu
def test_sparsemax_backward_on_the_card_long_rows(cuda):
    """The backward (`kernels/autograd.py`, plain PyTorch over the kernel's
    output) at L = 2048, the TKD draft head's causal rows."""
    z = torch.from_numpy(_causal_rows(2, 2048, 34)[:, ::8].copy())       # [2, 256, 2048]
    _card_vs_plain_grads(ops.sparsemax, ref.sparsemax_ref, [z.to(cuda)], "float32")


@pytest.mark.gpu
def test_train_hash_fn_step_past_1024_card_vs_cpu(cuda):
    """One TKD step at S = 1280 (sparsemax rows of 1280): the card's TKD-loss
    gradients within 1e-3 * max|g_cpu| a leaf, and one `train_hash_fn` step's
    loss within 1e-4 * max(1, |loss|), of the CPU's."""
    from repro_torch.core.hash_fn import hash_fn_apply, init_hash_fn
    from repro_torch.core.tkd import tkd_loss, train_hash_fn
    from repro_torch.tree import flatten, leaf_grads, requiring_grad, tree_map

    B, S, d, L, E = 2, 1280, 64, 2, 8
    hp = init_hash_fn(torch.Generator().manual_seed(1), d, L, E, d_h=32, device="cpu")
    emb = torch.from_numpy(_np((B, S, d), 35))
    teacher = torch.from_numpy(_np((L, B, S, E), 36, 2.0))
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        p = requiring_grad(tree_map(lambda t: t.to(dev), hp))
        e, t = emb.to(dev), teacher.to(dev)
        loss, _ = tkd_loss(hash_fn_apply(p, e, E), t, T=8, lam=0.005)
        grads = flatten(leaf_grads(loss, p))
        _, hist = train_hash_fn(tree_map(lambda t: t.to(dev), hp), iter([(e, t)]), steps=1,
                                lr=3e-3, T=8, lam=0.005, verbose=False)
        runs[dev.type] = (grads, hist[0]["loss"])
    (g_card, l_card), (g_cpu, l_cpu) = runs["cuda"], runs["cpu"]
    assert abs(l_card - l_cpu) <= 1e-4 * max(1.0, abs(l_cpu))
    for k, g in g_cpu.items():
        assert (g_card[k].cpu() - g).abs().max() <= 1e-3 * g.abs().max(), k


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
    # bf16: the kernel rounds P to bf16 before P V (the oracle's w.to(v.dtype))
    _close(got.float().cpu(), want.cpu(), F32_TOL if dtype == "float32" else 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 17, 64, 65, 256, 300])
def test_flash_prefill_bf16_tensor_core_matches_plain(cuda, S, D, G):
    """64-row query tiles and 64-key tiles: S below, at and across a tile
    edge, every head dim, GQA groups of 1 and 2, causal."""
    B, K = 2, 3
    q, k, v = (_t(_np(s, 30 + i), "bfloat16").to(cuda)
               for i, s in enumerate([(B, S, K * G, D), (B, S, K, D), (B, S, K, D)]))
    got = ops.flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    # the kernel rounds P to bf16 before P V, the plain version keeps fp32
    _close(got.float().cpu(), ref.flash_prefill_ref(q, k, v).cpu(), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("S,D,G,window,cap,causal", [
    (256, 64, 1, 64, 50.0, True), (300, 128, 2, 64, 30.0, True), (65, 32, 2, 1, 0.0, True),
    (129, 64, 2, 17, 0.0, False), (300, 64, 1, 100, 20.0, False), (256, 128, 1, 0, 0.0, False),
])
def test_flash_prefill_bf16_window_softcap_and_non_causal(cuda, S, D, G, window, cap, causal):
    """Tiles skipped below the window band and above the diagonal, masked
    where they straddle an edge; a window of 1 leaves each row one key."""
    B, K = 2, 2
    q, k, v = (_t(_np(s, 40 + i), "bfloat16").to(cuda)
               for i, s in enumerate([(B, S, K * G, D), (B, S, K, D), (B, S, K, D)]))
    got = ops.flash_prefill(q, k, v, window=window, cap=cap, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_prefill_ref(q, k, v, window, cap, causal)
    _close(got.float().cpu(), want.cpu(), 2e-2)


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
    # the split (decode_plan: 4 ranks of 64-key tiles at these shapes): 300
    # keys are not a whole number of tiles a rank; a window of 5 at the end
    # leaves each lane's only valid keys in the last rank
    (8, 300, 12, 12, 64, [299, 310, 5, 600, 0, 299, 150, 420], True, 0, 0.0),
    (8, 512, 12, 12, 64, [511] * 8, False, 5, 0.0),
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
    along d_in (core/offload.py quantize_stack_int4)."""
    from repro_torch.core.offload import quantize_stack_int4

    return quantize_stack_int4(torch.from_numpy(arr), "cpu", group)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [8, 640])
@pytest.mark.parametrize("fmt", ["fp", "int8", "int4"])
@pytest.mark.parametrize("S,shards,m", [(4, 2, 1), (8, 4, 3), (8, 2, 1)])
def test_expert_ffn_kernels_on_a_shard_slice(cuda, S, shards, m, fmt, C, dtype):
    """Expert-parallel serving launches B1 / B5 / B6 over shard m's slice of
    a [S, ...] slot pool: views at a non-zero offset into the pool (and into
    its scale planes), never copies. Each is held against the plain version
    of the slice and is bit-identical to the kernel over a contiguous copy
    of it (the address does not change the result)."""
    n = S // shards
    arrs = _served_ffn(S, C, False, seed=S + m)
    xe = _t(arrs[0][m * n:(m + 1) * n], dtype).to(cuda)
    pools = []
    for a in arrs[1:]:
        if a is None:
            pools += [None] if fmt == "fp" else [None, None]
        elif fmt == "fp":
            pools.append(_t(a, dtype).to(cuda))
        else:
            pools += [t.to(cuda) for t in (_quantized(a) if fmt == "int8" else _quantized4(a, 64))]
    view = [None if p is None else p[m * n:(m + 1) * n] for p in pools]
    for p, v in zip(pools, view):
        if p is not None:
            assert v.untyped_storage().data_ptr() == p.untyped_storage().data_ptr()
            assert v.is_contiguous()
            assert v.data_ptr() == p.data_ptr() + m * n * p.stride(0) * p.element_size()
    fn = {"fp": ops.expert_ffn, "int8": ops.expert_ffn_q, "int4": ops.expert_ffn_q4}[fmt]
    before = ops.launches()[{"fp": "expert_ffn", "int8": "expert_ffn_q",
                             "int4": "expert_ffn_q4"}[fmt]]
    got = fn(xe, *view, act="gelu")
    copied = fn(xe, *[None if v is None else v.clone() for v in view], act="gelu")
    torch.cuda.synchronize()
    assert ops.launches()[{"fp": "expert_ffn", "int8": "expert_ffn_q",
                           "int4": "expert_ffn_q4"}[fmt]] == before + 2
    want = {"fp": ref.expert_ffn_ref, "int8": ref.expert_ffn_q_ref,
            "int4": ref.expert_ffn_q4_ref}[fmt](xe, *view, act="gelu")
    assert torch.equal(got, copied)
    _close(got.float().cpu(), want.float().cpu(), F32_TOL if dtype == "float32" else BF16_TOL)


def _served_ffn(E, C, glu, seed, d=768, F=3072):
    """Full-width FFN inputs with weights at the served init scale (d^-1/2,
    F^-1/2, as chip_smoke.py phase 2 draws them), so outputs are O(1)."""
    return [_np((E, C, d), seed), _np((E, d, F), seed + 1, d ** -0.5),
            _np((E, d, F), seed + 2, d ** -0.5) if glu else None,
            _np((E, F, d), seed + 3, F ** -0.5)]


def _q8_args(arrs, dtype, cuda):
    args = [_t(arrs[0], dtype).to(cuda)]
    for a in arrs[1:]:
        args += [None, None] if a is None else [t.to(cuda) for t in _quantized(a)]
    return args


def _q4_args(arrs, group, dtype, cuda):
    args = [_t(arrs[0], dtype).to(cuda)]
    for a in arrs[1:]:
        args += [None, None] if a is None else [t.to(cuda) for t in _quantized4(a, group)]
    return args


@pytest.mark.gpu
@pytest.mark.parametrize("glu,act", [(False, "gelu"), (True, "silu")])
@pytest.mark.parametrize("E", [1, 4])
@pytest.mark.parametrize("C", [1, 8, 12, 77, 129, 640])
def test_expert_ffn_q_hopper_gemm_matches_plain(cuda, C, E, glu, act):
    """int8 weights through the TMA + wgmma GEMM at full width on every tile
    plan the served shapes reach: the decode tile at C <= 16 (n8 and n16,
    its splits summed in a cluster), the 64-row tile with one and two
    consumer warpgroups above, ragged capacity, split and unsplit
    projections (the column scale applied in the epilogue or after the
    split sum), and the gated two-tile stage."""
    args = _q8_args(_served_ffn(E, C, glu, 50 + C + E), "bfloat16", cuda)
    got = ops.expert_ffn_q(*args, act=act)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (E, C, 768)
    want = ref.expert_ffn_q_ref(*args, act=act)
    _close(got.float().cpu(), want.float().cpu(), BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("glu,act", [(False, "gelu"), (True, "silu")])
@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("C", [1, 8, 12, 77, 129, 640])
def test_expert_ffn_q4_hopper_gemm_matches_plain(cuda, C, E, glu, act):
    """Packed int4 weights (group 64) through the TMA + wgmma GEMM at full
    width, as the q8 case above; each weight is widened to q·s and rounded
    to bf16 where the plain version rounds it."""
    args = _q4_args(_served_ffn(E, C, glu, 70 + C + E), 64, "bfloat16", cuda)
    got = ops.expert_ffn_q4(*args, act=act)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (E, C, 768)
    want = ref.expert_ffn_q4_ref(*args, act=act)
    _close(got.float().cpu(), want.float().cpu(), BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("glu", [False, True])
@pytest.mark.parametrize("group", [32, 48, 1 << 20])   # 1 << 20: the whole axis, one group
def test_expert_ffn_q4_groups_at_a_split_plan(cuda, group, glu):
    """Groups of 32 (two a 64-row stage), 48 (straddling the stages) and the
    whole axis, at [2, 8] where the down-projection splits K eight ways."""
    E, C = 2, 8
    assert gemm_plan(E, C, 768, 3072, fmt="int4", group=min(group, 3072))[2] > 1
    args = _q4_args(_served_ffn(E, C, glu, 90 + group % 97), group, "bfloat16", cuda)
    got = ops.expert_ffn_q4(*args, act="gelu")
    torch.cuda.synchronize()
    want = ref.expert_ffn_q4_ref(*args, act="gelu")
    _close(got.float().cpu(), want.float().cpu(), BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,E", [("int8", 8), ("int4", 3)])
def test_expert_ffn_quantised_split_is_deterministic(cuda, fmt, E):
    """At its split decode plan (int8: 5b's 8 slots, int4: 5c's 3 warm
    slots) each format sums its fp32 partials in a fixed order: two runs on
    the same inputs are bit-identical."""
    assert gemm_plan(E, 8, 768, 3072, fmt=fmt, group=64)[2] > 1
    arrs = _served_ffn(E, 8, False, 110)
    if fmt == "int8":
        args, fn = _q8_args(arrs, "bfloat16", cuda), ops.expert_ffn_q
    else:
        args, fn = _q4_args(arrs, 64, "bfloat16", cuda), ops.expert_ffn_q4
    a, b = fn(*args, act="gelu"), fn(*args, act="gelu")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (100, 30.0)])
def test_flash_decode_paged_kernel_split_edge_cases(cuda, window, cap, dtype):
    """5c's shape (8 lanes, 32 pages of 16, the plan's 4 ranks of 64-key
    tiles), where the split divides each lane's live keys: fewer live pages
    than ranks, a lane whose only page is its last entry, no valid key,
    spilled entries, and a position past the allocated pages."""
    B, H, D, page, Mp = 8, 12, 64, 16, 32
    assert decode_plan(B, H, Mp * page, 1, D, getattr(torch, dtype)) == 4
    table = np.arange(B * Mp, dtype=np.int32).reshape(B, Mp)
    pos = np.full((B,), Mp * page - 1, np.int32)
    table[1, 1:] = -1                # one live page
    pos[1] = 9
    table[2, :-1] = -1               # its only page the last entry
    table[3, :] = -1                 # no valid key
    table[4, ::3] = -1               # spilled entries
    pos[5] = 5 * page + 3            # past its allocated pages
    table[6, 2:] = -1                # two live pages
    q, kp, vp, pt = _paged_inputs(B, H, H, D, page, B * Mp, table, dtype, cuda)
    p = torch.from_numpy(pos).to(cuda)
    got = ops.flash_decode_paged(q, kp, vp, pt, p, window=window, cap=cap)
    torch.cuda.synchronize()
    want = ref.flash_decode_paged_ref(q, kp, vp, pt, p, window, cap)
    _close(got.float().cpu(), want.cpu(), F32_TOL if dtype == "float32" else 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_flash_decode_split_is_deterministic(cuda, paged):
    """At the served plan (8 lanes x 12 kv heads over 512 keys, 4 ranks) the
    ranks' partials merge in rank order: two runs are bit-identical."""
    B, H, D, page, Mp = 8, 12, 64, 16, 32
    assert decode_plan(B, H, Mp * page, 1, D, torch.bfloat16) > 1
    q, kp, vp, pt = _paged_inputs(B, H, H, D, page, B * Mp, np.arange(B * Mp).reshape(B, Mp),
                                  "bfloat16", cuda)
    pos = torch.tensor([Mp * page - 1 - 37 * i for i in range(B)], dtype=torch.int32,
                       device=cuda)
    if paged:
        args, fn = (q, kp, vp, pt, pos), ops.flash_decode_paged
    else:
        k, v = (x[:-1].reshape(B, Mp * page, H, D).contiguous() for x in (kp, vp))
        sp = torch.arange(Mp * page, dtype=torch.int32, device=cuda).expand(B, -1).contiguous()
        args, fn = (q, k, v, sp, pos), ops.flash_decode
    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


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


# ---------------------------------------------------------------------------
# the attention-family configs' shapes: GQA group 16 (qwen3-moe-235b-a22b),
# head_dim 160 (stablelm-12b) and 256 (gemma2-9b, window 4096 and softcap
# 50), and the GLU expert FFN at deepseek-moe-16b's [d 2048, F 1408] and
# qwen3's [4096, 1536]
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,match", [
    ("group 17", "need a group of 1..16"), ("head_dim 96", "head_dim 96"),
    ("paged group 32", "need a group of 1..16"), ("cpu", "needs CUDA"),
])
def test_flash_decode_cuda_refusals(case, match):
    """Shapes are refused before the device: a group above 16 or a head_dim
    outside (32, 64, 128, 160, 256) raises a ValueError naming the kernel."""
    B, S, K, D = 1, 8, 2, 128
    H = {"group 17": 34, "paged group 32": 64}.get(case, 4)
    D = 96 if case == "head_dim 96" else D
    q = torch.zeros(B, H, D, dtype=torch.bfloat16)
    if case.startswith("paged"):
        kp = torch.zeros(3, 4, K, D, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=f"flash_decode_paged: .*{match}"):
            flash_decode_paged_cuda(q, kp, kp, torch.zeros(B, 2, dtype=torch.int32),
                                    torch.zeros(B, dtype=torch.int32))
        return
    k = torch.zeros(B, S, K, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        flash_decode_cuda(q, k, k, torch.zeros(B, S, dtype=torch.int32),
                          torch.zeros(B, dtype=torch.int32))


def test_flash_prefill_refuses_head_dims_outside_the_set():
    for D in (96, 192, 512):
        q = torch.zeros(1, 8, 2, D, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=f"flash_prefill: head_dim {D}"):
            flash_prefill_cuda(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D,window,cap", [
    (2, 300, 64, 4, 128, 0, 0.0),        # qwen3-moe's GQA 16
    (2, 200, 32, 8, 160, 0, 0.0),        # stablelm-12b
    (1, 300, 16, 8, 256, 64, 50.0),      # gemma2-9b's local layer, cut to a 64 window
    (1, 77, 16, 8, 256, 0, 50.0),        # gemma2-9b's global layer
    (2, 65, 6, 2, 160, 17, 30.0),
])
def test_flash_prefill_kernel_matches_plain_at_family_shapes(cuda, B, S, H, K, D, window, cap,
                                                             dtype):
    q, k, v = (_t(_np(s, 60 + i), dtype).to(cuda)
               for i, s in enumerate([(B, S, H, D), (B, S, K, D), (B, S, K, D)]))
    got = ops.flash_prefill(q, k, v, window=window, cap=cap)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    want = ref.flash_prefill_ref(q, k, v, window, cap, True)
    _close(got.float().cpu(), want.cpu(), F32_TOL if dtype == "float32" else 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D,pos,wrap,window,cap", [
    (8, 512, 64, 4, 128, [700, 5, 511, 512, 1023, 0, 64, 300], True, 0, 0.0),   # G 16
    (3, 100, 48, 4, 64, [150, 37, 99], True, 24, 30.0),           # G 12: blocks of 8 and 4
    (4, 300, 32, 8, 160, [299, 310, 5, 600], True, 0, 0.0),       # D 160
    (2, 512, 16, 8, 256, [4000, 511], True, 128, 50.0),           # D 256, window + cap
    (2, 40, 16, 1, 256, [-1, 30], False, 0, 0.0),                 # G 16, D 256, no valid key
])
def test_flash_decode_kernel_matches_plain_at_family_shapes(cuda, B, S, H, K, D, pos, wrap, window,
                                                            cap, dtype):
    q, k, v, sp, p = _decode_inputs(B, S, H, K, D, pos, wrap, dtype, cuda, seed=70)
    got = ops.flash_decode(q, k, v, sp, p, window=window, cap=cap)
    again = ops.flash_decode(q, k, v, sp, p, window=window, cap=cap)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ref.flash_decode_ref(q, k, v, sp, p, window, cap)
    _close(got.float().cpu(), want.cpu(), F32_TOL if dtype == "float32" else 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,K,D,page,window,cap", [
    (64, 4, 128, 16, 0, 0.0), (32, 8, 160, 8, 0, 0.0), (16, 8, 256, 4, 6, 50.0),
    (16, 1, 256, 8, 0, 0.0),
])
def test_flash_decode_paged_kernel_matches_plain_at_family_shapes(cuda, H, K, D, page, window,
                                                                  cap, dtype):
    n_pages = 12
    table = [[0, 1, 2, 3, 4], [-1, 5, -1, 6, 7], [8, 9, 10, -1, -1], [-1, -1, -1, -1, 11]]
    q, kp, vp, pt = _paged_inputs(4, H, K, D, page, n_pages, table, dtype, cuda, seed=80)
    pos = torch.tensor([5 * page - 1, 4 * page - 2, 7 * page, 2], dtype=torch.int32, device=cuda)
    got = ops.flash_decode_paged(q, kp, vp, pt, pos, window=window, cap=cap)
    torch.cuda.synchronize()
    want = ref.flash_decode_paged_ref(q, kp, vp, pt, pos, window, cap)
    _close(got.float().cpu(), want.cpu(), F32_TOL if dtype == "float32" else 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("E,C,d,F", [
    (16, 8, 2048, 1408), (6, 96, 2048, 1408),      # deepseek: decode and a batch block
    (32, 8, 4096, 1536), (4, 200, 4096, 1536),     # qwen3
])
def test_glu_expert_ffn_kernels_match_plain_at_family_shapes(cuda, E, C, d, F, fmt):
    """SwiGLU at the MoE families' widths in bf16, on every slot format. The
    weights at the models' own init scale, 1/sqrt(fan-in), so that the
    outputs are O(1) as the served layer's are (the bf16 error of h grows
    with its magnitude)."""
    xe = _np((E, C, d), C)
    wi, wg = _np((E, d, F), C + 1, d ** -0.5), _np((E, d, F), C + 2, d ** -0.5)
    wo = _np((E, F, d), C + 3, F ** -0.5)
    x = _t(xe, "bfloat16").to(cuda)
    if fmt == "bf16":
        args, fn, pfn = [x] + [_t(a, "bfloat16").to(cuda) for a in (wi, wg, wo)], \
            ops.expert_ffn, ref.expert_ffn_ref
    elif fmt == "int8":
        args = [x]
        for a in (wi, wg, wo):
            qa, sa = _quantized(a)
            args += [qa.to(cuda), sa.to(cuda)]
        fn, pfn = ops.expert_ffn_q, ref.expert_ffn_q_ref
    else:
        args = [x]
        for a in (wi, wg, wo):
            qa, sa = _quantized4(a, 64)
            args += [qa.to(cuda), sa.to(cuda)]
        fn, pfn = ops.expert_ffn_q4, ref.expert_ffn_q4_ref
    got = fn(*args, act="silu")
    torch.cuda.synchronize()
    want = pfn(*args, act="silu")
    _close(got.float().cpu(), want.float().cpu(), BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["int8-channel", "int8-tensor", "int4-64"])
@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048)])   # deepseek's w_in / w_gate, w_out
def test_store_quantisation_on_the_card_equals_the_cpu(cuda, k, n, fmt, dtype):
    """`ExpertStore` quantises its host masters on its own device: on the
    card the bytes and scales are the CPU's (and so the reference's numpy,
    test_torch_quantized / test_torch_tiering), bit for bit, at one MoE
    layer of deepseek-moe-16b's 64 experts."""
    from repro_torch.core.offload import quantize_stack_int4, quantize_stack_int8

    gen = torch.Generator(device=cuda).manual_seed(k + n)
    full = (torch.randn((1, 64, k, n), generator=gen, device=cuda) * k ** -0.5)
    full[0, 3, :, 7] = 0.0                                   # an all-zero channel (the 1e-8 floor)
    full = full.to(getattr(torch, dtype)).cpu()
    kind, arg = fmt.split("-")
    if kind == "int8":
        on_card, on_cpu = (quantize_stack_int8(full, dev, arg) for dev in (cuda, "cpu"))
    else:
        on_card, on_cpu = (quantize_stack_int4(full, dev, int(arg)) for dev in (cuda, "cpu"))
    for got, want in zip(on_card, on_cpu):
        assert got.device.type == "cpu" and got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the backwards of the training kernels on the card: each Function's
# gradient against autograd over the plain version on the same inputs, at
# the training forward's shapes (switch-base-8, [8, 128] tokens) and in bf16
# ---------------------------------------------------------------------------


def _card_vs_plain_grads(fn, plain, inputs, dtype, seed=9):
    """Gradients of <fn(inputs), ct> through the wrapper (the kernel's
    Function) and through autograd over `plain`, each leaf within
    tol * max(1, max|g_plain|) (fp32 1e-4, bf16 5e-2)."""
    a = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
    b = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*a)
    assert out.grad_fn is not None
    ct = torch.from_numpy(_np(tuple(out.shape), seed)).to(out.device, out.dtype)
    got = torch.autograd.grad(out, [t for t in a if t is not None], ct)
    want = torch.autograd.grad(plain(*b), [t for t in b if t is not None], ct)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, w in zip(got, want):
        g, w = g.float().cpu(), w.float().cpu()
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= tol * max(1.0, float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,d,F,glu,act,dtype", [
    (8, 160, 768, 3072, False, "gelu", "float32"),    # switch-base-8's training forward
    (8, 160, 768, 3072, False, "gelu", "bfloat16"),
    (3, 77, 128, 512, True, "silu", "float32"),
])
def test_expert_ffn_backward_on_the_card_matches_plain(cuda, E, C, d, F, glu, act, dtype):
    t = [None if a is None else _t(a, dtype).to(cuda) for a in _ffn_inputs(E, C, d, F, glu)]
    _card_vs_plain_grads(lambda *x: ops.expert_ffn(*x, act=act),
                         lambda *x: ref.expert_ffn_ref(*x, act=act), t, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,window,cap,dtype", [
    (8, 128, 12, 12, 0, 0.0, "float32"),              # switch-base-8's training forward
    (8, 128, 12, 12, 0, 0.0, "bfloat16"),
    (2, 96, 8, 2, 32, 30.0, "float32"),
])
def test_flash_prefill_backward_on_the_card_matches_plain(cuda, B, S, H, K, window, cap, dtype):
    q, k, v = (_t(_np(s, i), dtype).to(cuda) for i, s in enumerate(
        ((B, S, H, 64), (B, S, K, 64), (B, S, K, 64))))
    _card_vs_plain_grads(
        lambda q, k, v: ops.flash_prefill(q, k, v, window=window, cap=cap),
        lambda q, k, v: ref.flash_prefill_ref(q, k, v, window=window, cap=cap).to(q.dtype),
        [q, k, v], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,S_kv,H,K", [
    (2, 64, 512, 16, 16),        # seamless's cross-attention at phase 13's shape
    (2, 17, 1, 4, 4), (1, 65, 63, 10, 2), (2, 300, 65, 25, 5), (1, 1, 200, 8, 8),
    (2, 130, 129, 4, 1),
])
def test_flash_prefill_cross_attention_matches_plain(cuda, B, S, S_kv, H, K, dtype):
    """A key length of its own (unmasked): S_kv below, at and across the
    64-key tile edge and not a whole number of tiles, forward and backward."""
    q, k, v = (_t(_np(s, 90 + i), dtype).to(cuda)
               for i, s in enumerate([(B, S, H, 64), (B, S_kv, K, 64), (B, S_kv, K, 64)]))
    got = ops.flash_prefill(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and tuple(got.shape) == (B, S, H, 64)
    want = ref.flash_prefill_ref(q, k, v, causal=False)
    _close_attention(got, want, ref.flash_prefill_ref(q, k, v.abs(), causal=False), dtype)
    _card_vs_plain_grads(
        lambda q, k, v: ops.flash_prefill(q, k, v, causal=False),
        lambda q, k, v: ref.flash_prefill_ref(q, k, v, causal=False).to(q.dtype),
        [q, k, v], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,window,causal", [
    (2, 300, 64, True), (1, 4096, 2048, True), (2, 129, 0, False), (2, 77, 0, True),
])
def test_flash_prefill_at_group_5_matches_plain(cuda, B, S, window, causal, dtype):
    """hymba's 25 query heads over 5 kv heads of 64: the tensor-core body's
    64-row blocks at a group of 5, windowed (its 2048 window over a 4096
    prompt), unwindowed, non-causal; forward, and backward below 4096."""
    q, k, v = (_t(_np(s, 100 + i), dtype).to(cuda)
               for i, s in enumerate([(B, S, 25, 64), (B, S, 5, 64), (B, S, 5, 64)]))
    got = ops.flash_prefill(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_prefill_ref(q, k, v, window, 0.0, causal)
    _close_attention(got, want, ref.flash_prefill_ref(q, k, v.abs(), window, 0.0, causal), dtype)
    if S < 4096:
        _card_vs_plain_grads(
            lambda q, k, v: ops.flash_prefill(q, k, v, window=window, causal=causal),
            lambda q, k, v: ref.flash_prefill_ref(q, k, v, window, 0.0, causal).to(q.dtype),
            [q, k, v], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,pos,wrap,window", [
    (2, 2048, [4000, 100], True, 2048),      # hymba: its ring and window
    (3, 64, [150, 37, 63], True, 64),        # phase 13(d)'s cut window, wrapped
    (2, 77, [76, 10], False, 0),
])
def test_flash_decode_at_group_5_matches_plain(cuda, B, S, pos, wrap, window, dtype):
    """G 5 over D 64: a block's 8 head rows, 3 idle."""
    q, k, v, sp, p = _decode_inputs(B, S, 25, 5, 64, pos, wrap, dtype, cuda, seed=110)
    got = ops.flash_decode(q, k, v, sp, p, window=window)
    torch.cuda.synchronize()
    want = ref.flash_decode_ref(q, k, v, sp, p, window, 0.0)
    _close_attention(got, want, ref.flash_decode_ref(q, k, v.abs(), sp, p, window, 0.0), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,cross_len", [
    (2, 512, 16, 16, [512, 512]),            # seamless at phase 13's encoder length
    (3, 100, 16, 16, [100, 37, 1]),          # ragged encoder lengths
    (2, 65, 25, 5, [65, 64]),
])
def test_flash_decode_cross_form_matches_plain(cuda, B, S, H, K, cross_len, dtype):
    """Cross-attention's read of a fixed encoder cache: slot_pos 0 below
    cross_len and -1 above, the query at position 0, no window."""
    q, k, v, _, _ = _decode_inputs(B, S, H, K, 64, [0] * B, False, dtype, cuda, seed=120)
    n = torch.tensor(cross_len, dtype=torch.int32)
    sp = torch.where(torch.arange(S)[None, :] < n[:, None], 0, -1).to(torch.int32).to(cuda)
    zero = torch.zeros(B, dtype=torch.int32, device=cuda)
    got = ops.flash_decode(q, k, v, sp, zero)
    torch.cuda.synchronize()
    want = ref.flash_decode_ref(q, k, v, sp, zero)
    _close_attention(got, want, ref.flash_decode_ref(q, k, v.abs(), sp, zero), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_sparsemax_backward_on_the_card_matches_plain(cuda, masked):
    z = torch.from_numpy(_np((8, 128, 128), 0, 3.0))       # the TKD forward's scores
    if masked:
        z = torch.where(torch.ones(128, 128, dtype=torch.bool).tril(), z, torch.tensor(-1e30))
    _card_vs_plain_grads(ops.sparsemax, ref.sparsemax_ref, [z.to(cuda).contiguous()], "float32")
