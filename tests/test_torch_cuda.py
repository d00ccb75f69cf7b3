"""Port kernels on the card against their plain PyTorch versions.

Card-only (marked `gpu`): each CUDA kernel at misaligned shapes, both
dtypes, against its plain version on the same inputs.  Imports no JAX, so
it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels import tolerance
from repro_torch.kernels.flash_attention.ops import (flash_attention, flash_attention_bwd,
                                                     flash_attention_fwd, paged_decode)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref, paged_decode_ref)
from repro_torch.kernels.fused_mlp.backward import fused_mlp_bwd_ref
from repro_torch.kernels.fused_mlp.ops import fused_mlp_bwd, fused_mlp_hidden
from repro_torch.kernels.fused_mlp.ref import fused_mlp_hidden_ref
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.ssd.ops import ssd_chunk
from repro_torch.kernels.ssd.ref import ssd_chunk_ref
from repro_torch.models import apply_lm, init_lm, lm_loss
from repro_torch.models.linear import linear
from repro_torch.optim.adamw import init_opt, tree_leaves, tree_map
from repro_torch.train.train_step import make_train_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, device, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(
        device=device, dtype=dtype)


def _close(got, want, tol):
    """Each element within its own bound (kernels/tolerance.py)."""
    ok, err, ratio = tolerance.check(got, want, tol)
    assert ok, (err, ratio)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(64, 2048, 1024), (37, 70, 45), (1, 512, 200),
                                   (130, 4096, 96), (64, 64, 92544)])
def test_matmul(cuda, dtype, m, k, n):
    rng = np.random.default_rng(0)
    a = _rand(rng, (m, k), dtype, cuda)
    b = _rand(rng, (k, n), dtype, cuda, k ** -0.5)
    before = matmul.launches
    got = matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    want = matmul_ref(a, b)
    _close(got, want, tolerance.matmul_tol(a, b, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("m,h,f", [(64, 256, 512), (19, 72, 200), (130, 128, 96)])
def test_fused_mlp(cuda, dtype, mlp_type, m, h, f):
    rng = np.random.default_rng(1)
    x = _rand(rng, (m, h), dtype, cuda)
    wg = _rand(rng, (h, f), dtype, cuda, h ** -0.5)
    wu = _rand(rng, (h, f), dtype, cuda, h ** -0.5)
    got = fused_mlp_hidden(x, wg, wu, mlp_type=mlp_type)
    torch.cuda.synchronize()
    want = fused_mlp_hidden_ref(x, wg, wu, mlp_type)
    _close(got, want, tolerance.fused_mlp_hidden_tol(x, wg, wu, mlp_type, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_max,g,d", [(72, 2, 128), (200, 3, 64), (128, 1, 256), (90, 12, 128),
                                       (130, 16, 64)])
def test_paged_decode(cuda, dtype, s_max, g, d):
    rng = np.random.default_rng(2)
    slots, nkv, b = 9, 2, 6
    q = _rand(rng, (b, nkv * g, d), dtype, cuda)
    kp = _rand(rng, (slots, s_max, nkv, d), dtype, cuda)
    vp = _rand(rng, (slots, s_max, nkv, d), dtype, cuda)
    slot_idx = torch.tensor([4, 0, 8, 2, 7, 1], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([17, 0, s_max, 1, 65, s_max - 3], dtype=torch.int32, device=cuda)
    got = paged_decode(q, kp, vp, slot_idx, lengths)
    torch.cuda.synchronize()
    want = paged_decode_ref(q, kp, vp, slot_idx, lengths)
    assert torch.all(got[1] == 0)
    _close(got, want, tolerance.paged_decode_tol(q, kp, vp, slot_idx, lengths, want))


def _blocktable_case(rng, bs, g, d, dtype, device, quant, lengths=(130, 64, 77, 0, 33)):
    """Five rows over a pool of physical blocks of `bs` tokens: permuted
    ids, rows 0 and 2 sharing their first blocks, a dead row (3), lengths
    that cross the 64-token staging width and are not tile multiples, and
    every table entry past a row's live blocks pointing at a garbage block
    of huge values (1e4; an int8 pool's scales), so that a read of it would
    break the bound (the plain version masks it to weight 0)."""
    nkv = 2
    lengths = list(lengths)
    need = [-(-n // bs) for n in lengths]
    max_blocks = max(need) + 1
    nb = sum(need) + 1
    garbage = nb - 1
    ids = rng.permutation(nb - 1).tolist()
    tables = np.full((5, max_blocks), garbage, np.int32)
    for r, n in enumerate(need):
        for j in range(n):
            tables[r, j] = ids.pop()
    shared = min(need[0], need[2], 2)
    tables[2, :shared] = tables[0, :shared]
    q = _rand(rng, (5, nkv * g, d), dtype, device)
    shape = (nb, bs, nkv, d)
    if quant:
        from repro_torch.quant import quantize_kv
        (kp, ks), (vp, vs) = (quantize_kv(_rand(rng, shape, torch.float32, device))
                              for _ in range(2))
        ks[garbage], vs[garbage] = 1e4, 1e4
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = _rand(rng, shape, dtype, device), _rand(rng, shape, dtype, device)
        kp[garbage], vp[garbage] = 1e4, 1e4
        sc = {}
    return (q, kp, vp, torch.from_numpy(tables).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device), sc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("bs,g,d", [(4, 1, 64), (8, 2, 128), (16, 3, 64), (64, 2, 128),
                                    (16, 2, 128), (16, 12, 128), (8, 16, 64), (64, 12, 128)])
def test_paged_decode_blocktable(cuda, dtype, quant, bs, g, d):
    """The block-table kernel, float and int8 pools, against its plain
    version: each element within its bound, the dead row exactly zero, and
    the garbage block never read."""
    from repro_torch.kernels.flash_attention.ops import paged_decode_blocktable
    from repro_torch.kernels.flash_attention.ref import paged_decode_blocktable_ref
    q, kp, vp, tables, lengths, sc = _blocktable_case(np.random.default_rng(bs + g + d), bs, g,
                                                      d, dtype, cuda, quant)
    counter = "int8_launches" if quant else "launches"
    before = getattr(paged_decode_blocktable, counter)
    got = paged_decode_blocktable(q, kp, vp, tables, lengths, **sc)
    torch.cuda.synchronize()
    assert getattr(paged_decode_blocktable, counter) == before + 1
    want = paged_decode_blocktable_ref(q, kp, vp, tables, lengths, **sc)
    assert torch.isfinite(want).all() and torch.all(got[3] == 0)
    _close(got, want, tolerance.paged_decode_blocktable_tol(q, kp, vp, tables, lengths, want,
                                                             **sc))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_max,g,d", [(72, 2, 128), (200, 3, 64), (128, 1, 256), (90, 12, 128),
                                       (130, 16, 64)])
def test_paged_decode_int8(cuda, dtype, s_max, g, d):
    """The slot kernel over an int8 pool (f32 scales per (token, kv head)):
    permuted slots, dead slots, depths that 64 does not divide."""
    from repro_torch.quant import quantize_kv
    rng = np.random.default_rng(3)
    slots, nkv, b = 9, 2, 6
    q = _rand(rng, (b, nkv * g, d), dtype, cuda)
    (kp, ks), (vp, vs) = (quantize_kv(_rand(rng, (slots, s_max, nkv, d), torch.float32, cuda))
                          for _ in range(2))
    slot_idx = torch.tensor([4, 0, 8, 2, 7, 1], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([17, 0, s_max, 1, 65, s_max - 3], dtype=torch.int32, device=cuda)
    before = (paged_decode.launches, paged_decode.int8_launches)
    got = paged_decode(q, kp, vp, slot_idx, lengths, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (paged_decode.launches, paged_decode.int8_launches) == (before[0], before[1] + 1)
    want = paged_decode_ref(q, kp, vp, slot_idx, lengths, k_scale=ks, v_scale=vs)
    assert torch.all(got[1] == 0)
    _close(got, want, tolerance.paged_decode_tol(q, kp, vp, slot_idx, lengths, want,
                                                 k_scale=ks, v_scale=vs))


def _split(b, nkv, g, d, capacity, quant):
    """Tokens a block of the bf16 kernel takes at this shape."""
    from repro_torch.kernels.flash_attention.ops import paged_launch
    return paged_launch(b, nkv, g, d, capacity, 1 if quant else 2).split


def _slot_case(rng, s_max, g, d, dtype, device, quant, lengths):
    """Rows over a slot pool (permuted slots, nkv 2) whose positions past
    each row's length hold huge values (1e4; an int8 pool's scales), so that
    a read of one breaks the bound (the plain version masks it)."""
    nkv, b = 2, len(lengths)
    slots = b + 2
    q = _rand(rng, (b, nkv * g, d), dtype, device)
    slot_idx = torch.from_numpy(rng.permutation(slots)[:b].astype(np.int32)).to(device)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    dead = (torch.arange(s_max, device=device)[None, :] >= lengths[:, None])   # (b, s_max)
    shape = (slots, s_max, nkv, d)
    if quant:
        from repro_torch.quant import quantize_kv
        (kp, ks), (vp, vs) = (quantize_kv(_rand(rng, shape, torch.float32, device))
                              for _ in range(2))
        for t in (ks, vs):
            t[slot_idx.long()] = torch.where(dead[..., None], 1e4, t[slot_idx.long()])
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = _rand(rng, shape, dtype, device), _rand(rng, shape, dtype, device)
        for t in (kp, vp):
            t[slot_idx.long()] = torch.where(dead[..., None, None], 1e4, t[slot_idx.long()])
        sc = {}
    return q, kp, vp, slot_idx, lengths, sc


def _check_slot(q, kp, vp, slot_idx, lengths, sc):
    before = paged_decode.int8_launches if sc else paged_decode.launches
    got = paged_decode(q, kp, vp, slot_idx, lengths, **sc)
    torch.cuda.synchronize()
    assert (paged_decode.int8_launches if sc else paged_decode.launches) == before + 1
    want = paged_decode_ref(q, kp, vp, slot_idx, lengths, **sc)
    assert torch.isfinite(want).all()
    assert torch.all(got[lengths == 0] == 0)
    _close(got, want, tolerance.paged_decode_tol(q, kp, vp, slot_idx, lengths, want, **sc))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("g", [2, 12])
def test_paged_decode_split_boundaries(cuda, dtype, quant, g):
    """Lengths on a split boundary of the bf16 kernel, one token past it and
    one short of it (at the first and the last boundary), a live length of
    1 and a dead row; every position past a length holds garbage."""
    s_max, d = 200, 128
    sp = _split(8, 2, g, d, s_max, quant)
    last = (s_max - 1) // sp * sp
    lengths = [sp, sp + 1, sp - 1, 1, 0, last, last + 1, s_max]
    _check_slot(*_slot_case(np.random.default_rng(g), s_max, g, d, dtype, cuda, quant, lengths))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_deep_pool(cuda, dtype, quant):
    """A 2048-deep pool: 8 splits, each walking several tiles through the
    ring; full, near-full, split-boundary, short and dead rows."""
    s_max, g, d = 2048, 2, 128
    sp = _split(6, 2, g, d, s_max, quant)
    assert sp * 8 >= s_max and sp > 64   # the cluster limit stretched the split
    lengths = [s_max, s_max - 1, 3 * sp, 3 * sp + 1, 1, 0]
    _check_slot(*_slot_case(np.random.default_rng(5), s_max, g, d, dtype, cuda, quant, lengths))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("g,d", [(24, 128), (48, 64), (72, 128)])
def test_paged_decode_wide_group(cuda, dtype, quant, g, d):
    """More query heads than the old 16-wide block: 24 and 48 in one block
    of the bf16 kernel, 72 in two."""
    lengths = [130, 64, 0, 1, 33]
    _check_slot(*_slot_case(np.random.default_rng(g), 130, g, d, dtype, cuda, quant, lengths))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("bs,g", [(16, 2), (64, 12)])
def test_paged_decode_blocktable_split_boundaries(cuda, dtype, quant, bs, g):
    """The block-table kernel at lengths on, past and short of a split
    boundary, a live length of 1 and a dead row; the garbage block stays
    unread."""
    from repro_torch.kernels.flash_attention.ops import paged_decode_blocktable
    from repro_torch.kernels.flash_attention.ref import paged_decode_blocktable_ref
    sp = _split(5, 2, g, 128, 256, quant)
    q, kp, vp, tables, lengths, sc = _blocktable_case(
        np.random.default_rng(bs + g), bs, g, 128, dtype, cuda, quant,
        lengths=(sp + 1, sp, sp - 1, 0, 1))
    got = paged_decode_blocktable(q, kp, vp, tables, lengths, **sc)
    torch.cuda.synchronize()
    want = paged_decode_blocktable_ref(q, kp, vp, tables, lengths, **sc)
    assert torch.isfinite(want).all() and torch.all(got[3] == 0)
    _close(got, want, tolerance.paged_decode_blocktable_tol(q, kp, vp, tables, lengths, want,
                                                             **sc))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_paged_decode_forced_geometry(cuda, quant, tile, splits):
    """The bf16 kernel at each tile and number of splits, whatever
    `paged_launch` would pick here: one split (the output straight from the
    registers, a dead row's zeros) and clusters of 2, 3 and 8."""
    from repro_torch.kernels.flash_attention.ops import _paged_cuda
    q, kp, vp, slot_idx, lengths, sc = _slot_case(
        np.random.default_rng(tile + splits), 200, 12, 128, torch.bfloat16, cuda, quant,
        [200, 64, 65, 0, 1, 127])
    got = _paged_cuda(paged_decode, q, kp, vp, sc.get("k_scale"), sc.get("v_scale"), slot_idx,
                      lengths, 0, None, geometry=(tile, splits))
    torch.cuda.synchronize()
    want = paged_decode_ref(q, kp, vp, slot_idx, lengths, **sc)
    assert torch.all(got[3] == 0)
    _close(got, want, tolerance.paged_decode_tol(q, kp, vp, slot_idx, lengths, want, **sc))


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_empty_batch_counts_no_launch(cuda, quant):
    """A call with no rows launches nothing, so neither wrapper's count moves."""
    from repro_torch.kernels.flash_attention.ops import paged_decode_blocktable
    from repro_torch.quant import quantize_kv
    q = torch.zeros((0, 4, 64), dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros((3, 16, 2, 64), device=cuda)
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(pool), quantize_kv(pool)
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kp = vp = pool.to(torch.bfloat16)
        sc = {}
    idx = torch.zeros(0, dtype=torch.int32, device=cuda)
    tables = torch.zeros((0, 1), dtype=torch.int32, device=cuda)

    def counts():
        return [getattr(f, c) for f in (paged_decode, paged_decode_blocktable)
                for c in ("launches", "int8_launches")]

    before = counts()
    assert paged_decode(q, kp, vp, idx, idx, **sc).shape == (0, 4, 64)
    assert paged_decode_blocktable(q, kp, vp, tables, idx, **sc).shape == (0, 4, 64)
    assert counts() == before


def test_prefix_engine_on_the_card_matches_the_cpu(cuda):
    """The smoke model in f32 through Engine(prefix_cache=True,
    kv_dtype="int8") on the card (block-table int8 kernel) and on the host
    (plain versions): the same greedy tokens, and the kernel launched."""
    from repro_torch.kernels.flash_attention.ops import paged_decode_blocktable
    from repro_torch.serving.engine import BucketPolicy, Engine, synthetic_requests
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype="float32",
                              linear_impl="fused")
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    reqs = synthetic_requests(8, pattern="burst", min_prompt=18, max_prompt=30, min_new=3,
                              max_new=8, vocab=cfg.vocab_size, prefix_share=0.75,
                              shared_prefix_len=16, seed=29)
    policy = BucketPolicy(num_slots=4, prompt_buckets=(16, 32), seq_max=64)
    runs = []
    for dev, p in (("cpu", params), (cuda, _to(params, cuda))):
        eng = Engine(p, cfg, policy=policy, use_paged_kernel=True, prefix_cache=True,
                     block_size=8, kv_dtype="int8", device=dev)
        before = paged_decode_blocktable.int8_launches
        done, stats = eng.run(reqs, check_invariants=True)
        runs.append(([c.tokens for c in done], paged_decode_blocktable.int8_launches - before,
                     stats))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == 0 and runs[1][1] == runs[1][2].decode_steps * cfg.num_layers > 0
    assert runs[1][2].cache_hit_requests >= 2


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):   # a QuantizedTensor: payload, scales, axis
        return type(tree)(*(_to(v, device) if torch.is_tensor(v) else v for v in tree))
    return tree.detach().to(device)


def test_tied_head_through_the_kernels(cuda):
    """A tied output head (embed^T, not contiguous) runs through the tile
    GEMM and agrees with the plain path in f32."""
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), tie_embeddings=True,
                              dtype="float32", linear_impl="pallas")
    params = init_lm(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    assert "lm_head" not in params
    toks = torch.randint(0, cfg.vocab_size, (2, 13), device=cuda)
    before = matmul.launches
    got, _, _ = apply_lm(params, toks, cfg)
    assert matmul.launches > before
    want, _, _ = apply_lm(params, toks, dataclasses.replace(cfg, linear_impl="jnp"))
    # f32 sums in another order through the smoke model's layers (~1e-6
    # relative per GEMM), as the CPU parity tests allow 5e-5
    torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)


def test_wrappers_raise_on_bad_operands(cuda):
    a = torch.zeros((8, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        matmul(a, a.T.contiguous())
    with pytest.raises(ValueError):  # B neither row-major nor a transposed view
        matmul(torch.zeros((8, 16), device=cuda), torch.zeros((16, 16), device=cuda)[:, ::2].T)
    with pytest.raises(ValueError):  # operands on two devices
        matmul(torch.zeros((8, 16), device=cuda), torch.zeros((16, 8)))
    with pytest.raises(ValueError):  # past the flash kernels' largest head dim, 256
        q = torch.zeros((1, 4, 2, 272), device=cuda)
        flash_attention(q, q, q)


# --- the training slice ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["dgrad", "wgrad", "dgrad pair"])
@pytest.mark.parametrize("m,k,n", [(37, 70, 45), (130, 4096, 96), (64, 256, 2048),
                                   (4096, 2048, 1024)])
def test_matmul_transposed(cuda, dtype, layout, m, k, n):
    """Transposed views read in place: dgrad g @ w^T (w stored (n, k)),
    wgrad x^T @ g (x stored (k, m)), and two dgrad pairs in one sum."""
    rng = np.random.default_rng(3)
    if layout == "wgrad":
        a, b = _rand(rng, (k, m), dtype, cuda).T, _rand(rng, (k, n), dtype, cuda, k ** -0.5)
    else:
        a, b = _rand(rng, (m, k), dtype, cuda), _rand(rng, (n, k), dtype, cuda, k ** -0.5).T
    pair = ((_rand(rng, (m, k), dtype, cuda), _rand(rng, (n, k), dtype, cuda, k ** -0.5).T)
            if layout == "dgrad pair" else (None, None))
    before = matmul.launches
    got = matmul(a, b, *pair)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    want = matmul_ref(a, b, a1=pair[0], b1=pair[1])
    _close(got, want, tolerance.matmul_tol(a, b, want, *pair))


# The bf16 tiles' edges (csrc/gemm_sm90.cuh): rows on either side of the
# 64-row (one warpgroup) and 128-row (two) tiles; k off the 64-column step
# (70: two steps, the second ragged, no split; 4100: split, the last split
# ragged); n off the 64- and 128-column tiles, odd n included; and the
# training rows.  (m, k, n, whether k is split.)
EDGE_CASES = [(m, k, n, k == 4100) for m in (1, 63, 64, 65, 127, 128, 129)
              for k, n in ((70, 200), (4100, 45))]
EDGE_CASES += [(4096, 70, 200, False), (4096, 4100, 45, True), (64, 2048, 92544, False),
               (129, 256, 92544, False), (4096, 1024, 4100, False)]


def _layout_operands(rng, dtype, cuda, layout, m, k, n):
    """(a, b, a1, b1) for `layout`: nn, nt (b a transposed view), tn (a a
    transposed view), or the nt pair."""
    if layout == "tn":
        a, b = _rand(rng, (k, m), dtype, cuda).T, _rand(rng, (k, n), dtype, cuda, k ** -0.5)
    elif layout == "nn":
        a, b = _rand(rng, (m, k), dtype, cuda), _rand(rng, (k, n), dtype, cuda, k ** -0.5)
    else:
        a, b = _rand(rng, (m, k), dtype, cuda), _rand(rng, (n, k), dtype, cuda, k ** -0.5).T
    if layout != "nt pair":
        return a, b, None, None
    return a, b, _rand(rng, (m, k), dtype, cuda), _rand(rng, (n, k), dtype, cuda, k ** -0.5).T


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "nt pair"])
@pytest.mark.parametrize("m,k,n,split", EDGE_CASES)
def test_matmul_tile_edges(cuda, dtype, layout, m, k, n, split):
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul.ops import launch_shape
    _, _, ks = launch_shape(m, n, k, dtype, _build.num_sms(cuda))
    assert (ks < k) == split
    rng = np.random.default_rng(m + k + n)
    a, b, a1, b1 = _layout_operands(rng, dtype, cuda, layout, m, k, n)
    before = matmul.launches
    got = matmul(a, b, a1, b1)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    want = matmul_ref(a, b, a1=a1, b1=b1)
    _close(got, want, tolerance.matmul_tol(a, b, want, a1, b1))


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
def test_fused_mlp_at_the_training_shape(cuda, mlp_type):
    """The forward and the backward (recompute kernel + 3 tile GEMMs) at
    4096 x 2048 x 8192 in bf16: 128 x 128 tiles, 32 k steps."""
    rng = np.random.default_rng(6)
    m, h, f = 4096, 2048, 8192
    x = _rand(rng, (m, h), torch.bfloat16, cuda)
    wg = _rand(rng, (h, f), torch.bfloat16, cuda, h ** -0.5)
    wu = _rand(rng, (h, f), torch.bfloat16, cuda, h ** -0.5)
    dh = _rand(rng, (m, f), torch.bfloat16, cuda)
    got = fused_mlp_hidden(x, wg, wu, mlp_type=mlp_type)
    torch.cuda.synchronize()
    want = fused_mlp_hidden_ref(x, wg, wu, mlp_type)
    _close(got, want, tolerance.fused_mlp_hidden_tol(x, wg, wu, mlp_type, want))
    del got, want
    got = fused_mlp_bwd(x, wg, wu, dh, mlp_type=mlp_type)
    torch.cuda.synchronize()
    want = fused_mlp_bwd_ref(x, wg, wu, dh, mlp_type)
    for g, w, t in zip(got, want, tolerance.fused_mlp_bwd_tol(x, wg, wu, dh, mlp_type, want)):
        assert (g is None) == (w is None)
        if w is not None:
            _close(g, w, t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("m,h,f", [(64, 256, 512), (19, 72, 200), (130, 128, 96)])
def test_fused_mlp_bwd(cuda, dtype, mlp_type, m, h, f):
    rng = np.random.default_rng(4)
    x = _rand(rng, (m, h), dtype, cuda)
    wg = _rand(rng, (h, f), dtype, cuda, h ** -0.5)
    wu = _rand(rng, (h, f), dtype, cuda, h ** -0.5)
    dh = _rand(rng, (m, f), dtype, cuda)
    before = (fused_mlp_bwd.launches, matmul.launches)
    got = fused_mlp_bwd(x, wg, wu, dh, mlp_type=mlp_type)
    torch.cuda.synchronize()
    gemms = 3 if mlp_type == "swiglu" else 2
    assert (fused_mlp_bwd.launches, matmul.launches) == (before[0] + 1, before[1] + gemms)
    want = fused_mlp_bwd_ref(x, wg, wu, dh, mlp_type)
    tols = tolerance.fused_mlp_bwd_tol(x, wg, wu, dh, mlp_type, want)
    for g, w, t in zip(got, want, tols):
        assert (g is None) == (w is None)
        if w is not None:
            _close(g, w, t)


# (b, sq, skv, a, nkv, d, causal): causal with sq == skv and, top-left,
# with sq != skv; non-causal with sq != skv; g in {1, 2, 4}, lengths off the
# 64-row tiles; head dims padded in shared memory (20, 40, 80, 192: the
# paper's misaligned ones; 33, 100, 250: rows of 2-, 8- and 4-byte multiples)
FLASH_CASES = [(2, 72, 72, 4, 4, 64, True), (1, 200, 200, 4, 2, 128, True),
               (2, 40, 90, 8, 2, 16, False), (1, 130, 61, 4, 1, 32, False),
               (1, 256, 256, 16, 8, 128, True), (2, 100, 100, 4, 1, 20, True),
               (1, 70, 131, 8, 2, 40, False), (1, 150, 150, 8, 2, 80, True),
               (1, 65, 65, 2, 2, 80, False), (1, 90, 90, 4, 1, 192, True),
               (1, 77, 140, 6, 3, 192, False), (1, 50, 50, 2, 1, 33, True),
               (1, 70, 70, 4, 2, 100, True), (1, 64, 96, 2, 2, 250, False),
               (1, 70, 130, 4, 2, 64, True), (1, 130, 70, 4, 2, 80, True)]


def _flash_inputs(rng, dtype, cuda, b, sq, skv, a, nkv, d):
    return (_rand(rng, (b, sq, a, d), dtype, cuda), _rand(rng, (b, skv, nkv, d), dtype, cuda),
            _rand(rng, (b, skv, nkv, d), dtype, cuda), _rand(rng, (b, sq, a, d), dtype, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,a,nkv,d,causal", FLASH_CASES)
def test_flash_attention_fwd(cuda, dtype, b, sq, skv, a, nkv, d, causal):
    rng = np.random.default_rng(5)
    q, k, v, _ = _flash_inputs(rng, dtype, cuda, b, sq, skv, a, nkv, d)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    t_out, t_lse = tolerance.flash_attention_tol(q, k, v, want, causal=causal)
    _close(out, want[0], t_out)
    _close(lse, want[1], t_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,a,nkv,d,causal", FLASH_CASES)
def test_flash_attention_bwd(cuda, dtype, b, sq, skv, a, nkv, d, causal):
    rng = np.random.default_rng(6)
    q, k, v, do = _flash_inputs(rng, dtype, cuda, b, sq, skv, a, nkv, d)
    o, lse = flash_attention_ref(q, k, v, causal=causal)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    tols = tolerance.flash_attention_bwd_tol(q, k, v, o, lse, do, want, causal=causal)
    for g, w, t in zip(got, want, tols):
        _close(g, w, t)


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


# gradients of each autograd.Function against autograd through the plain
# path on the same card: f32 sums in another order (~1e-6 relative); bf16
# roundings of every output and of P / dS / dg / du (2^-8 relative each)
GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["linear", "fused_mlp_hidden", "flash_attention"])
def test_autograd_functions_match_the_plain_path(cuda, dtype, op):
    rng = np.random.default_rng(7)
    if op == "linear":
        ins = [_rand(rng, (3, 45, 136), dtype, cuda), _rand(rng, (136, 72), torch.float32, cuda)]
        kernel = lambda x, w: linear(x, w, impl="pallas")  # noqa: E731
        plain = lambda x, w: x @ w.to(x.dtype)  # noqa: E731
    elif op == "fused_mlp_hidden":
        ins = [_rand(rng, (70, 128), dtype, cuda), _rand(rng, (128, 200), dtype, cuda, 0.1),
               _rand(rng, (128, 200), dtype, cuda, 0.1)]
        kernel = fused_mlp_hidden
        plain = lambda x, wg, wu: fused_mlp_hidden_ref(x, wg, wu)  # noqa: E731
    else:
        ins = list(_flash_inputs(rng, dtype, cuda, 2, 100, 100, 4, 2, 64)[:3])
        kernel = flash_attention
        plain = lambda q, k, v: flash_attention_ref(q, k, v)[0]  # noqa: E731
    grads = []
    for fn in (kernel, plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        out = fn(*leaves)
        out.backward(torch.from_numpy(np.random.default_rng(8).standard_normal(
            tuple(out.shape)).astype(np.float32)).to(device=cuda, dtype=out.dtype))
        grads.append([t.grad for t in leaves])
    for gk, gp in zip(*grads):
        assert gk.dtype == gp.dtype and torch.isfinite(gk).all()
        assert _rel(gk, gp) <= GRAD_REL[dtype], (op, _rel(gk, gp))


def test_train_step_kernel_path_matches_plain_path(cuda):
    """internlm2-smoke in f32 on the card: the step-0 loss and gradients and
    a two-step trajectory of (fused, flash) against (jnp, naive) on the same
    params and batches (f32 sums in another order: ~1e-6 relative per GEMM,
    carried through 3 layers; AdamW bounds each update by lr)."""
    base = get_smoke_config("internlm2-1.8b")
    kern = dataclasses.replace(base, linear_impl="fused", attn_impl="flash")
    tc = TrainConfig(total_steps=2, warmup_steps=1, remat="none")
    shape = ShapeConfig("t", 72, 2, "train")
    runs = []
    for cfg in (kern, base):
        params = init_lm(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda,
                         dtype=torch.float32)
        batch = {k: torch.as_tensor(v, device=cuda)
                 for k, v in make_batch(cfg, shape, 0, 0).items()}
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = lm_loss(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        step = make_train_step(cfg, tc)
        opt = init_opt(params, tc)
        losses = []
        for s in range(2):
            b = {k: torch.as_tensor(v, device=cuda)
                 for k, v in make_batch(cfg, shape, s, 0).items()}
            params, opt, m = step(params, opt, b)
            losses.append(m["loss"].item())
        runs.append((loss.item(), grads, losses))
    (lk, gk, tk), (lp, gp, tp) = runs
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gk, gp):
        assert _rel(a, b) <= 1e-4
    np.testing.assert_allclose(tk, tp, rtol=1e-4)


# --- the int8-weight slice ------------------------------------------------------------

def _int8_operands(rng, m, k, n, device, gated=False):
    """Quantized operands as the wrappers make them: rows of x per row,
    weights per output channel, held K-major (`quantize_weight`)."""
    from repro_torch.quant import quantize_int8, quantize_weight
    x_q, x_s = quantize_int8(_rand(rng, (m, k), torch.float32, device))
    ws = [tuple(quantize_weight(_rand(rng, (k, n), torch.float32, device, k ** -0.5)))[:2]
          for _ in range(2 if gated else 1)]
    return x_q, x_s, ws


# The int8 tiles' edges (csrc/gemm_sm90_s8.cuh): rows on either side of the
# 64-row (one warpgroup, 64 x 128) and 128-row (two, 128 x 256) tiles and
# 4096; k off the 128-column step (70: one ragged step of rows that are not
# whole 16-byte chunks; 4100: split, the last split ragged), at one step
# (128) and deep (8192); n off the 32-, 128- and 256-column tiles up to the
# vocabulary.  (m, k, n, whether k is split.)
INT8_EDGE_CASES = [(m, k, n, k == 4100) for m in (1, 63, 64, 65, 127, 128, 129)
                   for k, n in ((70, 200), (4100, 45))]
INT8_EDGE_CASES += [(64, 2048, 1024, True), (64, 2048, 2048, True), (64, 8192, 2048, True),
                    (64, 2048, 92544, False), (129, 8192, 2048, True), (3, 100, 17, False),
                    (4096, 128, 200, False), (4096, 4100, 45, True),
                    (4096, 2048, 1024, False), (4096, 2048, 2048, False),
                    (130, 4100, 33000, False), (37, 128, 92544, False),
                    (37, 70, 45, False), (1, 512, 200, True), (130, 4096, 96, True),
                    (64, 64, 92544, False)]
# 16-byte copies with a ragged last k step (k % 16 == 0, k % 128 != 0: the
# chunks past k zero-filled), whole and split
INT8_EDGE_CASES += [(64, 1040, 200, True), (130, 1040, 96, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,split", INT8_EDGE_CASES)
def test_int8_matmul(cuda, dtype, m, k, n, split):
    """Bit-identical to the plain version (exact integer sums, the same f32
    de-scale) at misaligned shapes, with split-K (int32 partials) and
    without, with 16-byte copies and without (k 70, k 100), with 16-byte
    copies over a ragged k edge (k 64, 1040), no relayout of the K-major
    weight."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantized.ops import int8_matmul, int8_matmul_q, launch_shape
    from repro_torch.kernels.quantized.ref import int8_matmul_ref
    _, _, ks = launch_shape(m, n, k, _build.num_sms(cuda))
    assert (ks < k) == split
    rng = np.random.default_rng(m + k + n)
    a_q, a_s, [(b_q, b_s)] = _int8_operands(rng, m, k, n, cuda)
    before = (int8_matmul.launches, int8_matmul.relayouts)
    got = int8_matmul_q(a_q, a_s, b_q, b_s, dtype)
    torch.cuda.synchronize()
    assert (int8_matmul.launches, int8_matmul.relayouts) == (before[0] + 1, before[1])
    assert torch.equal(got, int8_matmul_ref(a_q, a_s, b_q, b_s, dtype))


@pytest.mark.parametrize("m,k,n", [(64, 2048, 1024), (130, 70, 45)])
def test_int8_matmul_relays_a_row_major_weight(cuda, m, k, n):
    """A (k, n) row-major payload (JAX's layout) is relaid K-major by the
    wrapper on the call, counted once, and the result is still exact; the
    fused MLP likewise, once per weight."""
    from repro_torch.kernels.quantized.ops import (int8_fused_mlp_hidden, int8_fused_mlp_q,
                                                   int8_matmul, int8_matmul_q)
    from repro_torch.kernels.quantized.ref import int8_fused_mlp_ref, int8_matmul_ref
    rng = np.random.default_rng(14)
    a_q, a_s, [(g_q, g_s), (u_q, u_s)] = _int8_operands(rng, m, k, n, cuda, gated=True)
    row_major = u_q.contiguous()
    assert not row_major.mT.is_contiguous() and torch.equal(row_major, u_q)
    before = (int8_matmul.launches, int8_matmul.relayouts)
    got = int8_matmul_q(a_q, a_s, row_major, u_s, torch.bfloat16)
    torch.cuda.synchronize()
    assert (int8_matmul.launches, int8_matmul.relayouts) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, int8_matmul_ref(a_q, a_s, u_q, u_s, torch.bfloat16))
    before = int8_fused_mlp_hidden.relayouts
    got = int8_fused_mlp_q(a_q, a_s, g_q.contiguous(), g_s, row_major, u_s)
    assert int8_fused_mlp_hidden.relayouts == before + 2
    want = int8_fused_mlp_ref(a_q, a_s, g_q, g_s, u_q, u_s)
    _close(got, want, tolerance.int8_fused_mlp_tol(a_q, a_s, g_q, g_s, u_q, u_s, "swiglu", want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("m,h,f", [(64, 2048, 512), (19, 72, 200), (130, 128, 96),
                                   (1, 70, 45), (65, 4100, 130), (129, 8192, 64)])
def test_int8_fused_mlp(cuda, dtype, mlp_type, m, h, f):
    from repro_torch.kernels.quantized.ops import int8_fused_mlp_hidden, int8_fused_mlp_q
    from repro_torch.kernels.quantized.ref import int8_fused_mlp_ref
    rng = np.random.default_rng(12)
    x_q, x_s, [(g_q, g_s), (u_q, u_s)] = _int8_operands(rng, m, h, f, cuda, gated=True)
    before = int8_fused_mlp_hidden.launches
    got = int8_fused_mlp_q(x_q, x_s, g_q, g_s, u_q, u_s, mlp_type=mlp_type, out_dtype=dtype)
    torch.cuda.synchronize()
    assert int8_fused_mlp_hidden.launches == before + 1
    want = int8_fused_mlp_ref(x_q, x_s, g_q, g_s, u_q, u_s, mlp_type=mlp_type, out_dtype=dtype)
    _close(got, want, tolerance.int8_fused_mlp_tol(x_q, x_s, g_q, g_s, u_q, u_s, mlp_type, want))


def test_int8_engine_on_the_card_matches_the_cpu(cuda):
    """The smoke model in f32 with prequantized weights through the slot
    engine on the card (int8 kernels, paged decode) and on the host (plain
    versions): the same greedy tokens, and the launch counts of the path:
    5L + 1 int8 GEMMs and L int8 fused MLPs per pass, no bf16-path GEMM."""
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden as fused
    from repro_torch.kernels.quantized.ops import int8_fused_mlp_hidden, int8_matmul
    from repro_torch.models.linear import quantize_linear_params
    from repro_torch.serving.engine import BucketPolicy, Engine, synthetic_requests
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype="float32",
                              linear_impl="quantized")
    params = quantize_linear_params(init_lm(torch.Generator().manual_seed(0), cfg, device="cpu"))
    reqs = synthetic_requests(8, pattern="burst", min_prompt=4, max_prompt=30, min_new=3,
                              max_new=8, vocab=cfg.vocab_size, seed=31)
    policy = BucketPolicy(num_slots=4, prompt_buckets=(16, 32), seq_max=64)
    runs = []
    for dev in ("cpu", cuda):
        eng = Engine(_to(params, dev), cfg, policy=policy, use_paged_kernel=True, device=dev)
        counts = (int8_matmul.launches, int8_fused_mlp_hidden.launches, matmul.launches,
                  fused.launches)
        done, stats = eng.run(reqs)
        counts = [now - then for now, then in zip(
            (int8_matmul.launches, int8_fused_mlp_hidden.launches, matmul.launches,
             fused.launches), counts)]
        runs.append(([c.tokens for c in done], counts, stats.prefills + stats.decode_steps))
    assert runs[0][0] == runs[1][0]
    L, passes = cfg.num_layers, runs[1][2]
    assert runs[0][1] == [0, 0, 0, 0]
    assert runs[1][1] == [passes * (5 * L + 1), passes * L, 0, 0]


def test_int8_straight_through_grads_on_the_card_match_the_cpu(cuda):
    """internlm2-smoke in f32 with linear_impl="quantized" and float weights
    (quantized per call): the step-0 loss and every gradient on the card
    (int8 kernels forward, tile GEMMs backward) against the host's plain
    versions on the same params and batch.  The int8 GEMMs are exact on both
    sides; the f32 ops around them sum in another order, which can move an
    activation across an int8 rounding step (1e-3 of a leaf's norm)."""
    from repro_torch.kernels.quantized.ops import int8_matmul
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), linear_impl="quantized")
    shape = ShapeConfig("t", 40, 2, "train")
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu", dtype=torch.float32)
    runs = []
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        leaves = list(tree_leaves(p))
        for t in leaves:
            t.requires_grad_(True)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(cfg, shape, 0, 0).items()}
        before = int8_matmul.launches
        loss, _ = lm_loss(p, batch, cfg)
        runs.append((loss.item(), [g.cpu() for g in torch.autograd.grad(loss, leaves)],
                     int8_matmul.launches - before))
    (lc, gc, nc), (lk, gk, nk) = runs
    assert nc == 0 and nk == 5 * cfg.num_layers + 1
    assert abs(lk - lc) <= 1e-4 * abs(lc)
    for a, b in zip(gk, gc):
        assert torch.isfinite(a).all() and _rel(a, b) <= 1e-3


def test_int8_wrappers_raise_on_bad_operands(cuda):
    from repro_torch.kernels.quantized.ops import int8_fused_mlp_q, int8_matmul_q
    rng = np.random.default_rng(13)
    a_q, a_s, [(b_q, b_s)] = _int8_operands(rng, 8, 64, 32, cuda)
    with pytest.raises(TypeError):   # a float payload
        int8_matmul_q(a_q.float(), a_s, b_q, b_s)
    with pytest.raises(TypeError):   # bf16 scales
        int8_matmul_q(a_q, a_s.bfloat16(), b_q, b_s)
    with pytest.raises(ValueError):  # per-tensor scales where per-channel are due
        int8_matmul_q(a_q, a_s, b_q, b_s[:, :1])
    with pytest.raises(ValueError):  # one scale per row of a, not per column
        int8_matmul_q(a_q, a_s.T.contiguous(), b_q, b_s)
    with pytest.raises(ValueError):  # a weight view neither K-major nor row-major
        int8_matmul_q(a_q, a_s, torch.cat([b_q, b_q], 1)[:, ::2], b_s)
    with pytest.raises(ValueError):  # operands on two devices
        int8_matmul_q(a_q, a_s, b_q.cpu(), b_s)
    with pytest.raises(TypeError):   # an output type the kernels do not write
        int8_matmul_q(a_q, a_s, b_q, b_s, torch.float16)
    with pytest.raises(ValueError):  # gate and up of different widths
        int8_fused_mlp_q(a_q, a_s, b_q[:, :16].contiguous(), b_s[:, :16].contiguous(), b_q, b_s)


# --- the SSM slice ------------------------------------------------------------------------

# seg's steps: [0, 1) as the JAX kernel's tests draw them (a key 65 steps
# back weighs at most e^-32), and [0, SLOW_DECAY) as a trained Mamba2's dt
# gives them (every key tile of a 256-step chunk counts, e^-5 at worst).
SLOW_DECAY = 0.02


def _ssd_operands(rng, lead, nc, Q, P, N, dtype, device, groups=1, step=1.0):
    """x_dt, B, C, seg as the model passes them: leading dims (b, groups,
    heads per group), x a permuted view of (b, nc, Q, heads, P), B and C
    expanded over the heads of a group; seg decreasing within each chunk
    by steps in [0, step)."""
    b, hg = lead[0], lead[-1]
    x = _rand(rng, (b, nc, Q, groups, hg, P), dtype, device, 0.5)
    B = _rand(rng, (b, nc, Q, groups, 1, N), dtype, device, 0.5)
    C = _rand(rng, (b, nc, Q, groups, 1, N), dtype, device, 0.5)
    steps = rng.uniform(0.0, step, size=(b, nc, Q, groups, hg))
    seg = torch.from_numpy(-np.cumsum(steps, axis=2).astype(np.float32)).to(device)
    heads = lambda t: t.permute(0, 3, 4, 1, 2, *range(5, t.dim()))  # noqa: E731
    expand = lambda t: heads(t.expand(b, nc, Q, groups, hg, N))  # noqa: E731
    return heads(x), expand(B), expand(C), heads(seg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,nc,Q,P,N", [
    ((2, 1, 3), 2, 40, 16, 16),      # the smoke-sized misaligned chunk
    ((2, 1, 4), 1, 100, 24, 40),     # a ragged chunk, N and P off the 16 grid
    ((1, 1, 6), 3, 77, 20, 130),     # unaligned rows (no 16-byte loads), N past 128
    ((1, 2, 3), 2, 256, 64, 128),    # two groups, mamba2's chunk
    ((3, 1, 2), 2, 1, 8, 8),         # one-step chunks
    ((1, 1, 48), 2, 256, 64, 128),   # mamba2-780m: one group of 48 heads
    ((1, 1, 80), 1, 256, 64, 64),    # zamba2-2.7b: 80 heads, N 64
    ((2, 1, 13), 1, 256, 64, 128),   # 13 heads: no slab size divides them
])
def test_ssd_chunk(cuda, dtype, lead, nc, Q, P, N):
    for step in (1.0, SLOW_DECAY):
        x, B, C, seg = _ssd_operands(np.random.default_rng(Q), lead, nc, Q, P, N, dtype, cuda,
                                     groups=lead[1], step=step)
        before = ssd_chunk.launches
        got = ssd_chunk(x, B, C, seg)
        torch.cuda.synchronize()
        assert ssd_chunk.launches == before + 1
        want = ssd_chunk_ref(x, B, C, seg)
        for g, w, tol in zip(got, want, tolerance.ssd_chunk_tol(x, B, C, seg, want)):
            assert g.shape == w.shape and g.dtype == dtype
            _close(g, w, tol)
        # the (bh, nc, Q, .) layout with the repeat materialised: the same numbers
        flat = [t.reshape(-1, *t.shape[3:]) for t in (x, B, C, seg)]
        y4, s4 = ssd_chunk(*flat)
        torch.testing.assert_close(y4.reshape(got[0].shape), got[0], atol=0, rtol=0)
        torch.testing.assert_close(s4.reshape(got[1].shape), got[1], atol=0, rtol=0)


def test_ssd_chunk_under_autograd_and_on_bad_operands(cuda):
    """Under autograd `ssd_chunk` takes `_SSDChunk`: one forward and one
    backward launch; bad operands raise."""
    from repro_torch.kernels.ssd.ops import ssd_chunk_bwd
    x, B, C, seg = _ssd_operands(np.random.default_rng(0), (1, 1, 2), 1, 16, 8, 8,
                                 torch.float32, cuda)
    f0, b0 = ssd_chunk.launches, ssd_chunk_bwd.launches
    xg = x.detach().requires_grad_()
    y, s = ssd_chunk(xg, B, C, seg)
    (y.sum() + s.sum()).backward()
    torch.cuda.synchronize()
    assert (ssd_chunk.launches - f0, ssd_chunk_bwd.launches - b0) == (1, 1)
    assert xg.grad.shape == x.shape and torch.isfinite(xg.grad).all()
    with pytest.raises(TypeError):
        ssd_chunk(x, B, C, seg.double())
    with pytest.raises(ValueError, match="N <= 256"):
        ssd_chunk(x, *(torch.zeros(*B.shape[:-1], 300, device=cuda) for _ in range(2)), seg)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk(x.transpose(-1, -2).contiguous().transpose(-1, -2), B, C, seg)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_chunk_bwd(*(torch.zeros(1, 1, 64, 128, device=cuda) for _ in range(3)),
                      torch.zeros(1, 1, 64, device=cuda), torch.zeros(1, 1, 64, 128, device=cuda),
                      torch.zeros(1, 1, 128, 128, device=cuda))


# positions past a row's range (rows past Q, columns past N and P, in the
# padding of every operand) hold POISON: a read past the mask shows
POISON = 1e4


def _poisoned(t, dims=2, pad=8):
    """A view of t's values inside a larger buffer, its last `dims` dims
    (rows and columns of a matrix, the steps of seg) padded by `pad`, whose
    other elements hold POISON."""
    k = t.dim() - dims
    buf = torch.full((*t.shape[:k], *(n + pad for n in t.shape[k:])), POISON, dtype=t.dtype,
                     device=t.device)
    view = buf[(...,) + tuple(slice(0, n) for n in t.shape[k:])]
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,nc,Q,P,N", [
    ((2, 1, 3), 2, 40, 16, 16),      # the misaligned chunk
    ((2, 1, 4), 1, 100, 64, 128),    # a ragged chunk at mamba2's widths
    ((1, 2, 3), 2, 256, 64, 128),    # two groups, mamba2's chunk
    ((2, 1, 48), 2, 256, 64, 128),   # mamba2-780m: one group of 48 heads
    ((1, 1, 80), 2, 256, 64, 64),    # zamba2-2.7b: 80 heads, N 64
    ((1, 1, 6), 3, 77, 20, 40),      # Q, P and N off every grid
    ((1, 1, 13), 1, 256, 64, 128),   # 13 heads: the slab does not divide them
    ((1, 1, 50), 1, 256, 64, 128),   # 50 heads: four slabs, the last of two
    ((1, 2, 13), 1, 256, 64, 128),   # two groups, slabs that share no scores
    ((1, 1, 5), 2, 192, 64, 128),    # three tiles a chunk
    ((2, 1, 3), 1, 65, 64, 64),      # one row past a tile
])
def test_ssd_chunk_bwd(cuda, dtype, lead, nc, Q, P, N):
    """The backward kernel against its plain version on the same operands,
    every element within `ssd_chunk_bwd_tol`, at the JAX tests' decay and a
    trained model's; every operand a strided view whose padding holds
    POISON; a second call on the same operands gives the same bits, and so
    does the flat layout."""
    from repro_torch.kernels.ssd.ops import ssd_chunk_bwd
    from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref
    for step in (1.0, SLOW_DECAY):
        rng = np.random.default_rng(Q + P)
        x, B, C, seg = _ssd_operands(rng, lead, nc, Q, P, N, dtype, cuda, groups=lead[1],
                                     step=step)
        dY = _rand(rng, x.shape, dtype, cuda)
        dS = _rand(rng, (*x.shape[:-2], N, P), dtype, cuda)
        ops = [_poisoned(t.contiguous()) for t in (x, dY, dS)]
        B, C = (_poisoned(t[:, :, :1].contiguous()).expand(t.shape) for t in (B, C))
        ops = [ops[0], B, C, _poisoned(seg.contiguous(), dims=1), ops[1], ops[2]]
        before = ssd_chunk_bwd.launches
        got = ssd_chunk_bwd(*ops)
        torch.cuda.synchronize()
        assert ssd_chunk_bwd.launches == before + 1
        want = ssd_chunk_bwd_ref(*ops)
        for g, w, tol in zip(got, want, tolerance.ssd_chunk_bwd_tol(*ops, want)):
            assert g.shape == w.shape and g.dtype == w.dtype
            _close(g, w, tol)
        # no sum crosses blocks in an unfixed order: the same bits again
        for g, again in zip(got, ssd_chunk_bwd(*ops)):
            torch.testing.assert_close(again, g, atol=0, rtol=0)
        # the (bh, nc, Q, .) layout with the repeat materialised: the same numbers
        flat = [t.reshape(-1, *t.shape[3:]) for t in ops]
        for g, f in zip(got, ssd_chunk_bwd(*flat)):
            torch.testing.assert_close(f.reshape(g.shape), g, atol=0, rtol=0)


@pytest.mark.parametrize("lead,nc,Q,P,N", [
    ((1, 1, 3), 1, 256, 128, 256),   # the widest shape: dX and dB / dC in two slices each
    ((1, 1, 4), 2, 130, 96, 160),    # P and N past one slice, off the grid
    ((2, 1, 2), 1, 100, 80, 64),     # two dX slices, one dB / dC slice
])
def test_ssd_chunk_bwd_wide(cuda, lead, nc, Q, P, N):
    """bf16 shapes past one column slice (P > 64, N > 128): more blocks,
    each forming the scores and dP over all of N and P; the plain version's
    bound, and the flat layout's bits."""
    from repro_torch.kernels.ssd.ops import ssd_chunk_bwd
    from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref
    rng = np.random.default_rng(Q + N)
    x, B, C, seg = _ssd_operands(rng, lead, nc, Q, P, N, torch.bfloat16, cuda, step=0.05)
    dY = _rand(rng, x.shape, torch.bfloat16, cuda)
    dS = _rand(rng, (*x.shape[:-2], N, P), torch.bfloat16, cuda)
    ops = (x, B, C, seg, dY, dS)
    got = ssd_chunk_bwd(*ops)
    want = ssd_chunk_bwd_ref(*ops)
    for g, w, tol in zip(got, want, tolerance.ssd_chunk_bwd_tol(*ops, want)):
        _close(g, w, tol)
    flat = [t.reshape(-1, *t.shape[3:]) for t in ops]
    for g, f in zip(got, ssd_chunk_bwd(*flat)):
        torch.testing.assert_close(f.reshape(g.shape), g, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_bwd_takes_expanded_cotangents(cuda, dtype):
    """The gradient of y.sum() + s.sum() arrives as cotangents expanded
    with stride 0 in every dim: the same result as their contiguous copies,
    within the plain version's bound."""
    from repro_torch.kernels.ssd.ops import ssd_chunk_bwd
    from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref
    x, B, C, seg = _ssd_operands(np.random.default_rng(5), (2, 1, 4), 2, 100, 64, 128, dtype,
                                 cuda)
    one = torch.ones((), dtype=dtype, device=cuda)
    dY, dS = one.expand(x.shape), one.expand((*x.shape[:-2], 128, 64))
    got = ssd_chunk_bwd(x, B, C, seg, dY, dS)
    dense = ssd_chunk_bwd(x, B, C, seg, dY.contiguous(), dS.contiguous())
    want = ssd_chunk_bwd_ref(x, B, C, seg, dY, dS)
    for g, d, w, tol in zip(got, dense, want,
                            tolerance.ssd_chunk_bwd_tol(x, B, C, seg, dY, dS, want)):
        torch.testing.assert_close(g, d, atol=0, rtol=0)
        _close(g, w, tol)


def _ssm_grads(params, batch, cfg, remat="none"):
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = lm_loss(params, batch, cfg, remat=remat)
    return loss.item(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_lm_loss_grads_on_the_card_match_the_cpu(cuda, arch):
    """The smoke model in f32 at a sequence that pads its last chunk: loss
    and every gradient leaf with `_SSDChunk` (the SSD kernel and its
    backward kernel), the tile GEMM, the fused MLP and flash on the card,
    against the plain path (jnp, naive, autograd through the SSD oracle) on
    the host: f32 sums in another order (~1e-6 relative per sum), carried
    through a few layers."""
    from repro_torch.kernels.ssd.ops import ssd_chunk_bwd
    from repro_torch.models import ssm as ssm_mod
    base = get_smoke_config(arch)
    kern = dataclasses.replace(base, linear_impl="fused", attn_impl="flash")
    params = init_lm(torch.Generator().manual_seed(0), base, device="cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(base, ShapeConfig("t", 40, 2, "train"), 0, 0).items()}
    f0, b0 = ssd_chunk.launches, ssd_chunk_bwd.launches
    lk, gk = _ssm_grads(_to(params, cuda), _to(batch, cuda), kern)
    torch.cuda.synchronize()
    assert (ssd_chunk.launches - f0, ssd_chunk_bwd.launches - b0) == (base.num_layers,) * 2
    real = ssm_mod.ssd_chunk
    ssm_mod.ssd_chunk = ssd_chunk_ref
    try:
        lp, gp = _ssm_grads(params, batch, base)
    finally:
        ssm_mod.ssd_chunk = real
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all() and _rel(a.cpu(), b) <= 1e-4


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_remat_full_equals_none_on_the_card(cuda, arch):
    """remat="full" over `ssm` and `hybrid_super` segments on the card: the
    recomputed layers launch the same deterministic kernels, so the loss
    and every gradient are bit-identical to remat="none"."""
    cfg = dataclasses.replace(get_smoke_config(arch), linear_impl="fused", attn_impl="flash")
    params = init_lm(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda,
                     dtype=torch.float32)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in
             make_batch(cfg, ShapeConfig("t", 72, 2, "train"), 0, 0).items()}
    l0, g0 = _ssm_grads(params, batch, cfg)
    l1, g1 = _ssm_grads(params, batch, cfg, remat="full")
    assert l0 == l1
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_serving_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke model in f32 (fused linear: the tile GEMM, and for zamba2
    the fused MLP; the SSD kernel per SSM layer per prefill, none per
    decode step) on the card and its plain versions on the host: prefill
    logits within 5e-5 (f32 sums in another order, as the CPU parity tests
    allow) and the same greedy tokens."""
    from repro_torch.serving.serve_step import greedy_generate, make_prefill_step
    cfg = dataclasses.replace(get_smoke_config(arch), linear_impl="fused")
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 70))
                              .astype(np.int32))
    want, _ = make_prefill_step(cfg, 70)(params, {"tokens": prompt})
    before = ssd_chunk.launches
    with torch.no_grad():
        got, _ = make_prefill_step(cfg, 70)(_to(params, cuda), {"tokens": prompt.to(cuda)})
    assert ssd_chunk.launches - before == cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=5e-5, rtol=5e-5)
    toks = greedy_generate(params, cfg, prompt, 8)
    before = ssd_chunk.launches
    toks_card = greedy_generate(_to(params, cuda), cfg, prompt.to(cuda), 8)
    assert ssd_chunk.launches - before == cfg.num_layers     # the prefill only
    assert torch.equal(toks_card.cpu(), toks)


# --- the tuning cache on the card -----------------------------------------------------

@pytest.fixture
def tuned_cache(cuda):
    """An empty default tuning cache for the test; none installed after."""
    from repro_torch.tuning.cache import TuningCache, set_default_cache
    cache = TuningCache()
    set_default_cache(cache)
    yield cache
    set_default_cache(None)


def _install(cache, op, shape, dtype, blocks):
    from repro_torch.tuning.cache import TunedConfig
    cache.entries.clear()
    cache.put(TunedConfig(op=op, shape=tuple(shape), dtype=dtype, hw_name="h100",
                          blocks=dict(blocks), time_us=1.0))


def _hit(fn, call):
    """call(), asserting it made exactly one tuned lookup, a hit."""
    before = (fn.tuned_hits, fn.tuned_misses)
    out = call()
    torch.cuda.synchronize()
    assert (fn.tuned_hits, fn.tuned_misses) == (before[0] + 1, before[1])
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(37, 1040, 200), (64, 2048, 2048)])
def test_tuned_matmul_at_every_lattice_geometry(tuned_cache, dtype, m, k, n):
    """An entry for each geometry the lattice offers: the tuned call is
    bit-identical to a forced launch of that geometry and within the bound
    of the plain version; a miss launches the rule's geometry."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul import ops
    from repro_torch.tuning.cache import dtype_name
    from repro_torch.tuning.candidates import matmul_candidates, split_depth
    rng = np.random.default_rng(m + k)
    a, b = _rand(rng, (m, k), dtype, "cuda"), _rand(rng, (k, n), dtype, "cuda", k ** -0.5)
    want = matmul_ref(a, b)
    sms = _build.num_sms(a.device)
    bk = ops.F32_BLOCK_K if dtype == torch.float32 else ops.BLOCK_K
    before = matmul.tuned_misses
    assert torch.equal(matmul(a, b, tuned=True),
                       ops._matmul_cuda(a, b, None, None, forced=ops.launch_shape(m, n, k, dtype,
                                                                                  sms)))
    assert matmul.tuned_misses == before + 1
    lattice = matmul_candidates(m, k, n, a.element_size(), sms)
    assert len(lattice) >= 2
    for bm, bn, s in lattice:
        _install(tuned_cache, "matmul", (m, k, n), dtype_name(dtype),
                 dict(block_m=bm, block_n=bn, split_k=s))
        got = _hit(matmul, lambda: matmul(a, b, tuned=True))
        forced = ops._matmul_cuda(a, b, None, None, forced=(bm, bn, split_depth(k, s, bk)))
        assert torch.equal(got, forced), (bm, bn, s)
        _close(got, want, tolerance.matmul_tol(a, b, want))


@pytest.mark.parametrize("fp8_dtype", ["float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("m,k,n", [(37, 1040, 200), (64, 2048, 2048)])
def test_tuned_fp8_matmul_at_every_lattice_geometry(tuned_cache, fp8_dtype, m, k, n):
    """The emulated fp8 GEMM's own entries (op "fp8_matmul", the mixed dtype
    key): each lattice geometry bit-identical to a forced launch on the
    rounded operands and within the bound of the plain version; the tile
    GEMM's counters count the lookups."""
    from repro_torch.kernels.matmul import ops
    from repro_torch.kernels.quantized.ops import fp8_matmul
    from repro_torch.quant import fp8_round_trip
    from repro_torch.tuning.candidates import fp8_matmul_candidates, split_depth
    rng = np.random.default_rng(m + n)
    a, b = _rand(rng, (m, k), torch.bfloat16, "cuda"), _rand(rng, (k, n), torch.bfloat16, "cuda",
                                                            k ** -0.5)
    a8, b8 = fp8_round_trip(a, fp8_dtype), fp8_round_trip(b, fp8_dtype)
    want = matmul_ref(a8, b8)
    for bm, bn, s in fp8_matmul_candidates(m, k, n):
        _install(tuned_cache, "fp8_matmul", (m, k, n), f"bfloat16x{fp8_dtype}",
                 dict(block_m=bm, block_n=bn, split_k=s))
        got = _hit(matmul, lambda: fp8_matmul(a, b, fp8_dtype=fp8_dtype, tuned=True))
        forced = ops._matmul_cuda(a8, b8, None, None, forced=(bm, bn, split_depth(k, s, 64)))
        assert torch.equal(got, forced), (bm, bn, s)
        _close(got, want, tolerance.matmul_tol(a8, b8, want))
    _install(tuned_cache, "fp8_matmul", (m, k, n), f"bfloat16x{fp8_dtype}",
             dict(block_m=256, block_n=128, split_k=1))
    with pytest.raises(RuntimeError):
        fp8_matmul(a, b, fp8_dtype=fp8_dtype, tuned=True)
        torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,h,f", [(19, 72, 200), (64, 2048, 8192)])
def test_tuned_fused_mlp_at_every_lattice_geometry(tuned_cache, dtype, m, h, f):
    from repro_torch.kernels.fused_mlp import ops
    from repro_torch.tuning.cache import dtype_name
    from repro_torch.tuning.candidates import fused_mlp_candidates
    rng = np.random.default_rng(m + h)
    x = _rand(rng, (m, h), dtype, "cuda")
    wg, wu = (_rand(rng, (h, f), dtype, "cuda", h ** -0.5) for _ in range(2))
    want = fused_mlp_hidden_ref(x, wg, wu, "swiglu")
    for bm, bf in fused_mlp_candidates(m, h, f, x.element_size()):
        _install(tuned_cache, "fused_mlp_swiglu", (m, h, f), dtype_name(dtype),
                 dict(block_m=bm, block_f=bf))
        got = _hit(fused_mlp_hidden, lambda: fused_mlp_hidden(x, wg, wu, tuned=True))
        assert torch.equal(got, ops._fused_cuda(x, wg, wu, "swiglu", forced=(bm, bf)))
        _close(got, want, tolerance.fused_mlp_hidden_tol(x, wg, wu, "swiglu", want))


@pytest.mark.parametrize("m,k,n", [(37, 1040, 200), (128, 2048, 2048), (256, 8192, 2048)])
def test_tuned_int8_matmul_at_every_lattice_geometry(tuned_cache, m, k, n):
    """Every geometry bit-identical to the forced launch and to the plain
    version (exact integer sums), bf16 activations' key."""
    from repro_torch.kernels.quantized import ops
    from repro_torch.kernels.quantized.ref import int8_matmul_ref
    from repro_torch.tuning.candidates import int8_matmul_candidates, split_depth
    rng = np.random.default_rng(m + n)
    a_q, a_s, [(b_q, b_s)] = _int8_operands(rng, m, k, n, "cuda")
    want = int8_matmul_ref(a_q, a_s, b_q, b_s, torch.bfloat16)
    for bm, bn, s in int8_matmul_candidates(m, k, n):
        _install(tuned_cache, "int8_matmul", (m, k, n), "bfloat16xint8",
                 dict(block_m=bm, block_n=bn, split_k=s))
        got = _hit(ops.int8_matmul, lambda: ops.int8_matmul_q(
            a_q, a_s, b_q, b_s, torch.bfloat16, tuned=True, act_dtype=torch.bfloat16))
        forced = ops._int8_matmul_cuda(a_q, a_s, b_q, b_s, torch.bfloat16,
                                       forced=(bm, bn, split_depth(k, s, ops.BLOCK_K)))
        assert torch.equal(got, forced) and torch.equal(got, want), (bm, bn, s)


@pytest.mark.parametrize("m,h,f", [(19, 72, 200), (64, 2048, 8192), (256, 2048, 8192)])
def test_tuned_int8_fused_mlp_at_every_lattice_geometry(tuned_cache, m, h, f):
    from repro_torch.kernels.quantized import ops
    from repro_torch.kernels.quantized.ref import int8_fused_mlp_ref
    from repro_torch.tuning.candidates import int8_fused_mlp_candidates
    rng = np.random.default_rng(m + f)
    x_q, x_s, [(g_q, g_s), (u_q, u_s)] = _int8_operands(rng, m, h, f, "cuda", gated=True)
    want = int8_fused_mlp_ref(x_q, x_s, g_q, g_s, u_q, u_s, out_dtype=torch.bfloat16)
    for bm, bf in int8_fused_mlp_candidates(m, h, f):
        _install(tuned_cache, "int8_fused_mlp_swiglu", (m, h, f), "bfloat16xint8",
                 dict(block_m=bm, block_f=bf))
        got = _hit(ops.int8_fused_mlp_hidden, lambda: ops.int8_fused_mlp_q(
            x_q, x_s, g_q, g_s, u_q, u_s, out_dtype=torch.bfloat16, tuned=True,
            act_dtype=torch.bfloat16))
        forced = ops._int8_fused_cuda(x_q, x_s, g_q, g_s, u_q, u_s, "swiglu", torch.bfloat16,
                                      forced=(bm, bf))
        assert torch.equal(got, forced)
        _close(got, want, tolerance.int8_fused_mlp_tol(x_q, x_s, g_q, g_s, u_q, u_s, "swiglu",
                                                       want))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("s_max,g,lengths", [(200, 12, [200, 64, 65, 0, 1, 127]),
                                             (128, 2, [128, 100, 7, 0, 64, 33, 90, 1])])
def test_tuned_paged_decode_at_every_lattice_geometry(tuned_cache, quant, s_max, g, lengths):
    from repro_torch.kernels.flash_attention.ops import _paged_cuda
    from repro_torch.tuning.candidates import paged_decode_candidates
    q, kp, vp, slot_idx, lengths, sc = _slot_case(
        np.random.default_rng(s_max + g), s_max, g, 128, torch.bfloat16, "cuda", quant, lengths)
    want = paged_decode_ref(q, kp, vp, slot_idx, lengths, **sc)
    key = (q.shape[0], kp.shape[0], s_max, 2, q.shape[1], 128)
    for tile, s in paged_decode_candidates(q.shape[0], 2, g, 128, s_max, kp.element_size()):
        _install(tuned_cache, "paged_decode", key, "bfloat16xint8" if quant else "bfloat16",
                 dict(tile=tile, splits=s))
        got = _hit(paged_decode, lambda: paged_decode(q, kp, vp, slot_idx, lengths, tuned=True,
                                                      **sc))
        forced = _paged_cuda(paged_decode, q, kp, vp, sc.get("k_scale"), sc.get("v_scale"),
                             slot_idx, lengths, 0, None, (tile, s))
        assert torch.equal(got, forced), (tile, s)
        assert torch.all(got[lengths == 0] == 0)
        _close(got, want, tolerance.paged_decode_tol(q, kp, vp, slot_idx, lengths, want, **sc))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("bs,g", [(16, 2), (64, 12)])
def test_tuned_paged_decode_blocktable_at_every_lattice_geometry(tuned_cache, quant, bs, g):
    from repro_torch.kernels.flash_attention.ops import _paged_cuda, paged_decode_blocktable
    from repro_torch.kernels.flash_attention.ref import paged_decode_blocktable_ref
    from repro_torch.tuning.candidates import paged_decode_candidates
    q, kb, vb, tables, lengths, sc = _blocktable_case(np.random.default_rng(bs + g), bs, g, 128,
                                                      torch.bfloat16, "cuda", quant)
    want = paged_decode_blocktable_ref(q, kb, vb, tables, lengths, **sc)
    key = (q.shape[0], kb.shape[0], bs, 2, q.shape[1], 128)
    capacity = tables.shape[1] * bs
    for tile, s in paged_decode_candidates(q.shape[0], 2, g, 128, capacity, kb.element_size()):
        _install(tuned_cache, "paged_decode_blocktable", key,
                 "bfloat16xint8" if quant else "bfloat16", dict(tile=tile, splits=s))
        got = _hit(paged_decode_blocktable, lambda: paged_decode_blocktable(
            q, kb, vb, tables, lengths, tuned=True, **sc))
        forced = _paged_cuda(paged_decode_blocktable, q, kb, vb, sc.get("k_scale"),
                             sc.get("v_scale"), tables, lengths, tables.shape[1], None, (tile, s))
        assert torch.equal(got, forced), (tile, s)
        _close(got, want, tolerance.paged_decode_blocktable_tol(q, kb, vb, tables, lengths,
                                                                want, **sc))


def test_tuned_entries_the_library_refuses_raise(tuned_cache):
    """A cache entry whose geometry no kernel instantiates raises at the
    launch; it never falls back to the rule."""
    from repro_torch.kernels.quantized import ops as qops
    rng = np.random.default_rng(3)
    a, b = (_rand(rng, s, torch.bfloat16, "cuda") for s in ((64, 256), (256, 128)))
    cases = [("matmul", (64, 256, 128), "bfloat16", dict(block_m=96, block_n=128, split_k=1),
              lambda: matmul(a, b, tuned=True)),
             ("matmul", (64, 256, 128), "bfloat16", dict(block_m=128, block_n=256, split_k=1),
              lambda: matmul(a, b, tuned=True)),
             ("fused_mlp_swiglu", (64, 256, 128), "bfloat16", dict(block_m=64, block_f=128),
              lambda: fused_mlp_hidden(a, b, b, tuned=True))]
    a_q, a_s, [(b_q, b_s), (u_q, u_s)] = _int8_operands(rng, 64, 256, 128, "cuda", gated=True)
    cases += [("int8_matmul", (64, 256, 128), "bfloat16xint8",
               dict(block_m=128, block_n=128, split_k=1),
               lambda: qops.int8_matmul_q(a_q, a_s, b_q, b_s, torch.bfloat16, tuned=True)),
              ("int8_fused_mlp_swiglu", (64, 256, 128), "bfloat16xint8",
               dict(block_m=64, block_f=64),
               lambda: qops.int8_fused_mlp_q(a_q, a_s, b_q, b_s, u_q, u_s,
                                             out_dtype=torch.bfloat16, tuned=True))]
    q, kp, vp, slot_idx, lengths, _ = _slot_case(rng, 64, 2, 128, torch.bfloat16, "cuda", False,
                                                 [64, 3])
    cases += [("paged_decode", (2, 4, 64, 2, 4, 128), "bfloat16", dict(tile=48, splits=1),
               lambda: paged_decode(q, kp, vp, slot_idx, lengths, tuned=True))]
    for op, shape, dtype, blocks, call in cases:
        _install(tuned_cache, op, shape, dtype, blocks)
        with pytest.raises((RuntimeError, ValueError)):
            call()
            torch.cuda.synchronize()


def test_a_tiny_autotune_writes_an_entry_the_next_call_hits(tuned_cache):
    """autotune_matmul and autotune_paged_decode into the default cache: the
    next tuned call hits the entry and launches its geometry."""
    from repro_torch.kernels.matmul import ops
    from repro_torch.tuning.candidates import split_depth
    from repro_torch.tuning.search import autotune_matmul, autotune_paged_decode
    cfg = autotune_matmul(64, 1024, 512, iters=3, warmup=1)
    assert cfg.candidates_tried >= 2 and cfg.time_us > 0 and cfg.baseline_us > 0
    rng = np.random.default_rng(5)
    a, b = (_rand(rng, s, torch.bfloat16, "cuda") for s in ((64, 1024), (1024, 512)))
    got = _hit(matmul, lambda: matmul(a, b, tuned=True))
    bl = cfg.blocks
    assert torch.equal(got, ops._matmul_cuda(a, b, None, None, forced=(
        bl["block_m"], bl["block_n"], split_depth(1024, bl["split_k"], ops.BLOCK_K))))
    cfg = autotune_paged_decode(8, 8, 128, 2, 8, 128, iters=3, warmup=1)
    assert cfg.op == "paged_decode" and set(cfg.blocks) == {"tile", "splits"}
    q = _rand(rng, (8, 8, 128), torch.bfloat16, "cuda")
    kp, vp = (_rand(rng, (8, 128, 2, 128), torch.bfloat16, "cuda") for _ in range(2))
    idx = torch.arange(8, dtype=torch.int32, device="cuda")
    lengths = torch.full((8,), 100, dtype=torch.int32, device="cuda")
    got = _hit(paged_decode, lambda: paged_decode(q, kp, vp, idx, lengths, tuned=True))
    want = paged_decode_ref(q, kp, vp, idx, lengths)
    _close(got, want, tolerance.paged_decode_tol(q, kp, vp, idx, lengths, want))


# --- the MoE slice: the expert-batched launches -----------------------------------------

# (experts, capacity rows, k, n): deepseek-v3's gate/up and w_down at its
# decode (8 rows) and prefill (160 rows) capacities, llama4-maverick's at 8
# rows (its experts cut to 3 for time: the per-expert shape is the path's),
# and ragged ones (rows and widths off the tiles, one expert)
EXPERT_CASES = [(3, 8, 7168, 2048), (3, 8, 2048, 7168), (2, 160, 7168, 2048),
                (2, 160, 2048, 7168), (3, 8, 5120, 8192), (3, 8, 8192, 5120),
                (5, 13, 72, 200), (1, 130, 96, 40), (4, 64, 70, 45)]


def _expert_operands(cuda, dtype, e, m, k, n, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((e, m, k), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((e, k, n), generator=gen, device=cuda) * k ** -0.5).to(dtype)
    return x, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,m,k,n", EXPERT_CASES)
def test_matmul_expert(cuda, dtype, e, m, k, n):
    """One launch for all experts, each expert within its bound of the plain
    version, and bit-identical to the 2-D kernel launched per expert at the
    same tile, unsplit (the batched launch is that kernel per expert)."""
    from repro_torch.kernels.matmul import ops
    from repro_torch.kernels.matmul.ref import matmul_expert_ref
    x, w = _expert_operands(cuda, dtype, e, m, k, n, 0)
    before = ops.matmul_expert.launches
    got = ops.matmul_expert(x, w)
    torch.cuda.synchronize()
    assert ops.matmul_expert.launches == before + 1
    want = matmul_expert_ref(x, w)
    _close(got, want, tolerance.matmul_tol(x, w, want))
    (tm, tn, _), _ = ops.geometry(m, k, n, dtype)
    step = ops.F32_BLOCK_K if dtype == torch.float32 else ops.BLOCK_K
    unsplit = -(-k // step) * step
    for z in range(e):
        one = ops._matmul_cuda(x[z], w[z], None, None, forced=(tm, tn, unsplit))
        assert torch.equal(got[z], one), z


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
@pytest.mark.parametrize("e,m,h,f", [(3, 8, 7168, 2048), (2, 160, 7168, 2048),
                                     (3, 8, 5120, 8192), (5, 13, 72, 200), (1, 130, 96, 40)])
def test_fused_mlp_hidden_expert(cuda, dtype, mlp_type, e, m, h, f):
    from repro_torch.kernels.fused_mlp import ops
    x, wg = _expert_operands(cuda, dtype, e, m, h, f, 1)
    _, wu = _expert_operands(cuda, dtype, e, m, h, f, 2)
    before = ops.fused_mlp_hidden_expert.launches
    got = ops.fused_mlp_hidden_expert(x, wg, wu, mlp_type=mlp_type)
    torch.cuda.synchronize()
    assert ops.fused_mlp_hidden_expert.launches == before + 1
    want = fused_mlp_hidden_ref(x, wg if mlp_type == "swiglu" else None, wu, mlp_type)
    _close(got, want, tolerance.fused_mlp_hidden_tol(x, wg, wu, mlp_type, want))
    tile, _ = ops.geometry(m, h, f, dtype, mlp_type)
    for z in range(e):
        one = ops._fused_cuda(x[z], wg[z] if mlp_type == "swiglu" else None, wu[z], mlp_type,
                              forced=tile)
        assert torch.equal(got[z], one), z


def test_expert_launch_is_forward_only_on_the_card(cuda):
    """Under autograd the batched launches raise, naming the MoE-training
    slice; the 2-D launches are unchanged (their own tests above)."""
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden_expert
    from repro_torch.kernels.matmul.ops import matmul_expert
    from repro_torch.models.linear import expert_fused_hidden, expert_linear
    x, w = _expert_operands(cuda, torch.bfloat16, 2, 8, 64, 32, 3)
    w.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="MoE-training slice"):
        matmul_expert(x, w)
    with pytest.raises(NotImplementedError, match="MoE-training slice"):
        expert_linear(x, w, impl="fused")
    with pytest.raises(NotImplementedError, match="MoE-training slice"):
        fused_mlp_hidden_expert(x, w, w, mlp_type="swiglu")
    with pytest.raises(NotImplementedError, match="MoE-training slice"):
        expert_fused_hidden(x, w, w, mlp_type="swiglu")
    with torch.no_grad():
        assert matmul_expert(x, w).shape == (2, 8, 32)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "deepseek-v3-671b"])
def test_moe_smoke_model_on_the_card_matches_the_cpu(cuda, arch):
    """The whole MoE smoke model (f32) on the card through the batched
    launches against the same params on the host (the plain versions):
    prefill logits and greedy tokens."""
    from repro_torch.serving.serve_step import greedy_generate
    cfg = dataclasses.replace(get_smoke_config(arch), linear_impl="fused")
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        want = apply_lm(params, toks, cfg)[0]
        got = apply_lm(on_card, toks.to(cuda), cfg)[0].cpu()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        assert torch.equal(greedy_generate(on_card, cfg, toks.to(cuda), 5).cpu(),
                           greedy_generate(params, cfg, toks, 5))
