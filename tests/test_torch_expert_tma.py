"""The expert-batched GEMM's TMA route, on the host: the operand
descriptions the wrappers hand csrc/gemm_sm90_tma.cuh's tensor maps, the
route by shape, and the op counter's charges for the batched launches.

A description (`kernels/matmul/ops.py` `tma_operand`) gives each operand's
stored layout (dims innermost first, byte strides of dims 1 and 2), the box
and whether the stored row is the contraction axis.  Rebuilt on the
tensor's own storage with `torch.as_strided`, it must be the tensor: the
GEMM's operand where the stored row runs along its last axis, its `.mT`
otherwise.  Stacks whose base or stored row is not a whole 16 bytes, and
f32, take the grid-z route (no description).  The kernels themselves run
only on the card (tests/test_torch_cuda.py).
"""
import pytest
import torch

from repro_torch.core import op_analysis
from repro_torch.kernels.fused_mlp import ops as fused_ops
from repro_torch.kernels.matmul import ops as mm_ops

BF = torch.bfloat16
FIELDS = 8
# capacities 1, 8, 160, 320 rows an expert; contractions of 8 (one box,
# zero-filled to the 64-column step) and 200 (a ragged last step)
CAPACITIES = (1, 8, 160, 320)
KS = (8, 200)


def _slots(desc):
    """{slot: (dims, strides, box, k_major)} of a description array."""
    flat = desc.tolist()
    out = {}
    for i, name in enumerate(mm_ops.TMA_SLOTS):
        f = flat[i * FIELDS:(i + 1) * FIELDS]
        if any(f):
            out[name] = (tuple(f[0:3]), tuple(f[3:5]), tuple(f[5:7]), bool(f[7]))
    return out


def _rebuilt(t, d, k_axis):
    """The operand `d` describes, rebuilt on t's storage."""
    (inner, outer, e), (s1, s2), _, k_major = d
    es = t.element_size()
    assert s1 % es == 0 and s2 % es == 0
    stored = torch.as_strided(t, (e, outer, inner), (s2 // es, s1 // es, 1), t.storage_offset())
    # the stored row is the operand's last axis unless it is the contraction
    # axis of B (k_axis 1) or an MN-major A
    row_last = (k_axis == 2 and k_major) or (k_axis == 1 and not k_major) or k_axis is None
    return stored if row_last else stored.mT


def _check(t, d, k_axis, box_rows):
    got = _rebuilt(t, d, k_axis)
    assert got.shape == t.shape and torch.equal(got, t)
    k_major = d[3]
    assert d[2] == (mm_ops.TMA_BOX, box_rows if k_major or k_axis is None else mm_ops.TMA_BOX)
    assert all(s % 16 == 0 for s in d[1])


def _stack(e, r, c, seed, transposed=False):
    g = torch.Generator().manual_seed(seed)
    if transposed:  # the .mT view of a row-major (e, c, r) stack
        return torch.randn(e, c, r, generator=g).to(BF).mT
    return torch.randn(e, r, c, generator=g).to(BF)


def _operands(layout, e, m, k, n):
    """(x, w, x1, w1) of one batched launch in `layout`, as the Functions'
    backwards pass them."""
    x = _stack(e, m, k, 0, transposed=layout == "tn")
    w = _stack(e, k, n, 1, transposed=layout.startswith("nt"))
    if layout != "nt pair":
        return x, w, None, None
    return x, w, _stack(e, m, k, 2), _stack(e, k, n, 3, transposed=True)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("cap", CAPACITIES)
@pytest.mark.parametrize("layout", ["nn", "nt", "nt pair", "tn"])
def test_matmul_expert_descriptions_rebuild_the_operands(layout, cap, k):
    """Every operand of the nn, nt, nt-pair and tn launches, and the output,
    rebuilt from its description on its own storage, at the TMA route's
    ragged capacities and contractions (the wgrad's k is the capacity)."""
    e = 3
    m, kk, n = (96, cap, k) if layout == "tn" else (cap, k, 136)
    x, w, x1, w1 = _operands(layout, e, m, kk, n)
    out = _stack(e, m, n, 9)     # the output's place (values, so a rebuild is compared)
    tm, tn = mm_ops.pick_tile(m)
    desc = mm_ops.expert_route(x, w, x1, w1, out, tm, tn)
    assert desc is not None
    d = _slots(desc)
    assert set(d) == {"a", "b0", "c"} | ({"a1", "b1"} if x1 is not None else set())
    # a K-major A box spans the tile's rows, or an expert's fewer rounded to 8
    a_rows = mm_ops.tma_a_rows(m, tm)
    assert a_rows == (tm if m >= tm else -(-m // 8) * 8)
    _check(x, d["a"], 2, a_rows)
    _check(w, d["b0"], 1, tn)
    _check(out, d["c"], None, mm_ops.TMA_BOX)
    if x1 is not None:
        _check(x1, d["a1"], 2, a_rows)
        _check(w1, d["b1"], 1, tn)
    # the layouts' majors: A K-major unless transposed, B K-major when transposed
    assert d["a"][3] == (layout != "tn") and d["b0"][3] == layout.startswith("nt")


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("cap", CAPACITIES)
def test_recompute_descriptions_rebuild_the_operands(gated, cap):
    """The batched recompute's x, weights, dh, dg and du rebuilt from their
    descriptions (x in boxes of the tile's rows or its capacity's, dh of the
    tile's rows, the weights MN-major, dg and du in 64-row boxes)."""
    e, h, f = 2, 200, 136
    x, wu = _stack(e, cap, h, 4), _stack(e, h, f, 5)
    wg = _stack(e, h, f, 6) if gated else None
    dh = _stack(e, cap, f, 7)
    dg, du = _stack(e, cap, f, 8) if gated else None, _stack(e, cap, f, 9)
    tile = fused_ops.pick_tile(cap, BF)
    d = _slots(fused_ops.recompute_route(x, wg, wu, dh, dg, du, tile))
    assert set(d) == {"a", "b0", "dh", "du"} | ({"b1", "dg"} if gated else set())
    _check(x, d["a"], 2, mm_ops.tma_a_rows(cap, tile[0]))
    _check(wg if gated else wu, d["b0"], 1, tile[1])
    _check(dh, d["dh"], None, tile[0])
    _check(du, d["du"], None, mm_ops.TMA_BOX)
    if gated:
        _check(wu, d["b1"], 1, tile[1])
        _check(dg, d["dg"], None, mm_ops.TMA_BOX)
    assert d["a"][3] and not d["b0"][3]


def _offset(t):
    """t's values in a stack whose base is 2 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    return flat.view(t.shape).copy_(t)


@pytest.mark.parametrize("case", ["row of 70", "base + 2 bytes", "output row of 45", "f32"])
def test_stacks_off_16_bytes_take_the_grid_z_route(case):
    """A stored row or a base that is not a whole 16 bytes, or f32, gives no
    description: the wrapper launches the grid-z route (`vec` as before)."""
    e, m, k, n = 2, 8, 64, 128
    x, w = _stack(e, m, k, 0), _stack(e, k, n, 1)
    if case == "row of 70":
        x, w = _stack(e, m, 70, 0), _stack(e, 70, n, 1)
    elif case == "base + 2 bytes":
        x = _offset(x)
        assert x.data_ptr() % 16 == 2
    elif case == "output row of 45":
        w = _stack(e, k, 45, 1, transposed=True)
    elif case == "f32":
        x, w = x.float(), w.float()
    out = torch.empty(e, m, w.shape[2], dtype=x.dtype)
    assert mm_ops.expert_route(x, w, None, None, out, 64, 128) is None
    # the recompute too: x misaligned or f32
    if case in ("base + 2 bytes", "f32", "row of 70"):
        f = 128
        wg, wu = _stack(e, x.shape[2], f, 2).to(x.dtype), _stack(e, x.shape[2], f, 3).to(x.dtype)
        dh = torch.empty(e, m, f, dtype=x.dtype)
        assert fused_ops.recompute_route(x, wg, wu, dh, dh, dh, (64, 64)) is None


def test_aligned_views_take_the_tma_route():
    """The route's counterpart: the same shapes whole, and a row-major slice
    of experts (its base at a whole expert), take descriptions."""
    x, w = _stack(4, 8, 64, 0), _stack(4, 64, 128, 1)
    out = torch.empty(2, 8, 128, dtype=BF)
    assert mm_ops.expert_route(x[2:], w[2:], None, None, out, 64, 128) is not None


# (launch, FLOPs, bytes) the op counter charged per batched launch before the
# TMA route, at deepseek-v3's training cut (16 experts, capacity 2560, h
# 7168, f 2048) and its decode capacity (256 experts x 8 rows, gelu).
CHARGES = {
    "nn": [("matmul_expert", 1202590842880.0, 1224736768.0)],
    "nt": [("matmul_expert", 1202590842880.0, 1224736768.0)],
    "nt pair": [("matmul_expert", 2405181685760.0, 1862270976.0)],
    "tn": [("matmul_expert", 1202590842880.0, 1224736768.0)],
    "bwd swiglu": [("fused_mlp_bwd_expert", 2405181685760.0, 2030043136.0),
                   ("matmul_expert", 2405181685760.0, 1862270976.0),
                   ("matmul_expert", 1202590842880.0, 1224736768.0),
                   ("matmul_expert", 1202590842880.0, 1224736768.0)],
    "bwd gelu decode": [("fused_mlp_bwd_expert", 60129542144.0, 7562330112.0),
                        ("matmul_expert", 60129542144.0, 7553941504.0),
                        ("matmul_expert", 60129542144.0, 7553941504.0)],
}


def _meta(*shape, transposed=False):
    if transposed:
        return torch.empty(shape[0], shape[2], shape[1], dtype=BF, device="meta").mT
    return torch.empty(shape, dtype=BF, device="meta")


@pytest.mark.parametrize("what", list(CHARGES))
def test_batched_charges_unchanged_on_meta(what):
    """The batched launches traced on meta (the TMA route's shapes, nothing
    launched) charge the op counter what they charged before it."""
    e, cap, h, f = 16, 2560, 7168, 2048
    with op_analysis.count() as c:
        if what == "nn":
            out = mm_ops.matmul_expert(_meta(e, cap, f), _meta(e, f, h))
        elif what == "nt":
            out = mm_ops.matmul_expert(_meta(e, cap, f), _meta(e, f, h, transposed=True))
        elif what == "nt pair":
            out = mm_ops.matmul_expert(_meta(e, cap, f), _meta(e, f, h, transposed=True),
                                       _meta(e, cap, f), _meta(e, f, h, transposed=True))
        elif what == "tn":
            out = mm_ops.matmul_expert(_meta(e, h, cap, transposed=True), _meta(e, cap, f))
        elif what == "bwd swiglu":
            out = fused_ops.fused_mlp_bwd_expert(_meta(e, cap, h), _meta(e, h, f),
                                                 _meta(e, h, f), _meta(e, cap, f))[0]
        else:
            e, cap = 256, 8
            out = fused_ops.fused_mlp_bwd_expert(_meta(e, cap, h), None, _meta(e, h, f),
                                                 _meta(e, cap, f), mlp_type="gelu")[0]
    assert out.device.type == "meta"
    want = {}
    for name, fl, nb in CHARGES[what]:
        row = want.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        row["launches"] += 1
        row["flops"] += fl
        row["bytes"] += nb
    assert c.counts.kernels == want
