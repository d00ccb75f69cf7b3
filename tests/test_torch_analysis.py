"""The port's codesign lint engine (repro_torch.analysis) against the JAX
package's (repro.analysis), on the CPU.

* the shape audit equals JAX's for every registered config, production and
  smoke, at every hardware target and two tensor-parallel degrees, and on
  the registry (only the configs' package differs in a finding's path);
* pragma scanning, the reporters and the engine's own findings (JAX's
  bad-pragma and syntax-error fixtures) equal JAX's;
* every kernel rule (KRN101-107, over CUDA sources and the tuned-op
  plumbing in the port's idiom) and every capture rule (JIT201-204, under
  torch.compile and a torch.cuda.graph block) fires on a planted fault and
  stays silent on its clean twin, whose sources are written below;
* the CLI gates, and passes on the port's own tree.
"""
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import reporters as jax_reporters
from repro.analysis import shape_audit as jax_audit
from repro.analysis import source as jax_source
from repro.analysis.engine import analyze as jax_analyze
from repro.analysis.findings import Finding as JaxFinding
from repro.configs import registry as jax_registry
from repro.core.hardware import get_hardware as jax_hardware
from repro_torch.analysis import RULES, analyze, audit_config, audit_registry
from repro_torch.analysis import reporters, source
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import RULES as PORT_RULES
from repro_torch.configs import registry
from repro_torch.core.hardware import get_hardware

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SRC = os.path.abspath(os.path.join(ROOT, "src"))
JAX_FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "analysis")
HWS = ("tpu_v5e", "a100", "v100", "h100")


def run(paths, **kw):
    kw.setdefault("registry_audit", False)
    return analyze([str(p) for p in paths], **kw)


def rule_ids(result):
    return sorted({f.rule_id for f in result.findings})


def write(tmp_path, files: dict):
    """Write {relative path: source} under tmp_path; returns tmp_path."""
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text).lstrip("\n"))
    return tmp_path


# -- shape audit against JAX ---------------------------------------------------


def _config_pairs():
    """(name, JAX config, port config) for every registered config,
    production and smoke."""
    jax_registry._load_all()
    registry._load_all()
    assert sorted(jax_registry._REGISTRY) == sorted(registry._REGISTRY)
    for name in sorted(registry._REGISTRY):
        yield name, jax_registry._REGISTRY[name], registry._REGISTRY[name]
        yield f"{name} smoke", jax_registry._SMOKE[name], registry._SMOKE[name]


def _raw(findings):
    return [(r.rule_id, r.severity, r.message, r.fix_hint) for r in findings]


@pytest.mark.parametrize("hw_name", HWS)
def test_audit_config_equals_jax_for_every_config(hw_name):
    # every field the finding shows: the rule, severity, message (the JAX
    # wording, "MXU" included, kept so the two stay comparable) and the
    # priced fix hint, at tp 1 and 2
    for tp in (1, 2):
        for name, jcfg, tcfg in _config_pairs():
            want = _raw(jax_audit.audit_config(jcfg, jax_hardware(hw_name), tp))
            got = _raw(audit_config(tcfg, get_hardware(hw_name), tp))
            assert got == want, (name, hw_name, tp)


def _anchored(findings):
    """A registry finding with its path cut to the config file's name: the
    one field that differs (src/repro/configs vs src/repro_torch/configs)."""
    return sorted((os.path.basename(f.file), f.line, f.rule_id, f.severity, f.arch,
                   f.message, f.fix_hint) for f in findings)


@pytest.mark.parametrize("hw_name", HWS)
def test_audit_registry_equals_jax(hw_name):
    want = jax_audit.audit_registry(hw_name=hw_name)
    got = audit_registry(hw_name=hw_name)
    assert got and _anchored(got) == _anchored(want)
    assert all(os.sep + "repro_torch" + os.sep in f.file for f in got)
    # the zamba2 pragma (configs/zamba2_2p7b.py) silences its SHP102 in both
    assert not any(f.arch == "zamba2-2.7b" and f.rule_id == "SHP102" for f in got)


def test_audit_defaults_to_the_h100():
    got = audit_registry()
    assert _anchored(got) == _anchored(audit_registry(hw_name="h100"))
    shp101 = {f.arch: f for f in got if f.rule_id == "SHP101" and f.severity == "warn"
              and not f.arch.endswith("-smoke")}
    assert set(shp101) == {"gpt3-2.7b-c0", "mamba2-780m", "whisper-small"}
    c0 = [f for f in got if f.arch == "gpt3-2.7b-c0" and f.rule_id == "SHP102"]
    assert len(c0) == 1 and "num_heads 32 -> 10 (head_dim 80 -> 256)" in c0[0].fix_hint
    assert not any(f.severity == "error" for f in got)
    smoke = audit_registry(include_smoke=False)
    assert smoke and not any(f.arch.endswith("-smoke") for f in smoke)


def test_the_priced_sibling_is_the_hints():
    """`_price_heads` returns the sibling config it priced (the one a card
    run times): its heads those of the hint, whole heads of d_model, KV
    heads that divide them, multi-head attention kept multi-head."""
    from repro_torch.analysis.shape_audit import _price_heads
    hw = get_hardware("h100")
    priced = 0
    for _, _, cfg in _config_pairs():
        if not cfg.num_heads or cfg.head_dim % hw.tile_2byte[1] == 0:
            continue
        got = _price_heads(cfg, hw)
        if got is None:
            continue
        sib, gain = got
        priced += 1
        hint = [f.fix_hint for f in audit_config(cfg, hw) if f.rule_id == "SHP102"]
        assert hint == [f"num_heads {cfg.num_heads} -> {sib.num_heads} (head_dim "
                        f"{cfg.head_dim} -> {sib.head_dim}), est. +{gain:.1f}% step time"]
        assert sib.head_dim * sib.num_heads == cfg.d_model
        assert sib.num_heads % sib.num_kv_heads == 0
        if cfg.num_kv_heads == cfg.num_heads:
            assert sib.num_kv_heads == sib.num_heads
    assert priced
    c0 = _price_heads(registry._REGISTRY["gpt3-2.7b-c0"], hw)[0]
    assert (c0.num_heads, c0.num_kv_heads, c0.head_dim) == (10, 10, 256)


# -- pragmas, reporters and the engine's findings against JAX -----------------


PRAGMA_TEXT = '''
"""A docstring showing `# repro: noqa[KRN101]` suppresses nothing."""
a = 1  # repro: noqa[KRN102]
b = 2  # repro: noqa[KRN101, JIT201]
c = 3  # repro: noqa
d = 4  # repro: noqa[KRN999,SHP101]
e = "# repro: noqa[JIT202]"
'''


def test_scan_pragmas_equals_jax():
    for text in (PRAGMA_TEXT, "x = (\n", open(os.path.join(JAX_FIXTURES, "bad_pragma.py")).read()):
        lines = text.splitlines()
        got, want = source.scan_pragmas(text, lines), jax_source.scan_pragmas(text, lines)
        assert (got.by_line, got.unknown) == (want.by_line, want.unknown)


def test_cuda_pragmas_read_line_comments_only():
    text = textwrap.dedent('''
        // repro: noqa[KRN101]
        float acc[4];  // repro: noqa[KRN102,KRN999]
        const char* s = "// repro: noqa[KRN103]";
        /* repro: noqa[KRN104] */ int x;
    ''')
    sup = source.scan_cuda_pragmas(text, text.splitlines())
    assert sup.by_line == {2: {"KRN101"}, 3: {"KRN102", "KRN999"}}
    assert sup.unknown == [(3, "KRN999")]
    code, skel, _ = source.lex_cuda(text)
    assert len(code) == len(skel) == len(text) and code.count("\n") == text.count("\n")
    assert "repro" not in skel and '"// repro: noqa[KRN103]"' in code


def _pair(cls, i):
    return cls(f"pkg/f{i % 3}.py", 10 - i, ("KRN101", "SHP101", "JIT204")[i % 3],
               ("error", "warn", "info")[i % 3], f"message {i} [arch{i}]",
               fix_hint="" if i % 2 else f"hint {i}", arch=f"arch{i}" if i % 2 else "")


def test_reporters_equal_jax():
    port = [_pair(Finding, i) for i in range(7)]
    jax = [_pair(JaxFinding, i) for i in range(7)]
    for fs, jfs in ((port, jax), ([], [])):
        for verbose in (True, False):
            a, b = io.StringIO(), io.StringIO()
            reporters.render_text(fs, a, verbose=verbose)
            jax_reporters.render_text(jfs, b, verbose=verbose)
            assert a.getvalue() == b.getvalue()
        a, b = io.StringIO(), io.StringIO()
        reporters.render_json(fs, a, meta={"paths": ["x"], "hw": "h100"})
        jax_reporters.render_json(jfs, b, meta={"paths": ["x"], "hw": "h100"})
        assert a.getvalue() == b.getvalue()
    a = io.StringIO()
    reporters.render_json(port, a)
    doc = json.loads(a.getvalue())
    assert [Finding.from_json(d) for d in doc["findings"]] == sorted(port,
                                                                     key=lambda f: f.sort_key)


def test_engine_findings_equal_jax_on_its_fixtures():
    paths = [os.path.join(JAX_FIXTURES, n) for n in ("syntax_error.py", "bad_pragma.py")]
    got = run(paths).findings
    want = jax_analyze(paths, registry_audit=False).findings
    assert [(f.file, f.line, f.rule_id, f.severity, f.message) for f in got] == \
        [(f.file, f.line, f.rule_id, f.severity, f.message) for f in want]
    assert rule_ids(run(paths)) == ["ANA001", "ANA002"]


def test_rule_catalog_matches_jax():
    from repro.analysis.rules import RULES as JAX_RULES
    assert RULES is PORT_RULES
    assert sorted(RULES) == sorted(JAX_RULES)
    for rid, r in RULES.items():
        j = JAX_RULES[rid]
        assert (r.default_severity, r.pass_name) == (j.default_severity, j.pass_name)
        assert r.doc


# -- kernel rules over CUDA sources: KRN101, KRN102 ---------------------------

KRN101_BAD = '''
#include <mma.h>
using namespace nvcuda;
__global__ void k() {
  __nv_bfloat16 acc[8];
  wmma::fragment<wmma::accumulator, 16, 16, 16, half> c_frag;
}
'''
KRN101_OK = '''
#include <mma.h>
using namespace nvcuda;
__global__ void k() {
  float acc[8];
  __nv_bfloat16 out[8];  // the stored output, not an accumulator
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c_frag;
}
'''
KRN102_BAD = '''
__device__ void f(float* d) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n128k16.f16.f16.f16 {%0}, %1, %2;" : "+f"(d[0]));
  asm volatile("wgmma.mma_async.sync.aligned.m64n128k32.f32.s8.s8 {%0}, %1, %2;" : "+f"(d[0]));
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 {%0}, {%1}, {%2}, {%3};");
}
__global__ void w() {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, half, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, half, wmma::col_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, half> c;
  wmma::mma_sync(c, a, b, c);
}
'''
KRN102_OK = '''
// wgmma.mma_async.sync.aligned.m64n128k16.f16.f16.f16 in a comment is not code
__device__ void f(float* d) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0}, %1, %2;" : "+f"(d[0]));
  asm volatile("wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {%0}, %1, %2;" : "+r"(d[0]));
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0}, {%1}, {%2}, {%3};");
}
__global__ void w() {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> c;
  wmma::mma_sync(c, a, b, c);
}
'''


def test_krn101_fires_on_half_accumulators_and_not_on_the_clean_twin(tmp_path):
    write(tmp_path, {"bad/k.cu": KRN101_BAD, "ok/k.cu": KRN101_OK})
    bad = run([tmp_path / "bad"]).findings
    assert [(f.rule_id, f.line) for f in bad] == [("KRN101", 4), ("KRN101", 5)]
    assert all(f.fix_hint for f in bad)
    assert run([tmp_path / "ok"]).findings == []


def test_krn102_fires_on_narrow_products_and_not_on_the_clean_twin(tmp_path):
    write(tmp_path, {"bad/k.cu": KRN102_BAD, "ok/k.cu": KRN102_OK})
    bad = run([tmp_path / "bad"]).findings
    assert [(f.rule_id, f.line) for f in bad if f.rule_id == "KRN102"] == [
        ("KRN102", 2), ("KRN102", 3), ("KRN102", 4), ("KRN102", 10)]
    assert "f16" in bad[0].message and "f32" in bad[0].fix_hint
    assert run([tmp_path / "ok"]).findings == []


def test_cuda_pragma_silences_a_kernel_finding(tmp_path):
    text = KRN102_BAD.replace(
        '.f16.f16.f16 {%0}, %1, %2;" : "+f"(d[0]));',
        '.f16.f16.f16 {%0}, %1, %2;" : "+f"(d[0]));  // repro: noqa[KRN102]')
    write(tmp_path, {"k.cu": text})
    lines = [f.line for f in run([tmp_path]).findings if f.rule_id == "KRN102"]
    assert lines == [3, 4, 10]


# -- launch geometry: KRN103 --------------------------------------------------

GEOMETRY_CU = '''
#include "toy_tile.cuh"
template <int TM, int TN, bool T>
static int launch(int m) { return TM * TN + m; }

template <int TM>
static int launch_fused(int m) { return launch<TM, 32, true>(m); }

#define TOY_CASE(TM, TN) \\
  if (tm == TM && tn == TN) return launch<TM, TN, false>(m);

static int dispatch(int m, int tm, int tn) {
  if (tm == 64 && tn == 128) return launch<64, 128, false>(m);
  TOY_CASE(128, 128)
  return -1;
}

// (128, 256) in a comment: tm == 128 && tn == 256
extern "C" int repro_toy(int m, int tm, int tn, int f32) {
  if (f32) {
    if (tm != BM || tn != BN) return -1;
    return 0;
  }
  return dispatch(m, tm, tn);
}

extern "C" int repro_toy_expert(int m, int tm, int tn) {
  if (tm == 64 && tn == 128) return launch<64, 128, true>(m);
  if (tm == 128 && tn == 128) return launch<128, 128, true>(m);
  return -1;
}

extern "C" int repro_toy_fused(int m, int tm) {
  if (tm == 64) return launch_fused<64>(m);
  if (tm == 128) return launch_fused<128>(m);
  return -1;
}
'''
GEOMETRY_CUH = '''
constexpr int BM = 48, BN = BM + 16;
'''
PAGED_CU = '''
constexpr int PAD = 96;  // a constant's value is no dispatch
template <int BKV>
static int run(int d) { return BKV + d; }

template <int DP>
static int widen(int d) { return DP - d; }

extern "C" int repro_toy_paged(int tile, int d) {
  if (d > PAD) return widen<96>(d);  // a template's first argument is no dispatch
  if (tile == 32) return run<32>(d);
  if (tile == 64) return run<64>(d);
  return -1;
}
'''
GEOMETRY_OPS = '''
import ctypes
DECODE_TILE = (64, 128)
TRAIN_TILE = (128, 128)
TILES = (DECODE_TILE, TRAIN_TILE)
F32_TILE = (48, 64)
FUSED_TILE, FUSED_WIDE_TILE = (64, 32), (128, 32)
PAGED_TILES = (32, 64)
SHARED_TILES = 4  # a count, not a tile


def pick_tile(m, f32):
    if f32:
        return F32_TILE
    return DECODE_TILE if m <= DECODE_TILE[0] else TRAIN_TILE


def launch(lib, m, f32):
    tm, tn = pick_tile(m, f32)
    return lib.repro_toy(m, tm, tn, int(f32))


def launch_expert(lib, m):
    tm, tn = TILES[m > 64]
    return lib.repro_toy_expert(m, tm, tn)


def launch_fused(lib, m):
    tm, _ = FUSED_TILE if m <= 64 else FUSED_WIDE_TILE
    return lib.repro_toy_fused(m, tm)


def launch_paged(lib, d, long):
    return lib.repro_toy_paged(PAGED_TILES[long], d)
'''


def _geometry_tree(tmp_path, ops=GEOMETRY_OPS, cu=GEOMETRY_CU, paged=PAGED_CU):
    return write(tmp_path, {"csrc/toy.cu": cu, "csrc/toy_tile.cuh": GEOMETRY_CUH,
                            "csrc/toy_paged.cu": paged, "toy/ops.py": ops})


def test_krn103_reads_dispatch_templates_macros_and_guards(tmp_path):
    _geometry_tree(tmp_path)
    assert run([tmp_path]).findings == []


def test_krn103_geometry_constants_and_their_launches(tmp_path):
    from repro_torch.analysis import kernel_contract
    sf = source.load_source(str(_geometry_tree(tmp_path) / "toy" / "ops.py"))
    consts = {name: tiles for name, _, tiles in kernel_contract.geometry_constants(sf)}
    assert "SHARED_TILES" not in consts  # an int under a *_TILES name is a count
    assert consts["PAGED_TILES"] == [32, 64] and consts["TILES"] == [(64, 128), (128, 128)]
    entries = {"repro_toy", "repro_toy_expert", "repro_toy_fused", "repro_toy_paged"}
    reached = kernel_contract.launches_of_constants(sf.tree, entries)
    assert reached["F32_TILE"] == [{"repro_toy"}]
    assert reached["TILES"] == [{"repro_toy_expert"}]
    assert sorted(map(sorted, reached["DECODE_TILE"])) == [["repro_toy"], ["repro_toy_expert"]]
    assert reached["FUSED_WIDE_TILE"] == [{"repro_toy_fused"}]
    assert reached["PAGED_TILES"] == [{"repro_toy_paged"}]


@pytest.mark.parametrize("fault", [
    ("ops", "TILES = (DECODE_TILE, TRAIN_TILE)", "TILES = (DECODE_TILE, (128, 256))", "TILES",
     "repro_toy_expert (toy.cu)"),
    ("ops", "F32_TILE = (48, 64)", "F32_TILE = (64, 64)", "F32_TILE", "repro_toy (toy.cu)"),
    ("ops", "(64, 32), (128, 32)", "(64, 32), (128, 64)", "FUSED_WIDE_TILE",
     "repro_toy_fused (toy.cu)"),
    # a one-dimensional tile: 96 is a template's first argument and a
    # constant's value in toy_paged.cu, but no dispatch
    ("ops", "PAGED_TILES = (32, 64)", "PAGED_TILES = (32, 96)", "PAGED_TILES",
     "repro_toy_paged (toy_paged.cu)"),
    # the entry that launches TRAIN_TILE loses its 128 x 128 case, while
    # another entry of the same file keeps one
    ("cu", "  TOY_CASE(128, 128)\n", "", "TRAIN_TILE", "repro_toy (toy.cu)"),
    ("paged", "  if (tile == 64) return run<64>(d);\n", "", "PAGED_TILES",
     "repro_toy_paged (toy_paged.cu)"),
])
def test_krn103_fires_on_a_tile_the_sources_do_not_instantiate(tmp_path, fault):
    where, old, new, name, entry = fault
    texts = {"ops": GEOMETRY_OPS, "cu": GEOMETRY_CU, "paged": PAGED_CU}
    assert old in texts[where]
    texts[where] = texts[where].replace(old, new)
    _geometry_tree(tmp_path, **texts)
    found = run([tmp_path]).findings
    assert [f.rule_id for f in found] == ["KRN103"]
    assert found[0].file.endswith("ops.py") and found[0].message.startswith(name + " ")
    assert f"which {entry} neither" in found[0].message
    # the Python side alone has no sources to hold it to
    assert run([tmp_path / "toy"]).findings == []


# -- the tuned-op contract: KRN104-107 in the port's idiom --------------------

CONTRACT_OPS = '''
from ..tuning.cache import lookup

TILES = ((64, 128), (128, 128))
SMEM_LIMIT = 232448


def op_name(kind):
    return f"toy_{kind}"


def geometry(m, k, n, *, op="matmul"):
    return lookup(op, (m, k, n), "bfloat16", "h100")


def paged_geometry(op, key_shape):
    return lookup(op, key_shape, "bfloat16", "h100")


def _paged(fn, b, n, d):
    what = fn.__name__
    return paged_geometry(what, (b, n, d))


def paged(b, n, d):
    return _paged(paged, b, n, d)


def fused(m, h, f, kind):
    return lookup(op_name(kind), (m, h, f), "bfloat16", "h100")


def mm(m, k, n):
    return geometry(m, k, n)


def fp8(m, k, n):
    return geometry(m, k, n, op="fp8_matmul")
'''
CONTRACT_CANDIDATES = '''
from ..kernels import ops


def matmul_candidates(m, k, n):
    return [t + (1,) for t in ops.TILES]


def paged_candidates(b, d):
    return [(t, s) for t in (32, 64) for s in (1, 2) if t * d * 4 <= ops.SMEM_LIMIT]
'''
CONTRACT_SEARCH = '''
from .cache import TunedConfig
from .candidates import matmul_candidates, paged_candidates


def _best(op, shape, blocks, cache):
    cfg = TunedConfig(op=op, shape=tuple(shape), blocks=blocks)
    cache.put(cfg)
    return cfg


def autotune_matmul(m, k, n, cache):
    return _best("matmul", (m, k, n), matmul_candidates(m, k, n)[0], cache)


def autotune_fp8(m, k, n, cache):
    return _best("fp8_matmul", (m, k, n), matmul_candidates(m, k, n)[0], cache)


def autotune_fused(m, h, f, kind, cache):
    from ..kernels.ops import op_name
    op = op_name(kind)
    return _best(op, (m, h, f), matmul_candidates(m, h, f)[0], cache)


def autotune_paged(b, n, d, cache):
    cands = paged_candidates(b, d)
    cache.put(TunedConfig(op="paged", shape=(b, n, d), blocks=cands[0]))
'''
CONTRACT_CACHE = '''
class TunedConfig:
    def __init__(self, op, shape, blocks):
        self.op, self.shape, self.blocks = op, shape, blocks


def lookup(op, shape, dtype, hw):
    return None
'''


def _contract(tmp_path, **edits):
    files = {"kernels/ops.py": CONTRACT_OPS, "tuning/candidates.py": CONTRACT_CANDIDATES,
             "tuning/search.py": CONTRACT_SEARCH, "tuning/cache.py": CONTRACT_CACHE}
    for rel, (old, new) in edits.items():
        rel = rel.replace("__", "/") + ".py"
        assert old in files[rel], (rel, old)
        files[rel] = files[rel].replace(old, new)
    return write(tmp_path, files)


def test_contract_clean_tree_resolves_the_ports_idiom(tmp_path):
    # every op reaches its writer through `_best(op, ...)`, its lookup through
    # an `op` parameter (a default, a keyword, `fn.__name__` through
    # `paged_geometry`) or an `*_op_name`-style helper
    assert run([_contract(tmp_path)]).findings == []


@pytest.mark.parametrize("fault", [
    # a lookup with no writer
    ("KRN104", {"kernels__ops": ('return _paged(paged, b, n, d)',
                                 'return _paged(paged, b, n, d)\n\n\n'
                                 'def ghost_paged(b, n, d):\n'
                                 '    return _paged(ghost_paged, b, n, d)')}, "ghost_paged"),
    # a key-arity mismatch: the fp8 lookup keys 2 elements, the writer 3
    ("KRN105", {"kernels__ops": ('    return geometry(m, k, n, op="fp8_matmul")',
                                 '    return lookup("fp8_matmul", (m, k), "bfloat16", "h100")')},
     "fp8_matmul"),
    # a lattice with no bound
    ("KRN106", {"tuning__candidates": ("return [t + (1,) for t in ops.TILES]",
                                       "return [(64, n, 1), (128, n, 1)]")},
     "matmul_candidates"),
    # an autotune that sweeps no lattice at all
    ("KRN106", {"tuning__search": ("    cands = paged_candidates(b, d)\n",
                                   "    cands = [(64, 1)]\n")}, "autotune_paged"),
    # a dead entry
    ("KRN107", {"tuning__search": ('_best("fp8_matmul", (m, k, n)',
                                   '_best("dead_op", (m, k, n)'),
                "kernels__ops": ('return geometry(m, k, n, op="fp8_matmul")',
                                 'return geometry(m, k, n)')}, "dead_op"),
])
def test_contract_rule_fires_on_its_planted_fault(tmp_path, fault):
    rule, edits, needle = fault
    found = run([_contract(tmp_path, **edits)]).findings
    assert found and {f.rule_id for f in found} == {rule}, found
    assert needle in found[0].message


def test_contract_needs_autotune_in_scope(tmp_path):
    _contract(tmp_path, kernels__ops=('return _paged(paged, b, n, d)',
                                      'return paged_geometry("ghost", (b, n, d))'))
    assert "KRN104" in rule_ids(run([tmp_path]))
    assert run([tmp_path / "kernels"]).findings == []


def test_the_ports_tree_has_no_kernel_findings():
    # the five findings JAX's analyzer raises on the port (KRN104 at the
    # fused, int8 and int8 fused lookups, KRN106 at the block-table lattice,
    # KRN107 at its per-block-size entry) are its idiom, which the port's
    # resolver reads; and every wrapper tile is one its CUDA sources build
    port = os.path.join(SRC, "repro_torch")
    assert run([port]).findings == []
    jax_view = jax_analyze([port], registry_audit=False).findings
    assert jax_view and {f.rule_id for f in jax_view} <= {"KRN104", "KRN106", "KRN107"}


# -- capture hygiene: JIT201-204 ----------------------------------------------

JIT_BAD = '''
import time

import torch

from repro_torch import obs

_CACHE = {}
_COUNT = 0


def helper(x):
    with obs.span("inside"):
        return x * time.time()


@torch.compile
def step(x, seen=[]):
    global _COUNT
    _COUNT += 1
    return helper(x) + _CACHE.get("k", 0)


def remember(k, v):
    _CACHE[k] = v


def capture(g, x):
    with torch.cuda.graph(g):
        obs.counter("captured").inc()
        y = x + time.perf_counter()
    return y
'''
JIT_OK = '''
import time

import torch

from repro_torch import obs

_TABLE = {"k": 1}


def helper(x, t):
    return x * t


@torch.compile
def step(x, seen=None):
    return helper(x, 2.0) + _TABLE["k"]


def capture(g, x):
    with obs.span("capture"):
        t = time.perf_counter()
    with torch.cuda.graph(g):
        y = step(x)
    return y, time.perf_counter() - t
'''


def test_jit_rules_fire_under_compile_and_capture(tmp_path):
    write(tmp_path, {"bad.py": JIT_BAD})
    found = run([tmp_path / "bad.py"]).findings
    assert rule_ids(run([tmp_path / "bad.py"])) == ["JIT201", "JIT202", "JIT203", "JIT204"]
    where = {(f.rule_id, f.line) for f in found}
    # helper reached from the compiled step, and the capture block itself
    assert {("JIT201", 12), ("JIT202", 13), ("JIT203", 17), ("JIT204", 18),
            ("JIT204", 20), ("JIT201", 29), ("JIT202", 30)} == where
    j204 = [f.message for f in found if f.rule_id == "JIT204"]
    assert any("global" in m for m in j204) and any("_CACHE" in m for m in j204)


@pytest.mark.parametrize("root", ["compiled", "graphed", "captured"])
def test_each_capture_root_is_found(tmp_path, root):
    body = {"compiled": "g = torch.compile(f)",
            "graphed": "g = torch.cuda.make_graphed_callables((f,), (x,))",
            "captured": "with torch.cuda.graph(cg):\n                f(x)"}[root]
    write(tmp_path, {"m.py": f'''
        import random
        import torch


        def f(x):
            return x + random.random()


        def main(x, cg):
            {body}
        '''})
    assert [f.rule_id for f in run([tmp_path]).findings] == ["JIT202"]


def test_jit_clean_twin_and_noqa(tmp_path):
    write(tmp_path, {"ok.py": JIT_OK,
                     "noqa.py": JIT_BAD.replace("x * time.time()",
                                                "x * time.time()  # repro: noqa[JIT202]")})
    assert run([tmp_path / "ok.py"]).findings == []
    lines = [f.line for f in run([tmp_path / "noqa.py"]).findings if f.rule_id == "JIT202"]
    assert lines == [30]


# -- the CLI -------------------------------------------------------------------


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=env, cwd=cwd, timeout=120)


def test_cli_gate_formats_and_catalog(tmp_path):
    write(tmp_path, {"bad.cu": KRN101_BAD, "ok.cu": KRN101_OK,
                     "pragma.py": "X = 1  # repro: noqa[KRN999]\n"})
    p = _cli("bad.cu", "--no-registry-audit", cwd=tmp_path)
    assert p.returncode == 1 and "KRN101" in p.stdout and "FAIL" in p.stderr
    assert _cli("ok.cu", "--no-registry-audit", cwd=tmp_path).returncode == 0
    # a warning passes the default gate and fails --fail-on warn
    assert _cli("pragma.py", "--no-registry-audit", cwd=tmp_path).returncode == 0
    assert _cli("pragma.py", "--no-registry-audit", "--fail-on", "warn",
                cwd=tmp_path).returncode == 1
    out = tmp_path / "report.json"
    p = _cli("bad.cu", "--no-registry-audit", "--format", "json", "--output", str(out),
             cwd=tmp_path)
    doc = json.loads(out.read_text())
    assert p.returncode == 1 and doc["counts"]["error"] == 2
    assert doc["meta"]["hw"] == "h100" and doc["meta"]["files_scanned"] == 1
    p = _cli("--list-rules", cwd=tmp_path)
    assert p.returncode == 0
    assert all(rid in p.stdout for rid in RULES)


def test_cli_passes_on_the_port_tree(tmp_path):
    # no paths: the port's own package wherever it runs from, at the H100
    p = _cli("--fail-on", "error", "--format", "json", cwd=tmp_path)
    assert p.returncode == 0, p.stdout + p.stderr
    doc = json.loads(p.stdout)
    assert doc["meta"]["hw"] == "h100" and doc["counts"]["error"] == 0
    scanned = {os.path.relpath(f["file"], SRC).split(os.sep)[0] for f in doc["findings"]}
    assert scanned == {"repro_torch"}
    assert doc["meta"]["files_scanned"] > 100
