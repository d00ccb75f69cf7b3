"""Rule registry: every check the lint engine can raise, with a stable ID.

The JAX package's catalog (`repro.analysis.rules`), with its IDs, names,
severities and passes, and the port's own checks where they differ:

  * ``SHP1xx`` — shape-efficiency audit over the port's config registry
    (`analysis.shape_audit`), priced through the port's `core.gemm_model`
    at the H100 by default.
  * ``KRN1xx`` — kernel contract (`analysis.kernel_contract`): KRN101-103
    read the CUDA sources (`kernels/csrc/*.cu`, `*.cuh`) where JAX reads
    Pallas bodies; KRN104-107 are the tuned-op contract between the
    wrappers' cache lookups, `tuning/search.py` and `tuning/candidates.py`.
  * ``JIT2xx`` — capture hygiene (`analysis.jit_hygiene`): host-side effects
    in code that `torch.compile` traces or a CUDA graph captures, where JAX
    checks `jax.jit` / `pl.pallas_call`-reachable code.
  * ``ANA0xx`` — the engine itself (unparseable file, unknown rule in a
    pragma).

``python -m repro_torch.analysis --list-rules`` prints it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    name: str
    default_severity: str  # info | warn | error
    pass_name: str  # shape | kernel | jit | engine
    doc: str


RULES: Dict[str, Rule] = {}


def register(rule_id: str, name: str, default_severity: str, pass_name: str,
             doc: str) -> Rule:
    if rule_id in RULES:
        raise ValueError(f"duplicate rule id {rule_id}")
    r = Rule(rule_id, name, default_severity, pass_name, doc)
    RULES[rule_id] = r
    return r


def get_rule(rule_id: str) -> Rule:
    return RULES[rule_id]


# -- engine ------------------------------------------------------------------
ANA001 = register(
    "ANA001", "syntax-error", "error", "engine",
    "Python file does not parse; no other checks can run on it (CUDA "
    "sources are not parsed, so never raise it).")
ANA002 = register(
    "ANA002", "unknown-rule-in-pragma", "warn", "engine",
    "A `# repro: noqa[...]` pragma (`// repro: noqa[...]` in a CUDA "
    "source) names a rule ID that does not exist (typo'd suppressions "
    "silently stop suppressing).")

# -- shape audit -------------------------------------------------------------
SHP101 = register(
    "SHP101", "vocab-alignment", "error", "shape",
    "vocab_size is not a multiple of the hardware lane width (paper §VI-B "
    "'vocab divisible by 64'; 64 on the H100, 128 on TPU lanes).  The "
    "embedding/lm_head GEMM pads every pass; the fix hint prices padding "
    "the declared vocab.")
SHP102 = register(
    "SHP102", "head-dim-alignment", "error", "shape",
    "d_model/num_heads leaves a head_dim whose largest power-of-two factor "
    "is below the lane width — attention BMMs run at reduced tensor-core "
    "utilization (paper Fig. 1 GPT-3 2.7B case study).")
SHP103 = register(
    "SHP103", "dff-alignment", "error", "shape",
    "d_ff is not lane-aligned (tile quantization pads every MLP GEMM pass; "
    "paper §VII-B d_ff re-search).")
SHP104 = register(
    "SHP104", "expert-dff-alignment", "error", "shape",
    "MoE expert d_ff (moe_d_ff) is not lane-aligned; every expert GEMM pads.")
SHP105 = register(
    "SHP105", "ssm-alignment", "error", "shape",
    "SSM state or chunk size is not lane-aligned; the SSD chunk BMMs pad.")
SHP106 = register(
    "SHP106", "wave-quantization", "warn", "shape",
    "On wave-scheduled hardware (GPUs: the H100's 132 SMs), the MLP output "
    "tile count leaves a mostly-empty tail wave over the SMs (paper §VI-B "
    "wave quantization).  Only raised for hardware with concurrent_tiles.")

# -- kernel contract ---------------------------------------------------------
KRN101 = register(
    "KRN101", "non-f32-accumulator", "error", "kernel",
    "A CUDA accumulator — a wmma accumulator fragment, or an array whose "
    "name holds `acc` — is declared at half, __half, __nv_bfloat16 or bf16.  "
    "Accumulators must be f32 (s32 for int8 products): bf16 accumulation "
    "loses ~8 bits of mantissa per product.  (JAX checks Pallas VMEM "
    "scratch.)")
KRN102 = register(
    "KRN102", "dot-missing-f32-accum", "error", "kernel",
    "A tensor-core product in a CUDA source (`wgmma.mma_async`, `mma.sync`, "
    "`wmma::mma_sync`) accumulates below f32 for float operands, or other "
    "than s32 for s8/u8 operands.  (JAX checks dot/dot_general's "
    "preferred_element_type in Pallas bodies.)")
KRN103 = register(
    "KRN103", "launch-geometry-uninstantiated", "error", "kernel",
    "A tile in a wrapper's geometry constants (module-level `*_TILE` / "
    "`*_TILES` of a Python file that calls a C entry) appears in no "
    "dispatch case or template instantiation of the code that the C "
    "entries of a launching function it reaches run: the Python side can "
    "choose a launch the library refuses.  A one-dimensional tile must be "
    "a dispatch or `case` value.  (JAX's KRN103 checks BlockSpec index-map "
    "arity against the grid rank.)")
KRN104 = register(
    "KRN104", "tuned-op-unregistered", "error", "kernel",
    "A tuning-cache lookup names an op that no autotune entry point ever "
    "writes — tuned=True would silently never hit.  Op names resolve "
    "through parameters of writer and lookup helpers (`_best`, "
    "`paged_geometry`), `fn.__name__` and the `*_op_name` helpers.")
KRN105 = register(
    "KRN105", "tuned-key-arity", "error", "kernel",
    "A tuning-cache lookup's shape-key arity differs from what the "
    "autotuner persists for that op — the key never matches, so tuned=True "
    "silently falls back to defaults.")
KRN106 = register(
    "KRN106", "autotune-without-lattice", "error", "kernel",
    "An autotune entry point does not sweep a `*_candidates` lattice, or "
    "its lattice is bounded by no Hopper feasibility model: shared memory "
    "within SMEM_LIMIT, or tiles drawn from the wrappers' geometry "
    "constants (what the CUDA library instantiates).")
KRN107 = register(
    "KRN107", "tuned-op-never-consulted", "warn", "kernel",
    "The autotuner persists entries for an op that nothing in the analyzed "
    "tree ever looks up (dead tuning entries).")

# -- jit hygiene -------------------------------------------------------------
JIT201 = register(
    "JIT201", "obs-inside-jit", "error", "jit",
    "An obs span/metric/dispatch call is reachable from a function that "
    "torch.compile traces or a CUDA graph captures (torch.compile, "
    "torch.cuda.make_graphed_callables, a `with torch.cuda.graph(...)` "
    "block).  It runs once at trace or capture time and records nothing "
    "on replay.")
JIT202 = register(
    "JIT202", "host-effect-inside-jit", "error", "jit",
    "A host-side clock or RNG call (time.*, random.*, np.random.*, "
    "datetime.now) is reachable from traced or captured code: it executes "
    "once and is baked into the program or graph as a constant.")
JIT203 = register(
    "JIT203", "mutable-default-in-jit", "error", "jit",
    "A function reachable from traced or captured code has a mutable "
    "default argument (list/dict/set): the default is captured once and "
    "shared across calls.")
JIT204 = register(
    "JIT204", "global-capture-in-jit", "error", "jit",
    "A function reachable from traced or captured code declares `global`, "
    "or reads a module-level mutable (list/dict/set) that the module "
    "mutates elsewhere — the value is captured once and later mutation "
    "never reaches the replayed program.")
