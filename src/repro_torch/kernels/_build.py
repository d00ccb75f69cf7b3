"""Build and load the port's CUDA kernels.

Every source under `kernels/csrc/*.cu` compiles in its own `nvcc -c`, all
started together, and one more `nvcc` links the objects into one shared
library with a plain C interface, loaded with `ctypes` (pointers and the
CUDA stream pass as `c_void_p`, ints as `c_int`; every entry point returns
`cudaGetLastError()` and the wrappers raise when it is not 0).  No PyTorch
headers are compiled, so a cold build takes as long as the slowest source.

The build happens at first use, never at import, into `build/kernels/` at
the checkout's root (listed in `.gitignore`).  The library's file name
carries a hash of the sources and flags, so an edited source never loads a
stale build; a finished build is moved into place atomically, so two
processes building at once cannot load a half-written file.

`BUILD_HOOKS` are called with the `Library` each time `build()` resolves
it (an nvcc build, or the load of a finished one), before it is cached:
`obs.CompileWatch` records the build there and, when armed, raises from
inside `build()`, so the kernel call that needed it is on the stack.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/gemm_tile.cuh `DType`, and int8 KV storage
# (csrc/paged_decode.cu)
DT_F32, DT_BF16, DT_INT8 = 0, 1, 2


@dataclasses.dataclass
class Library:
    """The loaded kernel library and how it was obtained."""
    lib: ctypes.CDLL
    path: Path
    build_s: float        # 0.0 when an existing build was loaded
    log: str              # nvcc's output (ptxas register/spill report), kept beside the library


_LIBRARY: Optional[Library] = None
BUILD_HOOKS: List[Callable[[Library], None]] = []


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built on first use "
            "on a machine with the CUDA toolkit (PATH or /usr/local/cuda)")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Library:
    """Compile (if needed) and load the kernel library; cached per process.
    Each resolution is passed to every hook in `BUILD_HOOKS` first."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    lib = _load()
    for hook in list(BUILD_HOOKS):
        hook(lib)
    _LIBRARY = lib
    return lib


def _load() -> Library:
    """Build the library of the current sources unless it exists, and load it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libreprokernels-{_digest()}.so"
    log_path = target.with_suffix(".log")
    build_s = 0.0
    if not target.exists():
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            _compile(Path(work), target)
        build_s = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(target))
    _declare(lib)
    return Library(lib=lib, path=target, build_s=build_s, log=log)


def _run(cmds):
    """Run the commands at once; (output of each, in order).  Raises on the
    first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{out}")
    return outs


def _compile(work: Path, target: Path) -> str:
    """One `nvcc -c` per source, all at once, then one link; the library is
    moved into place only when whole, its nvcc output written beside it."""
    nvcc = _nvcc()
    cu = sorted(CSRC.glob("*.cu"))
    objs = [work / f"{src.stem}.o" for src in cu]
    logs = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(cu, objs)])
    tmp = work / "lib.so"
    logs += _run([[nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp),
                   *map(str, objs)]])
    log = "".join(logs)
    target.with_suffix(".log").write_text(log)   # before the library, which marks a build done
    os.replace(tmp, target)
    return log


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_matmul.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.repro_matmul.restype = i
    lib.repro_fused_mlp_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.repro_fused_mlp_bwd.restype = i
    lib.repro_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, i, p]
    lib.repro_flash_fwd.restype = i
    lib.repro_flash_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, i,
                                    p]
    lib.repro_flash_bwd.restype = i
    lib.repro_fused_mlp.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.repro_fused_mlp.restype = i
    lib.repro_matmul_expert.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.repro_matmul_expert.restype = i
    lib.repro_fused_mlp_expert.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.repro_fused_mlp_expert.restype = i
    lib.repro_paged_decode.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f,
                                       i, i, p]
    lib.repro_paged_decode.restype = i
    lib.repro_int8_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.repro_int8_matmul.restype = i
    lib.repro_int8_fused_mlp.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.repro_int8_fused_mlp.restype = i
    lib.repro_int8_matmul_expert.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.repro_int8_matmul_expert.restype = i
    lib.repro_fused_mlp_bwd_expert.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.repro_fused_mlp_bwd_expert.restype = i
    lib.repro_matmul_expert_tma.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.repro_matmul_expert_tma.restype = i
    lib.repro_fused_mlp_bwd_expert_tma.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                                   i, p]
    lib.repro_fused_mlp_bwd_expert_tma.restype = i
    lib.repro_ssd_chunk.argtypes = [p, p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong),
                                    i, i, i, i, i, i, i, i, i, i, i, i, ctypes.c_longlong, p]
    lib.repro_ssd_chunk.restype = i
    lib.repro_ssd_chunk_bwd.argtypes = [p] * 10 + [ctypes.POINTER(ctypes.c_longlong),
                                                   i, i, i, i, i, i, i, i, i, i, i,
                                                   ctypes.c_longlong, p, p]
    lib.repro_ssd_chunk_bwd.restype = i


def check(status: int, what: str) -> None:
    """Raise when a kernel entry point reports a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


# --- binding helpers shared by the kernel wrappers ----------------------------------

def dtype_code(dtype) -> int:
    if dtype == torch.bfloat16:
        return DT_BF16
    if dtype == torch.float32:
        return DT_F32
    raise TypeError(f"the CUDA kernels take bfloat16 or float32, got {dtype}")


def cuda_operands(what: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous operands "
                             f"(got strides {t.stride()} for shape {tuple(t.shape)})")


def aligned16(*tensors) -> bool:
    """Every base pointer 16-byte aligned (the kernels' vector loads)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


META_SMS = 132   # the H100 SXM's SMs: the launch shapes a meta trace plans for


@functools.lru_cache(maxsize=None)
def num_sms(device) -> int:
    if torch.device(device).type == "meta":
        return META_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> Optional[ctypes.c_void_p]:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def dispatch_device(what: str, t) -> str:
    """'cpu' (plain PyTorch version), 'cuda' (the kernel) or 'meta' (the
    CUDA path's shape checks, then outputs of the kernel's shapes and
    dtypes, and the kernel charged to the op counter: a dry run's trace);
    raise on any other device — there is no fallback."""
    kind = t.device.type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: no kernel for device {t.device} "
                         f"(CPU runs the plain version, CUDA the kernel, meta traces it)")
    return kind


def traced(device) -> bool:
    """True on the meta device: the launch is planned and charged, not made."""
    return torch.device(device).type == "meta"


if __name__ == "__main__":
    # Time a cold build both ways: one nvcc per source, all at once, and a
    # link (what `build` does), against one nvcc call over every source.
    #   PYTHONPATH=src python -m repro_torch.kernels._build
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        _compile(work, work / "parallel.so")
        t1 = time.perf_counter()
        _run([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(work / "single.so"),
               *map(str, sorted(CSRC.glob("*.cu")))]])
        t2 = time.perf_counter()
    print(f"cold build of {len(list(CSRC.glob('*.cu')))} sources: one nvcc per source at once "
          f"and a link {t1 - t0:.1f} s; one nvcc call over all {t2 - t1:.1f} s")
