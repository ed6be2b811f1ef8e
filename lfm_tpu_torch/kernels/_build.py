"""Build and bind the port's CUDA kernels: nvcc into one shared library with
a plain C interface, loaded with ctypes.

The library is built at first use from ``csrc/`` into
``kernels/_build/<hash of sources and flags>/`` (ignored by git). Each
``.cu`` compiles in its own nvcc process, all started together; the link
writes a temporary name that ``os.replace`` moves into place, so a build
that is killed leaves neither a lock nor a half-written library. Beside the
library, ``<source>.ptxas.txt`` keeps each source's ``ptxas -v`` report
(registers and spills per kernel; ``ptxas_usage`` reads it). Nothing here
runs at import time, and nothing here is needed on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "liblfm_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
PTXAS_SUFFIX = ".ptxas.txt"
BUILD_TIMEOUT_S = 900

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: every pointer and the stream are c_void_p, every size c_int
SIGNATURES = {
    "lfm_attention_small": [_P] * 4 + [_I] * 9 + [_P],
    "lfm_attention_small_bwd": [_P] * 8 + [_I] * 10 + [_P],
    "lfm_dit_block": [_P] * 16 + [_I] * 5 + [_P],
    "lfm_dit_block_train_fwd": [_P] * 20 + [_I] * 5 + [_P],
    "lfm_dit_block_train_mlp_bwd": [_P] * 20 + [_I] * 4 + [_P],
    "lfm_dit_block_train_attn_bwd": [_P] * 22 + [_I] * 4 + [_P],
    "lfm_flash_attention": [_P] * 4 + [_I] * 10 + [_P],
    "lfm_flash_f32_max_block": [],
    "lfm_groupnorm_silu": [_P] * 4 + [_I] * 4 + [_F, _I, _P],
    "lfm_groupnorm_silu_plan": [_I] * 6 + [_P],
    "lfm_groupnorm_silu_layout": [_P] * 4 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
    "lfm_groupnorm_silu_div_check": [_P] * 5 + [_I, _P],
    "lfm_quant_rows": [_P] * 3 + [_I] * 3 + [_P],
    "lfm_int8_gemm": [_P] * 6 + [_I] * 5 + [_P],
    "lfm_bf16_mlp": [_P] * 5 + [_I] * 3 + [_P],
    "lfm_gemm": [_P] * 8 + [_I] * 8 + [_P],
    "lfm_gemm_bwd": [_P] * 6 + [_I] * 6 + [_P],
}


class LaunchCounter:
    """Counts a wrapper's kernel launches, in all and, for the wrappers that
    take either element type (``add``), by dtype, and for the attention
    wrappers by head count (a tensor-parallel rank launches with its own
    heads); a run resets it and reads it back to show that its path went
    through the kernel."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.by_dtype = {}
        self.by_heads = {}

    def add(self, dtype, heads: Optional[int] = None) -> None:
        self.count += 1
        key = str(dtype).removeprefix("torch.")
        self.by_dtype[key] = self.by_dtype.get(key, 0) + 1
        if heads is not None:
            self.by_heads[heads] = self.by_heads.get(heads, 0) + 1


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin)")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it is already
    built for these sources; returns its path. Raises with nvcc's stderr."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        objs, procs = [], []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
            objs.append(str(obj))
        failures = []
        try:
            for src, proc in procs:
                _, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
                if proc.returncode != 0:
                    failures.append(f"{src.name}:\n{err}")
                (tmp / (src.stem + PTXAS_SUFFIX)).write_text(err)
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        lib_tmp = tmp / LIB_NAME
        res = subprocess.run([nvcc, *ARCH, "-shared", *objs, "-o", str(lib_tmp)],
                             capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stderr)
        out.parent.mkdir(parents=True, exist_ok=True)
        for log in tmp.glob("*" + PTXAS_SUFFIX):
            os.replace(log, out.parent / log.name)
        os.replace(lib_tmp, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library with its argument types declared (built on first
    call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def ptxas_usage(stem: str) -> Dict[str, Dict[str, int]]:
    """{mangled kernel name: registers, spill_stores, spill_loads (bytes)}
    from the ptxas report of ``csrc/<stem>.cu`` in the built library's
    directory."""
    text = (library_path().parent / (stem + PTXAS_SUFFIX)).read_text()
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage
