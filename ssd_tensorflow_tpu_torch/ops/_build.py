"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
its own (with the shared ``csrc/*.cuh`` headers it includes) into
``_build/lib<name>-<hash>.so`` (the directory is listed in
``.gitignore``) at first use, for ``sm_90a`` at ``-O3`` and without
``--use_fast_math``: the NMS kernel must divide in IEEE round-to-nearest
to match the plain version bit for bit. All sources compile in parallel,
one ``nvcc`` each; a library whose source hash is already built is
reused. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("nms", "stem", "stem_uint8", "stem_probe", "int8_conv", "group_norm")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build csrc/")


def _target(name: str) -> Path:
    digest = hashlib.sha1()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


@functools.cache
def libraries() -> dict:
    """Build (in parallel) and load every kernel library: name -> CDLL."""
    BUILD_DIR.mkdir(exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    jobs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in jobs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: ctypes.CDLL(str(target)) for name, target in targets.items()}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the last
    build of ``csrc/<name>.cu`` in this checkout, or '' if none."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def check(rc: int, what: str) -> None:
    """Raise when a launch function returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
