"""Build a CUDA source of this package into a shared library with ``nvcc``.

Each kernel module (``fork_compact.py``, ``epoch_megakernel.py``,
``flash_attention.py``, ``decode_attention.py``, ``ssd_scan.py``) compiles
its source under ``csrc/`` for ``sm_90a`` into a library with a plain C
interface, at first use, into ``build/`` beside this file (listed in
``.gitignore``), and loads it with ``ctypes``.  The library's name carries
a hash of the source and the flags, so an edited ``.cu`` file builds anew.
Nothing here compiles at import time.

    python3 src/repro_torch/kernels/nvcc.py SOURCE [SOURCE ...]

times one build of each source with these flags, in turn, and prints
``ptxas``'s report of each kernel (registers, spills): two versions of a
source side by side in one call.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import time
from typing import Tuple

BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = os.path.join(root, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the built library for ``source`` and the flags lives."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: pathlib.Path,
          ptxas_info: bool = False) -> Tuple[pathlib.Path, str]:
    """Compile ``source`` unless the library for it exists.

    Returns ``(library path, compiler output)``; ``ptxas_info`` asks
    ``ptxas`` for each kernel's registers, shared memory and spills (and
    rebuilds to get them).
    """
    out = library_path(source)
    if out.exists() and not ptxas_info:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    if ptxas_info:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, proc.stdout + proc.stderr


def main(argv=None) -> int:
    sources = sys.argv[1:] if argv is None else argv
    if not sources:
        print(__doc__)
        return 2
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for src in sources:
        out = BUILD_DIR / f"timed_{os.getpid()}.so"
        cmd = [nvcc_path(), "-Xptxas", "-v", *NVCC_FLAGS, "-o", str(out), src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        out.unlink(missing_ok=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            print(f"[nvcc] {src}: failed ({proc.returncode})\n{log}")
            return 1
        print(f"[nvcc] {src}: built in {secs:.2f} s")
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                print(f"[nvcc]   {line.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
