"""Build the port's CUDA sources into shared libraries, at first use.

Each library is compiled from the checkout's own ``csrc/*.cu`` with
``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repository root
(a library of several sources: one ``nvcc`` per source, started together,
then one link),
named by a hash of its sources, the headers beside them (``csrc/*.cuh``)
and the flags, so a changed source or header is rebuilt and an unchanged
one is loaded as is.  The compiler's output (with
``ptxas``'s registers, shared memory and spills per kernel) is kept beside
the library as ``<name>-<hash>.log``.  The library exposes a plain C
interface and is loaded with ``ctypes``; nothing here includes PyTorch's
headers.  Nothing is built or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "compile_library", "find_nvcc", "load_library", "ptxas_report",
           "sass_registers"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def compile_library(sources: list[Path], out: Path) -> str:
    """Compile ``sources`` into the shared library ``out``: one ``nvcc``
    per source, all started together, then a link.  Returns the compiler's
    output (ptxas's registers and spills); raises if a step fails."""
    nvcc = find_nvcc()
    if len(sources) == 1:
        steps = [[nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), str(sources[0])]]
        objs = []
    else:
        objs = [out.with_name(f"{out.name}.{i}.o") for i in range(len(sources))]
        steps = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for o, src in zip(objs, sources)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in steps]
    texts = [proc.communicate()[0] for proc in procs]  # every process ends before any raise
    log = "".join(texts)
    for cmd, proc, text in zip(steps, procs, texts):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{text}")
    if objs:
        proc = subprocess.run([nvcc, "-shared", "-o", str(out), *map(str, objs)],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        for o in objs:
            o.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) linking {out.name}:\n{proc.stderr}")
    return log


def load_library(name: str, sources: list[Path]) -> ctypes.CDLL:
    """Compile ``sources`` (which may include the ``*.cuh`` headers beside
    them) into ``build/kernels/<name>-<hash>.so`` if that file is missing,
    and load it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted({hdr for src in sources for hdr in src.parent.glob("*.cuh")})
    for src in [*sources, *headers]:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        out.with_suffix(".log").write_text(compile_library(list(sources), tmp))
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes per kernel, by mangled name, from a build
    log (ptxas's ``-v`` lines)."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


def sass_registers(sass: str) -> dict[str, int]:
    """The registers each kernel's machine code touches, by mangled name,
    from ``cuobjdump -sass``: one past the highest register any instruction
    names, an accumulator of ``HGMMA.64xNx16.F32`` counted as the N/2
    registers it spans and a 64- or 128-bit access as 2 or 4.  Where a
    kernel raises its warps' registers with ``setmaxnreg``, this is what the
    raised branch was given, which ptxas's ``-v`` line (the launch's budget)
    does not show."""
    out: dict[str, int] = {}
    name = None
    for ln in sass.splitlines():
        m = re.search(r"Function : ([\w$]+)", ln)
        if m:
            name = m.group(1)
            out[name] = 0
            continue
        if name is None or "/*" not in ln:
            continue
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", ln)]
        if not regs:
            continue
        top = max(regs) + 1
        m = re.search(r"HGMMA\.64x(\d+)x\d+\.F32", ln)
        if m:
            top = max(top, regs[0] + int(m.group(1)) // 2)
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?(LD|ST)\w*\.(?:\w+\.)*?(64|128)\b", ln)
        if m:  # a load's first register is its data, a store's last
            top = max(top, (regs[0] if m.group(1) == "LD" else regs[-1]) + int(m.group(2)) // 32)
        out[name] = max(out[name], top)
    return out
