"""What every hand-written kernel needs around it: build, bind, count.

The CUDA C++ kernels live in ``csrc/<name>.cu``.  Each source exports plain C
entry points (pointers and the stream as ``void*``, sizes as ``int``) that
return ``cudaGetLastError()`` after the launch.  This module compiles a
source with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch/`` at the repository root, loads it with ``ctypes``, and
declares the argument types of its functions.  A library is named by a hash
of its source, every header in ``csrc/`` and the flags, so an edited source
or header is rebuilt and an unchanged one is loaded as it is.  The build runs at first use, once per process, under a
lock: several broker manager threads may reach a kernel at the same moment.

Nothing here runs at import time: the CPU tests import every kernel module,
so this module must import where no CUDA toolkit is installed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = (
    "flash_attention", "moe_gmm", "rglru_scan", "selective_scan",
    "flash_attention_bwd", "flash_attention_bwd_wgmma", "flash_attention_bwd_tf32x3", "rglru_scan_bwd", "moe_gmm_bwd",
    "selective_scan_bwd",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, stack and spills, kept in BUILD_LOGS
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
BUILD_LOGS: dict[str, str] = {}  # source -> the compiler's output, for sources built by this process
BUILD_SECONDS: dict[str, float] = {}  # source -> seconds its nvcc ran, for sources built by this process


class LaunchCounter:
    """Thread-safe count of one kernel's launches.  A wrapper bumps it where
    it launches its kernel and nowhere else, so a run can show that its main
    path went through the kernel and not through the plain version."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def bump(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "only where the CUDA toolkit is installed"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: named by a hash of the
    source, of every header a source may include (``csrc/*.cuh``) and of the
    flags, include paths among them."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def load(*names: str) -> list[ctypes.CDLL]:
    """Build the named sources where their library is missing, one ``nvcc``
    per source, all started together, then load them.  Each build's
    seconds, from the start to its own end, go to BUILD_SECONDS."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        procs, t0, logs = [], time.perf_counter(), {}
        for name in todo:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append((name, out, tmp, proc))

        def wait(name, proc):  # a thread a build: each pipe drained as it fills, each end timed
            logs[name] = proc.communicate()[0]
            BUILD_SECONDS[name] = time.perf_counter() - t0

        waiters = [threading.Thread(target=wait, args=(name, proc)) for name, _, _, proc in procs]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        errors = []
        for name, out, tmp, proc in procs:
            log = logs[name]
            if proc.returncode != 0:
                errors.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
            else:
                BUILD_LOGS[name] = log
                os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in todo:
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return [_LIBS[n] for n in names]


def function(source: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """A C entry point of ``csrc/<source>.cu`` with its argument and return
    types declared (``c_void_p`` for every pointer and the stream: left
    undeclared, ctypes would pass a pointer as a 32-bit int and cut it)."""
    key = (source, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        (lib,) = load(source)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _FUNCS[key] = fn
    return fn


def kernel_label(mangled: str) -> str:
    """``name<args>`` of a kernel in an anonymous namespace, or in a namespace
    nested in one, from its mangled symbol (``..._cu_<8 hex>[<len><ns>...]
    <len><name>I<Li<n>E...>E...``): the last name, else the symbol."""
    m = re.search(r"_cu_[0-9a-f]{8}", mangled)
    if not m:
        return mangled
    pos, name = m.end(), None
    while (n := re.match(r"\d+", mangled[pos:])) is not None:
        start = pos + n.end()
        name, pos = mangled[start:start + int(n.group())], start + int(n.group())
    if name is None:
        return mangled
    args = re.match(r"I((?:Li\d+E)+)E", mangled[pos:])
    return f"{name}<{','.join(re.findall(r'Li(\d+)E', args.group(1)))}>" if args else name


def ptxas_usage(log: str) -> list[dict]:
    """Per kernel, from ``-Xptxas -v`` output: its name (``kernel_label``),
    registers a thread, stack frame and spill bytes, and its static shared
    memory where it has any (dynamic shared memory is the launch's)."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": kernel_label(m.group(1))}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem"] = int(m.group(1))
    return rows


def check_aligned(kernel: str, *tensors) -> None:
    """Raise unless every operand starts on a 16-byte boundary, as TMA and
    the scans' 16-byte cp.async chunks need."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{kernel} kernel: operands must start on 16-byte boundaries")


def check(source: str, code: int) -> None:
    """Raise if a launch returned a CUDA error: a refused launch (too many
    threads, too much shared memory) never runs, and no later synchronize
    reports it."""
    if code != 0:
        describe = function(source, f"{source}_error_string", [ctypes.c_int], ctypes.c_char_p)
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {code} ({describe(code).decode()})")
