#!/usr/bin/env python3
"""Seconds ``nvcc`` takes on each hand-kernel source of one or more trees,
on the machine that runs it (the build that ``kernels/_build.py`` makes at a
kernel's first launch).

    python3 scripts/build_times.py [--src DIR] [--src DIR ...]

Each ``--src`` is a ``src`` directory holding a ``repro_torch`` (default:
this checkout's); give two commits' trees in the order parent, this, this,
parent to read the spread.  For each tree, in turn, every source of its
``_build.SOURCES`` is compiled with its own ``NVCC_FLAGS``, all at once as
``_build.load`` starts them, into a fresh directory under ``build/`` that is
removed after; only that tree's ``_build.py`` is loaded, by path, so no
package and no torch is imported.  One ``build_times`` JSON line a tree:
each source's seconds from the start to its own end, and the whole build's.
"""
import argparse
import importlib.util
import json
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def tree_build(src: str):
    """The ``_build`` module of the tree under ``src``, loaded by path."""
    path = Path(src).resolve() / "repro_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_seconds(src: str) -> dict:
    b = tree_build(src)
    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="build_times_", dir=ROOT / "build"))
    seconds, logs = {}, {}
    try:
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen([b.nvcc(), *b.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(b.CSRC / f"{name}.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for name in b.SOURCES}

        def wait(name, proc):
            logs[name] = proc.communicate()[0]
            seconds[name] = time.perf_counter() - t0

        waiters = [threading.Thread(target=wait, args=item) for item in procs.items()]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        failed = {name: logs[name][-2000:] for name, proc in procs.items() if proc.returncode != 0}
        if failed:
            raise RuntimeError(f"nvcc failed in {src}: {failed}")
        return {"src": src, "seconds": seconds, "total_s": time.perf_counter() - t0}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", help="a tree's src directory (repeatable; default: this checkout's)")
    args = ap.parse_args()
    for src in args.src or [str(ROOT / "src")]:
        print("build_times " + json.dumps(build_seconds(src)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
