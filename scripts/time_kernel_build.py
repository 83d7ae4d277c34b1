"""Wall time of each ``nvcc`` that builds a source tree's kernels, started
all together as ``hnsw_nsg_tpu_torch/ops/_build.py`` starts them, on a
machine with the CUDA toolkit.

    python3 scripts/time_kernel_build.py [--tree DIR] [--ptxas]

``--tree`` is the root of a checkout of this repository (default: the one
this script is in); its ``hnsw_nsg_tpu_torch/csrc/*.cu`` are compiled with
the tree's own ``_build.NVCC_FLAGS`` and linked into the library its
``_build.load_library`` looks for, so that a later run of the tree loads
it without a build. Prints one JSON line per source (its seconds from the
common start) and one for the longest. ``--ptxas`` adds ``-Xptxas -v``
(which changes no code) and prints each kernel's registers, spills and
static shared memory, one JSON line a kernel.
"""

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def ptxas_lines(log: str):
    """(kernel, registers, spill stores, spill loads, static smem) from
    ``-Xptxas -v`` output, names demangled where c++filt is found."""
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append([name, int(m.group(1)), *spill,
                        int(m.group(2) or 0)])
            name, spill = None, (0, 0)
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(o[0] for o in out),
                               capture_output=True, text=True).stdout
        for o, n in zip(out, names.splitlines()):
            o[0] = n
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "tree_build", Path(args.tree) / "hnsw_nsg_tpu_torch" / "ops"
        / "_build.py")
    _build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(_build)

    srcs = _build._sources()
    flags = [*_build.NVCC_FLAGS, *(["-Xptxas", "-v"] if args.ptxas else [])]
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        t0 = time.perf_counter()
        for src in srcs:
            log = Path(tmp) / f"{src.stem}.log"
            with open(log, "w") as out:
                procs[src.name] = (log, subprocess.Popen(
                    [_build._nvcc(), *flags, "-c", "-o",
                     str(Path(tmp) / f"{src.stem}.o"), str(src)],
                    stdout=out, stderr=subprocess.STDOUT))
        seconds = {}
        while len(seconds) < len(procs):
            for name, (_, proc) in procs.items():
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.perf_counter() - t0
            time.sleep(0.05)
        for name, (log, proc) in procs.items():
            text = log.read_text()
            print(json.dumps(dict(tree=args.tree, source=name,
                                  seconds=seconds[name], rc=proc.returncode)))
            if proc.returncode != 0:
                print(text, file=sys.stderr)
            if args.ptxas:
                for kern, regs, st, ld, smem in ptxas_lines(text):
                    print(json.dumps(dict(source=name, kernel=kern[:160],
                                          registers=regs, spill_stores=st,
                                          spill_loads=ld, smem=smem)))
        failed = [n for n, (_, p) in procs.items() if p.returncode != 0]
        print(json.dumps(dict(tree=args.tree, longest=max(seconds.values()),
                              failed=failed)))
        if failed:
            raise SystemExit(1)
        so = _build.library_path()
        so.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(so), *(str(Path(tmp) / f"{s.stem}.o")
                                   for s in srcs)], check=True)


if __name__ == "__main__":
    main()
