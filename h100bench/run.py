"""Run one cell of the port's benchmark once and print its result.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cells; each
cell's configuration, traffic mix and limits, and each metric's reader,
are files under ``h100bench/`` found by name (``benchlib/registry.py``).
The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last: each number compared beside its
limit, which the last lines on standard error repeat). A run without a
CUDA card, or with fewer cards than the cell asks for, exits 2 and prints
no result; one that loaded JAX or the JAX package exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".h100bench_cache"


def _fixed_caches():
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds (the port's nvcc libraries already
    live in its own ``_build/`` there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from benchlib import harness, nojax, registry

    cell = registry.cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START, cell)
    bad = nojax.forbidden(sys.modules)
    if bad:
        print(f"h100bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line = json.dumps(result)
    for text in harness.check_lines(result):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
