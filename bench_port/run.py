#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port (``rspc_tpu_torch``).

    python3 bench_port/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` once on the CUDA card of this
machine, from the root of a checkout (``harness.py`` says how), and
prints its result as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; then ``checks``, each compared number with its limit,
which also close standard error. Exits 2 without the cards the cell
asks for, 1 on any other failure, printing no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

# caches of compilers the port may use, at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "bench_port_cache" / sub))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from bench_port import harness

    try:
        return harness.main(args, T0)
    except harness.NoDevice as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
