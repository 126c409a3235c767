"""Run one cell of the benchmark of ``ray_tpu_torch`` on this machine's cards.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration and traffic mix; set-up builds the program's kernels into the
checkout (or finds them built), makes the weights and inputs from the seed
and warms the cell's shapes, then the window is measured for ``--seconds``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones), ``device`` (with the card's power
limit, and with ``--trace 1`` also ``busy_s`` and ``window_s``), with
``--trace 1`` a ``breakdown``, and last ``checks``, each
number compared with the reference beside its limit; those numbers are
also the last lines of standard error.

Exits non-zero, printing no result, where the cell's cards are not there,
where ``jax``, ``jaxlib``, ``flax`` or ``ray_tpu`` is loaded once the
window has closed, or where the program is not in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_STARTED = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / ".cache"


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was loaded."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _STARTED


def _environment() -> None:
    """Caches at fixed paths inside the checkout, and no JAX pulled in by a
    library."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    setup_started = time.perf_counter() - _process_age_s()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))

    from perfbench.harness.device import forbidden_loaded, look_for_cards
    from perfbench.harness.execute import execute
    from perfbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    missing = look_for_cards(cell.chips)
    if missing:
        print(f"perfbench: {missing}; no result", file=sys.stderr)
        return 2
    import torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                     setup_started)
    loaded = forbidden_loaded()
    if loaded:
        print(f"perfbench: forbidden modules loaded: {loaded}; no result",
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
