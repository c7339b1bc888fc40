"""The host time of ``import paddle_tpu_torch``, for one checkout or
several compared in turn.

Each run is a fresh interpreter under ``python -X importtime``; the
number kept is the cumulative microseconds of the ``paddle_tpu_torch``
line (torch's own import included). The checkouts are run interleaved,
so that a change in the host's load falls on all of them alike:

    python -m paddle_tpu_torch.tools_import_time --runs 12 OLD_DIR NEW_DIR

prints one JSON object: each directory's median, least and sorted
seconds, and the count of ``paddle_tpu_torch`` modules it loads.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys


def import_seconds(root):
    """One fresh interpreter in ``root``: (seconds, modules loaded)."""
    code = ("import sys, paddle_tpu_torch; print(sum(m.split('.')[0] == "
            "'paddle_tpu_torch' for m in sys.modules))")
    out = subprocess.run([sys.executable, "-X", "importtime", "-c", code],
                         cwd=root, capture_output=True, text=True, check=True)
    line = [ln for ln in out.stderr.splitlines()
            if ln.rstrip().endswith("| paddle_tpu_torch")][-1]
    return int(line.split("|")[1]) / 1e6, int(out.stdout.strip())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--runs", type=int, default=12)
    args = ap.parse_args(argv)
    secs = {r: [] for r in args.roots}
    mods = {}
    for _ in range(args.runs):
        for r in args.roots:
            s, mods[r] = import_seconds(os.path.abspath(r))
            secs[r].append(s)
    print(json.dumps({r: {"median_s": statistics.median(v), "min_s": min(v),
                          "seconds": sorted(v), "modules": mods[r]}
                      for r, v in secs.items()}))


if __name__ == "__main__":
    main()
