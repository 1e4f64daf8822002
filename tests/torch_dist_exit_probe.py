"""How often a 2-rank gloo group fails at interpreter exit: runs the
``linger`` group of tests/torch_dist_worker.py (rank 0 stays on after the
last collective while rank 1 exits) ``--runs`` times, ``--parallel`` groups
at once, against the ``expecto_tpu_torch`` of ``--tree`` (a checkout of
this repository; default this one), and prints one JSON line: the groups
that failed and those in which a rank aborted ("terminate called without
an active exception", SIGABRT)::

    python tests/torch_dist_exit_probe.py [--tree CHECKOUT] [--runs 100] [--parallel 4]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))


def run_group(tree: str) -> tuple[int, str]:
    env = {**os.environ, "PYTHONPATH": tree, "OMP_NUM_THREADS": "1"}
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                          os.path.join(HERE, "torch_dist_worker.py"), "linger", json.dumps({"linger_s": 0.5})],
                         cwd=tree, env=env, capture_output=True, text=True, timeout=180)
    return res.returncode, res.stderr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(HERE))
    ap.add_argument("--runs", type=int, default=100)
    ap.add_argument("--parallel", type=int, default=4)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    with ThreadPoolExecutor(args.parallel) as pool:
        results = list(pool.map(lambda _i: run_group(tree), range(args.runs)))
    failed = sum(rc != 0 for rc, _err in results)
    aborted = sum("terminate called without an active exception" in err for _rc, err in results)
    print(json.dumps({"tree": tree, "runs": args.runs, "failed": failed, "aborted": aborted}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
