"""One rank of the 2-process ``torch.distributed`` groups of
tests/test_torch_dist.py and tests/test_torch_dist_e2e.py, on the CPU (gloo):

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_dist_worker.py <mode> <json config>

``train``: the row-sharded trainers on the inputs of ``cfg["inputs"]`` (an
npz), each rank on its ``host_row_range`` rows on ``cfg["device"]`` (default
the CPU; ``cuda``: the rank's card), every case also with ``_all_reduce``
swapped for the identity; rank 0 writes ``cfg["out"]``.
``exchange2``: two exchanges with the same tag into one directory.
``linger``: 50 all-reduces, then rank 0 stays ``cfg["linger_s"]`` seconds
(as the train CLI's rank 0 writes its files) while the other rank exits.
"""

import json
import sys

import numpy as np


def train(cfg: dict) -> None:
    from expecto_tpu_torch.models import gblinear
    from expecto_tpu_torch.ops import gblinear_cd
    from expecto_tpu_torch.parallel import dist
    from expecto_tpu_torch.parallel.mesh import local_device

    inp = np.load(cfg["inputs"])
    X, y1, Y8, rw8 = inp["X"], inp["y1"], inp["Y8"], inp["rw8"]
    lo, hi = dist.host_row_range(X.shape[0])
    hp = gblinear.GBLinearParams(num_round=int(cfg["num_round"]), block_size=int(cfg["block_size"]),
                                 reg_alpha=float(cfg["alpha"]))
    evals = [(inp["Xe"], inp["ye"], "eval"), (X, y1, "train")]
    device = local_device(cfg.get("device", "cpu"))
    real = gblinear._all_reduce
    calls = {}

    def counted(t):
        calls["n"] += 1
        return real(t)

    out = {}
    for fault, reduce in (("", counted), ("identity_", lambda t: t)):
        gblinear._all_reduce = reduce
        try:
            calls["n"] = 0
            gblinear_cd.reset_launch_counts()
            k1 = gblinear.train_gblinear_sharded(X[lo:hi], y1[lo:hi], hp, evals=evals, device=device)
            if not fault:
                out["k1_calls"], out["k1_launches"] = calls["n"], gblinear_cd.coord_update.launches
            k8 = gblinear.train_gblinear_multi_sharded(X[lo:hi], Y8[lo:hi], hp, row_weights_local=rw8[lo:hi],
                                                        device=device)
        finally:
            gblinear._all_reduce = real
        out[f"{fault}k1_w"], out[f"{fault}k1_b"] = k1.weight, np.float64(k1.bias)
        for name, hist in k1.eval_history.items():
            out[f"{fault}k1_hist_{name}"] = np.asarray(hist)
        out[f"{fault}k8_w"], out[f"{fault}k8_b"] = k8.weights, k8.biases
    if dist.is_primary():
        np.savez(cfg["out"], **out)


def exchange2(cfg: dict) -> None:
    """Two back-to-back exchanges with the same tag into the same directory:
    the sequence-stamped shard names keep the second call's writes clear of
    the primary's deletion of the first call's shards."""
    from expecto_tpu_torch.parallel import dist

    n = int(cfg["n"])
    lo, hi = dist.host_row_range(n)
    rows = np.arange(n, dtype=np.float64)
    m1 = dist.exchange_row_blocks({"x": rows[lo:hi] * 2.0}, cfg["dir"], "reused_tag")
    m2 = dist.exchange_row_blocks({"x": rows[lo:hi] * 3.0}, cfg["dir"], "reused_tag")
    if not (np.array_equal(m1["x"], rows * 2.0) and np.array_equal(m2["x"], rows * 3.0)):
        raise AssertionError("an exchange returned other rows")
    dist.barrier("exchange2.done")
    if dist.is_primary():
        np.savez(cfg["out"], x1=m1["x"], x2=m2["x"])


def linger(cfg: dict) -> None:
    """Rank 1 leaves the group's last collective for interpreter exit while
    rank 0 still runs."""
    import time

    import torch
    import torch.distributed

    t = torch.ones(1000)
    for _ in range(50):
        torch.distributed.all_reduce(t)
    if torch.distributed.get_rank() == 0:
        time.sleep(float(cfg.get("linger_s", 0.5)))


def main() -> int:
    from expecto_tpu_torch.parallel.mesh import maybe_initialize_distributed

    mode, cfg = sys.argv[1], json.loads(sys.argv[2])
    maybe_initialize_distributed(cfg.get("device", "cpu"))
    {"train": train, "exchange2": exchange2, "linger": linger}[mode](cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
