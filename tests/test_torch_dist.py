"""The port's multi-process layer against the JAX package's: row ranges,
shard names and merges on the same files (in process), the backend and
device rule, the row-sharded gblinear trainers over a real 2-rank gloo
group on the CPU against the JAX sharded trainers on the 8-device CPU mesh
and against the port's single-process trainer, and the training CLI as a
2-rank torchrun group against its 1-process run."""

import json
import os

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from expecto_tpu.models import gblinear as jax_gb
from expecto_tpu.parallel import dist as jax_dist
from expecto_tpu_torch.io.xgb import load_xgb07_binary
from expecto_tpu_torch.models import gblinear as torch_gb
from expecto_tpu_torch.parallel import dist, mesh
from torch_port_common import DIST_WORKER, single_torch_thread, torchrun  # noqa: F401 (autouse fixture)


# --- row ranges, shard names, merges: the same calls on the same files ---


@pytest.mark.parametrize("n,w", [(103, 8), (10, 1), (5, 8), (0, 3), (24, 4)])
def test_host_row_range_and_shard_path_match_jax(n, w):
    for r in range(w):
        assert dist.host_row_range(n, r, w) == jax_dist.host_row_range(n, r, w)
        assert dist.shard_path("/x/out.h5", r, w) == jax_dist.shard_path("/x/out.h5", r, w)
    ranges = [dist.host_row_range(n, r, w) for r in range(w)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_one_process_without_a_group(tmp_path):
    assert dist.process_info() == (0, 1) and dist.is_primary()
    assert dist.host_row_range(7) == (0, 7) and dist.shard_path("a.npy") == "a.npy"
    dist.barrier("no-op")
    arrays = {"x": np.arange(3.0)}
    assert dist.exchange_row_blocks(arrays, str(tmp_path), "t") is arrays
    assert not os.listdir(tmp_path)


def _write_shards(root, kind: str, n: int = 11, w: int = 3):
    """Shard files of one logical output under ``root``: returns its path."""
    full = np.arange(n * 4, dtype=np.float32).reshape(n, 4) * 0.5
    ids = np.array([f"row{i}".encode() for i in range(n)])
    path = os.path.join(root, {"h5": "out.h5", "h5_fold2": "shift.h5", "npy": "feats.npy"}.get(kind, "t.csv"))
    for r in range(w):
        a, b = dist.host_row_range(n, r, w)
        sp = dist.shard_path(path, r, w)
        if kind == "h5":
            with h5py.File(sp, "w") as f:
                f.create_dataset("data", data=full[a:b])
                f.create_dataset("ids", data=ids[a:b])
        elif kind == "h5_fold2":
            with h5py.File(sp, "w") as f:
                f.create_dataset("diff", data=np.concatenate([full[a:b], -full[a:b]]))
        elif kind == "npy":
            np.save(sp, full[a:b])
        else:
            with open(sp, "w") as f:
                f.write("genes,ref_preds\n" + "".join(f"G{i},{full[i, 0]!r}\n" for i in range(a, b)))
    return path


@pytest.mark.parametrize("kind", ["h5", "h5_fold2", "npy", "csv", "csv_no_header"])
def test_merges_match_jax(tmp_path, kind):
    merged = {}
    for tag, mod in (("port", dist), ("jax", jax_dist)):
        root = tmp_path / tag
        root.mkdir()
        path = _write_shards(str(root), kind)
        assert [os.path.basename(p) for p in mod.list_shards(path)] == [
            os.path.basename(p) for p in jax_dist.list_shards(path)]
        if kind.startswith("h5"):
            mod.merge_sharded_h5(path, delete_shards=True, fold_axis0=2 if kind == "h5_fold2" else 1)
            with h5py.File(path) as f:
                merged[tag] = {k: f[k][...] for k in f}
        elif kind == "npy":
            mod.merge_sharded_npy(path, delete_shards=True)
            merged[tag] = {"x": np.load(path)}
        else:
            mod.merge_sharded_csv(path, delete_shards=True, header=kind == "csv")
            merged[tag] = {"text": open(path).read()}
        assert mod.list_shards(path) == [path]  # shards deleted, the merged file stands
    for k, v in merged["jax"].items():
        np.testing.assert_array_equal(merged["port"][k], v)
    if kind == "h5_fold2":  # [fwd of every shard; rc of every shard], as one process writes it
        full = np.arange(44, dtype=np.float32).reshape(11, 4) * 0.5
        np.testing.assert_array_equal(merged["port"]["diff"], np.concatenate([full, -full]))


def _case_missing_shard(root):
    path = os.path.join(root, "x.h5")
    with h5py.File(dist.shard_path(path, 0, 3), "w") as f:
        f.create_dataset("d", data=np.zeros(2))
    return path, {}


def _case_mixed_worlds(root):
    path = os.path.join(root, "y.h5")
    for r, w in [(0, 2), (1, 2), (0, 4), (1, 4)]:
        with h5py.File(dist.shard_path(path, r, w), "w") as f:
            f.create_dataset("d", data=np.zeros(1))
    return path, {}


def _case_odd_fold(root):
    path = os.path.join(root, "odd.h5")
    for r in range(2):
        with h5py.File(dist.shard_path(path, r, 2), "w") as f:
            f.create_dataset("d", data=np.zeros((3, 2)))
    return path, {"fold_axis0": 2}


def _case_missing_dataset(root):
    path = os.path.join(root, "md.h5")
    with h5py.File(dist.shard_path(path, 0, 2), "w") as f:
        f.create_dataset("a", data=np.zeros((2, 2)))
        f.create_dataset("b", data=np.zeros((2, 2)))
    with h5py.File(dist.shard_path(path, 1, 2), "w") as f:
        f.create_dataset("a", data=np.zeros((2, 2)))
    return path, {}


def _case_dtype_mismatch(root):
    path = os.path.join(root, "z.h5")
    for r, dt in [(0, np.float16), (1, np.float32)]:
        with h5py.File(dist.shard_path(path, r, 2), "w") as f:
            f.create_dataset("d", data=np.zeros((2, 3), dt))
    return path, {}


def _case_trailing_shape(root):
    path = os.path.join(root, "ts.h5")
    for r, cols in [(0, 3), (1, 4)]:
        with h5py.File(dist.shard_path(path, r, 2), "w") as f:
            f.create_dataset("d", data=np.zeros((2, cols), np.float32))
    return path, {}


@pytest.mark.parametrize("case,match", [
    (_case_missing_shard, "expected shards"),
    (_case_mixed_worlds, "mixed shard sets"),
    (_case_odd_fold, "not divisible by fold"),
    (_case_missing_dataset, "missing from some shards"),
    (_case_dtype_mismatch, "dtype mismatch"),
    (_case_trailing_shape, "trailing shape mismatch"),
])
def test_merge_errors_match_jax(tmp_path, case, match):
    for tag, mod in (("port", dist), ("jax", jax_dist)):
        root = tmp_path / tag
        root.mkdir()
        path, kw = case(str(root))
        with pytest.raises(AssertionError, match=match) as err:
            mod.merge_sharded_h5(path, **kw)
        if tag == "port":
            port_msg = str(err.value).replace(str(tmp_path / "port"), "")
        else:
            assert port_msg == str(err.value).replace(str(tmp_path / "jax"), "")


def test_fresh_shards_supersede_a_stale_merged_file(tmp_path):
    path = str(tmp_path / "out.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=np.zeros((5, 4), np.float32))  # a previous run's merged file
    _write_shards(str(tmp_path), "h5")
    assert len(dist.list_shards(path)) == 3
    dist.merge_sharded_h5(path, delete_shards=True)
    with h5py.File(path) as f:
        np.testing.assert_array_equal(f["data"], np.arange(44, dtype=np.float32).reshape(11, 4) * 0.5)
    with pytest.raises(FileNotFoundError):
        dist.merge_sharded_npy(str(tmp_path / "absent.npy"))


@pytest.mark.parametrize("parts,n,match", [
    ([(0, 2), (2, 3), (5, 1)], 6, None),
    ([(3, 3), (0, 3)], 6, None),
    ([(0, 2), (3, 3)], 6, "tile contiguously"),
    ([(0, 3), (2, 4)], 6, "tile contiguously"),
    ([(0, 2), (2, 2)], 6, "assembled 4 rows"),
])
def test_assemble_rows_matches_jax(parts, n, match):
    full = np.arange(n * 2, dtype=np.float64).reshape(n, 2)
    blocks = [(s, full[s : s + k]) for s, k in parts]
    if match is None:
        np.testing.assert_array_equal(dist.assemble_rows(blocks, n), jax_dist.assemble_rows(blocks, n))
        np.testing.assert_array_equal(dist.assemble_rows(blocks, n), full)
    else:
        for mod in (dist, jax_dist):
            with pytest.raises(AssertionError, match=match):
                mod.assemble_rows(blocks, n)


# --- the backend and device rule ---


@pytest.mark.parametrize("device_type,local_ranks,cards,backend", [
    ("cpu", 2, 0, "gloo"), ("cpu", 1, 8, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 8, 8, "nccl"),
    ("cuda", 2, 8, "nccl"), ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo"),
])
def test_backend_rule(device_type, local_ranks, cards, backend):
    assert mesh.choose_backend(device_type, local_ranks, cards) == backend


@pytest.mark.parametrize("device,local_rank,cards,want", [
    ("cpu", 3, 2, "cpu"), ("cuda", 0, 1, "cuda:0"), ("cuda", 1, 1, "cuda:0"), ("cuda", 5, 4, "cuda:1"),
    ("cuda", 3, 8, "cuda:3"), ("cuda:2", 0, 8, "cuda:2"),
])
def test_device_rule(device, local_rank, cards, want):
    assert mesh.rank_device(torch.device(device), local_rank, cards) == torch.device(want)


def test_no_card_raises_and_one_rank_joins_no_group(monkeypatch):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mesh.choose_backend("cuda", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mesh.rank_device(torch.device("cuda"), 0, 0)
    with pytest.raises(ValueError, match="backend"):
        mesh.choose_backend("mps", 1, 0)
    for world in (None, "1"):
        if world is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", world)
        mesh.maybe_initialize_distributed("cpu")
        assert not torch.distributed.is_initialized()
    assert mesh.local_device("cpu") == torch.device("cpu")
    x, n = mesh.pad_to_multiple(np.ones((5, 2)), 4)
    assert x.shape == (8, 2) and n == 5 and not x[5:].any()


# --- the row-sharded trainers over a real 2-rank gloo group ---

N_ROWS, N_FEAT, N_EVAL, K, ROUNDS, BLOCK, ALPHA = 150, 700, 40, 8, 6, 256, 0.5


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """Seeded inputs; the 2-rank group's results (sound and with the identity
    all-reduce); the JAX sharded trainers' and the port's single-process
    trainers' on the full rows."""
    rng = np.random.default_rng(17)
    X = rng.standard_normal((N_ROWS, N_FEAT)).astype(np.float32)
    w_true = (rng.standard_normal(N_FEAT) * (rng.random(N_FEAT) < 0.1)).astype(np.float32)
    y1 = (X @ w_true * 0.3 + 2.5 + 0.1 * rng.standard_normal(N_ROWS)).astype(np.float32)
    Y8 = (y1[:, None] + 0.2 * rng.standard_normal((N_ROWS, K))).astype(np.float32)
    rw8 = torch_gb.bootstrap_row_weights(N_ROWS, list(range(K)))
    Xe = rng.standard_normal((N_EVAL, N_FEAT)).astype(np.float32)
    ye = (Xe @ w_true * 0.3 + 2.5).astype(np.float32)
    d = tmp_path_factory.mktemp("sharded")
    np.savez(d / "inputs.npz", X=X, y1=y1, Y8=Y8, rw8=rw8, Xe=Xe, ye=ye)
    cfg = {"inputs": str(d / "inputs.npz"), "out": str(d / "out.npz"), "num_round": ROUNDS, "block_size": BLOCK,
           "alpha": ALPHA}
    torchrun([DIST_WORKER, "train", json.dumps(cfg)])
    group = dict(np.load(d / "out.npz"))

    jhp = jax_gb.GBLinearParams(num_round=ROUNDS, block_size=BLOCK, reg_alpha=ALPHA)
    evals = [(Xe, ye, "eval"), (X, y1, "train")]
    jk1 = jax_gb.train_gblinear_sharded(X, y1, jhp, evals=evals)
    jk8 = jax_gb.train_gblinear_multi_sharded(X, Y8, jhp, row_weights_local=rw8)
    thp = torch_gb.GBLinearParams(num_round=ROUNDS, block_size=BLOCK, reg_alpha=ALPHA)
    tk1 = torch_gb.train_gblinear_multi(X, y1, thp, device="cpu")
    tk8 = torch_gb.train_gblinear_multi(X, Y8, thp, row_weights=rw8, device="cpu")
    refs = {
        "jax": {"k1": (jk1.weight, jk1.bias, jk1.eval_history), "k8": (jk8.weights, jk8.biases, None)},
        "port": {"k1": (tk1.weights[:, 0], tk1.biases[0], None), "k8": (tk8.weights, tk8.biases, None)},
    }
    return group, refs, (X, y1, Y8, rw8, evals, thp)


def _gaps(group: dict, prefix: str, case: str, ref) -> dict:
    """max |w - w_ref| over 1e-5 max|w_ref|, |b - b_ref| over 1e-6 and the
    watchlist's max gap over 1e-5: the check holds when all are <= 1."""
    w, b, hist = ref
    out = {"w": float(np.abs(group[f"{prefix}{case}_w"] - w).max()) / (1e-5 * float(np.abs(w).max())),
           "b": float(np.abs(group[f"{prefix}{case}_b"] - b).max()) / 1e-6}
    if hist is not None:
        out["hist"] = max(float(np.abs(group[f"{prefix}{case}_hist_{k}"] - np.asarray(v)).max())
                          for k, v in hist.items()) / 1e-5
    return out


@pytest.mark.parametrize("case", ["k1", "k8"])
@pytest.mark.parametrize("against", ["jax", "port"])
def test_two_rank_trainer_matches_the_reference_and_the_identity_fault_does_not(sharded_runs, case, against):
    group, refs, _inputs = sharded_runs
    ref = refs[against][case]
    assert np.abs(ref[0]).max() > 1e-3  # the fit is not degenerate
    sound = _gaps(group, "", case, ref)
    assert max(sound.values()) <= 1.0, sound
    planted = _gaps(group, "identity_", case, ref)
    assert max(planted.values()) > 1.0, planted


def test_two_rank_trainer_counts_its_all_reduces(sharded_runs):
    group, _refs, _inputs = sharded_runs
    n_blocks = -(-N_FEAT // BLOCK)
    assert int(group["k1_calls"]) == 3 + ROUNDS * (1 + n_blocks)
    assert group["k1_hist_eval"].shape == group["k1_hist_train"].shape == (ROUNDS,)


def test_one_process_sharded_trainer_equals_the_multi_trainer_bit_for_bit(sharded_runs):
    _group, _refs, (X, y1, Y8, rw8, evals, thp) = sharded_runs
    got = torch_gb.train_gblinear_multi_sharded(X, Y8, thp, row_weights_local=rw8, device="cpu")
    want = torch_gb.train_gblinear_multi(X, Y8, thp, row_weights=rw8, device="cpu")
    np.testing.assert_array_equal(got.weights, want.weights)
    np.testing.assert_array_equal(got.biases, want.biases)
    k1 = torch_gb.train_gblinear_sharded(X, y1, thp, evals=evals, device="cpu")
    single = torch_gb.train_gblinear(X, y1, thp, evals=evals, device="cpu")
    assert np.abs(k1.weight - single.weight).max() <= 1e-5 * np.abs(single.weight).max()
    for name, hist in single.eval_history.items():
        np.testing.assert_allclose(k1.eval_history[name], hist, rtol=0, atol=1e-5)


# --- the training CLI as a 2-rank group ---


@pytest.fixture(scope="module")
def train_files(tmp_path_factory):
    rng = np.random.default_rng(11)
    n, f = 240, 400
    X = rng.normal(size=(n, f)).astype(np.float32)
    w_true = rng.normal(size=(f, 2)).astype(np.float32) * 0.05
    expr = np.exp(X @ w_true + 2.0)
    d = tmp_path_factory.mktemp("train")
    np.save(d / "X.npy", X)
    pd.DataFrame({"id": [f"G{i}" for i in range(n)], "seqnames": np.where(np.arange(n) % 4 == 0, "chr8", "chr2"),
                  "type": ["protein_coding"] * n}).to_csv(d / "anno.csv", index=False)
    pd.DataFrame({"gene": [f"G{i}" for i in range(n)], "tissueA": expr[:, 0], "tissueB": expr[:, 1]}).to_csv(
        d / "exp.csv", index=False)
    return ["--inputFile", str(d / "X.npy"), "--annoFile", str(d / "anno.csv"), "--expFile", str(d / "exp.csv"),
            "--num_round", "20", "--device", "cpu"]


@pytest.mark.parametrize("mode", ["single", "bootstrap", "all_vectorized"])
def test_train_cli(train_files, tmp_path, mode):
    """Rank 0's model files (and --evalFile, metrics.h5) against the
    1-process run within the JAX e2e bounds (weights 1e-5 of max|w|, biases
    1e-6, predictions 1e-4): the gradient sums are all-reduced in another
    order."""
    from expecto_tpu_torch.cli.train import main

    flags = {"single": ["--targetIndex", "1"], "bootstrap": ["--targetIndex", "1", "--bootstrap_seeds", "3"],
             "all_vectorized": ["--allTissues", "--vectorized"]}[mode]
    single, group = tmp_path / "single", tmp_path / "group"

    def args(o):
        return [*train_files, *flags, "--output_dir", str(o),
                *(["--evalFile", str(o) + "_eval.csv"] if mode == "single" else [])]

    assert main(args(single)) == 0
    torchrun(["-m", "expecto_tpu_torch.cli.train", *args(group)])
    names = sorted(os.listdir(single))
    assert sorted(os.listdir(group)) == names
    saves = [n for n in names if n.endswith(".save")]
    assert len(saves) == {"single": 1, "bootstrap": 3, "all_vectorized": 2}[mode]
    for name in saves:
        m1, m2 = load_xgb07_binary(single / name), load_xgb07_binary(group / name)
        assert np.abs(m1.weight).max() > 1e-3
        assert np.abs(m1.weight - m2.weight).max() < 1e-5 * np.abs(m1.weight).max(), name
        assert abs(m1.bias - m2.bias) < 1e-6, name
    if mode == "single":
        e1, e2 = pd.read_csv(str(single) + "_eval.csv"), pd.read_csv(str(group) + "_eval.csv")
        assert e1.shape == e2.shape and e1.shape[0] > 0
        np.testing.assert_array_equal(e1["target"].values, e2["target"].values)
        np.testing.assert_allclose(e2["pred"].values, e1["pred"].values, rtol=0, atol=1e-4)
    if mode == "all_vectorized":
        with h5py.File(single / "metrics.h5") as f1, h5py.File(group / "metrics.h5") as f2:
            assert sorted(f1) == sorted(f2)
            assert list(f1["tissue"][...]) == list(f2["tissue"][...])
            np.testing.assert_allclose(f2["spearman_valid"][...], f1["spearman_valid"][...], rtol=0, atol=1e-3)
