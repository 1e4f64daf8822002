"""Multi-process execution helpers on ``torch.distributed``: deterministic
row sharding, host-local sharded output and merges in shard order (port of
expecto_tpu/parallel/dist.py).

Each process (rank) takes a deterministic contiguous row range of the
global work list, computes on its own device, and writes
``<stem>.shard{r:05d}-of-{w:05d}<ext>`` files; the ``merge_sharded_*``
functions and ``assemble_rows`` reassemble them in shard order, so a merged
file holds the rows a single-process run writes, in the same order.

Host coordination (barriers) runs on a gloo group of its own, so a NCCL
default group never carries host-side waits. Without a process group every
function sees one process: rank 0 of 1.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch.distributed as dist

#: the gloo group that carries barriers when the default group is not gloo
#: (created on first use; every rank creates it in the same program order)
_HOST_GROUP = None


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process in the default process group —
    (0, 1) when no group is initialized."""
    if not _initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the process that owns single-writer outputs (merged files,
    diagnostics prints): rank 0, or any process of a single-process run."""
    return process_info()[0] == 0


def _host_group():
    """The gloo group for host coordination: the default group when it is
    gloo, else a gloo group over every rank, made once."""
    global _HOST_GROUP
    if dist.get_backend() == "gloo":
        return None  # the default group
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    return _HOST_GROUP


def barrier(name: str) -> None:
    """Block until every process reaches this point (no-op single-process).
    Used before a primary-only merge so all shard files exist. Runs on the
    gloo host group; a rank that does not arrive within the group's timeout
    raises here, with ``name`` in the error."""
    if process_info()[1] == 1:
        return
    try:
        dist.monitored_barrier(group=_host_group(), wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} failed on rank {dist.get_rank()}: {e}") from e


def host_row_range(n_rows: int, process_index: int | None = None, process_count: int | None = None) -> tuple[int, int]:
    """Contiguous [start, stop) row range owned by this process.
    Deterministic: the first ``n % w`` processes take one extra row."""
    rank, world = process_info()
    r = rank if process_index is None else process_index
    w = world if process_count is None else process_count
    base, extra = divmod(n_rows, w)
    start = r * base + min(r, extra)
    stop = start + base + (1 if r < extra else 0)
    return start, stop


def shard_path(path: str, process_index: int | None = None, process_count: int | None = None) -> str:
    """``out.h5`` -> ``out.shard00002-of-00008.h5`` (unchanged in one process)."""
    rank, world = process_info()
    r = rank if process_index is None else process_index
    w = world if process_count is None else process_count
    if w == 1:
        return path
    stem, ext = os.path.splitext(path)
    return f"{stem}.shard{r:05d}-of-{w:05d}{ext}"


def list_shards(path: str) -> list[str]:
    """All shard files for a logical path, in shard order; [path] if the
    unsharded file exists and no shards do.

    Shard files take precedence over a pre-existing merged file: a rerun
    into an output dir that already holds a previous run's merged output
    merges the fresh shards over it (the mergers write through a temporary
    file and ``os.replace``, so a half-merged file never shadows them)."""
    stem, ext = os.path.splitext(path)
    by_index: dict[int, str] = {}
    worlds = set()
    for fpath in sorted(glob.glob(f"{stem}.shard*-of-*{ext}")):
        m = re.search(r"shard(\d{5})-of-(\d{5})", fpath)
        if m is None:
            continue  # hand-named stragglers don't belong to this shard set
        by_index[int(m.group(1))] = fpath
        worlds.add(int(m.group(2)))
    if not by_index:
        return [path] if os.path.exists(path) else []
    # every file must agree on the world size and the indices must be
    # exactly 0..N-1: shards left behind by a run with another process count
    # must not be merged with this run's
    if len(worlds) != 1:
        raise AssertionError(
            f"mixed shard sets for {path}: world sizes {sorted(worlds)} — "
            "remove stale shards from a previous run before merging"
        )
    expected = worlds.pop()
    if sorted(by_index) != list(range(expected)):
        raise AssertionError(
            f"expected shards 0..{expected - 1} for {path}, found indices {sorted(by_index)}"
        )
    return [by_index[i] for i in range(expected)]


def merge_sharded_h5(path: str, out_path: str | None = None, delete_shards: bool = False, fold_axis0: int = 1) -> str:
    """Concatenate shard h5 files (row axis 0 of every dataset) in shard
    order into the logical file: the rows a single-process run writes.

    ``fold_axis0``: number of equal row segments each shard's datasets carry.
    The per-shift chromatin h5s stack forward rows then reverse-complement
    rows ([fwd; rc], io/h5.py); with ``fold_axis0=2`` the merged file is
    [fwd_shard0..fwd_shardK; rc_shard0..rc_shardK], the single-process
    layout, instead of interleaving the halves per shard."""
    import h5py

    shards = list_shards(path)
    if not shards:
        raise FileNotFoundError(path)
    out_path = out_path or path
    if shards == [path]:
        return path
    # stream shard by shard into preallocated datasets: peak memory is one
    # shard, not twice the merged file (shift h5s run to several GB)
    shapes: dict[str, tuple] = {}
    dtypes: dict[str, np.dtype] = {}
    shard_rows: dict[str, list[int]] = {}
    for s in shards:
        with h5py.File(s, "r") as f:
            for name in f:
                shape, dtype = f[name].shape, f[name].dtype
                if shape[0] % fold_axis0:
                    raise AssertionError(
                        f"shard dataset {name} in {s} has {shape[0]} rows, not divisible by fold {fold_axis0}"
                    )
                if name in shapes:
                    if shapes[name][1:] != shape[1:]:
                        raise AssertionError(f"shard dataset {name} trailing shape mismatch")
                    if dtypes[name] != dtype:
                        # h5py would cast on write (one process in fp32
                        # parity mode merged into fp16 shards)
                        raise AssertionError(
                            f"shard dataset {name} dtype mismatch: {dtypes[name]} vs {dtype} in {s}"
                        )
                    shapes[name] = (shapes[name][0] + shape[0],) + shape[1:]
                else:
                    shapes[name], dtypes[name] = shape, dtype
                shard_rows.setdefault(name, []).append(shape[0])
    for name, rows in shard_rows.items():
        if len(rows) != len(shards):
            raise AssertionError(f"dataset {name} missing from some shards of {path}")
    with h5py.File(out_path + ".tmp", "w") as out:
        dsets = {name: out.create_dataset(name, shape=shapes[name], dtype=dtypes[name]) for name in shapes}
        # segment k of the merged file starts where all shards' first k
        # segments end; within it shards contribute in shard order
        seg_total = {name: shapes[name][0] // fold_axis0 for name in shapes}
        seg_done = {name: 0 for name in shapes}  # rows of earlier shards, per segment
        for s in shards:
            with h5py.File(s, "r") as f:
                for name in f:
                    seg = f[name].shape[0] // fold_axis0
                    for k in range(fold_axis0):
                        o = k * seg_total[name] + seg_done[name]
                        dsets[name][o : o + seg] = f[name][k * seg : (k + 1) * seg]
                    seg_done[name] += seg
    os.replace(out_path + ".tmp", out_path)
    if delete_shards:
        for s in shards:
            os.remove(s)
    return out_path


def merge_sharded_npy(path: str, out_path: str | None = None, delete_shards: bool = False) -> str:
    """Concatenate shard ``.npy`` files (axis 0) in shard order into the
    logical file (the gene-feature matrix path)."""
    shards = list_shards(path)
    if not shards:
        raise FileNotFoundError(path)
    out_path = out_path or path
    if shards == [path]:
        return path
    merged = np.concatenate([np.load(s) for s in shards], axis=0)
    with open(out_path + ".tmp", "wb") as f:
        np.save(f, merged)
    os.replace(out_path + ".tmp", out_path)
    if delete_shards:
        for s in shards:
            os.remove(s)
    return out_path


def merge_sharded_csv(path: str, out_path: str | None = None, delete_shards: bool = False, header: bool = True) -> str:
    """Concatenate shard CSV/TSV files in shard order, keeping the first
    shard's header line only (the ref_preds.csv path)."""
    shards = list_shards(path)
    if not shards:
        raise FileNotFoundError(path)
    out_path = out_path or path
    if shards == [path]:
        return path
    chunks: list[str] = []
    for i, s in enumerate(shards):
        with open(s) as f:
            text = f.read()
        if header and i > 0:
            text = text.split("\n", 1)[1] if "\n" in text else ""
        chunks.append(text)
    with open(out_path + ".tmp", "w") as f:
        f.write("".join(chunks))
    os.replace(out_path + ".tmp", out_path)
    if delete_shards:
        for s in shards:
            os.remove(s)
    return out_path


#: per-process exchange counter; all processes issue exchanges in the same
#: program order, so the stamped sequence numbers agree across ranks
_EXCHANGE_SEQ = 0


def exchange_row_blocks(arrays: dict[str, np.ndarray], tmp_dir: str, tag: str) -> dict[str, np.ndarray]:
    """Share per-process contiguous row blocks through the filesystem: each
    rank writes its block (the ``host_row_range`` slice, in global row
    order) as one npz shard; after a barrier every rank assembles and
    returns the full arrays. The wire format is exact (raw float bits, no
    CSV round trip), so the assembled arrays hold each rank's rows bit for
    bit. Single-process: returns ``arrays`` unchanged.

    Repeated exchanges with the same (tmp_dir, tag) are safe: every call
    stamps a per-process sequence number into the shard filenames, so a
    second call's writes never race the primary's deletion of the first
    call's shards (all ranks issue exchanges in the same program order, so
    the counters agree)."""
    rank, world = process_info()
    if world == 1:
        return arrays
    os.makedirs(tmp_dir, exist_ok=True)
    global _EXCHANGE_SEQ
    seq = _EXCHANGE_SEQ
    _EXCHANGE_SEQ += 1
    path = os.path.join(tmp_dir, f".exchange_{tag}.{seq:04d}.npz")
    own = shard_path(path)
    np.savez(own, **arrays)
    barrier(f"exchange.{tag}.written")
    # the (tag, seq) identity lives in the shard stem, so if some rank issued
    # an exchange the others did not, the lagging ranks wrote another stem
    # and this stem's shard set comes up short: name the cause here
    missing = [r for r in range(world) if not os.path.exists(shard_path(path, process_index=r))]
    if missing:
        raise AssertionError(
            f"exchange {tag!r} (seq {seq}) is missing shard(s) from process(es) "
            f"{missing} after the write barrier — the per-process exchange "
            "counters have desynced (some process issued an exchange the "
            "others did not; exchanges must run in identical program order "
            "on every process)"
        )
    per_key: dict[str, list[np.ndarray]] = {}
    for s in list_shards(path):
        if os.path.abspath(s) == os.path.abspath(own):
            # this rank's block is already in memory
            for k, v in arrays.items():
                per_key.setdefault(k, []).append(v)
            continue
        with np.load(s) as f:
            for k in f.files:
                per_key.setdefault(k, []).append(f[k])
    merged = {k: np.concatenate(v, axis=0) for k, v in per_key.items()}
    barrier(f"exchange.{tag}.read")
    if is_primary():
        for r in range(world):
            os.remove(shard_path(path, process_index=r))
    return merged


def assemble_rows(parts: list[tuple[int, np.ndarray]], n_rows: int) -> np.ndarray:
    """Place (start, block) pairs into a (n_rows, ...) array (the in-memory
    merge of row blocks)."""
    out = np.empty((n_rows,) + parts[0][1].shape[1:], dtype=parts[0][1].dtype)
    # blocks must tile [0, n_rows) exactly: a size-only check would accept
    # overlapping parts and leave an uninitialized gap
    end = 0
    for start, block in sorted(parts, key=lambda p: p[0]):
        if start != end:
            raise AssertionError(f"row blocks must tile contiguously: block at {start}, expected {end}")
        out[start : start + block.shape[0]] = block
        end = start + block.shape[0]
    if end != n_rows:
        raise AssertionError(f"assembled {end} rows, expected {n_rows}")
    return out
