"""Memory-mapped FASTA random access (pyfasta replacement).

The reference uses ``pyfasta.Fasta('./resources/hg19.fa')`` with 1-based
inclusive ``sequence({'chr', 'start', 'stop'})`` lookups (chromatin.py:44,
205-206). pyfasta materializes a newline-free ".flat" sidecar and mmaps it;
we do the same: building ``<fa>.etflat`` (concatenated contig bytes) plus a
small JSON index on first open, then serving window fetches as raw mmap
slices.

If a native helper library (see ``native/``) is present it is used for the
flat-file build; the numpy fallback is used otherwise. Fetches themselves are
mmap slices either way (zero-copy until decode).

Coordinate semantics:
    - ``sequence(chrom, start, stop)`` is 1-based, inclusive on both ends.
    - Out-of-range coordinates are clamped to the contig, so edge windows
      come back shorter than requested; callers that need fixed-length
      windows pad with 'N' (matching the reference consensus path,
      geuvadis_predict_ref_all_genes.py:109-144).
"""

from __future__ import annotations

import json
import mmap
import os
from pathlib import Path

import numpy as np

_FLAT_SUFFIX = ".etflat"
_IDX_SUFFIX = ".etidx.json"


def _source_fingerprint(fasta_path: Path) -> list[int]:
    # (size, mtime_ns) is cheap and catches re-downloads/regenerations; a
    # same-size mtime-preserving copy (cp -p / tar -p) of a *different*
    # genome defeats it — callers swapping genomes that way must delete the
    # sidecars (a content hash would cost a 3 GB read per open).
    st = fasta_path.stat()
    return [int(st.st_size), int(st.st_mtime_ns)]


def _write_index(idx_path: Path, fingerprint: list[int], index: dict) -> None:
    tmp = idx_path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"__source__": fingerprint, "contigs": index}))
    os.replace(tmp, idx_path)


def _build_flat(fasta_path: Path, flat_path: Path, idx_path: Path) -> None:
    """One-time scan: strip headers/newlines into a flat byte file + index.
    Uses the native builder (native/etseq.cc) when available."""
    from . import native

    # fingerprint BEFORE reading: if the FASTA is swapped mid-build the
    # recorded stamp then mismatches the new file and forces a rebuild on
    # the next open, instead of permanently serving the stale flat content
    fingerprint = _source_fingerprint(fasta_path)

    if native.available() and fingerprint[0] > 0:  # mmap rejects empty files
        # mmap the source (OS-paged, no heap copy) and stream the flat
        # array straight to disk: peak extra RAM ~1x genome, not ~3x
        nidx = None
        with open(fasta_path, "rb") as f:
            raw = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            try:
                try:
                    flat, nidx = native.build_flat(raw)
                except RuntimeError:
                    pass  # >4096 contigs: the streaming builder below has no cap
                else:
                    flat.tofile(str(flat_path))
                    del flat
            finally:
                try:
                    raw.close()
                except BufferError:
                    # numpy views of the mmap are still referenced by an
                    # in-flight exception traceback; GC reclaims the map
                    pass
        if nidx is not None:
            _write_index(idx_path, fingerprint, {k: [off, ln] for k, (off, ln) in nidx.items()})
            return

    index: dict[str, list[int]] = {}
    offset = 0
    name = None
    # Stream in large chunks; FASTA lines are short so a line iterator is
    # acceptable for the one-time build (hg19 ~3GB -> ~40s; cached after).
    with open(fasta_path, "rb") as src, open(flat_path, "wb") as dst:
        for line in src:
            if line.startswith(b">"):
                if name is not None:
                    index[name][1] = offset - index[name][0]
                name = line[1:].split()[0].decode()
                index[name] = [offset, 0]
            else:
                seq = line.rstrip(b"\r\n")
                dst.write(seq)
                offset += len(seq)
        if name is not None:
            index[name][1] = offset - index[name][0]
    _write_index(idx_path, fingerprint, index)


class FastaIndex:
    """Random-access FASTA with pyfasta-compatible 1-based inclusive fetches."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        flat = self.path.with_name(self.path.name + _FLAT_SUFFIX)
        idx = self.path.with_name(self.path.name + _IDX_SUFFIX)
        contigs = self._load_fresh_index(flat, idx)
        if contigs is None:
            _build_flat(self.path, flat, idx)
            contigs = json.loads(idx.read_text())["contigs"]
        self._index: dict[str, list[int]] = contigs
        self._file = open(flat, "rb")
        if os.fstat(self._file.fileno()).st_size > 0:
            self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        else:  # zero contigs (empty/truncated FASTA): mmap rejects empty files
            self._mmap = b""

    def _load_fresh_index(self, flat: Path, idx: Path):
        """Contig index if the sidecars are usable, else None (rebuild).

        Rebuild when sidecars are missing OR the source FASTA changed since
        they were built (size+mtime fingerprint) — a re-downloaded or swapped
        genome must not be silently served from stale sidecars.
        Pre-fingerprint sidecars (a flat ``{name: [off, len]}`` dict, no
        ``__source__`` key) rebuild once to record the fingerprint — unless
        the source FASTA is gone, in which case they are served as-is:
        sidecars-only deployments (source deleted after the one-time build)
        must not crash on a format migration. New-format sidecars without a
        source are likewise served as-is."""
        if not (flat.exists() and idx.exists()):
            return None
        try:
            meta = json.loads(idx.read_text())
        except ValueError:
            return None
        try:
            contigs = meta["contigs"]
            stamp = meta["__source__"]
        except (KeyError, TypeError):
            # old-format sidecar: the whole dict is the contig index
            if (
                not self.path.exists()
                and isinstance(meta, dict)
                and meta
                and all(isinstance(v, list) and len(v) == 2 for v in meta.values())
            ):
                return meta
            return None
        if not self.path.exists():
            return contigs
        return contigs if stamp == _source_fingerprint(self.path) else None

    def __contains__(self, chrom: str) -> bool:
        return chrom in self._index

    def contig_length(self, chrom: str) -> int:
        return self._index[chrom][1]

    def sequence(self, chrom: str, start: int, stop: int) -> str:
        """1-based inclusive fetch, clamped to the contig bounds."""
        off, length = self._index[chrom]
        lo = max(int(start) - 1, 0)
        hi = min(int(stop), length)
        if hi <= lo:
            return ""
        return self._mmap[off + lo : off + hi].decode("ascii")

    def window_codes(self, chrom: str, starts_1based, window_len: int) -> "np.ndarray":
        """(n, window_len) int8 base codes for fixed-length windows; positions
        outside the contig encode as N. Uses the native gather kernel when
        available, else a numpy loop over mmap slices."""
        from .encode import _BYTE_LUT, N_CODE
        from . import native

        off, length = self._index[chrom]
        starts0 = np.asarray(starts_1based, dtype=np.int64) - 1
        if native.available():
            contig = np.frombuffer(self._mmap, dtype=np.uint8, count=length, offset=off)
            return native.gather_windows(contig, starts0, window_len)
        out = np.full((starts0.shape[0], window_len), N_CODE, dtype=np.int8)
        for i, s in enumerate(starts0):
            lo = max(int(s), 0)
            hi = min(int(s) + window_len, length)
            if hi > lo:
                raw = np.frombuffer(self._mmap, dtype=np.uint8, count=hi - lo, offset=off + lo)
                out[i, lo - int(s) : lo - int(s) + (hi - lo)] = _BYTE_LUT[raw]
        return out

    def window_bytes(self, chrom: str, starts_1based, window_len: int) -> "np.ndarray":
        """(n, window_len) raw sequence bytes for fixed-length windows, in one
        vectorized gather; positions outside the contig are 0 (no base ever
        compares equal to it). Batched replacement for per-row
        :meth:`sequence` calls on hot diagnostic paths."""
        off, length = self._index[chrom]
        starts0 = np.asarray(starts_1based, dtype=np.int64) - 1
        if length == 0 or starts0.size == 0:
            return np.zeros((starts0.shape[0], window_len), np.uint8)
        contig = np.frombuffer(self._mmap, dtype=np.uint8, count=length, offset=off)
        idx = starts0[:, None] + np.arange(window_len, dtype=np.int64)[None, :]
        valid = (idx >= 0) & (idx < length)
        return np.where(valid, contig[np.clip(idx, 0, length - 1)], np.uint8(0))

    def close(self) -> None:
        if isinstance(self._mmap, mmap.mmap):
            self._mmap.close()
        self._file.close()


def write_fasta(path: str | os.PathLike, contigs: dict[str, str], width: int = 70) -> None:
    """Write a FASTA file (test fixtures / consensus outputs)."""
    with open(path, "w") as f:
        for name, seq in contigs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")
